"""Cluster object model (layer L0 of SURVEY.md §1).

Counterpart: ``kubernetes_simulator_tpu/models/core.py`` (a copy).

Typed, user-facing descriptions of nodes, pods, taints, tolerations,
affinity terms, topology-spread constraints, and pod groups. These mirror
the upstream Kubernetes API types that the reference simulator schedules
over ([K8S] semantics; [BASELINE] capability surface — the reference mount
was empty, see SURVEY.md §0, so citations are to upstream semantics, not
reference file:line).

Everything here is plain Python; the SoA tensor encodings that the CPU and
JAX scheduling paths consume live in :mod:`.encode`.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ..utils.quantity import parse_quantity

# Well-known resource names (upstream v1 core). Extended resources (e.g.
# "google.com/tpu", "nvidia.com/gpu") are arbitrary additional keys.
CPU = "cpu"
MEMORY = "memory"
PODS = "pods"
EPHEMERAL_STORAGE = "ephemeral-storage"
DEFAULT_RESOURCES = (CPU, MEMORY, PODS, EPHEMERAL_STORAGE)


class Effect(enum.IntEnum):
    """Taint effects. Integer values are the on-tensor encoding (0 = pad)."""

    NO_SCHEDULE = 1
    PREFER_NO_SCHEDULE = 2
    NO_EXECUTE = 3

    @classmethod
    def parse(cls, s: str) -> "Effect":
        return {
            "NoSchedule": cls.NO_SCHEDULE,
            "PreferNoSchedule": cls.PREFER_NO_SCHEDULE,
            "NoExecute": cls.NO_EXECUTE,
        }[s]


class Operator(enum.IntEnum):
    """Selector-expression operators ([K8S] NodeSelectorOperator /
    LabelSelectorOperator). Integer values are the on-tensor encoding."""

    IN = 1
    NOT_IN = 2
    EXISTS = 3
    DOES_NOT_EXIST = 4
    GT = 5
    LT = 6

    @classmethod
    def parse(cls, s: str) -> "Operator":
        return {
            "In": cls.IN,
            "NotIn": cls.NOT_IN,
            "Exists": cls.EXISTS,
            "DoesNotExist": cls.DOES_NOT_EXIST,
            "Gt": cls.GT,
            "Lt": cls.LT,
        }[s]


@dataclass(frozen=True)
class Taint:
    key: str
    value: str = ""
    effect: Effect = Effect.NO_SCHEDULE

    def __post_init__(self):
        if isinstance(self.effect, str):
            object.__setattr__(self, "effect", Effect.parse(self.effect))
        object.__setattr__(self, "key", str(self.key))
        object.__setattr__(self, "value", str(self.value))

    @classmethod
    def from_dict(cls, d: dict) -> "Taint":
        eff = d.get("effect", "NoSchedule")
        return cls(
            key=d["key"],
            value=str(d.get("value", "")),
            effect=eff if isinstance(eff, Effect) else Effect.parse(eff),
        )


@dataclass(frozen=True)
class Toleration:
    """[K8S] v1.Toleration. ``key=None`` with ``operator="Exists"`` tolerates
    everything; ``effect=None`` matches all effects."""

    key: Optional[str] = None
    operator: str = "Equal"  # "Equal" | "Exists"
    value: str = ""
    effect: Optional[Effect] = None

    def __post_init__(self):
        if isinstance(self.effect, str):
            object.__setattr__(self, "effect", Effect.parse(self.effect))
        if self.key is not None:
            object.__setattr__(self, "key", str(self.key))
        object.__setattr__(self, "operator", str(self.operator))
        object.__setattr__(self, "value", str(self.value))

    def tolerates(self, taint: Taint) -> bool:
        if self.effect is not None and self.effect != taint.effect:
            return False
        if self.key is None:
            return self.operator == "Exists"
        if self.key != taint.key:
            return False
        if self.operator == "Exists":
            return True
        return self.value == taint.value

    @classmethod
    def from_dict(cls, d: dict) -> "Toleration":
        eff = d.get("effect")
        if isinstance(eff, str):
            eff = Effect.parse(eff)
        return cls(
            key=d.get("key"),
            operator=d.get("operator", "Equal"),
            value=str(d.get("value", "")),
            effect=eff,
        )


@dataclass(frozen=True)
class MatchExpression:
    """One requirement inside a selector term ([K8S] NodeSelectorRequirement
    / LabelSelectorRequirement)."""

    key: str
    operator: Operator
    values: Tuple[str, ...] = ()

    @classmethod
    def make(cls, key: str, operator, values: Sequence[str] = ()) -> "MatchExpression":
        op = operator if isinstance(operator, Operator) else Operator.parse(operator)
        return cls(key=key, operator=op, values=tuple(str(v) for v in values))

    def matches(self, labels: Dict[str, str]) -> bool:
        """Evaluate against a label map. [K8S] nodeaffinity semantics:
        In/Gt/Lt require the key to be present; NotIn/DoesNotExist match
        when the key is absent."""
        present = self.key in labels
        if self.operator == Operator.EXISTS:
            return present
        if self.operator == Operator.DOES_NOT_EXIST:
            return not present
        if self.operator == Operator.IN:
            return present and labels[self.key] in self.values
        if self.operator == Operator.NOT_IN:
            return not (present and labels[self.key] in self.values)
        # Gt / Lt: single integer value, key must be present and numeric.
        if not present:
            return False
        try:
            node_v = float(labels[self.key])
            want = float(self.values[0])
        except (ValueError, IndexError):
            return False
        return node_v > want if self.operator == Operator.GT else node_v < want


@dataclass(frozen=True)
class NodeSelectorTerm:
    """AND of match expressions ([K8S] NodeSelectorTerm)."""

    match_expressions: Tuple[MatchExpression, ...] = ()

    def matches(self, labels: Dict[str, str]) -> bool:
        return all(e.matches(labels) for e in self.match_expressions)


@dataclass(frozen=True)
class PreferredSchedulingTerm:
    weight: int
    term: NodeSelectorTerm


@dataclass(frozen=True)
class NodeAffinitySpec:
    """[K8S] v1.NodeAffinity: required = OR of terms; preferred = weighted."""

    required: Tuple[NodeSelectorTerm, ...] = ()  # empty → no requirement
    preferred: Tuple[PreferredSchedulingTerm, ...] = ()


@dataclass(frozen=True)
class LabelSelector:
    """[K8S] metav1.LabelSelector: match_labels AND match_expressions."""

    match_labels: Tuple[Tuple[str, str], ...] = ()
    match_expressions: Tuple[MatchExpression, ...] = ()

    @classmethod
    def make(cls, match_labels: Dict[str, str] = None, match_expressions=()) -> "LabelSelector":
        return cls(
            match_labels=tuple(sorted((match_labels or {}).items())),
            match_expressions=tuple(match_expressions),
        )

    def matches(self, labels: Dict[str, str]) -> bool:
        for k, v in self.match_labels:
            if labels.get(k) != v:
                return False
        return all(e.matches(labels) for e in self.match_expressions)

    @property
    def empty(self) -> bool:
        return not self.match_labels and not self.match_expressions


@dataclass(frozen=True)
class PodAffinityTerm:
    """[K8S] v1.PodAffinityTerm: select existing pods by label selector in
    ``namespaces`` (empty → the incoming pod's own namespace), co-located by
    ``topology_key``."""

    label_selector: LabelSelector
    topology_key: str
    namespaces: Tuple[str, ...] = ()


@dataclass(frozen=True)
class WeightedPodAffinityTerm:
    weight: int
    term: PodAffinityTerm


@dataclass(frozen=True)
class PodAffinitySpec:
    required: Tuple[PodAffinityTerm, ...] = ()
    preferred: Tuple[WeightedPodAffinityTerm, ...] = ()


@dataclass(frozen=True)
class TopologySpreadConstraint:
    """[K8S] v1.TopologySpreadConstraint."""

    max_skew: int
    topology_key: str
    when_unsatisfiable: str  # "DoNotSchedule" | "ScheduleAnyway"
    label_selector: LabelSelector


@dataclass
class Node:
    name: str
    capacity: Dict[str, float] = field(default_factory=dict)
    allocatable: Optional[Dict[str, float]] = None  # defaults to capacity
    labels: Dict[str, str] = field(default_factory=dict)
    taints: List[Taint] = field(default_factory=list)

    def __post_init__(self):
        self.capacity = {k: parse_quantity(v) for k, v in self.capacity.items()}
        if self.allocatable is None:
            self.allocatable = dict(self.capacity)
        else:
            self.allocatable = {k: parse_quantity(v) for k, v in self.allocatable.items()}
        # Every node implicitly has the hostname topology label.
        self.labels.setdefault("kubernetes.io/hostname", self.name)


@dataclass
class Pod:
    name: str
    namespace: str = "default"
    labels: Dict[str, str] = field(default_factory=dict)
    requests: Dict[str, float] = field(default_factory=dict)
    priority: int = 0
    arrival_time: float = 0.0
    duration: Optional[float] = None  # virtual seconds until completion; None = forever
    tolerations: List[Toleration] = field(default_factory=list)
    node_affinity: NodeAffinitySpec = field(default_factory=NodeAffinitySpec)
    pod_affinity: PodAffinitySpec = field(default_factory=PodAffinitySpec)
    pod_anti_affinity: PodAffinitySpec = field(default_factory=PodAffinitySpec)
    topology_spread: List[TopologySpreadConstraint] = field(default_factory=list)
    pod_group: Optional[str] = None  # gang / coscheduling group name
    node_name: Optional[str] = None  # pre-bound pods in the initial cluster state

    def __post_init__(self):
        self.requests = {k: parse_quantity(v) for k, v in self.requests.items()}
        # Every pod consumes one "pods" slot ([K8S] node allocatable.pods).
        self.requests.setdefault(PODS, 1.0)


@dataclass(frozen=True)
class PodGroup:
    """[K8S] scheduler-plugins coscheduling PodGroup: all-or-nothing gang of
    at least ``min_member`` pods."""

    name: str
    min_member: int


@dataclass
class Cluster:
    nodes: List[Node]
    pods: List[Pod] = field(default_factory=list)  # pre-existing (possibly bound) pods
    pod_groups: Dict[str, PodGroup] = field(default_factory=dict)

    def node_by_name(self, name: str) -> Node:
        for n in self.nodes:
            if n.name == name:
                return n
        raise KeyError(name)
