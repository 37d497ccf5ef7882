"""Builtin scheduler plugins — CPU (numpy) path, and the plugin-set constants.

Counterpart: ``kubernetes_simulator_tpu/plugins/builtin.py`` (a copy):
the plugin classes (NodeResourcesFit with LeastAllocated / MostAllocated /
RequestedToCapacityRatio, TaintToleration, NodeAffinity, InterPodAffinity,
PodTopologySpread; vectorized over nodes through :mod:`..ops.cpu`) that
the port's CPU scheduler framework (:mod:`..framework.framework`) runs for
``greedy_replay`` and the policy tuner's oracle; the default plugin order
and Score weights ([K8S] default profile); the policy tuner's surface
(``TUNABLE_WEIGHT_RANGE``, ``TUNABLE_FIT_STRATEGIES``,
``tunable_parameters``); the "System" default spreading constraints and
the pre-encode injector. The device path's Filter/Score arithmetic lives
in :mod:`..ops.reference` (plain PyTorch) and ``csrc/`` (the kernels).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from ..models.encode import EncodedCluster, EncodedPods
from ..models.state import SchedState
from ..ops import cpu as K


@dataclass
class SchedulingContext:
    """Per-replay immutable context handed to every plugin call."""

    ec: EncodedCluster
    pods: EncodedPods
    expr_match: np.ndarray  # [N, E] — cached expr_match_matrix(ec)

    @classmethod
    def build(cls, ec: EncodedCluster, pods: EncodedPods) -> "SchedulingContext":
        return cls(ec=ec, pods=pods, expr_match=K.expr_match_matrix(ec))


class Plugin:
    """Extension-point interface ([K8S] framework.Plugin). ``filter`` returns
    a feasibility mask over all nodes (None = no opinion); ``score`` returns
    raw per-node scores which ``normalize`` maps to [0, 100]."""

    name: str = "Plugin"

    def filter(self, ctx: SchedulingContext, st: SchedState, p: int) -> Optional[np.ndarray]:
        return None

    def score(self, ctx: SchedulingContext, st: SchedState, p: int) -> Optional[np.ndarray]:
        return None

    def normalize(self, raw: np.ndarray, feasible: np.ndarray) -> np.ndarray:
        return raw


class NodeResourcesFit(Plugin):
    """[K8S] noderesources/fit. ``strategy`` ∈ {LeastAllocated, MostAllocated,
    RequestedToCapacityRatio}; ``resources`` maps resource name → weight
    (default cpu=1, memory=1). Extended resources participate in the Filter
    unconditionally (they are rows of the tensors)."""

    name = "NodeResourcesFit"

    def __init__(
        self,
        ctx: SchedulingContext,
        strategy: str = "LeastAllocated",
        resources: Optional[Dict[str, float]] = None,
        shape: Optional[List[dict]] = None,
    ):
        self.strategy = strategy
        res = resources or {"cpu": 1.0, "memory": 1.0}
        R = ctx.ec.num_resources
        self.weights = np.zeros(R, dtype=np.float32)
        for rname, w in res.items():
            ri = ctx.ec.vocab._r.get(rname)
            if ri is not None:
                self.weights[ri] = w
        pts = shape or [{"utilization": 0, "score": 0}, {"utilization": 100, "score": 10}]
        self.shape_x = np.array([pt["utilization"] for pt in pts], dtype=np.float32)
        self.shape_y = np.array([pt["score"] * 10.0 for pt in pts], dtype=np.float32)

    def filter(self, ctx, st, p):
        return K.fit_mask(ctx.ec, st, ctx.pods, p)

    def score(self, ctx, st, p):
        if self.strategy == "LeastAllocated":
            return K.least_allocated_score(ctx.ec, st, ctx.pods, p, self.weights)
        if self.strategy == "MostAllocated":
            return K.most_allocated_score(ctx.ec, st, ctx.pods, p, self.weights)
        return K.requested_to_capacity_ratio_score(
            ctx.ec, st, ctx.pods, p, self.weights, self.shape_x, self.shape_y
        )


class TaintToleration(Plugin):
    """[K8S] tainttoleration: Filter on untolerated NoSchedule/NoExecute;
    Score prefers fewer untolerated PreferNoSchedule taints."""

    name = "TaintToleration"

    def __init__(self, ctx: SchedulingContext):
        pass

    def filter(self, ctx, st, p):
        return K.taint_mask(ctx.ec, ctx.pods, p)

    def score(self, ctx, st, p):
        return K.taint_prefer_count(ctx.ec, ctx.pods, p)

    def normalize(self, raw, feasible):
        return K.normalize_max(raw, feasible, reverse=True)


class NodeAffinity(Plugin):
    """[K8S] nodeaffinity: required terms filter; preferred terms score."""

    name = "NodeAffinity"

    def __init__(self, ctx: SchedulingContext):
        pass

    def filter(self, ctx, st, p):
        return K.node_affinity_mask(ctx.expr_match, ctx.pods, p)

    def score(self, ctx, st, p):
        return K.node_affinity_score(ctx.expr_match, ctx.pods, p)

    def normalize(self, raw, feasible):
        return K.normalize_max(raw, feasible)


class InterPodAffinity(Plugin):
    """[K8S] interpodaffinity over the count-group tensors (SURVEY.md §7
    hard part #2): required (anti-)affinity filter incl. the symmetric
    existing-pods'-anti-affinity check; preferred terms score both ways."""

    name = "InterPodAffinity"

    def __init__(self, ctx: SchedulingContext):
        pass

    def filter(self, ctx, st, p):
        return K.interpod_filter_mask(ctx.ec, st, ctx.pods, p)

    def score(self, ctx, st, p):
        return K.interpod_score(ctx.ec, st, ctx.pods, p)

    def normalize(self, raw, feasible):
        return K.normalize_min_max(raw, feasible)


class PodTopologySpread(Plugin):
    """[K8S] podtopologyspread: DoNotSchedule constraints filter on maxSkew;
    scoring prefers domains with fewer matching pods."""

    name = "PodTopologySpread"

    def __init__(self, ctx: SchedulingContext, defaultingType=None, defaultConstraints=None):
        # Defaulting args are consumed pre-encode by inject_default_spread;
        # accepted here so the KubeSchedulerConfiguration vocabulary parses.
        pass

    def filter(self, ctx, st, p):
        return K.spread_filter_mask(ctx.ec, st, ctx.pods, p)

    def score(self, ctx, st, p):
        # None when the pod has no ScheduleAnyway constraints ([K8S]
        # PreScore Skip) — the framework then contributes nothing.
        return K.spread_score(ctx.ec, st, ctx.pods, p)

    def normalize(self, raw, feasible):
        return K.spread_normalize(raw, feasible)


PLUGIN_FACTORIES = {
    "NodeResourcesFit": NodeResourcesFit,
    "TaintToleration": TaintToleration,
    "NodeAffinity": NodeAffinity,
    "InterPodAffinity": InterPodAffinity,
    "PodTopologySpread": PodTopologySpread,
}

#: Plugin name → default Score weight ([K8S] default profile weights).
DEFAULT_WEIGHTS = {
    "NodeResourcesFit": 1.0,
    "TaintToleration": 3.0,
    "NodeAffinity": 2.0,
    "InterPodAffinity": 2.0,
    "PodTopologySpread": 2.0,
}

#: Policy-tuner surface (round 9, sim.tuner): the default Score-weight
#: search range. Upstream accepts weights in [0, 100]; the useful dynamic
#: range is far smaller — only weight RATIOS matter to the argmax.
TUNABLE_WEIGHT_RANGE = (0.0, 10.0)

#: NodeResourcesFit scoring strategies with a cheap traced selector in the
#: device score fold (ops/policy.py POLICY_COLS "fit_least" column; index order
#: matters: fit_least > 0.5 selects LeastAllocated).
TUNABLE_FIT_STRATEGIES = ("MostAllocated", "LeastAllocated")


def tunable_parameters(config=None) -> List[dict]:
    """The tunable-parameter surface for the policy tuner: one ``weight``
    entry per Score plugin (canonical PLUGIN_FACTORIES order — the same
    order as ops/policy.py POLICY_WEIGHT_COLS) plus the NodeResourcesFit
    strategy ``choice``. ``enabled`` marks parameters whose plugin is in
    the config's plugin list (disabled plugins' score rows are statically
    absent from the device program, so their columns are inert — the
    search pins them to their defaults). ``default`` reflects the config's
    own weights/args, so the unmodified policy vector reproduces the
    configured scheduler exactly."""
    weights = dict(DEFAULT_WEIGHTS)
    enabled = set(PLUGIN_FACTORIES)
    strategy = "LeastAllocated"
    if config is not None:
        weights.update(config.weights or {})
        if config.plugins is not None:
            enabled = {e["name"] for e in config.plugins}
            for e in config.plugins:
                if e.get("name") == "NodeResourcesFit":
                    strategy = e.get("args", {}).get("strategy", strategy)
    lo, hi = TUNABLE_WEIGHT_RANGE
    out = [
        {
            "name": name, "kind": "weight", "lo": lo, "hi": hi,
            "default": float(weights[name]), "enabled": name in enabled,
        }
        for name in PLUGIN_FACTORIES
    ]
    out.append({
        "name": "NodeResourcesFit.strategy", "kind": "choice",
        "choices": TUNABLE_FIT_STRATEGIES, "default": strategy,
        # A RequestedToCapacityRatio base strategy has no traced selector
        # (its shape table is static) — the column is inert then.
        "enabled": (
            "NodeResourcesFit" in enabled
            and strategy in TUNABLE_FIT_STRATEGIES
        ),
    })
    return out


def make_plugins(
    ctx: SchedulingContext, plugin_config: Optional[List[dict]] = None
) -> List[Plugin]:
    """Instantiate a plugin list from config entries
    ``[{"name": ..., "args": {...}}, ...]`` (default: full default set)."""
    if plugin_config is None:
        plugin_config = [{"name": n} for n in PLUGIN_FACTORIES]
    out = []
    for entry in plugin_config:
        factory = PLUGIN_FACTORIES[entry["name"]]
        out.append(factory(ctx, **entry.get("args", {})))
    return out


#: Plugin names in Filter/Score order — the order of the device score fold
#: (ops/policy.py POLICY_WEIGHT_COLS) and of StepSpec's flags.
PLUGIN_NAMES = tuple(PLUGIN_FACTORIES)


#: kube-scheduler "System" default spreading (KubeSchedulerConfiguration
#: PodTopologySpreadArgs when defaultingType=System).
SYSTEM_DEFAULT_SPREAD = [
    {"maxSkew": 3, "topologyKey": "kubernetes.io/hostname",
     "whenUnsatisfiable": "ScheduleAnyway"},
    {"maxSkew": 5, "topologyKey": "topology.kubernetes.io/zone",
     "whenUnsatisfiable": "ScheduleAnyway"},
]


def resolved_default_constraints(config):
    """The PodTopologySpread defaulting constraint list from config, or
    None when not configured — the single source for both the predicate
    and the injector."""
    constraints = None
    for e in (config.plugins if config and config.plugins is not None else []):
        if e.get("name") != "PodTopologySpread":
            continue
        args = e.get("args", {})
        if args.get("defaultingType") == "System":
            constraints = SYSTEM_DEFAULT_SPREAD
        elif args.get("defaultConstraints"):
            constraints = args["defaultConstraints"]
    return constraints


def inject_default_spread(pods, config) -> None:
    """Apply PodTopologySpread cluster-default constraints: pods WITHOUT
    explicit constraints get the plugin-args defaults, selecting on the
    pod's own labels (the simulator's stand-in for upstream's
    controller-selector lookup — pods of one controller share labels).

    Config vocabulary mirrors KubeSchedulerConfiguration:
        plugins:
        - name: PodTopologySpread
          args: {defaultingType: System}             # built-in pair
        # or explicit: args: {defaultConstraints: [{maxSkew: ..., ...}]}
    No-op unless the plugin entry asks for defaulting (upstream's List
    defaulting with an empty list)."""
    from ..models.core import LabelSelector, TopologySpreadConstraint

    constraints = resolved_default_constraints(config)
    if not constraints:
        return
    for p in pods:
        if p.topology_spread or not p.labels:
            continue
        for c in constraints:
            p.topology_spread.append(
                TopologySpreadConstraint(
                    max_skew=int(c["maxSkew"]),
                    topology_key=c["topologyKey"],
                    when_unsatisfiable=c.get("whenUnsatisfiable", "ScheduleAnyway"),
                    label_selector=LabelSelector.make(dict(p.labels)),
                )
            )
