"""Replay result type and the node-event timeline.

Counterpart: ``kubernetes_simulator_tpu/sim/runtime.py`` — the
:class:`ReplayResult`, field for field, so rows and tests read both
packages' results alike, and the chaos timeline's :class:`NodeEvent`,
``validate_node_events`` and ``events_hash`` (:47-130, the same checks and
messages). The JAX package's CPU event engine is not part of the port.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from ..models.state import SchedState
from ..utils.metrics import round_fragmentation


@dataclass
class NodeEvent:
    """Cluster perturbation at a virtual timestamp (failure injection)."""

    time: float
    kind: str  # "node_down" | "node_up" | "capacity_scale"
    node: int
    scale: float = 1.0


_EVENT_KINDS = ("node_down", "node_up", "capacity_scale")


def validate_node_events(
    events: Optional[List[NodeEvent]], num_nodes: int
) -> List[NodeEvent]:
    """Up-front validation shared by every engine (device replay, what-if
    timelines): a malformed timeline raises an actionable ``ValueError``
    instead of silently misbehaving mid-replay. Checks: known kind, node
    index in range, finite non-negative non-decreasing times, ``node_up``
    only after a ``node_down`` on the same node, and a non-negative
    ``capacity_scale`` factor. Returns the (unmodified) list for
    chaining."""
    events = events or []
    down: set = set()
    prev_t = -np.inf
    for i, ev in enumerate(events):
        where = f"node_events[{i}]"
        if ev.kind not in _EVENT_KINDS:
            raise ValueError(
                f"{where}: unknown kind {ev.kind!r} (expected one of "
                f"{', '.join(_EVENT_KINDS)})"
            )
        if not (0 <= int(ev.node) < num_nodes):
            raise ValueError(
                f"{where}: node {ev.node} out of range for a cluster of "
                f"{num_nodes} nodes"
            )
        t = float(ev.time)
        if not np.isfinite(t) or t < 0:
            raise ValueError(
                f"{where}: time {ev.time!r} must be a finite value >= 0"
            )
        if t < prev_t:
            raise ValueError(
                f"{where}: time {t} is before the previous event's "
                f"{prev_t} — timelines must be sorted by time (the "
                f"checkpoint event cursor and the boundary-granular "
                f"device application both assume it)"
            )
        prev_t = t
        if ev.kind == "node_down":
            down.add(int(ev.node))
        elif ev.kind == "node_up":
            if int(ev.node) not in down:
                raise ValueError(
                    f"{where}: node_up for node {ev.node} without a prior "
                    f"node_down — recovery of a node that never failed "
                    f"usually means a mis-built timeline"
                )
            down.discard(int(ev.node))
        elif ev.kind == "capacity_scale" and (
            not np.isfinite(float(ev.scale)) or float(ev.scale) < 0
        ):
            raise ValueError(
                f"{where}: capacity_scale factor {ev.scale!r} must be a "
                f"finite value >= 0"
            )
    return events


def events_hash(events: Optional[List[NodeEvent]]) -> np.ndarray:
    """Stable 32-byte digest of a timeline (uint8[32]) — what a
    boundary-mode checkpoint blob stores, so a resume under a DIFFERENT
    event list is rejected instead of silently re-applying or skipping
    events."""
    import hashlib

    items = tuple(
        (float(e.time), str(e.kind), int(e.node), float(e.scale))
        for e in (events or [])
    )
    digest = hashlib.sha256(repr(items).encode()).digest()
    return np.frombuffer(digest, dtype=np.uint8).copy()


@dataclass
class ReplayResult:
    assignments: np.ndarray  # [P] i32 node per pod (PAD = never placed)
    placed: int
    unschedulable: int
    preemptions: int
    attempts: int
    wall_clock_s: float
    placements_per_sec: float
    virtual_makespan: float
    utilization: Dict[str, float]
    state: SchedState
    # The retry buffer's drops and the chaos node_down evictions (NoExecute
    # victims, their re-binds, those never re-placed, and the mean virtual
    # time from eviction to re-bind).
    retry_dropped: int = 0
    evictions: int = 0
    evict_rescheduled: int = 0
    evict_stranded: int = 0
    evict_latency_mean: float = 0.0
    # End-of-replay fragmentation / stranded-capacity / packing gauges
    # (utils.metrics.fragmentation_gauges).
    fragmentation: Optional[dict] = None
    # Telemetry (sim.telemetry.ReplayTelemetry) — None at granularity "off".
    telemetry: Optional[object] = None
    # The route the chunks' waves took (sim.torch_runtime.choose_route):
    # "chunk" (one K6 launch a chunk) or "slot" (K1 -> K2 -> K3 a slot).
    route: Optional[str] = None

    def summary(self) -> dict:
        out = {
            "placed": self.placed,
            "unschedulable": self.unschedulable,
            "preemptions": self.preemptions,
            "attempts": self.attempts,
            "wall_clock_s": round(self.wall_clock_s, 4),
            "placements_per_sec": round(self.placements_per_sec, 1),
            "virtual_makespan": self.virtual_makespan,
            "utilization": {k: round(v, 4) for k, v in self.utilization.items()},
            "retry_dropped": self.retry_dropped,
            "evictions": self.evictions,
            "evict_rescheduled": self.evict_rescheduled,
            "evict_stranded": self.evict_stranded,
            "evict_latency_mean": round(self.evict_latency_mean, 4),
        }
        if self.fragmentation is not None:
            out["fragmentation"] = round_fragmentation(self.fragmentation)
        if self.telemetry is not None:
            out["telemetry"] = self.telemetry.summary()
        return out
