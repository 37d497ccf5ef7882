"""Replay result type.

Counterpart: ``kubernetes_simulator_tpu/sim/runtime.py`` — the
:class:`ReplayResult` only, field for field, so rows and tests read both
packages' results alike. The JAX package's CPU event engine is not part
of the port.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from ..models.state import SchedState
from ..utils.metrics import round_fragmentation


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
    # Counters of the modes the port does not carry yet (retry buffer,
    # chaos evictions); kept so a result row has the reference's shape.
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
