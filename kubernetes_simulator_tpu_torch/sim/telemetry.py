"""Replay telemetry at granularity ``off`` or ``summary``.

Counterpart: ``kubernetes_simulator_tpu/sim/telemetry.py`` — the
``summary`` level: the first-bind latency histogram (a placement in its
arrival wave has latency 0; one by the retry buffer's pass waits until its
boundary) and the wall-clock phase timers. ``series`` and ``timeline`` (rejection attribution, depth series,
timeline events) are a later slice of the port and raise here.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

# Fixed exponential bucket edges (virtual seconds), kube-histogram style.
LATENCY_BUCKETS: Tuple[float, ...] = (
    0.0, 0.5, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0, 512.0,
)

_LEVELS = ("off", "summary")
_LATER = ("series", "timeline")

#: Canonical phase-timer names (the JAX package's PHASE_NAMES).
PHASE_NAMES = ("dispatch", "device_wait", "boundary_fold", "host_mirror")


def resolve_granularity(v: Optional[str]) -> str:
    """None → "summary"; "off"/"summary" pass; later levels raise."""
    g = "summary" if v is None else str(v)
    if g in _LATER:
        raise NotImplementedError(
            f"telemetry granularity {g!r} (rejection attribution, series, "
            "timeline) is not ported yet: the port's engine collects "
            "'off' or 'summary'"
        )
    if g not in _LEVELS:
        raise ValueError(
            f"telemetry granularity {g!r} must be one of "
            f"{', '.join(_LEVELS + _LATER)}"
        )
    return g


def latency_summary(zero_count: int, values: Sequence[float]) -> Optional[dict]:
    """count/mean/p50/p90/p99 plus cumulative fixed-bucket counts of the
    first-bind latencies (``zero_count`` exact zeros + ``values``);
    quantiles by ``np.percentile(method='lower')`` as the reference."""
    vals = np.asarray(list(values), dtype=np.float64)
    n = int(zero_count) + vals.size
    if n == 0:
        return None
    arr = np.concatenate([np.zeros(int(zero_count), dtype=np.float64), vals])
    arr.sort()
    idx = np.searchsorted(arr, np.asarray(LATENCY_BUCKETS), side="right")
    buckets: Dict[str, int] = {
        f"le_{edge:g}": int(c) for edge, c in zip(LATENCY_BUCKETS, idx)
    }
    buckets["le_inf"] = n
    p50, p90, p99 = (
        float(np.percentile(arr, q, method="lower")) for q in (50, 90, 99)
    )
    return {
        "count": n,
        "mean": float(arr.mean()),
        "max": float(arr[-1]),
        "p50": p50,
        "p90": p90,
        "p99": p99,
        "buckets": buckets,
    }


def first_bind_latency(placed: int, retry_waits: Sequence[float]) -> Optional[dict]:
    """The summary histogram of a run's ``placed`` first binds: a pod
    placed in its arrival wave waits 0; one placed by the retry pass waits
    from its arrival to the start time of its boundary (``retry_waits``;
    boundary-granular, kubernetes_simulator_tpu/sim/boundary.py:614-628),
    counted as 0 when that is not later."""
    waits = np.asarray(list(retry_waits), dtype=np.float64)
    later = waits[waits > 0.0]
    return latency_summary(int(placed) - later.size, later)


class PhaseTimers:
    """Accumulating wall-clock phase breakdown; ``tick(phase)`` is a
    context manager costing two ``perf_counter`` calls (chunk cadence)."""

    def __init__(self):
        self.acc: Dict[str, float] = {}

    class _Tick:
        __slots__ = ("timers", "phase", "t0")

        def __init__(self, timers: "PhaseTimers", phase: str):
            self.timers = timers
            self.phase = phase

        def __enter__(self):
            self.t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            self.timers.add(self.phase, time.perf_counter() - self.t0)
            return False

    def tick(self, phase: str) -> "_Tick":
        return PhaseTimers._Tick(self, phase)

    def add(self, phase: str, dt: float) -> None:
        self.acc[phase] = self.acc.get(phase, 0.0) + dt

    def summary(self) -> Dict[str, float]:
        return {k: round(v, 6) for k, v in sorted(self.acc.items())}


@dataclass
class ReplayTelemetry:
    """Telemetry attached to ``ReplayResult.telemetry`` (None at ``off``)."""

    granularity: str
    latency: Optional[dict] = None
    phases: Dict[str, float] = field(default_factory=dict)

    def summary(self) -> dict:
        out: dict = {"granularity": self.granularity, "phases": self.phases}
        if self.latency is not None:
            out["latency"] = self.latency
        return out
