"""Replay telemetry: granularity ``off`` / ``summary`` / ``series`` /
``timeline``.

Counterpart: ``kubernetes_simulator_tpu/sim/telemetry.py`` —
``TelemetryConfig`` (:71), ``latency_summary`` (:102), ``PhaseTimers``
(:150), ``ReplayTelemetry`` with ``summary`` / ``query_view`` (:178-235),
``TelemetryCollector`` with its episode semantics (:338-437; the host
hooks ``rejection`` / ``clear_episode`` that the CPU event engine calls),
``first_reject_counts_host`` (:440-460), and the
Chrome-trace export ``_trace_events`` / ``write_chrome_trace``
(:462-589). The fleet merges (``ReplayTelemetry.merge``,
``write_chrome_trace_merged``) come with the multi-process fleet.

- ``summary``: the first-bind latency histogram (a placement in its
  arrival wave has latency 0; one by the retry buffer's pass waits until
  its boundary) and the wall-clock phase timers.
- ``series``: + the kube "0/N nodes available" first-reject attribution
  (``reasons`` per unschedulable episode, ``rejection_attempts`` per failed
  attempt; counted on the card by K5 and fetched once a run) and the
  virtual-time series sampled at chunk boundaries.
- ``timeline``: + the bind, preempt, evict, node_down and node_up events
  and the Chrome-trace export (load it in Perfetto).
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# Fixed exponential bucket edges (virtual seconds), kube-histogram style.
LATENCY_BUCKETS: Tuple[float, ...] = (
    0.0, 0.5, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0, 512.0,
)

_LEVELS = ("off", "summary", "series", "timeline")

#: Canonical phase-timer names (the JAX package's PHASE_NAMES).
PHASE_NAMES = ("dispatch", "device_wait", "boundary_fold", "host_mirror")


@dataclass(frozen=True)
class TelemetryConfig:
    granularity: str = "summary"

    def __post_init__(self):
        if self.granularity not in _LEVELS:
            raise ValueError(
                f"telemetry granularity {self.granularity!r} must be one of "
                f"{', '.join(_LEVELS)}"
            )

    @classmethod
    def resolve(cls, v) -> "TelemetryConfig":
        """None → default (summary); str → validated; config → itself."""
        if v is None:
            return cls()
        if isinstance(v, cls):
            return v
        return cls(granularity=str(v))

    @property
    def enabled(self) -> bool:
        return self.granularity != "off"

    @property
    def want_series(self) -> bool:
        return _LEVELS.index(self.granularity) >= 2

    @property
    def want_timeline(self) -> bool:
        return _LEVELS.index(self.granularity) >= 3


def resolve_granularity(v) -> str:
    """The granularity name of ``v`` (None → "summary"; a str or a
    :class:`TelemetryConfig`); an unknown level raises ``ValueError``."""
    return TelemetryConfig.resolve(v).granularity


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
    """Telemetry attached to ``ReplayResult.telemetry`` (None at ``off``);
    plain picklable data, never device tensors."""

    granularity: str
    # Latency histogram (latency_summary); None when nothing bound.
    latency: Optional[dict] = None
    # Per-episode first-reject counts by plugin name ("unschedulable
    # reasons").
    reasons: Optional[Dict[str, int]] = None
    # Per-attempt first-reject counts (cadence-dependent; >= reasons).
    rejection_attempts: Optional[Dict[str, int]] = None
    # Virtual-time series: {"t": [...], "<gauge or depth>": [...], ...}.
    series: Optional[Dict[str, List[float]]] = None
    # Wall-clock phase accumulators (seconds).
    phases: Dict[str, float] = field(default_factory=dict)
    # First-bind latencies of pods that did not bind in their arrival wave
    # (pod → virtual seconds) and the count of exact-zero binds.
    bind_latency: Dict[int, float] = field(default_factory=dict)
    zero_latency_binds: int = 0
    # Timeline events: (kind, t, pod, node), pod/node = -1 when n/a.
    events: List[Tuple[str, float, int, int]] = field(default_factory=list)

    def summary(self) -> dict:
        out: dict = {"granularity": self.granularity, "phases": self.phases}
        if self.latency is not None:
            out["latency"] = self.latency
        if self.reasons is not None:
            out["reasons"] = dict(self.reasons)
            out["rejection_attempts"] = dict(self.rejection_attempts or {})
        if self.series is not None:
            out["series_samples"] = len(self.series.get("t", ()))
        if self.events:
            out["timeline_events"] = len(self.events)
        return out

    def query_view(self) -> dict:
        """JSON-ready view: :meth:`summary` without the phase timers, plus
        the raw virtual-time series."""
        out = self.summary()
        out.pop("phases", None)
        if self.series is not None:
            out["series"] = {k: [float(v) for v in vs] for k, vs in self.series.items()}
        return out


class TelemetryCollector:
    """Mutable per-replay accumulator; :meth:`result` freezes it into a
    :class:`ReplayTelemetry`.

    The rejection attribution's episode semantics (a pod's first
    fully-failed attempt charges ``reasons``, every failed attempt charges
    ``rejection_attempts``, until a bind or an eviction re-arms the pod) are
    applied on the card by K5 and its twin ``ops.reference.first_reject``;
    the device engines hand the fetched totals to :meth:`rejection_totals`.
    The CPU event engine (:class:`.runtime.CpuReplayEngine`) charges each
    failed attempt on the host through :meth:`rejection` and
    :meth:`clear_episode` (the reference's per-attempt hooks)."""

    def __init__(self, config=None):
        self.cfg = TelemetryConfig.resolve(config)
        self.phases = PhaseTimers()
        self._lat: Dict[int, float] = {}
        self._zero = 0
        self._reasons: Dict[str, int] = {}
        self._attempts: Dict[str, int] = {}
        self._attributed: set = set()
        self._series: Dict[str, List[float]] = {}
        self._events: List[Tuple[str, float, int, int]] = []

    # -- latency ----------------------------------------------------------

    def bind_zero(self, n: int = 1) -> None:
        """n pods bound at their arrival instant/wave (latency exactly 0)."""
        self._zero += int(n)

    def bind_latency(self, pod: int, lat: float) -> None:
        """First bind of ``pod`` at ``lat`` virtual seconds after arrival."""
        self._lat[int(pod)] = float(lat)

    # -- rejection attribution -------------------------------------------

    def rejection_totals(self, names: Sequence[str], reasons, attempts) -> None:
        """[K] per-episode and per-attempt totals in plugin order, counted
        with the episode semantics already applied (the card's K5
        counters)."""
        for k, r, a in zip(names, np.asarray(reasons).tolist(), np.asarray(attempts).tolist()):
            if a:
                self._attempts[k] = self._attempts.get(k, 0) + int(a)
            if r:
                self._reasons[k] = self._reasons.get(k, 0) + int(r)

    def rejection(self, pod: int, counts: Dict[str, int]) -> None:
        """One fully-failed scheduling attempt of ``pod`` on the host, with
        its first-reject ``counts`` by plugin name: every attempt charges
        ``rejection_attempts``, the first of an episode ``reasons``."""
        for k, v in counts.items():
            self._attempts[k] = self._attempts.get(k, 0) + int(v)
        if pod not in self._attributed:
            self._attributed.add(pod)
            for k, v in counts.items():
                self._reasons[k] = self._reasons.get(k, 0) + int(v)

    def clear_episode(self, pod: int) -> None:
        """A bind or an eviction ends the pod's unschedulable episode."""
        self._attributed.discard(int(pod))

    # -- series / timeline ------------------------------------------------

    def sample(self, t: float, **depths: float) -> None:
        self._series.setdefault("t", []).append(float(t))
        for k, v in depths.items():
            self._series.setdefault(k, []).append(float(v))

    def event(self, kind: str, t: float, pod: int = -1, node: int = -1) -> None:
        self._events.append((kind, float(t), int(pod), int(node)))

    # -- finalize ---------------------------------------------------------

    def result(self) -> Optional[ReplayTelemetry]:
        if not self.cfg.enabled:
            return None
        tel = ReplayTelemetry(
            granularity=self.cfg.granularity,
            latency=latency_summary(self._zero, list(self._lat.values())),
            phases=self.phases.summary(),
            bind_latency=dict(self._lat),
            zero_latency_binds=self._zero,
        )
        if self.cfg.want_series:
            # Zero entries are dropped, as the reference drops them.
            tel.reasons = {k: v for k, v in self._reasons.items() if v}
            tel.rejection_attempts = {k: v for k, v in self._attempts.items() if v}
            tel.series = {k: list(v) for k, v in self._series.items()}
        if self.cfg.want_timeline:
            tel.events = list(self._events)
        return tel


def first_reject_counts_host(
    plugins, ctx, st, p: int, num_nodes: int
) -> Tuple[np.ndarray, Dict[str, int]]:
    """Host-side first-reject attribution: run the Filter chain charging
    each node to the first plugin that rejects it. Returns (final mask,
    counts); the counts are those of ``SchedulerFramework.feasible_mask``
    with ``reject_counts``, whose early stop loses nothing."""
    mask = np.ones(num_nodes, dtype=bool)
    counts: Dict[str, int] = {}
    for pl in plugins:
        counts[pl.name] = 0
        m = pl.filter(ctx, st, p)
        if m is not None:
            counts[pl.name] = int((mask & ~m).sum())
            mask &= m
    return mask, counts


# -- Chrome-trace (Perfetto) export --------------------------------------


def _trace_events(
    res,
    arrival: Optional[np.ndarray] = None,
    duration: Optional[np.ndarray] = None,
    requests: Optional[np.ndarray] = None,
    rindex: Optional[Dict[str, int]] = None,
) -> List[dict]:
    """Trace events of one result: pids 0 ("cluster") / 1 ("chaos"); a pod
    span per placed pod from its first bind to its completion (or the
    makespan) on its node's row, per-node cpu/memory usage counters with
    ``requests`` and ``rindex``, each ``node_down`` → ``node_up`` window as
    a ``node<n> down`` span on the chaos track (a node that never comes back
    down to the makespan), and every other timeline event (``bind``,
    ``preempt``, ``evict``) as an instant on its node's row."""
    tel = getattr(res, "telemetry", None)
    assignments = np.asarray(res.assignments)
    makespan = float(getattr(res, "virtual_makespan", 0.0))
    ev: List[dict] = [
        {"name": "process_name", "ph": "M", "pid": 0, "args": {"name": "cluster"}},
        {"name": "process_name", "ph": "M", "pid": 1, "args": {"name": "chaos"}},
    ]
    used_nodes = sorted({int(n) for n in assignments if n >= 0})
    for n in used_nodes:
        ev.append({"name": "thread_name", "ph": "M", "pid": 0,
                   "tid": n, "args": {"name": f"node{n}"}})
    lat = tel.bind_latency if tel is not None else {}
    spans: List[tuple] = []  # (pod, node, start, end)
    if arrival is not None:
        placed = np.nonzero(assignments >= 0)[0]
        for p in placed.tolist():
            start = float(arrival[p]) + float(lat.get(p, 0.0))
            end = makespan
            if duration is not None and np.isfinite(duration[p]):
                end = min(end, start + float(duration[p]))
            spans.append((p, int(assignments[p]), start, end))
            ev.append({
                "name": f"pod{p}", "ph": "X", "pid": 0,
                "tid": int(assignments[p]),
                "ts": start * 1e6, "dur": max(end - start, 0.0) * 1e6,
            })
    if requests is not None and rindex is not None and spans:
        req = np.asarray(requests, dtype=np.float64)
        cols = [
            (rn, ri) for rn, ri in sorted(rindex.items(), key=lambda kv: kv[1])
            if rn in ("cpu", "memory")
        ]
        deltas: Dict[int, Dict[float, np.ndarray]] = {}
        for p, n, start, end in spans:
            d = deltas.setdefault(n, {})
            r = req[p, [ri for _, ri in cols]]
            d[start] = d.get(start, 0.0) + r
            d[end] = d.get(end, 0.0) - r
        for n in sorted(deltas):
            run = np.zeros(len(cols), dtype=np.float64)
            for t in sorted(deltas[n]):
                run = run + deltas[n][t]
                ev.append({
                    "name": f"node{n} usage", "ph": "C", "pid": 0,
                    "tid": n, "ts": t * 1e6,
                    "args": {rn: round(float(run[k]), 6) for k, (rn, _) in enumerate(cols)},
                })
    down_at: Dict[int, float] = {}
    for kind, t, pod, node in (tel.events if tel is not None else ()):
        if kind == "node_down":
            down_at[node] = t
        elif kind == "node_up":
            t0 = down_at.pop(node, t)
            ev.append({"name": f"node{node} down", "ph": "X", "pid": 1, "tid": node,
                       "ts": t0 * 1e6, "dur": max(t - t0, 0.0) * 1e6})
        else:
            ev.append({
                "name": kind, "ph": "i", "s": "t", "pid": 0,
                "tid": node if node >= 0 else 0, "ts": t * 1e6,
                "args": ({"pod": pod} if pod >= 0 else {}),
            })
    for node, t0 in sorted(down_at.items()):
        # a node that never came back: its span runs to the makespan
        ev.append({"name": f"node{node} down", "ph": "X", "pid": 1, "tid": node,
                   "ts": t0 * 1e6, "dur": max(makespan - t0, 0.0) * 1e6})
    return ev


def write_chrome_trace(
    path: str,
    res,
    arrival: Optional[np.ndarray] = None,
    duration: Optional[np.ndarray] = None,
    requests: Optional[np.ndarray] = None,
    rindex: Optional[Dict[str, int]] = None,
) -> int:
    """Export the simulated cluster timeline of ``res`` as a Chrome trace
    JSON (virtual seconds → trace microseconds; see :func:`_trace_events`).
    Returns the number of trace events written."""
    ev = _trace_events(res, arrival, duration, requests=requests, rindex=rindex)
    with open(path, "w") as f:
        json.dump({"traceEvents": ev, "displayTimeUnit": "ms"}, f)
    return len(ev)
