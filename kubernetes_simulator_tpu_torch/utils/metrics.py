"""Metrics and result rows.

Counterpart: ``kubernetes_simulator_tpu/utils/metrics.py`` — what the
``run`` and ``what-if`` commands print: the utilization means, the
telemetry series gauges (``series_gauges`` :122), the end-of-replay
fragmentation gauges, the JSONL writer (``stamp_ts=False`` drops the
wall-clock stamp, as the tuner's trajectory rows need), the replay row,
the what-if rows (``whatif_rows`` :329) and the tuner's row schema
(``TUNE_SCHEMA_VERSION`` :79). The float64
host arithmetic is the reference's, line for line, so both packages give
the same gauges from the same committed state. The multi-process (fleet)
row stamp is not carried over."""

from __future__ import annotations

import hashlib
import json
import logging
import math
import os
import sys
import time
from typing import IO, Dict, Iterable, Optional

import numpy as np


def deterministic_jsonl() -> bool:
    """``KSIM_DETERMINISTIC_JSONL=1`` zeroes every wall-clock-derived
    JSONL field while keeping the fields present as numbers."""
    return os.environ.get("KSIM_DETERMINISTIC_JSONL", "") == "1"


log = logging.getLogger("k8sim.torch")
if not log.handlers:
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s"))
    log.addHandler(_h)
    log.setLevel(logging.INFO)

#: JSONL row schema version of the JAX package's replay rows.
SCHEMA_VERSION = 7
#: Schema of the policy tuner's trajectory rows (``run_type: "tune"``,
#: scripts/check_metrics_schema.py).
TUNE_SCHEMA_VERSION = 3


def config_hash(cfg_dict: dict) -> str:
    """Short stable hash of a config mapping (canonical-JSON sha256)."""
    blob = json.dumps(cfg_dict, sort_keys=True, separators=(",", ":"), default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:12]


def pending_fit_mask(
    used: np.ndarray, allocatable: np.ndarray, request: np.ndarray
) -> np.ndarray:
    """[N] — which nodes could fit ONE request right now, in the Filter's
    own eps form (``ops.reference.fit_mask``)."""
    return np.all(used + request[None, :] <= allocatable + 1e-6, axis=1)


_UTIL_RESOURCES = ("cpu", "memory")


def utilization_means(used, allocatable, rindex) -> Dict[str, float]:
    """Mean per-node utilization fraction per resource name.

    ``used``/``allocatable`` are [N, R]; ``rindex`` maps resource name →
    column. Nodes with zero allocatable (drained / chaos node_down before
    restore) count as 0 utilization, matching the historical inline loops
    this replaces."""
    used = np.asarray(used, dtype=np.float64)
    alloc_all = np.asarray(allocatable, dtype=np.float64)
    util: Dict[str, float] = {}
    for rname in _UTIL_RESOURCES:
        ri = rindex.get(rname)
        if ri is not None:
            alloc = alloc_all[:, ri]
            with np.errstate(invalid="ignore", divide="ignore"):
                u = np.where(alloc > 0, used[:, ri] / np.where(alloc > 0, alloc, 1), 0)
            util[rname] = float(u.mean())
    return util


def series_gauges(used, allocatable, rindex) -> Dict[str, float]:
    """Per-sample utilization gauges of the telemetry series
    (kubernetes_simulator_tpu/utils/metrics.py:122): ``util_cpu`` (mean
    per-node CPU utilization), ``util_mem`` (only when the vocab has a
    memory column) and ``frag_cpu`` (1 − largest free CPU block / total
    free; 0 when nothing is free)."""
    means = utilization_means(used, allocatable, rindex)
    out = {"util_cpu": means.get("cpu", 0.0)}
    if "memory" in means:
        out["util_mem"] = means["memory"]
    ci = rindex.get("cpu")
    frag = 0.0
    if ci is not None:
        alloc = np.asarray(allocatable, dtype=np.float64)[:, ci]
        u = np.asarray(used, dtype=np.float64)[:, ci]
        free = np.maximum(alloc - u, 0.0)
        total_free = float(free.sum())
        if total_free > 0.0:
            frag = 1.0 - float(free.max()) / total_free
    out["frag_cpu"] = frag
    return out


def fragmentation_gauges(allocatable, used, pending_requests, rindex) -> dict:
    """End-of-replay fragmentation / packing gauges.

    - ``stranded[r]``: free capacity on nodes that cannot fit the largest
      still-pending pod (largest by CPU request, memory tie-break, lowest
      pod index last) — the classic stranded-capacity gauge. 0 when no
      pod is pending. The fit test is vector-wise over ALL resource
      columns, so a node is only "usable" if the whole pod fits.
    - ``frag_index[r]``: 1 − largest free block / total free (0 when the
      cluster is fully packed or fully empty).
    - ``packing_efficiency``: ideal node count (sum-of-usage lower bound,
      per-resource ceiling against the largest node) / nodes actually
      touched. 1.0 when nothing is placed.

    Pure float64 numpy on host state — both engines call it with the
    restored allocatable and their committed ``used``/pending sets, so
    the outputs are bit-identical between the two packages."""
    alloc = np.asarray(allocatable, dtype=np.float64)
    used = np.asarray(used, dtype=np.float64)
    req = np.asarray(pending_requests, dtype=np.float64)
    if req.ndim == 1:
        req = req.reshape(0, alloc.shape[1]) if req.size == 0 else req.reshape(1, -1)
    free = np.maximum(alloc - used, 0.0)
    names = [r for r in _UTIL_RESOURCES if rindex.get(r) is not None]

    stranded: Dict[str, float] = {r: 0.0 for r in names}
    stranded_frac: Dict[str, float] = {r: 0.0 for r in names}
    npend = int(req.shape[0])
    if npend:
        n = npend
        ci, mi = rindex.get("cpu"), rindex.get("memory")
        key_cpu = req[:, ci] if ci is not None else np.zeros(n)
        key_mem = req[:, mi] if mi is not None else np.zeros(n)
        # lexsort: last key is primary — biggest CPU, then biggest memory,
        # then lowest index, so the "largest pending pod" is deterministic.
        big = req[int(np.lexsort((np.arange(n), -key_mem, -key_cpu))[0])]
        # The scheduler's own fit arithmetic decides "cannot fit".
        fits = pending_fit_mask(used, alloc, big)
        for r in names:
            ri = rindex[r]
            stranded[r] = float(free[~fits, ri].sum())
            total = float(alloc[:, ri].sum())
            stranded_frac[r] = stranded[r] / total if total > 0 else 0.0

    frag_index: Dict[str, float] = {}
    for r in names:
        ri = rindex[r]
        total_free = float(free[:, ri].sum())
        frag_index[r] = (
            1.0 - float(free[:, ri].max()) / total_free if total_free > 0 else 0.0
        )

    nodes_active = int(np.any(used > 0, axis=1).sum())
    nodes_ideal = 0
    for r in names:
        ri = rindex[r]
        cap = float(alloc[:, ri].max()) if alloc.shape[0] else 0.0
        total_used = float(used[:, ri].sum())
        if cap > 0 and total_used > 0:
            nodes_ideal = max(nodes_ideal, int(np.ceil(total_used / cap)))
    packing = float(nodes_ideal) / nodes_active if nodes_active else 1.0
    return {
        "stranded": stranded,
        "stranded_frac": stranded_frac,
        "frag_index": frag_index,
        "packing_efficiency": packing,
        "nodes_active": nodes_active,
        "nodes_ideal": nodes_ideal,
        "pending": npend,
    }


def round_fragmentation(frag: Optional[dict]) -> Optional[dict]:
    """JSONL/summary-friendly copy of a fragmentation_gauges() dict with
    floats rounded to 6 places (virtual-time-deterministic, so no
    KSIM_DETERMINISTIC_JSONL scrub is needed)."""
    if frag is None:
        return None
    out: dict = {}
    for k, v in frag.items():
        if isinstance(v, dict):
            out[k] = {kk: round(float(vv), 6) for kk, vv in v.items()}
        elif isinstance(v, float):
            out[k] = round(v, 6)
        else:
            out[k] = v
    return out


class JsonlWriter:
    """Append-mode JSONL sink (stdout when ``path`` is None). Usable as a
    context manager — the CLI wraps whole commands in ``with`` so the file
    is closed (rows flushed) even when the run raises. Every row is
    stamped with ``ts``, ``schema`` and the writer's ``context`` (seed /
    engine / config hash); explicit row keys win over context keys."""

    def __init__(self, path: Optional[str] = None, context: Optional[dict] = None):
        self.path = path
        self.context = dict(context or {})
        self._f: Optional[IO] = open(path, "a") if path else None

    def write(self, row: dict, stamp_ts: bool = True) -> None:
        stamp = (
            {"ts": 0.0 if deterministic_jsonl() else time.time()}
            if stamp_ts
            else {}
        )
        row = {
            **stamp,
            "schema": SCHEMA_VERSION,
            **self.context,
            **row,
        }
        line = json.dumps(row)
        if self._f:
            self._f.write(line + "\n")
            self._f.flush()
        else:
            print(line)

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None

    def __enter__(self) -> "JsonlWriter":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


def _scrub_timing(row: dict) -> dict:
    """Zero wall-clock-derived fields under KSIM_DETERMINISTIC_JSONL."""
    if deterministic_jsonl():
        for k in ("wall_clock_s", "placements_per_sec", "latency_s", "queue_wait_s"):
            if k in row:
                row[k] = 0.0
    return row


def replay_row(kind: str, res, extra: Optional[dict] = None) -> dict:
    row = {"kind": kind, **res.summary()}
    if extra:
        row.update(extra)
    return _scrub_timing(row)


def whatif_rows(res, extra: Optional[dict] = None) -> Iterable[dict]:
    """One ``whatif-aggregate`` row and one ``whatif-scenario`` row per
    scenario; a batch run with tier preemption adds each scenario's
    ``preemptions`` (its victims), and ``retry_dropped`` rides with them
    where the result has both, as in the reference's rows
    (kubernetes_simulator_tpu/utils/metrics.py:342-390; its retry what-if
    without preemption reports no per-scenario drops there). A kube batch
    adds each scenario's chaos counters ``evictions`` / ``evict_*`` (zero
    in a scenario without a timeline), its fragmentation gauges
    ``stranded_cpu`` / ``frag_index_cpu`` / ``packing_efficiency`` and,
    with telemetry on, its first-bind latency quantiles ``latency_p50`` /
    ``_p90`` / ``_p99`` (None where it bound nothing), rounded as the
    reference rounds them."""
    base = extra or {}
    pre = getattr(res, "preemptions", None)
    drop = getattr(res, "retry_dropped", None)
    evi = getattr(res, "evictions", None)
    lat50 = getattr(res, "latency_p50", None)
    str_cpu = getattr(res, "stranded_cpu", None)
    yield _scrub_timing({
        "kind": "whatif-aggregate",
        "scenarios": int(res.placed.shape[0]),
        "total_placed": res.total_placed,
        "wall_clock_s": round(res.wall_clock_s, 4),
        "placements_per_sec": round(res.placements_per_sec, 1),
        "completions_on": bool(res.completions_on),
        "engine": res.engine,
        **base,
    })
    for s in range(res.placed.shape[0]):
        row = {
            "kind": "whatif-scenario",
            "scenario": s,
            "placed": int(res.placed[s]),
            "unschedulable": int(res.unschedulable[s]),
            "utilization_cpu": (
                round(float(res.utilization_cpu[s]), 4) if res.utilization_cpu is not None else None
            ),
            **base,
        }
        if pre is not None:
            row["preemptions"] = int(pre[s])
            if drop is not None:
                row["retry_dropped"] = int(drop[s])
        if evi is not None:
            row["evictions"] = int(evi[s])
            row["evict_rescheduled"] = int(res.evict_rescheduled[s])
            row["evict_stranded"] = int(res.evict_stranded[s])
            row["evict_latency_mean"] = round(float(res.evict_latency_mean[s]), 4)
        if lat50 is not None:
            for key, arr in (("latency_p50", lat50), ("latency_p90", res.latency_p90),
                             ("latency_p99", res.latency_p99)):
                v = float(arr[s])
                row[key] = None if math.isnan(v) else round(v, 6)
        if str_cpu is not None:
            row["stranded_cpu"] = round(float(str_cpu[s]), 6)
            row["frag_index_cpu"] = round(float(res.frag_index_cpu[s]), 6)
            row["packing_efficiency"] = round(float(res.packing_efficiency[s]), 6)
        yield row
