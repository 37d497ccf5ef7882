"""Real Borg-2019 schema ETL.

Counterpart: ``kubernetes_simulator_tpu/sim/borg_etl.py`` (``Borg2019Etl``
:88 and ``load_borg2019`` :319) on its ``csv.DictReader`` path only: the
reference's fast path, the C++ event parser of ``native/borg2019.cpp`` and
its vectorized aggregation, stays with the JAX package, whose tests pin it
value-identical to this path (``test_native_ingest_matches_dictreader``).

Maps the Google cluster-usage trace v3 ("ClusterData2019") table exports —
``instance_events`` and optionally ``collection_events`` CSV files — into
the columnar form consumed by :func:`..sim.borg.encoded_from_cols`, which
runs the normal template-expansion Encoder path. The dataset itself is not
in the repository; the mapper is exercised by tests that write tiny files
in the real schema (tests/test_torch_borg.py, as tests/test_borg_etl.py
does for the reference).

Schema mapping:
- instance SUBMIT (type 0) → task arrival; the first SUBMIT per
  (collection_id, instance_index) wins.
- FINISH/KILL (types 6/7) → duration = end − arrival (missing → ∞).
- ``alloc_collection_id`` > 0 → pod-group membership (alloc set ≈ gang);
  group ids are remapped first-appearance by encoded_from_cols, and gang
  members are reordered to co-arrive at the set's first submit (the
  alloc-set semantic; pack_waves needs members adjacent).
- ``priority`` (0..450) → pod priority (the 2019 tiering).
- ``collection_id`` → app id (template class) — remapped first-appearance
  and wrapped into the template vocabulary by encoded_from_cols.
- priority < 120 (free + BEB tiers) → tolerates the ``dedicated=batch``
  taint, mirroring the generator's toleration rule.
- resource_request.cpus / .memory are normalized to the largest machine:
  scaled by ``cpu_scale`` / ``mem_scale`` into the synthetic cluster's
  units.
- timestamps are microseconds with a 600 s lead-in: converted to seconds
  from trace start, clamped at 0.

Column names accept both the BigQuery export form
(``resource_request.cpus``) and flattened variants (``cpus``/``cpu``).
Event types accept the integer enum or the upper-case name.
"""

from __future__ import annotations

import csv
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from ..models.encode import EncodedCluster, EncodedPods
from .borg import BorgSpec, encoded_from_cols

SUBMIT, FINISH, KILL = 0, 6, 7
_TYPE_NAMES = {
    "SUBMIT": SUBMIT, "QUEUE": 1, "ENABLE": 2, "SCHEDULE": 3, "EVICT": 4,
    "FAIL": 5, "FINISH": FINISH, "KILL": KILL, "LOST": 8,
    "UPDATE_PENDING": 9, "UPDATE_RUNNING": 10,
}
_US = 1e-6
_LEAD_S = 600.0
#: free (≤99) and best-effort-batch (100..119) tiers tolerate batch taints.
_BATCH_PRIORITY_MAX = 119


def _etype(v: str) -> int:
    v = v.strip()
    if not v:
        return -1
    if v.upper() in _TYPE_NAMES:
        return _TYPE_NAMES[v.upper()]
    try:
        return int(float(v))
    except ValueError:
        return -1


def _col(row: dict, *names, default=""):
    for n in names:
        if n in row and row[n] != "":
            return row[n]
    return default


def _to_id(v: str) -> int:
    """Integer id parse without a float round-trip (ids above 2^53 must
    stay exact — the INT64 schema allows them); decimal/scientific
    notation from float-typed re-exports still parses via float."""
    try:
        return int(v)
    except ValueError:
        return int(float(v))


@dataclass
class Borg2019Etl:
    """Streaming mapper: real-schema CSVs → encoded trace columns."""

    instance_events: str
    collection_events: Optional[str] = None
    cpu_scale: float = 8.0
    mem_scale: float = 16.0 * 2**30

    def read_cols(self) -> Dict[str, np.ndarray]:
        """Columnar task table, one ``csv.DictReader`` pass over each file."""
        return self._cols_dictreader()

    def _cols_dictreader(self) -> Dict[str, np.ndarray]:
        # Optional job-level fallbacks (priority / alloc set) keyed by
        # collection_id, from collection_events.
        job_prio: Dict[int, int] = {}
        job_alloc: Dict[int, int] = {}
        if self.collection_events:
            with open(self.collection_events, newline="") as f:
                for row in csv.DictReader(f):
                    if _etype(_col(row, "type")) != SUBMIT:
                        continue
                    cid = _to_id(_col(row, "collection_id", default="0"))
                    p = _col(row, "priority")
                    if p != "":
                        job_prio[cid] = _to_id(p)
                    a = _col(row, "alloc_collection_id")
                    if a != "":
                        job_alloc[cid] = _to_id(a)

        # One streaming pass over instance_events: the FIRST SUBMIT wins
        # the task row (arrival); FINISH/KILL record the end time. A
        # re-scheduled instance (EVICT → re-SUBMIT cycles are common in
        # the real trace) anchors its duration at the LAST submit before
        # the end, so the replay holds resources for the final runtime —
        # not the whole eviction-spanning lifetime.
        tasks: Dict[Tuple[int, int], list] = {}
        ends: Dict[Tuple[int, int], float] = {}
        last_submit: Dict[Tuple[int, int], float] = {}
        with open(self.instance_events, newline="") as f:
            for row in csv.DictReader(f):
                et = _etype(_col(row, "type"))
                cid = _to_id(_col(row, "collection_id", default="0"))
                iidx = _to_id(_col(row, "instance_index", default="0"))
                key = (cid, iidx)
                t = float(_col(row, "time", default="0")) * _US - _LEAD_S
                if et == SUBMIT:
                    last_submit[key] = max(
                        max(t, 0.0), last_submit.get(key, 0.0)
                    )
                    if key in tasks:
                        continue
                    prio = _col(row, "priority")
                    prio = (
                        _to_id(prio) if prio != ""
                        else job_prio.get(cid, 0)
                    )
                    alloc = _col(row, "alloc_collection_id")
                    alloc = (
                        _to_id(alloc) if alloc != ""
                        else job_alloc.get(cid, 0)
                    )
                    cpu = float(
                        _col(row, "resource_request.cpus", "cpus", "cpu",
                             default="0")
                    )
                    mem = float(
                        _col(row, "resource_request.memory", "memory", "mem",
                             default="0")
                    )
                    tasks[key] = [max(t, 0.0), cpu, mem, prio, alloc, cid]
                elif et in (FINISH, KILL):
                    ends[key] = max(t, 0.0)

        P = len(tasks)
        if P == 0:
            raise ValueError(
                f"no instance SUBMIT events in {self.instance_events}"
            )
        keys = list(tasks.keys())
        arr = np.array([tasks[k][0] for k in keys], np.float64)
        cpu = np.array([tasks[k][1] for k in keys], np.float32) * np.float32(
            self.cpu_scale
        )
        mem = np.array([tasks[k][2] for k in keys], np.float32) * np.float32(
            self.mem_scale
        )
        prio = np.array([tasks[k][3] for k in keys], np.int64)
        alloc = np.array([tasks[k][4] for k in keys], np.int64)
        appid = np.array([tasks[k][5] for k in keys], np.int64)
        def _dur(k):
            if k not in ends:
                return np.inf
            start = last_submit.get(k, tasks[k][0])
            if start > ends[k]:
                # Re-SUBMIT after the last FINISH/KILL: the restarted
                # incarnation is still running at trace end — hold its
                # resources for the remainder (clamping to the stale end
                # would give duration 0, freeing them instantly).
                return np.inf
            return max(ends[k] - start, 0.0)

        dur = np.array([_dur(k) for k in keys], np.float32)
        return self._finish_cols(arr, cpu, mem, prio, alloc, appid, dur)

    def _finish_cols(self, arr, cpu, mem, prio, alloc, appid, dur):
        """Shared tail: alloc sets → gangs with co-arrival + final sort."""
        group = np.where(alloc > 0, alloc, -1)
        # Alloc-set members co-arrive at the set's first submit and must be
        # index-adjacent (pack_waves packs a gang into one wave).
        sort_t = np.asarray(arr, np.float64).copy()
        gm = group >= 0
        if gm.any():
            u, inv = np.unique(group[gm], return_inverse=True)
            mins = np.full(len(u), np.inf)
            np.minimum.at(mins, inv, arr[gm])
            sort_t[gm] = mins[inv]
        order = np.lexsort((arr, group, sort_t))
        arr2 = sort_t[order]  # gang members share the set's arrival
        return {
            "arrival": arr2,
            "cpu": cpu[order],
            "mem": mem[order],
            "priority": prio[order].astype(np.int32),
            "group_id": group[order],
            "app_id": appid[order],
            "tolerates": (prio[order] <= _BATCH_PRIORITY_MAX).astype(np.int32),
            "duration": dur[order],
        }


def load_borg2019(
    instance_events: str,
    spec: BorgSpec,
    collection_events: Optional[str] = None,
    cpu_scale: float = 8.0,
    mem_scale: float = 16.0 * 2**30,
) -> Tuple[EncodedCluster, EncodedPods, dict]:
    """Real-schema ingest → (EncodedCluster, EncodedPods, meta): the
    Borg-2019 counterpart of sim.borg.load_trace_csv. ``spec`` supplies
    the cluster shape and template vocabulary."""
    etl = Borg2019Etl(
        instance_events=instance_events,
        collection_events=collection_events,
        cpu_scale=cpu_scale,
        mem_scale=mem_scale,
    )
    return encoded_from_cols(spec, etl.read_cols())
