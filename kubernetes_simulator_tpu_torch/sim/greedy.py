"""Greedy wave replay, numpy host edition: the port's CPU anchor.

Counterpart: ``kubernetes_simulator_tpu/sim/greedy.py`` (``greedy_replay``
:106, ``_try_tier_preempt`` :56; ``priority_tiers`` and
``normalize_preemption`` are :mod:`.tiers`' copies) and the part of
``kubernetes_simulator_tpu/sim/boundary.py`` ``BoundaryOps`` (:77-546)
that it drives: the static and pending completion releases and the
bounded retry pass at each chunk boundary.

The algorithm is the one the device engines run — arrival-order waves,
sequential slots with speculative binds, wave-boundary gang
commit/rollback — on the host, through the numpy plugin chain of
:class:`..framework.framework.SchedulerFramework`. The policy tuner
re-checks its winner here (a held-out scenario's perturbed cluster with
the winning weights as an ordinary config), and the tests hold the port's
engines against it.

``preemption="tier"`` (or ``True``) adds the greedy engines' tier
preemption: when a pod is unschedulable, a node may be chosen where
evicting ALL lower-priority non-gang pods makes it fit (resource fit +
the other filters at their current, pre-eviction values); candidates
rank by (fewest victims, lowest max victim tier, lowest index). Evicted
pods become unplaced and are not re-queued, and their affinity/spread
counts are not rewound ("phantom counts"). At most one preemption fires
per wave; gang pods neither preempt nor get evicted.

``preemption="kube"`` (the minimal-victims PostFilter at chunk
boundaries) is refused by name: it needs the PostFilter, which is not
ported yet (queue A items 6 and 13).
"""

from __future__ import annotations

import time
from dataclasses import replace as dc_replace
from typing import List, Optional

import numpy as np

from ..framework.framework import FrameworkConfig, SchedulerFramework
from ..models.encode import PAD, EncodedCluster, EncodedPods
from ..models.state import bind, init_state, release_delta, unbind
from ..utils.metrics import fragmentation_gauges, utilization_means
from .runtime import ReplayResult
from .tiers import normalize_preemption, priority_tiers
from .waves import WaveBatch, pack_waves

_NEVER = 1 << 30  # bind_chunk sentinel: never statically released


def _try_tier_preempt(fw, ec, ep, st, p, pod_tier):
    """The anchor's preemption decision. Returns (node, victims) or None."""
    tp = int(pod_tier[p])
    if ep.group_id[p] != PAD or tp == 0:
        return None
    bound = st.bound
    lower = np.nonzero((bound >= 0) & (pod_tier < tp) & (ep.group_id == PAD))[0]
    if lower.size == 0:
        return None
    N = ec.num_nodes
    victims_n = np.zeros(N, np.int64)
    np.add.at(victims_n, bound[lower], 1)
    lower_used = np.zeros((N, ec.num_resources), np.float32)
    np.add.at(lower_used, bound[lower], ep.requests[lower])
    # Fit after evict-all-lower (same eps form as ops.cpu.fit_mask).
    pre_fit = np.all(
        st.used - lower_used + ep.requests[p][None, :] <= ec.allocatable + 1e-6, axis=1,
    )
    # All non-fit filters at their current (pre-eviction) values.
    masks = np.ones(N, bool)
    for pl in fw.plugins:
        if pl.name == "NodeResourcesFit":
            continue
        m = pl.filter(fw.ctx, st, p)
        if m is not None:
            masks &= m
    cand = pre_fit & masks & (victims_n > 0)
    if not cand.any():
        return None
    maxtier_n = np.full(N, -1, np.int64)
    np.maximum.at(maxtier_n, bound[lower], pod_tier[lower].astype(np.int64))
    score = victims_n * 1024 + maxtier_n
    score = np.where(cand, score, np.iinfo(np.int64).max)
    n = int(np.argmin(score))  # lowest index on ties
    victims = lower[bound[lower] == n]
    return n, victims


class _Boundary:
    """Host bookkeeping and the boundary passes of the greedy anchor
    (``BoundaryOps`` without the kube PostFilter, the device-chunk fold,
    the lazy plane log, chaos evictions, checkpoints and telemetry): the
    live state, assignments, counters, the FIFO retry buffer and the
    pending releases of retry-placed pods."""

    def __init__(self, ec: EncodedCluster, ep: EncodedPods, fw: SchedulerFramework,
                 waves: WaveBatch, wave_width: int, chunk_waves: int, retry_buffer: int = 0):
        self.ec, self.ep, self.fw = ec, ep, fw
        if retry_buffer:
            # Wave-multiple rounding shared with the device retry pass.
            retry_buffer = -(-retry_buffer // wave_width) * wave_width
        self.retry_buffer = retry_buffer
        P = ep.num_pods
        self.st = init_state(ec, ep)
        self.assignments = np.where(ep.bound_node >= 0, ep.bound_node, PAD).astype(np.int32)
        self.released = np.zeros(P, bool)
        self.rel_time = ep.arrival + np.where(np.isfinite(ep.duration), ep.duration, np.inf)
        # Chunk index each pod was bound in (pre-bound = -2): boundary b
        # releases only pods bound in chunks <= b-2 (one-chunk slack).
        self.bind_chunk = np.full(P, _NEVER, np.int64)
        self.bind_chunk[ep.bound_node >= 0] = -2
        self.retry_q: List[int] = []
        self.pend: List[list] = []  # [relb, pod, node]
        self.placed_total = 0
        self.retry_dropped = 0
        # Boundary start times: f64 for the static release schedule, f32
        # finite prefix for the retry pend schedule (the device's f32 table).
        firsts = waves.idx[0::chunk_waves, 0]
        tb_all = np.where(firsts >= 0, ep.arrival[np.clip(firsts, 0, None)], np.inf)
        nfin = int(np.isfinite(tb_all).sum())
        self.tb32 = tb_all[:nfin].astype(np.float32) if retry_buffer else None
        # Static release schedule: each pod's earliest eligible boundary
        # (rel_time <= tb[b], floored by the one-chunk slack chunk_of + 2),
        # bucketed per boundary; boundary() re-checks the dynamic parts.
        chunk_of = np.full(P, _NEVER, np.int64)
        flat = waves.idx.reshape(-1)
        fv = flat >= 0
        if fv.any():
            chunk_of[flat[fv]] = np.nonzero(fv)[0] // (chunk_waves * waves.idx.shape[1])
        chunk_of[ep.bound_node >= 0] = -2
        elig = np.searchsorted(tb_all[:nfin], self.rel_time, side="left")
        b_rel = np.maximum(elig, chunk_of + 2)
        ok = b_rel < nfin
        cand = np.nonzero(ok)[0].astype(np.int64)
        cand = cand[np.argsort(b_rel[cand], kind="stable")]  # pod-asc within b
        counts = np.bincount(b_rel[cand], minlength=max(nfin, 1))
        self._rel_bucket_off = np.concatenate(([0], np.cumsum(counts))).astype(np.int64)
        self._rel_bucket_pods = cand
        self._n_rel_buckets = nfin

    def _apply_planes(self, sign: float, pods: np.ndarray, nodes: np.ndarray) -> None:
        du, dmc, daa, dpw = release_delta(self.ec, self.ep, pods, nodes)
        st = self.st
        if sign > 0:
            st.used += du
            st.match_count += dmc
            st.anti_active += daa
            st.pref_wsum += dpw
        else:
            st.used -= du
            st.match_count -= dmc
            st.anti_active -= daa
            st.pref_wsum -= dpw

    def offer_failure(self, p: int) -> None:
        """A non-gang pod that missed placement enters the FIFO buffer
        (overflow drops the newest — counted)."""
        if not self.retry_buffer or self.ep.group_id[p] != PAD:
            return
        if len(self.retry_q) < self.retry_buffer:
            self.retry_q.append(int(p))
        else:
            self.retry_dropped += 1

    def boundary(self, b: int, t_chunk: float) -> None:
        """Boundary ``b`` (start time ``t_chunk``): the due pending
        releases, the static releases, then the retry pass."""
        st = self.st
        rel_pods = [int(e[1]) for e in self.pend if e[0] <= b]
        self.pend[:] = [e for e in self.pend if e[0] > b]
        if b < self._n_rel_buckets and np.isfinite(t_chunk):
            cand = self._rel_bucket_pods[self._rel_bucket_off[b]: self._rel_bucket_off[b + 1]]
            if cand.size:
                m = ((st.bound[cand] >= 0) & ~self.released[cand]
                     & (self.bind_chunk[cand] < b - 1))
                rel_pods.extend(cand[m].tolist())
        if rel_pods:
            rel_p = np.asarray(rel_pods, np.int64)
            self._apply_planes(-1.0, rel_p, st.bound[rel_p].astype(np.int64))
            st.bound[rel_p] = PAD
            self.released[rel_p] = True
        if not (self.retry_buffer and self.retry_q):
            return
        ec, ep = self.ec, self.ep
        still_q: List[int] = []
        for p in self.retry_q:
            res = self.fw.schedule_one(st, p, allow_preemption=False)
            if res.node == PAD:
                still_q.append(p)
                continue
            bind(ec, ep, st, p, res.node)
            self.assignments[p] = res.node
            if ep.bound_node[p] == PAD:
                self.placed_total += 1
            # Release schedule: f32 boundary search, >= b+1 — the pod
            # starts now, not at arrival.
            dur = np.float32(ep.duration[p])
            if np.isfinite(dur) and len(self.pend) < self.retry_buffer:
                rb = int(np.searchsorted(self.tb32, np.float32(t_chunk) + dur, side="left"))
                if rb < len(self.tb32):
                    self.pend.append([max(rb, b + 1), p, int(res.node)])
        self.retry_q = still_q


def greedy_replay(
    ec: EncodedCluster,
    ep: EncodedPods,
    config: Optional[FrameworkConfig] = None,
    waves: Optional[WaveBatch] = None,
    wave_width: int = 8,
    preemption=False,
    completions_chunk_waves: Optional[int] = None,
    retry_buffer: int = 0,
) -> ReplayResult:
    """``completions_chunk_waves``: mirror the device engines'
    chunk-granular completions — before each chunk of that many waves,
    pods whose ``arrival + duration`` is at or before the chunk's start
    time release their resources and count contributions (they stay in
    ``assignments``).

    ``retry_buffer``: non-gang pods that miss placement enter a FIFO retry
    buffer (capacity ``retry_buffer``, rounded up to the wave width;
    overflow drops the newest). At each chunk boundary, after the
    releases, one retry pass re-attempts every buffered pod in order;
    placed pods leave the buffer, start at the boundary's time and release
    at the first boundary whose start time reaches ``t_b + duration``
    (in f32, at least ``b+1``), through a pending list also capped at
    ``retry_buffer``. Requires ``completions_chunk_waves``."""
    mode = normalize_preemption(preemption)
    if mode == "kube":
        raise NotImplementedError(
            "greedy_replay(preemption='kube') (the boundary PostFilter pass) is not ported "
            "yet (queue A items 6 and 13); use the JAX package"
        )
    # No PostFilter: in-wave attempts pass allow_preemption=False. Copy,
    # don't write through the caller's config object.
    config = dc_replace(config or FrameworkConfig(), enable_preemption=False)
    if retry_buffer and not completions_chunk_waves:
        raise ValueError("retry_buffer requires completions_chunk_waves")
    if retry_buffer and mode == "tier":
        raise ValueError("retry_buffer is not supported with tier preemption")
    fw = SchedulerFramework(ec, ep, config)
    if waves is None:
        waves = pack_waves(ep, wave_width)
    ops = _Boundary(ec, ep, fw, waves, wave_width, completions_chunk_waves or 1,
                    retry_buffer=retry_buffer)
    st = ops.st
    _, pod_tier = priority_tiers(ep)
    # Pre-bound pods appear in assignments (matching the device engines)
    # but never count toward placed_total (they were not scheduled here).
    assignments = ops.assignments
    preemptions = 0
    t0 = time.perf_counter()
    for wi, wave in enumerate(waves.idx):
        if completions_chunk_waves and wi % completions_chunk_waves == 0:
            b = wi // completions_chunk_waves
            first = int(wave[0]) if wave.shape[0] else -1
            t_chunk = float(ep.arrival[first]) if first >= 0 else np.inf
            ops.boundary(b, t_chunk)
        slot_choice: List[int] = []
        slot_pods: List[int] = []
        evicted_in_wave: set = set()
        preempted_this_wave = False
        for p in wave:
            if p < 0:
                continue
            p = int(p)
            res = fw.schedule_one(st, p, allow_preemption=False)
            node = res.node
            if node == PAD and mode == "tier" and not preempted_this_wave:
                hit = _try_tier_preempt(fw, ec, ep, st, p, pod_tier)
                if hit is not None:
                    node, victims = hit
                    preempted_this_wave = True
                    preemptions += len(victims)
                    for v in victims:
                        v = int(v)
                        vn = int(st.bound[v])
                        # Resources-only unbind: counts stay (phantom).
                        st.used[vn] -= ep.requests[v]
                        st.bound[v] = PAD
                        if assignments[v] >= 0:
                            assignments[v] = PAD
                            if ep.bound_node[v] == PAD:  # scheduled here
                                ops.placed_total -= 1
                        elif v in slot_pods:
                            evicted_in_wave.add(v)
            if node != PAD:
                bind(ec, ep, st, p, node)
            slot_pods.append(p)
            slot_choice.append(node)
        # Gang commit: a group fails if ANY member slot went unplaced.
        failed_groups = {
            int(ep.group_id[p])
            for p, c in zip(slot_pods, slot_choice)
            if c == PAD and ep.group_id[p] != PAD
        }
        for p, c in zip(slot_pods, slot_choice):
            if p in evicted_in_wave:
                continue  # evicted mid-wave: never committed
            g = int(ep.group_id[p])
            if c != PAD and g in failed_groups:
                unbind(ec, ep, st, p)
            elif c != PAD:
                assignments[p] = c
                ops.placed_total += 1
                if completions_chunk_waves:
                    ops.bind_chunk[p] = wi // completions_chunk_waves
            else:
                # Failed non-gang pod enters the retry buffer (slot order
                # within the wave; overflow drops the newest).
                ops.offer_failure(p)
    wall = time.perf_counter() - t0
    placed_total = ops.placed_total
    to_schedule = int((ep.bound_node == PAD).sum())
    util = utilization_means(st.used, ec.allocatable, ec.vocab._r)
    pending = (ep.bound_node == PAD) & (assignments == PAD)
    frag = fragmentation_gauges(ec.allocatable, st.used, ep.requests[pending], ec.vocab._r)
    return ReplayResult(
        assignments=assignments,
        placed=placed_total,
        unschedulable=to_schedule - placed_total,
        preemptions=preemptions,
        attempts=to_schedule,
        wall_clock_s=wall,
        placements_per_sec=placed_total / wall if wall > 0 else 0.0,
        virtual_makespan=float(ep.arrival.max()) if ep.num_pods else 0.0,
        utilization=util,
        state=st,
        retry_dropped=ops.retry_dropped,
        fragmentation=frag,
    )
