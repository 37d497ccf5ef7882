"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

From the root of a checkout, on a host with one CUDA card. In order:

1. prints the card's name and power limit (nvidia-smi);
2. builds the kernels from ``kubernetes_simulator_tpu_torch/csrc`` (one
   nvcc per source, in parallel) and prints the build seconds;
3. single-scenario kernel checks (S=1) at the config2 shape (5,000
   nodes, 50,000 pods, the full default plugin set) over a few hundred
   random slots of a mid-replay state: masks, score rows, choices and the
   state after every apply must equal the plain-PyTorch twin's exactly,
   and so must a 4,000-pair release and a gang rollback;
4. the same checks at S=4 and N=5,000, with scenarios whose allocatable
   and taints differ (node loss, capacity changes, hard and soft injected
   taints), scenario by scenario;
5. replays a reduced case (300 nodes, 3,000 pods, completions and gangs)
   through the kernel path, the plain path on the card and the plain path
   on the CPU: assignments must be identical;
6. runs a reduced what-if (8 scenarios × 60 nodes × 3,000 pods,
   durationMean 60, gangs: a contended trace where gangs roll back and
   completions move placements) the same three ways: assignments [S, P]
   must be identical;
7. replays the config2 shape (durationMean 50, gangFraction 0.02) on the
   kernel path with every launch counter zeroed just before, checks the
   result and each kernel's launches, and profiles a second replay;
8. the main path: the headline what-if — 128 scenarios
   (``uniform_scenarios(seed=0)``) × 2,000 nodes × 20,000 pods, the full
   default plugin set, durationMean 50, gangs (0.02 × 4), chunkWaves 512
   — with the counters zeroed just before a warm-up run and read just
   after it, then three timed runs (median wall, aggregate placements/s),
   scenario 0 held against a single-scenario replay of the same trace,
   one profiled run for the device's busy share; then each kernel held
   against its twin at the headline shapes (S=128, N=2,000) and timed
   beside its twin, a PyTorch yardstick and its least possible time on
   the card.

Prints the kernel table as one JSON line, then, as its last line,
``{"ok": true, "device": {...}}``. Any failed check raises (exit code not
0, no result line). Details go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from kubernetes_simulator_tpu_torch.framework.framework import FrameworkConfig  # noqa: E402
from kubernetes_simulator_tpu_torch.models.encode import PAD, encode  # noqa: E402
from kubernetes_simulator_tpu_torch.models.state import init_state  # noqa: E402
from kubernetes_simulator_tpu_torch.ops import kernels as K  # noqa: E402
from kubernetes_simulator_tpu_torch.ops import reference as ref  # noqa: E402
from kubernetes_simulator_tpu_torch.sim.synthetic import make_cluster, make_workload  # noqa: E402
from kubernetes_simulator_tpu_torch.sim.torch_runtime import (  # noqa: E402
    StepSpec,
    TorchReplayEngine,
)
from kubernetes_simulator_tpu_torch.sim.whatif import (  # noqa: E402
    Perturbation,
    ScenarioSet,
    WhatIfEngine,
    uniform_scenarios,
)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
F32_OPS_PER_S = 67e12  # H100 SXM f32 rate outside the tensor cores
SEED = 0
HEADLINE = dict(scenarios=128, nodes=2000, pods=20_000, chunk_waves=512)

SOURCES = {
    "filter_score": ("kubernetes_simulator_tpu_torch/csrc/filter_score.cu",
                     "kubernetes_simulator_tpu/ops/tpu3.py:944"),
    "normalize_select": ("kubernetes_simulator_tpu_torch/csrc/normalize_select.cu",
                         "kubernetes_simulator_tpu/ops/tpu.py:739"),
    "apply_placements": ("kubernetes_simulator_tpu_torch/csrc/apply_placements.cu",
                         "kubernetes_simulator_tpu/sim/jax_runtime.py:1414"),
}


def case(nodes, pods, seed=SEED, duration_mean=50.0, gang_fraction=0.02):
    """config2's generators (taints, affinity, spread, tolerations) with
    completions and gangs (of 4) on."""
    cluster = make_cluster(nodes, seed=seed, taint_fraction=0.1)
    workload, _ = make_workload(
        pods, seed=seed, with_affinity=True, with_spread=True, with_tolerations=True,
        duration_mean=duration_mean, gang_fraction=gang_fraction, gang_size=4,
    )
    return encode(cluster, workload)


def time_cuda(fn, iters):
    """Mean ms of ``fn(i)`` over ``iters`` calls, by CUDA events after a
    warm-up."""
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for i in range(iters):
        fn(i)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def device_ms(fn, iters, match=None):
    """Mean device time (ms) per ``fn(i)`` call over ``iters`` calls, from
    the CUPTI kernel records of torch.profiler: the kernels whose name
    contains ``match`` (every kernel when None). None when the profiler
    recorded no device time."""
    from torch.profiler import ProfilerActivity, profile

    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
    total_us = 0.0
    for evt in prof.key_averages():
        if match is None or match in evt.key:
            total_us += getattr(evt, "device_time_total", None) or getattr(
                evt, "cuda_time_total", 0.0)
    return total_us / iters / 1e3 if total_us > 0 else None


def profiled_busy_s(fn):
    """(result of fn(), seconds of device time torch.profiler recorded)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
    busy_us = sum(
        (getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0))
        for e in prof.key_averages()
    )
    return out, busy_us / 1e6


def bound(nbytes, nops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _ids(a):
    return {int(g) for g in np.ravel(a) if g >= 0}


class Work:
    """Bytes and operations each kernel's function needs on given inputs,
    for its least time on the card: each input read once and each output
    written once. A table shared by the S scenarios (the pod rows, labels,
    domains, a shared allocatable or taints) counts once, a stacked one S
    times. A plane row counts only for the groups and planes the pod reads
    it in, and only over the domains of the group's key; a domain-map
    (gdom) cell counts once however many scenarios look it up; a score row
    counts only where its on_* flag puts it into the total. Where the work
    depends on the run's data (K3's nodes), the nodes given are counted:
    a PAD node costs only the read of its choice."""

    def __init__(self, ep, tb):
        self.ep, self.k = ep, tb.consts
        self.S, self.N, self.R = tb.state.used.shape
        c = tb.cluster
        self.alloc_copies = c.allocatable.shape[0] if c.allocatable.dim() == 3 else 1
        self.taint_copies = c.taint_key.shape[0] if c.taint_key.dim() == 3 else 1
        self.TT = c.taint_key.shape[-1]
        self.gdom = c.gdom.cpu().numpy().astype(np.int64)
        self.gnd = c.gnd.cpu().numpy().astype(np.int64)
        self.G, self.D = tb.state.match_count.shape[1:]
        k = self.k
        self.rows_on = int(k.on_fit) + int(k.on_taint) + int(k.on_na) + int(k.on_ip) + int(k.on_sp)
        self._k3_terms = {}

    def k1(self, p):
        """(bytes, ops) of K1 for pod p over all S scenarios."""
        ep, k, S, N, R = self.ep, self.k, self.S, self.N, self.R
        mc, aa, pw = set(), set(), set()
        if k.interpod:
            mc = _ids(ep.aff_req[p]) | _ids(ep.anti_req[p]) | _ids(ep.pref_aff[p])
            aa = set(np.nonzero(ep.pod_matches_group[p])[0].tolist())
            pw = aa if k.has_symmetric_pref else set()
        if k.spread:
            mc |= _ids(ep.spread_g[p])
        exprs = set()
        if k.node_affinity:
            exprs = _ids(ep.na_pref[p]) | (_ids(ep.na_req[p]) if ep.na_has_req[p] else set())
        looked_up = mc | aa | pw
        cells = sum(int(self.gnd[g]) for gs in (mc, aa, pw) for g in gs)
        TO = ep.tol_key.shape[1]
        nbytes = (
            S * N * R * 4 + self.alloc_copies * N * R * 4 + R * 4  # used, alloc, request
            + (self.taint_copies * 3 * N * self.TT * 4 + TO * 12 if k.taints else 0)
            + N * len(exprs)  # expression-match columns the pod's terms name
            + len(looked_up) * N * 4  # gdom rows, shared
            + S * cells * 4  # plane cells, per scenario
            + S * N * (1 + self.rows_on * 4 + int(k.on_sp))  # feasible, rows, ignored
        )
        nops = S * N * (R * 8 + (self.TT * (4 + TO * 6) if k.taints else 0)
                        + len(exprs) + len(looked_up) * 4 + 16)
        return nbytes, nops

    def k2(self):
        """(bytes, ops) of K2 for one slot over all S scenarios."""
        S, N = self.S, self.N
        return (S * (N * (1 + self.rows_on * 4 + int(self.k.on_sp)) + 4),
                S * N * (2 + self.rows_on * 8))

    def _terms(self, p):
        """(plane, group) pairs K3 adds to for pod p: match_count (0) for
        each group p matches, anti_active (1) for its anti terms, pref_wsum
        (2) for its preferred terms."""
        t = self._k3_terms.get(p)
        if t is None:
            ep = self.ep
            g0 = np.nonzero(ep.pod_matches_group[p])[0]
            g1, g2 = ep.anti_req[p][ep.anti_req[p] >= 0], ep.pref_aff[p][ep.pref_aff[p] >= 0]
            t = (np.concatenate([np.zeros(g0.size), np.ones(g1.size), np.full(g2.size, 2)])
                 .astype(np.int64), np.concatenate([g0, g1, g2]).astype(np.int64))
            self._k3_terms[p] = t
        return t

    def k3(self, pods, nodes, rollback=False):
        """(bytes, ops) of K3 applying pods[k] at nodes[s, k] in each of the
        S scenarios. A rollback reads the wave's choices and gang ids and
        undoes only the pairs of a gang left partial: pass those pairs'
        nodes (PAD for the rest)."""
        ep, N, R, G, D = self.ep, self.N, self.R, self.G, self.D
        pods = np.asarray(pods, np.int64)
        nodes = np.asarray(nodes, np.int64).reshape(-1, pods.size)
        S = nodes.shape[0]
        uniq = np.unique(pods[pods >= 0])
        AA, PA = ep.anti_req.shape[1], ep.pref_aff.shape[1]
        nbytes = (pods.size * 8 + S * pods.size * 4  # pod ids, slots; each scenario's choice
                  + uniq.size * (R * 4 + G + AA * 4 + PA * 8)  # the pods' shared rows
                  + (pods.size * 4 if rollback else 0))  # gang ids
        s_i, k_i = np.nonzero((nodes >= 0) & (pods >= 0)[None])
        if s_i.size == 0:
            return nbytes, 0
        n, p = nodes[s_i, k_i], pods[k_i]
        nbytes += np.unique(s_i * N + n).size * R * 8  # used rows, read and written
        order = np.argsort(p, kind="stable")
        up, first, count = np.unique(p[order], return_index=True, return_counts=True)
        parts = []
        for u, a, c in zip(up.tolist(), first.tolist(), count.tolist()):
            pl, g = self._terms(u)
            if g.size:
                parts.append((np.tile(pl, c), np.tile(g, c), np.repeat(order[a : a + c], g.size)))
        if not parts:
            return nbytes, s_i.size * R
        pl, g, j = (np.concatenate(x) for x in zip(*parts))
        nn, ss = n[j], s_i[j]
        nbytes += np.unique(g * N + nn).size * 4  # gdom cells, shared
        dom = self.gdom[g, nn]
        live = dom >= 0
        cell = ((ss[live] * 3 + pl[live]) * G + g[live]) * D + dom[live]
        nbytes += np.unique(cell).size * 8  # plane cells, read and written
        return nbytes, s_i.size * R + int(live.sum())

    def chunk_loop_ms(self, plan, assignments, launches):
        """B6's bound: the sum over every launch of a run of that launch's
        least time. K1 counts each wave pod, K2 each slot; K3 binds and
        releases count the nodes the run's assignments [S, P] give them,
        which leaves out the binds of gang pods later rolled back, and a
        rollback counts its reads only (the run records no undone pair):
        this term is a floor."""
        S = self.S
        wave_pods = plan.idx[plan.idx >= 0]
        k1 = sum(bound(*self.k1(int(p)))[0] for p in wave_pods)
        k2 = launches["normalize_select"] * bound(*self.k2())[0]
        binds = sum(bound(*self.k3([p], assignments[:, p]))[0] for p in wave_pods.tolist())
        pad = lambda w: np.full((S, w.size), PAD)
        rollbacks = sum(bound(*self.k3(w, pad(w), rollback=True))[0]
                        for w in plan.idx[plan.gang_wave])
        releases = sum(bound(*self.k3(bk[0], assignments[:, bk[0]]))[0]
                       for bk in plan.buckets if bk is not None)
        n_k3 = (wave_pods.size + int(plan.gang_wave.sum())
                + sum(bk is not None for bk in plan.buckets))
        if (launches["filter_score"] != wave_pods.size or launches["apply_placements"] != n_k3):
            raise AssertionError(f"launch counts {launches} do not match the chunk plan")
        return dict(k1=k1, k2=k2, k3_bind=binds, k3_rollback=rollbacks, k3_release=releases,
                    total=k1 + k2 + binds + rollbacks + releases)


def mid_replay_tables(ec, ep, cl, consts, S, rng, dev):
    """Twin and kernel tables of S scenarios in a mid-replay state: a third
    of the trace bound at random nodes, chosen per scenario. Returns
    (twin tables, kernel tables with a copy of the state, pre-bound pods,
    their nodes [S, n])."""
    st = init_state(ec, ep)
    state = ref.stacked_state(st.used, st.match_count, st.anti_active, st.pref_wsum, S, dev)
    pods = ref.pods_to(ep, dev)
    tb_t = ref.Tables(cl, pods, state, ref.new_scratch(S, ec.num_nodes, dev), consts)
    pre = rng.choice(ep.num_pods, size=ep.num_pods // 3, replace=False).astype(np.int32)
    pre_nodes = rng.integers(0, ec.num_nodes, size=(S, pre.size)).astype(np.int32)
    pre_t = torch.as_tensor(pre, device=dev)
    ref.apply_placements(tb_t, pre_t, torch.arange(pre.size, dtype=torch.int32, device=dev),
                         torch.as_tensor(pre_nodes, device=dev), 1.0)
    tb_k = tb_t._replace(state=ref.DevState(*(t.clone() for t in tb_t.state)),
                         scratch=ref.new_scratch(S, ec.num_nodes, dev))
    return tb_t, tb_k, pre, pre_nodes


def hold_kernels(where, ep, tb_t, tb_k, pre, pre_nodes, n_slots, rng, dev):
    """Each kernel against its twin on the same inputs, slot after slot:
    masks, score rows and choices of every scenario, and the state after
    every bind, a bucketed release (each scenario's own nodes, some PAD)
    and a gang rollback (a member unplaced in odd scenarios only). Raises
    on the first difference; returns what the timings reuse."""
    S = tb_t.state.used.shape[0]
    b = K.Bound(tb_k)

    def same_state(at):
        for name in ref.DevState._fields:
            x, y = getattr(tb_k.state, name), getattr(tb_t.state, name)
            if not torch.equal(x, y):
                err = float((x - y).abs().max())
                raise AssertionError(f"{where}, {at}: state {name} differs (max |d| {err})")

    slots = rng.choice(np.setdiff1d(np.arange(ep.num_pods), pre), size=n_slots,
                       replace=False).astype(np.int32)
    pid = torch.as_tensor(slots, device=dev)
    pos = torch.arange(n_slots, dtype=torch.int32, device=dev)
    ch_k = torch.full((S, n_slots), PAD, dtype=torch.int32, device=dev)
    ch_t = ch_k.clone()
    k1_err = 0.0
    for i, p in enumerate(slots.tolist()):
        K.filter_score(b, p)
        ref.filter_score(tb_t, p)
        xk, xt = tb_k.scratch, tb_t.scratch
        if not torch.equal(xk.feasible, xt.feasible) or not torch.equal(xk.ignored, xt.ignored):
            raise AssertionError(f"{where}: filter_score masks differ at pod {p}")
        k1_err = max(k1_err, float((xk.scores - xt.scores).abs().max()))
        K.normalize_select(b, p, ch_k, i)
        ref.normalize_select(tb_t, p, ch_t, i)
        if not torch.equal(ch_k[:, i], ch_t[:, i]):
            raise AssertionError(f"{where}: normalize_select choices differ at pod {p}: "
                                 f"{ch_k[:, i].tolist()[:8]} != {ch_t[:, i].tolist()[:8]}")
        K.apply_placements(b, pid[i : i + 1], pos[i : i + 1], ch_k, 1.0)
        ref.apply_placements(tb_t, pid[i : i + 1], pos[i : i + 1], ch_t, 1.0)
        same_state(f"bind of pod {p}")
    if k1_err != 0.0:
        raise AssertionError(f"{where}: filter_score score rows differ by {k1_err}")
    placed = int((ch_k >= 0).sum())
    if not 0 < placed:
        raise AssertionError(f"{where}: no slot placed; the check state is degenerate")
    # A release bucket, in pod order, reading each scenario's own node.
    n_rel = min(4000, pre.size)
    rel = np.sort(rng.choice(pre.size, size=n_rel, replace=False))
    rel = rel[np.argsort(pre[rel])]
    rel_nodes = pre_nodes[:, rel].copy()
    rel_nodes[rng.random(rel_nodes.shape) < 0.1] = PAD
    rel_p = torch.as_tensor(pre[rel], device=dev)
    rel_pos = torch.arange(n_rel, dtype=torch.int32, device=dev)
    rel_ch = torch.as_tensor(rel_nodes, device=dev)
    K.apply_placements(b, rel_p, rel_pos, rel_ch, -1.0)
    ref.apply_placements(tb_t, rel_p, rel_pos, rel_ch, -1.0)
    torch.cuda.synchronize()
    same_state("release")
    # Gang rollback over one wave: a gang whose last member is unplaced in
    # the odd scenarios (in the only one at S=1), a complete gang, a
    # non-gang pod and a padded slot.
    gid = ep.group_id
    gangs = np.unique(gid[gid >= 0])[:2]
    g0 = np.nonzero(gid == gangs[0])[0]
    wave = np.concatenate([g0, np.nonzero(gid == gangs[1])[0], np.nonzero(gid < 0)[0][:1],
                           [PAD]]).astype(np.int32)
    wnodes = rng.integers(0, tb_t.state.used.shape[1], size=(S, wave.size)).astype(np.int32)
    unplaced = (np.arange(S) % 2 == 1) if S > 1 else np.ones(1, bool)
    wnodes[unplaced, g0.size - 1] = PAD
    wnodes[:, -1] = PAD
    w_p = torch.as_tensor(wave, device=dev)
    w_pos = torch.arange(wave.size, dtype=torch.int32, device=dev)
    wn_k = torch.tensor(wnodes, device=dev)
    wn_t = wn_k.clone()
    K.apply_placements(b, w_p, w_pos, wn_k, -1.0, rollback=True)
    ref.apply_placements(tb_t, w_p, w_pos, wn_t, -1.0, rollback=True)
    torch.cuda.synchronize()
    same_state("rollback")
    rolled = (wn_k < 0).sum(dim=1).cpu().numpy() - (wnodes < 0).sum(axis=1)
    if (not torch.equal(wn_k, wn_t) or not (rolled[unplaced] == g0.size - 1).all()
            or (rolled[~unplaced] != 0).any()):
        raise AssertionError(f"{where}: rollback choices differ or rolled back the wrong gangs")
    print(f"{where}: {n_slots} slots x {S} scenarios ({placed} placements), a {n_rel}-pair "
          f"release and a gang rollback; kernels equal their twins exactly", flush=True)
    return dict(b=b, slots=slots, pid=pid, ch_k=ch_k, ch_t=ch_t, k1_err=k1_err, placed=placed,
                rel=(rel_p, rel_pos, rel_ch, pre[rel]))


def time_kernels(ep, tb_t, held, dev, iters=200, plain_iters=20):
    """Device time per launch (torch.profiler) and host launch interval
    (CUDA events) of each kernel at the held shapes, beside its twin's
    time, a PyTorch yardstick and the least time the card could take."""
    b, slots, pid = held["b"], held["slots"], held["pid"]
    ch_k, ch_t = held["ch_k"], held["ch_t"]
    S = tb_t.state.used.shape[0]
    n = len(slots)
    sl = slots.tolist()
    t_k1 = time_cuda(lambda i: K.filter_score(b, sl[i % n]), iters)
    t_k1_plain = time_cuda(lambda i: ref.filter_score(tb_t, sl[i % n]), plain_iters)
    t_k2 = time_cuda(lambda i: K.normalize_select(b, sl[i % n], ch_k, 0), iters)
    t_k2_plain = time_cuda(lambda i: ref.normalize_select(tb_t, sl[i % n], ch_t, 0), plain_iters)
    ref.filter_score(tb_t, sl[0])
    total = ref.weighted_total(tb_t, sl[0])
    masked = torch.where(tb_t.scratch.feasible, total, torch.full_like(total, float("-inf")))
    t_argmax = time_cuda(lambda i: torch.argmax(masked, dim=-1), iters)
    one_p = pid[:1]
    one_pos = torch.zeros(1, dtype=torch.int32, device=dev)
    one_ch = ch_k[:, :1].clone().clamp_(min=0).contiguous()
    one_ch_t = one_ch.clone()
    t_k3 = time_cuda(lambda i: K.apply_placements(b, one_p, one_pos, one_ch, 1.0 - 2.0 * (i % 2)),
                     iters)
    t_k3_plain = time_cuda(
        lambda i: ref.apply_placements(tb_t, one_p, one_pos, one_ch_t, 1.0 - 2.0 * (i % 2)),
        plain_iters)
    rel_p, rel_pos, rel_ch, rel_pods = held["rel"]
    t_rel = time_cuda(lambda i: K.apply_placements(b, rel_p, rel_pos, rel_ch,
                                                   1.0 - 2.0 * (i % 2)), 10)
    t_rel_plain = time_cuda(lambda i: ref.apply_placements(tb_t, rel_p, rel_pos, rel_ch,
                                                           1.0 - 2.0 * (i % 2)), 10)
    d_k1 = device_ms(lambda i: K.filter_score(b, sl[i % n]), iters, "ksim_filter_score")
    d_k2 = device_ms(lambda i: K.normalize_select(b, sl[i % n], ch_k, 0), iters,
                     "ksim_normalize_select")
    d_argmax = device_ms(lambda i: torch.argmax(masked, dim=-1), iters)
    d_k3 = device_ms(lambda i: K.apply_placements(b, one_p, one_pos, one_ch,
                                                  1.0 - 2.0 * (i % 2)), iters, "ksim_apply")
    d_rel = device_ms(lambda i: K.apply_placements(b, rel_p, rel_pos, rel_ch,
                                                   1.0 - 2.0 * (i % 2)), 10, "ksim_apply")
    pick = lambda d, t: d if d is not None else t
    work = Work(ep, tb_t)
    k1b, k1o = np.mean([work.k1(p) for p in sl], axis=0)
    k2b, k2o = work.k2()
    k3b, k3o = work.k3(one_p.cpu().numpy(), one_ch.cpu().numpy())
    rb, ro = work.k3(rel_pods, rel_ch.cpu().numpy())
    out = {
        "filter_score": dict(max_abs_err=held["k1_err"], ms=pick(d_k1, t_k1), device_ms=d_k1,
                             launch_interval_ms=t_k1, plain_ms=t_k1_plain, bytes=float(k1b),
                             ops=float(k1o), library_ms=None),
        "normalize_select": dict(max_abs_err=0.0, ms=pick(d_k2, t_k2), device_ms=d_k2,
                                 launch_interval_ms=t_k2, plain_ms=t_k2_plain,
                                 bytes=float(k2b), ops=float(k2o),
                                 library_ms=pick(d_argmax, t_argmax),
                                 library_launch_interval_ms=t_argmax),
        "apply_placements": dict(max_abs_err=0.0, ms=pick(d_k3, t_k3), device_ms=d_k3,
                                 launch_interval_ms=t_k3, plain_ms=t_k3_plain,
                                 bytes=float(k3b), ops=float(k3o), library_ms=None),
    }
    for m in out.values():
        m["bound_ms"], m["bound_by"] = bound(m["bytes"], m["ops"])
    release = dict(pairs=len(rel_pods), scenarios=S, ms=pick(d_rel, t_rel), device_ms=d_rel,
                   launch_interval_ms=t_rel, plain_ms=t_rel_plain,
                   bound_ms=bound(float(rb), float(ro))[0])
    return out, release


def check_kernels_s1(ec, ep, results, dev):
    """Step 3: S=1 kernels vs twins at the config2 shape."""
    consts = StepSpec.from_config(ec, FrameworkConfig(), ep).consts()
    rng = np.random.default_rng(SEED)
    tb_t, tb_k, pre, pre_nodes = mid_replay_tables(ec, ep, ref.cluster_to(ec, dev), consts, 1,
                                                   rng, dev)
    held = hold_kernels("S=1 kernel checks (N=5000)", ep, tb_t, tb_k, pre, pre_nodes, 300, rng,
                        dev)
    results["kernels_s1_n5000"], results["apply_release_s1_n5000"] = time_kernels(
        ep, tb_t, held, dev)


def check_kernels_s4(ec, ep, results, dev):
    """Step 4: S=4 kernels vs twins at N=5000, scenarios whose allocatable
    and taints differ."""
    scen = uniform_scenarios(ec, 4, seed=SEED + 1, p_node_down=1.0, p_capacity=1.0, p_taint=1.0)
    scen[1].perturbations.append(Perturbation(
        "add_taint", nodes=np.arange(0, ec.num_nodes, 6), key="whatif/soft", value="x",
        effect="PreferNoSchedule"))
    ss = ScenarioSet(ec, scen, device=dev)
    for a, c in ((ss.alloc[1], ss.alloc[2]), (ss.taint_key[1], ss.taint_key[2])):
        if torch.equal(a, c):
            raise AssertionError("the S=4 check's scenarios do not differ")
    consts = dataclasses.replace(StepSpec.from_config(ec, FrameworkConfig(), ep),
                                 taint_score=True).consts()
    cl = ref.cluster_to(ec, dev)._replace(
        allocatable=ss.alloc, taint_key=ss.taint_key, taint_kv=ss.taint_kv,
        taint_effect=ss.taint_effect)
    rng = np.random.default_rng(SEED + 4)
    tb_t, tb_k, pre, pre_nodes = mid_replay_tables(ec, ep, cl, consts, 4, rng, dev)
    held = hold_kernels("S=4 kernel checks (N=5000)", ep, tb_t, tb_k, pre, pre_nodes, 150, rng,
                        dev)
    results["check_s4"] = dict(slots=150, placements=held["placed"],
                               release_pairs=len(held["rel"][3]))


def check_reduced_replay(results, dev="cuda"):
    """Step 5: kernel path == plain path on the card == plain path on the
    CPU, on a trace where completions change the placements."""
    ec, ep = case(300, 3000, duration_mean=20.0, gang_fraction=0.05)
    kw = dict(wave_width=8, chunk_waves=64)
    t0 = time.perf_counter()
    kern = TorchReplayEngine(ec, ep, FrameworkConfig(), device=dev, **kw).replay()
    t1 = time.perf_counter()
    plain = TorchReplayEngine(ec, ep, FrameworkConfig(), device=dev, plain=True,
                              **kw).replay()
    t2 = time.perf_counter()
    cpu = TorchReplayEngine(ec, ep, FrameworkConfig(), device="cpu", **kw).replay()
    t3 = time.perf_counter()
    for name, other in (("plain on the card", plain), ("plain on the cpu", cpu)):
        diff = np.nonzero(kern.assignments != other.assignments)[0]
        if diff.size:
            raise AssertionError(f"reduced replay: kernel path != {name} at pods {diff[:5]}")
        for plane in ("used", "match_count", "anti_active", "pref_wsum"):
            if not np.array_equal(getattr(kern.state, plane), getattr(other.state, plane)):
                raise AssertionError(f"reduced replay: {plane} differs from {name}")
    off = TorchReplayEngine(ec, ep, FrameworkConfig(), device=dev, completions=False,
                            **kw).replay()
    moved = int((off.assignments != kern.assignments).sum())
    if kern.placed <= 0 or moved == 0:
        raise AssertionError("reduced replay placed nothing or completions changed nothing")
    results["reduced"] = dict(nodes=300, pods=3000, placed=kern.placed,
                              unschedulable=kern.unschedulable, moved_by_completions=moved,
                              kernel_s=t1 - t0, plain_card_s=t2 - t1, plain_cpu_s=t3 - t2)
    print(f"reduced replay (300 nodes, 3000 pods): placed {kern.placed}, identical on the "
          f"kernel path, the plain path on the card and on the CPU "
          f"({t1 - t0:.2f}s / {t2 - t1:.2f}s / {t3 - t2:.2f}s); completions move "
          f"{moved} assignments", flush=True)


def check_reduced_whatif(results, dev="cuda"):
    """Step 6: the what-if batch on the kernel path == the plain path on the
    card == the plain path on the CPU."""
    nodes, pods = 60, 3000
    ec, ep = case(nodes, pods, duration_mean=60.0, gang_fraction=0.05)
    scen = uniform_scenarios(ec, 8, seed=1, p_node_down=0.5, p_capacity=0.5, p_taint=0.5)
    kw = dict(wave_width=8, chunk_waves=64, collect_assignments=True)
    mk = lambda **o: WhatIfEngine(ec, ep, scen, FrameworkConfig(), **{**kw, **o})
    t0 = time.perf_counter()
    kern = mk(device=dev).run()
    t1 = time.perf_counter()
    plain = mk(device=dev, plain=True).run()
    t2 = time.perf_counter()
    cpu = mk(device="cpu").run()
    t3 = time.perf_counter()
    for name, other in (("plain on the card", plain), ("plain on the cpu", cpu)):
        bad = np.argwhere(kern.assignments != other.assignments)
        if bad.size:
            raise AssertionError(f"reduced what-if: kernel path != {name} at (scenario, pod) "
                                 f"{bad[:5].tolist()}")
    if not np.array_equal(kern.utilization_cpu, plain.utilization_cpu):
        raise AssertionError("reduced what-if: utilization differs from the plain path")
    off = mk(device=dev, completions=False).run()
    moved = int((off.assignments != kern.assignments).sum())
    distinct = len({a.tobytes() for a in kern.assignments})
    gang_unplaced = int((kern.assignments[:, ep.group_id >= 0] < 0).sum())
    if moved == 0 or distinct < 2 or gang_unplaced == 0 or kern.total_placed <= 0:
        raise AssertionError("reduced what-if is vacuous (no scenario, completion or gang "
                             "rollback effect)")
    results["reduced_whatif"] = dict(
        scenarios=len(scen), nodes=nodes, pods=pods, placed=kern.placed.tolist(),
        moved_by_completions=moved, distinct_scenarios=distinct,
        gang_pods_unplaced=gang_unplaced,
        kernel_s=t1 - t0, plain_card_s=t2 - t1, plain_cpu_s=t3 - t2)
    print(f"reduced what-if (8 scenarios x {nodes} nodes x {pods} pods): placed "
          f"{kern.placed.tolist()}, assignments identical on the kernel path, the plain path on "
          f"the card and on the CPU ({t1 - t0:.2f}s / {t2 - t1:.2f}s / {t3 - t2:.2f}s); "
          f"completions move {moved} assignments, {gang_unplaced} gang pods rolled back or "
          f"unplaced", flush=True)


def check_result(ec, ep, res):
    P = ep.num_pods
    if res.assignments.shape != (P,) or res.state.used.shape != ec.allocatable.shape:
        raise AssertionError("result shapes are wrong")
    for plane in ("used", "match_count", "anti_active", "pref_wsum"):
        if not np.all(np.isfinite(getattr(res.state, plane))):
            raise AssertionError(f"{plane} holds non-finite values")
    if res.placed + res.unschedulable != res.attempts or res.placed <= 0:
        raise AssertionError("placed/unschedulable do not add up")
    a = res.assignments
    if not np.all((a >= PAD) & (a < ec.num_nodes)):
        raise AssertionError("assignments out of range")
    if not np.all(res.state.used <= ec.allocatable + 1e-3):
        raise AssertionError("a node is committed past its allocatable")
    if res.state.match_count.min() < 0 or res.state.anti_active.min() < 0:
        raise AssertionError("a count plane went negative")
    gid = ep.group_id
    for g in np.unique(gid[gid >= 0]):
        placed = a[gid == g] >= 0
        if placed.any() and not placed.all():
            raise AssertionError(f"gang {g} placed partially")


def check_whatif_result(ep, res, S):
    to_schedule = int((ep.bound_node < 0).sum())
    if res.placed.shape != (S,) or res.utilization_cpu.shape != (S,):
        raise AssertionError("what-if result shapes are wrong")
    if not np.all(res.placed + res.unschedulable == to_schedule) or (res.placed <= 0).any():
        raise AssertionError("what-if placed/unschedulable do not add up")
    u = res.utilization_cpu
    if not np.all(np.isfinite(u)) or (u < 0).any() or (u > 1 + 1e-5).any():
        raise AssertionError(f"utilization out of range: {u.min()}..{u.max()}")
    if int(res.placed.sum()) != res.total_placed:
        raise AssertionError("total_placed is not the sum over scenarios")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script needs a CUDA "
              "card", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {name}", flush=True)
    results = {"nvidia_smi": smi, "device": name}
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    K.build(verbose=True)
    results["build_s"] = K.last_build_s
    print(f"kernels built in {K.last_build_s:.2f}s "
          f"({time.perf_counter() - t0:.2f}s with loading)", flush=True)

    t0 = time.perf_counter()
    ec, ep = case(5000, 50_000)
    results["encode_s"] = time.perf_counter() - t0
    print(f"config2 shape encoded: {ec.num_nodes} nodes, {ep.num_pods} pods, "
          f"R={ec.num_resources} G={ec.num_groups} D={ec.max_domains} "
          f"T={ec.node_domain.shape[0]} ({results['encode_s']:.1f}s)", flush=True)

    check_kernels_s1(ec, ep, results, dev)
    check_kernels_s4(ec, ep, results, dev)
    check_reduced_replay(results)
    check_reduced_whatif(results)

    # Step 7: the config2 single replay, kernel path; counters from zero.
    eng = TorchReplayEngine(ec, ep, FrameworkConfig(), wave_width=8, chunk_waves=1024)
    K.reset_launch_counts()
    res = eng.replay()
    launches_c2 = K.launch_counts()
    check_result(ec, ep, res)
    for k, n in launches_c2.items():
        if n <= 0:
            raise AssertionError(f"kernel {k} was not launched by the config2 replay")
    res_p, busy_s = profiled_busy_s(eng.replay)
    if not np.array_equal(res_p.assignments, res.assignments):
        raise AssertionError("the profiled replay placed differently")
    results["chunk_loop_bound_ms_config2"] = Work(ep, eng._tables()).chunk_loop_ms(
        eng.plan, res.assignments[None], launches_c2)
    print(f"config2 chunk-loop bound (B6): {json.dumps(results['chunk_loop_bound_ms_config2'])} "
          f"ms", flush=True)
    results["config2"] = dict(
        nodes=ec.num_nodes, pods=ep.num_pods, wall_s=res.wall_clock_s,
        placements_per_s=res.placements_per_sec, placed=res.placed,
        unschedulable=res.unschedulable, launches=launches_c2,
        phases=res.telemetry.phases if res.telemetry is not None else None,
        profiled_wall_s=res_p.wall_clock_s, device_busy_s=busy_s,
        device_busy_share=busy_s / res_p.wall_clock_s if busy_s else None,
    )
    print(f"config2 replay (5000 nodes, 50000 pods): wall {res.wall_clock_s:.3f}s, "
          f"{res.placements_per_sec:.1f} placements/s, placed {res.placed}, launches "
          f"{json.dumps(launches_c2)}; profiled: wall {res_p.wall_clock_s:.3f}s, device busy "
          f"{busy_s:.3f}s", flush=True)
    del eng, res, res_p

    # Step 8: the main path, the headline what-if; counters from zero.
    hs = HEADLINE
    t0 = time.perf_counter()
    ec, ep = case(hs["nodes"], hs["pods"])
    scen = uniform_scenarios(ec, hs["scenarios"], seed=0)
    eng = WhatIfEngine(ec, ep, scen, FrameworkConfig(), chunk_waves=hs["chunk_waves"],
                       collect_assignments=True)
    setup_s = time.perf_counter() - t0
    K.reset_launch_counts()
    warm = eng.run()
    launches = K.launch_counts()
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {k} was not launched on the main path")
    check_whatif_result(ep, warm, hs["scenarios"])
    runs = [eng.run() for _ in range(3)]
    for r in runs:
        if not np.array_equal(r.placed, warm.placed):
            raise AssertionError("the headline placed differently from run to run")
    walls = sorted(r.wall_clock_s for r in runs)
    wall = float(np.median(walls))
    single = TorchReplayEngine(ec, ep, FrameworkConfig(), chunk_waves=hs["chunk_waves"]).replay()
    if int(warm.placed[0]) != single.placed:
        raise AssertionError(f"scenario 0 placed {int(warm.placed[0])}, the single replay "
                             f"{single.placed}")
    res_p, busy_s = profiled_busy_s(eng.run)
    rel_launches = sum(bk is not None for bk in eng.plan.buckets)
    rollbacks = int(eng.plan.gang_wave.sum())
    results["headline"] = dict(
        **hs, setup_s=setup_s, chunk_waves_run=eng.plan.C, chunks=len(eng.plan.buckets),
        completions_on=warm.completions_on, launches=launches,
        launches_detail=dict(release=rel_launches, rollback=rollbacks,
                             bind=launches["apply_placements"] - rel_launches - rollbacks),
        walls_s=walls, warmup_wall_s=warm.wall_clock_s, wall_s=wall,
        placements_per_s=warm.total_placed / wall, total_placed=warm.total_placed,
        placed_min=int(warm.placed.min()), placed_max=int(warm.placed.max()),
        scenario0_placed=int(warm.placed[0]), single_replay_placed=single.placed,
        single_replay_wall_s=single.wall_clock_s,
        utilization_cpu_mean=float(warm.utilization_cpu.mean()),
        profiled_wall_s=res_p.wall_clock_s, device_busy_s=busy_s,
        device_busy_share=busy_s / res_p.wall_clock_s if busy_s else None,
    )
    print(f"headline what-if ({hs['scenarios']} scenarios x {hs['nodes']} nodes x "
          f"{hs['pods']} pods, chunkWaves {hs['chunk_waves']}, completions + gangs): "
          f"median wall {wall:.3f}s of {[round(w, 3) for w in walls]}, "
          f"{warm.total_placed / wall:.1f} aggregate placements/s, placed "
          f"{int(warm.placed.min())}..{int(warm.placed.max())} per scenario; scenario 0 "
          f"{int(warm.placed[0])} == single replay {single.placed}; launches "
          f"{json.dumps(launches)}; profiled: wall {res_p.wall_clock_s:.3f}s, device busy "
          f"{busy_s:.3f}s ({busy_s / res_p.wall_clock_s:.1%})", flush=True)

    # Each kernel held against its twin, and timed, at the headline shapes.
    rng = np.random.default_rng(SEED + 128)
    tb_t = eng._tables()
    tb_t, tb_k, pre, pre_nodes = mid_replay_tables(ec, ep, tb_t.cluster, tb_t.consts,
                                                   hs["scenarios"], rng, dev)
    held = hold_kernels(f"S={hs['scenarios']} kernel checks (N={hs['nodes']})", ep, tb_t, tb_k,
                        pre, pre_nodes, 40, rng, dev)
    kernels, release = time_kernels(ep, tb_t, held, dev)
    results["kernels"], results["apply_release"] = kernels, release
    results["chunk_loop_bound_ms_headline"] = Work(ep, eng._tables()).chunk_loop_ms(
        eng.plan, warm.assignments, launches)
    print(f"headline chunk-loop bound (B6): "
          f"{json.dumps(results['chunk_loop_bound_ms_headline'])} ms; release of "
          f"{release['pairs']} pods x {release['scenarios']} scenarios: {release['ms']:.4f} ms, "
          f"bound {release['bound_ms']:.6f} ms", flush=True)
    results["wall_s_total"] = time.perf_counter() - t_start

    table = []
    for k, m in kernels.items():
        src, replaces = SOURCES[k]
        table.append({
            "name": k, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[k], "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": m["library_ms"],
        })
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(results, f, indent=1)
    print(f"done in {results['wall_s_total']:.1f}s", flush=True)
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
