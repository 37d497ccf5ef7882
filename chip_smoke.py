"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

From the root of a checkout, on a host with one CUDA card. In order:

1. prints the card's name and power limit (nvidia-smi);
2. builds the replay kernels from ``kubernetes_simulator_tpu_torch/csrc``
   (one nvcc per source, in parallel) and prints the build seconds;
3. holds each kernel against its plain-PyTorch twin on the card at the
   main path's shapes (the config2 trace: 5,000 nodes, 50,000 pods, the
   full default plugin set) over a few hundred random slots: masks,
   score rows, choices and the state after every apply must be exactly
   equal; times each kernel, its twin and a PyTorch yardstick, and works
   out each kernel's least possible time on the card;
4. replays a reduced case (300 nodes, 3,000 pods, full plugins,
   completions and gangs on) through the kernel path, the plain path on
   the card and the plain path on the CPU: assignments must be identical;
5. replays the config2 shape (5,000 nodes, 50,000 pods, full default
   plugins, durationMean 50, gangFraction 0.02) through the kernel path
   with every launch counter zeroed just before, checks the result, and
   fails unless each kernel was launched.

Prints the kernel table as one JSON line, then, as its last line,
``{"ok": true, "device": {...}}``. Any failed check raises (exit code
not 0, no result line). Details go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

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
from kubernetes_simulator_tpu_torch.ops import kernels as K  # noqa: E402
from kubernetes_simulator_tpu_torch.ops import reference as ref  # noqa: E402
from kubernetes_simulator_tpu_torch.sim.synthetic import make_cluster, make_workload  # noqa: E402
from kubernetes_simulator_tpu_torch.sim.torch_runtime import (  # noqa: E402
    StepSpec,
    TorchReplayEngine,
)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
F32_OPS_PER_S = 67e12  # H100 SXM f32 rate outside the tensor cores
CHECK_SLOTS = 300
SEED = 0

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
    completions and gangs on."""
    cluster = make_cluster(nodes, seed=seed, taint_fraction=0.1)
    workload, _ = make_workload(
        pods, seed=seed, with_affinity=True, with_spread=True, with_tolerations=True,
        duration_mean=duration_mean, gang_fraction=gang_fraction,
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


def bound(nbytes, nops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


NUM_ROWS = ref.NUM_ROWS


def k1_work(ec, ep, tb, p):
    """(bytes, ops) the K1 function needs for pod p: each input it reads
    once, each output written once."""
    N, R = ec.allocatable.shape
    G = tb.cluster.gdom.shape[0]
    D = tb.state.match_count.shape[1]
    k = tb.consts
    groups = set()
    if k.interpod:
        groups |= {int(g) for g in ep.aff_req[p] if g >= 0}
        groups |= {int(g) for g in ep.anti_req[p] if g >= 0}
        groups |= {int(g) for g in ep.pref_aff[p] if g >= 0}
        groups |= set(np.nonzero(ep.pod_matches_group[p])[0].tolist())
    if k.spread:
        groups |= {int(g) for g in ep.spread_g[p] if g >= 0}
    TT, E = ec.taint_key.shape[1], tb.cluster.expr_match.shape[1]
    nbytes = (
        2 * N * R * 4  # used, alloc
        + (3 * N * TT * 4 if k.taints else 0)
        + (N * E if k.node_affinity else 0)
        + len(groups) * (N * 4 + D * 4 * (3 if k.interpod else 1))  # gdom rows + plane rows
        + N * (1 + NUM_ROWS * 4 + 1)  # feasible, score rows, ignored
    )
    nops = N * (R * 8 + TT * 4 + len(groups) * 4 + 16)
    return nbytes, nops


def check_kernels(ec, ep, results, dev="cuda"):
    """Step 3: kernels vs twins at the main path's shapes."""
    dev = torch.device(dev)
    spec = StepSpec.from_config(ec, FrameworkConfig(), ep)
    consts = spec.consts()
    cl, pods = ref.cluster_to(ec, dev), ref.pods_to(ep, dev)
    G, D = cl.gdom.shape[0], max(ec.max_domains, 1)
    zero = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)
    state_k = ref.DevState(zero(ec.num_nodes, ec.num_resources), zero(G, D), zero(G, D),
                           zero(G, D))
    tb_t = ref.Tables(cl, pods, state_k, ref.new_scratch(ec.num_nodes, dev), consts)
    rng = np.random.default_rng(SEED)
    # A realistic mid-replay state: a third of the trace bound at random.
    pre = rng.choice(ep.num_pods, size=ep.num_pods // 3, replace=False).astype(np.int32)
    pre_nodes = rng.integers(0, ec.num_nodes, size=pre.size).astype(np.int32)
    ref.apply_placements(tb_t, torch.as_tensor(pre, device=dev),
                         torch.as_tensor(pre_nodes, device=dev), 1.0)
    state_t = ref.DevState(*(t.clone() for t in state_k))
    tb_k = ref.Tables(cl, pods, state_k, ref.new_scratch(ec.num_nodes, dev), consts)
    tb_t = tb_t._replace(state=state_t)
    b = K.Bound(tb_k)

    def same_state(where):
        for name in ref.DevState._fields:
            x, y = getattr(tb_k.state, name), getattr(tb_t.state, name)
            if not torch.equal(x, y):
                err = float((x - y).abs().max())
                raise AssertionError(f"{where}: state {name} differs (max |d| {err})")

    slots = rng.choice(np.setdiff1d(np.arange(ep.num_pods), pre), size=CHECK_SLOTS,
                       replace=False).astype(np.int32)
    pid = torch.as_tensor(slots, device=dev)
    ch_k = torch.full((CHECK_SLOTS,), PAD, dtype=torch.int32, device=dev)
    ch_t = ch_k.clone()
    k1_err = 0.0  # K2 and K3 are held exactly (choices, states) and raise otherwise
    placed = 0
    for i, p in enumerate(slots.tolist()):
        K.filter_score(b, p)
        ref.filter_score(tb_t, p)
        xk, xt = tb_k.scratch, tb_t.scratch
        if not torch.equal(xk.feasible, xt.feasible) or not torch.equal(xk.ignored, xt.ignored):
            raise AssertionError(f"filter_score: masks differ at pod {p}")
        k1_err = max(k1_err, float((xk.scores - xt.scores).abs().max()))
        K.normalize_select(b, p, ch_k[i : i + 1])
        ref.normalize_select(tb_t, p, ch_t[i : i + 1])
        if int(ch_k[i]) != int(ch_t[i]):
            raise AssertionError(f"normalize_select: choice {int(ch_k[i])} != {int(ch_t[i])} "
                                 f"at pod {p}")
        placed += int(ch_k[i] >= 0)
        K.apply_placements(b, pid[i : i + 1], ch_k[i : i + 1], 1.0)
        ref.apply_placements(tb_t, pid[i : i + 1], ch_t[i : i + 1], 1.0)
    torch.cuda.synchronize()
    same_state("binds")
    if k1_err != 0.0:
        raise AssertionError(f"filter_score: score rows differ by {k1_err}")
    if not 0 < placed < CHECK_SLOTS + 1:
        raise AssertionError("no slot placed: the check state is degenerate")
    # Release of a chunk-boundary-sized batch, in pod order.
    n_rel = min(4000, pre.size)
    rel = rng.choice(pre.size, size=n_rel, replace=False)
    rel = rel[np.argsort(pre[rel])]  # pod order, as a boundary releases
    rel_p = torch.as_tensor(pre[rel], device=dev)
    rel_n = torch.as_tensor(pre_nodes[rel], device=dev)
    K.apply_placements(b, rel_p, rel_n, -1.0)
    ref.apply_placements(tb_t, rel_p, rel_n, -1.0)
    torch.cuda.synchronize()
    same_state("release")
    # Gang rollback over one wave: a gang with its last member unplaced, a
    # complete gang, a non-gang pod and a padded slot.
    gid = ep.group_id
    gangs = np.unique(gid[gid >= 0])[:2]
    wave = np.concatenate([np.nonzero(gid == gangs[0])[0], np.nonzero(gid == gangs[1])[0],
                           np.nonzero(gid < 0)[0][:1], [PAD]]).astype(np.int32)
    wnodes = rng.integers(0, ec.num_nodes, size=wave.size).astype(np.int32)
    wnodes[int((gid[wave[wave >= 0]] == gangs[0]).sum()) - 1] = PAD
    wnodes[-1] = PAD
    w_p = torch.as_tensor(wave, device=dev)
    wn_k = torch.as_tensor(wnodes, device=dev)
    wn_t = wn_k.clone()
    K.apply_placements(b, w_p, wn_k, -1.0, rollback=True)
    ref.apply_placements(tb_t, w_p, wn_t, -1.0, rollback=True)
    torch.cuda.synchronize()
    same_state("rollback")
    if not torch.equal(wn_k, wn_t) or int((wn_k < 0).sum()) <= 2:
        raise AssertionError("rollback: choices differ or no member rolled back")

    # Timings at these shapes (launches here are not the main path's).
    iters = 200
    p_list = slots.tolist()
    t_k1 = time_cuda(lambda i: K.filter_score(b, p_list[i % CHECK_SLOTS]), iters)
    t_k1_plain = time_cuda(lambda i: ref.filter_score(tb_t, p_list[i % CHECK_SLOTS]), 20)
    t_k2 = time_cuda(lambda i: K.normalize_select(b, p_list[i % CHECK_SLOTS], ch_k[:1]), iters)
    t_k2_plain = time_cuda(
        lambda i: ref.normalize_select(tb_t, p_list[i % CHECK_SLOTS], ch_t[:1]), 20)
    total = ref.weighted_total(tb_t, p_list[0])
    masked = torch.where(tb_t.scratch.feasible, total, torch.full_like(total, float("-inf")))
    t_argmax = time_cuda(lambda i: torch.argmax(masked), iters)
    one_p, one_n = pid[:1], ch_k[:1].clone()
    one_n.clamp_(min=0)
    t_k3 = time_cuda(lambda i: K.apply_placements(b, one_p, one_n, 1.0 - 2.0 * (i % 2)),
                     iters)
    t_k3_plain = time_cuda(
        lambda i: ref.apply_placements(tb_t, one_p, one_n, 1.0 - 2.0 * (i % 2)), 20)
    t_k3_rel = time_cuda(lambda i: K.apply_placements(b, rel_p, rel_n, 1.0 - 2.0 * (i % 2)),
                         10)
    t_k3_rel_plain = time_cuda(
        lambda i: ref.apply_placements(tb_t, rel_p, rel_n, 1.0 - 2.0 * (i % 2)), 10)

    # Device time per launch (CUPTI); the event timings above are the
    # host's launch interval, which bounds a loop of tiny launches.
    d_k1 = device_ms(lambda i: K.filter_score(b, p_list[i % CHECK_SLOTS]), iters,
                     "ksim_filter_score")
    d_k2 = device_ms(lambda i: K.normalize_select(b, p_list[i % CHECK_SLOTS], ch_k[:1]),
                     iters, "ksim_normalize_select")
    d_argmax = device_ms(lambda i: torch.argmax(masked), iters)
    d_k3 = device_ms(lambda i: K.apply_placements(b, one_p, one_n, 1.0 - 2.0 * (i % 2)),
                     iters, "ksim_apply")
    d_k3_rel = device_ms(
        lambda i: K.apply_placements(b, rel_p, rel_n, 1.0 - 2.0 * (i % 2)), 10, "ksim_apply")
    pick = lambda d, t: d if d is not None else t

    N, R = ec.allocatable.shape
    k1b, k1o = np.mean([k1_work(ec, ep, tb_t, p) for p in p_list], axis=0)
    k2b = N * (1 + NUM_ROWS * 4 + 1) + 4
    k2o = N * 24
    Gm = int(ep.pod_matches_group[int(slots[0])].sum())
    k3b = R * 4 * 3 + G + G * 4 + Gm * 4 * 2 + 8
    k3o = R + Gm
    rel_groups = ep.pod_matches_group[pre[rel]].sum()
    k3rb = n_rel * (8 + R * 4 * 3 + G + G * 4) + rel_groups * 8
    results["kernels"] = {
        "filter_score": dict(max_abs_err=k1_err, ms=pick(d_k1, t_k1),
                             device_ms=d_k1, launch_interval_ms=t_k1, plain_ms=t_k1_plain,
                             bytes=float(k1b), ops=float(k1o), library_ms=None),
        "normalize_select": dict(max_abs_err=0.0, ms=pick(d_k2, t_k2), device_ms=d_k2,
                                 launch_interval_ms=t_k2, plain_ms=t_k2_plain,
                                 bytes=float(k2b), ops=float(k2o),
                                 library_ms=pick(d_argmax, t_argmax),
                                 library_launch_interval_ms=t_argmax),
        "apply_placements": dict(max_abs_err=0.0, ms=pick(d_k3, t_k3), device_ms=d_k3,
                                 launch_interval_ms=t_k3, plain_ms=t_k3_plain,
                                 bytes=float(k3b), ops=float(k3o), library_ms=None),
    }
    results["apply_release"] = dict(
        pairs=n_rel, ms=pick(d_k3_rel, t_k3_rel), device_ms=d_k3_rel,
        launch_interval_ms=t_k3_rel, plain_ms=t_k3_rel_plain,
        bound_ms=bound(float(k3rb), n_rel * (R + 8.0))[0],
    )
    results["check_slots"] = CHECK_SLOTS
    results["check_placed"] = placed
    print(f"kernel checks: {CHECK_SLOTS} slots ({placed} placed), a {n_rel}-pair release and "
          f"a gang rollback — kernels equal their twins exactly", flush=True)


def check_reduced_replay(results, dev="cuda"):
    """Step 4: kernel path == plain path on the card == plain path on the
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script needs a CUDA "
              "card", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {name}", flush=True)
    results = {"nvidia_smi": smi, "device": name}

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

    check_kernels(ec, ep, results)
    check_reduced_replay(results)

    # Step 5: the main path, full size, kernel path; counters from zero.
    eng = TorchReplayEngine(ec, ep, FrameworkConfig(), wave_width=8, chunk_waves=1024)
    K.reset_launch_counts()
    res = eng.replay()
    launches = K.launch_counts()
    check_result(ec, ep, res)
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {k} was not launched on the main path")
    results["main"] = dict(
        nodes=ec.num_nodes, pods=ep.num_pods, wall_s=res.wall_clock_s,
        placements_per_s=res.placements_per_sec, placed=res.placed,
        unschedulable=res.unschedulable, launches=launches,
        phases=res.telemetry.phases if res.telemetry is not None else None,
    )
    # A second, profiled replay of the same case: the device's busy share.
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        res_p = eng.replay()
    busy_us = sum(
        (getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0))
        for e in prof.key_averages()
    )
    if not np.array_equal(res_p.assignments, res.assignments):
        raise AssertionError("the profiled replay placed differently")
    results["main_profiled"] = dict(
        wall_s=res_p.wall_clock_s, device_busy_s=busy_us / 1e6,
        device_busy_share=busy_us / 1e6 / res_p.wall_clock_s if busy_us else None,
    )
    print(f"profiled replay: wall {res_p.wall_clock_s:.3f}s, device busy "
          f"{busy_us / 1e6:.3f}s", flush=True)
    print(f"main path (5000 nodes, 50000 pods, full plugins, completions + gangs): "
          f"wall {res.wall_clock_s:.3f}s, {res.placements_per_sec:.1f} placements/s, "
          f"placed {res.placed}, unschedulable {res.unschedulable}", flush=True)
    print("kernels " + json.dumps(launches), flush=True)

    table = []
    for k, m in results["kernels"].items():
        src, replaces = SOURCES[k]
        b_ms, b_by = bound(m["bytes"], m["ops"])
        m.update(bound_ms=b_ms, bound_by=b_by)
        table.append({
            "name": k, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[k], "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": m["library_ms"],
        })
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
