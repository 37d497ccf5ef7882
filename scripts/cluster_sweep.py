"""Time the cluster selects at every cluster size and block width, on the card.

K2 (normalize_select), K6 (chunk_replay, its K2 phase) and K7 (shard_select)
launch as thread-block clusters whose geometry ``ops/kernels.py``
``cluster_plan`` chooses. This script overrides that choice, launch by
launch, with every cluster size C (1..8) and block width (256, 512, 1,024
threads) at the main path's shapes, checks that each geometry gives the
plan's choices bit for bit, and prints each launch's device time
(torch.profiler, CUPTI) beside the plan's own geometry:

- K2 after K1 on a mid-replay state: S = 1 at N = 500, 5,000 and 10,000;
  S = 128 at N = 2,000;
- K7 after K1 at config13's layout (N = 10,000 over 8 shards) and at 3;
- K6 over 32 waves of a 5,000-node replay at S = 1.

``--split`` instead splits K6's slot into its phases: the script builds
``csrc/chunk_replay.cu`` with ``-DKSIM_K6_STAMPS`` into a library of its own
(the kernels' build carries no stamp), runs the first chunk of the headline
what-if (S = 128 x 2,000 nodes) and of config4 (S = 1 x 10,000 nodes) through
it, checks the choices and planes against the unstamped K6, and prints the
median of each phase a slot from the stamps of scenario 0's first block.

``--release`` instead splits K3's release into its kernels: each release
case (the headline's 4,000 pods x 128 scenarios x 2,000 nodes, the same at
one scenario of 5,000 nodes, the Borg cut's 4 x 4,000 pairs on 12 nodes
plain and with tier planes, and 20,000 pods x 128 scenarios x 10,000 nodes)
released 20 times from a restored state under torch.profiler, each kernel's
(and any memset's) device time a release printed from that one profile. It
uses only ``ops/kernels.py`` ``apply_placements`` and ``chip_smoke.py``'s
cases, so a copy of it in an older checkout times that checkout's release.

Usage (needs a CUDA card; writes ``chiprun_out/cluster_sweep.json`` or, with
``--split``, ``chiprun_out/k6_split.json``, or, with ``--release``,
``chiprun_out/release_split.json``)::

    python scripts/cluster_sweep.py [--split | --release]
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from kubernetes_simulator_tpu_torch import cli  # noqa: E402
from kubernetes_simulator_tpu_torch.framework.framework import FrameworkConfig  # noqa: E402
from kubernetes_simulator_tpu_torch.ops import kernels as K  # noqa: E402
from kubernetes_simulator_tpu_torch.ops import reference as ref  # noqa: E402
from kubernetes_simulator_tpu_torch.sim.torch_runtime import (  # noqa: E402
    StepSpec,
    TorchReplayEngine,
    new_choices,
    run_waves,
)
from kubernetes_simulator_tpu_torch.sim.whatif import WhatIfEngine, uniform_scenarios  # noqa: E402

WIDTHS = (256, 512, 1024)


def device_ms(fn, iters, match):
    """Device ms a call (torch.profiler), or CUDA events where the profiler
    recorded no device time."""
    return cs.device_ms(fn, iters, match) or cs.time_cuda(fn, iters)


def geometries(plan, widths=WIDTHS):
    """Every (C, threads) plan of the same shapes; the plan's own first."""
    out = [plan]
    for C in range(1, K.CLUSTER_CAP + 1):
        if plan.NP > 1:
            if C > plan.NP:
                continue
            span = plan.span
        else:
            span = K._round32(-(-plan.N // C))
            if -(-plan.N // span) != C:
                continue
        for t in widths:
            g = K.ClusterPlan(S=plan.S, N=plan.N, NP=plan.NP, C=C, threads=t, span=span,
                              grid=plan.S * C)
            if g not in out:
                out.append(g)
    return out


def sweep_k2(S, N, dev, rows):
    ec, ep = cs.case(N, max(4 * N, 2000))
    consts = StepSpec.from_config(ec, FrameworkConfig(), ep).consts()
    rng = np.random.default_rng(cs.SEED)
    tb_t, tb_k, pre, _ = cs.mid_replay_tables(ec, ep, ref.cluster_to(ec, dev, S), consts, S,
                                              rng, dev)
    b = K.Bound(tb_k)
    pods = rng.choice(np.setdiff1d(np.arange(ep.num_pods), pre), size=4, replace=False)
    p = int(pods[0])
    K.filter_score(b, p)
    ch = torch.full((S, 1), -1, dtype=torch.int32, device=dev)
    want = ch.clone()
    ref.normalize_select(tb_k, p, want, 0)
    plan = b.plan("normalize_select")
    for g in geometries(plan):
        b._plans["normalize_select"] = g
        ch.fill_(-1)
        K.normalize_select(b, p, ch, 0)
        torch.cuda.synchronize()
        if not torch.equal(ch, want):
            raise AssertionError(f"K2 {g}: {ch.flatten()[:4].tolist()} != "
                                 f"{want.flatten()[:4].tolist()}")
        ms = device_ms(lambda i: K.normalize_select(b, p, ch, 0), 200,
                       "ksim_normalize_select")
        rows.append(dict(kernel="normalize_select", S=S, N=N, C=g.C, threads=g.threads,
                         plan=g == plan, us=ms * 1e3))
        print(json.dumps(rows[-1]), flush=True)
    b._plans["normalize_select"] = plan


def sweep_k7(P, dev, rows):
    ec, ep = cs.case(10_000, 2000)
    eng = TorchReplayEngine(ec, ep, FrameworkConfig(), chunk_waves=8, device=dev,
                            node_shards=P)
    tb = eng._tables()
    b = K.Bound(tb)
    ch = new_choices(eng.plan, 1, eng.pods.bound_node, dev)
    p = int(eng.plan.idx[0, 0])
    K.filter_score(b, p)
    want = ch.clone()
    ref.shard_select(tb, p, want, 0)
    plan = b.plan("shard_select")
    for g in geometries(plan):
        b._plans["shard_select"] = g
        K.shard_select(b, p, ch, 0)
        torch.cuda.synchronize()
        if not torch.equal(ch, want):
            raise AssertionError(f"K7 {g}: {int(ch[0, 0])} != {int(want[0, 0])}")
        ms = device_ms(lambda i: K.shard_select(b, p, ch, 0), 200, "ksim_shard_select")
        rows.append(dict(kernel="shard_select", S=1, N=10_000, NP=P, C=g.C,
                         threads=g.threads, plan=g == plan, us=ms * 1e3))
        print(json.dumps(rows[-1]), flush=True)
    b._plans["shard_select"] = plan


def sweep_k6(N, dev, rows, waves=32):
    ec, ep = cs.case(N, 20_000)
    eng = TorchReplayEngine(ec, ep, FrameworkConfig(), wave_width=8, chunk_waves=64,
                            device=dev)
    plan_w = eng.plan
    desc = plan_w.device_desc(dev)
    tb = eng._tables()
    ch = new_choices(plan_w, 1, eng.pods.bound_node, dev)
    b = K.Bound(tb)
    snap = {k: x.clone() for k, x in cs._planes(tb).items()}
    ch0 = ch.clone()

    def run():
        for k, x in cs._planes(tb).items():
            x.copy_(snap[k])
        ch.copy_(ch0)
        K.chunk_replay(b, desc.idx, desc.gang, ch, 0, waves)

    tb_s, ch_s = eng._tables(), ch0.clone()
    run_waves(plan_w, tb_s, ch_s, 0, waves, plain=False, route="slot")
    plan = b.plan("chunk_replay")
    slots = int((plan_w.idx[:waves] >= 0).sum())
    cands = [plan] + [
        K.ClusterPlan(S=1, N=N, NP=1, C=C, threads=K.SELECT_THREADS,
                      span=K._round32(-(-N // C)), grid=C)
        for C in range(1, K.CLUSTER_CAP + 1)
        if -(-N // K._round32(-(-N // C))) == C
    ]
    for g in dict.fromkeys(cands):
        b._plans["chunk_replay"] = g
        run()
        torch.cuda.synchronize()
        if not torch.equal(ch, ch_s):
            raise AssertionError(f"K6 {g}: choices differ from the per-slot route")
        ms = device_ms(lambda i: run(), 10, "ksim_chunk_replay")
        rows.append(dict(kernel="chunk_replay", S=1, N=N, C=g.C, span=g.span,
                         plan=g == plan, slots=slots, us_per_slot=ms * 1e3 / slots))
        print(json.dumps(rows[-1]), flush=True)
    b._plans["chunk_replay"] = plan


#: The intervals between the stamped points of a K6 slot (csrc/chunk_replay.cu
#: K6_STAMP): the pod's term tables and the block barrier, K1's body over the
#: block's nodes and the block barrier, K2's body (with its cluster exchanges),
#: K3's bind (rank 0; the others wait), the cluster barrier.
SPLIT_PHASES = ("k1_prologue", "k1_nodes", "k2_phase", "k3_bind", "barrier")
STAMP_SLOTS = 4096


def stamped_chunk_replay():
    """K6 built with its phase stamps into a library of its own under
    ``_build/``: (its entry point, its stamp reader)."""
    out = K._lib_path("chunk_replay_stamps.cu")
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run([K._nvcc(), *K.NVCC_FLAGS, "-DKSIM_K6_STAMPS", "-I", str(K.CSRC),
                        "-o", str(out), *(str(K.CSRC / f) for f in (
                            K.KERNELS["chunk_replay"], *K.EXTRA_SOURCES["chunk_replay"]))],
                       check=True)
    lib = ctypes.CDLL(str(out))
    fn = lib.ksim_chunk_replay
    fn.argtypes, fn.restype = K._ARGTYPES["chunk_replay"], ctypes.c_int
    rd = lib.ksim_chunk_replay_stamps
    rd.argtypes, rd.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_int
    return fn, rd


def split_k6(where, plan, mk, stamped, rows):
    """K6 over the first chunk of ``plan`` from the state ``mk()`` makes,
    once unstamped and once stamped (the same choices and planes), and the
    stamped slot split into its phases (ns, medians over the stamped slots)."""
    fn, rd = stamped
    dev = torch.device("cuda")
    desc = plan.device_desc(dev)
    end = plan.C
    slots = int((plan.idx[:end] >= 0).sum())
    out = {}
    for name in ("plain", "stamped"):
        tb, ch = mk()
        b = K.Bound(tb)
        keep = K._libs["chunk_replay"]
        if name == "stamped":
            K._libs["chunk_replay"] = fn
        try:
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
            K.chunk_replay(b, desc.idx, desc.gang, ch, 0, end)
            ev[1].record()
            torch.cuda.synchronize()
        finally:
            K._libs["chunk_replay"] = keep
        out[name] = (tb, ch, ev[0].elapsed_time(ev[1]) * 1e3 / slots)
    cs.same_planes(f"{where}: stamped K6 vs K6", out["plain"][0], out["plain"][1],
                   out["stamped"][0], out["stamped"][1])
    n = min(slots, STAMP_SLOTS)
    buf = (ctypes.c_longlong * (4 + 6 * n))()
    rc = rd(buf, len(buf))
    if rc != 0:
        raise RuntimeError(f"reading K6's stamps failed with CUDA error {rc}")
    arr = np.frombuffer(buf, dtype=np.int64)
    cycles_per_ns = (arr[3] - arr[1]) / (arr[2] - arr[0])
    st = arr[4:].reshape(n, 6).astype(np.float64) / cycles_per_ns
    phases = np.diff(st, axis=1)
    row = dict(kernel="chunk_replay", split=where, S=int(out["plain"][1].shape[0]),
               N=int(out["plain"][0].state.used.shape[1]), cluster=cs.plan_of(K.chunk_replay),
               slots=slots, stamped_slots=n, us_per_slot=out["plain"][2],
               stamped_us_per_slot=out["stamped"][2], sm_clock_ghz=float(cycles_per_ns),
               slot_ns_median=float(np.median(st[:, 5] - st[:, 0])),
               **{f"{k}_ns_median": float(np.median(phases[:, i]))
                  for i, k in enumerate(SPLIT_PHASES)},
               **{f"{k}_ns_p90": float(np.percentile(phases[:, i], 90))
                  for i, k in enumerate(SPLIT_PHASES)})
    rows.append(row)
    print(json.dumps(row), flush=True)


def split_main(dev, rows):
    stamped = stamped_chunk_replay()
    hs = cs.HEADLINE
    ec, ep = cs.case(hs["nodes"], hs["pods"])
    scen = uniform_scenarios(ec, hs["scenarios"], seed=0)
    eng = WhatIfEngine(ec, ep, scen, FrameworkConfig(), chunk_waves=hs["chunk_waves"],
                       collect_assignments=True)
    split_k6("headline", eng.plan,
             lambda: (eng._tables(), new_choices(eng.plan, eng.S, eng.pods.bound_node, dev)),
             stamped, rows)
    del eng
    t0 = time.perf_counter()
    cfg = cli._load(os.path.join(ROOT, cs.CONFIG4))
    ec, ep = cli.build_encoded_case(cfg)
    eng = TorchReplayEngine(ec, ep, cfg.framework, wave_width=cfg.wave_width,
                            chunk_waves=cfg.chunk_waves, device=dev)
    print(f"config4 built in {time.perf_counter() - t0:.1f}s", flush=True)
    split_k6("config4", eng.plan,
             lambda: (eng._tables(), new_choices(eng.plan, 1, ep.bound_node, dev)),
             stamped, rows)


#: K3's release cases: (name, nodes, pods, scenarios, released pods, kind);
#: nodes None for the Borg cut (chip_smoke.BORG_CUT).
RELEASE_SPLIT_CASES = (
    ("headline", 2000, 20_000, 128, 4000, "borg"),
    ("s1_n5000", 5000, 8000, 1, 4000, "borg"),
    ("borg_cut", None, None, 4, 4000, "borg"),
    ("borg_cut_tier", None, None, 4, 4000, "tier"),
    ("s128_n10000_k20000", 10_000, 20_000, 128, 20_000, "borg"),
)


def release_split(dev, rows, iters=20):
    from torch.profiler import ProfilerActivity, profile

    from kubernetes_simulator_tpu_torch.sim.borg import BorgSpec, make_borg_encoded

    for name, nodes, pods, S, released, kind in RELEASE_SPLIT_CASES:
        if nodes is None:
            bc = cs.BORG_CUT
            ec, ep, _ = make_borg_encoded(BorgSpec(nodes=bc["nodes"], tasks=bc["tasks"],
                                                   seed=cs.SEED))
        else:
            ec, ep = cs.case(nodes, pods)
        (tb_k, pid_k, pos, ch_k, due_k), _ = cs.release_case(kind, ec, ep, dev, S=S,
                                                             n_pairs=released)
        b = K.Bound(tb_k)
        fn = cs.restored(tb_k, lambda i: K.apply_placements(b, pid_k, pos, ch_k, -1.0,
                                                            due=due_k))
        for i in range(3):
            fn(i)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(i)
            torch.cuda.synchronize()
        split = {}
        for e in prof.key_averages():
            us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)
            if us and ("ksim_release" in e.key or "Memset" in e.key):
                key = e.key.split("(")[0].split("<")[0].replace("void ", "")
                split[key] = split.get(key, 0.0) + us / iters
        row = dict(kernel="apply_placements_release", case=name, S=S,
                   N=int(tb_k.state.used.shape[1]), pairs=int(pid_k.shape[-1]),
                   us=sum(split.values()), us_by_kernel=split)
        rows.append(row)
        print(json.dumps(row), flush=True)
        del tb_k, b, fn, prof
        torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("cluster_sweep: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    K.build()
    if "--split" in sys.argv[1:]:
        rows = []
        split_main(dev, rows)
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        with open(os.path.join(ROOT, "chiprun_out", "k6_split.json"), "w") as f:
            json.dump(dict(nvidia_smi=smi, rows=rows), f, indent=1)
        return 0
    if "--release" in sys.argv[1:]:
        rows = []
        release_split(dev, rows)
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        with open(os.path.join(ROOT, "chiprun_out", "release_split.json"), "w") as f:
            json.dump(dict(nvidia_smi=smi, rows=rows), f, indent=1)
        return 0
    rows = []
    for S, N in ((1, 5000), (1, 10_000), (128, 2000), (1, 500)):
        sweep_k2(S, N, dev, rows)
    for P in (8, 3):
        sweep_k7(P, dev, rows)
    sweep_k6(5000, dev, rows)
    sweep_k6(10_000, dev, rows)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "cluster_sweep.json"), "w") as f:
        json.dump(dict(nvidia_smi=smi, rows=rows), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
