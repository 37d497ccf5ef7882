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

Usage (needs a CUDA card; writes ``chiprun_out/cluster_sweep.json``)::

    python scripts/cluster_sweep.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from kubernetes_simulator_tpu_torch.framework.framework import FrameworkConfig  # noqa: E402
from kubernetes_simulator_tpu_torch.ops import kernels as K  # noqa: E402
from kubernetes_simulator_tpu_torch.ops import reference as ref  # noqa: E402
from kubernetes_simulator_tpu_torch.sim.torch_runtime import (  # noqa: E402
    StepSpec,
    TorchReplayEngine,
    new_choices,
    run_waves,
)

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
    tiles = -(-N // K.SELECT_THREADS)
    cands = [plan] + [
        K.ClusterPlan(S=1, N=N, NP=1, C=C, threads=K.SELECT_THREADS,
                      span=K._round32(-(-N // C)), grid=C * -(-tiles // C))
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
        rows.append(dict(kernel="chunk_replay", S=1, N=N, C=g.C, grid=g.grid,
                         plan=g == plan, slots=slots, us_per_slot=ms * 1e3 / slots))
        print(json.dumps(rows[-1]), flush=True)
    b._plans["chunk_replay"] = plan


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
    res = {C: K.chunk_clusters(C, dev) for C in range(1, K.CLUSTER_CAP + 1)}
    print("K6's resident clusters of C blocks (1,024 threads): " + json.dumps(res), flush=True)
    rows = []
    for S, N in ((1, 5000), (1, 10_000), (128, 2000), (1, 500)):
        sweep_k2(S, N, dev, rows)
    for P in (8, 3):
        sweep_k7(P, dev, rows)
    sweep_k6(5000, dev, rows)
    sweep_k6(10_000, dev, rows)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "cluster_sweep.json"), "w") as f:
        json.dump(dict(nvidia_smi=smi, resident=res, rows=rows), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
