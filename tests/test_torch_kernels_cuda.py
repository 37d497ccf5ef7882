"""The port's CUDA kernels against their plain twins, on the card.

Marked ``cuda``: each test skips (inside the test, never at collection)
where torch has no CUDA device. On the card, run them with

    python -m pytest tests/test_torch_kernels_cuda.py -q -m cuda

Tolerance: none — the kernels keep the twins' operation order, and are
compiled without FMA contraction and with IEEE division — except the
what-if ``utilization_cpu`` of the card against the CPU (1e-6: an f32 mean
over nodes summed in another order)."""

import numpy as np
import pytest
import torch

from kubernetes_simulator_tpu_torch.framework.framework import FrameworkConfig
from kubernetes_simulator_tpu_torch.models.encode import PAD, encode
from kubernetes_simulator_tpu_torch.ops import kernels as K
from kubernetes_simulator_tpu_torch.ops import reference as ref
from kubernetes_simulator_tpu_torch.sim.synthetic import make_cluster, make_workload
from kubernetes_simulator_tpu_torch.sim.torch_runtime import StepSpec, TorchReplayEngine

pytestmark = pytest.mark.cuda

#: The kernels every path launches (the retry buffer adds retry_boundary).
PATH_KERNELS = ("filter_score", "normalize_select", "apply_placements")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _case(seed, nodes=64, pods=600, **kw):
    cluster = make_cluster(nodes, seed=seed, taint_fraction=0.2)
    workload, _ = make_workload(pods, seed=seed, with_affinity=True, with_spread=True,
                                with_tolerations=True, **kw)
    return encode(cluster, workload)


@pytest.mark.parametrize("seed", range(3))
def test_kernels_equal_twins(card, seed):
    ec, ep = _case(seed, gang_fraction=0.1, gang_size=3)
    consts = StepSpec.from_config(ec, FrameworkConfig(), ep).consts()
    cl, pods = ref.cluster_to(ec, card), ref.pods_to(ep, card)
    G, D = cl.gdom.shape[1], max(ec.max_domains, 1)
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=card)
    st_k = ref.DevState(z(1, ec.num_nodes, ec.num_resources), z(1, G, D), z(1, G, D),
                        z(1, G, D))
    st_t = ref.DevState(*(t.clone() for t in st_k))
    tb_k = ref.Tables(cl, pods, st_k, ref.new_scratch(1, ec.num_nodes, card), consts)
    tb_t = ref.Tables(cl, pods, st_t, ref.new_scratch(1, ec.num_nodes, card), consts)
    b = K.Bound(tb_k)
    ids = torch.arange(ep.num_pods, dtype=torch.int32, device=card)
    ch_k = torch.full((1, ep.num_pods), PAD, dtype=torch.int32, device=card)
    ch_t = ch_k.clone()
    for p in range(ep.num_pods):
        K.filter_score(b, p)
        ref.filter_score(tb_t, p)
        for f in ref.Scratch._fields:
            assert torch.equal(getattr(tb_k.scratch, f), getattr(tb_t.scratch, f)), (p, f)
        K.normalize_select(b, p, ch_k, p)
        ref.normalize_select(tb_t, p, ch_t, p)
        assert int(ch_k[0, p]) == int(ch_t[0, p]), p
        K.apply_placements(b, ids[p : p + 1], ids[p : p + 1], ch_k, 1.0)
        ref.apply_placements(tb_t, ids[p : p + 1], ids[p : p + 1], ch_t, 1.0)
    rel = ids[::3].contiguous()
    K.apply_placements(b, rel, rel, ch_k, -1.0)
    ref.apply_placements(tb_t, rel, rel, ch_t, -1.0)
    torch.cuda.synchronize()
    for f in ref.DevState._fields:
        assert torch.equal(getattr(st_k, f), getattr(st_t, f)), f


def test_batched_kernels_equal_twins(card):
    """At S=3 (scenarios whose allocatable and taints differ), each kernel
    equals its batched twin: masks, score rows, choices and the state after
    every bind, a bucketed release and a gang rollback."""
    from torch_port_case import scenario_tables

    ep, tb_cpu, _ = scenario_tables()
    move = lambda nt: type(nt)(*(x.to(card) if torch.is_tensor(x) else x for x in nt))
    mk = lambda: ref.Tables(move(tb_cpu.cluster), move(tb_cpu.pods),
                            type(tb_cpu.state)(*(x.to(card).clone() for x in tb_cpu.state)),
                            move(tb_cpu.scratch), tb_cpu.consts)
    tb_k, tb_t = mk(), mk()
    b = K.Bound(tb_k)
    P = ep.num_pods
    ids = torch.arange(P, dtype=torch.int32, device=card)
    ch_k = torch.full((3, P), PAD, dtype=torch.int32, device=card)
    ch_t = ch_k.clone()

    def same(where):
        torch.cuda.synchronize()
        for part in ("state", "scratch"):
            for f in getattr(tb_k, part)._fields:
                assert torch.equal(getattr(getattr(tb_k, part), f),
                                   getattr(getattr(tb_t, part), f)), (where, f)
        assert torch.equal(ch_k, ch_t), where

    for p in range(P):
        K.filter_score(b, p)
        ref.filter_score(tb_t, p)
        K.normalize_select(b, p, ch_k, p)
        ref.normalize_select(tb_t, p, ch_t, p)
        K.apply_placements(b, ids[p : p + 1], ids[p : p + 1], ch_k, 1.0)
        ref.apply_placements(tb_t, ids[p : p + 1], ids[p : p + 1], ch_t, 1.0)
        same(f"slot {p}")
    assert not torch.equal(ch_k[0], ch_k[1]) and (ch_k < 0).any()
    rel = ids[::3].contiguous()
    K.apply_placements(b, rel, rel, ch_k, -1.0)
    ref.apply_placements(tb_t, rel, rel, ch_t, -1.0)
    same("release")
    gid = ep.group_id
    wave = torch.as_tensor(np.nonzero(gid == gid[gid >= 0][0])[0].astype(np.int32),
                           device=card)
    ch_k[1, wave[-1].long()] = PAD
    ch_t[1, wave[-1].long()] = PAD
    K.apply_placements(b, wave, wave, ch_k, -1.0, rollback=True)
    ref.apply_placements(tb_t, wave, wave, ch_t, -1.0, rollback=True)
    same("rollback")
    assert (ch_k[1, wave.long()] == PAD).all()


def test_whatif_kernel_path_equals_plain_path(card):
    from kubernetes_simulator_tpu_torch.sim.whatif import WhatIfEngine, uniform_scenarios

    ec, ep = _case(8, nodes=40, pods=600, duration_mean=3.0, arrival_rate=50.0,
                   gang_fraction=0.1, gang_size=3)
    scen = uniform_scenarios(ec, 6, seed=1, p_node_down=0.5, p_taint=0.5)
    kw = dict(wave_width=4, chunk_waves=8, collect_assignments=True)
    K.reset_launch_counts()
    kern = WhatIfEngine(ec, ep, scen, FrameworkConfig(), device=card, **kw).run()
    assert all(K.launch_counts()[k] > 0 for k in PATH_KERNELS)
    plain = WhatIfEngine(ec, ep, scen, FrameworkConfig(), device=card, plain=True, **kw).run()
    cpu = WhatIfEngine(ec, ep, scen, FrameworkConfig(), device="cpu", **kw).run()
    np.testing.assert_array_equal(kern.assignments, plain.assignments)
    np.testing.assert_array_equal(kern.assignments, cpu.assignments)
    np.testing.assert_array_equal(kern.utilization_cpu, plain.utilization_cpu)
    # The card and the CPU take the f32 mean over nodes in different orders.
    np.testing.assert_allclose(kern.utilization_cpu, cpu.utilization_cpu, atol=1e-6)


def test_replay_kernel_path_equals_plain_path(card):
    ec, ep = _case(7, nodes=40, pods=800, duration_mean=3.0, arrival_rate=50.0,
                   gang_fraction=0.1, gang_size=3)
    kw = dict(wave_width=4, chunk_waves=8)
    K.reset_launch_counts()
    kern = TorchReplayEngine(ec, ep, FrameworkConfig(), device=card, **kw).replay()
    assert all(K.launch_counts()[k] > 0 for k in PATH_KERNELS)
    plain = TorchReplayEngine(ec, ep, FrameworkConfig(), device=card, plain=True, **kw).replay()
    cpu = TorchReplayEngine(ec, ep, FrameworkConfig(), device="cpu", **kw).replay()
    np.testing.assert_array_equal(kern.assignments, plain.assignments)
    np.testing.assert_array_equal(kern.assignments, cpu.assignments)
    np.testing.assert_array_equal(kern.state.used, cpu.state.used)


def _contended_preempt_case():
    """8 nodes, 300 pods with spread, tolerations and durations: evictions
    fire and completions release (tests/test_whatif_preempt_completions.py's
    contended trace)."""
    cluster = make_cluster(8, seed=2, taint_fraction=0.2)
    workload, _ = make_workload(300, seed=2, with_spread=True, with_tolerations=True,
                                duration_mean=20.0, arrival_rate=12.0)
    return encode(cluster, workload)


def test_preempt_kernels_equal_twins(card):
    """Under tier preemption, at S=4, launch after launch over a whole
    run: K1's candidate rows, K2's masked argmin (choices, eviction
    records, wave stamps), K3's eviction and victim marking (the whole
    choice buffer, the victim counters) and the state and tier planes
    after every bind, release and rollback equal the twins'."""
    from kubernetes_simulator_tpu_torch.sim.torch_runtime import new_choices
    from kubernetes_simulator_tpu_torch.sim.whatif import WhatIfEngine, uniform_scenarios

    ec, ep = _contended_preempt_case()
    eng = WhatIfEngine(ec, ep, uniform_scenarios(ec, 4, seed=1, p_capacity=0.5),
                       FrameworkConfig(), chunk_waves=4, preemption=True, device=card)
    plan = eng.plan
    tb_k, tb_t = eng._tables(), eng._tables()
    ch_k = new_choices(plan, 4, ep.bound_node, card)
    ch_t = ch_k.clone()
    b = K.Bound(tb_k)
    pk, pt = tb_k.preempt, tb_t.preempt
    idx = torch.as_tensor(plan.idx.reshape(-1), device=card)
    pos = torch.arange(plan.L, dtype=torch.int32, device=card)

    def same(where):
        torch.cuda.synchronize()
        for part in ("state", "scratch"):
            for f in getattr(tb_k, part)._fields:
                assert torch.equal(getattr(getattr(tb_k, part), f),
                                   getattr(getattr(tb_t, part), f)), (where, f)
        for f in ("used_tier", "npods_tier", "cand", "last_wave", "ev_node", "ev_tier",
                  "victims"):
            assert torch.equal(getattr(pk, f), getattr(pt, f)), (where, f)
        assert torch.equal(ch_k, ch_t), where

    W, C = plan.idx.shape[1], plan.C
    fired = 0
    for w in range(plan.idx.shape[0]):
        if w % C == 0 and plan.buckets[w // C] is not None:
            bp, bpos = (torch.as_tensor(x, device=card) for x in plan.buckets[w // C])
            K.apply_placements(b, bp, bpos, ch_k, -1.0)
            ref.apply_placements(tb_t, bp, bpos, ch_t, -1.0)
            same(f"release {w // C}")
        for k, p in enumerate(plan.idx[w].tolist()):
            if p < 0:
                continue
            s = w * W + k
            K.filter_score(b, p)
            ref.filter_score(tb_t, p)
            K.normalize_select(b, p, ch_k, s, w)
            ref.normalize_select(tb_t, p, ch_t, s, w)
            same(f"slot {s}")
            fired += int((pk.ev_node >= 0).sum())
            K.apply_placements(b, idx[s : s + 1], pos[s : s + 1], ch_k, 1.0, boundary=w // C)
            ref.apply_placements(tb_t, idx[s : s + 1], pos[s : s + 1], ch_t, 1.0,
                                 boundary=w // C)
            same(f"bind {s}")
        if plan.gang_wave[w]:
            K.apply_placements(b, idx[w * W : (w + 1) * W], pos[w * W : (w + 1) * W], ch_k,
                               -1.0, rollback=True)
            ref.apply_placements(tb_t, idx[w * W : (w + 1) * W], pos[w * W : (w + 1) * W],
                                 ch_t, -1.0, rollback=True)
            same(f"rollback {w}")
    assert fired > 0 and int(pk.victims.sum()) > 0


def test_preempt_kernel_path_equals_plain_path(card):
    """Tier preemption x completions: the replay and the S=4 what-if on the
    kernel path equal the plain path on the card and on the CPU, with the
    kernels launched."""
    from kubernetes_simulator_tpu_torch.sim.whatif import WhatIfEngine, uniform_scenarios

    ec, ep = _contended_preempt_case()
    kw = dict(chunk_waves=4, preemption=True)
    K.reset_launch_counts()
    kern = TorchReplayEngine(ec, ep, FrameworkConfig(), device=card, **kw).replay()
    assert all(K.launch_counts()[k] > 0 for k in PATH_KERNELS)
    for other in (TorchReplayEngine(ec, ep, FrameworkConfig(), device=card, plain=True,
                                    **kw).replay(),
                  TorchReplayEngine(ec, ep, FrameworkConfig(), device="cpu", **kw).replay()):
        np.testing.assert_array_equal(kern.assignments, other.assignments)
        assert kern.preemptions == other.preemptions
    assert kern.preemptions > 0
    scen = uniform_scenarios(ec, 4, seed=1, p_capacity=0.5)
    wkw = dict(kw, collect_assignments=True)
    wk = WhatIfEngine(ec, ep, scen, FrameworkConfig(), device=card, **wkw).run()
    for other in (WhatIfEngine(ec, ep, scen, FrameworkConfig(), device=card, plain=True,
                               **wkw).run(),
                  WhatIfEngine(ec, ep, scen, FrameworkConfig(), device="cpu", **wkw).run()):
        np.testing.assert_array_equal(wk.assignments, other.assignments)
        np.testing.assert_array_equal(wk.preemptions, other.preemptions)


def _retry_case(seed=3):
    """3 nodes, 300 pods with affinity, spread, tolerations, short durations
    and gangs arriving fast: buffers of 8 fill and overflow, pods are
    placed on retry and released through the pending list."""
    cluster = make_cluster(3, seed=seed, taint_fraction=0.2)
    workload, _ = make_workload(300, seed=seed, arrival_rate=120.0, duration_mean=3.0,
                                with_affinity=True, with_spread=True, with_tolerations=True,
                                gang_fraction=0.05, gang_size=2)
    return encode(cluster, workload)


def _chip_smoke():
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    return chip_smoke


def test_retry_kernels_equal_twins(card):
    """A whole S=4 retry what-if launch by launch: every pending release,
    retry-pass K1 / K2 / K3 (one pod per scenario), K4 and main-path bind
    with its failure append equals the twin, every plane compared."""
    from kubernetes_simulator_tpu_torch.sim.torch_runtime import new_choices
    from kubernetes_simulator_tpu_torch.sim.whatif import WhatIfEngine, uniform_scenarios

    cs = _chip_smoke()
    ec, ep = _retry_case()
    scen = uniform_scenarios(ec, 4, seed=1, p_node_down=0.5, p_capacity=0.5, p_taint=0.5)
    eng = WhatIfEngine(ec, ep, scen, FrameworkConfig(), wave_width=4, chunk_waves=3,
                       retry_buffer=8, device=card)
    tb_k = eng._tables()
    tb_t = cs.clone_tables(tb_k)
    ch_k = new_choices(eng.plan, 4, eng.pods.bound_node, card)
    ch_t = ch_k.clone()
    n = cs.lockstep("S=4 retry what-if", eng.plan, tb_k, tb_t, ch_k, ch_t, 0,
                    eng.plan.idx.shape[0], card)
    assert n["appends"] and n["overflows"] and n["retry_slots"] and n["k4"]
    assert int((tb_k.retry.rnode >= 0).sum()) > 0


def test_retry_kernel_path_equals_plain_path(card):
    """The retry replay and the S=4 retry what-if on the kernel path equal
    the plain path on the card and on the CPU: assignments, placed, drops
    and every retry record, with all four kernels launched."""
    from kubernetes_simulator_tpu_torch.sim.whatif import WhatIfEngine, uniform_scenarios

    cs = _chip_smoke()
    ec, ep = _retry_case(4)
    kw = dict(wave_width=4, chunk_waves=3, retry_buffer=8)
    K.reset_launch_counts()
    eng = TorchReplayEngine(ec, ep, FrameworkConfig(), device=card, **kw)
    kern = eng.replay()
    counts = K.launch_counts()
    assert all(counts[k] > 0 for k in PATH_KERNELS + ("retry_boundary",))
    # summary telemetry attributes nothing
    assert counts["first_reject"] == counts["first_reject_fold"] == 0
    rec = cs.retry_records(eng.last_tables)
    for o in (dict(device=card, plain=True), dict(device="cpu")):
        e = TorchReplayEngine(ec, ep, FrameworkConfig(), **kw, **o)
        other = e.replay()
        np.testing.assert_array_equal(kern.assignments, other.assignments)
        assert (kern.placed, kern.retry_dropped) == (other.placed, other.retry_dropped)
        cs.same_records("replay", rec, cs.retry_records(e.last_tables))
    assert kern.retry_dropped > 0 and (rec["rnode"] >= 0).any()
    scen = uniform_scenarios(ec, 4, seed=1, p_capacity=0.5)
    runs = []
    for o in (dict(device=card), dict(device=card, plain=True), dict(device="cpu")):
        tb, _, a, placed, _ = WhatIfEngine(ec, ep, scen, FrameworkConfig(), **kw, **o)._run()
        runs.append((a, placed, cs.retry_records(tb)))
    for a, placed, r in runs[1:]:
        np.testing.assert_array_equal(runs[0][0], a)
        np.testing.assert_array_equal(runs[0][1], placed)
        cs.same_records("what-if", runs[0][2], r)


def test_label_kernels_equal_twins(card):
    """K1 and K3 with label rows, launch by launch over a whole S=4
    what-if whose scenarios read four rows — the base, a zone move, a new
    zone and a tier flip: scratch rows, choices and state after every K1,
    K2, bind, release and rollback equal the twins'."""
    from kubernetes_simulator_tpu_torch.sim.torch_runtime import new_choices
    from kubernetes_simulator_tpu_torch.sim.whatif import Perturbation, Scenario, WhatIfEngine

    cs = _chip_smoke()
    ec, ep = _case(9, nodes=40, pods=600, duration_mean=3.0, arrival_rate=50.0,
                   gang_fraction=0.1, gang_size=3)
    zone = "topology.kubernetes.io/zone"
    scen = [Scenario(),
            Scenario([Perturbation("set_label", nodes=np.arange(0, 12), key=zone,
                                   value="zone-3")]),
            Scenario([Perturbation("set_label", nodes=np.arange(5, 20, 2), key=zone,
                                   value="zone-new")]),
            Scenario([Perturbation("set_label", nodes=np.arange(1, 30, 3), key="tier",
                                   value="hot")])]
    eng = WhatIfEngine(ec, ep, scen, FrameworkConfig(), wave_width=4, chunk_waves=8,
                       device=card)
    tb_k = eng._tables()
    assert tb_k.cluster.gdom.shape[0] == 4 and tb_k.cluster.lrow.tolist() == [0, 1, 2, 3]
    tb_t = cs.clone_tables(tb_k)
    ch_k = new_choices(eng.plan, 4, eng.pods.bound_node, card)
    ch_t = ch_k.clone()
    n = cs.lockstep("S=4 label rows", eng.plan, tb_k, tb_t, ch_k, ch_t, 0,
                    eng.plan.idx.shape[0], card)
    assert n["binds"] and n["static_release"] and n["rollbacks"]
    assert len({r.tobytes() for r in ch_k.cpu().numpy()}) == 4


def test_label_kernel_path_equals_plain_path(card):
    """The reduced relabel what-if (chip_smoke.check_reduced_relabel: 8
    scenarios x 60 nodes x 3,000 pods) on the kernel path equals the plain
    path on the card and on the CPU, with the kernels launched."""
    cs = _chip_smoke()
    K.reset_launch_counts()
    results = {}
    cs.check_reduced_relabel(results, dev=card)
    assert all(K.launch_counts()[k] > 0 for k in PATH_KERNELS)
    assert len(results["reduced_relabel"]["scenarios_moved"]) == 7


def test_first_reject_equals_twin(card):
    """K5 against its twin launch by launch in series replays: the plain
    path at S=1 (after each slot's K2) and the retry path at S=4 (each
    retry-pass slot and the chunk folds against the chunk-start planes),
    reject counters compared after every launch; then whole series replays
    on the kernel path equal the plain path on the card and on the CPU."""
    from kubernetes_simulator_tpu_torch.sim.whatif import WhatIfEngine, uniform_scenarios

    cs = _chip_smoke()
    results = {}
    ec, ep = _retry_case(4)
    eng = TorchReplayEngine(ec, ep, FrameworkConfig(), device=card, wave_width=4, chunk_waves=3,
                            telemetry="series")
    n = cs.hold_first_reject("S=1 plain", eng, 0, eng.plan.idx.shape[0], card, results)
    assert n["k5_slot"] and n["k5_charged"]
    scen = uniform_scenarios(ec, 4, seed=1, p_node_down=0.5, p_capacity=0.5, p_taint=0.5)
    w = WhatIfEngine(ec, ep, scen, FrameworkConfig(), wave_width=4, chunk_waves=3,
                     retry_buffer=8, device=card)
    n = cs.hold_first_reject("S=4 retry", w, 0, w.plan.idx.shape[0], card, results)
    assert n["k5_fold"] and n["k5_retry"] and n["k5_charged"]
    for kw in (dict(), dict(retry_buffer=8)):
        K.reset_launch_counts()
        runs = [TorchReplayEngine(ec, ep, FrameworkConfig(), wave_width=4, chunk_waves=3,
                                  telemetry="timeline", **kw, **o).replay()
                for o in (dict(device=card), dict(device=card, plain=True), dict(device="cpu"))]
        counts = K.launch_counts()
        assert counts["first_reject"] > 0
        assert (counts["first_reject_fold"] > 0) == bool(kw)  # the fold: retry path only
        for other in runs[1:]:
            np.testing.assert_array_equal(runs[0].assignments, other.assignments)
            assert cs.series_digest(runs[0].telemetry) == cs.series_digest(other.telemetry)


#: Policy rows: the default, non-integer weights under MostAllocated, a zero
#: weight, non-integer weights under LeastAllocated.
POLICY_ROWS = [[1.0, 3.0, 2.0, 2.0, 2.0, 1.0], [2.3125, 0.7, 4.1, 1.55, 3.3, 0.0],
               [1.0, 0.0, 2.0, 0.0, 5.25, 1.0], [9.99, 0.125, 0.3333, 7.77, 0.01, 1.0]]


def test_policy_kernels_equal_twins(card):
    """K1 and K2 with per-scenario policy rows (row B1w) equal their twins
    slot by slot at S=4, one row per scenario."""
    ec, ep = _case(5, nodes=48, pods=400)
    S = len(POLICY_ROWS)
    consts = StepSpec.from_config(ec, FrameworkConfig(), ep).consts(traced=True)
    cl, pods = ref.cluster_to(ec, card, S), ref.pods_to(ep, card)
    G, D = cl.gdom.shape[1], max(ec.max_domains, 1)
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=card)
    wrow = torch.tensor(POLICY_ROWS, dtype=torch.float32, device=card)
    mk = lambda: ref.Tables(cl, pods, ref.DevState(z(S, ec.num_nodes, ec.num_resources),
                                                   z(S, G, D), z(S, G, D), z(S, G, D)),
                            ref.new_scratch(S, ec.num_nodes, card), consts, wrow=wrow)
    tb_k, tb_t = mk(), mk()
    b = K.Bound(tb_k)
    ids = torch.arange(ep.num_pods, dtype=torch.int32, device=card)
    ch_k = torch.full((S, ep.num_pods), PAD, dtype=torch.int32, device=card)
    ch_t = ch_k.clone()
    for p in range(ep.num_pods):
        K.filter_score(b, p)
        ref.filter_score(tb_t, p)
        K.normalize_select(b, p, ch_k, p)
        ref.normalize_select(tb_t, p, ch_t, p)
        K.apply_placements(b, ids[p : p + 1], ids[p : p + 1], ch_k, 1.0)
        ref.apply_placements(tb_t, ids[p : p + 1], ids[p : p + 1], ch_t, 1.0)
        torch.cuda.synchronize()
        for f in ref.Scratch._fields:
            assert torch.equal(getattr(tb_k.scratch, f), getattr(tb_t.scratch, f)), (p, f)
        assert torch.equal(ch_k[:, p], ch_t[:, p]), p
    # The MostAllocated row (1) and the non-integer row (3) place apart from
    # every other row; rows 0 and 2 place alike on this 48-node trace.
    c = ch_k.cpu().numpy()
    for i, j in ((1, 0), (1, 2), (1, 3), (3, 0), (3, 2)):
        assert (c[i] != c[j]).any(), (i, j)


def test_policy_whatif_kernel_path_equals_plain_path(card):
    """A policy what-if with completions on the kernel path equals the
    plain path on the card and the CPU, before and after set_policies,
    with one set-up."""
    from kubernetes_simulator_tpu_torch.sim.whatif import WhatIfEngine, uniform_scenarios

    ec, ep = _case(8, nodes=40, pods=600, duration_mean=3.0, arrival_rate=50.0,
                   gang_fraction=0.1, gang_size=3)
    scen = uniform_scenarios(ec, 4, seed=1, p_node_down=0.5, p_taint=0.5)
    pol = np.asarray(POLICY_ROWS, np.float32)
    kw = dict(wave_width=4, chunk_waves=8, collect_assignments=True)
    eng = WhatIfEngine(ec, ep, scen, FrameworkConfig(), device=card, policies=pol, **kw)
    for rows in (pol, pol[::-1].copy()):
        eng.set_policies(rows)
        K.reset_launch_counts()
        kern = eng.run()
        assert all(K.launch_counts()[k] > 0 for k in PATH_KERNELS)
        for o in (dict(device=card, plain=True), dict(device="cpu")):
            other = WhatIfEngine(ec, ep, scen, FrameworkConfig(), policies=rows, **kw, **o).run()
            np.testing.assert_array_equal(kern.assignments, other.assignments)
    assert eng.setups == 1
