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

#: The kernels every path with completions launches on the chunk route, the
#: main path (the retry buffer adds K1, K2 in its retry pass and
#: retry_boundary).
PATH_KERNELS = ("apply_placements", "chunk_replay")
#: The kernels of the per-slot route.
SLOT_KERNELS = ("filter_score", "normalize_select", "apply_placements")


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
    assert all(K.launch_counts()[k] > 0 for k in PATH_KERNELS) and kern.route == "chunk"
    plain = TorchReplayEngine(ec, ep, FrameworkConfig(), device=card, plain=True, **kw).replay()
    cpu = TorchReplayEngine(ec, ep, FrameworkConfig(), device="cpu", **kw).replay()
    np.testing.assert_array_equal(kern.assignments, plain.assignments)
    np.testing.assert_array_equal(kern.assignments, cpu.assignments)
    np.testing.assert_array_equal(kern.state.used, cpu.state.used)
    K.reset_launch_counts()
    slot = TorchReplayEngine(ec, ep, FrameworkConfig(), device=card, **kw)
    _, _, a_slot, _, _ = slot._run(route="slot")
    assert all(K.launch_counts()[k] > 0 for k in SLOT_KERNELS)
    assert K.launch_counts()["chunk_replay"] == 0
    np.testing.assert_array_equal(kern.assignments, a_slot[0])


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
    assert all(counts[k] > 0 for k in PATH_KERNELS + SLOT_KERNELS + ("retry_boundary",))
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
    # The check runs the chunk route (K6, its route asserted) and then the
    # per-slot route with the counters zeroed just before it.
    assert all(K.launch_counts()[k] > 0 for k in SLOT_KERNELS)
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
        # the plain path attributes inside K6 (its attributed mode); the retry
        # path's pass and folds launch K5
        assert (counts["first_reject"] > 0) == bool(kw)
        assert (K.chunk_replay.attributed == counts["chunk_replay"] > 0) == (not kw)
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


def _chunk_cases():
    """(name, engine factory) of the chunk route's modes at small sizes:
    the plain path with completions and gangs (S=1 and S=4), label rows,
    policy rows, tier preemption, the retry buffer's main-path binds and
    engine="v2"."""
    from kubernetes_simulator_tpu_torch.sim.whatif import (Perturbation, Scenario, WhatIfEngine,
                                                           uniform_scenarios)

    ec, ep = _case(8, nodes=40, pods=600, duration_mean=3.0, arrival_rate=50.0,
                   gang_fraction=0.1, gang_size=3)
    scen = uniform_scenarios(ec, 4, seed=1, p_node_down=0.5, p_taint=0.5)
    zone = "topology.kubernetes.io/zone"
    relabel = [Scenario(), Scenario([Perturbation("set_label", nodes=np.arange(0, 12), key=zone,
                                                  value="zone-new")])]
    pec, pep = _contended_preempt_case()
    rec, rep = _retry_case(4)
    kw = dict(wave_width=4, chunk_waves=8)
    return [
        ("replay", lambda dev: TorchReplayEngine(ec, ep, FrameworkConfig(), device=dev, **kw)),
        ("what-if", lambda dev: WhatIfEngine(ec, ep, scen, FrameworkConfig(), device=dev, **kw)),
        ("labels", lambda dev: WhatIfEngine(ec, ep, relabel, FrameworkConfig(), device=dev, **kw)),
        ("policies", lambda dev: WhatIfEngine(ec, ep, scen, FrameworkConfig(), device=dev,
                                              policies=np.asarray(POLICY_ROWS, np.float32),
                                              **kw)),
        ("tier", lambda dev: WhatIfEngine(pec, pep, uniform_scenarios(pec, 4, seed=1,
                                                                      p_capacity=0.5),
                                          FrameworkConfig(), chunk_waves=4, preemption=True,
                                          device=dev)),
        ("retry", lambda dev: WhatIfEngine(rec, rep, scen[:1] * 4, FrameworkConfig(),
                                           wave_width=4, chunk_waves=3, retry_buffer=8,
                                           device=dev)),
        ("v2", lambda dev: TorchReplayEngine(ec, ep, FrameworkConfig(), device=dev, engine="v2",
                                             **kw)),
    ]


@pytest.mark.parametrize("case", range(7))
def test_chunk_replay_equals_slot_route_and_twin(card, case):
    """K6 against the per-slot route and its twin: a whole run of each mode
    on the chunk route (one K6 launch a chunk, K1 and K2 never launched
    outside the retry pass) equals the same engine on the per-slot route on
    the card, and the twin ref.chunk_replay, chunk by chunk: the choice
    buffer and every state plane after each chunk."""
    from kubernetes_simulator_tpu_torch.sim.torch_runtime import new_choices, run_waves

    name, make = _chunk_cases()[case]
    eng = make(card)
    K.reset_launch_counts()
    tb_c, _, a_chunk, placed, _ = eng._run(route="chunk")
    counts = K.launch_counts()
    assert eng.last_route == "chunk" and counts["chunk_replay"] == len(eng.plan.buckets), counts
    if eng.retry_buffer == 0:
        assert counts["filter_score"] == counts["normalize_select"] == 0, counts
    tb_s, _, a_slot, placed_s, _ = eng._run(route="slot")
    np.testing.assert_array_equal(a_chunk, a_slot)
    np.testing.assert_array_equal(placed, placed_s)
    plan = eng.plan
    tb_k, tb_t = eng._tables(), eng._tables()
    S = tb_k.state.used.shape[0]
    ch_k = new_choices(plan, S, eng.pods.bound_node, card)
    ch_t = ch_k.clone()
    for c in range(len(plan.buckets)):
        lo, hi = c * plan.C, (c + 1) * plan.C
        run_waves(plan, tb_k, ch_k, lo, hi, plain=False, route="chunk")
        run_waves(plan, tb_t, ch_t, lo, hi, plain=True, route="chunk")
        torch.cuda.synchronize()
        assert torch.equal(ch_k, ch_t), (name, c)
        for f in ref.DevState._fields:
            assert torch.equal(getattr(tb_k.state, f), getattr(tb_t.state, f)), (name, c, f)
    for f in ref.DevState._fields:
        assert torch.equal(getattr(tb_k.state, f), getattr(tb_c.state, f)), (name, f)


def _shard_engine(dev, P, paged=False, plain=False, seed=7):
    ec, ep = _case(seed, nodes=37, pods=500, gang_fraction=0.1, gang_size=4, duration_mean=40.0)
    return TorchReplayEngine(ec, ep, FrameworkConfig(), chunk_waves=4, device=dev,
                             node_shards=P, paged=paged, plain=plain)


@pytest.mark.parametrize("P", (2, 3, 8, 12, 20))
def test_shard_kernels_equal_twins(card, P):
    """K1 on the sharded tables, K7 and K8 against their twins launch by
    launch over a whole sharded replay (37 nodes: P = 3 and 8 pad the node
    axis): the scratch rows after K1, each shard's packed extrema, the
    choice and the column's domain ids after K7, every state plane after each K8
    bind, gang rollback and release."""
    from kubernetes_simulator_tpu_torch.sim.torch_runtime import new_choices

    eng = _shard_engine(card, P)
    plan = eng.plan
    tb_k, tb_t = eng._tables(), eng._tables()
    b = K.Bound(tb_k)
    ch_k = new_choices(plan, 1, eng.pods.bound_node, card)
    ch_t = ch_k.clone()
    idx = torch.as_tensor(plan.idx.reshape(-1), device=card)
    pos = torch.arange(plan.L, dtype=torch.int32, device=card)
    W, C = plan.idx.shape[1], plan.C
    K.reset_launch_counts()

    def same_state(where):
        torch.cuda.synchronize()
        for f in ref.DevState._fields:
            assert torch.equal(getattr(tb_k.state, f), getattr(tb_t.state, f)), (where, f)
        assert torch.equal(ch_k, ch_t), where
        assert torch.equal(tb_k.shards.cdom, tb_t.shards.cdom), where

    rollbacks = releases = 0
    for w, row in enumerate(plan.idx.tolist()):
        if w % C == 0 and plan.buckets[w // C] is not None:
            ids, cols = (torch.as_tensor(a, device=card) for a in plan.buckets[w // C])
            K.shard_apply(b, ids, cols, ch_k, -1.0)
            ref.shard_apply(tb_t, ids, cols, ch_t, -1.0)
            same_state(("release", w))
            releases += 1
        for k, p in enumerate(row):
            if p < 0:
                continue
            s = w * W + k
            K.filter_score(b, p)
            ref.filter_score(tb_t, p)
            torch.cuda.synchronize()
            for f in ref.Scratch._fields:
                assert torch.equal(getattr(tb_k.scratch, f), getattr(tb_t.scratch, f)), (s, f)
            K.shard_select(b, p, ch_k, s)
            ref.shard_select(tb_t, p, ch_t, s)
            torch.cuda.synchronize()
            assert torch.equal(tb_k.shards.ext, tb_t.shards.ext), s
            K.shard_apply(b, idx[s : s + 1], pos[s : s + 1], ch_k, 1.0)
            ref.shard_apply(tb_t, idx[s : s + 1], pos[s : s + 1], ch_t, 1.0)
            same_state(("bind", s))
        if plan.gang_wave[w]:
            sl = slice(w * W, (w + 1) * W)
            K.shard_apply(b, idx[sl], pos[sl], ch_k, -1.0, rollback=True)
            ref.shard_apply(tb_t, idx[sl], pos[sl], ch_t, -1.0, rollback=True)
            same_state(("rollback", w))
            rollbacks += 1
    slots = int((plan.idx >= 0).sum())
    counts = K.launch_counts()
    assert counts["filter_score"] == counts["shard_select"] == slots, counts
    assert counts["shard_apply"] == slots + rollbacks + releases, counts
    assert (counts["shard_apply_bind"], counts["shard_apply_rollback"],
            counts["shard_apply_release"]) == (slots, rollbacks, releases), counts
    assert rollbacks and releases and int((ch_k[0, : plan.idx.size] < 0).sum()) > 0


@pytest.mark.parametrize("P,paged", [(3, False), (8, False), (3, True), (8, True), (1, True)])
def test_shard_kernel_path_equals_plain_path(card, P, paged):
    """A sharded (or, P = 1, paged replicated) replay on the kernels equals
    the same replay on the twins on the card and on the CPU, and the
    replicated K6 replay: assignments, placed and ``used``; the sharded run
    launches one K9 a chunk, K8 at each release and nothing of K1, K2, K3,
    K6 or K7."""
    rep = _shard_engine(card, 1).replay()
    K.reset_launch_counts()
    eng = _shard_engine(card, P, paged=paged)
    res = eng.replay()
    counts = K.launch_counts()
    if P > 1:
        releases = sum(bk is not None for bk in eng.plan.buckets)
        assert res.route == "shard", res.route
        assert counts["shard_chunk_replay"] == len(eng.plan.buckets), counts
        assert counts["shard_apply"] == counts["shard_apply_release"] == releases, counts
        for k in ("filter_score", "shard_select", "normalize_select", "chunk_replay",
                  "apply_placements"):
            assert counts[k] == 0, (k, counts)
    else:
        assert res.route == "chunk" and counts["chunk_replay"] == len(eng.plan.buckets)
    if paged:
        assert eng.last_pager is not None and eng.last_pager.prefetches > 0
    for other in (rep, _shard_engine(card, P, paged=paged, plain=True).replay(),
                  _shard_engine("cpu", P, paged=paged).replay()):
        np.testing.assert_array_equal(res.assignments, other.assignments)
        assert res.placed == other.placed
        np.testing.assert_array_equal(res.state.used, other.state.used)


@pytest.mark.parametrize("P", (3, 8))
def test_shard_chunk_replay_equals_twin_and_slot_route(card, P):
    """K9 against its twin and against the per-slot kernels (K1 -> K7 -> K8)
    over a whole sharded replay (37 nodes: P = 3 and 8 pad the node axis),
    chunk by chunk from the same state after each boundary's K8 release:
    every state plane, the scratch rows, the choice buffer and the shard
    buffers (ext, best_v, best_i, cdom) bit for bit, with K9's plan K7's C
    in blocks of 1,024 threads."""
    from kubernetes_simulator_tpu_torch.sim.torch_runtime import new_choices

    eng = _shard_engine(card, P)
    plan = eng.plan
    tb_9, tb_t, tb_s = eng._tables(), eng._tables(), eng._tables()
    b9, bs = K.Bound(tb_9), K.Bound(tb_s)
    ch_9 = new_choices(plan, 1, eng.pods.bound_node, card)
    ch_t, ch_s = ch_9.clone(), ch_9.clone()
    idx = torch.as_tensor(plan.idx.reshape(-1), device=card)
    gang = torch.as_tensor(plan.gang_wave.astype(np.uint8), device=card)
    pos = torch.arange(plan.L, dtype=torch.int32, device=card)
    W, C = plan.idx.shape[1], plan.C
    K.reset_launch_counts()
    for c in range(len(plan.buckets)):
        if plan.buckets[c] is not None:
            ids, cols = (torch.as_tensor(a, device=card) for a in plan.buckets[c])
            K.shard_apply(b9, ids, cols, ch_9, -1.0)
            ref.shard_apply(tb_t, ids, cols, ch_t, -1.0)
            K.shard_apply(bs, ids, cols, ch_s, -1.0)
        K.shard_chunk_replay(b9, idx, gang, ch_9, c * C, (c + 1) * C)
        ref.shard_chunk_replay(tb_t, idx, gang, ch_t, c * C, (c + 1) * C)
        for w in range(c * C, (c + 1) * C):
            for k, p in enumerate(plan.idx[w].tolist()):
                if p < 0:
                    continue
                s = w * W + k
                K.filter_score(bs, p)
                K.shard_select(bs, p, ch_s, s)
                K.shard_apply(bs, idx[s : s + 1], pos[s : s + 1], ch_s, 1.0)
            if plan.gang_wave[w]:
                sl = slice(w * W, (w + 1) * W)
                K.shard_apply(bs, idx[sl], pos[sl], ch_s, -1.0, rollback=True)
        torch.cuda.synchronize()
        for tb, ch, name in ((tb_t, ch_t, "twin"), (tb_s, ch_s, "per-slot kernels")):
            for part in ("state", "scratch", "shards"):
                x, y = getattr(tb_9, part), getattr(tb, part)
                for f, a in zip(x._fields, x):
                    if torch.is_tensor(a):
                        assert torch.equal(a, getattr(y, f)), (name, c, part, f)
            assert torch.equal(ch_9, ch), (name, c)
    counts = K.launch_counts()
    assert counts["shard_chunk_replay"] == len(plan.buckets), counts
    cp = K.shard_chunk_replay.plan
    assert cp.threads == K.SELECT_THREADS and cp.C == b9.plan("shard_select").C, cp
    assert int(plan.gang_wave.sum()) and int((ch_9[0, : plan.idx.size] < 0).sum()) > 0


# ---------------------------------------------------------------------------
# The cluster selects (K2, K6's K2 phase, K7) at node counts where a scenario
# spans several blocks (ops/kernels.py cluster_plan), bit for bit.
# ---------------------------------------------------------------------------

_CLUSTER_CASES = {}


def _cluster_case(nodes, pods=48):
    """A cluster of ``nodes`` nodes and a short workload, encoded once."""
    if nodes not in _CLUSTER_CASES:
        _CLUSTER_CASES[nodes] = _case(11, nodes=nodes, pods=pods, gang_fraction=0.1,
                                      gang_size=3)
    return _CLUSTER_CASES[nodes]


def _select_tables(card, S, N, preempt=False):
    """Tables of S scenarios over N nodes for K2 alone: the encoded case's
    cluster and pods, zero state, the scratch rows to be filled by the test;
    under ``preempt`` every non-gang pod of tier 1 (and a 64-column choice
    buffer's bookkeeping)."""
    ec, ep = _cluster_case(N)
    consts = StepSpec.from_config(ec, FrameworkConfig(), ep).consts()
    cl = ref.cluster_to(ec, card, S)
    G, D = cl.gdom.shape[1], max(ec.max_domains, 1)
    z = lambda *sh: torch.zeros(sh, dtype=torch.float32, device=card)
    st = ref.DevState(z(S, N, ec.num_resources), z(S, G, D), z(S, G, D), z(S, G, D))
    pre = None
    if preempt:
        P, L, Tt = ep.num_pods, 64, 2
        pre = ref.new_preempt(np.ones(P, np.int32), ep.group_id, np.full(L, PAD, np.int32),
                              np.zeros(L, np.int32), L, np.zeros((Tt, N, ec.num_resources)),
                              np.zeros((Tt, N)), S, card)
    return ref.Tables(cl, ref.pods_to(ep, card), st,
                      ref.new_scratch(S, N, card), consts, preempt=pre)


def _fill_scratch(tb, rng, case, span):
    """Scratch rows of one case: small integer raws (many equal totals);
    ``straddle``: only the fit row varies, its best value on both sides of
    every block boundary (and at the last node), nothing feasible before
    rank 0's last node; ``pad``: nothing feasible."""
    x = tb.scratch
    S, R, N = x.scores.shape
    rows = rng.integers(0, 4, size=(S, R, N)).astype(np.float32)
    feas = rng.random((S, N)) < 0.7
    ign = rng.random((S, N)) < 0.1
    if case == "straddle":
        rows[:] = 0.0
        rows[:, ref.ROW_FIT] = rng.integers(0, 3, size=(S, N))
        top = [n for b in range(span, N, span) for n in (b - 1, b)] + [N - 1]
        rows[:, ref.ROW_FIT, top] = 50.0
        feas[:, : span - 1] = False
        feas[:, top] = True
        ign[:] = False
    if case == "pad":
        feas[:] = False
    x.scores.copy_(torch.as_tensor(rows))
    x.feasible.copy_(torch.as_tensor(feas))
    x.ignored.copy_(torch.as_tensor(ign))


def _clone_tables(tb):
    cp = lambda nt: type(nt)(*(t.clone() if torch.is_tensor(t) else t for t in nt))
    return tb._replace(scratch=cp(tb.scratch),
                       preempt=cp(tb.preempt) if tb.preempt is not None else None)


@pytest.mark.parametrize("S,N", [(1, 5000), (1, 10000), (4, 5000), (128, 2000)])
@pytest.mark.parametrize("case", ["random", "straddle", "pad"])
def test_cluster_normalize_select_equals_twin(card, S, N, case):
    """K2 as a cluster select (N not a multiple of C x 1,024) against its
    twin, pod after pod: random rows full of equal totals, the best total
    on both sides of every block boundary (the lowest index must win across
    blocks), and nothing feasible (PAD)."""
    tb_k = _select_tables(card, S, N)
    b = K.Bound(tb_k)
    plan = b.plan("normalize_select")
    assert plan.grid == S * plan.C and plan.C * plan.span >= N
    if S == 1:
        assert plan.C > 1 and N % (plan.C * 1024), plan
    rng = np.random.default_rng(S * 7 + N)
    ch_k = torch.full((S, 8), PAD, dtype=torch.int32, device=card)
    ch_t = ch_k.clone()
    pods = rng.choice(tb_k.pods.group_id.shape[0], size=8, replace=False)
    for i, p in enumerate(pods.tolist()):
        _fill_scratch(tb_k, rng, case, plan.span)
        K.normalize_select(b, p, ch_k, i)
        ref.normalize_select(tb_k, p, ch_t, i)
        torch.cuda.synchronize()
        assert torch.equal(ch_k[:, i], ch_t[:, i]), (case, p, ch_k[:, i], ch_t[:, i])
    assert K.normalize_select.plan == plan
    if case == "pad":
        assert bool((ch_k == PAD).all())
    else:
        assert bool((ch_k >= 0).all())
    if case == "straddle" and plan.C > 1:
        assert bool((ch_k == plan.span - 1).all())


def test_cluster_normalize_select_retry_pass(card):
    """K2's retry pass (one pod a scenario, an empty slot PAD) as a cluster
    select at S = 4, N = 5,000."""
    S, N = 4, 5000
    tb = _select_tables(card, S, N)
    b = K.Bound(tb)
    assert b.plan("normalize_select").C > 1
    rng = np.random.default_rng(3)
    ch_k = torch.full((S, 4), PAD, dtype=torch.int32, device=card)
    ch_t = ch_k.clone()
    P = tb.pods.group_id.shape[0]
    for i in range(4):
        _fill_scratch(tb, rng, "random", b.plan("normalize_select").span)
        pod_of_s = torch.as_tensor(rng.integers(0, P, size=S).astype(np.int32), device=card)
        pod_of_s[i] = PAD
        K.normalize_select(b, PAD, ch_k, i, -1, pod_of_s)
        ref.normalize_select(tb, PAD, ch_t, i, -1, pod_of_s)
        torch.cuda.synchronize()
        assert torch.equal(ch_k[:, i], ch_t[:, i]), (i, ch_k[:, i], ch_t[:, i])
        assert int(ch_k[i, i]) == PAD


def test_cluster_preempt_argmin(card):
    """K2's masked argmin as a cluster select at S = 1, N = 5,000: nothing
    feasible, candidate ranks tied on both sides of a block boundary; the
    argmin fires once a wave (choice, eviction record, wave stamp), and a
    second pod of the same wave writes PAD and no record."""
    N = 5000
    tb_k = _select_tables(card, 1, N, preempt=True)
    b = K.Bound(tb_k)
    plan = b.plan("normalize_select")
    assert plan.C > 1
    tb_t = _clone_tables(tb_k)
    rng = np.random.default_rng(5)
    gid = tb_k.pods.group_id.cpu().numpy()
    p0, p1 = np.nonzero(gid < 0)[0][:2].tolist()
    cand = np.full(N, np.inf, np.float32)
    on = rng.random(N) < 0.3
    cand[on] = rng.integers(1, 5, size=int(on.sum())) * 1024.0
    b0 = plan.span
    cand[[b0 - 1, b0, N - 1]] = 1024.0 - 1.0  # the lowest rank, at a boundary
    cand[: b0 - 1] = np.where(cand[: b0 - 1] < 1024.0, np.inf, cand[: b0 - 1])
    ch_k = torch.full((1, 64), PAD, dtype=torch.int32, device=card)
    ch_t = ch_k.clone()
    for tb in (tb_k, tb_t):
        tb.scratch.feasible.zero_()
        tb.preempt.cand.copy_(torch.as_tensor(cand)[None])
    for slot, p in enumerate((p0, p1)):
        K.normalize_select(b, p, ch_k, slot, 3)
        ref.normalize_select(tb_t, p, ch_t, slot, 3)
        torch.cuda.synchronize()
        assert torch.equal(ch_k, ch_t), (slot, ch_k[0, :2], ch_t[0, :2])
        for f in ("last_wave", "ev_node", "ev_tier"):
            assert torch.equal(getattr(tb_k.preempt, f), getattr(tb_t.preempt, f)), (slot, f)
    assert int(ch_k[0, 0]) == b0 - 1 and int(ch_k[0, 1]) == PAD
    assert int(tb_k.preempt.ev_node[0]) == PAD and int(tb_k.preempt.last_wave[0]) == 3


@pytest.mark.parametrize("nodes", [5000, 9001, 10000])
def test_cluster_chunk_replay_s1(card, nodes):
    """K6 at S = 1 on a cluster (config2's and config4's node counts, and
    9,001: ranks of 1,152 nodes, the last one 937): the chunk route equals
    the per-slot route and the twins on the card (assignments and
    ``used``)."""
    ec, ep = _case(13, nodes=nodes, pods=700, gang_fraction=0.1, gang_size=3,
                   duration_mean=5.0, arrival_rate=40.0)
    kw = dict(wave_width=8, chunk_waves=16)
    K.reset_launch_counts()
    eng = TorchReplayEngine(ec, ep, FrameworkConfig(), device=card, **kw)
    res = eng.replay()
    assert res.route == "chunk" and K.launch_counts()["chunk_replay"] == len(eng.plan.buckets)
    plan = K.chunk_replay.plan
    assert plan.C > 1 and plan.grid == plan.C and plan.threads == K.SELECT_THREADS, plan
    if nodes > 5000:  # phase 1 tiles a rank's nodes; the last rank is short
        assert plan.span > K.SELECT_THREADS and nodes % plan.span, plan
    _, _, a_slot, _, _ = eng._run(route="slot")
    np.testing.assert_array_equal(res.assignments, a_slot[0])
    plain = TorchReplayEngine(ec, ep, FrameworkConfig(), device=card, plain=True, **kw).replay()
    np.testing.assert_array_equal(res.assignments, plain.assignments)
    np.testing.assert_array_equal(res.state.used, plain.state.used)


@pytest.mark.parametrize("C", [1, 2, 4])
def test_chunk_replay_attributed_equals_twin_and_slot_kernels(card, C):
    """K6's attributed mode (series on the plain path) at S = 1 with C ranks
    a cluster over 200 nodes, chunk by chunk from the initial state of a
    contended trace without completions (7 pods fail): the choice buffer,
    every state plane and the reject counters equal the twin
    ref.chunk_replay(reject=) and the per-slot kernels K1 -> K2 -> K5 -> K3
    (with K3's rollback after a gang wave) after each chunk; K6's launches
    count as attributed. Then the series replay on the chunk route (one
    attributed K6 a chunk, no K1, K2 or K5 launched) equals the per-slot
    route's."""
    from kubernetes_simulator_tpu_torch.sim.torch_runtime import new_choices

    ec, ep = _case(21, nodes=200, pods=1500, gang_fraction=0.1, gang_size=3)
    eng = TorchReplayEngine(ec, ep, FrameworkConfig(), device=card, wave_width=8,
                            chunk_waves=16, telemetry="series")
    plan = eng.plan
    desc = plan.device_desc(card)
    W = plan.idx.shape[1]
    tbs = [eng._tables(attribute=True) for _ in range(3)]
    chs = [new_choices(plan, 1, eng.pods.bound_node, card) for _ in range(3)]
    b_k, b_s = K.Bound(tbs[0]), K.Bound(tbs[2])
    assert _chip_smoke().force_k6_ranks(b_k, C) == C
    pos = torch.arange(plan.L, dtype=torch.int32, device=card)
    K.reset_launch_counts()
    for c in range(len(plan.buckets)):
        lo, hi = c * plan.C, (c + 1) * plan.C
        K.chunk_replay(b_k, desc.idx, desc.gang, chs[0], lo, hi, reject=tbs[0].reject)
        ref.chunk_replay(tbs[1], desc.idx, desc.gang, chs[1], lo, hi, reject=tbs[1].reject)
        for w in range(lo, hi):
            for k, p in enumerate(plan.idx[w].tolist()):
                if p < 0:
                    continue
                s = w * W + k
                K.filter_score(b_s, p)
                K.normalize_select(b_s, p, chs[2], s, w)
                K.first_reject(b_s, desc.idx[s : s + 1], chs[2][:, s : s + 1])
                K.apply_placements(b_s, desc.idx[s : s + 1], pos[s : s + 1], chs[2], 1.0)
            if plan.gang_wave[w]:
                K.apply_placements(b_s, desc.idx[w * W : (w + 1) * W], pos[w * W : (w + 1) * W],
                                   chs[2], -1.0, rollback=True)
        torch.cuda.synchronize()
        for i in (1, 2):
            assert torch.equal(chs[0], chs[i]), (C, c, i)
            for part in ("state", "reject"):
                for f, x, y in zip(getattr(tbs[0], part)._fields, getattr(tbs[0], part),
                                   getattr(tbs[i], part)):
                    assert torch.equal(x, y), (C, c, i, part, f)
    assert K.chunk_replay.plan.C == C
    assert K.chunk_replay.launches == K.chunk_replay.attributed == len(plan.buckets)
    assert int(tbs[0].reject.attempts.sum()) > 0
    K.reset_launch_counts()
    res = eng.replay()
    counts = K.launch_counts()
    assert res.route == "chunk" and K.chunk_replay.attributed == len(plan.buckets), counts
    assert counts["filter_score"] == counts["normalize_select"] == counts["first_reject"] == 0
    assert res.telemetry.reasons == res.telemetry.rejection_attempts != {}
    rj = eng.last_tables.reject
    tb_slot, _, a_slot, _, _ = eng._run(series=True, route="slot")
    assert K.launch_counts()["first_reject"] > 0
    np.testing.assert_array_equal(res.assignments, a_slot[0])
    for f, x, y in zip(rj._fields, rj, tb_slot.reject):
        assert torch.equal(x, y), f


def test_chunk_replay_beyond_the_card(card):
    """K6 at more scenarios than the card holds at once (300 clusters of
    one 1,024-thread block): the first 8 waves on K6 equal the per-slot
    route and the twin (choices and every state plane)."""
    from kubernetes_simulator_tpu_torch.sim.torch_runtime import new_choices, run_waves
    from kubernetes_simulator_tpu_torch.sim.whatif import WhatIfEngine, uniform_scenarios

    ec, ep = _case(21, nodes=2000, pods=400, gang_fraction=0.1, gang_size=3)
    S = 300
    eng = WhatIfEngine(ec, ep, uniform_scenarios(ec, S, seed=0), FrameworkConfig(),
                       wave_width=8, chunk_waves=8, device=card)
    plan = eng.plan
    runs = {}
    for route, plain in (("chunk", False), ("slot", False), ("twin", True)):
        tb = eng._tables()
        ch = new_choices(plan, S, eng.pods.bound_node, card)
        run_waves(plan, tb, ch, 0, plan.C, plain=plain, route="slot" if route == "slot" else
                  "chunk")
        runs[route] = (tb, ch)
        if route == "chunk":
            grid = K.chunk_replay.plan.grid
            assert grid == S > torch.cuda.get_device_properties(card).multi_processor_count
    torch.cuda.synchronize()
    tb_k, ch_k = runs["chunk"]
    for route in ("slot", "twin"):
        tb, ch = runs[route]
        assert torch.equal(ch_k, ch), route
        for f in ref.DevState._fields:
            assert torch.equal(getattr(tb_k.state, f), getattr(tb.state, f)), (route, f)


@pytest.mark.parametrize("kind,pairs", [("borg", 4000), ("tier", 4000), ("labels", 4000),
                                        ("pending", 4000), ("borg", 5000), ("tier", 5000),
                                        ("pending", 4096), ("borg", 3)])
def test_release_equals_pair_order(card, kind, pairs):
    """K3's release (each tile of pairs sorted by node, each node summed in
    pair order) on the Borg cut's 12 nodes x 5,000 tasks, some 300 pairs a
    node, plain, with tier planes, with a label row a scenario and as the
    retry buffer's pending release (its largest buffer, 4,096), across
    tiles of 1,024 pairs (each node's pairs in every tile; 5,000 pairs: a
    short last tile) and in one tile of 4 (3 pairs): every plane equal to
    the twin's and ``used`` to ``_add_in_pair_order``'s sums, bit for bit
    (chip_smoke.py's hold_release)."""
    from kubernetes_simulator_tpu_torch.sim.borg import BorgSpec, make_borg_encoded

    cs = _chip_smoke()
    ec, ep, _ = make_borg_encoded(BorgSpec(nodes=12, tasks=5000, seed=cs.SEED))
    rec = cs.hold_release(f"release ({kind}, {pairs})", ep,
                          cs.release_case(kind, ec, ep, card, n_pairs=pairs), timed=False)
    assert not rec["dyadic_requests"] or pairs < 100, rec
    if pairs >= 1000:
        assert rec["max_pairs_a_node"] >= 100, rec


@pytest.mark.parametrize("P", (3, 8, 12, 20))
def test_cluster_shard_select_equals_twin(card, P):
    """K7 as a cluster per scenario over 5,000 nodes (C = min(P, 8); at 12
    and 20 shards a block owns several), after K1, slot after slot of a
    sharded replay's first waves: each shard's packed extrema and pair,
    the choice and the column's domain ids equal the twin's."""
    from kubernetes_simulator_tpu_torch.sim.torch_runtime import new_choices

    ec, ep = _case(17, nodes=5000, pods=300, gang_fraction=0.1, gang_size=4)
    eng = TorchReplayEngine(ec, ep, FrameworkConfig(), chunk_waves=4, device=card,
                            node_shards=P)
    plan = eng.plan
    tb_k, tb_t = eng._tables(), eng._tables()
    b = K.Bound(tb_k)
    cp = b.plan("shard_select")
    assert cp.C == min(P, K.CLUSTER_CAP) and cp.NP == P, cp
    ch_k = new_choices(plan, 1, eng.pods.bound_node, card)
    ch_t = ch_k.clone()
    idx = torch.as_tensor(plan.idx.reshape(-1), device=card)
    pos = torch.arange(plan.L, dtype=torch.int32, device=card)
    W = plan.idx.shape[1]
    sh_k, sh_t = tb_k.shards, tb_t.shards
    for w, row in enumerate(plan.idx[:12].tolist()):
        for k, p in enumerate(row):
            if p < 0:
                continue
            s = w * W + k
            K.filter_score(b, p)
            ref.filter_score(tb_t, p)
            K.shard_select(b, p, ch_k, s)
            ref.shard_select(tb_t, p, ch_t, s)
            torch.cuda.synchronize()
            for f in ("ext", "best_v", "best_i", "cdom"):
                assert torch.equal(getattr(sh_k, f), getattr(sh_t, f)), (s, f)
            assert torch.equal(ch_k, ch_t), s
            K.shard_apply(b, idx[s : s + 1], pos[s : s + 1], ch_k, 1.0)
            ref.shard_apply(tb_t, idx[s : s + 1], pos[s : s + 1], ch_t, 1.0)
    assert int((ch_k[0, : 12 * W] >= 0).sum()) > 0
