"""The chunk route on the CPU: the device descriptor of a chunk plan and
the plain twin of K6, ``ops.reference.chunk_replay``, held against the
per-slot route of ``run_waves(plain=True)`` — the choice buffer and every
state plane (with the tier and retry tables where the mode has them) equal
after every chunk — on the modes K6 takes: the headline's generators cut,
the what-if with completions and gangs, label rows, policy rows, tier
preemption and the retry buffer's main-path binds. Exact comparisons."""

import numpy as np
import pytest
import torch

from kubernetes_simulator_tpu_torch.framework.framework import FrameworkConfig
from kubernetes_simulator_tpu_torch.models.encode import PAD, encode
from kubernetes_simulator_tpu_torch.ops import kernels as K
from kubernetes_simulator_tpu_torch.ops import reference as ref
from kubernetes_simulator_tpu_torch.sim.synthetic import make_cluster, make_workload
from kubernetes_simulator_tpu_torch.sim.torch_runtime import (
    ROUTES,
    TorchReplayEngine,
    choose_route,
    new_choices,
    run_waves,
)
from kubernetes_simulator_tpu_torch.sim.whatif import (
    Perturbation,
    Scenario,
    WhatIfEngine,
    uniform_scenarios,
)


def _headline_cut(nodes=40, pods=700, seed=0, **kw):
    """The headline's generators (affinity, spread, tolerations, gangs of
    4, durationMean 50) cut small; ``kw`` overrides the workload."""
    wkw = dict(with_affinity=True, with_spread=True, with_tolerations=True, duration_mean=50.0,
               gang_fraction=0.02, gang_size=4)
    wkw.update(kw)
    cluster = make_cluster(nodes, seed=seed, taint_fraction=0.1)
    workload, _ = make_workload(pods, seed=seed, **wkw)
    return encode(cluster, workload)


def _engine(case):
    ec, ep = _headline_cut()
    ec2, ep2 = _headline_cut(nodes=30, pods=600, seed=3, duration_mean=4.0, arrival_rate=40.0,
                             gang_fraction=0.1, gang_size=3)
    zone = "topology.kubernetes.io/zone"
    if case == "replay":
        return TorchReplayEngine(ec, ep, FrameworkConfig(), chunk_waves=8, device="cpu")
    if case == "whatif":
        scen = uniform_scenarios(ec2, 4, seed=1, p_node_down=0.5, p_taint=0.5)
        return WhatIfEngine(ec2, ep2, scen, FrameworkConfig(), wave_width=4, chunk_waves=6,
                            device="cpu")
    if case == "labels":
        ec2, ep2 = _headline_cut(nodes=30, pods=200, seed=3, duration_mean=4.0,
                                 arrival_rate=40.0, gang_fraction=0.1, gang_size=3)
        scen = [Scenario(),
                Scenario([Perturbation("set_label", nodes=np.arange(0, 10), key=zone,
                                       value="zone-new")]),
                Scenario([Perturbation("set_label", nodes=np.arange(1, 30, 3), key="tier",
                                       value="hot")])]
        return WhatIfEngine(ec2, ep2, scen, FrameworkConfig(), wave_width=4, chunk_waves=6,
                            device="cpu")
    if case == "policies":
        pol = np.asarray([[1.0, 3.0, 2.0, 2.0, 2.0, 1.0], [2.3125, 0.7, 4.1, 1.55, 3.3, 0.0],
                          [1.0, 0.0, 2.0, 0.0, 5.25, 1.0]], np.float32)
        scen = uniform_scenarios(ec2, 3, seed=2, p_node_down=0.5)
        return WhatIfEngine(ec2, ep2, scen, FrameworkConfig(), wave_width=4, chunk_waves=6,
                            policies=pol, device="cpu")
    if case == "tier":
        cluster = make_cluster(8, seed=2, taint_fraction=0.2)
        workload, _ = make_workload(300, seed=2, with_spread=True, with_tolerations=True,
                                    duration_mean=20.0, arrival_rate=12.0)
        pec, pep = encode(cluster, workload)
        scen = uniform_scenarios(pec, 3, seed=1, p_capacity=0.5)
        return WhatIfEngine(pec, pep, scen, FrameworkConfig(), chunk_waves=4, preemption=True,
                            device="cpu")
    assert case == "retry"
    cluster = make_cluster(3, seed=4, taint_fraction=0.2)
    workload, _ = make_workload(300, seed=4, arrival_rate=120.0, duration_mean=3.0,
                                with_affinity=True, with_spread=True, with_tolerations=True,
                                gang_fraction=0.05, gang_size=2)
    rec, rep = encode(cluster, workload)
    return WhatIfEngine(rec, rep, uniform_scenarios(rec, 3, seed=1, p_capacity=0.5),
                        FrameworkConfig(), wave_width=4, chunk_waves=3, retry_buffer=8,
                        device="cpu")


CASES = ("replay", "whatif", "labels", "policies", "tier", "retry")


def _planes(tb):
    out = dict(zip(ref.DevState._fields, tb.state))
    for part in ("preempt", "retry"):
        nt = getattr(tb, part)
        if nt is not None:
            out.update({f"{part}.{f}": x for f, x in zip(nt._fields, nt) if torch.is_tensor(x)})
    return out


@pytest.mark.parametrize("case", CASES)
def test_chunk_twin_equals_slot_route_chunk_by_chunk(case):
    eng = _engine(case)
    plan = eng.plan
    S = eng.S
    tb_slot, tb_chunk = eng._tables(), eng._tables()
    ch_slot = new_choices(plan, S, eng.pods.bound_node, "cpu")
    ch_chunk = ch_slot.clone()
    nchunks = len(plan.buckets)
    assert nchunks >= 3, nchunks
    for c in range(nchunks):
        lo, hi = c * plan.C, (c + 1) * plan.C
        run_waves(plan, tb_slot, ch_slot, lo, hi, plain=True, route="slot")
        run_waves(plan, tb_chunk, ch_chunk, lo, hi, plain=True, route="chunk")
        assert torch.equal(ch_slot, ch_chunk), (case, c)
        a, b = _planes(tb_slot), _planes(tb_chunk)
        for name in a:
            assert torch.equal(a[name], b[name]), (case, c, name)
    placed = (ch_chunk[:, : plan.idx.size] >= 0).sum()
    assert placed > 0
    if case == "tier":
        assert int(tb_chunk.preempt.victims.sum()) > 0
    if case == "retry":
        assert int(tb_chunk.retry.rdrop.sum()) > 0 and int((tb_chunk.retry.rnode >= 0).sum()) > 0


@pytest.mark.parametrize("case", CASES)
def test_engine_routes_place_alike(case):
    """The engine's mode-chosen route (chunk, through the K6 wrapper's
    twin on CPU tensors) and the explicit per-slot route give the same
    assignments and planes; the route is recorded and nothing is launched."""
    eng = _engine(case)
    K.reset_launch_counts()
    tb_c, _, a_c, placed_c, _ = eng._run()
    assert eng.last_route == "chunk"
    tb_s, _, a_s, placed_s, _ = eng._run(route="slot")
    assert eng.last_route == "slot"
    np.testing.assert_array_equal(a_c, a_s)
    np.testing.assert_array_equal(placed_c, placed_s)
    for name, x in _planes(tb_c).items():
        assert torch.equal(x, _planes(tb_s)[name]), name
    assert set(K.launch_counts().values()) == {0}


def test_descriptor_is_the_plan():
    """The descriptor is the plan's slot index and gang flags, and a
    padded chunk end loses no slot: every valid slot of the trace is
    walked exactly once (its choice column written) on the chunk route."""
    ec, ep = _headline_cut(pods=333)
    eng = TorchReplayEngine(ec, ep, FrameworkConfig(), chunk_waves=16, device="cpu")
    plan = eng.plan
    desc = plan.device_desc("cpu")
    assert desc.idx.dtype == torch.int32 and desc.gang.dtype == torch.uint8
    np.testing.assert_array_equal(desc.idx.numpy(), plan.idx.reshape(-1))
    np.testing.assert_array_equal(desc.gang.numpy().astype(bool), plan.gang_wave)
    assert plan.idx.shape[0] % plan.C == 0 and (plan.idx[-1] == PAD).all()
    tb, _, a, placed, to_schedule = eng._run()
    valid = plan.idx.reshape(-1) >= 0
    assert int(valid.sum()) == to_schedule == ep.num_pods
    walked = eng.last_choices[0, : plan.idx.size][valid]
    assert (walked >= 0).sum() == int(placed[0]) and (a[0] >= 0).sum() == int(placed[0])


def test_choose_route_and_refusals():
    assert ROUTES == ("chunk", "slot", "shard", "shard_slot")
    assert choose_route(False) == "chunk"
    assert choose_route(True) == "slot"
    assert choose_route(False, True) == "shard"
    assert choose_route(True, True) == "shard_slot"
    v2 = TorchReplayEngine(*_headline_cut(pods=100), FrameworkConfig(), device="cpu",
                           engine="v2")
    assert v2.replay().route == "chunk"
    eng = TorchReplayEngine(*_headline_cut(pods=100), FrameworkConfig(), device="cpu",
                            telemetry="series")
    assert eng.replay().route == "chunk"
    tb = eng._tables()
    ch = new_choices(eng.plan, 1, eng.pods.bound_node, "cpu")
    from kubernetes_simulator_tpu_torch.sim.torch_runtime import new_series

    with pytest.raises(ValueError, match="replicated routes"):
        run_waves(eng.plan, tb, ch, 0, 1, plain=False, ser=new_series(eng.plan, tb, True),
                  route="shard")
    with pytest.raises(ValueError, match="route must be"):
        run_waves(eng.plan, tb, ch, 0, 1, plain=False, route="wave")
