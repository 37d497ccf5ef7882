"""Kube preemption in the port — the minimal-victims PostFilter as a step of
the retry pass (K6's retry mode on the card; its plain twins here, on the
CPU) — held against the JAX package, case by case of
tests/test_kube_preempt.py.

Every case runs the same encoded trace through the JAX
``greedy_replay(preemption="kube")`` (the anchor) and
``JaxReplayEngine(preemption="kube")``, and through the port's
``greedy_replay`` and ``TorchReplayEngine(device="cpu")``; equal means
equal assignments, placed, preemptions and retry_dropped, the port's
summary latency equal to the JAX engine's, and the final planes within
tests/test_jax_parity.py::assert_parity's tolerances (``used`` atol 1e-3,
the count planes 1e-5). The what-if cases hold the port's
``WhatIfEngine(preemption="kube")`` to the JAX one, and each perturbed
scenario to a from-scratch replay of the perturbed cluster. Inputs come
from the JAX package's generators, carried into the port as numpy arrays
(tests/torch_port_case.py)."""

import dataclasses

import numpy as np
import pytest
import torch

from kubernetes_simulator_tpu.framework.framework import FrameworkConfig as J_Config
from kubernetes_simulator_tpu.models.core import (
    Cluster,
    LabelSelector,
    Node,
    Pod,
    PodAffinitySpec,
    PodAffinityTerm,
    Taint,
)
from kubernetes_simulator_tpu.models.encode import PAD, encode
from kubernetes_simulator_tpu.sim import whatif as J
from kubernetes_simulator_tpu.sim.greedy import greedy_replay as j_greedy
from kubernetes_simulator_tpu.sim.jax_runtime import JaxReplayEngine
from kubernetes_simulator_tpu.sim.synthetic import make_cluster, make_workload
from kubernetes_simulator_tpu_torch.framework.framework import FrameworkConfig
from kubernetes_simulator_tpu_torch.ops import reference as ref
from kubernetes_simulator_tpu_torch.sim import torch_runtime as TR
from kubernetes_simulator_tpu_torch.sim import whatif as T
from kubernetes_simulator_tpu_torch.sim.greedy import greedy_replay as t_greedy

from torch_port_case import port_case

USED_ATOL = 1e-3  # assert_parity's tolerance on ``used`` (f32 sums)
PLANE_ATOL = 1e-5  # and on the count planes
FIT_ONLY = [{"name": "NodeResourcesFit"}]


@pytest.fixture(autouse=True)
def _deterministic():
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


def hold(cluster, pods, plugins=None, wave_width=8, chunk_waves=4, retry_buffer=64):
    """The four replays of one trace under kube preemption, held equal;
    returns the port engine's result and its tables."""
    ec, ep = encode(cluster, pods)
    pec, pep = port_case(ec, ep)
    jcfg, tcfg = J_Config(plugins=plugins), FrameworkConfig(plugins=plugins)
    kw = dict(preemption="kube", retry_buffer=retry_buffer)
    a = j_greedy(ec, ep, jcfg, wave_width=wave_width, completions_chunk_waves=chunk_waves, **kw)
    d = JaxReplayEngine(ec, ep, jcfg, wave_width=wave_width, chunk_waves=chunk_waves,
                        **kw).replay()
    g = t_greedy(pec, pep, tcfg, wave_width=wave_width, completions_chunk_waves=chunk_waves,
                 **kw)
    eng = TR.TorchReplayEngine(pec, pep, tcfg, wave_width=wave_width, chunk_waves=chunk_waves,
                               device="cpu", **kw)
    t = eng.replay()
    # The JAX engine equals its anchor on every case here; where they
    # differed the port would follow the anchor (ROADMAP C).
    np.testing.assert_array_equal(d.assignments, a.assignments)
    for name, r in (("port greedy", g), ("port engine", t)):
        np.testing.assert_array_equal(r.assignments, a.assignments, err_msg=name)
        assert (r.placed, r.preemptions, r.retry_dropped) == (
            a.placed, a.preemptions, a.retry_dropped), name
        np.testing.assert_allclose(r.state.used, a.state.used, atol=USED_ATOL, err_msg=name)
        np.testing.assert_allclose(r.state.match_count, a.state.match_count, atol=PLANE_ATOL,
                                   err_msg=name)
        np.testing.assert_allclose(r.state.anti_active, a.state.anti_active, atol=PLANE_ATOL,
                                   err_msg=name)
    assert t.telemetry.latency == d.telemetry.latency
    assert t.route == "chunk"
    return t, eng.last_tables


def test_minimal_victims_not_evict_all_lower():
    """Two lower-priority pods on the node, the preemptor needs one slot:
    only the lowest-priority one goes (tier preemption would take both)."""
    cluster = Cluster(nodes=[Node("n0", {"cpu": 2})])
    pods = [
        Pod("lo0", requests={"cpu": 1}, arrival_time=0.0, priority=0),
        Pod("lo5", requests={"cpu": 1}, arrival_time=1.0, priority=5),
        Pod("hi", requests={"cpu": 1}, arrival_time=2.0, priority=100),
    ]
    t, _ = hold(cluster, pods, FIT_ONLY, wave_width=1, chunk_waves=1, retry_buffer=8)
    assert list(t.assignments) == [PAD, 0, 0] and t.preemptions == 1


def test_node_ranking_fewest_then_lowest_priority():
    """n0 needs two victims, n1 and n2 one each: the lower max victim
    priority wins (n2). Pre-bound pods make the layout."""
    nodes = [Node("n0", {"cpu": 2}), Node("n1", {"cpu": 2}), Node("n2", {"cpu": 2})]
    pods = [
        Pod("a0", requests={"cpu": 1}, arrival_time=0.0, priority=10, node_name="n0"),
        Pod("a1", requests={"cpu": 1}, arrival_time=0.0, priority=10, node_name="n0"),
        Pod("b0", requests={"cpu": 2}, arrival_time=0.0, priority=20, node_name="n1"),
        Pod("c0", requests={"cpu": 2}, arrival_time=0.0, priority=5, node_name="n2"),
        Pod("hi", requests={"cpu": 2}, arrival_time=4.0, priority=100),
    ]
    t, _ = hold(Cluster(nodes=nodes), pods, FIT_ONLY, wave_width=1, chunk_waves=1,
                retry_buffer=8)
    assert t.assignments[4] == 2 and t.assignments[3] == PAD and t.preemptions == 1


def test_count_rewind_unblocks_anti_affinity():
    """Evicting the anti-affinity blocker rewinds its counts exactly, so the
    preemptor passes the full confirm (the trial walk's path)."""
    nodes = [Node("n0", {"cpu": 2}, labels={"kubernetes.io/hostname": "n0"})]
    anti = PodAffinitySpec(required=(PodAffinityTerm(
        label_selector=LabelSelector.make({"app": "x"}),
        topology_key="kubernetes.io/hostname"),))
    pods = [
        Pod("blocker", labels={"app": "x"}, requests={"cpu": 1}, arrival_time=0.0, priority=0),
        Pod("hi", labels={"app": "y"}, requests={"cpu": 1}, arrival_time=1.0, priority=100,
            pod_anti_affinity=anti),
    ]
    t, tb = hold(Cluster(nodes=nodes), pods,
                 [{"name": "NodeResourcesFit"}, {"name": "InterPodAffinity"}],
                 wave_width=1, chunk_waves=1, retry_buffer=8)
    assert t.assignments[0] == PAD and t.assignments[1] == 0 and t.preemptions == 1
    assert float(tb.state.anti_active.sum()) == 1.0  # hi's own term only: no phantom


def test_victim_requeued_and_replaced():
    """The victim re-enters the pass's queue and lands on the other node once
    its blocker completes; the pre-bound victim's re-placement is not a
    placement of this replay (placed counts it once, as the reference)."""
    nodes = [Node("n0", {"cpu": 2}), Node("n1", {"cpu": 2})]
    pods = [
        Pod("lo", requests={"cpu": 2}, arrival_time=0.0, priority=0, node_name="n0"),
        Pod("blk", requests={"cpu": 2}, arrival_time=0.0, duration=6.0, priority=50,
            node_name="n1"),
        Pod("hi", requests={"cpu": 2}, arrival_time=1.0, priority=100),
        Pod("t1", requests={}, arrival_time=2.0),
        Pod("t2", requests={}, arrival_time=7.0),
        Pod("t3", requests={}, arrival_time=8.0),
    ]
    t, tb = hold(Cluster(nodes=nodes), pods, FIT_ONLY, wave_width=1, chunk_waves=1,
                 retry_buffer=8)
    assert list(t.assignments[:3]) == [1, 1, 0] and t.preemptions == 1
    assert int(tb.retry.first_b[0, 0]) == ref.FIRST_IN_WAVE  # pre-bound, then evicted


def test_gangs_never_victims_and_never_preempt():
    nodes = [Node("n0", {"cpu": 2})]
    pods = [
        Pod("g0", requests={"cpu": 1}, arrival_time=0.0, priority=0, pod_group="g"),
        Pod("g1", requests={"cpu": 1}, arrival_time=0.0, priority=0, pod_group="g"),
        Pod("hi", requests={"cpu": 1}, arrival_time=1.0, priority=100),
    ]
    t, _ = hold(Cluster(nodes=nodes), pods, FIT_ONLY, wave_width=2, chunk_waves=1,
                retry_buffer=8)
    assert list(t.assignments) == [0, 0, PAD] and t.preemptions == 0


@pytest.mark.parametrize("kube", [False, True])
def test_retry_dropped_reported(kube):
    """Drops on a full buffer are a reported number (the plain retry buffer
    and kube alike)."""
    nodes = [Node("n0", {"cpu": 1})]
    pods = [Pod("seed", requests={"cpu": 1}, arrival_time=0.0)]
    pods += [Pod(f"f{i}", requests={"cpu": 1}, arrival_time=1.0 + i) for i in range(20)]
    if kube:
        t, _ = hold(Cluster(nodes=nodes), pods, FIT_ONLY, wave_width=1, chunk_waves=1,
                    retry_buffer=4)
    else:
        ec, ep = encode(Cluster(nodes=nodes), pods)
        pec, pep = port_case(ec, ep)
        a = j_greedy(ec, ep, J_Config(plugins=FIT_ONLY), wave_width=1,
                     completions_chunk_waves=1, retry_buffer=4)
        t = TR.TorchReplayEngine(pec, pep, FrameworkConfig(plugins=FIT_ONLY), wave_width=1,
                                 chunk_waves=1, retry_buffer=4, device="cpu").replay()
        np.testing.assert_array_equal(t.assignments, a.assignments)
        assert t.retry_dropped == a.retry_dropped
    assert t.retry_dropped > 0


def _random_case(seed, with_affinity=False):
    cluster = make_cluster(6, seed=seed, taint_fraction=0.2)
    pods, _ = make_workload(260, seed=seed, with_spread=True, with_tolerations=True,
                            with_affinity=with_affinity, duration_mean=60.0, arrival_rate=8.0)
    return cluster, pods


@pytest.mark.parametrize("seed,with_affinity", [(0, False), (2, False), (3, False), (2, True)])
def test_random_overcommitted_traces(seed, with_affinity):
    """Over-committed random traces with priorities, spread, tolerations and
    durations: preemptions and completions both fire. With affinity the
    trace holds required anti-affinity, so every pod takes the trial walk;
    without it the spread-free pods take the cumsum path."""
    cluster, pods = _random_case(seed, with_affinity)
    t, tb = hold(cluster, pods)
    if seed != 0:
        assert t.preemptions > 0
    assert tb.retry.trace_has_anti == with_affinity


def test_both_postfilter_paths_preempt():
    """The PostFilter's two paths each rescue a pod in these traces: the
    cumsum path (no state-dependent filter on the pod) and the trial walk
    (a DoNotSchedule spread term, or required anti-affinity anywhere)."""
    seen = {"cumsum": 0, "trial": 0}
    orig = ref.post_filter

    def counting(tb, choices, s, p, b):
        hit = orig(tb, choices, s, p, b)
        if hit is not None:
            pods, k = tb.pods, tb.consts
            trial = tb.retry.trace_has_anti and k.interpod or bool(
                ((pods.spread_g[p] >= 0) & pods.spread_dns[p]).any()) and k.spread
            seen["trial" if trial else "cumsum"] += 1
        return hit

    ref.post_filter = counting
    try:
        for seed, aff in ((2, False), (2, True)):
            cluster, pods = _random_case(seed, aff)
            ec, ep = encode(cluster, pods)
            pec, pep = port_case(ec, ep)
            TR.TorchReplayEngine(pec, pep, FrameworkConfig(), chunk_waves=4, preemption="kube",
                                 retry_buffer=64, device="cpu").replay()
    finally:
        ref.post_filter = orig
    assert seen["cumsum"] > 0 and seen["trial"] > 0, seen


def test_framework_postfilter_equals_reference():
    """The port's SchedulerFramework PostFilter (the host reference) equals
    the JAX one pod by pod on a mid-replay state of an over-committed
    trace, rescued pods carrying no reasons."""
    from kubernetes_simulator_tpu.framework.framework import SchedulerFramework as JFW
    from kubernetes_simulator_tpu.models.state import bind as j_bind, init_state
    from kubernetes_simulator_tpu_torch.framework.framework import SchedulerFramework as TFW
    from kubernetes_simulator_tpu_torch.models.state import SchedState

    for seed, aff in ((2, False), (2, True)):
        cluster, pods = _random_case(seed, aff)
        ec, ep = encode(cluster, pods)
        pec, pep = port_case(ec, ep)
        jfw, tfw = JFW(ec, ep, J_Config()), TFW(pec, pep, FrameworkConfig())
        st = init_state(ec, ep)
        rescued = 0
        for p in range(ep.num_pods):
            tst = SchedState(*(getattr(st, f.name).copy() for f in dataclasses.fields(st)))
            jr = jfw.schedule_one(st, p, allow_preemption=True, want_reasons=True)
            tr = tfw.schedule_one(tst, p, allow_preemption=True, want_reasons=True)
            assert (tr.node, tr.reason, tr.victims, tr.reasons) == (
                jr.node, jr.reason, jr.victims, jr.reasons), p
            rescued += jr.reason == "Preempted"
            if jr.node != PAD and not jr.victims:
                j_bind(ec, ep, st, p, jr.node)
        assert rescued > 0


@pytest.fixture(scope="module")
def whatif_case():
    cluster, pods = _random_case(2)
    return cluster, pods


def test_whatif_unperturbed_equals_single_replay(whatif_case):
    cluster, pods = whatif_case
    ec, ep = encode(cluster, pods)
    pec, pep = port_case(ec, ep)
    kw = dict(chunk_waves=4, preemption="kube", retry_buffer=64)
    single = TR.TorchReplayEngine(pec, pep, FrameworkConfig(), device="cpu", **kw).replay()
    assert single.preemptions > 0
    res = T.WhatIfEngine(pec, pep, [T.Scenario(), T.Scenario()], FrameworkConfig(),
                         collect_assignments=True, device="cpu", **kw).run()
    for s in range(2):
        np.testing.assert_array_equal(res.assignments[s], single.assignments)
    assert list(res.placed) == [single.placed] * 2
    assert list(res.preemptions) == [single.preemptions] * 2
    assert list(res.retry_dropped) == [single.retry_dropped] * 2
    assert list(res.evictions) == [0, 0] and res.route == "chunk"
    tally = T.WhatIfEngine(pec, pep, [T.Scenario(), T.Scenario()], FrameworkConfig(),
                           device="cpu", **kw).run()
    np.testing.assert_array_equal(tally.placed, res.placed)


def test_whatif_perturbed_equals_from_scratch_and_jax(whatif_case):
    """scale_capacity and add_taint scenarios: each equals the JAX
    WhatIfEngine's scenario and a from-scratch replay (the JAX anchor and
    the port's engine) of the perturbed cluster."""
    cluster, pods = whatif_case
    ec, ep = encode(cluster, pods)
    pec, pep = port_case(ec, ep)
    kw = dict(chunk_waves=4, preemption="kube", retry_buffer=64)
    j_scen = [
        J.Scenario(),
        J.Scenario([J.Perturbation("scale_capacity", nodes=np.arange(2), resource="cpu",
                                   factor=0.5)]),
        J.Scenario([J.Perturbation("add_taint", nodes=np.arange(2), key="kk", value="vv",
                                   effect="NoSchedule")]),
    ]
    t_scen = [
        T.Scenario(),
        T.Scenario([T.Perturbation("scale_capacity", nodes=np.arange(2), resource="cpu",
                                   factor=0.5)]),
        T.Scenario([T.Perturbation("add_taint", nodes=np.arange(2), key="kk", value="vv",
                                   effect="NoSchedule")]),
    ]
    jres = J.WhatIfEngine(ec, ep, j_scen, J_Config(), collect_assignments=True, **kw).run()
    eng = T.WhatIfEngine(pec, pep, t_scen, FrameworkConfig(), collect_assignments=True,
                         device="cpu", **kw)
    tres = eng.run()
    np.testing.assert_array_equal(tres.assignments, jres.assignments)
    for name in ("placed", "preemptions", "retry_dropped", "evictions", "evict_rescheduled",
                 "evict_stranded"):
        np.testing.assert_array_equal(getattr(tres, name), getattr(jres, name), err_msg=name)
    np.testing.assert_allclose(tres.utilization_cpu, jres.utilization_cpu, atol=USED_ATOL)

    scaled = make_cluster(6, seed=2, taint_fraction=0.2)
    for i in range(2):
        scaled.nodes[i].allocatable = {k: (v * 0.5 if k == "cpu" else v)
                                       for k, v in scaled.nodes[i].allocatable.items()}
    tainted = make_cluster(6, seed=2, taint_fraction=0.2)
    for i in range(2):
        tainted.nodes[i].taints.append(Taint("kk", "vv", "NoSchedule"))
    for s, cl in ((1, scaled), (2, tainted)):
        ec2, ep2 = encode(cl, pods)
        a = j_greedy(ec2, ep2, J_Config(), completions_chunk_waves=4, preemption="kube",
                     retry_buffer=64)
        np.testing.assert_array_equal(tres.assignments[s], a.assignments)
        assert int(tres.placed[s]) == a.placed and int(tres.preemptions[s]) == a.preemptions
        pec2, pep2 = port_case(ec2, ep2)
        t = TR.TorchReplayEngine(pec2, pep2, FrameworkConfig(), device="cpu", **kw).replay()
        np.testing.assert_array_equal(tres.assignments[s], t.assignments)
        np.testing.assert_allclose(eng.last_tables.state.used[s].numpy(), t.state.used,
                                   atol=USED_ATOL)


def test_guards(tmp_path):
    """The reference's refusals, and the modes the port refuses by name (each
    naming its ROADMAP item)."""
    ec, ep = encode(Cluster(nodes=[Node("n0", {"cpu": 1})]),
                    [Pod("p", requests={"cpu": 1}, arrival_time=0.0, duration=1.0)])
    pec, pep = port_case(ec, ep)
    cfg = FrameworkConfig(plugins=FIT_ONLY)
    with pytest.raises(ValueError, match="retry_buffer > 0"):
        TR.TorchReplayEngine(pec, pep, cfg, preemption="kube", device="cpu")
    with pytest.raises(ValueError, match="retry_buffer > 0"):
        t_greedy(pec, pep, cfg, preemption="kube", completions_chunk_waves=1)
    with pytest.raises(ValueError, match="completions_chunk_waves"):
        t_greedy(pec, pep, cfg, preemption="kube", retry_buffer=8)
    with pytest.raises(ValueError, match="tier"):
        TR.TorchReplayEngine(pec, pep, cfg, preemption="tier", retry_buffer=8, device="cpu")
    with pytest.raises(ValueError, match="completions=False"):
        TR.TorchReplayEngine(pec, pep, cfg, preemption="kube", retry_buffer=8,
                             completions=False, device="cpu")
    with pytest.raises(ValueError, match="paged"):
        TR.TorchReplayEngine(pec, pep, cfg, preemption="kube", retry_buffer=8, paged=True,
                             device="cpu")
    with pytest.raises(NotImplementedError, match="item 6a"):
        TR.TorchReplayEngine(pec, pep, cfg, preemption="kube", retry_buffer=8, device="cpu",
                             node_shards=2)
    for g in ("series", "timeline"):  # kube's attribution and events run (queue A item 6c)
        TR.TorchReplayEngine(pec, pep, cfg, preemption="kube", retry_buffer=8, device="cpu",
                             telemetry=g)
    eng = TR.TorchReplayEngine(pec, pep, cfg, preemption="kube", retry_buffer=8, device="cpu")
    with pytest.raises(NotImplementedError, match="item 6a"):
        eng._run(route="slot")
    # Ported since (queue A item 6d): a path without a cadence writes
    # nothing, as the reference's replay.
    eng.replay(checkpoint_path=str(tmp_path / "x.npz"))
    assert not (tmp_path / "x.npz").exists()
    assert TR.choose_route(True, kube=True) == "chunk"
    scen = [T.Scenario()]
    with pytest.raises(ValueError, match="retry_buffer > 0"):
        T.WhatIfEngine(pec, pep, scen, cfg, preemption="kube", device="cpu")
    with pytest.raises(ValueError, match="no-mesh"):
        T.WhatIfEngine(pec, pep, scen, cfg, preemption="kube", retry_buffer=8,
                       mesh=[torch.device("cpu")], device="cpu")
    with pytest.raises(ValueError, match="completions"):
        T.WhatIfEngine(pec, pep, scen, cfg, preemption="kube", retry_buffer=8,
                       completions=False, device="cpu")
    lec, lep = port_case(*encode(*_random_case(2)))
    with pytest.raises(ValueError, match="label"):
        T.WhatIfEngine(lec, lep, [T.Scenario([T.Perturbation(
            "set_label", nodes=np.array([0]), key="topology.kubernetes.io/zone", value="zz")])],
            cfg, preemption="kube", retry_buffer=8, device="cpu")
    ec2, ep2 = encode(Cluster(nodes=[Node("n0", {"cpu": 2})]),
                      [Pod("a", requests={"cpu": 1}, arrival_time=0.0, node_name="n0"),
                       Pod("p", requests={"cpu": 1}, arrival_time=1.0)])
    pec2, pep2 = port_case(ec2, ep2)
    with pytest.raises(ValueError, match="pre-bound"):
        T.WhatIfEngine(pec2, pep2, scen, cfg, preemption="kube", retry_buffer=8, device="cpu")


def test_config_and_cli_take_kube(tmp_path):
    """``devicePreemption: kube`` parses, carries the reference's checks,
    and the CLI's run passes it with the buffer: the replay row's
    preemptions and drops equal the JAX anchor's."""
    import json

    import yaml

    from kubernetes_simulator_tpu.utils.config import SimConfig as J_SimConfig
    from kubernetes_simulator_tpu.utils.config import build_encoded_case as j_build
    from kubernetes_simulator_tpu_torch import cli
    from kubernetes_simulator_tpu_torch.utils.config import SimConfig, config_errors

    d = {"devicePreemption": "kube", "chunkWaves": 4,
         "cluster": {"synthetic": {"nodes": 6, "seed": 2, "taintFraction": 0.2}},
         "workload": {"synthetic": {"pods": 260, "seed": 2, "durationMean": 60.0,
                                    "arrivalRate": 8.0, "spread": True, "tolerations": True}},
         "whatIf": {"retryBuffer": 64}}
    cfg = SimConfig.from_dict(d)
    assert cfg.device_preemption == "kube" and config_errors(cfg) == []
    assert any("retryBuffer > 0" in e for e in config_errors(SimConfig.from_dict(
        {**d, "whatIf": {}})))
    assert any("no-mesh" in e for e in config_errors(SimConfig.from_dict(
        {**d, "whatIf": {"retryBuffer": 64, "mesh": True}})))
    assert any("pagedWaves" in e for e in config_errors(SimConfig.from_dict(
        {**d, "pagedWaves": True})))
    path, out = tmp_path / "k.yaml", tmp_path / "rows.jsonl"
    path.write_text(yaml.safe_dump({**d, "output": str(out)}))
    assert cli.main(["run", str(path), "--device", "cpu"]) == 0
    row = json.loads(out.read_text().splitlines()[0])
    jc = J_SimConfig.from_dict(d)
    ec, ep = j_build(jc)
    a = j_greedy(ec, ep, jc.framework, wave_width=jc.wave_width, preemption="kube",
                 completions_chunk_waves=jc.chunk_waves, retry_buffer=64)
    assert (row["placed"], row["preemptions"], row["retry_dropped"]) == (
        a.placed, a.preemptions, a.retry_dropped)
    assert a.preemptions > 0
