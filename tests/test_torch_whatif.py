"""The port's what-if engine (kubernetes_simulator_tpu_torch.sim.whatif)
against the JAX package's, on the CPU at small sizes.

Inputs are made from seeds by the JAX package's generators and carried
into the port as numpy arrays (tests/torch_port_case.py). Assignments and
placed counts are compared exactly; ``utilization_cpu`` within 1e-6, the
tolerance tests/test_completions_device.py holds the JAX engine's two
release paths to (an f32 mean over nodes, summed in another order)."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from kubernetes_simulator_tpu.framework.framework import FrameworkConfig as J_Config
from kubernetes_simulator_tpu.models.core import Cluster, Node, Pod, Taint
from kubernetes_simulator_tpu.models.encode import encode
from kubernetes_simulator_tpu.sim.greedy import greedy_replay
from kubernetes_simulator_tpu.sim.jax_runtime import JaxReplayEngine
from kubernetes_simulator_tpu.sim.synthetic import make_cluster, make_workload
from kubernetes_simulator_tpu.sim import whatif as J
from kubernetes_simulator_tpu_torch.framework.framework import FrameworkConfig
from kubernetes_simulator_tpu_torch.sim import whatif as T
from kubernetes_simulator_tpu_torch.sim.torch_runtime import TorchReplayEngine

from torch_port_case import port_case

UTIL_ATOL = 1e-6


@pytest.fixture(autouse=True)
def _deterministic():
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


def port_scenarios(scen):
    """The port's copy of a JAX-package scenario list."""
    return [
        T.Scenario([T.Perturbation(**dataclasses.asdict(pt)) for pt in sc.perturbations])
        for sc in scen
    ]


def both(ec, ep, scen, plugins=None, **kw):
    """(port result, JAX result, port engine) of one batch; the port's
    scenarios and case are carried copies of the JAX package's."""
    pec, pep = port_case(ec, ep)
    eng = T.WhatIfEngine(pec, pep, port_scenarios(scen), FrameworkConfig(plugins=plugins),
                         device="cpu", **kw)
    jres = J.WhatIfEngine(ec, ep, scen, J_Config(plugins=plugins), **kw).run()
    return eng.run(), jres, eng


def assert_rows_equal(got, want, what):
    bad = np.argwhere(got != want)
    assert bad.size == 0, (
        f"{what}: {len(bad)} mismatches, first (scenario, pod) {bad[:5].tolist()}: "
        f"port={got[tuple(bad[:5].T)]} other={want[tuple(bad[:5].T)]}"
    )


# -- (a) the scenario stacks, with the carried vocabulary ----------------------


@pytest.mark.parametrize("probs", [{}, dict(p_node_down=0.5, p_taint=0.6)],
                         ids=["default", "dense"])
def test_scenario_stacks_equal_reference(probs):
    cluster = make_cluster(60, seed=3, taint_fraction=0.2)
    pods, _ = make_workload(20, seed=3, with_tolerations=True)
    ec, ep = encode(cluster, pods)
    pec, _ = port_case(ec, ep)
    jscen = J.uniform_scenarios(ec, 8, seed=3, **probs)
    tscen = T.uniform_scenarios(pec, 8, seed=3, **probs)
    for js, ts in zip(jscen, tscen):
        assert [p.op for p in js.perturbations] == [p.op for p in ts.perturbations]
        for p, q in zip(js.perturbations, ts.perturbations):
            np.testing.assert_array_equal(p.nodes, q.nodes)
            assert (p.resource, p.factor, p.key, p.value, p.effect) == (
                q.resource, q.factor, q.key, q.value, q.effect)
    hs = J.ScenarioSet(ec, jscen, keep_host_stacks=True).host_stacks
    ss = T.ScenarioSet(pec, tscen)
    for name, t in (("alloc", ss.alloc), ("tk", ss.taint_key), ("tv", ss.taint_kv),
                    ("te", ss.taint_effect)):
        assert t.numpy().dtype == hs[name].dtype, name
        np.testing.assert_array_equal(t.numpy(), hs[name], err_msg=name)
    assert pec.vocab.keys == ec.vocab.keys and pec.vocab.kvs == ec.vocab.kvs
    if probs:
        assert any(p.op == "add_taint" for sc in jscen for p in sc.perturbations)
        assert any(p.op == "node_down" for sc in jscen for p in sc.perturbations)


# -- (b) tests/test_whatif.py:29, :40, :140 -------------------------------------


def test_base_scenarios_equal_reference_and_single_replay():
    cluster = make_cluster(15, seed=0, taint_fraction=0.1)
    pods, _ = make_workload(80, seed=0, with_affinity=True, with_spread=True,
                            with_tolerations=True)
    ec, ep = encode(cluster, pods)
    res, jres, _ = both(ec, ep, [J.Scenario(), J.Scenario()], collect_assignments=True)
    single = JaxReplayEngine(ec, ep, J_Config()).replay()
    assert_rows_equal(res.assignments, jres.assignments, "jax what-if")
    for s in range(2):
        assert_rows_equal(res.assignments[s], single.assignments, f"single replay {s}")
    np.testing.assert_array_equal(res.placed, jres.placed)
    assert res.placed[0] == single.placed


def test_perturbed_scenarios_equal_reference_and_single_replays():
    cluster = make_cluster(12, seed=3)
    pods, _ = make_workload(60, seed=3, with_tolerations=True)
    ec, ep = encode(cluster, pods)
    scen = [
        J.Scenario(),
        J.Scenario([J.Perturbation("node_down", nodes=np.array([0, 1]))]),
        J.Scenario([J.Perturbation("scale_capacity", nodes=np.arange(6), resource="cpu",
                                   factor=0.5)]),
        J.Scenario([J.Perturbation("add_taint", nodes=np.arange(4), key="k", value="v",
                                   effect="NoSchedule")]),
    ]
    res, jres, _ = both(ec, ep, scen, collect_assignments=True)
    assert_rows_equal(res.assignments, jres.assignments, "jax what-if")
    np.testing.assert_array_equal(res.placed, jres.placed)
    np.testing.assert_array_equal(res.unschedulable, jres.unschedulable)
    clusters = J.ScenarioSet(ec, scen, keep_host_stacks=True).host_clusters(ec)
    for s, ec_s in enumerate(clusters):
        single = JaxReplayEngine(ec_s, ep, J_Config()).replay()
        assert_rows_equal(res.assignments[s], single.assignments, f"single replay {s}")
    # Non-vacuous: node_down moves pods off nodes 0 and 1.
    assert (res.assignments[1] >= 2).all() and (res.assignments[0] < 2).any()


def test_injected_prefer_taint_reenables_score_row():
    cluster = make_cluster(12, seed=9)  # no taints in the base cluster
    pods, _ = make_workload(80, seed=9)
    ec, ep = encode(cluster, pods)
    scen = [
        J.Scenario(),
        J.Scenario([J.Perturbation("add_taint", nodes=np.arange(6), key="soft", value="x",
                                   effect="PreferNoSchedule")]),
    ]
    res, jres, eng = both(ec, ep, scen, collect_assignments=True)
    assert eng.spec.taint_score
    assert_rows_equal(res.assignments, jres.assignments, "jax what-if")
    cluster_t = make_cluster(12, seed=9)
    for n in cluster_t.nodes[:6]:
        n.taints.append(Taint("soft", "x", "PreferNoSchedule"))
    ec_t, ep_t = encode(cluster_t, pods)
    single = JaxReplayEngine(ec_t, ep_t, J_Config()).replay()
    assert_rows_equal(res.assignments[1], single.assignments, "tainted single replay")
    assert (res.assignments[1] != res.assignments[0]).any()


# -- (c) tests/test_completions_device.py:160, :196, :278 ------------------------


def test_completions_scenario0_equals_single_replay():
    cluster = make_cluster(10, seed=7)
    pods, _ = make_workload(150, seed=7, arrival_rate=15.0, duration_mean=2.0,
                            with_spread=True, with_tolerations=True)
    ec, ep = encode(cluster, pods)
    scen = [
        J.Scenario(),
        J.Scenario([J.Perturbation("scale_capacity", nodes=np.arange(5), resource="cpu",
                                   factor=0.5)]),
    ]
    kw = dict(wave_width=4, chunk_waves=4, collect_assignments=True, completions=True)
    res, jres, eng = both(ec, ep, scen, **kw)
    assert eng.completions_on and res.completions_on == jres.completions_on
    single = JaxReplayEngine(ec, ep, J_Config(), wave_width=4, chunk_waves=4).replay()
    assert_rows_equal(res.assignments[0], single.assignments, "single replay")
    assert_rows_equal(res.assignments, jres.assignments, "jax what-if")
    np.testing.assert_array_equal(res.placed, jres.placed)
    np.testing.assert_allclose(res.utilization_cpu, jres.utilization_cpu, atol=UTIL_ATOL)
    off, _, _ = both(ec, ep, scen, **dict(kw, completions=False))
    assert (off.assignments[0] != res.assignments[0]).any()


def test_completions_device_release_equals_reference():
    cluster = make_cluster(12, seed=3, taint_fraction=0.2)
    pods, _ = make_workload(120, seed=3, arrival_rate=12.0, duration_mean=2.0,
                            with_spread=True, with_tolerations=True)
    ec, ep = encode(cluster, pods)
    scen = J.uniform_scenarios(ec, 4, seed=3)
    res, jres, _ = both(ec, ep, scen, chunk_waves=4)
    np.testing.assert_array_equal(res.placed, jres.placed)
    np.testing.assert_allclose(res.utilization_cpu, jres.utilization_cpu, atol=UTIL_ATOL)
    assert res.assignments is None
    collected, _, _ = both(ec, ep, scen, chunk_waves=4, collect_assignments=True)
    np.testing.assert_array_equal(collected.placed, res.placed)
    np.testing.assert_array_equal(collected.utilization_cpu, res.utilization_cpu)
    off, _, _ = both(ec, ep, scen, chunk_waves=4, completions=False)
    assert (off.placed != res.placed).any() or (
        np.abs(off.utilization_cpu - res.utilization_cpu) > 1e-4).any()


def test_prebound_pod_releases_from_the_static_tail():
    cluster = Cluster(nodes=[Node("n0", {"cpu": 1})])
    pods = [
        Pod("pre", requests={"cpu": 1}, arrival_time=0.0, duration=1.0, node_name="n0"),
        Pod("f1", requests={}, arrival_time=2.0),
        Pod("f2", requests={}, arrival_time=3.0),
        Pod("b", requests={"cpu": 1}, arrival_time=5.0),
    ]
    ec, ep = encode(cluster, pods)
    plugins = [{"name": "NodeResourcesFit"}]
    res, jres, _ = both(ec, ep, [J.Scenario()], plugins, wave_width=1, chunk_waves=1,
                        collect_assignments=True)
    anchor = greedy_replay(ec, ep, J_Config(plugins=plugins), wave_width=1,
                           completions_chunk_waves=1)
    assert anchor.assignments[3] == 0
    assert int(res.placed[0]) == int(jres.placed[0]) == anchor.placed == 3
    assert_rows_equal(res.assignments[0], anchor.assignments, "anchor")


# -- (d) the full plugin set with gangs and completions (scaled down from :228) --


def test_full_plugins_gangs_completions_equal_greedy_per_scenario():
    cluster = make_cluster(12, seed=5, taint_fraction=0.2)
    pods, meta = make_workload(
        100, seed=5, arrival_rate=14.0, duration_mean=2.0, with_affinity=True,
        with_spread=True, with_tolerations=True, gang_fraction=0.1, gang_size=2,
    )
    assert meta["num_gangs"] > 0
    ec, ep = encode(cluster, pods)
    scen = J.uniform_scenarios(ec, 4, seed=5, p_node_down=0.5, p_taint=0.5)
    res, jres, eng = both(ec, ep, scen, chunk_waves=4, collect_assignments=True)
    assert eng.chunk_waves == 4 and eng.completions_on
    assert_rows_equal(res.assignments, jres.assignments, "jax what-if")
    clusters = J.ScenarioSet(ec, scen, keep_host_stacks=True).host_clusters(ec)
    for s, ec_s in enumerate(clusters):
        anchor = greedy_replay(ec_s, ep, J_Config(), completions_chunk_waves=4)
        assert_rows_equal(res.assignments[s], anchor.assignments, f"greedy scenario {s}")
        assert int(res.placed[s]) == anchor.placed
    # Non-vacuous: scenarios differ, completions and gang rollbacks matter.
    assert len({tuple(a) for a in res.assignments}) > 1
    off, _, _ = both(ec, ep, scen, chunk_waves=4, completions=False, collect_assignments=True)
    assert (off.assignments != res.assignments).any()


# -- (e) S = 1 equals the single replay -------------------------------------------


def test_single_scenario_equals_torch_replay():
    cluster = make_cluster(15, seed=4, taint_fraction=0.2)
    pods, _ = make_workload(120, seed=4, arrival_rate=20.0, duration_mean=1.5,
                            with_affinity=True, with_spread=True, with_tolerations=True,
                            gang_fraction=0.1, gang_size=3)
    ec, ep = encode(cluster, pods)
    pec, pep = port_case(ec, ep)
    kw = dict(wave_width=4, chunk_waves=3)
    res = T.WhatIfEngine(pec, pep, [T.Scenario()], FrameworkConfig(), device="cpu",
                         collect_assignments=True, **kw).run()
    single = TorchReplayEngine(pec, pep, FrameworkConfig(), device="cpu", **kw).replay()
    assert_rows_equal(res.assignments[0], single.assignments, "torch replay")
    assert int(res.placed[0]) == single.placed
    assert int(res.unschedulable[0]) == single.unschedulable
    cpu = pec.vocab._r["cpu"]
    a = pec.allocatable[:, cpu]
    want = np.where(a > 0, single.state.used[:, cpu] / np.where(a > 0, a, 1), 0).mean()
    np.testing.assert_allclose(res.utilization_cpu[0], want, atol=UTIL_ATOL)


# -- (f) refusals -------------------------------------------------------------


def _tiny():
    from kubernetes_simulator_tpu_torch.models.encode import encode as t_encode
    from kubernetes_simulator_tpu_torch.sim.synthetic import (
        make_cluster as t_cluster,
        make_workload as t_workload,
    )

    return t_encode(t_cluster(4, seed=0), t_workload(6, seed=0)[0])


@pytest.mark.parametrize(
    "kw,item",
    [(dict(mesh=["cpu", "cpu"]), "runs"),
     (dict(fork_checkpoint="fork.npz"), "runs"),
     (dict(preemption="kube", retry_buffer=8), "runs"),
     (dict(preemption="kube"), "retry_buffer > 0"),
     (dict(policies=np.ones((2, 6), np.float32), mesh=["cpu", "cpu"]), "runs"),
     (dict(node_shards=2), "queue A item 10"),
     (dict(_dcn_recovery={"block": (0, 1)}), "queue A item 11"),
     (dict(telemetry="series", engine="v2"), "no engine= argument"),
     (dict(engine="v2"), "no engine= argument"),
     ("events", "queue A item 7")],
    ids=lambda v: v if isinstance(v, str) else None,
)
def test_engine_refuses_later_modes_by_queue_item(kw, item):
    ec, ep = _tiny()
    scen = [T.Scenario(), T.Scenario()]
    if kw == "events":
        # Ported since (chaos timelines, tests/test_torch_chaos.py): without
        # kube the reference's error, with it the batch runs.
        from kubernetes_simulator_tpu_torch.sim.runtime import NodeEvent

        scen[1].events = [NodeEvent(time=0.0, kind="node_down", node=0)]
        with pytest.raises(ValueError, match="kube"):
            T.WhatIfEngine(ec, ep, scen, device="cpu")
        res = T.WhatIfEngine(ec, ep, scen, device="cpu", preemption="kube", retry_buffer=8,
                             chunk_waves=1).run()
        assert res.placed.shape == (2,) and int(res.evictions[0]) == 0
        return
    if item == "retry_buffer > 0":  # the reference's error
        with pytest.raises(ValueError, match=item):
            T.WhatIfEngine(ec, ep, scen, device="cpu", **kw)
        return
    if "fork_checkpoint" in kw:
        # Ported since (what-if forks, tests/test_torch_fork.py): the batch
        # starts from the replay's checkpoint, scenario 0 places as it.
        import os
        import tempfile

        ck = os.path.join(tempfile.mkdtemp(), kw["fork_checkpoint"])
        single = TorchReplayEngine(ec, ep, device="cpu", chunk_waves=1).replay(
            checkpoint_path=ck, checkpoint_every=1)
        res = T.WhatIfEngine(ec, ep, scen, device="cpu", chunk_waves=1, fork_checkpoint=ck,
                             collect_assignments=True).run()
        np.testing.assert_array_equal(res.assignments[0], single.assignments)
        return
    if item == "runs" and kw.get("preemption") == "kube":
        # Ported since (kube preemption, tests/test_torch_kube.py): each
        # scenario places as the single replay does.
        res = T.WhatIfEngine(ec, ep, scen, device="cpu", chunk_waves=1, **kw).run()
        single = TorchReplayEngine(ec, ep, device="cpu", chunk_waves=1, **kw).replay()
        assert res.placed.tolist() == [single.placed] * 2
        return
    if item == "runs":
        # Ported since (the scenario mesh, :mod:`parallel.mesh`): a block a
        # device, placing as the unsplit batch does.
        kw.pop("mesh")
        want = T.WhatIfEngine(ec, ep, scen, device="cpu", **kw).run()
        res = T.WhatIfEngine(ec, ep, scen, device="cpu", mesh=["cpu", "cpu"], **kw).run()
        assert (res.n_devices, res.mesh_shape) == (2, {"scenarios": 2})
        np.testing.assert_array_equal(res.placed, want.placed)
        return
    with pytest.raises(NotImplementedError, match=item):
        T.WhatIfEngine(ec, ep, scen, device="cpu", **kw)


def test_set_label_batch_runs():
    """``set_label`` is ported (tests/test_torch_labels_whatif.py holds it
    against the reference): a batch that relabels nodes runs."""
    ec, ep = _tiny()
    scen = [T.Scenario(), T.Scenario([T.Perturbation(
        "set_label", nodes=np.arange(2), key="topology.kubernetes.io/zone", value="z9")])]
    res = T.WhatIfEngine(ec, ep, scen, device="cpu", collect_assignments=True).run()
    assert res.engine == "v3" and res.placed.tolist() == [6, 6]


def test_default_device_is_cuda_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ec, ep = _tiny()
    with pytest.raises(RuntimeError, match="cuda"):
        T.WhatIfEngine(ec, ep, [T.Scenario()])
    res = T.WhatIfEngine(ec, ep, [T.Scenario()], device="cpu").run()
    assert int(res.placed[0]) == 6


# -- (g) the what-if CLI ------------------------------------------------------------


def test_whatif_cli_writes_rows(tmp_path):
    from kubernetes_simulator_tpu_torch import cli

    out = tmp_path / "rows.jsonl"
    cfg = tmp_path / "w.yaml"
    cfg.write_text(
        "cluster: {synthetic: {nodes: 12, seed: 1, taintFraction: 0.2}}\n"
        "workload: {synthetic: {pods: 60, seed: 1, spread: true, tolerations: true,"
        " durationMean: 1.0, arrivalRate: 30.0}}\n"
        "whatIf: {scenarios: 3, seed: 2, nodeDownP: 0.5, taintP: 0.5}\n"
        "chunkWaves: 2\n"
        f"output: {out}\n"
    )
    assert cli.main(["what-if", str(cfg), "--device", "cpu"]) == 0
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    agg, scen_rows = rows[0], rows[1:]
    assert agg["kind"] == "whatif-aggregate" and agg["scenarios"] == 3
    assert agg["completions_on"] and agg["engine"] == "v3" and agg["device"] == "cpu"
    assert [r["scenario"] for r in scen_rows] == [0, 1, 2]
    assert all(r["kind"] == "whatif-scenario" for r in scen_rows)
    assert sum(r["placed"] for r in scen_rows) == agg["total_placed"]
    assert all(r["placed"] + r["unschedulable"] == 60 for r in scen_rows)
    # The same batch through the JAX package's CLI path gives the same counts.
    from kubernetes_simulator_tpu.utils.config import SimConfig as J_SimConfig
    from kubernetes_simulator_tpu.utils.config import build_encoded_case as J_build

    jcfg = J_SimConfig.load(str(cfg))
    ec, ep = J_build(jcfg)
    jscen = J.uniform_scenarios(ec, 3, seed=2, p_node_down=0.5, p_taint=0.5)
    jres = J.WhatIfEngine(ec, ep, jscen, jcfg.framework, chunk_waves=2).run()
    assert [r["placed"] for r in scen_rows] == jres.placed.tolist()


def test_whatif_cli_refuses_mesh_and_retry_buffer(tmp_path):
    """``whatIf.mesh`` runs (a one-device mesh on ``--device cpu``; its rows
    say so). ``whatIf.retryBuffer`` runs, and is refused only where the
    reference refuses it: a trace with no finite duration (no release
    boundary) and ``completions: false``."""
    from kubernetes_simulator_tpu_torch import cli

    cfg = tmp_path / "w.yaml"
    base = "cluster: {synthetic: {nodes: 4}}\nworkload: {synthetic: {pods: 5%s}}\n"
    mesh_out = tmp_path / "mesh.jsonl"
    cfg.write_text(base % "" + f"whatIf: {{scenarios: 2, mesh: true}}\noutput: {mesh_out}\n")
    assert cli.main(["what-if", str(cfg), "--device", "cpu"]) == 0
    rows = [json.loads(line) for line in mesh_out.read_text().splitlines()]
    assert [r["mesh"] for r in rows] == [True] * 3 and [r["placed"] for r in rows[1:]] == [5, 5]
    cfg.write_text(base % "" + "whatIf: {scenarios: 2, retryBuffer: 64}\n")
    with pytest.raises(ValueError, match="retry_buffer requires"):
        cli.main(["what-if", str(cfg), "--device", "cpu"])
    cfg.write_text(base % ", durationMean: 1.0"
                   + "whatIf: {scenarios: 2, retryBuffer: 64, completions: false}\n")
    with pytest.raises(ValueError, match="whatIf.retryBuffer requires"):
        cli.main(["what-if", str(cfg), "--device", "cpu"])
    out = tmp_path / "rows.jsonl"
    cfg.write_text(base % ", durationMean: 1.0"
                   + f"whatIf: {{scenarios: 2, retryBuffer: 64}}\noutput: {out}\n")
    assert cli.main(["what-if", str(cfg), "--device", "cpu"]) == 0
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["placed"] for r in rows[1:]] == [5, 5]
