"""The scenario axis over a mesh (kubernetes_simulator_tpu_torch.parallel.mesh
and ``WhatIfEngine(mesh=...)``) against the JAX package's meshed what-if on
its 8 virtual CPU devices (tests/conftest.py), on the CPU at small sizes.

The port's mesh here is N CPU devices (a block of S / N scenarios each).
Inputs are made from seeds by the JAX package's generators and carried into
the port as numpy arrays (tests/torch_port_case.py). Assignments and placed
counts are compared exactly; the state planes of the meshed and unsplit
port runs exactly too, and ``utilization_cpu`` against the JAX engine
within 1e-3, assert_parity's tolerance on ``used`` (tests/test_jax_parity.py).
"""

import dataclasses
import logging

import jax
import numpy as np
import pytest
import torch

from kubernetes_simulator_tpu.framework.framework import FrameworkConfig as J_Config
from kubernetes_simulator_tpu.models.encode import encode
from kubernetes_simulator_tpu.parallel.mesh import fit_population as j_fit_population
from kubernetes_simulator_tpu.parallel.mesh import make_mesh as j_make_mesh
from kubernetes_simulator_tpu.sim import whatif as J
from kubernetes_simulator_tpu.sim.greedy import greedy_replay
from kubernetes_simulator_tpu.sim.synthetic import make_cluster, make_workload
from kubernetes_simulator_tpu_torch.framework.framework import FrameworkConfig
from kubernetes_simulator_tpu_torch.parallel.mesh import fit_population, make_mesh
from kubernetes_simulator_tpu_torch.sim import whatif as T

from torch_port_case import port_case

UTIL_ATOL = 1e-3


def small_case(seed=0, n=15, p=80, **kw):
    """tests/test_whatif.py's case."""
    cluster = make_cluster(n, seed=seed, taint_fraction=0.1)
    pods, _ = make_workload(p, seed=seed, with_affinity=True, with_spread=True,
                            with_tolerations=True, **kw)
    return encode(cluster, pods)


def port_scenarios(scen):
    return [T.Scenario([T.Perturbation(**dataclasses.asdict(pt)) for pt in sc.perturbations])
            for sc in scen]


def cpu_mesh(n):
    return make_mesh(devices=["cpu"] * n)


def assert_same_tables(meshed, unsplit):
    """Every block's state planes equal the unsplit batch's rows."""
    tbs = meshed.last_tables
    for f in ("used", "match_count", "anti_active", "pref_wsum"):
        got = torch.cat([getattr(tb.state, f) for tb in tbs])
        assert torch.equal(got, getattr(unsplit.last_tables.state, f)), f


def labels_case(**kw):
    """tests/test_whatif.py::test_labels_dirty_mesh_matches_unsharded's
    batch: 8 scenarios, 7 of them relabelling two nodes' zones."""
    ec, ep = small_case(seed=11, n=16, p=64, **kw)
    zkey = "topology.kubernetes.io/zone"
    rng = np.random.default_rng(11)
    scen = [J.Scenario()] + [
        J.Scenario([J.Perturbation("set_label", nodes=rng.choice(16, 2, replace=False),
                                   key=zkey, value=f"zone-{rng.integers(0, 8)}")])
        for _ in range(7)
    ]
    return ec, ep, scen


@pytest.fixture(scope="module")
def plain_batch():
    """tests/test_whatif.py::test_mesh_sharded_matches_unsharded's batch:
    (the port's case, its scenarios, the JAX engine's result over its
    8-device mesh, the port's unsplit engine after its run and result)."""
    assert len(jax.devices()) == 8
    ec, ep = small_case(seed=7)
    scen = J.uniform_scenarios(ec, 16, seed=7)
    jres = J.WhatIfEngine(ec, ep, scen, J_Config(), mesh=j_make_mesh(),
                          collect_assignments=True).run()
    pec, pep = port_case(ec, ep)
    tscen = port_scenarios(scen)
    one = T.WhatIfEngine(pec, pep, tscen, FrameworkConfig(), collect_assignments=True,
                         device="cpu")
    return pec, pep, tscen, jres, one, one.run()


@pytest.mark.parametrize("ndev", [8, 2])
def test_mesh_matches_reference_mesh_and_unsplit(plain_batch, ndev):
    """The port over N CPU devices == the port unsplit == the JAX engine
    over its 8-device mesh."""
    pec, pep, tscen, jres, one, want = plain_batch
    eng = T.WhatIfEngine(pec, pep, tscen, FrameworkConfig(), collect_assignments=True,
                         device="cpu", mesh=cpu_mesh(ndev))
    res = eng.run()
    assert len(eng._blocks) == ndev and [b.hi - b.lo for b in eng._blocks] == [16 // ndev] * ndev
    np.testing.assert_array_equal(res.assignments, want.assignments)
    np.testing.assert_array_equal(res.assignments, jres.assignments)
    np.testing.assert_array_equal(res.placed, jres.placed)
    np.testing.assert_allclose(res.utilization_cpu, jres.utilization_cpu, atol=UTIL_ATOL)
    assert_same_tables(eng, one)
    assert (res.n_devices, res.mesh_shape) == (ndev, {"scenarios": ndev})
    assert (jres.n_devices, jres.mesh_shape) == (8, {"scenarios": 8})
    assert res.completions_on == jres.completions_on == want.completions_on


@pytest.fixture(scope="module")
def labels_batch():
    """(the port's case, scenarios, the JAX engine's assignments, the port's
    unsplit engine after its run) of :func:`labels_case`."""
    ec, ep, scen = labels_case()
    jres = J.WhatIfEngine(ec, ep, scen, J_Config(), chunk_waves=4,
                          collect_assignments=True).run()
    pec, pep = port_case(ec, ep)
    tscen = port_scenarios(scen)
    one = T.WhatIfEngine(pec, pep, tscen, FrameworkConfig(), chunk_waves=4,
                         collect_assignments=True, device="cpu")
    one.run()
    return pec, pep, tscen, jres.assignments, one


@pytest.mark.parametrize("ndev", [8, 2])
def test_labels_dirty_mesh_matches_unsplit(labels_batch, ndev):
    """The DynTables batch over N devices (8: blocks of one scenario) ==
    the port unsplit == the JAX engine; both stay v3 with label rows."""
    pec, pep, tscen, want, one = labels_batch
    eng = T.WhatIfEngine(pec, pep, tscen, FrameworkConfig(), chunk_waves=4,
                         collect_assignments=True, device="cpu", mesh=cpu_mesh(ndev))
    assert eng.engine == "v3" and eng.sset.labels_dirty
    res = eng.run()
    # Each block reads its scenarios' label rows out of the shared tables.
    lrows = torch.cat([b.engine._cluster.lrow for b in eng._blocks])
    assert lrows.tolist() == eng.sset.lrow_host.tolist()
    np.testing.assert_array_equal(res.assignments, want)
    unsplit = T.assignments_from_choices(one.plan, one.last_choices, pep.bound_node)[0]
    np.testing.assert_array_equal(res.assignments, unsplit)
    assert_same_tables(eng, one)


def test_labels_dirty_mesh_leaves_the_device_release_path():
    """With durations, a DynTables batch under a mesh runs arrivals-only
    with the reference's warning (sim/whatif.py:981-997), and raises it
    under completions=True."""
    ec, ep, scen = labels_case(duration_mean=2.0)
    with pytest.warns(UserWarning) as jw:
        J.WhatIfEngine(ec, ep, scen, J_Config(), chunk_waves=4, mesh=j_make_mesh())
    pec, pep = port_case(ec, ep)
    tscen = port_scenarios(scen)
    with pytest.warns(UserWarning) as tw:
        eng = T.WhatIfEngine(pec, pep, tscen, FrameworkConfig(), chunk_waves=4, device="cpu",
                             mesh=cpu_mesh(2))
    msg = lambda w: [str(x.message) for x in w if "ARRIVALS-ONLY" in str(x.message)]
    assert msg(tw) == msg(jw) and "(mesh" in msg(tw)[0]
    res = eng.run()
    assert not res.completions_on
    want = T.WhatIfEngine(pec, pep, tscen, FrameworkConfig(), chunk_waves=4, device="cpu",
                          completions=False).run()
    np.testing.assert_array_equal(res.placed, want.placed)
    with pytest.raises(ValueError, match="ARRIVALS-ONLY"):
        T.WhatIfEngine(pec, pep, tscen, FrameworkConfig(), chunk_waves=4, device="cpu",
                       mesh=cpu_mesh(2), completions=True)


def test_tier_with_completions_under_a_mesh_is_arrivals_only():
    """Tier preemption with completions turns arrivals-only under a mesh,
    loudly, with the reference's message (sim/whatif.py:979-980); the
    meshed batch places as the unsplit one with completions off, and the
    victims per scenario come back in scenario order."""
    # tests/test_torch_preempt_whatif.py's contended trace: evictions fire.
    cluster = make_cluster(8, seed=2, taint_fraction=0.2)
    pods, _ = make_workload(400, seed=2, with_spread=True, with_tolerations=True,
                            duration_mean=20.0, arrival_rate=12.0)
    ec, ep = encode(cluster, pods)
    scen = J.uniform_scenarios(ec, 4, seed=2)
    with pytest.warns(UserWarning) as jw:
        J.WhatIfEngine(ec, ep, scen, J_Config(), chunk_waves=4, preemption="tier",
                       mesh=j_make_mesh(4))
    pec, pep = port_case(ec, ep)
    tscen = port_scenarios(scen)
    with pytest.warns(UserWarning) as tw:
        eng = T.WhatIfEngine(pec, pep, tscen, FrameworkConfig(), chunk_waves=4, device="cpu",
                             preemption="tier", mesh=cpu_mesh(2))
    msg = lambda w: [str(x.message) for x in w if "ARRIVALS-ONLY" in str(x.message)]
    assert msg(tw) == msg(jw) and "device tier preemption under a mesh" in msg(tw)[0]
    res = eng.run()
    want = T.WhatIfEngine(pec, pep, tscen, FrameworkConfig(), chunk_waves=4, device="cpu",
                          preemption="tier", completions=False).run()
    assert not res.completions_on
    np.testing.assert_array_equal(res.placed, want.placed)
    np.testing.assert_array_equal(res.preemptions, want.preemptions)
    assert want.preemptions.sum() > 0
    with pytest.raises(ValueError, match="device tier preemption under a mesh"):
        T.WhatIfEngine(pec, pep, tscen, FrameworkConfig(), chunk_waves=4, device="cpu",
                       preemption="tier", mesh=cpu_mesh(2), completions=True)


def test_retry_buffer_under_a_mesh():
    """The retry buffer runs under a mesh, as the reference's (its retry
    what-if needs only the device-release path): drops and the retry
    records in scenario order, each block its own buffers."""
    ec, ep = small_case(seed=3, n=6, p=120, duration_mean=2.0, arrival_rate=40.0)
    pec, pep = port_case(ec, ep)
    tscen = port_scenarios(J.uniform_scenarios(ec, 4, seed=3))
    one = T.WhatIfEngine(pec, pep, tscen, FrameworkConfig(), chunk_waves=2, device="cpu",
                         retry_buffer=16)
    want = one._run()
    eng = T.WhatIfEngine(pec, pep, tscen, FrameworkConfig(), chunk_waves=2, device="cpu",
                         retry_buffer=16, mesh=cpu_mesh(4))
    got = eng._run()
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])
    rnode = torch.cat([tb.retry.rnode for tb in got[0]])
    assert torch.equal(rnode, want[0].retry.rnode) and bool((rnode >= 0).any())
    res = eng.run()
    np.testing.assert_array_equal(res.retry_dropped, one.run().retry_dropped)


def test_divisibility_error_equals_reference():
    ec, ep = small_case(seed=7)
    scen = J.uniform_scenarios(ec, 6, seed=7)
    with pytest.raises(ValueError) as je:
        J.WhatIfEngine(ec, ep, scen, J_Config(), mesh=j_make_mesh())
    pec, pep = port_case(ec, ep)
    with pytest.raises(ValueError) as te:
        T.WhatIfEngine(pec, pep, port_scenarios(scen), FrameworkConfig(), device="cpu",
                       mesh=cpu_mesh(8))
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("pop,per,ndev", [(5, 3, 8), (2, 1, 2), (16, 4, 8), (7, 2, 3),
                                          (1, 5, 8), (3, 4, 1)])
def test_fit_population_equals_reference(pop, per, ndev, caplog):
    with caplog.at_level(logging.INFO):
        want = j_fit_population(pop, per, j_make_mesh(ndev))
        got = fit_population(pop, per, cpu_mesh(ndev))
    assert got == want
    lines = [r.getMessage() for r in caplog.records if "fit_population" in r.getMessage()]
    assert len(lines) == (2 if got != pop else 0) and len(set(lines)) <= 1


def test_config5_scale_1024_scenarios_mesh():
    """[BASELINE] config #5's scenario count: 1,024 scenarios over 8 CPU
    devices (blocks of 128) at 12 x 48 (tests/test_whatif.py's case);
    scenario 0 equals the single-replay anchor (the JAX package's
    greedy_replay, which its JaxReplayEngine equals exactly:
    tests/test_jax_parity.py), and the batch places as the port unsplit."""
    ec, ep = small_case(seed=9, n=12, p=48)
    pec, pep = port_case(ec, ep)
    scen = T.uniform_scenarios(pec, 1024, seed=9)
    res = T.WhatIfEngine(pec, pep, scen, FrameworkConfig(), chunk_waves=4, device="cpu",
                         mesh=cpu_mesh(8)).run()
    assert res.placed.shape == (1024,) and int(res.placed[0]) > 0
    single = greedy_replay(ec, ep, J_Config())
    assert int(res.placed[0]) == int((single.assignments[ep.bound_node == -1] >= 0).sum())
    want = T.WhatIfEngine(pec, pep, scen, FrameworkConfig(), chunk_waves=4,
                          device="cpu").run()
    np.testing.assert_array_equal(res.placed, want.placed)


def test_make_mesh_devices_and_refusal(monkeypatch):
    assert make_mesh(devices=["cpu"] * 3, num_devices=2) == [torch.device("cpu")] * 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        make_mesh()
    with pytest.raises(ValueError, match="at least one"):
        make_mesh(devices=[])


def test_meshed_tuner_equals_unmeshed_at_the_padded_population():
    """tune.mesh: the population is padded as the reference pads it
    (3 x 2 train scenarios over 4 devices -> 4), the flat axis splits into
    blocks of 2 rows, and the search equals the unmeshed one at the padded
    population: the same draws, so the same trajectory (the port's
    unmeshed tuner is held against the JAX package's in
    tests/test_torch_tuner.py)."""
    from kubernetes_simulator_tpu_torch.sim import tuner as TT

    ec, ep = small_case(seed=2, n=8, p=40)
    pec, pep = port_case(ec, ep)
    common = dict(rounds=2, seed=1, train_scenarios=2, heldout_scenarios=2, scenario_seed=0,
                  chunk_waves=4, cpu_oracle=False, device="cpu")
    meshed = TT.PolicyTuner(pec, pep, FrameworkConfig(), population=3, mesh=cpu_mesh(4),
                            **common)
    tres = meshed.run()
    want = TT.PolicyTuner(pec, pep, FrameworkConfig(), population=4, **common).run()
    assert (tres.population, tres.population_requested, want.population) == (4, 3, 4)
    assert (tres.n_devices, tres.mesh_shape) == (4, {"scenarios": 4})
    assert [b.hi - b.lo for b in meshed._train_engine._blocks] == [2] * 4
    assert tres.trajectory == want.trajectory
    np.testing.assert_array_equal(tres.best_vector, want.best_vector)


def test_config5_parses_like_the_reference():
    """examples/config5_multitenant_mesh.yaml: the scenario mesh and the
    extended resource parse as the JAX package parses them."""
    from pathlib import Path

    from kubernetes_simulator_tpu.utils.config import SimConfig as J_SimConfig
    from kubernetes_simulator_tpu_torch.utils.config import SimConfig, config_errors

    path = str(Path(__file__).resolve().parent.parent / "examples"
               / "config5_multitenant_mesh.yaml")
    got, want = SimConfig.load(path), J_SimConfig.load(path)
    assert dataclasses.asdict(got.whatif) == dataclasses.asdict(want.whatif)
    assert got.whatif.mesh and got.whatif.scenarios == 1024
    assert dataclasses.asdict(got.cluster) == dataclasses.asdict(want.cluster)
    assert dataclasses.asdict(got.workload) == dataclasses.asdict(want.workload)
    assert config_errors(got) == []


def test_blocks_sharing_a_card_plan_for_their_share(monkeypatch):
    """Two blocks of 64 scenarios on one card of 132 SMs: alone, a block
    would plan K6 as clusters of two (128 blocks, the card full); under
    sm_share(2) each plans clusters of one, so the two fill the card
    together as the unsplit batch of 128 does."""
    from types import SimpleNamespace

    from kubernetes_simulator_tpu_torch.ops import kernels as K

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: SimpleNamespace(multi_processor_count=132))
    tb = lambda S: SimpleNamespace(state=SimpleNamespace(used=torch.zeros(S, 2000, 2)))
    assert (K.select_plan("chunk_replay", tb(64)).C, K.select_plan("chunk_replay", tb(128)).C
            ) == (2, 1)
    with K.sm_share(2):
        assert K.select_plan("chunk_replay", tb(64)).C == 1
    assert K.select_plan("chunk_replay", tb(64)).C == 2
