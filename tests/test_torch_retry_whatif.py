"""The unschedulable-retry buffer in the port's scenario-batched what-if
(``WhatIfEngine(retry_buffer=...)``) against the JAX package, on the CPU
at small sizes.

Every case of tests/test_retry_device.py is held against the JAX
``WhatIfEngine(retry_buffer=...)`` (per-scenario ``placed`` and
``retry_dropped``) and, per scenario, against ``greedy_replay(retry_buffer
=...)`` on that scenario's perturbed cluster (the JAX ScenarioSet's
``host_clusters``), with the port's assignments read through the engine's
``_run()``: under the buffer the what-if collects no assignments, as in
the reference. Inputs come from seeds through the JAX package's
generators, carried into the port as numpy arrays
(tests/torch_port_case.py). Every comparison is exact."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from kubernetes_simulator_tpu.framework.framework import FrameworkConfig as J_Config
from kubernetes_simulator_tpu.models.core import (
    Cluster,
    LabelSelector,
    Node,
    Pod,
    TopologySpreadConstraint,
)
from kubernetes_simulator_tpu.models.encode import PAD, encode
from kubernetes_simulator_tpu.sim import whatif as J
from kubernetes_simulator_tpu.sim.greedy import greedy_replay
from kubernetes_simulator_tpu.sim.synthetic import make_cluster, make_workload
from kubernetes_simulator_tpu_torch.framework.framework import FrameworkConfig
from kubernetes_simulator_tpu_torch.sim import whatif as T
from kubernetes_simulator_tpu_torch.sim.torch_runtime import TorchReplayEngine

from torch_port_case import port_case

FIT_ONLY = [{"name": "NodeResourcesFit"}]


@pytest.fixture(autouse=True)
def _deterministic():
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


def port_scenarios(scen):
    return [
        T.Scenario([T.Perturbation(**dataclasses.asdict(pt)) for pt in sc.perturbations])
        for sc in scen
    ]


def run_port(ec, ep, scen, plugins=None, **kw):
    """(result, assignments [S, P]) of the port's batch; the case is a
    carried copy taken before the JAX package interns anything."""
    pec, pep = port_case(ec, ep)
    eng = T.WhatIfEngine(pec, pep, port_scenarios(scen), FrameworkConfig(plugins=plugins),
                         device="cpu", **kw)
    res = eng.run()
    _, _, assignments, placed, _ = eng._run()
    np.testing.assert_array_equal(placed, res.placed)
    return res, assignments


def run_jax(ec, ep, scen, plugins=None, **kw):
    return J.WhatIfEngine(ec, ep, scen, J_Config(plugins=plugins), **kw).run()


def hold_against_greedy(ec, ep, scen, assignments, res, plugins=None, W=8, C=1024, RB=0):
    """Each scenario's assignments, placed and drops == greedy_replay on
    its perturbed cluster."""
    clusters = J.ScenarioSet(ec, scen, keep_host_stacks=True).host_clusters(ec)
    for s, ecs in enumerate(clusters):
        a = greedy_replay(ecs, ep, J_Config(plugins=plugins), wave_width=W,
                          completions_chunk_waves=C, retry_buffer=RB)
        bad = np.nonzero(assignments[s] != a.assignments)[0]
        assert bad.size == 0, (s, bad[:5], assignments[s][bad[:5]], a.assignments[bad[:5]])
        assert int(res.placed[s]) == a.placed, s
        assert int(res.retry_dropped[s]) == a.retry_dropped, s


def both(ec, ep, scen, plugins=None, W=8, C=1024, RB=0):
    """Port vs the JAX what-if (placed, drops) and vs greedy per scenario."""
    res, assignments = run_port(ec, ep, scen, plugins, wave_width=W, chunk_waves=C,
                                retry_buffer=RB)
    jres = run_jax(ec, ep, scen, plugins, wave_width=W, chunk_waves=C, retry_buffer=RB)
    np.testing.assert_array_equal(res.placed, jres.placed)
    np.testing.assert_array_equal(res.retry_dropped, jres.retry_dropped)
    hold_against_greedy(ec, ep, scen, assignments, res, plugins, W, C, RB)
    return res, assignments


def _contended(seed=11, pods=120, nodes=3, **kw):
    cluster = make_cluster(nodes, seed=seed)
    workload, _ = make_workload(pods, seed=seed, arrival_rate=60.0, duration_mean=1.5,
                                with_spread=True, with_tolerations=True, **kw)
    return encode(cluster, workload)


# -- the cases of tests/test_retry_device.py ----------------------------------------


def test_retry_places_after_release_tiny():
    cluster = Cluster(nodes=[Node("n0", {"cpu": 1})])
    pods = [
        Pod("a", requests={"cpu": 1}, arrival_time=0.0, duration=3.0),
        Pod("b", requests={"cpu": 1}, arrival_time=1.0),
        Pod("f1", requests={}, arrival_time=6.0),
        Pod("f2", requests={}, arrival_time=8.0),
    ]
    ec, ep = encode(cluster, pods)
    res, a = both(ec, ep, [J.Scenario()], FIT_ONLY, W=1, C=1, RB=1)
    assert a[0, 1] == 0 and int(res.placed[0]) == 4
    off, _ = run_port(ec, ep, [J.Scenario()], FIT_ONLY, wave_width=1, chunk_waves=1)
    assert int(off.placed[0]) == 3


def test_retry_parity_random_contended():
    ec, ep = _contended()
    res, a = both(ec, ep, [J.Scenario()], W=4, C=4, RB=8)
    off, a_off = run_port(ec, ep, [J.Scenario()], wave_width=4, chunk_waves=4)
    assert int(res.placed[0]) > int(off.placed[0])
    assert ((a[0] >= 0) & (a_off[0] == PAD)).any()


def test_retry_buffer_overflow_drops_newest():
    cluster = Cluster(nodes=[Node("n0", {"cpu": 1})])
    pods = [
        Pod("a", requests={"cpu": 1}, arrival_time=0.0, duration=2.0),
        Pod("b", requests={"cpu": 1}, arrival_time=0.5, duration=100.0),
        Pod("c", requests={"cpu": 1}, arrival_time=0.6, duration=100.0),
        Pod("f1", requests={}, arrival_time=5.0),
        Pod("f2", requests={}, arrival_time=8.0),
    ]
    ec, ep = encode(cluster, pods)
    res, a = both(ec, ep, [J.Scenario()], FIT_ONLY, W=1, C=1, RB=1)
    assert a[0, 1] == 0 and a[0, 2] == PAD
    assert int(res.placed[0]) == 4 and int(res.retry_dropped[0]) == 1


def test_retry_placed_pod_releases_later():
    cluster = Cluster(nodes=[Node("n0", {"cpu": 1})])
    pods = [
        Pod("a", requests={"cpu": 1}, arrival_time=0.0, duration=2.0),
        Pod("b", requests={"cpu": 1}, arrival_time=0.5, duration=1.0),
        Pod("f1", requests={}, arrival_time=4.0),
        Pod("f2", requests={}, arrival_time=6.0),
        Pod("c", requests={"cpu": 1}, arrival_time=5.0),
        Pod("f3", requests={}, arrival_time=8.0),
        Pod("f4", requests={}, arrival_time=10.0),
        Pod("f5", requests={}, arrival_time=12.0),
    ]
    ec, ep = encode(cluster, pods)
    res, a = both(ec, ep, [J.Scenario()], FIT_ONLY, W=1, C=1, RB=2)
    assert a[0, 1] == 0 and a[0, 4] == 0


def test_retry_gang_pods_excluded():
    cluster = Cluster(nodes=[Node("n0", {"cpu": 2})])
    pods = [
        Pod("a", requests={"cpu": 2}, arrival_time=0.0, duration=2.0),
        Pod("g0", requests={"cpu": 1}, arrival_time=0.5, pod_group="g"),
        Pod("g1", requests={"cpu": 1}, arrival_time=0.5, pod_group="g"),
        Pod("s", requests={"cpu": 1}, arrival_time=0.7),
        Pod("f1", requests={}, arrival_time=5.0),
        Pod("f2", requests={}, arrival_time=8.0),
        Pod("f3", requests={}, arrival_time=10.0),
    ]
    ec, ep = encode(cluster, pods)
    res, a = both(ec, ep, [J.Scenario()], FIT_ONLY, W=2, C=1, RB=2)
    assert a[0, 3] == 0 and a[0, 1] == PAD and a[0, 2] == PAD


def test_retry_multi_scenario_counts():
    """Perturbed scenarios (capacity cut, node loss, an injected taint)
    run the retry machinery per scenario; every scenario equals the JAX
    what-if and greedy_replay on its perturbed cluster."""
    cluster = make_cluster(6, seed=13, taint_fraction=0.2)
    workload, _ = make_workload(100, seed=13, arrival_rate=25.0, duration_mean=1.2,
                                with_spread=True, with_tolerations=True)
    ec, ep = encode(cluster, workload)
    scen = [
        J.Scenario(),
        J.Scenario([J.Perturbation("scale_capacity", nodes=np.arange(3), resource="cpu",
                                   factor=0.5)]),
        J.Scenario([J.Perturbation("node_down", nodes=np.arange(2))]),
        J.Scenario([J.Perturbation("add_taint", nodes=np.arange(1, 4), key="whatif/k",
                                   value="v", effect="NoSchedule")]),
    ]
    res, a = both(ec, ep, scen, W=4, C=4, RB=8)
    assert int(res.placed[1]) <= int(res.placed[0])
    assert len({row.tobytes() for row in a}) == len(scen)


def test_retry_full_plugin_envelope_parity():
    """Anti/pref count planes, multi-topology spread and hostname rows."""
    cluster = make_cluster(3, seed=23)
    workload, _ = make_workload(150, seed=23, arrival_rate=60.0, duration_mean=1.5,
                                with_affinity=True, with_spread=True, with_tolerations=True)
    ec, ep = encode(cluster, workload)
    res, _ = both(ec, ep, [J.Scenario()], W=4, C=4, RB=8)
    off, _ = run_port(ec, ep, [J.Scenario()], wave_width=4, chunk_waves=4)
    assert int(res.placed[0]) > int(off.placed[0])


@pytest.mark.parametrize(
    "what",
    ["no durations", "completions=False", "collect_assignments", "preemption", "fork"],
)
def test_retry_requires_device_release_path(what):
    """The reference's refusals, with its message."""
    if what == "no durations":
        ec, ep = encode(make_cluster(4, seed=0), make_workload(16, seed=0)[0])
        kw = {}
    else:
        ec, ep = _contended()
        kw = {"completions=False": dict(completions=False),
              "collect_assignments": dict(collect_assignments=True),
              "preemption": dict(preemption=True),
              "fork": dict(fork_checkpoint="fork.npz")}[what]
    pec, pep = port_case(ec, ep)
    with pytest.raises(ValueError, match="retry_buffer requires"):
        T.WhatIfEngine(pec, pep, [T.Scenario()], device="cpu", retry_buffer=8, **kw)
    if what in ("no durations", "collect_assignments"):
        with pytest.raises(ValueError, match="retry_buffer requires"):
            J.WhatIfEngine(ec, ep, [J.Scenario()], J_Config(), retry_buffer=8, **kw)


# -- further cases ------------------------------------------------------------------


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_uniform_scenarios_overflowing_buffer(seed):
    """uniform_scenarios over a cut cluster: buffers fill and overflow in
    most scenarios, the pending list carries releases, gangs roll back."""
    cluster = make_cluster(3, seed=seed, taint_fraction=0.2)
    workload, _ = make_workload(200, seed=seed, arrival_rate=120.0, duration_mean=3.0,
                                with_affinity=True, with_spread=True, with_tolerations=True,
                                gang_fraction=0.05, gang_size=2)
    ec, ep = encode(cluster, workload)
    scen = J.uniform_scenarios(ec, 4, seed=seed, p_node_down=0.5, p_capacity=0.5, p_taint=0.5)
    res, _ = both(ec, ep, scen, W=4, C=3, RB=8)
    assert (res.retry_dropped > 0).sum() >= 2


def test_single_scenario_equals_replay():
    ec, ep = _contended(pods=200)
    pec, pep = port_case(ec, ep)
    kw = dict(wave_width=4, chunk_waves=4, retry_buffer=8, device="cpu")
    eng = T.WhatIfEngine(pec, pep, [T.Scenario()], FrameworkConfig(), **kw)
    res = eng.run()
    assert res.assignments is None
    _, _, a, _, _ = eng._run()
    r = TorchReplayEngine(pec, pep, FrameworkConfig(), **kw).replay()
    np.testing.assert_array_equal(a[0], r.assignments)
    assert int(res.placed[0]) == r.placed and int(res.retry_dropped[0]) == r.retry_dropped > 0


def test_host_scale_domains_run_where_the_reference_refuses():
    """A topology with more than 128 domains of two nodes each: the JAX
    what-if refuses the buffer (its TPU host-row layout), the port runs it
    and equals greedy_replay, as JaxReplayEngine's host pass does."""
    from kubernetes_simulator_tpu.sim.jax_runtime import JaxReplayEngine

    nodes = [Node(f"n{i}", {"cpu": 1}, labels={"rack": f"r{i // 2}"}) for i in range(260)]
    sel = LabelSelector.make({"app": "a"})
    spread = [TopologySpreadConstraint(1, "rack", "DoNotSchedule", sel)]
    rng = np.random.default_rng(0)
    pods = [Pod(f"p{i}", labels={"app": "a"}, requests={"cpu": 1}, arrival_time=0.02 * i,
                duration=float(rng.uniform(2.0, 30.0)), topology_spread=list(spread))
            for i in range(600)]
    ec, ep = encode(Cluster(nodes=nodes), pods)
    kw = dict(wave_width=8, chunk_waves=4, retry_buffer=16)
    res, a = run_port(ec, ep, [J.Scenario()], **kw)
    with pytest.raises(ValueError, match="retry_buffer requires"):
        run_jax(ec, ep, [J.Scenario()], **kw)
    want = greedy_replay(ec, ep, J_Config(), wave_width=8, completions_chunk_waves=4,
                         retry_buffer=16)
    np.testing.assert_array_equal(a[0], want.assignments)
    assert int(res.placed[0]) == want.placed and int(res.retry_dropped[0]) == want.retry_dropped
    host = JaxReplayEngine(ec, ep, J_Config(), **kw).replay()
    assert host.placed == want.placed
    off, _ = run_port(ec, ep, [J.Scenario()], wave_width=8, chunk_waves=4)
    assert int(off.placed[0]) != int(res.placed[0])


def test_default_device_is_cuda_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ec, ep = _contended()
    pec, pep = port_case(ec, ep)
    with pytest.raises(RuntimeError, match="cuda"):
        T.WhatIfEngine(pec, pep, [T.Scenario()], retry_buffer=8)


def test_cli_what_if_rows_equal_jax_rows(tmp_path, capsys):
    """examples/config7_retry_completions.yaml cut to 8 scenarios x 12
    nodes x 1,600 pods, chunkWaves 16 and retryBuffer 32 (over-committed:
    buffers fill and overflow): the port's what-if rows equal the JAX
    CLI's, and retry changes the placements."""
    import yaml

    from kubernetes_simulator_tpu import cli as J_cli
    from kubernetes_simulator_tpu_torch import cli

    d = yaml.safe_load(open("examples/config7_retry_completions.yaml"))
    d["cluster"]["synthetic"]["nodes"] = 12
    d["workload"]["synthetic"]["pods"] = 1600
    d["whatIf"].update(scenarios=8, retryBuffer=32)
    d["chunkWaves"] = 16
    cfg = tmp_path / "c7.yaml"
    cfg.write_text(yaml.safe_dump(d))

    def rows(main):
        capsys.readouterr()
        assert main(["what-if", str(cfg)] + (["--device", "cpu"] if main is cli.main else [])) == 0
        out = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
        drop = {"ts", "engine", "device", "wall_clock_s", "placements_per_sec"}
        return [{k: v for k, v in r.items() if k not in drop} for r in out]

    got, want = rows(cli.main), rows(J_cli.main)
    assert got == want
    d["whatIf"]["retryBuffer"] = 0
    cfg.write_text(yaml.safe_dump(d))
    off = rows(cli.main)
    assert [r.get("placed") for r in off] != [r.get("placed") for r in got]
