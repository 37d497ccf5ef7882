"""Tier preemption × completions in the port's scenario-batched what-if,
WhatIfEngine(device="cpu", preemption=True), against the greedy anchor.

The case is tests/test_whatif_preempt_completions.py's ``_contended()``
trace (8 nodes, 400 pods with spread and tolerations, durationMean 20,
chunks of 4 waves: evictions fire and completions move placements), run
as one batch of unperturbed, node_down, scale_capacity and add_taint
scenarios. Each scenario's assignments, ``placed`` and ``preemptions``
must equal ``greedy_replay(preemption=True, completions_chunk_waves=4)``
on its perturbed cluster exactly. One smaller case is also held against
the JAX WhatIfEngine (its preemption suites are marked slow); the guards
raise the reference's errors."""

import numpy as np
import pytest
import torch

from kubernetes_simulator_tpu.framework.framework import FrameworkConfig as J_Config
from kubernetes_simulator_tpu.models.core import Cluster, Node, Pod, Taint
from kubernetes_simulator_tpu.models.encode import encode
from kubernetes_simulator_tpu.sim.greedy import greedy_replay
from kubernetes_simulator_tpu.sim.synthetic import make_cluster, make_workload
from kubernetes_simulator_tpu_torch.framework.framework import FrameworkConfig
from kubernetes_simulator_tpu_torch.sim import whatif as T
from kubernetes_simulator_tpu_torch.sim.torch_runtime import TorchReplayEngine

from torch_port_case import port_case

C = 4  # chunk waves of the contended trace


@pytest.fixture(autouse=True)
def _deterministic():
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


def _pods(seed, pods_n):
    return make_workload(pods_n, seed=seed, with_spread=True, with_tolerations=True,
                         duration_mean=20.0, arrival_rate=12.0)[0]


def _cluster(seed, nodes, perturb=None):
    """make_cluster with one scenario's perturbation applied to the object
    model: ("node_down", idx), ("cpu", idx, factor) or ("taint", idx)."""
    cluster = make_cluster(nodes, seed=seed, taint_fraction=0.2)
    if perturb is not None:
        op, idx = perturb[0], perturb[1]
        for i in idx:
            node = cluster.nodes[i]
            if op == "node_down":
                node.allocatable = {k: 0.0 for k in node.allocatable}
            elif op == "cpu":
                node.allocatable = {k: (v * perturb[2] if k == "cpu" else v)
                                    for k, v in node.allocatable.items()}
            else:
                node.taints.append(Taint("whatif/k", "v", "NoSchedule"))
    return cluster


SCENARIOS = [
    (None, T.Scenario()),
    (("node_down", [0, 1]), T.Scenario([T.Perturbation("node_down", nodes=np.arange(2))])),
    (("cpu", [0, 1, 2], 0.5), T.Scenario([T.Perturbation(
        "scale_capacity", nodes=np.arange(3), resource="cpu", factor=0.5)])),
    (("taint", [0, 1]), T.Scenario([T.Perturbation(
        "add_taint", nodes=np.arange(2), key="whatif/k", value="v", effect="NoSchedule")])),
    (None, T.Scenario()),
]


def test_contended_scenarios_match_anchor():
    seed, nodes, pods_n = 2, 8, 400
    pods = _pods(seed, pods_n)
    ec, ep = encode(_cluster(seed, nodes), pods)
    pec, pep = port_case(ec, ep)
    eng = T.WhatIfEngine(pec, pep, [s for _, s in SCENARIOS], FrameworkConfig(),
                         chunk_waves=C, preemption=True, collect_assignments=True, device="cpu")
    res = eng.run()
    assert res.completions_on
    for s, (perturb, _) in enumerate(SCENARIOS):
        ecs, eps = encode(_cluster(seed, nodes, perturb), pods)
        a = greedy_replay(ecs, eps, J_Config(), preemption=True, completions_chunk_waves=C)
        bad = np.nonzero(res.assignments[s] != a.assignments)[0]
        assert bad.size == 0, (s, bad[:5], res.assignments[s][bad[:5]], a.assignments[bad[:5]])
        assert int(res.placed[s]) == a.placed, s
        assert int(res.preemptions[s]) == a.preemptions, s
    assert res.preemptions[0] > 0  # evictions fire in the base scenario
    assert len({a.tobytes() for a in res.assignments}) > 2  # the scenarios differ
    # Completions move placements: the same batch without them differs.
    off = T.WhatIfEngine(pec, pep, [SCENARIOS[0][1]], FrameworkConfig(), chunk_waves=C,
                         preemption=True, completions=False, device="cpu").run()
    assert int(off.placed[0]) != int(res.placed[0])


def test_single_scenario_equals_replay_and_tally_equals_collect():
    seed, nodes, pods_n = 3, 8, 240
    ec, ep = encode(_cluster(seed, nodes), _pods(seed, pods_n))
    pec, pep = port_case(ec, ep)
    kw = dict(chunk_waves=C, preemption=True, device="cpu")
    w = T.WhatIfEngine(pec, pep, [T.Scenario()], FrameworkConfig(), collect_assignments=True,
                       **kw).run()
    r = TorchReplayEngine(pec, pep, FrameworkConfig(), **kw).replay()
    np.testing.assert_array_equal(w.assignments[0], r.assignments)
    assert int(w.placed[0]) == r.placed and int(w.preemptions[0]) == r.preemptions
    tally = T.WhatIfEngine(pec, pep, [T.Scenario()], FrameworkConfig(), **kw).run()
    assert tally.assignments is None
    np.testing.assert_array_equal(tally.placed, w.placed)
    np.testing.assert_array_equal(tally.preemptions, w.preemptions)


def test_matches_jax_whatif_engine():
    """tests/test_whatif_preempt_completions.py's perturbed case (300
    pods, a cpu cut and an injected taint), against the JAX WhatIfEngine."""
    from kubernetes_simulator_tpu.sim.whatif import Perturbation as JP
    from kubernetes_simulator_tpu.sim.whatif import Scenario as JS
    from kubernetes_simulator_tpu.sim.whatif import WhatIfEngine as J_WhatIf

    ec, ep = encode(_cluster(2, 8), _pods(2, 300))
    scen = lambda S, P: [
        S(), S([P("scale_capacity", nodes=np.arange(3), resource="cpu", factor=0.5)]),
        S([P("add_taint", nodes=np.arange(2), key="k", value="v", effect="NoSchedule")])]
    want = J_WhatIf(ec, ep, scen(JS, JP), J_Config(), chunk_waves=C, preemption=True,
                    collect_assignments=True).run()
    pec, pep = port_case(ec, ep)
    got = T.WhatIfEngine(pec, pep, scen(T.Scenario, T.Perturbation), FrameworkConfig(),
                         chunk_waves=C, preemption=True, collect_assignments=True,
                         device="cpu").run()
    np.testing.assert_array_equal(got.assignments, want.assignments)
    np.testing.assert_array_equal(got.placed, want.placed)
    assert got.completions_on == want.completions_on


def test_prebound_pods_refused():
    from kubernetes_simulator_tpu.sim.whatif import Scenario as JS
    from kubernetes_simulator_tpu.sim.whatif import WhatIfEngine as J_WhatIf

    nodes = [Node("n0", capacity={"cpu": 2.0, "memory": 4 * 2**30, "pods": 5})]
    pods = [Pod("pre", labels={}, requests={"cpu": 1.0}, priority=0, arrival_time=0.0,
                node_name="n0"),
            Pod("hi", labels={}, requests={"cpu": 2.0}, priority=10, arrival_time=1.0)]
    ec, ep = encode(Cluster(nodes=nodes), pods)
    msg = "what-if preemption does not support pre-bound pods"
    with pytest.raises(ValueError, match=msg):
        J_WhatIf(ec, ep, [JS()], J_Config(), preemption=True)
    pec, pep = port_case(ec, ep)
    with pytest.raises(ValueError, match=msg):
        T.WhatIfEngine(pec, pep, [T.Scenario()], device="cpu", preemption=True)
    # Without preemption the same trace runs.
    assert T.WhatIfEngine(pec, pep, [T.Scenario()], device="cpu").run().total_placed == 0


@pytest.mark.parametrize("kw,match", [(dict(engine="v2"), "v3 engine"),
                                      (dict(retry_buffer=8), "retry_buffer")])
def test_guards_raise_the_reference_errors(kw, match):
    ec, ep = encode(_cluster(2, 8), _pods(2, 40))
    pec, pep = port_case(ec, ep)
    with pytest.raises(ValueError, match=match):
        T.WhatIfEngine(pec, pep, [T.Scenario()], device="cpu", preemption=True, **kw)


def test_cli_what_if_with_device_preemption(tmp_path):
    """``what-if`` with ``devicePreemption: true``: the scenario rows carry
    ``preemptions``, scenario 0's equal to greedy_replay's."""
    import json

    import yaml

    from kubernetes_simulator_tpu.utils.config import SimConfig as J_SimConfig
    from kubernetes_simulator_tpu.utils.config import build_encoded_case
    from kubernetes_simulator_tpu_torch import cli

    d = {
        "devicePreemption": True,
        "cluster": {"synthetic": {"nodes": 8, "seed": 2, "taintFraction": 0.2}},
        "workload": {"synthetic": {"pods": 300, "seed": 2, "tolerations": True,
                                   "spread": True, "durationMean": 20.0,
                                   "arrivalRate": 12.0}},
        "chunkWaves": C,
        "whatIf": {"scenarios": 3, "seed": 1},
        "output": str(tmp_path / "out.jsonl"),
    }
    cfg = tmp_path / "w.yaml"
    cfg.write_text(yaml.safe_dump(d))
    assert cli.main(["what-if", str(cfg), "--device", "cpu"]) == 0
    rows = [json.loads(x) for x in (tmp_path / "out.jsonl").read_text().splitlines()]
    sc = [r for r in rows if r["kind"] == "whatif-scenario"]
    assert len(sc) == 3 and all("preemptions" in r for r in sc)
    jcfg = J_SimConfig.from_dict(d)
    ec, ep = build_encoded_case(jcfg)
    a = greedy_replay(ec, ep, jcfg.framework, preemption=True, completions_chunk_waves=C)
    assert sc[0]["placed"] == a.placed and sc[0]["preemptions"] == a.preemptions > 0
