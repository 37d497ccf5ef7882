"""The port's host evaluator (kubernetes_simulator_tpu_torch.sim.tuner
``PolicyTuner(evaluator="cpu")``, and ``"auto"`` with host terms) against
the JAX package's, on the CPU.

On examples/config12_utilization.yaml's trace (40 nodes x 1,100 pods, the
objective utilizationCpu with the latencyP99 <= 2 constraint: ``auto``
routes it to the host) at population 2 x 1 round x 2 train scenarios, both
tuners must give the same candidates, the same objective rows, the same
best vector and the same held-out row; the evaluator's resolution must
follow the reference's (tests/test_tuner.py:404); and on the reference's
latency-fragmentation family (tests/test_tuner.py:443) the latency
constraint must change the winner in the port as in the reference, with the
same trajectory. No card work is done: the train engine is never built."""

import os

import numpy as np
import pytest

from kubernetes_simulator_tpu.framework.framework import FrameworkConfig as J_Config
from kubernetes_simulator_tpu.models.core import Cluster, Node, Pod
from kubernetes_simulator_tpu.models.encode import encode
from kubernetes_simulator_tpu.sim import tuner as JT
from kubernetes_simulator_tpu.utils.config import SimConfig as J_SimConfig
from kubernetes_simulator_tpu.utils.config import build_encoded_case as j_build
from kubernetes_simulator_tpu_torch.framework.framework import FrameworkConfig
from kubernetes_simulator_tpu_torch.sim import tuner as TT
from kubernetes_simulator_tpu_torch.utils.config import SimConfig, build_encoded_case

from torch_port_case import assert_same, port_case

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG12 = os.path.join(ROOT, "examples", "config12_utilization.yaml")


def _kw(tu, population, rounds):
    return dict(
        algo=tu.algo, population=population, rounds=rounds, seed=tu.seed,
        elite_frac=tu.elite_frac, objective=tu.objective, constraints=tu.constraints,
        evaluator=tu.evaluator, train_scenarios=tu.train_scenarios,
        heldout_scenarios=tu.heldout_scenarios, scenario_seed=tu.scenario_seed,
        p_node_down=tu.node_down_p, p_capacity=tu.capacity_p, p_taint=tu.taint_p,
        cpu_oracle=tu.cpu_oracle, cpu_envelope=tu.cpu_envelope,
    )


def test_config12_host_evaluator_equals_reference():
    jcfg = J_SimConfig.load(CONFIG12)
    tcfg = SimConfig.load(CONFIG12)
    ec, ep = j_build(jcfg)
    pec, pep = build_encoded_case(tcfg)
    assert_same(pec, port_case(ec, ep)[0], "ec")
    assert_same(pep, port_case(ec, ep)[1], "ep")
    assert tcfg.tune.evaluator == jcfg.tune.evaluator == "auto"
    assert tcfg.tune.train_scenarios == 2
    want = JT.PolicyTuner(ec, ep, jcfg.framework, **_kw(jcfg.tune, 2, 1))
    got = TT.PolicyTuner(pec, pep, tcfg.framework, **_kw(tcfg.tune, 2, 1))
    assert want.evaluator == got.evaluator == "cpu"
    rw, rg = want.run(), got.run()
    assert rg.trajectory == rw.trajectory
    np.testing.assert_array_equal(rg.best_vector, rw.best_vector)
    assert rg.best_policy == rw.best_policy
    for f in ("train_objective", "heldout_objective", "default_heldout_objective",
              "evaluations", "cpu_objective", "cpu_envelope", "evaluator"):
        assert getattr(rg, f) == getattr(rw, f), f
    assert rg.compile_count is None and got._train_engine is None
    assert rg.trajectory[-1]["evaluator"] == "cpu"
    # The cache: the incumbent's train objective was computed once.
    assert len(got._host_cache) == len(want._host_cache)


def _fragmentation_case():
    nodes = [Node(f"n{i}", capacity={"cpu": 4.0, "memory": 16.0}) for i in range(4)]
    pods = [Pod(f"small-{i}", requests={"cpu": 1.0, "memory": 1.0}, arrival_time=float(i))
            for i in range(8)]
    pods += [Pod(f"large-{i}", requests={"cpu": 4.0, "memory": 4.0},
                 arrival_time=float(8 + i)) for i in range(2)]
    return encode(Cluster(nodes=nodes), pods)


@pytest.mark.parametrize("kw,want", [
    (dict(objective={"placementRate": 1.0}), "device"),
    (dict(objective={"utilizationCpu": 1.0},
          constraints=[{"metric": "latencyP99", "max": 1.0}]), "cpu"),
    (dict(objective={"strandedCpu": -1.0}), "cpu"),
    (dict(objective={"placementRate": 1.0}, evaluator="cpu"), "cpu"),
    (dict(objective={"latencyP99": -1.0}, evaluator="device"), "evaluator='cpu'"),
    (dict(evaluator="gpu"), "evaluator must be"),
])
def test_evaluator_resolution(kw, want):
    ec, ep = _fragmentation_case()
    pec, pep = port_case(ec, ep)
    if want in ("device", "cpu"):
        j = JT.PolicyTuner(ec, ep, J_Config(), population=2, rounds=1, **kw)
        t = TT.PolicyTuner(pec, pep, FrameworkConfig(), population=2, rounds=1, device="cpu",
                           **kw)
        assert j.evaluator == t.evaluator == want
        return
    for tuner, (e, p), cfg in ((JT.PolicyTuner, (ec, ep), J_Config()),
                               (TT.PolicyTuner, (pec, pep), FrameworkConfig())):
        with pytest.raises(ValueError, match=want):
            tuner(e, p, cfg, population=2, rounds=1, **kw)


def _latency_fragmentation_case():
    nodes = [Node(f"n{i}", capacity={"cpu": 4.0, "memory": 16.0}) for i in range(4)]
    pods = [Pod(f"small-{i}", requests={"cpu": 1.0, "memory": 1.0}, arrival_time=float(i),
                duration=20.0) for i in range(8)]
    pods += [Pod(f"large-{i}", requests={"cpu": 4.0, "memory": 4.0},
                 arrival_time=float(8 + i)) for i in range(2)]
    return encode(Cluster(nodes=nodes), pods)


def test_latency_constraint_changes_winner():
    """Unconstrained, the utilization objective ties everywhere and keeps the
    default LeastAllocated incumbent; under latencyP99 <= 1 the search finds
    MostAllocated: the port's trajectories equal the reference's."""
    ec, ep = _latency_fragmentation_case()
    pec, pep = port_case(ec, ep)
    kw = dict(algo="cem", population=4, rounds=2, seed=0, train_scenarios=2,
              heldout_scenarios=1, scenario_seed=1, p_node_down=0.0, p_capacity=0.0,
              p_taint=0.0, evaluator="cpu", objective={"utilizationCpu": 1.0})
    cons = dict(constraints=[{"metric": "latencyP99", "max": 1.0, "penalty": 1.0}])
    out = {}
    for name, extra in (("free", {}), ("constrained", cons)):
        j = JT.PolicyTuner(ec, ep, J_Config(), **kw, **extra).run()
        t = TT.PolicyTuner(pec, pep, FrameworkConfig(), **kw, **extra).run()
        assert t.trajectory == j.trajectory, name
        out[name] = t
    assert out["free"].best_policy["fitStrategy"] == "LeastAllocated"
    assert out["constrained"].best_policy["fitStrategy"] == "MostAllocated"
    assert out["constrained"].improved()
    assert out["constrained"].compile_count is None and out["constrained"].cpu_objective is None
    assert out["constrained"].trajectory[-1]["objective_constraints"] == [
        {"metric": "latencyP99", "penalty": 1.0, "max": 1.0}]
