"""TorchReplayEngine(device="cpu") against both reference engines.

Every case of tests/test_jax_parity.py (fit-only, the full plugin set on
seeds 0-2, gangs, infeasible-gang rollback, extended resources, chunked
equals single-shot, the domainless-node bootstrap) and the completions
trace of tests/test_completions_device.py: the port's assignments and
``placed`` equal greedy_replay's and JaxReplayEngine's (engine v3, and
engine v2 in ``test_parity_engine_v2``) exactly; ``used`` agrees to atol 1e-3 and ``match_count`` to atol 1e-5 —
the tolerances of tests/test_jax_parity.py::assert_parity, which stem
from f32 sums of bucketed quantities."""

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
)
from kubernetes_simulator_tpu.models.encode import PAD, encode
from kubernetes_simulator_tpu.sim.greedy import greedy_replay
from kubernetes_simulator_tpu.sim.jax_runtime import JaxReplayEngine
from kubernetes_simulator_tpu.sim.synthetic import config1, make_cluster, make_workload
from kubernetes_simulator_tpu_torch.framework.framework import FrameworkConfig
from kubernetes_simulator_tpu_torch.sim.torch_runtime import TorchReplayEngine

from torch_port_case import assert_state_close, port_case

USED_ATOL = 1e-3
MC_ATOL = 1e-5


@pytest.fixture(autouse=True)
def _deterministic():
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


def torch_replay(ec, ep, plugins=None, **kw):
    pec, pep = port_case(ec, ep)
    return TorchReplayEngine(pec, pep, FrameworkConfig(plugins=plugins), device="cpu",
                             **kw).replay()


def assert_parity3(cluster, pods, plugins=None, wave_width=8, completions_chunk_waves=None,
                   engine="v3", **kw):
    """Port vs greedy_replay vs JaxReplayEngine(engine) on one case, with
    ``engine`` on both sides."""
    ec, ep = encode(cluster, pods)
    anchor = greedy_replay(ec, ep, J_Config(plugins=plugins), wave_width=wave_width,
                           completions_chunk_waves=completions_chunk_waves)
    jax_res = JaxReplayEngine(ec, ep, J_Config(plugins=plugins), wave_width=wave_width,
                              engine=engine, **kw).replay()
    res = torch_replay(ec, ep, plugins, wave_width=wave_width, engine=engine, **kw)
    for name, other in (("greedy", anchor), ("jax", jax_res)):
        mismatch = np.nonzero(res.assignments != other.assignments)[0]
        assert mismatch.size == 0, (
            f"{name}: {mismatch.size} mismatches, first at pod {mismatch[:5]}: "
            f"port={res.assignments[mismatch[:5]]} {name}={other.assignments[mismatch[:5]]}"
        )
        assert res.placed == other.placed, name
        assert res.unschedulable == other.unschedulable, name
        assert_state_close(res.state, other.state, USED_ATOL, MC_ATOL)
    return res, anchor


def _case_fit_only():
    cluster, pods, plugins = config1(num_nodes=40, num_pods=300)
    return cluster, pods, plugins, {}


def _case_full_plugin_set(seed):
    cluster = make_cluster(25, seed=seed, taint_fraction=0.2)
    pods, _ = make_workload(
        120, seed=seed, with_affinity=True, with_spread=True, with_tolerations=True
    )
    return cluster, pods, None, {}


def _case_gangs():
    cluster = make_cluster(15, seed=5)
    pods, meta = make_workload(80, seed=5, gang_fraction=0.2, gang_size=3)
    assert meta["num_gangs"] > 0
    return cluster, pods, None, {}


def _case_gang_infeasible():
    # A 4-pod gang of 1 cpu each can never fit two nodes of 3 cpu in all:
    # every gang rolls back at its wave boundary; the singleton fits.
    cluster = Cluster(nodes=[Node("n0", {"cpu": 2}), Node("n1", {"cpu": 1})])
    pods = [
        Pod(f"g{g}-m{m}", requests={"cpu": 1}, arrival_time=float(g * 4 + m),
            pod_group=f"gang-{g}")
        for g in range(3)
        for m in range(4)
    ]
    pods.append(Pod("single", requests={"cpu": 1}, arrival_time=100.0))
    return cluster, pods, None, dict(wave_width=4)


def _case_extended_resources():
    cluster = make_cluster(20, seed=3, extended_resources={"google.com/tpu": (8, 0.3)})
    pods, _ = make_workload(
        100, seed=3, extended_resource=("google.com/tpu", 8, 0.3), gang_fraction=0.1,
        gang_size=4,
    )
    return cluster, pods, None, {}


def _case_completions():
    cluster = make_cluster(12, seed=3, taint_fraction=0.2)
    pods, _ = make_workload(
        80, seed=3, arrival_rate=10.0, duration_mean=2.0,
        with_affinity=True, with_spread=True, with_tolerations=True,
    )
    return cluster, pods, None, dict(wave_width=4, completions_chunk_waves=4, chunk_waves=4)


#: The parity cases of this file that test_parity_engine_v2 runs with
#: engine v2 on both sides.
PARITY_CASES = {
    "fit_only": _case_fit_only,
    **{f"full_plugin_set_{s}": (lambda s=s: _case_full_plugin_set(s)) for s in range(3)},
    "gangs": _case_gangs,
    "gang_infeasible": _case_gang_infeasible,
    "extended_resources": _case_extended_resources,
    "completions": _case_completions,
}


def test_parity_fit_only():
    cluster, pods, plugins, kw = _case_fit_only()
    assert_parity3(cluster, pods, plugins, **kw)


@pytest.mark.parametrize("seed", range(3))
def test_parity_full_plugin_set(seed):
    cluster, pods, plugins, kw = _case_full_plugin_set(seed)
    assert_parity3(cluster, pods, plugins, **kw)


def test_parity_with_gangs():
    cluster, pods, plugins, kw = _case_gangs()
    assert_parity3(cluster, pods, plugins, **kw)


def test_parity_gang_infeasible_rolls_back_identically():
    cluster, pods, plugins, kw = _case_gang_infeasible()
    res, _ = assert_parity3(cluster, pods, plugins, **kw)
    assert res.unschedulable == 12
    assert res.assignments[-1] >= 0
    assert res.state.used[:, 0].sum() == 1.0  # only the singleton holds cpu (row 0)


def test_parity_extended_resources_multitenant():
    cluster, pods, plugins, kw = _case_extended_resources()
    assert_parity3(cluster, pods, plugins, **kw)


@pytest.mark.parametrize("case", sorted(PARITY_CASES))
def test_parity_engine_v2(case):
    """engine="v2" (the reference's node-space chain, row B8) runs on the
    port's K1–K3, which commit pod by pod as v2 does: each parity case
    equals JaxReplayEngine(engine="v2") and greedy_replay."""
    cluster, pods, plugins, kw = PARITY_CASES[case]()
    assert_parity3(cluster, pods, plugins, engine="v2", **kw)


@pytest.mark.parametrize("strategy", ["MostAllocated", "RequestedToCapacityRatio"])
def test_parity_fit_strategies(strategy):
    """The other NodeResourcesFit strategies, on a contended trace with
    gangs (a few pods stay unschedulable)."""
    shape = [{"utilization": 0, "score": 0}, {"utilization": 40, "score": 7},
             {"utilization": 100, "score": 3}]
    plugins = [{"name": "NodeResourcesFit", "args": {"strategy": strategy, "shape": shape}}]
    plugins += [{"name": n} for n in ("TaintToleration", "NodeAffinity", "InterPodAffinity",
                                      "PodTopologySpread")]
    cluster = make_cluster(25, seed=4, taint_fraction=0.2)
    pods, _ = make_workload(150, seed=4, with_affinity=True, with_spread=True,
                            with_tolerations=True, gang_fraction=0.1, gang_size=3)
    res, _ = assert_parity3(cluster, pods, plugins)
    assert res.unschedulable > 0


def test_chunked_equals_single_shot():
    cluster, pods, plugins = config1(num_nodes=20, num_pods=200)
    ec, ep = encode(cluster, pods)
    one = torch_replay(ec, ep, plugins, chunk_waves=10_000)
    many = torch_replay(ec, ep, plugins, chunk_waves=4)
    jax_one = JaxReplayEngine(ec, ep, J_Config(plugins=plugins), chunk_waves=10_000).replay()
    assert (one.assignments == many.assignments).all()
    assert (one.assignments == jax_one.assignments).all()
    np.testing.assert_array_equal(one.state.used, many.state.used)


def test_parity_bootstrap_on_domainless_node():
    """A pod placed via the bootstrap exception on a node WITHOUT the
    topology label must not count toward the group total."""
    zone = "topology.kubernetes.io/zone"
    nodes = [
        Node("n-zoned", capacity={"cpu": 0.5, "memory": 1, "pods": 10}, labels={zone: "a"}),
        Node("n-bare", capacity={"cpu": 8, "memory": 32, "pods": 10}),
    ]
    aff = PodAffinitySpec(required=(PodAffinityTerm(LabelSelector.make({"app": "x"}), zone),))
    pods = [
        Pod("a", labels={"app": "x"}, requests={"cpu": 1}, arrival_time=0.0, pod_affinity=aff),
        Pod("b", labels={"app": "x"}, requests={"cpu": 1}, arrival_time=1.0, pod_affinity=aff),
    ]
    res, _ = assert_parity3(Cluster(nodes=nodes), pods)
    assert res.placed == 2
    assert res.state.match_count.sum() == 0.0  # domainless binds count nowhere


def test_completions_parity_random():
    cluster, pods, plugins, kw = _case_completions()
    res, anchor = assert_parity3(cluster, pods, plugins, **kw)
    # Releases must actually matter on this trace, or the test is vacuous.
    ec, ep = encode(cluster, pods)
    off = torch_replay(ec, ep, wave_width=4, chunk_waves=4, completions=False)
    assert (res.assignments != off.assignments).any()
    np.testing.assert_array_equal(off.assignments, greedy_replay(ec, ep, J_Config(),
                                                                 wave_width=4).assignments)


def test_completion_frees_capacity_for_a_later_pod():
    # a holds the only cpu until t=5; b arrives at t=10 and fits only if the
    # release happened (one zero-request filler chunk gives the one-chunk
    # slack).
    cluster = Cluster(nodes=[Node("n0", {"cpu": 1})])
    pods = [
        Pod("a", requests={"cpu": 1}, arrival_time=0.0, duration=5.0),
        Pod("f", requests={}, arrival_time=6.0),
        Pod("b", requests={"cpu": 1}, arrival_time=10.0),
    ]
    plugins = [{"name": "NodeResourcesFit"}]
    res, _ = assert_parity3(cluster, pods, plugins, wave_width=1, completions_chunk_waves=1,
                            chunk_waves=1)
    assert res.assignments.tolist() == [0, 0, 0]
    ec, ep = encode(cluster, pods)
    off = torch_replay(ec, ep, plugins, wave_width=1, chunk_waves=1, completions=False)
    assert off.assignments[2] == PAD


def test_summary_telemetry_and_result_row():
    cluster, pods, plugins = config1(num_nodes=10, num_pods=40)
    ec, ep = encode(cluster, pods)
    res = torch_replay(ec, ep, plugins)
    tel = res.summary()["telemetry"]
    assert tel["granularity"] == "summary"
    assert tel["latency"]["count"] == res.placed == 40
    assert {"dispatch", "device_wait"} <= set(tel["phases"])
    assert torch_replay(ec, ep, plugins, telemetry="off").telemetry is None
    assert res.fragmentation is not None and res.utilization["cpu"] > 0
