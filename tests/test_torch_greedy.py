"""The port's greedy anchor (kubernetes_simulator_tpu_torch.sim.greedy
``greedy_replay``, over its numpy scheduler framework, plugins and
ops/cpu.py) against the JAX package's ``greedy_replay`` on the traces of
tests/test_jax_parity.py, with tier preemption, the retry buffer and
completions, on the CPU.

Every ReplayResult field is compared: assignments, counters and the
end-of-replay gauges exactly, the state planes bit for bit (both run the
same numpy arithmetic in the same order)."""

import numpy as np
import pytest

from kubernetes_simulator_tpu.framework.framework import FrameworkConfig as J_Config
from kubernetes_simulator_tpu.models.core import (
    Cluster,
    LabelSelector,
    Node,
    Pod,
    PodAffinitySpec,
    PodAffinityTerm,
)
from kubernetes_simulator_tpu.models.encode import encode
from kubernetes_simulator_tpu.sim.greedy import greedy_replay as j_greedy
from kubernetes_simulator_tpu.sim.synthetic import config1, make_cluster, make_workload
from kubernetes_simulator_tpu_torch.framework.framework import (
    FrameworkConfig,
    SchedulerFramework,
)
from kubernetes_simulator_tpu_torch.models.state import init_state
from kubernetes_simulator_tpu_torch.sim.greedy import greedy_replay

from torch_port_case import port_case

FIELDS = ("placed", "unschedulable", "preemptions", "attempts", "retry_dropped",
          "evictions", "virtual_makespan", "utilization", "fragmentation")


def assert_greedy_equal(cluster, pods, plugins=None, weights=None, **kw):
    ec, ep = encode(cluster, pods)
    want = j_greedy(ec, ep, J_Config(plugins=plugins, weights=weights), **kw)
    pec, pep = port_case(ec, ep)
    got = greedy_replay(pec, pep, FrameworkConfig(plugins=plugins, weights=weights), **kw)
    bad = np.nonzero(got.assignments != want.assignments)[0]
    assert bad.size == 0, f"first pods {bad[:5].tolist()}: port {got.assignments[bad[:5]]} " \
                          f"reference {want.assignments[bad[:5]]}"
    for f in FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    for f in ("used", "match_count", "anti_active", "pref_wsum", "bound"):
        np.testing.assert_array_equal(getattr(got.state, f), getattr(want.state, f), f)
    return got


def test_fit_only():
    assert_greedy_equal(*config1(num_nodes=40, num_pods=300))


@pytest.mark.parametrize("seed", range(3))
def test_full_plugin_set(seed):
    cluster = make_cluster(25, seed=seed, taint_fraction=0.2)
    pods, _ = make_workload(120, seed=seed, with_affinity=True, with_spread=True,
                            with_tolerations=True)
    assert_greedy_equal(cluster, pods)


def test_with_gangs():
    cluster = make_cluster(15, seed=5)
    pods, meta = make_workload(80, seed=5, gang_fraction=0.2, gang_size=3)
    assert meta["num_gangs"] > 0
    assert_greedy_equal(cluster, pods)


def test_gang_infeasible_rolls_back():
    cluster = Cluster(nodes=[Node("n0", {"cpu": 2}), Node("n1", {"cpu": 1})])
    pods = [Pod(f"g{g}-m{m}", requests={"cpu": 1}, arrival_time=float(g * 4 + m),
                pod_group=f"gang-{g}") for g in range(3) for m in range(4)]
    pods.append(Pod("single", requests={"cpu": 1}, arrival_time=100.0))
    res = assert_greedy_equal(cluster, pods, wave_width=4)
    assert res.unschedulable == 12 and res.assignments[-1] >= 0


def test_extended_resources_multitenant():
    cluster = make_cluster(20, seed=3, extended_resources={"google.com/tpu": (8, 0.3)})
    pods, _ = make_workload(100, seed=3, extended_resource=("google.com/tpu", 8, 0.3),
                            gang_fraction=0.1, gang_size=4)
    assert_greedy_equal(cluster, pods)


def test_bootstrap_on_domainless_node():
    zone = "topology.kubernetes.io/zone"
    nodes = [Node("n-zoned", capacity={"cpu": 0.5, "memory": 1, "pods": 10},
                  labels={zone: "a"}),
             Node("n-bare", capacity={"cpu": 8, "memory": 32, "pods": 10})]
    aff = PodAffinitySpec(required=(PodAffinityTerm(LabelSelector.make({"app": "x"}), zone),))
    pods = [Pod(n, labels={"app": "x"}, requests={"cpu": 1}, arrival_time=float(i),
                pod_affinity=aff) for i, n in enumerate("ab")]
    assert assert_greedy_equal(Cluster(nodes=nodes), pods).placed == 2


@pytest.mark.parametrize("weights,strategy", [
    ({"NodeResourcesFit": 2.5, "TaintToleration": 0.0, "PodTopologySpread": 3.75}, None),
    ({"NodeAffinity": 0.3333, "InterPodAffinity": 7.1}, "MostAllocated"),
    ({}, "RequestedToCapacityRatio"),
])
def test_policy_configs(weights, strategy):
    """Non-integer and zero weights and each fit strategy, as the tuner's
    oracle materializes them (FrameworkConfig.with_policy)."""
    cluster = make_cluster(8, seed=9, taint_fraction=0.2)
    pods, _ = make_workload(300, seed=9, with_affinity=True, with_spread=True,
                            with_tolerations=True)
    jcfg = J_Config().with_policy(weights, fit_strategy=strategy)
    tcfg = FrameworkConfig().with_policy(weights, fit_strategy=strategy)
    assert (tcfg.plugins, tcfg.weights) == (jcfg.plugins, jcfg.weights)
    res = assert_greedy_equal(cluster, pods, plugins=tcfg.plugins, weights=tcfg.weights)
    assert res.unschedulable > 0


@pytest.mark.parametrize("seed", [2, 3])
def test_tier_preemption_with_completions(seed):
    cluster = make_cluster(8, seed=seed, taint_fraction=0.2)
    pods, _ = make_workload(400, seed=seed, with_tolerations=True, with_spread=True,
                            duration_mean=20.0, arrival_rate=12.0)
    res = assert_greedy_equal(cluster, pods, preemption=True, completions_chunk_waves=4)
    assert res.preemptions > 0


def test_tier_preemption_with_gangs():
    cluster = make_cluster(10, seed=2, taint_fraction=0.2)
    pods, _ = make_workload(300, seed=2, with_tolerations=True, gang_fraction=0.1,
                            gang_size=3)
    assert assert_greedy_equal(cluster, pods, preemption="tier").preemptions > 0


@pytest.mark.parametrize("seed,W,C,RB", [(1, 8, 2, 8), (2, 4, 3, 4), (3, 2, 5, 16)])
def test_retry_buffer_with_completions(seed, W, C, RB):
    cluster = make_cluster(4, seed=seed, taint_fraction=0.2)
    pods, _ = make_workload(160, seed=seed, arrival_rate=50.0, duration_mean=2.0,
                            with_affinity=True, with_spread=True, with_tolerations=True,
                            gang_fraction=0.1, gang_size=2)
    res = assert_greedy_equal(cluster, pods, wave_width=W, completions_chunk_waves=C,
                              retry_buffer=RB)
    assert res.retry_dropped > 0 or res.placed > 0


def test_completions_only():
    cluster = make_cluster(3, seed=11)
    pods, _ = make_workload(120, seed=11, arrival_rate=60.0, duration_mean=1.5,
                            with_spread=True, with_tolerations=True)
    assert_greedy_equal(cluster, pods, completions_chunk_waves=4)


def _tiny():
    cluster = make_cluster(4, seed=0)
    pods, _ = make_workload(20, seed=0, duration_mean=1.0)
    return port_case(*encode(cluster, pods))


@pytest.mark.parametrize("kw,exc,match", [
    (dict(preemption="kube", completions_chunk_waves=2, retry_buffer=8), NotImplementedError,
     "queue A items 6 and 13"),
    (dict(retry_buffer=8), ValueError, "completions_chunk_waves"),
    (dict(retry_buffer=8, completions_chunk_waves=2, preemption=True), ValueError,
     "tier preemption"),
])
def test_refusals(kw, exc, match):
    pec, pep = _tiny()
    with pytest.raises(exc, match=match):
        greedy_replay(pec, pep, FrameworkConfig(), **kw)


def test_schedule_one_refuses_the_postfilter():
    pec, pep = _tiny()
    fw = SchedulerFramework(pec, pep, FrameworkConfig())
    st = init_state(pec, pep)
    with pytest.raises(NotImplementedError, match="PostFilter"):
        fw.schedule_one(st, 0, allow_preemption=True)
    assert fw.schedule_one(st, 0).node >= 0
    fw_off = SchedulerFramework(pec, pep, FrameworkConfig(enable_preemption=False))
    assert fw_off.schedule_one(st, 0, allow_preemption=True).node >= 0
