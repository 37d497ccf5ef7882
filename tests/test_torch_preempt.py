"""Tier preemption (``preemption=True`` / ``"tier"``) in the port's single
replay, TorchReplayEngine(device="cpu"), against the greedy anchor.

The cases are those of tests/test_preemption_device.py: the tight traces
(seeds 0-3, spread), the gangs trace, high priority placing over a full
cluster, pre-bound victims, the completions cases (the tiny trace, a
victim that never releases, a completed pod that is never evicted, the
random over-committed trace), the four tier mixes and the gang-completion
tier-plane case. Each checks assignments, ``placed`` and ``preemptions``
equal to ``greedy_replay(preemption=True, …)`` exactly, and to
JaxReplayEngine(preemption=True) on the four tight seeds; ``used`` to
atol 1e-3 (tests/test_jax_parity.py::assert_parity's tolerance, from f32
sums of bucketed quantities), and the tier planes equal to a host rebuild
from the final assignments to the same tolerance. Also the twin of
``ops/tpu.py:788 masked_argmin`` and every guard of the mode, each raising
the reference's error."""

import numpy as np
import pytest
import torch

from kubernetes_simulator_tpu.framework.framework import FrameworkConfig as J_Config
from kubernetes_simulator_tpu.models.core import Cluster, Node, Pod
from kubernetes_simulator_tpu.models.encode import PAD, encode
from kubernetes_simulator_tpu.sim.greedy import greedy_replay, priority_tiers
from kubernetes_simulator_tpu.sim.jax_runtime import JaxReplayEngine
from kubernetes_simulator_tpu.sim.synthetic import make_cluster, make_workload
from kubernetes_simulator_tpu_torch.framework.framework import FrameworkConfig
from kubernetes_simulator_tpu_torch.ops import reference as ref
from kubernetes_simulator_tpu_torch.sim.torch_runtime import TorchReplayEngine

from torch_port_case import port_case

USED_ATOL = 1e-3
FIT_ONLY = [{"name": "NodeResourcesFit"}]


@pytest.fixture(autouse=True)
def _deterministic():
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


def _tight_case(seed, n_nodes=30, n_pods=220, **wl):
    """tests/test_preemption_device.py's over-committed cluster."""
    cluster = make_cluster(n_nodes, seed=seed, taint_fraction=0.2)
    pods, _ = make_workload(n_pods, seed=seed, with_tolerations=True, **wl)
    return encode(cluster, pods)


def host_tier_planes(ep, eng, assignments):
    """Tier planes rebuilt on the host from the final assignments: every
    placed non-gang pod that the run never released, by tier and node."""
    _, pod_tier = priority_tiers(ep)
    Tt = int(pod_tier.max()) + 1
    N, R = eng.ec.num_nodes, eng.ec.num_resources
    ut = np.zeros((Tt, N, R), np.float32)
    nt = np.zeros((Tt, N), np.float32)
    released = np.zeros(ep.num_pods, bool)
    col_pod = eng.plan.col_pod
    live = col_pod >= 0
    released[col_pod[live]] = eng.plan.col_relb[live] != ref.NEVER
    for p in np.nonzero((assignments >= 0) & (ep.group_id < 0) & ~released)[0]:
        ut[pod_tier[p], assignments[p]] += ep.requests[p]
        nt[pod_tier[p], assignments[p]] += 1.0
    return ut, nt


def assert_preempt_parity(ec, ep, plugins=None, wave_width=8, chunk_waves=None, jax=False):
    """Port vs greedy_replay(preemption=True) (and JaxReplayEngine with
    ``jax``) on one case; returns (port result, anchor result)."""
    cfg = J_Config(plugins=plugins)
    anchor = greedy_replay(ec, ep, cfg, wave_width=wave_width, preemption=True,
                           completions_chunk_waves=chunk_waves)
    pec, pep = port_case(ec, ep)
    kw = dict(wave_width=wave_width)
    if chunk_waves is not None:
        kw["chunk_waves"] = chunk_waves
    eng = TorchReplayEngine(pec, pep, FrameworkConfig(plugins=plugins), device="cpu",
                            preemption=True, **kw)
    res = eng.replay()
    others = [("greedy", anchor)]
    if jax:
        others.append(("jax", JaxReplayEngine(ec, ep, cfg, preemption=True, **kw).replay()))
    for name, other in others:
        bad = np.nonzero(res.assignments != other.assignments)[0]
        assert bad.size == 0, (
            f"{name}: {bad.size} mismatches, first at pods {bad[:5]}: "
            f"port={res.assignments[bad[:5]]} {name}={other.assignments[bad[:5]]}")
        assert res.placed == other.placed, name
        assert res.preemptions == other.preemptions, name
        np.testing.assert_allclose(res.state.used, other.state.used, atol=USED_ATOL)
    ut, nt = host_tier_planes(ep, eng, res.assignments)
    pre = eng.last_tables.preempt
    np.testing.assert_allclose(pre.used_tier[0].numpy(), ut, atol=USED_ATOL)
    np.testing.assert_array_equal(pre.npods_tier[0].numpy(), nt)
    assert int(pre.victims[0]) == res.preemptions
    return res, anchor


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_tight_matches_anchor_and_jax(seed):
    ec, ep = _tight_case(seed, with_spread=True)
    assert_preempt_parity(ec, ep, jax=True)


def test_tight_with_gangs():
    ec, ep = _tight_case(7, gang_fraction=0.15, gang_size=3)
    assert (ep.group_id >= 0).any()
    assert_preempt_parity(ec, ep)


def test_preemption_places_high_priority():
    nodes = [Node(f"n{i}", capacity={"cpu": 4.0, "memory": 8 * 2**30, "pods": 10})
             for i in range(4)]
    pods = [Pod(f"lo{i}", labels={"app": "lo"}, requests={"cpu": 1.0}, priority=0,
                arrival_time=float(i)) for i in range(16)]
    pods += [Pod(f"hi{i}", labels={"app": "hi"}, requests={"cpu": 2.0}, priority=100,
                 arrival_time=100.0 + i) for i in range(4)]
    ec, ep = encode(Cluster(nodes=nodes), pods)
    res, _ = assert_preempt_parity(ec, ep)
    assert (res.assignments[16:] >= 0).sum() >= 2 and res.preemptions > 0
    assert (res.state.used[:, ec.vocab._r["cpu"]] <= 4.0 + 1e-5).all()


def test_prebound_pods_preempted():
    nodes = [Node(f"n{i}", capacity={"cpu": 2.0, "memory": 4 * 2**30, "pods": 5})
             for i in range(2)]
    pods = [Pod(f"pre{i}", labels={"app": "lo"}, requests={"cpu": 2.0}, priority=0,
                arrival_time=0.0, node_name=f"n{i}") for i in range(2)]
    pods += [Pod(f"hi{i}", labels={"app": "hi"}, requests={"cpu": 2.0}, priority=100,
                 arrival_time=10.0 + i) for i in range(2)]
    ec, ep = encode(Cluster(nodes=nodes), pods)
    res, _ = assert_preempt_parity(ec, ep)
    assert res.preemptions >= 1
    assert (res.assignments[2:] >= 0).any() and (res.assignments[:2] == PAD).any()


def _one_node(pods):
    return encode(Cluster(nodes=[Node("n0", {"cpu": 2})]), pods)


def test_completions_tiny():
    """lo's completion, not an eviction, frees the node for hi."""
    ec, ep = _one_node([
        Pod("lo", requests={"cpu": 2}, arrival_time=0.0, duration=3.0, priority=0),
        Pod("f1", requests={}, arrival_time=5.0),
        Pod("f2", requests={}, arrival_time=6.0),
        Pod("hi", requests={"cpu": 2}, arrival_time=10.0, priority=100),
    ])
    res, _ = assert_preempt_parity(ec, ep, FIT_ONLY, wave_width=1, chunk_waves=1)
    assert res.assignments[0] == 0 and res.assignments[3] == 0 and res.preemptions == 0


def test_victim_never_releases():
    """hi evicts lo; lo's would-be completion frees nothing, so probe does
    not fit while hi runs."""
    ec, ep = _one_node([
        Pod("lo", requests={"cpu": 2}, arrival_time=0.0, duration=6.0, priority=0),
        Pod("f1", requests={}, arrival_time=1.0, priority=200),
        Pod("f2", requests={}, arrival_time=2.0, priority=200),
        Pod("hi", requests={"cpu": 2}, arrival_time=3.0, duration=100.0, priority=100),
        Pod("f3", requests={}, arrival_time=7.0, priority=200),
        Pod("f4", requests={}, arrival_time=8.0, priority=200),
        Pod("probe", requests={"cpu": 2}, arrival_time=9.0, priority=0),
    ])
    res, _ = assert_preempt_parity(ec, ep, FIT_ONLY, wave_width=1, chunk_waves=1)
    assert res.assignments[0] == PAD and res.assignments[3] == 0
    assert res.assignments[6] == PAD and res.preemptions == 1


def test_completed_pod_not_evicted():
    ec, ep = _one_node([
        Pod("lo", requests={"cpu": 2}, arrival_time=0.0, duration=1.0, priority=0),
        Pod("f1", requests={}, arrival_time=2.0),
        Pod("f2", requests={}, arrival_time=3.0),
        Pod("hi", requests={"cpu": 2}, arrival_time=5.0, priority=100),
    ])
    res, _ = assert_preempt_parity(ec, ep, FIT_ONLY, wave_width=1, chunk_waves=1)
    assert res.assignments[0] == 0 and res.assignments[3] == 0 and res.preemptions == 0


@pytest.mark.parametrize("seed", [2, 3])
def test_completions_parity_random(seed):
    """Over-committed trace with durations: evictions fire and completions
    change the placements."""
    ec, ep = _tight_case(seed, n_nodes=8, n_pods=400, with_spread=True, duration_mean=20.0,
                         arrival_rate=12.0)
    res, anchor = assert_preempt_parity(ec, ep, chunk_waves=4)
    assert res.preemptions > 0
    off = greedy_replay(ec, ep, J_Config(), preemption=True)
    assert (off.assignments != anchor.assignments).any()


TIER_MIXES = [(0, 100), (0, 50, 100), (0, 10, 100, 1000), (0, 0, 0, 1000)]


@pytest.mark.parametrize("tiers", TIER_MIXES, ids=lambda t: "x".join(map(str, t)))
def test_tier_mix_parity(tiers):
    """Priorities ramp up over arrival time, so later tiers preempt
    earlier ones."""
    n_pods = 72
    nodes = [Node(f"n{i}", capacity={"cpu": 4.0, "memory": 8 * 2**30, "pods": 12})
             for i in range(6)]
    pods = [
        Pod(f"p{i}", labels={"app": f"a{i % 3}"}, requests={"cpu": [0.5, 1.0, 2.0][i % 3]},
            priority=tiers[min(len(tiers) - 1, (i * len(tiers)) // n_pods)],
            arrival_time=float(i))
        for i in range(n_pods)
    ]
    ec, ep = encode(Cluster(nodes=nodes), pods)
    res, _ = assert_preempt_parity(ec, ep)
    assert res.preemptions > 0


def test_gang_completion_keeps_tier_planes():
    """A completed gang pod never leaves the tier planes (it never entered
    them), so hi still finds lo to evict."""
    ec, ep = _one_node([
        Pod("g0", requests={"cpu": 1}, arrival_time=0.0, duration=2.0, pod_group="g",
            priority=0),
        Pod("g1", requests={"cpu": 1}, arrival_time=0.0, duration=2.0, pod_group="g",
            priority=0),
        Pod("f1", requests={}, arrival_time=3.0, priority=200),
        Pod("f2", requests={}, arrival_time=4.0, priority=200),
        Pod("lo", requests={"cpu": 2}, arrival_time=5.0, duration=100.0, priority=0),
        Pod("f3", requests={}, arrival_time=6.0, priority=200),
        Pod("f4", requests={}, arrival_time=7.0, priority=200),
        Pod("hi", requests={"cpu": 2}, arrival_time=8.0, priority=100),
    ])
    res, _ = assert_preempt_parity(ec, ep, FIT_ONLY, wave_width=2, chunk_waves=1)
    assert res.assignments[7] == 0 and res.preemptions == 1


def test_masked_argmin_twin_matches_reference():
    """Lowest-index ties and the all-false mask, against ops/tpu.py:788."""
    import jax.numpy as jnp

    from kubernetes_simulator_tpu.ops import tpu as T

    rng = np.random.default_rng(0)
    for i in range(25):
        s = rng.integers(0, 5, 32).astype(np.float32)
        m = rng.random(32) < (0.4 if i else 0.0)
        want, want_ok = T.masked_argmin(jnp.asarray(s), jnp.asarray(m))
        got, ok = ref.masked_argmin(torch.as_tensor(s), torch.as_tensor(m))
        assert int(got) == int(want) and bool(ok) == bool(want_ok)
        if not m.any():
            assert int(got) == PAD and not bool(ok)
    # Batched rows, as K2 reads the candidate row of every scenario.
    s = rng.integers(0, 3, (4, 16)).astype(np.float32)
    m = rng.random((4, 16)) < 0.5
    m[2] = False
    got, ok = ref.masked_argmin(torch.as_tensor(s), torch.as_tensor(m))
    for r in range(4):
        want, want_ok = T.masked_argmin(jnp.asarray(s[r]), jnp.asarray(m[r]))
        assert int(got[r]) == int(want) and bool(ok[r]) == bool(want_ok)


# ---------------------------------------------------------------------------
# Guards: the reference's errors
# ---------------------------------------------------------------------------


def _port_tight(seed=0):
    return port_case(*_tight_case(seed))


@pytest.mark.parametrize("kw,match", [
    (dict(engine="v2"), "engine='v3'"),
    (dict(retry_buffer=8), "retry_buffer"),
    (dict(node_shards=2), "node_shards"),
])
def test_guards_raise_the_reference_errors(kw, match):
    ec, ep = _tight_case(0)
    with pytest.raises(ValueError, match=match):
        JaxReplayEngine(ec, ep, J_Config(), preemption=True, **kw)
    pec, pep = port_case(ec, ep)
    with pytest.raises(ValueError, match=match):
        TorchReplayEngine(pec, pep, device="cpu", preemption=True, **kw)


@pytest.mark.parametrize("kw", [dict(checkpoint_path="ck.npz", checkpoint_every=1),
                                dict(resume=True)])
def test_checkpoint_refused_with_preemption(kw):
    pec, pep = _port_tight()
    eng = TorchReplayEngine(pec, pep, device="cpu", preemption=True)
    with pytest.raises(ValueError, match="checkpoint/resume"):
        eng.replay(**kw)


def test_more_than_eight_tiers_refused():
    nodes = [Node("n0", {"cpu": 4})]
    pods = [Pod(f"p{i}", requests={"cpu": 1}, priority=i, arrival_time=float(i))
            for i in range(9)]
    ec, ep = encode(Cluster(nodes=nodes), pods)
    from kubernetes_simulator_tpu.ops import tpu3 as V3
    from kubernetes_simulator_tpu.sim.jax_runtime import StepSpec as J_Spec

    with pytest.raises(ValueError, match="<= 8 priority tiers"):
        V3.V3Static.build(ec, ep, J_Spec.from_config(ec, J_Config(), ep), preemption=True)
    pec, pep = port_case(ec, ep)
    with pytest.raises(ValueError, match="<= 8 priority tiers"):
        TorchReplayEngine(pec, pep, device="cpu", preemption=True)


def test_hostname_scale_terms_refused():
    """Hostname anti-affinity over 150 nodes: host-plane rows, refused as
    the reference refuses them; the same trace runs with preemption off."""
    ec, ep = encode(make_cluster(150, seed=1), make_workload(50, seed=1, with_affinity=True)[0])
    from kubernetes_simulator_tpu.ops import tpu3 as V3
    from kubernetes_simulator_tpu.sim.jax_runtime import StepSpec as J_Spec

    assert V3.V3Static.build(ec, ep, J_Spec.from_config(ec, J_Config(), ep)).has_host_rows
    with pytest.raises(ValueError, match="hostname-scale"):
        JaxReplayEngine(ec, ep, J_Config(), preemption=True)
    pec, pep = port_case(ec, ep)
    with pytest.raises(ValueError, match="hostname-scale"):
        TorchReplayEngine(pec, pep, device="cpu", preemption=True)
    assert TorchReplayEngine(pec, pep, device="cpu").replay().placed > 0


def test_host_row_gate_equals_reference():
    """The port's copy of the is_host rule agrees with V3Static on traces
    with and without hostname-scale terms."""
    from kubernetes_simulator_tpu.ops import tpu3 as V3
    from kubernetes_simulator_tpu.sim.jax_runtime import StepSpec as J_Spec
    from kubernetes_simulator_tpu_torch.sim.tiers import has_host_rows
    from kubernetes_simulator_tpu_torch.sim.torch_runtime import StepSpec

    for nodes, kw in ((150, dict(with_affinity=True)), (100, dict(with_affinity=True)),
                      (150, dict(with_spread=True)), (40, dict(with_spread=True))):
        ec, ep = encode(make_cluster(nodes, seed=1), make_workload(60, seed=1, **kw)[0])
        want = V3.V3Static.build(ec, ep, J_Spec.from_config(ec, J_Config(), ep)).has_host_rows
        pec, pep = port_case(ec, ep)
        spec = StepSpec.from_config(pec, FrameworkConfig(), pep)
        assert has_host_rows(pec, pep, spec.interpod, spec.spread) == want, (nodes, kw)


def test_kube_preemption_refused_by_name():
    """Kube preemption is ported (tests/test_torch_kube.py); without a retry
    buffer it is refused with the reference's error, which names it."""
    pec, pep = _port_tight()
    with pytest.raises(ValueError, match="kube"):
        TorchReplayEngine(pec, pep, device="cpu", preemption="kube")
    with pytest.raises(ValueError, match="preemption must be"):
        TorchReplayEngine(pec, pep, device="cpu", preemption="soft")


def test_preemption_off_launches_and_results_unchanged():
    """With preemption off the tables carry no preemption state and the
    replay equals the anchor's preemption-free replay."""
    ec, ep = _tight_case(1, with_spread=True)
    pec, pep = port_case(ec, ep)
    eng = TorchReplayEngine(pec, pep, device="cpu")
    res = eng.replay()
    assert eng.last_tables.preempt is None and res.preemptions == 0
    np.testing.assert_array_equal(res.assignments,
                                  greedy_replay(ec, ep, J_Config()).assignments)


def test_cli_runs_config6_at_reduced_size(tmp_path):
    """``run examples/config6_preempt_defaults.yaml --device cpu`` cut to
    20 nodes x 1,040 pods (its 52 pods a node, tiers, tolerations and
    plugins): the row's placed and preemptions equal greedy_replay's on
    the same case."""
    import json

    import yaml

    from kubernetes_simulator_tpu.utils.config import SimConfig as J_SimConfig
    from kubernetes_simulator_tpu.utils.config import build_encoded_case
    from kubernetes_simulator_tpu_torch import cli

    d = yaml.safe_load(open("examples/config6_preempt_defaults.yaml"))
    d["cluster"]["synthetic"]["nodes"] = 20
    d["workload"]["synthetic"]["pods"] = 1040
    d["output"] = str(tmp_path / "out.jsonl")
    cfg = tmp_path / "c6.yaml"
    cfg.write_text(yaml.safe_dump(d))
    assert cli.main(["run", str(cfg), "--device", "cpu"]) == 0
    row = json.loads((tmp_path / "out.jsonl").read_text().splitlines()[-1])
    jcfg = J_SimConfig.from_dict(d)
    ec, ep = build_encoded_case(jcfg)
    anchor = greedy_replay(ec, ep, jcfg.framework, preemption=True)
    assert row["placed"] == anchor.placed and row["preemptions"] == anchor.preemptions
    assert anchor.preemptions > 0


@pytest.mark.parametrize("value,accepted", [(True, True), ("tier", True), (False, True),
                                            ("kube", True), ("soft", False)])
def test_config_device_preemption(value, accepted):
    from kubernetes_simulator_tpu_torch.utils.config import SimConfig

    d = {"devicePreemption": value}
    if not accepted:
        with pytest.raises(ValueError, match="devicePreemption"):
            SimConfig.from_dict(d)
        return
    assert SimConfig.from_dict(d).device_preemption == value
