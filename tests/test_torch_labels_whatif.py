"""``set_label`` in the port's what-if engine against the JAX package's,
on the CPU at small sizes.

Each case carries the same inputs, made from seeds by the JAX package's
generators, into the port (tests/torch_port_case.py) and runs the batch
through both what-if engines; each scenario is also replayed from scratch
by the JAX package's ``greedy_replay`` on its cluster, perturbed
explicitly on the object model and re-encoded. Tolerance: none —
assignments and placed counts are integers, the label tables are
compared bit for bit (as tests/test_jax_parity.py::assert_parity holds
f32 planes)."""

import dataclasses
import os
import sys
import warnings

import numpy as np
import pytest
import torch

from kubernetes_simulator_tpu.framework.framework import FrameworkConfig as J_Config
from kubernetes_simulator_tpu.models.core import (
    Cluster,
    LabelSelector,
    MatchExpression,
    Node,
    NodeAffinitySpec,
    NodeSelectorTerm,
    Pod,
    PodAffinitySpec,
    PodAffinityTerm,
    Taint,
    TopologySpreadConstraint,
)
from kubernetes_simulator_tpu.models.encode import encode
from kubernetes_simulator_tpu.ops import cpu as C
from kubernetes_simulator_tpu.sim import whatif as J
from kubernetes_simulator_tpu.sim.greedy import greedy_replay
from kubernetes_simulator_tpu.sim.jax_runtime import _spread_w_table
from kubernetes_simulator_tpu.sim.synthetic import make_cluster, make_workload
from kubernetes_simulator_tpu_torch.framework.framework import FrameworkConfig
from kubernetes_simulator_tpu_torch.ops import reference as ref
from kubernetes_simulator_tpu_torch.sim import whatif as T

from torch_port_case import port_case

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"


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


def port_engine(ec, ep, scen, **kw):
    pec, pep = port_case(ec, ep)
    return T.WhatIfEngine(pec, pep, port_scenarios(scen), FrameworkConfig(), device="cpu", **kw)


def port_assignments(eng):
    """(assignments [S, P], placed [S]) of one run of a port engine, also
    when it does not collect them (``_run``, as the retry tests read them)."""
    _, _, assignments, placed, _ = eng._run()
    return assignments, placed


def greedy_per_scenario(cluster, pods, scen, **kw):
    """greedy_replay's result for each scenario's explicitly perturbed,
    re-encoded cluster."""
    out = []
    for sc in scen:
        ec2, ep2 = encode(chip_smoke.explicit_cluster(cluster, sc, Taint), pods)
        out.append(greedy_replay(ec2, ep2, J_Config(), **kw))
    return out


def assert_rows_equal(got, want, what):
    bad = np.argwhere(np.asarray(got) != np.asarray(want))
    assert bad.size == 0, f"{what}: {len(bad)} mismatches, first {bad[:5].tolist()}"


# -- (a) the label rows against the reference's re-derivation -------------------


def _label_case():
    """18 nodes over the synthetic zones with a singleton zone and a node
    without the zone key; numeric ``gen`` labels; pods with zone spread and
    affinity, a ``tier`` preference and a ``gen Gt 3`` requirement."""
    cluster = make_cluster(18, seed=5, taint_fraction=0.1)
    cluster.nodes[7].labels[ZONE] = "zonly"
    del cluster.nodes[11].labels[ZONE]
    for i, n in enumerate(cluster.nodes):
        n.labels["gen"] = str(i % 6)
    pods, _ = make_workload(70, seed=5, with_affinity=True, with_spread=True,
                            with_tolerations=True)
    for p in pods[::7]:
        p.node_affinity = NodeAffinitySpec(required=(NodeSelectorTerm(
            (MatchExpression.make("gen", "Gt", ["3"]),)),))
    return cluster, pods


LABEL_SCENARIOS = {
    "existing_value": [J.Perturbation("set_label", nodes=np.array([0, 4]), key=ZONE,
                                      value="zone-1"),
                       J.Perturbation("scale_capacity", nodes=np.array([2]), resource="cpu",
                                      factor=0.5)],
    "new_value": [J.Perturbation("set_label", nodes=np.array([1, 9]), key=ZONE,
                                 value="zz-fresh")],
    "empty_singleton": [J.Perturbation("set_label", nodes=np.array([7]), key=ZONE,
                                       value="zone-0")],
    "gain_key": [J.Perturbation("set_label", nodes=np.array([11]), key=ZONE, value="zone-2")],
    "new_key": [J.Perturbation("set_label", nodes=np.array([11]), key="pool",
                               value="blue")],
    "numeric": [J.Perturbation("set_label", nodes=np.array([0, 1, 2]), key="gen",
                               value="9"),
                J.Perturbation("set_label", nodes=np.array([5]), key="gen", value="x")],
    "tier_flip": [J.Perturbation("set_label", nodes=np.arange(1, 5), key="tier", value="hot")],
    "taint_only": [J.Perturbation("add_taint", nodes=np.array([5]), key="wi", value="x",
                                  effect="NoSchedule")],
}


def test_label_rows_equal_reference():
    """Each scenario's rows (node domains per group, domain counts, spread
    weights, expression matches) and the batch's domain width equal those
    the JAX ScenarioSet derives, and the interned vocabularies agree."""
    cluster, pods = _label_case()
    ec, ep = encode(cluster, pods)
    pec, _ = port_case(ec, ep)
    scen = [J.Scenario()] + [J.Scenario(v) for v in LABEL_SCENARIOS.values()]
    jss = J.ScenarioSet(ec, scen)
    tss = T.ScenarioSet(pec, port_scenarios(scen))
    assert pec.vocab.keys == ec.vocab.keys and pec.vocab.kvs == ec.vocab.kvs
    assert "pool" in pec.vocab.keys and ("pool", "blue") in pec.vocab.kvs
    assert (ZONE, "zz-fresh") in pec.vocab.kvs
    assert tss.max_domains == jss.max_domains and tss.labels_dirty == jss.labels_dirty
    labels = tss.labels()
    lrow = labels["lrow"].numpy()
    assert lrow[0] == 0 and (lrow[1:-1] > 0).all() and lrow[-1] == 0
    dc = jss.dc
    for s in range(len(scen)):
        ec_s = dataclasses.replace(
            ec, node_domain=np.asarray(dc.node_domain[s]),
            num_domains=np.asarray(dc.num_domains[s]),
            node_label_key=np.asarray(dc.node_label_key[s]),
            node_label_kv=np.asarray(dc.node_label_kv[s]),
            node_label_num=np.asarray(dc.node_label_num[s]))
        r = int(lrow[s])
        gdom = labels["gdom"][r].numpy()
        np.testing.assert_array_equal(gdom, C._group_dom_per_node(ec_s)[: gdom.shape[0]],
                                      err_msg=f"gdom {s}")
        gt = ec.group_topo
        np.testing.assert_array_equal(
            labels["gnd"][r].numpy(),
            np.where(gt >= 0, ec_s.num_domains[np.clip(gt, 0, None)], 0), err_msg=f"gnd {s}")
        np.testing.assert_array_equal(labels["sp_w"][r].numpy(),
                                      np.asarray(_spread_w_table(ec_s), np.float32),
                                      err_msg=f"sp_w {s}")
        np.testing.assert_array_equal(labels["expr_match"][r].numpy(),
                                      C.expr_match_matrix(ec_s), err_msg=f"expr_match {s}")
    # The reference's DynTables weights (existing domains) are the rank rows'.
    assert jss.dyn is not None
    np.testing.assert_array_equal(labels["sp_w"][lrow].numpy(), jss.dyn.sp_w_g)
    # Non-vacuous: the numeric relabel flips the Gt match, the tier flip the In.
    em = labels["expr_match"].numpy()
    assert (em[lrow[6]] != em[0]).any() and (em[lrow[7]] != em[0]).any()
    assert int(labels["gnd"][lrow[2]].sum()) > int(labels["gnd"][0].sum())  # a new zone


# -- (b) tests/test_whatif.py:106, :183 and :313 ---------------------------------


def test_set_label_rederives_domains():
    nodes = [Node(f"n{i}", {"cpu": 100}, labels={"zone": "za" if i < 3 else "zb"})
             for i in range(4)]
    sel = LabelSelector.make({"app": "w"})
    pods = [
        Pod(f"p{i}", labels={"app": "w"},
            topology_spread=[TopologySpreadConstraint(1, "zone", "DoNotSchedule", sel)],
            arrival_time=float(i), requests={"cpu": 1})
        for i in range(8)
    ]
    cluster = Cluster(nodes=nodes)
    ec, ep = encode(cluster, pods)
    scen = [J.Scenario(),
            J.Scenario([J.Perturbation("set_label", nodes=np.array([3]), key="zone",
                                       value="za")])]
    eng = port_engine(ec, ep, scen, collect_assignments=True)
    res = eng.run()
    jres = J.WhatIfEngine(ec, ep, scen, J_Config(), collect_assignments=True).run()
    assert res.engine == jres.engine == "v3"
    assert_rows_equal(res.assignments, jres.assignments, "jax what-if")
    for s, g in enumerate(greedy_per_scenario(cluster, pods, scen)):
        assert_rows_equal(res.assignments[s], g.assignments, f"greedy scenario {s}")
    assert res.placed.tolist() == [8, 8]
    a0 = res.assignments[0]
    assert (a0 < 3).any() and (a0 >= 3).any()
    assert (res.assignments[1] < 3).sum() > (a0 < 3).sum()


def test_labels_dirty_six_scenarios_equal_reference_and_scratch():
    """tests/test_whatif.py:183: an existing value with a capacity change,
    a new value, emptying the singleton zone, a node gaining the key and a
    taint-only scenario in one batch."""
    cluster = make_cluster(18, seed=5, taint_fraction=0.1)
    cluster.nodes[7].labels[ZONE] = "zonly"
    del cluster.nodes[11].labels[ZONE]
    pods, _ = make_workload(70, seed=5, with_affinity=True, with_spread=True,
                            with_tolerations=True)
    ec, ep = encode(cluster, pods)
    names = ("existing_value", "new_value", "empty_singleton", "gain_key", "taint_only")
    scen = [J.Scenario()] + [J.Scenario(LABEL_SCENARIOS[k]) for k in names]
    eng = port_engine(ec, ep, scen, chunk_waves=4, collect_assignments=True)
    res = eng.run()
    jeng = J.WhatIfEngine(ec, ep, scen, J_Config(), chunk_waves=4, collect_assignments=True)
    jres = jeng.run()
    assert res.engine == jres.engine == "v3" and jeng._dyn is not None
    assert_rows_equal(res.assignments, jres.assignments, "jax what-if")
    np.testing.assert_array_equal(res.placed, jres.placed)
    for s, g in enumerate(greedy_per_scenario(cluster, pods, scen)):
        assert_rows_equal(res.assignments[s], g.assignments, f"greedy scenario {s}")
    assert len({a.tobytes() for a in res.assignments}) > 3


def test_labels_dirty_with_completions_equal_reference_and_scratch():
    """tests/test_whatif.py:313: relabels with completions on the device
    release path."""
    cluster = make_cluster(6, seed=17, taint_fraction=0.1)
    del cluster.nodes[5].labels[ZONE]
    pods, _ = make_workload(400, seed=17, arrival_rate=40.0, duration_mean=1.5,
                            with_spread=True, with_tolerations=True)
    ec, ep = encode(cluster, pods)
    scen = [
        J.Scenario(),
        J.Scenario([J.Perturbation("set_label", nodes=np.array([0, 3]), key=ZONE,
                                   value="zone-1")]),
        J.Scenario([J.Perturbation("set_label", nodes=np.array([2]), key=ZONE,
                                   value="zz-new")]),
        J.Scenario([J.Perturbation("set_label", nodes=np.array([5]), key=ZONE,
                                   value="zone-0")]),
    ]
    eng = port_engine(ec, ep, scen, chunk_waves=4)
    assert eng.chunk_waves == 4
    assignments, placed = port_assignments(eng)
    res = eng.run()
    jres = J.WhatIfEngine(ec, ep, scen, J_Config(), chunk_waves=4).run()
    assert res.completions_on and jres.completions_on and res.engine == jres.engine == "v3"
    np.testing.assert_array_equal(res.placed, jres.placed)
    np.testing.assert_array_equal(res.placed, placed)
    for s, g in enumerate(greedy_per_scenario(cluster, pods, scen, completions_chunk_waves=4)):
        assert_rows_equal(assignments[s], g.assignments, f"greedy scenario {s}")
        assert int(placed[s]) == g.placed
    off = port_engine(ec, ep, scen, chunk_waves=4, completions=False).run()
    assert (off.placed != res.placed).any()


# -- (c) outside the DynTables envelope: the v2 fallback's role ------------------


def _k33_case():
    cluster = make_cluster(40, seed=21, taint_fraction=0.1)
    pods, _ = make_workload(160, seed=21, arrival_rate=30.0, duration_mean=2.0,
                            with_affinity=True, with_spread=True, with_tolerations=True)
    scen = [J.Scenario(),
            J.Scenario([J.Perturbation("set_label", nodes=np.arange(33), key=ZONE,
                                       value="zone-3")]),
            J.Scenario([J.Perturbation("set_label", nodes=np.array([4]), key=ZONE,
                                       value="zone-x")])]
    return cluster, pods, scen, 33, [1]


def _hostname_case():
    """More than 128 hostname domains (a hostname-scale key); the pods
    require the six nodes of pool ``a``, and every third one keeps leaders
    off its host. One scenario merges three of those hosts into one
    hostname, one renames a host to a fresh name (same partition)."""
    cluster = make_cluster(132, seed=8)
    for i, n in enumerate(cluster.nodes):
        n.labels[HOST] = f"h{i}"
        if i < 6:
            n.labels["pool"] = "a"
    pods, _ = make_workload(150, seed=8, arrival_rate=20.0, duration_mean=3.0,
                            with_affinity=True, with_spread=True)
    sel = LabelSelector.make({"role": "leader"})
    pool = NodeAffinitySpec(required=(NodeSelectorTerm((MatchExpression.make("pool", "In",
                                                                             ["a"]),)),))
    for i, p in enumerate(pods):
        p.node_affinity = pool
        if i % 3 == 0:
            p.pod_anti_affinity = PodAffinitySpec(
                required=(PodAffinityTerm(label_selector=sel, topology_key=HOST),))
    scen = [J.Scenario(),
            J.Scenario([J.Perturbation("set_label", nodes=np.array([0, 1]), key=HOST,
                                       value="h2")]),
            J.Scenario([J.Perturbation("set_label", nodes=np.array([5]), key=HOST,
                                       value="h-new")])]
    return cluster, pods, scen, 2, [1]


def _prebound_case():
    """Pre-bound pods on nodes that a scenario moves to another zone, under
    zone spread and zone affinity."""
    cluster = make_cluster(16, seed=12)
    pods, _ = make_workload(120, seed=12, arrival_rate=25.0, duration_mean=2.0,
                            with_affinity=True, with_spread=True)
    sel = LabelSelector.make({"app": "pinned"})
    pre = []
    for i in range(6):
        pre.append(Pod(f"pre-{i}", labels={"app": "pinned"}, requests={"cpu": 1.0},
                       arrival_time=0.0, node_name=f"node-{i}",
                       topology_spread=[TopologySpreadConstraint(1, ZONE, "DoNotSchedule",
                                                                 sel)]))
    for j, p in enumerate(pods[::4]):
        p.labels["app"] = "pinned"
        p.topology_spread = [TopologySpreadConstraint(1, ZONE, "DoNotSchedule", sel)]
        if j % 3 == 0:
            p.pod_affinity = PodAffinitySpec(
                required=(PodAffinityTerm(label_selector=sel, topology_key=ZONE),))
    pods = pre + pods
    scen = [J.Scenario(),
            J.Scenario([J.Perturbation("set_label", nodes=np.array([0, 1, 2]), key=ZONE,
                                       value="zone-5")]),
            J.Scenario([J.Perturbation("set_label", nodes=np.array([3, 4]), key=ZONE,
                                       value="zone-new")])]
    return cluster, pods, scen, 3, [1, 2]


OUTSIDE = {"k33": _k33_case, "hostname": _hostname_case, "prebound": _prebound_case}


@pytest.mark.parametrize("name", list(OUTSIDE))
def test_outside_the_envelope_equals_reference_and_scratch(name):
    """K = 33 relabelled nodes, a hostname-scale relabel and pre-bound pods
    each send the reference to its v2 fallback: the port reports the same
    engine, turns completions off with the same warning, and places as the
    JAX v2 engine and as greedy_replay of each relabelled cluster
    (arrivals only). The pre-bound case records a reference caveat: the
    JAX engine builds the pre-bound pods' planes from the base domains in
    every scenario, so it differs from greedy_replay where a relabel moves
    the node of a pre-bound pod; the port equals greedy_replay."""
    cluster, pods, scen, k, moved = OUTSIDE[name]()
    ec, ep = encode(cluster, pods)
    with pytest.warns(UserWarning, match="v2 fallback engine"):
        eng = port_engine(ec, ep, scen, chunk_waves=4, collect_assignments=True)
    with pytest.warns(UserWarning, match="v2 fallback engine"):
        jeng = J.WhatIfEngine(ec, ep, scen, J_Config(), chunk_waves=4,
                              collect_assignments=True)
    assert eng.engine == jeng.engine == "v2"
    assert eng.completions_on is False and jeng.completions_on is False
    assert eng.sset.relabelled == k
    res, jres = eng.run(), jeng.run()
    assert (res.engine, res.completions_on) == (jres.engine, jres.completions_on)
    anchors = greedy_per_scenario(cluster, pods, scen)
    for s, g in enumerate(anchors):
        assert_rows_equal(res.assignments[s], g.assignments, f"greedy scenario {s}")
    if name == "prebound":
        # Reference caveat (ROADMAP C): the JAX engine differs from
        # greedy_replay in the scenarios that move pre-bound pods' nodes.
        assert_rows_equal(jres.assignments[0], res.assignments[0], "jax what-if")
        for s in moved:
            assert (jres.assignments[s] != anchors[s].assignments).any(), s
    else:
        assert_rows_equal(res.assignments, jres.assignments, "jax what-if")
    for s in moved:  # non-vacuous: the relabel moves placements
        assert (res.assignments[s] != res.assignments[0]).any(), s


def test_completions_true_outside_the_envelope_raises_in_both():
    cluster, pods, scen, _, _ = _k33_case()
    ec, ep = encode(cluster, pods)
    with pytest.raises(ValueError, match="completions cannot be honored"):
        port_engine(ec, ep, scen, chunk_waves=4, completions=True)
    with pytest.raises(ValueError, match="completions cannot be honored"):
        J.WhatIfEngine(ec, ep, scen, J_Config(), chunk_waves=4, completions=True)


def test_collect_assignments_turns_completions_off_in_both():
    """Inside the envelope, collecting the assignments takes a relabelled
    batch off the reference's device-release path: completions off, with
    its warning. Without relabels the same batch keeps them on."""
    cluster, pods, scen, _, _ = _k33_case()
    scen = [scen[0], scen[2]]
    ec, ep = encode(cluster, pods)
    for make in (lambda **kw: port_engine(ec, ep, scen, chunk_waves=4, **kw),
                 lambda **kw: J.WhatIfEngine(ec, ep, scen, J_Config(), chunk_waves=4, **kw)):
        with pytest.warns(UserWarning, match="collect_assignments"):
            eng = make(collect_assignments=True)
        assert eng.engine == "v3" and eng.completions_on is False
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert make().completions_on is True
    plain = port_engine(ec, ep, [scen[0]] * 2, chunk_waves=4, collect_assignments=True)
    assert plain.completions_on is True


# -- (d) refusals -------------------------------------------------------------


@pytest.mark.parametrize("kw,match", [
    (dict(preemption=True), "what-if preemption requires the v3 engine"),
    (dict(retry_buffer=8), "label-perturbation DynTables"),
], ids=["preemption", "retry_buffer"])
def test_relabelled_batches_refuse_preemption_and_retry_in_both(kw, match):
    cluster, pods, scen, _, _ = _k33_case()
    scen = [scen[0], scen[2]]
    ec, ep = encode(cluster, pods)
    with pytest.raises(ValueError, match=match):
        port_engine(ec, ep, scen, **kw)
    with pytest.raises(ValueError, match=match):
        J.WhatIfEngine(ec, ep, scen, J_Config(), **kw)


def test_base_rows_when_no_scenario_relabels():
    """A batch without set_label keeps one label row and the base domain
    width: the tables of the single replay's shapes."""
    cluster = make_cluster(12, seed=2)
    pods, _ = make_workload(30, seed=2, with_spread=True)
    ec, ep = encode(cluster, pods)
    eng = port_engine(ec, ep, J.uniform_scenarios(ec, 4, seed=2))
    tb = eng._tables()
    cl = tb.cluster
    assert cl.gdom.shape[0] == cl.expr_match.shape[0] == cl.gnd.shape[0] == 1
    assert cl.lrow.tolist() == [0, 0, 0, 0]
    assert tb.state.match_count.shape[2] == max(ec.max_domains, 1)
    base = ref.cluster_to(port_case(ec, ep)[0], "cpu")
    for f in ("expr_match", "gdom", "gnd", "sp_w"):
        assert torch.equal(getattr(cl, f), getattr(base, f)), f
