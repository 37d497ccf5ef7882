"""The plain twins of the port's kernels against the reference chains.

Per pod, on the seeds of tests/test_oracle_parity.py: the K1 twin
(filter_score) and the K2 twin (normalize_select) give exactly the
feasibility mask, the per-plugin normalized scores, the weighted total and
the choice of the JAX chain (sim/jax_runtime.eval_pod + ops/tpu
select_node), and the mask, raw scores and choice of the numpy chain
(ops/cpu through SchedulerFramework). The K3 twin (apply_placements)
equals models/state bind / unbind / release_delta exactly. The K5 twin
(first_reject) gives eval_pod(want_masks=True)'s per-plugin masks and
ops/tpu first_reject_counts' counts. Tolerance: none
— the scores are integer-valued f32 floor chains and the planes are sums
of bucketed quantities, so everything compares bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_simulator_tpu.framework.framework import FrameworkConfig as J_Config
from kubernetes_simulator_tpu.framework.framework import SchedulerFramework
from kubernetes_simulator_tpu.models.encode import encode
from kubernetes_simulator_tpu.models.state import bind, init_state, release_delta, unbind
from kubernetes_simulator_tpu.ops import cpu as C
from kubernetes_simulator_tpu.ops import tpu as T
from kubernetes_simulator_tpu.sim.jax_runtime import StepSpec as J_StepSpec
from kubernetes_simulator_tpu.sim.jax_runtime import eval_pod
from kubernetes_simulator_tpu.sim.jax_runtime import spec_plugin_names as j_spec_plugin_names
from kubernetes_simulator_tpu.sim.synthetic import make_cluster, make_workload
from kubernetes_simulator_tpu_torch.framework.framework import FrameworkConfig
from kubernetes_simulator_tpu_torch.ops import reference as ref
from kubernetes_simulator_tpu_torch.sim.torch_runtime import StepSpec, spec_plugin_names

from test_oracle_parity import random_cluster_pods
from torch_port_case import port_case, port_state, scenario_tables

PAD = -1

#: NodeResourcesFit strategy per oracle seed: every strategy is walked.
_RTCR_SHAPE = [
    {"utilization": 0, "score": 0},
    {"utilization": 40, "score": 7},
    {"utilization": 100, "score": 3},
]
STRATEGIES = {
    0: None,
    1: None,
    2: [{"name": n} for n in ("TaintToleration", "NodeAffinity", "InterPodAffinity",
                              "PodTopologySpread")]
    + [{"name": "NodeResourcesFit", "args": {"strategy": "MostAllocated"}}],
    3: None,
    4: [{"name": "NodeResourcesFit", "args": {"strategy": "RequestedToCapacityRatio",
                                              "shape": _RTCR_SHAPE}},
        {"name": "TaintToleration"}, {"name": "NodeAffinity"},
        {"name": "InterPodAffinity"}, {"name": "PodTopologySpread"}],
    5: None,
}


@pytest.fixture(autouse=True)
def _deterministic():
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


def _tables(ec, ep, st, plugins):
    pec, pep = port_case(ec, ep)
    spec = StepSpec.from_config(pec, FrameworkConfig(plugins=plugins), pep)
    tb = ref.Tables(
        cluster=ref.cluster_to(pec, "cpu"), pods=ref.pods_to(pep, "cpu"),
        state=port_state(st).planes, scratch=ref.new_scratch(1, ec.num_nodes, "cpu"),
        consts=spec.consts(),
    )
    return tb


def _jax_state(ec, st):
    gdom = C._group_dom_per_node(ec)
    ns = lambda a: jnp.asarray(T.domain_to_node_space(a, gdom))
    return T.DevState(
        used=jnp.asarray(st.used), match_count=ns(st.match_count),
        anti_active=ns(st.anti_active), pref_wsum=ns(st.pref_wsum),
        match_total=jnp.asarray(st.match_count.sum(axis=1)),
    )


def _jax_rows(dc, d, dst, s, spec, feasible):
    """[5, N] per-plugin normalized rows of the JAX chain (eval_pod's
    terms; rows of plugins off in the spec are 0)."""
    N = dc.allocatable.shape[0]
    zero = jnp.zeros(N, jnp.float32)
    rows = [zero] * 5
    rw = np.asarray(spec.resource_weights, np.float32)
    if spec.fit:
        if spec.fit_strategy == "LeastAllocated":
            rows[0] = T.least_allocated_score(dc, dst, s, rw)
        elif spec.fit_strategy == "MostAllocated":
            rows[0] = T.most_allocated_score(dc, dst, s, rw)
        else:
            rows[0] = T.requested_to_capacity_ratio_score(
                dc, dst, s, rw, spec.shape_x, spec.shape_y)
    if spec.taints:
        rows[1] = T.normalize_max(T.taint_prefer_count(dc, s), feasible, reverse=True)
    if spec.node_affinity:
        rows[2] = T.normalize_max(T.node_affinity_score(d, s), feasible)
    if spec.interpod:
        rows[3] = T.normalize_min_max(
            T.interpod_score(d, dst, s, spec.has_symmetric_pref), feasible)
    if spec.spread:
        raw, ign, any_sp = T.spread_score_upstream(
            d, dst, s, T._padded_w_table(spec.sp_w_g, d.gdom_f.shape[0]))
        rows[4] = T.spread_upstream_normalize(raw, ign, feasible, any_sp, spec.sp_norm_f32)
    return jnp.stack(rows)


def _jax_chain(spec):
    """The per-slot JAX chain (mask, total, choice, normalized rows).

    Jitted, with the cluster tensors as arguments as the engines pass them
    (closed over as constants, XLA folds ``x / alloc`` into
    ``x · (1/alloc)``). RequestedToCapacityRatio runs op by op, as
    eval_pod is written: under jit XLA reassociates the shape's constant
    factors ``(u − x0)·(1/Δx)·Δy``, which moves a floor-quantized score
    by one against numpy (logged as a reference caveat in ROADMAP.md C)."""

    def step(dc, d, dst, s):
        f, total = eval_pod(dc, d, dst, s, spec)
        choice, _ = T.select_node(total, f)
        return f, total, choice, _jax_rows(dc, d, dst, s, spec, f)

    return step if spec.fit_strategy == "RequestedToCapacityRatio" else jax.jit(step)


@pytest.mark.parametrize("seed", range(6))
def test_filter_score_select_twins_match_reference_chains(seed):
    cluster, pods = random_cluster_pods(seed)
    plugins = STRATEGIES[seed]
    ec, ep = encode(cluster, pods)
    st = init_state(ec, ep)
    tb = _tables(ec, ep, st, plugins)
    fw = SchedulerFramework(ec, ep, J_Config(plugins=plugins))
    jspec = J_StepSpec.from_config(ec, J_Config(plugins=plugins), ep)
    dc = T.DevCluster.from_encoded(ec)
    d = T.Derived.build(dc)
    chain = _jax_chain(jspec)
    slots = T.gather_slots(ep, np.arange(ep.num_pods))
    rng = np.random.default_rng(seed + 99)
    choices = torch.full((1, 1), PAD, dtype=torch.int32)
    placed_any = 0
    for p in range(ep.num_pods):
        ref.filter_score(tb, p)
        ref.normalize_select(tb, p, choices, 0)
        choice = choices[0, 0]
        feas = tb.scratch.feasible[0].numpy()
        # JAX chain
        s = jax.tree.map(lambda a: a[p], slots)
        jf, jtotal, jchoice, jrows = chain(dc, d, _jax_state(ec, st), s)
        np.testing.assert_array_equal(feas, np.asarray(jf), err_msg=f"mask p={p}")
        np.testing.assert_array_equal(
            ref.normalized_rows(tb, p)[0].numpy(), np.asarray(jrows),
            err_msg=f"normalized rows p={p}")
        np.testing.assert_array_equal(
            ref.weighted_total(tb, p)[0].numpy(), np.asarray(jtotal), err_msg=f"total p={p}")
        assert int(choice) == int(jchoice), p
        # numpy chain
        np.testing.assert_array_equal(feas, fw.feasible_mask(st, p), err_msg=f"cpu mask p={p}")
        assert int(choice) == fw.schedule_one(st, p, allow_preemption=False).node, p
        sc = tb.scratch.scores[0].numpy()
        k = tb.consts
        if k.taints:
            np.testing.assert_array_equal(sc[ref.ROW_TAINT], C.taint_prefer_count(ec, ep, p))
        if k.node_affinity:
            np.testing.assert_array_equal(
                sc[ref.ROW_NA], C.node_affinity_score(fw.ctx.expr_match, ep, p))
        if k.interpod:
            np.testing.assert_array_equal(sc[ref.ROW_IP], C.interpod_score(ec, st, ep, p))
        if k.spread:
            craw = C.spread_score(ec, st, ep, p)
            if craw is not None:
                ign = tb.scratch.ignored[0].numpy()
                np.testing.assert_array_equal(ign, craw == -1)
                np.testing.assert_array_equal(sc[ref.ROW_SPREAD][~ign], craw[~ign])
        # Bind on a random feasible node in both states (K3 twin = bind).
        if feas.any():
            n = int(rng.choice(np.nonzero(feas)[0]))
            bind(ec, ep, st, p, n)
            ref.apply_placements(
                tb, torch.tensor([p], dtype=torch.int32), torch.tensor([0], dtype=torch.int32),
                torch.tensor([[n]], dtype=torch.int32), 1.0)
            placed_any += 1
        for name in ("used", "match_count", "anti_active", "pref_wsum"):
            np.testing.assert_array_equal(
                getattr(tb.state, name)[0].numpy(), getattr(st, name), err_msg=f"{name} p={p}")
    assert placed_any > 0


def _bound_case(seed=3, **wkw):
    cluster = make_cluster(20, seed=seed, taint_fraction=0.2)
    pods, _ = make_workload(
        90, seed=seed, with_affinity=True, with_spread=True, with_tolerations=True, **wkw)
    ec, ep = encode(cluster, pods)
    st = init_state(ec, ep)
    fw = SchedulerFramework(ec, ep, J_Config())
    for p in range(ep.num_pods):
        n = fw.schedule_one(st, p, allow_preemption=False).node
        if n != PAD:
            bind(ec, ep, st, p, n)
    return ec, ep, st


def test_apply_twin_release_equals_unbind_and_release_delta():
    ec, ep, st = _bound_case()
    tb = _tables(ec, ep, st, None)
    rel = np.nonzero(st.bound >= 0)[0][::2]
    nodes = st.bound[rel].copy()
    seq = st.copy()
    for p in rel:
        unbind(ec, ep, seq, int(p))
    du, dmc, daa, dpw = release_delta(ec, ep, rel, nodes)
    ref.apply_placements(
        tb, torch.tensor(rel, dtype=torch.int32), torch.arange(rel.size, dtype=torch.int32),
        torch.tensor(nodes, dtype=torch.int32)[None], -1.0)
    for name, delta in (("used", du), ("match_count", dmc), ("anti_active", daa),
                        ("pref_wsum", dpw)):
        got = getattr(tb.state, name)[0].numpy()
        np.testing.assert_array_equal(got, getattr(seq, name), err_msg=name)
        np.testing.assert_array_equal(got, getattr(st, name) - delta, err_msg=name)
    assert rel.size > 10


def test_apply_twin_gang_rollback_equals_unbind():
    ec, ep, st = _bound_case(seed=5, gang_fraction=0.3, gang_size=3)
    tb = _tables(ec, ep, st, None)
    gid = ep.group_id
    gangs = [g for g in np.unique(gid[gid >= 0]) if (st.bound[gid == g] >= 0).all()]
    assert len(gangs) >= 2
    failed, kept = gangs[0], gangs[1]
    fm = np.nonzero(gid == failed)[0]
    km = np.nonzero(gid == kept)[0]
    loner = np.nonzero((gid < 0) & (st.bound >= 0))[0][:1]
    # One wave: the failed gang with its last member unplaced, a complete
    # gang, a placed non-gang pod and a padded slot.
    wave = np.concatenate([fm, km, loner, [PAD]]).astype(np.int32)
    nodes = np.where(wave >= 0, st.bound[np.clip(wave, 0, None)], PAD).astype(np.int32)
    last = fm[-1]
    unbind(ec, ep, st, int(last))  # the unplaced member never bound
    ref.apply_placements(
        tb, torch.tensor([int(last)], dtype=torch.int32), torch.tensor([0], dtype=torch.int32),
        torch.tensor([[int(nodes[len(fm) - 1])]], dtype=torch.int32), -1.0)
    nodes[len(fm) - 1] = PAD
    expect_nodes = nodes.copy()
    expect_nodes[: len(fm)] = PAD
    for p in fm[:-1]:
        unbind(ec, ep, st, int(p))
    nodes_t = torch.tensor(nodes)[None]
    ref.apply_placements(tb, torch.tensor(wave), torch.arange(wave.size, dtype=torch.int32),
                         nodes_t, -1.0, rollback=True)
    np.testing.assert_array_equal(nodes_t[0].numpy(), expect_nodes)
    for name in ("used", "match_count", "anti_active", "pref_wsum"):
        np.testing.assert_array_equal(
            getattr(tb.state, name)[0].numpy(), getattr(st, name), err_msg=name)


def test_gang_rollback_mask_rules():
    """A placed member of a gang with an unplaced member in the same slot
    list rolls back; complete gangs, non-gang pods and PAD slots never."""
    pods = ref.DevPods(*[torch.zeros(1)] * (len(ref.DevPods._fields) - 1),
                       group_id=torch.tensor([0, 0, 1, 1, -1, 2], dtype=torch.int32))
    ids = torch.tensor([0, 1, 2, 3, 4, -1], dtype=torch.int32)
    nodes = torch.tensor([5, -1, 7, 8, -1, -1], dtype=torch.int32)
    mask = ref.gang_rollback_mask(pods, ids, nodes)
    assert mask.tolist() == [True, False, False, False, False, False]


def _assert_slices(batched, singles, where, parts=("state", "scratch")):
    for s, tb in enumerate(singles):
        for part in parts:
            for name in getattr(tb, part)._fields:
                got = getattr(getattr(batched, part), name)[s : s + 1]
                assert torch.equal(got, getattr(getattr(tb, part), name)), (where, s, name)


def test_batched_twins_equal_single_scenario_twins():
    """At S=3, slice s of each batched twin equals the same twin at S=1 on
    scenario s's tables: masks, score rows and choices slot after slot,
    the state after every bind, a bucketed release and a gang rollback."""
    ep, batched, singles = scenario_tables()
    P = ep.num_pods
    ids = torch.arange(P, dtype=torch.int32)
    ch_b = torch.full((3, P), PAD, dtype=torch.int32)
    ch_s = [torch.full((1, P), PAD, dtype=torch.int32) for _ in singles]
    for p in range(P):
        ref.filter_score(batched, p)
        ref.normalize_select(batched, p, ch_b, p)
        for s, tb in enumerate(singles):
            ref.filter_score(tb, p)
            ref.normalize_select(tb, p, ch_s[s], p)
            assert int(ch_s[s][0, p]) == int(ch_b[s, p]), (p, s)
        _assert_slices(batched, singles, f"slot {p} scores", ("scratch",))
        ref.apply_placements(batched, ids[p : p + 1], ids[p : p + 1], ch_b, 1.0)
        for s, tb in enumerate(singles):
            ref.apply_placements(tb, ids[p : p + 1], ids[p : p + 1], ch_s[s], 1.0)
        _assert_slices(batched, singles, f"slot {p} bind")
    # The scenarios differ, and some slots are unplaced.
    assert not torch.equal(ch_b[0], ch_b[1]) and not torch.equal(ch_b[1], ch_b[2])
    assert (ch_b < 0).any() and (ch_b >= 0).sum() > P
    # A release bucket: every third pod, each scenario's own node (PAD skipped).
    rel = ids[::3].contiguous()
    ref.apply_placements(batched, rel, rel, ch_b, -1.0)
    for s, tb in enumerate(singles):
        ref.apply_placements(tb, rel, rel, ch_s[s], -1.0)
    _assert_slices(batched, singles, "release")
    # A gang rollback over a wave of gang members, one member unplaced in
    # scenario 1 only.
    gid = ep.group_id
    g0 = int(gid[gid >= 0][0])
    wave = torch.as_tensor(np.nonzero(gid == g0)[0].astype(np.int32))
    ch_b[1, int(wave[-1])] = PAD
    ch_s[1][0, int(wave[-1])] = PAD
    ref.apply_placements(batched, wave, wave, ch_b, -1.0, rollback=True)
    for s, tb in enumerate(singles):
        ref.apply_placements(tb, wave, wave, ch_s[s], -1.0, rollback=True)
        assert torch.equal(ch_s[s][0], ch_b[s]), s
    _assert_slices(batched, singles, "rollback")
    assert (ch_b[1, wave.long()] == PAD).all() and (ch_b[0, wave.long()] >= 0).all()


def _jax_masks(spec):
    """eval_pod(want_masks=True)'s ordered per-plugin masks (jitted with the
    cluster tensors as arguments; the masks are exact booleans)."""
    return jax.jit(lambda dc, d, dst, s: eval_pod(dc, d, dst, s, spec, want_masks=True)[2])


@pytest.mark.parametrize("seed", range(6))
def test_first_reject_twin_matches_reference_counts(seed):
    """The K5 twin op by op against ops/tpu.py:816 first_reject_counts over
    eval_pod(want_masks=True), pod by pod at random mid-replay states (each
    pod then bound on a random feasible node): the per-plugin masks, the
    ungated counts, and the gated add with its episode rule (a pod no node
    admits charges attempts on every call and reasons on the first)."""
    cluster, pods = random_cluster_pods(seed)
    plugins = STRATEGIES[seed]
    ec, ep = encode(cluster, pods)
    st = init_state(ec, ep)
    tb = _tables(ec, ep, st, plugins)
    pec, pep = port_case(ec, ep)
    names = spec_plugin_names(StepSpec.from_config(pec, FrameworkConfig(plugins=plugins), pep))
    tb = tb._replace(reject=ref.new_reject(len(names), ep.num_pods, 1, "cpu"))
    jspec = J_StepSpec.from_config(ec, J_Config(plugins=plugins), ep)
    assert names == j_spec_plugin_names(jspec)
    dc = T.DevCluster.from_encoded(ec)
    d = T.Derived.build(dc)
    masks_of = _jax_masks(jspec)
    slots = T.gather_slots(ep, np.arange(ep.num_pods))
    rng = np.random.default_rng(seed + 7)
    gate = torch.full((1, 1), PAD, dtype=torch.int32)
    want_r = np.zeros(len(names), np.int64)
    rejecting = 0
    for p in range(ep.num_pods):
        s = jax.tree.map(lambda a: a[p], slots)
        jm = masks_of(dc, d, _jax_state(ec, st), s)
        tm = ref.filter_masks(tb, p)
        assert len(tm) == len(jm) == len(names)
        for k, (a, b) in enumerate(zip(tm, jm)):
            np.testing.assert_array_equal(a[0].numpy(), np.asarray(b), err_msg=f"p={p} {k}")
        counts, feasible = ref.first_reject_counts(tm)
        np.testing.assert_array_equal(counts[0].numpy(),
                                      np.asarray(T.first_reject_counts(jm, True)))
        failed = not bool(feasible[0])
        want = np.asarray(T.first_reject_counts(jm, failed))
        before = tb.reject.attempts.clone()
        pid = torch.tensor([p], dtype=torch.int32)
        for _ in range(2):  # a second failed attempt of the same episode
            ref.first_reject(tb, pid, gate)
        np.testing.assert_array_equal((tb.reject.attempts - before)[0].numpy(), 2 * want)
        want_r += want
        np.testing.assert_array_equal(tb.reject.reasons[0].numpy(), want_r)
        assert int(tb.reject.attributed[0, p]) == int(failed)
        rejecting += int(counts.sum() > 0)
        feas = np.asarray(jm[0])
        for m in jm[1:]:
            feas = feas & np.asarray(m)
        if feas.any():
            n = int(rng.choice(np.nonzero(feas)[0]))
            bind(ec, ep, st, p, n)
            ref.apply_placements(
                tb, torch.tensor([p], dtype=torch.int32), torch.tensor([0], dtype=torch.int32),
                torch.tensor([[n]], dtype=torch.int32), 1.0)
    assert rejecting > 0  # some plugin rejected some node


def test_first_reject_twin_gates_and_batches():
    """At S=3 the twin equals the S=1 twin on each scenario's tables; a
    placed gate, a PAD pod and a pod some node admits charge nothing; per
    scenario pods ([S, M], the retry pass) charge their own rows."""
    ep, batched, singles = scenario_tables()
    K_ = sum(map(bool, (batched.consts.fit, batched.consts.taints, batched.consts.node_affinity,
                        batched.consts.interpod, batched.consts.spread)))
    batched = batched._replace(reject=ref.new_reject(K_, ep.num_pods, 3, "cpu"))
    singles = [tb._replace(reject=ref.new_reject(K_, ep.num_pods, 1, "cpu")) for tb in singles]
    # Fill the state so that some pods fail: bind every pod where it fits.
    P = ep.num_pods
    ids = torch.arange(P, dtype=torch.int32)
    ch_b = torch.full((3, P), PAD, dtype=torch.int32)
    for p in range(P):
        ref.filter_score(batched, p)
        ref.normalize_select(batched, p, ch_b, p)
        ref.apply_placements(batched, ids[p : p + 1], ids[p : p + 1], ch_b, 1.0)
    for s, tb in enumerate(singles):
        for name in ref.DevState._fields:
            getattr(tb.state, name).copy_(getattr(batched.state, name)[s : s + 1])
    gate = torch.full((3, P), PAD, dtype=torch.int32)
    gate[:, ::5] = 0  # placed: never charged
    slot_pods = ids.clone()
    slot_pods[3] = PAD
    ref.first_reject(batched, slot_pods, gate)
    for s, tb in enumerate(singles):
        ref.first_reject(tb, slot_pods, gate[s : s + 1])
        for name in ref.Reject._fields:
            assert torch.equal(getattr(batched.reject, name)[s : s + 1],
                               getattr(tb.reject, name)), (s, name)
    assert int(batched.reject.attempts.sum()) > 0
    assert not bool(batched.reject.attributed[:, ::5].any())
    assert not bool(batched.reject.attributed[:, 3].any())
    # One pod per scenario: scenario s attributes pod q_s at its own state.
    q = torch.tensor([[P - 1], [P - 2], [PAD]], dtype=torch.int32)
    before = batched.reject.attempts.clone()
    ref.first_reject(batched, q, torch.full((3, 1), PAD, dtype=torch.int32))
    for s, tb in enumerate(singles):
        if int(q[s, 0]) >= 0:
            ref.first_reject(tb, q[s], torch.full((1, 1), PAD, dtype=torch.int32))
        assert torch.equal(batched.reject.attempts[s : s + 1], tb.reject.attempts), s
    assert torch.equal(batched.reject.attempts[2], before[2])


# -- per-scenario policy rows (row B1w) ------------------------------------------

#: Four policy rows: the default, non-integer weights under MostAllocated,
#: a zero weight, non-integer weights under LeastAllocated.
POLICY_ROWS = np.array([
    [1.0, 3.0, 2.0, 2.0, 2.0, 1.0],
    [2.3125, 0.7, 4.1, 1.55, 3.3, 0.0],
    [1.0, 0.0, 2.0, 0.0, 5.25, 1.0],
    [9.99, 0.125, 0.3333, 7.77, 0.01, 1.0],
], np.float32)


@pytest.mark.parametrize("plugins", [None, STRATEGIES[4]], ids=["least", "ratio"])
def test_policy_row_twins_match_traced_fold(plugins):
    """K1's strategy row and K2's weight row, op by op, against the JAX
    package's traced fold (ops/tpu.py eval_pod_fused(wvec), eager): at each
    slot of real waves, for each policy row, the mask, the fit row of the
    row's strategy (the selector ignored under RequestedToCapacityRatio),
    the weighted total where feasible and the choice."""
    from kubernetes_simulator_tpu.sim.waves import pack_waves

    cluster = make_cluster(12, seed=8, taint_fraction=0.3)
    pods, _ = make_workload(24, seed=8, with_affinity=True, with_spread=True,
                            with_tolerations=True)
    ec, ep = encode(cluster, pods)
    st = init_state(ec, ep)
    R = POLICY_ROWS.shape[0]
    pec, pep = port_case(ec, ep)
    spec = StepSpec.from_config(pec, FrameworkConfig(plugins=plugins), pep)
    wrow = torch.from_numpy(POLICY_ROWS.copy())
    ps = port_state(st).planes
    tb = ref.Tables(
        cluster=ref.cluster_to(pec, "cpu"), pods=ref.pods_to(pep, "cpu"),
        state=ref.stacked_state(*(x[0].numpy() for x in ps), R, "cpu"),
        scratch=ref.new_scratch(R, ec.num_nodes, "cpu"), consts=spec.consts(traced=True),
        wrow=wrow,
    )
    jspec = J_StepSpec.from_config(ec, J_Config(plugins=plugins), ep)
    dc = T.DevCluster.from_encoded(ec)
    d = T.Derived.build(dc)
    rw = np.asarray(jspec.resource_weights, np.float32)
    sb = T.gather_slots(ep, pack_waves(ep, 8).idx)
    rng = np.random.default_rng(8)
    choices = torch.full((R, 1), PAD, dtype=torch.int32)
    checked = 0
    for wi in range(sb.pod_id.shape[0]):
        wave = jax.tree.map(lambda a: a[wi], sb)
        pre = T.build_wave_pre(dc, d, wave, jspec)
        widths = T.wave_widths(wave, jspec)
        for k in range(8):
            p = int(wave.pod_id[k])
            if not bool(wave.valid[k]):
                continue
            s = jax.tree.map(lambda a: a[k], wave)
            pk = jax.tree.map(lambda a: a[k], pre)
            dst = _jax_state(ec, st)
            ref.filter_score(tb, p)
            ref.normalize_select(tb, p, choices, 0)
            total = ref.weighted_total(tb, p)
            for r in range(R):
                f1, sc1, _ = T.eval_pod_fused(dc, d, dst, s, pk, jspec, widths,
                                              wvec=jnp.asarray(POLICY_ROWS[r]))
                f1 = np.asarray(f1)
                np.testing.assert_array_equal(tb.scratch.feasible[r].numpy(), f1)
                if jspec.fit_strategy in ("LeastAllocated", "MostAllocated"):
                    least = POLICY_ROWS[r, 5] > 0.5
                    fit = (T.least_allocated_score if least else T.most_allocated_score)(
                        dc, dst, s, rw)
                else:
                    fit = T.requested_to_capacity_ratio_score(
                        dc, dst, s, rw, jspec.shape_x, jspec.shape_y)
                np.testing.assert_array_equal(
                    tb.scratch.scores[r, ref.ROW_FIT].numpy(), np.asarray(fit),
                    err_msg=f"fit row p={p} r={r}")
                np.testing.assert_array_equal(total[r].numpy()[f1], np.asarray(sc1)[f1],
                                              err_msg=f"total p={p} r={r}")
                node, placed = T.select_node(sc1, jnp.asarray(f1))
                assert int(choices[r, 0]) == (int(node) if bool(placed) else PAD), (p, r)
                checked += 1
            feas = tb.scratch.feasible[0].numpy()
            if feas.any():  # every row binds the same node: one shared state
                n = int(rng.choice(np.nonzero(feas)[0]))
                bind(ec, ep, st, p, n)
                ref.apply_placements(
                    tb, torch.tensor([p], dtype=torch.int32),
                    torch.tensor([0], dtype=torch.int32),
                    torch.full((R, 1), n, dtype=torch.int32), 1.0)
    assert checked == 4 * ep.num_pods
    if plugins is not None:  # the selector is inert: rows 0 and 1 share a fit row
        np.testing.assert_array_equal(tb.scratch.scores[0, ref.ROW_FIT].numpy(),
                                      tb.scratch.scores[1, ref.ROW_FIT].numpy())


def test_traced_consts_keep_zero_weight_rows():
    """Static mode gates a zero-weight plugin out of the total; traced
    mode keeps every enabled row in (ops/tpu.py:62 policy_weight_fns)."""
    ec, ep = encode(make_cluster(6, seed=1, taint_fraction=0.5),
                    make_workload(20, seed=1, with_affinity=True, with_spread=True,
                                  with_tolerations=True)[0])
    pec, pep = port_case(ec, ep)
    cfg = FrameworkConfig(weights={"NodeAffinity": 0.0, "PodTopologySpread": 0.0})
    spec = StepSpec.from_config(pec, cfg, pep)
    static, traced = spec.consts(), spec.consts(traced=True)
    assert (static.on_na, static.on_sp) == (False, False)
    assert (traced.on_na, traced.on_sp) == (spec.node_affinity, spec.spread) == (True, True)
    assert traced.on_fit == static.on_fit and traced.on_taint == static.on_taint
