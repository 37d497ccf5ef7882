"""Node-plane sharding (row B13) of the port's single replay against the JAX
package's, on the CPU: ``TorchReplayEngine(node_shards=s)`` against
``JaxReplayEngine(node_shards=s)`` (the conftest's 8 virtual devices),
``greedy_replay`` and the port's replicated run; the shard-select twin
against the unsharded select twin and against the JAX package's
``select_node_sharded`` under ``shard_map``, over random mid-replay states
carried across by ``convert.shard_state_from_numpy``; SHARD_PINS on
chip_smoke's Borg cut; the refusals; and the boundary-release repair of the
retry buffer on a Borg cut.

Tolerance: assignments, placed, unschedulable, the summary's counts and
every choice are exact; ``used`` and ``match_count`` against the JAX
package to ``tests/test_jax_parity.py::assert_parity``'s 1e-3 and 1e-5, and
between the port's own runs exact."""

import dataclasses
import os
import sys

import jax
import numpy as np
import pytest
import torch

from kubernetes_simulator_tpu.framework.framework import FrameworkConfig as J_Config
from kubernetes_simulator_tpu.models.encode import encode as j_encode
from kubernetes_simulator_tpu.sim import borg as J_borg
from kubernetes_simulator_tpu.sim.greedy import greedy_replay
from kubernetes_simulator_tpu.sim.jax_runtime import JaxReplayEngine
from kubernetes_simulator_tpu.sim.synthetic import make_cluster, make_workload
from kubernetes_simulator_tpu_torch.convert import shard_state_from_numpy
from kubernetes_simulator_tpu_torch.framework.framework import FrameworkConfig
from kubernetes_simulator_tpu_torch.models.encode import PAD
from kubernetes_simulator_tpu_torch.ops import reference as ref
from kubernetes_simulator_tpu_torch.parallel.shards import make_layout, shard_cluster
from kubernetes_simulator_tpu_torch.sim import borg as T_borg
from kubernetes_simulator_tpu_torch.sim.torch_runtime import StepSpec, TorchReplayEngine

from torch_port_case import port_case

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

#: node_shards of the port's runs: 24 nodes split evenly at 2, 3, 4 and 8
#: (shards of 3 nodes), and 5 pads the node axis to 25 rows
PORT_SHARDS = (1, 2, 3, 4, 5, 8)
#: node_shards of the JAX engine (at most the 8 virtual devices)
JAX_SHARDS = (1, 2, 4, 5, 8)


def _case(n_nodes=24, n_pods=220, seed=7):
    """tests/test_node_sharding.py:_case: taints, affinity, spread,
    tolerations, gangs of 4, durationMean 40 (completions on)."""
    cluster = make_cluster(n_nodes, seed=seed, taint_fraction=0.2)
    pods, _ = make_workload(
        n_pods, seed=seed, with_affinity=True, with_spread=True,
        with_tolerations=True, gang_fraction=0.1, gang_size=4, duration_mean=40.0,
    )
    return j_encode(cluster, pods)


@pytest.fixture(scope="module")
def runs():
    """The _case trace (24 nodes x 220 pods, chunkWaves 4): the JAX engine at
    each of JAX_SHARDS, greedy_replay, and the port's replicated run."""
    ec, ep = _case()
    jax_res = {s: JaxReplayEngine(ec, ep, J_Config(), chunk_waves=4, node_shards=s,
                                  telemetry="off").replay() for s in JAX_SHARDS}
    greedy = greedy_replay(ec, ep, J_Config(), wave_width=8, completions_chunk_waves=4)
    pec, pep = port_case(ec, ep)
    rep = TorchReplayEngine(pec, pep, FrameworkConfig(), chunk_waves=4, device="cpu").replay()
    return (ec, ep), (pec, pep), jax_res, greedy, rep


def _same(res, other, where, exact=True):
    np.testing.assert_array_equal(res.assignments, other.assignments, err_msg=where)
    assert (res.placed, res.unschedulable) == (other.placed, other.unschedulable), where
    if exact:
        np.testing.assert_array_equal(res.state.used, other.state.used, err_msg=where)
        np.testing.assert_array_equal(res.state.match_count, other.state.match_count,
                                      err_msg=where)
    else:
        np.testing.assert_allclose(res.state.used, other.state.used, atol=1e-3, err_msg=where)
        np.testing.assert_allclose(res.state.match_count, other.state.match_count, atol=1e-5,
                                   err_msg=where)


@pytest.mark.parametrize("s", PORT_SHARDS)
def test_sharded_replay_equals_jax_greedy_and_replicated(runs, s):
    """The _case trace: the port at node_shards=s on the CPU equals the JAX
    engine at s (and, where s exceeds nothing the JAX engine runs, its
    replicated run), greedy_replay and the port's replicated run."""
    _, (pec, pep), jax_res, greedy, rep = runs
    eng = TorchReplayEngine(pec, pep, FrameworkConfig(), chunk_waves=4, device="cpu",
                            node_shards=s)
    res = eng.replay()
    assert res.route == ("shard" if s > 1 else "chunk")
    if s > 1:
        assert eng.engine == "v2" and eng.layout.n_pad == -(-24 // s) * s
        assert eng.last_tables.state.used.shape[1] == eng.layout.n_pad
        assert {eng.layout.shard_device(p) for p in range(s)} == {eng.device}
    _same(res, rep, f"s={s} vs the port's replicated run")
    _same(res, greedy, f"s={s} vs greedy_replay", exact=False)
    _same(res, jax_res.get(s, jax_res[1]), f"s={s} vs JaxReplayEngine", exact=False)
    for k in ("placed", "unschedulable", "attempts", "preemptions", "retry_dropped"):
        assert getattr(res, k) == getattr(jax_res.get(s, jax_res[1]), k), k


def test_borg_cut_sharded_paged_pins():
    """chip_smoke.SHARD_CUT: config4's generator cut to 12 nodes x 5,000
    tasks, chunkWaves 32 (contended), at node_shards=4 with paged pod
    waves: the port on the CPU equals JaxReplayEngine(node_shards=4,
    paged=True) and greedy_replay, and SHARD_PINS."""
    sc = chip_smoke.SHARD_CUT
    kw = dict(nodes=sc["nodes"], tasks=sc["tasks"], seed=chip_smoke.SEED)
    jec, jep, _ = J_borg.make_borg_encoded(J_borg.BorgSpec(**kw))
    tec, tep, _ = T_borg.make_borg_encoded(T_borg.BorgSpec(**kw))
    res = TorchReplayEngine(tec, tep, FrameworkConfig(), chunk_waves=sc["chunk_waves"],
                            device="cpu", node_shards=sc["node_shards"], paged=True).replay()
    jres = JaxReplayEngine(jec, jep, J_Config(), chunk_waves=sc["chunk_waves"],
                           node_shards=sc["node_shards"], paged=True, telemetry="off").replay()
    gres = greedy_replay(jec, jep, J_Config(), wave_width=8,
                         completions_chunk_waves=sc["chunk_waves"])
    for other, where in ((jres, "JaxReplayEngine"), (gres, "greedy_replay")):
        np.testing.assert_array_equal(res.assignments, other.assignments, err_msg=where)
    got = dict(placed=res.placed, unschedulable=res.unschedulable,
               sha256=chip_smoke.assignments_sha256(res.assignments))
    assert got == chip_smoke.SHARD_PINS and res.route == "shard"


# ---------------------------------------------------------------------------
# The shard-select twin at random mid-replay states
# ---------------------------------------------------------------------------

#: nodes of the module case: 2 shards of 13, 3 of 9 (one pad row), 8 of 4
#: (six pad rows)
MODULE_NODES = 26
_JAX_SELECT = {}


def _jax_select(P, n_local, n_real):
    """The JAX package's select_node_sharded under shard_map over P of the
    virtual devices (as tests/test_mesh_hlo.py builds node-sharded
    programs): (scores [n_pad], feasible [n_pad], gdom_f [G, n_pad]) ->
    (choice, placed, gdom_at, has_dom), replicated."""
    key = (P, n_local, n_real)
    if key not in _JAX_SELECT:
        from jax.experimental.shard_map import shard_map
        from jax.sharding import PartitionSpec as PS

        from kubernetes_simulator_tpu.ops import tpu as JT
        from kubernetes_simulator_tpu.parallel import mesh as M

        ctx = JT.ShardCtx(axis=M.NODE_AXIS, n_local=n_local, n_real=n_real, nshards=P)
        body = lambda sc, fe, gd: JT.select_node_sharded(sc, fe, gd, ctx)
        _JAX_SELECT[key] = jax.jit(shard_map(
            body, mesh=M.make_node_mesh(P),
            in_specs=(PS(M.NODE_AXIS), PS(M.NODE_AXIS), PS(None, M.NODE_AXIS)),
            out_specs=(PS(), PS(), PS(), PS()), check_rep=False))
    return _JAX_SELECT[key]


def _module_case(P):
    """A 26-node case whose node ``n_local - 1`` (the last of shard 0) is
    copied onto node ``n_local`` (the first of shard 1) — allocatable,
    labels, taints, domains — so the two tie across the shard border."""
    cluster = make_cluster(MODULE_NODES, seed=3, taint_fraction=0.2)
    pods, _ = make_workload(120, seed=3, with_affinity=True, with_spread=True,
                            with_tolerations=True)
    ec, ep = j_encode(cluster, pods)
    a = -(-MODULE_NODES // P) - 1
    fields = {}
    for f in ("allocatable", "node_label_key", "node_label_kv", "node_label_num", "taint_key",
              "taint_kv", "taint_effect"):
        x = getattr(ec, f).copy()
        x[a + 1] = x[a]
        fields[f] = x
    nd = ec.node_domain.copy()
    nd[:, a + 1] = nd[:, a]
    return dataclasses.replace(ec, node_domain=nd, **fields), ep, a


def _states(ec, P, a, rng):
    """Mid-replay states of ``ec`` in the JAX package's v2 layout (used [N,
    R], node-space count planes [G, N], built by its domain_to_node_space):
    random usage and counts; every node full but the tied border pair;
    shard 1 full; every node full."""
    from kubernetes_simulator_tpu.ops.tpu import domain_to_node_space

    N, R = ec.allocatable.shape
    gdom, gnd, _ = ref.group_domains(ec)
    G, D = gdom.shape[0], max(ec.max_domains, 1)
    n_local = -(-N // P)

    def planes(used):
        mc = rng.integers(0, 3, size=(G, D)).astype(np.float32)
        aa = (rng.random((G, D)) < 0.1).astype(np.float32)
        pw = rng.integers(0, 4, size=(G, D)).astype(np.float32)
        for p in (mc, aa, pw):
            p[np.arange(D)[None, :] >= gnd[:, None]] = 0.0
        return (used.astype(np.float32),) + tuple(domain_to_node_space(x, gdom)
                                                  for x in (mc, aa, pw))

    full = ec.allocatable.copy()
    rand = ec.allocatable * rng.uniform(0.0, 0.9, size=(N, 1))
    pair = full.copy()
    pair[a] = pair[a + 1] = ec.allocatable[a] * 0.25
    shard1 = rand.copy()
    shard1[n_local:2 * n_local] = full[n_local:2 * n_local]
    return {"random": planes(rand), "border tie": planes(pair), "shard 1 full": planes(shard1),
            "all full": planes(full)}, gdom, D


@pytest.mark.parametrize("P", (2, 3, 8))
def test_shard_select_twin_equals_select_and_jax(P):
    """Random mid-replay states carried into the shard layout by
    convert.shard_state_from_numpy, at P = 2, 3 (a pad row) and 8 (six):
    for every pod, the shard-select twin's choice equals the unsharded
    normalize_select twin's bit for bit and the JAX package's
    select_node_sharded on the same totals; its domain ids equal the
    chosen node's (the JAX winner's gdom_at); ties across the shard border
    go to the lower global id; a full shard and a full cluster are
    handled."""
    rng = np.random.default_rng(P)
    jec, jep, a = _module_case(P)
    ec, ep = port_case(jec, jep)
    spec = StepSpec.from_config(ec, FrameworkConfig(), ep)
    layout = make_layout(ec.num_nodes, P, "cpu")
    nl, n_pad = layout.n_local, layout.n_pad
    states, gdom, D = _states(ec, P, a, rng)
    cl_u = ref.cluster_to(ec, "cpu")
    cl_s = ref.cluster_to(shard_cluster(ec, layout), "cpu")
    pods = ref.pods_to(ep, "cpu")
    G = gdom.shape[0]
    gdom_pad = np.full((G, n_pad), PAD, np.int32)
    gdom_pad[:, : ec.num_nodes] = gdom
    fn = _jax_select(P, nl, ec.num_nodes)
    seen = dict(ties=0, empty_shard=0, none=0, placed=0)
    for name, (used, mc, aa, pw) in states.items():
        st_s = shard_state_from_numpy(used, mc, aa, pw, gdom, ec.max_domains, layout, "cpu")
        st_u = ref.DevState(st_s.used[:, : ec.num_nodes].clone(),
                            *(x.clone() for x in st_s[1:]))
        tb_u = ref.Tables(cl_u, pods, st_u, ref.new_scratch(1, ec.num_nodes, "cpu"),
                          spec.consts())
        tb_s = ref.Tables(cl_s, pods, st_s, ref.new_scratch(1, n_pad, "cpu"), spec.consts(),
                          shards=ref.new_shards(P, nl, ec.num_nodes, 1, ep.num_pods, G, "cpu"))
        ch_u = torch.full((1, ep.num_pods), PAD, dtype=torch.int32)
        ch_s = ch_u.clone()
        for p in range(ep.num_pods):
            ref.filter_score(tb_u, p)
            ref.filter_score(tb_s, p)
            assert torch.equal(tb_s.scratch.feasible[:, ec.num_nodes:],
                               torch.zeros((1, n_pad - ec.num_nodes), dtype=torch.bool))
            ref.normalize_select(tb_u, p, ch_u, p)
            ref.shard_select(tb_s, p, ch_s, p)
            c = int(ch_u[0, p])
            assert int(ch_s[0, p]) == c, (name, p)
            dom = tb_s.shards.cdom[0, p].numpy()
            want = gdom[:, c] if c >= 0 else np.full(G, PAD)
            np.testing.assert_array_equal(dom, want, err_msg=f"{name}, pod {p}")
            total = np.zeros(n_pad, np.float32)
            feas = np.zeros(n_pad, bool)
            total[: ec.num_nodes] = ref.weighted_total(tb_u, p)[0].numpy()
            feas[: ec.num_nodes] = tb_u.scratch.feasible[0].numpy()
            jc, jplaced, jdom, jhas = fn(total, feas, gdom_pad.astype(np.float32))
            assert int(jc) == c and bool(jplaced) == (c >= 0), (name, p)
            if c >= 0:
                np.testing.assert_array_equal(np.where(np.asarray(jhas) > 0.5,
                                                       np.asarray(jdom), PAD), want)
            f = feas[:n_pad].reshape(P, nl)
            seen["placed"] += c >= 0
            seen["none"] += c < 0
            seen["empty_shard"] += bool((~f.any(axis=1)).any() and f.any())
            best = total[feas].max() if feas.any() else None
            seen["ties"] += bool(best is not None and feas[a] and feas[a + 1]
                                 and total[a] == total[a + 1] == best and c == a)
    assert all(seen.values()), seen


# ---------------------------------------------------------------------------
# Refusals, as the reference refuses; the port's own by name
# ---------------------------------------------------------------------------


def _tiny():
    return port_case(*_case(n_nodes=8, n_pods=40))


def test_tier_preemption_with_shards_refused_as_reference():
    jec, jep = _case(n_nodes=8, n_pods=40)
    ec, ep = port_case(jec, jep)
    with pytest.raises(ValueError) as want:
        JaxReplayEngine(jec, jep, J_Config(), node_shards=2, preemption=True)
    with pytest.raises(ValueError) as got:
        TorchReplayEngine(ec, ep, device="cpu", node_shards=2, preemption=True)
    assert str(got.value) == str(want.value)


def test_paged_with_retry_buffer_refused_as_reference():
    jec, jep = _case(n_nodes=8, n_pods=40)
    ec, ep = port_case(jec, jep)
    with pytest.raises(ValueError) as want:
        JaxReplayEngine(jec, jep, J_Config(), paged=True, retry_buffer=8)
    with pytest.raises(ValueError) as got:
        TorchReplayEngine(ec, ep, device="cpu", paged=True, retry_buffer=8)
    assert str(got.value) == str(want.value)


def test_whatif_refuses_node_shards_as_reference():
    from kubernetes_simulator_tpu_torch.sim.whatif import WhatIfEngine, uniform_scenarios

    ec, ep = _tiny()
    with pytest.raises(NotImplementedError, match="node_shards"):
        WhatIfEngine(ec, ep, uniform_scenarios(ec, 2, seed=0), FrameworkConfig(),
                     device="cpu", node_shards=2)


@pytest.mark.parametrize("kw, what", [
    (dict(retry_buffer=8), "retry_buffer with node_shards"),
    (dict(telemetry="series"), "telemetry series/timeline with node_shards"),
    (dict(telemetry="timeline"), "telemetry series/timeline with node_shards"),
])
def test_port_refuses_by_name_under_shards(kw, what):
    ec, ep = _tiny()
    with pytest.raises(NotImplementedError, match=what):
        TorchReplayEngine(ec, ep, device="cpu", node_shards=2, **kw)


@pytest.mark.parametrize("extra", [
    {"nodeShards": -1},
    {"nodeShards": 2, "devicePreemption": True},
    {"pagedWaves": True, "whatIf": {"retryBuffer": 8}},
    {"nodeShards": 4, "pagedWaves": True},
])
def test_validate_errors_equal_reference(tmp_path, extra):
    """The port's checks of nodeShards / pagedWaves give the JAX package's
    validate_config messages (kubernetes_simulator_tpu/cli.py:735-757); the
    CLI refuses a config that fails them."""
    import yaml

    from kubernetes_simulator_tpu import cli as J_cli
    from kubernetes_simulator_tpu.utils.config import SimConfig as J_SimConfig
    from kubernetes_simulator_tpu_torch import cli
    from kubernetes_simulator_tpu_torch.utils.config import SimConfig, shard_errors

    d = {"strategy": "jax", "cluster": {"synthetic": {"nodes": 8}},
         "workload": {"synthetic": {"pods": 40, "durationMean": 40.0}}, **extra}
    got = shard_errors(SimConfig.from_dict(d))
    want = [e for e in J_cli.validate_config(J_SimConfig.from_dict(d))
            if e.startswith(("nodeShards", "pagedWaves"))]
    assert got == want
    if got:
        path = tmp_path / "c.yaml"
        path.write_text(yaml.safe_dump(d))
        with pytest.raises(ValueError, match=got[0][:20]):
            cli.main(["run", str(path), "--device", "cpu"])


@pytest.mark.parametrize("budget, shards, paged", [
    (1, 0, False), (1, 2, False), (1, 0, True), (10**12, 0, False),
])
def test_replicated_budget_refused_where_reference_refuses(monkeypatch, budget, shards, paged):
    """KSIM_MAX_REPLICATED_BYTES (sim/jax_runtime.py:1108-1123): the port's
    estimate equals the reference's, and both engines refuse the same
    replicated runs (never a sharded one), naming node_shards / paged."""
    from kubernetes_simulator_tpu.sim.jax_runtime import replicated_resident_bytes as j_bytes
    from kubernetes_simulator_tpu_torch.sim.torch_runtime import replicated_resident_bytes

    jec, jep = _case(n_nodes=8, n_pods=40)
    ec, ep = port_case(jec, jep)
    for resident in (True, False):
        assert replicated_resident_bytes(ec, ep, resident) == j_bytes(jec, jep, resident)
    monkeypatch.setenv("KSIM_MAX_REPLICATED_BYTES", str(budget))
    outcomes = []
    for make in (lambda: JaxReplayEngine(jec, jep, J_Config(), node_shards=shards, paged=paged),
                 lambda: TorchReplayEngine(ec, ep, device="cpu", node_shards=shards,
                                           paged=paged)):
        try:
            make()
            outcomes.append(None)
        except ValueError as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]
    assert (outcomes[0] is not None) == (budget == 1 and shards <= 1)
    if outcomes[0]:
        assert "node_shards" in outcomes[0] and "paged" in outcomes[0]


# ---------------------------------------------------------------------------
# The repair: a retry boundary's pending and static releases, one delta
# ---------------------------------------------------------------------------


def test_retry_borg_cut_boundary_release_equals_greedy():
    """config4's generator cut to 10 nodes x 4,000 tasks (seed 3),
    chunkWaves 16, retryBuffer 32: Borg's 0.1-cpu requests are not binary
    fractions, and 21 boundaries release pending and static pods at one
    node. greedy_replay sums a boundary's pending and static releases into
    one delta (sim/boundary.py boundary_releases); the port's single replay
    does the same (``joint``, which ``replay`` passes) and equals it; the
    what-if's order (the two subtracted apart, ``joint=False``) places the
    same count with other assignments here. (JaxReplayEngine places 2,918
    here: its own divergence from greedy_replay, ROADMAP C.)"""
    kw = dict(nodes=10, tasks=4000, seed=3)
    jec, jep, _ = J_borg.make_borg_encoded(J_borg.BorgSpec(**kw))
    tec, tep, _ = T_borg.make_borg_encoded(T_borg.BorgSpec(**kw))
    eng = TorchReplayEngine(tec, tep, FrameworkConfig(), chunk_waves=16, device="cpu",
                            retry_buffer=32)
    res = eng.replay()
    assert (eng.plan.C, eng.retry_buffer) == (16, 32)
    gres = greedy_replay(jec, jep, J_Config(), wave_width=8, completions_chunk_waves=16,
                         retry_buffer=32)
    np.testing.assert_array_equal(res.assignments, gres.assignments)
    assert res.placed == gres.placed == 3045 and res.retry_dropped == gres.retry_dropped
    _, _, apart, placed_apart, _ = eng._run(joint=False)
    assert int(placed_apart[0]) == res.placed
    assert not np.array_equal(apart[0], res.assignments)


@pytest.mark.parametrize("seed", range(3))
def test_release_twins_sum_in_pair_order(seed):
    """The release twins' per-node sums (K3's and K8's: ``used`` deltas of
    0.1-cpu requests, many pairs on one node) run in pair order, one pass
    per rank among a node's pairs: equal bit for bit to a sequential loop,
    whatever order ``index_add_`` would keep among equal rows."""
    rng = np.random.default_rng(seed)
    M, N, R = 400, 7, 3
    rows = torch.as_tensor(rng.integers(0, N, size=M))
    vals = torch.as_tensor((rng.integers(1, 40, size=(M, R)) * 0.1).astype(np.float32))
    got = torch.zeros(N, R)
    ref._add_in_pair_order(got, rows, vals)
    want = torch.zeros(N, R)
    for k in range(M):
        want[rows[k]] += vals[k]
    assert torch.equal(got, want)
    # the same pairs in another order sum otherwise: the order is observable
    other = torch.zeros(N, R)
    ref._add_in_pair_order(other, rows.flip(0), vals.flip(0))
    assert not torch.equal(other, want)
