"""The node-sharded chunk route (K9 ``shard_chunk_replay``, row B13's
``make_chunk_fn_sharded``) on the CPU, where the wrapper runs K9's plain
twin: the route ``"shard"`` (one K9 twin call a chunk) against the per-slot
shard route ``"shard_slot"`` (the twins of K1 -> K7 -> K8 a slot) on every
plane, against the port's replicated run, and against ``JaxReplayEngine``
under node shards and ``greedy_replay``; and the wrapper's refusals.

Tolerance: the two shard routes equal on every plane (``used``, the count
planes, the scratch rows, ``ext``, ``best_v`` / ``best_i``, ``cdom`` and the
choice buffer) bit for bit; assignments, placed and unschedulable exact
everywhere; ``used`` and ``match_count`` exact against the port's
replicated run and to ``tests/test_torch_shards.py``'s ``_same`` tolerances
(1e-3, 1e-5) against the JAX package. ``tests/test_torch_shards.py`` holds
the same route against ``JaxReplayEngine`` at every shard count it runs."""

import numpy as np
import pytest
import torch

from kubernetes_simulator_tpu.framework.framework import FrameworkConfig as J_Config
from kubernetes_simulator_tpu.models.encode import encode as j_encode
from kubernetes_simulator_tpu.sim.greedy import greedy_replay
from kubernetes_simulator_tpu.sim.jax_runtime import JaxReplayEngine
from kubernetes_simulator_tpu.sim.synthetic import make_cluster, make_workload
from kubernetes_simulator_tpu_torch.framework.framework import FrameworkConfig
from kubernetes_simulator_tpu_torch.ops import kernels as K
from kubernetes_simulator_tpu_torch.ops import reference as ref
from kubernetes_simulator_tpu_torch.sim.torch_runtime import (TorchReplayEngine, choose_route,
                                                              new_choices, run_waves)

from torch_port_case import port_case

#: node shards of the port's runs: 24 nodes in blocks of 12, 8 (three), 5
#: (one pad row at the end of the last shard) and 3
SHARDS = (2, 3, 5, 8)
#: the JAX engine's node shards (every count places alike:
#: tests/test_torch_shards.py)
JAX_SHARDS = 8
CHUNK_WAVES = 2


def _case(seed=7, n_nodes=24, n_pods=120):
    """tests/test_torch_shards.py's case cut to 120 pods, durationMean 0.5
    so that six of the eight boundaries release: taints, affinity, spread,
    tolerations, gangs of 4 (0.1)."""
    cluster = make_cluster(n_nodes, seed=seed, taint_fraction=0.2)
    pods, _ = make_workload(
        n_pods, seed=seed, with_affinity=True, with_spread=True,
        with_tolerations=True, gang_fraction=0.1, gang_size=4, duration_mean=0.5,
    )
    return j_encode(cluster, pods)


@pytest.fixture(scope="module")
def runs():
    """The case, the JAX engine at JAX_SHARDS shards, greedy_replay and the
    port's replicated run (K6's twin)."""
    ec, ep = _case()
    jres = JaxReplayEngine(ec, ep, J_Config(), chunk_waves=CHUNK_WAVES, node_shards=JAX_SHARDS,
                           telemetry="off").replay()
    greedy = greedy_replay(ec, ep, J_Config(), wave_width=8, completions_chunk_waves=CHUNK_WAVES)
    pec, pep = port_case(ec, ep)
    rep = TorchReplayEngine(pec, pep, FrameworkConfig(), chunk_waves=CHUNK_WAVES,
                            device="cpu").replay()
    return (pec, pep), jres, greedy, rep


def _planes(tb):
    out = {}
    for part in ("state", "scratch", "shards"):
        nt = getattr(tb, part)
        out.update({f"{part}.{f}": x for f, x in zip(nt._fields, nt) if torch.is_tensor(x)})
    return out


@pytest.mark.parametrize("P,paged", [(2, False), (3, False), (3, True), (5, False), (8, True)])
def test_shard_route_equals_slot_route_replicated_jax_greedy(runs, P, paged):
    """The case at node_shards=P (paged or resident): the route ``"shard"``
    equals ``"shard_slot"`` on every plane and the choice buffer, and places
    as the port's replicated run (exact ``used`` and ``match_count``), the
    JAX engine under shards and greedy_replay."""
    (pec, pep), jres, greedy, rep = runs
    eng = TorchReplayEngine(pec, pep, FrameworkConfig(), chunk_waves=CHUNK_WAVES, device="cpu",
                            node_shards=P, paged=paged)
    assert choose_route(False, True) == "shard" and eng.layout.n_pad == -(-24 // P) * P
    res = eng.replay()
    assert res.route == "shard" and (eng.last_pager is not None) == paged
    planes, choices = _planes(eng.last_tables), eng.last_choices
    assert int(eng.plan.gang_wave.sum()) > 0 and any(bk is not None for bk in eng.plan.buckets)
    slot_tb, _, slot_a, _, _ = eng._run(route="shard_slot")
    assert eng.last_route == "shard_slot"
    for name, x in _planes(slot_tb).items():
        assert torch.equal(planes[name], x), name
    np.testing.assert_array_equal(choices, eng.last_choices)
    np.testing.assert_array_equal(res.assignments, slot_a[0])
    for other, exact, where in ((rep, True, "the replicated run"), (jres, False, "JAX"),
                                (greedy, False, "greedy_replay")):
        np.testing.assert_array_equal(res.assignments, other.assignments, err_msg=where)
        assert (res.placed, res.unschedulable) == (other.placed, other.unschedulable), where
        tol = dict(rtol=0, atol=0) if exact else dict(atol=1e-3)
        np.testing.assert_allclose(res.state.used, other.state.used, err_msg=where, **tol)
        tol = dict(rtol=0, atol=0) if exact else dict(atol=1e-5)
        np.testing.assert_allclose(res.state.match_count, other.state.match_count,
                                   err_msg=where, **tol)


def test_wrapper_refuses_what_k9_refuses(runs):
    """``K.shard_chunk_replay`` refuses on CPU tensors what
    ``ksim_shard_chunk_replay`` refuses: replicated tables, tier preemption or
    the retry buffer beside shards, shards that do not tile the node axis, a
    wave wider than 1,024 slots, waves outside the plan or past the choice
    buffer, a malformed slot index; a call in range runs the twin."""
    (pec, pep), *_ = runs
    eng = TorchReplayEngine(pec, pep, FrameworkConfig(), chunk_waves=CHUNK_WAVES, device="cpu",
                            node_shards=3)
    plan = eng.plan
    tb = eng._tables()
    ch = new_choices(plan, 1, eng.pods.bound_node, "cpu")
    desc = plan.device_desc("cpu")
    idx, gang = desc.idx, desc.gang
    n = gang.numel()
    b = K.Bound(tb)

    def refused(tables, *args, match=None):
        with pytest.raises(ValueError, match=match):
            K.shard_chunk_replay(K.Bound(tables) if tables is not None else b, *args)

    rep_tb = TorchReplayEngine(pec, pep, FrameworkConfig(), chunk_waves=CHUNK_WAVES,
                               device="cpu")._tables()
    refused(rep_tb, idx, gang, ch, 0, 1, match="node-sharded")
    N, R = tb.state.used.shape[1:]
    pre = ref.new_preempt(np.zeros(pep.num_pods, np.int32), pep.group_id, plan.col_pod,
                          plan.col_relb, plan.idx.size, np.zeros((1, N, R), np.float32),
                          np.zeros((1, N), np.float32), 1, "cpu")
    refused(tb._replace(preempt=pre), idx, gang, ch, 0, 1, match="tier preemption")
    sh = tb.shards
    refused(tb._replace(shards=sh._replace(n_local=sh.n_local - 1)), idx, gang, ch, 0, 1,
            match="do not tile")
    wide = torch.full((2 * (K._MAX_WAVE + 1),), -1, dtype=torch.int32)
    refused(None, wide, torch.zeros(2, dtype=torch.uint8), ch, 0, 1, match="at most")
    refused(None, idx, gang, ch, 1, 0)
    refused(None, idx, gang, ch, 0, n + 1)
    refused(None, idx, gang, ch[:, : plan.idx.shape[1]], 0, 2)
    refused(None, idx.to(torch.int64), gang, ch, 0, 1, match="int32")
    refused(None, idx[:-1], gang, ch, 0, 1, match="int32")
    K.shard_chunk_replay(b, idx, gang, ch, 0, 0)  # an empty range does nothing
    assert bool((ch[:, : plan.idx.size] == -1).all())
    K.shard_chunk_replay(b, idx, gang, ch, 0, 1)
    assert int((ch[0, : plan.idx.shape[1]] >= 0).sum()) > 0


def test_run_waves_chunk_by_chunk_equals_one_call(runs):
    """The route ``"shard"`` over the plan in one ``run_waves`` call equals
    the same route chunk by chunk (a boundary's K8 release, then K9's twin
    over the chunk), and the per-slot twins wave by wave, at 3 shards."""
    (pec, pep), *_ = runs
    eng = TorchReplayEngine(pec, pep, FrameworkConfig(), chunk_waves=CHUNK_WAVES, device="cpu",
                            node_shards=3)
    plan = eng.plan
    nw = plan.idx.shape[0]
    out = []
    for route, step in (("shard", plan.C), ("shard_slot", 1)):
        tb = eng._tables()
        ch = new_choices(plan, 1, eng.pods.bound_node, "cpu")
        for w in range(0, nw, step):
            run_waves(plan, tb, ch, w, min(nw, w + step), plain=False, route=route)
        out.append((_planes(tb), ch))
    (p1, c1), (p2, c2) = out
    assert torch.equal(c1, c2)
    for name, x in p1.items():
        assert torch.equal(x, p2[name]), name
