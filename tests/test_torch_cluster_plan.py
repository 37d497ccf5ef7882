"""The launch geometry of the cluster selects (ops/kernels.py cluster_plan).

K2, K6, K7 and K9 launch as thread-block clusters whose size, block width, grid
and per-block node ranges or shard sets come from one plain function of the
shapes and the card's SM count. It runs here on the CPU with the SM counts of
H100 parts (132 SXM, 114 PCIe)."""

import pytest

from kubernetes_simulator_tpu_torch.ops.kernels import (
    CLUSTER_CAP,
    MIN_THREADS,
    SELECT_THREADS,
    ClusterPlan,
    chunk_plan,
    cluster_plan,
    shard_chunk_plan,
)

SMS = (132, 114)
SHAPES = [(1, 37), (1, 500), (1, 2000), (1, 5000), (1, 10_000), (4, 5000), (16, 10_000),
          (33, 3000), (128, 500), (128, 2000), (132, 2000), (300, 2000), (1000, 10_000)]
SHARDED = [(1, 8, 1250), (1, 3, 3334), (1, 12, 834), (1, 20, 500), (1, 3, 34), (1, 8, 5),
           (4, 8, 1250), (128, 8, 250), (300, 3, 700)]
#: Batches the card cannot hold at once (one 1,024-thread block an SM).
BEYOND = [(300, 2000), (1000, 10_000), (4096, 500)]


def _check_common(plan: ClusterPlan, S, sms):
    assert 1 <= plan.C <= min(16, CLUSTER_CAP)
    assert plan.grid % plan.C == 0 and plan.grid >= plan.C
    assert plan.threads % 32 == 0 and MIN_THREADS <= plan.threads <= SELECT_THREADS
    if S >= sms:
        assert plan.C == 1


def _check_ranges(plan: ClusterPlan, N):
    covered = []
    for r in range(plan.C):
        lo, hi = plan.node_range(r)
        assert lo < hi, (r, lo, hi)  # no rank is empty
        covered.extend(range(lo, hi))
    assert covered == list(range(N))  # every node once, in order
    assert plan.span % 32 == 0 and plan.C * plan.span >= N


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("S,N", SHAPES)
def test_select_plan(S, N, sms):
    """K2: one cluster a scenario (grid S·C), the node axis split into
    contiguous ranks of ``span`` nodes; C > 1 only while S leaves the card
    idle, and never more ranks than 1,024-node tiles."""
    plan = cluster_plan(S, N, sms=sms)
    _check_common(plan, S, sms)
    _check_ranges(plan, N)
    assert plan.grid == S * plan.C and plan.NP == 1
    assert plan.C <= max(1, -(-N // SELECT_THREADS))
    assert S * plan.C <= max(sms, S)
    assert plan == cluster_plan(S, N, sms=sms)  # a pure function


def _check_chunk(plan: ClusterPlan, S, N, sms):
    """K6: one cluster of C blocks of 1,024 threads a scenario (grid S·C),
    rank r owning its nodes in both phases, C = 1 once S fills the card."""
    _check_common(plan, S, sms)
    _check_ranges(plan, N)
    assert plan.threads == SELECT_THREADS and plan.NP == 1
    assert plan.grid == S * plan.C
    assert plan.C <= max(1, -(-N // SELECT_THREADS))
    assert S * plan.C <= max(sms, S)
    # the same C and span as K2's plan of the same shapes
    k2 = cluster_plan(S, N, sms=sms)
    assert (plan.C, plan.span) == (k2.C, k2.span)
    assert plan == chunk_plan(S, N, sms=sms)  # a pure function


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("S,N", SHAPES)
def test_chunk_plan(S, N, sms):
    """K6 at the main path's shapes: C > 1 while S leaves SMs idle (S = 1,
    N >= 2,048: a cluster; config4's 10,000 nodes: C = 8 of 1,280), the
    headline's 128 x 2,000 one block a scenario."""
    plan = chunk_plan(S, N, sms=sms)
    _check_chunk(plan, S, N, sms)
    if (S, N) == (128, 2000):
        assert plan.C == 1 and plan.grid == 128
    if (S, N) == (1, 10_000):
        assert plan.C == 8 and plan.span == 1280 and plan.node_range(7) == (8960, 10_000)
    if S == 1 and N >= 2 * SELECT_THREADS:
        assert plan.C > 1


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("S,N", BEYOND)
def test_chunk_plan_beyond_the_card(S, N, sms):
    """No residency cap: a batch of more scenarios than the card holds at
    once is one launch of S clusters (they run in waves)."""
    plan = chunk_plan(S, N, sms=sms)
    _check_chunk(plan, S, N, sms)
    assert plan.C == 1 and plan.grid == S > sms


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("S,NP,n_local", SHARDED)
def test_shard_plan(S, NP, n_local, sms):
    """K7: C = min(NP, the cap) blocks a scenario (C = 1 once S fills the
    card); block r reduces the shards r, r + C, ..., so every shard falls to
    exactly one block, each block's in shard order."""
    N = NP * n_local
    plan = cluster_plan(S, N, NP, sms=sms)
    _check_common(plan, S, sms)
    assert plan.NP == NP and plan.span == n_local and plan.grid == S * plan.C
    if S < sms:
        assert plan.C == min(NP, CLUSTER_CAP, sms // S)
    owned = [q for r in range(plan.C) for q in plan.shards(r)]
    assert sorted(owned) == list(range(NP))
    for r in range(plan.C):
        qs = plan.shards(r)
        assert qs and list(qs) == sorted(qs) and all(q % plan.C == r for q in qs)
    assert plan == cluster_plan(S, N, NP, sms=sms)


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("S,NP,n_local", SHARDED)
def test_shard_chunk_plan(S, NP, n_local, sms):
    """K9: K7's cluster size, grid and shard sets, in blocks of
    SELECT_THREADS (phase 1 runs K1's body a node a thread, n_local tiled by
    the block)."""
    N = NP * n_local
    plan = shard_chunk_plan(S, N, NP, sms=sms)
    k7 = cluster_plan(S, N, NP, sms=sms)
    assert plan.threads == SELECT_THREADS
    assert (plan.C, plan.grid, plan.span, plan.NP) == (k7.C, k7.grid, k7.span, k7.NP)
    assert [plan.shards(r) for r in range(plan.C)] == [k7.shards(r) for r in range(k7.C)]


@pytest.mark.parametrize("args,kw", [
    ((0, 100), dict(sms=132)),
    ((1, 0), dict(sms=132)),
    ((1, 100), dict(sms=0)),
    ((1, 100, 3), dict(sms=132)),
])
def test_plan_refuses(args, kw):
    """Empty shapes, no SM and shards that do not tile the node axis
    raise."""
    with pytest.raises(ValueError):
        cluster_plan(*args, **kw)
