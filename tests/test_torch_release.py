"""K3's release grouping against its spec, on the CPU.

The release kernels (csrc/apply_placements.cu ``ksim_release``) sort each
tile of a release's pairs by the key (node, index in the tile) and sum each
node's requests from zero, tile by tile, in key order. ``_tile_grouped`` and
``_sub_grouped`` below are that grouping in plain torch. Held bit for bit (no
tolerance: the order is the point) against ``_add_in_pair_order``, the twins'
spec, and against the JAX package's ``release_delta`` (``np.add.at`` in pair
order), on Borg-shaped requests that are not binary fractions, with at least
100 pairs on one node. The kernels themselves are held against the twin on
the card (tests/test_torch_kernels_cuda.py ``test_release_equals_pair_order``)."""

import numpy as np
import pytest
import torch

from kubernetes_simulator_tpu.models.state import release_delta
from kubernetes_simulator_tpu_torch.ops import reference as ref
from kubernetes_simulator_tpu_torch.ops.kernels import RELEASE_TILE, release_tile
from kubernetes_simulator_tpu_torch.sim.borg import BorgSpec, make_borg_encoded

#: (pairs, seed): a release of `pairs` Borg tasks, a third of them (at least
#: 100) on node 0.
CASES = [(257, 1), (600, 2), (4000, 3), (4000, 4)]


def _tile_grouped(rows: torch.Tensor, tile: int):
    """The pairs of each row in the kernels' order: each tile's keys (row,
    index in the tile) sorted, a row's pairs its run in each tile, tile by
    tile. Returns {row: pair indices}."""
    K = rows.numel()
    out = {}
    for t0 in range(0, K, tile):
        r = rows[t0 : t0 + tile].long()
        keys = r * tile + torch.arange(r.numel())
        for key in torch.sort(keys).values.tolist():  # distinct keys: any sort is stable
            out.setdefault(key // tile, []).append(t0 + key % tile)
    return out


def _sub_grouped(target: torch.Tensor, rows: torch.Tensor, vals: torch.Tensor, tile: int):
    """``target[n] -= (row n's vals summed from zero in the grouped
    order)`` — the kernels' sums thread, plain."""
    for n, ks in _tile_grouped(rows, tile).items():
        acc = torch.zeros_like(target[n])
        for k in ks:
            acc = acc + vals[k]
        target[n] = target[n] - acc


@pytest.fixture(scope="module")
def borg():
    """The Borg cut's shape: 12 nodes x 5,000 tasks."""
    ec, ep, _ = make_borg_encoded(BorgSpec(nodes=12, tasks=5000, seed=0))
    return ec, ep


def _release(ec, ep, pairs, seed):
    rng = np.random.default_rng(seed)
    idx = np.sort(rng.choice(ep.num_pods, size=pairs, replace=False))
    nodes = rng.integers(0, ec.num_nodes, size=pairs)
    nodes[rng.choice(pairs, size=max(100, pairs // 3), replace=False)] = 0
    used0 = torch.as_tensor((rng.random((ec.num_nodes, ec.num_resources)) * 8).astype(np.float32))
    return idx, nodes, used0


@pytest.mark.parametrize("pairs,seed", CASES)
def test_group_by_row_is_a_stable_sort(pairs, seed):
    """The grouping keeps pair order within each row at the kernels' tile
    for one scenario on 132 SMs (a power of two, at most RELEASE_TILE): the
    rows' pairs in row order are a stable sort of the rows."""
    rows = torch.as_tensor(np.random.default_rng(seed).integers(0, 12, size=pairs))
    tile = release_tile(pairs, 1, 132)  # one scenario on an H100 SXM: tiles of 1,024
    assert tile <= RELEASE_TILE and tile & (tile - 1) == 0 and tile < 2 * pairs
    g = _tile_grouped(rows, tile)
    order = torch.as_tensor([k for n in sorted(g) for k in g[n]])
    assert torch.equal(order, torch.sort(rows, stable=True).indices)


@pytest.mark.parametrize("tile", (256, 32, 7))
@pytest.mark.parametrize("pairs,seed", CASES)
def test_grouped_release_equals_pair_order(borg, pairs, seed, tile):
    """used less each node's requests summed in the grouped order equals
    used less _add_in_pair_order's sums and less the JAX package's
    release_delta, bit for bit, at tiles that cut a node's pairs across
    2 to 572 tiles; the same requests summed in reverse order differ, so the
    test can see an order fault."""
    ec, ep = borg
    idx, nodes, used0 = _release(ec, ep, pairs, seed)
    req = torch.as_tensor(ep.requests[idx])
    rows = torch.as_tensor(nodes)
    assert not bool((req * 1024 == torch.round(req * 1024)).all())  # not binary fractions
    assert int(torch.bincount(rows).max()) >= 100
    got = used0.clone()
    _sub_grouped(got, rows, req, tile)
    delta = torch.zeros_like(used0)
    ref._add_in_pair_order(delta, rows, req)
    assert torch.equal(got, used0 - delta)
    jax_used = release_delta(ec, ep, idx, nodes)[0]
    assert torch.equal(got, used0 - torch.as_tensor(jax_used))
    rev = torch.zeros_like(used0)
    ref._add_in_pair_order(rev, rows.flip(0), req.flip(0))
    assert not torch.equal(rev, delta)
