"""The node-shard layout of one scenario's node planes (row B13).

Counterparts: ``kubernetes_simulator_tpu/parallel/mesh.py`` —
``make_node_mesh`` (:98), ``pad_node_axis`` (:146), ``shard_node_planes``
(:159); ``kubernetes_simulator_tpu/ops/tpu.py`` — ``ShardCtx`` (:767),
``shard_gids`` (:780); and ``JaxReplayEngine._shard_cluster``
(``kubernetes_simulator_tpu/sim/jax_runtime.py:1180-1208``).

``P`` shards each hold a contiguous block of ``n_local = ceil(N / P)``
nodes of the node axis padded to ``n_pad = n_local · P``; shard ``p``'s row
``i`` is the node of global id ``gid = p · n_local + i``, so global id
order is the node order and a lowest-global-id tie-break equals the
unsharded argmax's lowest index. Every node-axis table (allocatable,
``used``, node labels and the expression matches derived from them,
taints, node → domain) is laid out ``[P, n_local, …]`` — the padded
``[n_pad, …]`` table, whose shard blocks are its contiguous row ranges —
and the pad rows carry the reference's neutral fill (zero capacity, PAD
labels, taints and domains, no-op taint effect). The kernels mask a pad
row infeasible whatever the fill (``gid >= n_real``).

The domain-space count planes ``[G, D]`` (``match_count``,
``anti_active``, ``pref_wsum``) are replicated state, as the reference's
``match_total`` is (``P()`` at sim/jax_runtime.py:484-490): on one device
the port keeps them once, and each shard reads them there.

The reference puts shard ``p`` on local device ``p`` and refuses more
shards than it sees (parallel/mesh.py:107-113). In the port every shard
sits on the engine's one device (:meth:`ShardLayout.shard_device`), the card or
the CPU the caller asked for; the shards' only cross-shard values go
through the exchange functions of :mod:`..ops.reference`, so spreading
them over several cards changes only those.
"""

from __future__ import annotations

from dataclasses import dataclass, replace as dc_replace

import numpy as np
import torch

from ..models.encode import PAD, EncodedCluster


@dataclass(frozen=True)
class ShardLayout:
    """``P`` shards of ``n_local`` nodes over ``n_real`` real nodes."""

    P: int
    n_real: int
    n_local: int
    device: torch.device

    @property
    def n_pad(self) -> int:
        return self.P * self.n_local

    def shard_device(self, p: int) -> torch.device:
        """The device of shard ``p``: every shard sits on the engine's one
        device."""
        if not 0 <= p < self.P:
            raise ValueError(f"shard {p} outside 0..{self.P - 1}")
        return self.device


def make_layout(n_real: int, node_shards: int, device) -> ShardLayout:
    """The layout of ``n_real`` nodes over ``node_shards`` shards (>= 1)."""
    P = int(node_shards)
    if P < 1:
        raise ValueError(f"node_shards must be >= 1, got {node_shards}")
    if n_real < 1:
        raise ValueError("a node-sharded replay needs at least one node")
    return ShardLayout(P=P, n_real=int(n_real), n_local=-(-int(n_real) // P),
                       device=torch.device(device))


def pad_node_axis(a: np.ndarray, axis: int, n_pad: int, fill) -> np.ndarray:
    """Host copy of ``a`` with its node ``axis`` padded to ``n_pad`` rows
    of ``fill`` (parallel/mesh.py:146)."""
    n = a.shape[axis]
    if n == n_pad:
        return np.asarray(a)
    pad = [(0, 0)] * a.ndim
    pad[axis] = (0, n_pad - n)
    return np.pad(np.asarray(a), pad, constant_values=fill)


def shard_cluster(ec: EncodedCluster, layout: ShardLayout) -> EncodedCluster:
    """``ec`` with its node axis padded to ``layout.n_pad`` rows of the
    reference's neutral fill (sim/jax_runtime.py:1180-1208): zero
    capacity, PAD labels (numeric 0), PAD taints with effect 0, PAD
    domains. ``ec`` itself is untouched; results keep the real node
    count."""
    n_pad = layout.n_pad
    pad = pad_node_axis
    names = list(ec.node_names) + [f"<pad-{i}>" for i in range(n_pad - ec.num_nodes)]
    return dc_replace(
        ec,
        node_names=names,
        num_nodes=n_pad,
        allocatable=pad(ec.allocatable, 0, n_pad, 0.0),
        node_label_key=pad(ec.node_label_key, 0, n_pad, PAD),
        node_label_kv=pad(ec.node_label_kv, 0, n_pad, PAD),
        node_label_num=pad(ec.node_label_num, 0, n_pad, 0.0),
        taint_key=pad(ec.taint_key, 0, n_pad, PAD),
        taint_kv=pad(ec.taint_kv, 0, n_pad, PAD),
        taint_effect=pad(ec.taint_effect, 0, n_pad, 0),
        node_domain=pad(ec.node_domain, 1, n_pad, PAD),
    )
