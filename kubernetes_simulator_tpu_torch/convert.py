"""Carry an encoded case and a scheduling state across from the JAX package.

This system has no weights; the encoded tables and the carried state take
their place. These functions take plain numpy arrays — what
``dataclasses.asdict``-style field dicts of the JAX package's
``EncodedCluster`` / ``EncodedPods`` / ``SchedState`` hold — so a test can
feed both packages the identical case without the port importing
anything of the JAX package.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from .models.encode import EncodedCluster, EncodedPods, Vocab
from .ops.reference import DevState, stacked_state

_EC_ARRAYS = (
    "allocatable", "node_label_key", "node_label_kv", "node_label_num", "taint_key",
    "taint_kv", "taint_effect", "node_domain", "num_domains", "expr_key", "expr_op",
    "expr_vals", "expr_num", "group_topo",
)
_VOCAB = ("resources", "keys", "kvs", "namespaces", "topo_keys")
_EP_ARRAYS = (
    "requests", "priority", "arrival", "duration", "ns", "bound_node", "tol_key", "tol_kv",
    "tol_effect", "na_req", "na_has_req", "na_pref", "na_pref_w", "aff_req", "anti_req",
    "pref_aff", "pref_aff_w", "spread_g", "spread_skew", "spread_dns", "pod_matches_group",
    "group_id", "pg_min_member",
)


def encoded_from_numpy(
    ec_fields: Dict[str, object], ep_fields: Dict[str, object]
) -> Tuple[EncodedCluster, EncodedPods]:
    """The port's (EncodedCluster, EncodedPods) from numpy field dicts.

    ``ec_fields`` holds the cluster arrays by field name, ``max_domains``
    and the whole interning vocabulary: ``resources`` (name → row dict),
    ``keys``, ``kvs`` ((key, value) pairs), ``namespaces`` and
    ``topo_keys`` (lists in id order). A later interning of a new key or
    key/value pair (the what-if ``add_taint``) then gives the same id in
    both packages. Optional: ``node_names`` and ``group_keys`` (only their
    count is used; without them every group row with a topology key
    counts).
    ``ep_fields`` holds the pod arrays by field name; ``names`` and
    ``pg_names`` are optional."""
    missing = [k for k in _EC_ARRAYS + _VOCAB if k not in ec_fields]
    missing += [k for k in _EP_ARRAYS if k not in ep_fields]
    if missing:
        raise KeyError(f"missing fields: {', '.join(missing)}")
    res = dict(ec_fields["resources"])
    vocab = Vocab(
        resources=[name for name, _ in sorted(res.items(), key=lambda kv: kv[1])],
        keys=[str(k) for k in ec_fields["keys"]],
        kvs=[(str(k), str(v)) for k, v in ec_fields["kvs"]],
        namespaces=[str(n) for n in ec_fields["namespaces"]],
        topo_keys=[str(t) for t in ec_fields["topo_keys"]],
    )
    arr = {k: np.array(ec_fields[k], copy=True) for k in _EC_ARRAYS}
    N = arr["allocatable"].shape[0]
    G = len(ec_fields.get("group_keys") or []) or int((arr["group_topo"] >= 0).sum())
    ec = EncodedCluster(
        vocab=vocab,
        node_names=list(ec_fields.get("node_names") or [f"node-{i}" for i in range(N)]),
        num_nodes=N,
        max_domains=int(ec_fields["max_domains"]),
        group_keys=list(ec_fields.get("group_keys") or [None] * G),
        **arr,
    )
    parr = {k: np.array(ep_fields[k], copy=True) for k in _EP_ARRAYS}
    P = parr["requests"].shape[0]
    ep = EncodedPods(
        num_pods=P,
        names=list(ep_fields.get("names") or [f"pod-{i}" for i in range(P)]),
        pg_names=list(ep_fields.get("pg_names") or []),
        **parr,
    )
    return ec, ep


class CarriedState(NamedTuple):
    """One scheduling state on a device: the carried planes, as the S = 1
    stack the engines and kernels take, plus ``bound`` (the pod → node
    map, PAD = unbound)."""

    planes: DevState
    bound: torch.Tensor  # [P] i32


def state_from_numpy(used, match_count, anti_active, pref_wsum, bound, device) -> CarriedState:
    """Copy a host state (models.state.SchedState layout) to ``device``
    (always a copy: the planes are updated in place)."""
    return CarriedState(
        planes=stacked_state(used, match_count, anti_active, pref_wsum, 1, device),
        bound=torch.tensor(np.asarray(bound, np.int32), device=device),
    )


def shard_state_from_numpy(used, match_count, anti_active, pref_wsum, gdom, max_domains: int,
                           layout, device) -> DevState:
    """The JAX engine's padded node-space state in the port's shard layout.

    The inputs are the numpy form of the planes of the JAX package's v2
    (node-space) state (``JaxReplayEngine._to_dev_state_v2``): ``used
    [N_pad, R]`` and the count planes ``match_count`` / ``anti_active`` /
    ``pref_wsum`` ``[G, N_pad]``, each node's count of its domain under group
    g's key, with the node → domain map ``gdom [G, N_pad]`` (PAD: none) of
    the same node axis; its first ``layout.n_real`` rows are the real nodes.
    The result is an S = 1 DevState on ``device``: ``used`` over
    ``layout``'s padded node axis (pad rows 0; shard p's block its rows
    ``[p · n_local, (p + 1) · n_local)``) and the replicated domain-space
    planes ``[G, D]`` (D = ``max(max_domains, 1)``), each domain's count read
    at a node of it."""
    n = layout.n_real
    used = np.asarray(used, np.float32)[:n]
    gdom = np.asarray(gdom)[:, :n]
    G, D = gdom.shape[0], max(int(max_domains), 1)
    u = np.zeros((layout.n_pad, used.shape[1]), np.float32)
    u[:n] = used

    def dom(plane):
        plane = np.asarray(plane, np.float32)[:, :n]
        out = np.zeros((G, D), np.float32)
        g, m = np.nonzero(gdom >= 0)
        out[g, gdom[g, m]] = plane[g, m]
        return out

    return stacked_state(u, dom(match_count), dom(anti_active), dom(pref_wsum), 1, device)


def to_numpy(state: CarriedState) -> Dict[str, np.ndarray]:
    """The inverse of :func:`state_from_numpy`: field name → host array."""
    p = state.planes
    return {
        "used": p.used[0].cpu().numpy(),
        "match_count": p.match_count[0].cpu().numpy(),
        "anti_active": p.anti_active[0].cpu().numpy(),
        "pref_wsum": p.pref_wsum[0].cpu().numpy(),
        "bound": state.bound.cpu().numpy(),
    }
