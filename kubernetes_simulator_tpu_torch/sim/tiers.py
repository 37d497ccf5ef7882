"""Tier preemption: the host helpers and the guards of the device mode.

Counterpart: ``kubernetes_simulator_tpu/sim/greedy.py`` (``priority_tiers``
:50, ``normalize_preemption`` :98) and the static gates of
``kubernetes_simulator_tpu/ops/tpu3.py`` (``V3Static.MAX_TIERS`` :226 and
its check :313-322, the hostname-scale ``is_host = nd_g > DMAX_COARSE``
rule :245, the singleton-topology flags ``single_g`` :249-258 and the
host-row refusal :383-388).

Semantics (the greedy anchor's): a pod that no node accepts may preempt
when it is non-gang with tier > 0 and no preemption has fired yet in this
wave of this scenario. It preempts on the node where evicting ALL non-gang
pods of lower tier bound there makes it fit — the resource fit after the
eviction, every other filter at its current value — ranking candidates by
``victims·1024 + max victim tier``, lowest first, ties to the lowest
index. Victims become unplaced and are never re-queued; their affinity
and spread counts stay ("phantom counts"); a completed pod is never a
victim and a victim never releases.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..models.encode import EncodedCluster, EncodedPods

#: The device mode carries at most this many distinct priorities.
MAX_TIERS = 8
#: A topology key with more domains than this is hostname-scale (the
#: reference keeps such groups in node-space "host planes").
DMAX_COARSE = 128


def priority_tiers(ep: EncodedPods) -> Tuple[np.ndarray, np.ndarray]:
    """(tiers [T] ascending distinct priorities, pod_tier [P] i32)."""
    tiers, inv = np.unique(ep.priority, return_inverse=True)
    return tiers.astype(np.int64), inv.astype(np.int32)


def normalize_preemption(preemption) -> Optional[str]:
    """False/None → None; True → "tier"; "tier"/"kube" pass through."""
    if preemption in (False, None):
        return None
    if preemption is True:
        return "tier"
    if preemption in ("tier", "kube"):
        return preemption
    raise ValueError(f"preemption must be False/True/'tier'/'kube', got {preemption!r}")


def _host_groups(ec: EncodedCluster, ep: EncodedPods, interpod: bool, spread: bool
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """([G] bool groups that a term the step reads names and whose topology
    key has more than DMAX_COARSE domains, [G] i32 their topology)."""
    G = max(ec.num_groups, 1)
    gt = ec.group_topo[:G] if ec.group_topo.shape[0] >= G else np.full(G, -1, np.int32)
    nd_g = np.where(gt >= 0, ec.num_domains[np.clip(gt, 0, None)], 0)
    is_host = nd_g > DMAX_COARSE
    ref = np.zeros(G, bool)
    for arr, on in ((ep.aff_req, interpod), (ep.anti_req, interpod),
                    (ep.spread_g, spread), (ep.pref_aff, interpod)):
        if on and arr.size:
            ref[np.unique(arr[arr >= 0])] = True
    return ref & is_host, gt


def has_host_rows(ec: EncodedCluster, ep: EncodedPods, interpod: bool, spread: bool) -> bool:
    """Does any term the step reads name a group whose topology key has
    more than DMAX_COARSE domains (the reference's host-plane rows)?
    ``interpod`` / ``spread``: the step's plugin flags (StepSpec)."""
    return bool(_host_groups(ec, ep, interpod, spread)[0].any())


def nonsingleton_host_rows(ec: EncodedCluster, ep: EncodedPods, interpod: bool,
                           spread: bool) -> bool:
    """Does such a host-plane row have a domain of more than one node (the
    reference's device releases cannot regroup it)?"""
    host, gt = _host_groups(ec, ep, interpod, spread)
    for t in np.unique(gt[host]):
        dom = ec.node_domain[t]
        if dom[dom >= 0].size and np.bincount(dom[dom >= 0]).max() > 1:
            return True
    return False


def check_tier_mode(ec: EncodedCluster, ep: EncodedPods, interpod: bool, spread: bool
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """The device mode's static gates, with the reference's errors; returns
    (tiers, pod_tier)."""
    tiers, pod_tier = priority_tiers(ep)
    if len(tiers) > MAX_TIERS:
        raise ValueError(
            f"device preemption supports <= {MAX_TIERS} priority tiers; trace has {len(tiers)}"
        )
    if has_host_rows(ec, ep, interpod, spread):
        raise ValueError(
            "device preemption is not supported together with hostname-scale topology "
            "terms (host planes); use the CPU event engine for full kube PostFilter "
            "semantics"
        )
    return tiers, pod_tier


def tier_planes(ep: EncodedPods, pod_tier: np.ndarray, Tt: int, num_nodes: int,
                num_resources: int) -> Tuple[np.ndarray, np.ndarray]:
    """Host (used_tier [Tt, N, R] f32, npods_tier [Tt, N] f32) of the
    pre-bound non-gang pods, added in pod order (ops/tpu3.py:483-533,
    ``DevState3.from_host``)."""
    used_tier = np.zeros((Tt, num_nodes, num_resources), np.float32)
    npods_tier = np.zeros((Tt, num_nodes), np.float32)
    for p in np.nonzero((ep.bound_node >= 0) & (ep.group_id < 0))[0]:
        t, n = int(pod_tier[p]), int(ep.bound_node[p])
        used_tier[t, n] += ep.requests[p]
        npods_tier[t, n] += 1.0
    return used_tier, npods_tier
