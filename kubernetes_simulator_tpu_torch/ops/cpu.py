"""Vectorized scheduling kernels, numpy host edition.

Counterpart: ``kubernetes_simulator_tpu/ops/cpu.py`` (a copy, numpy
only). Each function evaluates one extension-point predicate/score for ONE
pending pod against ALL nodes at once. The port's CPU scheduler framework
(:mod:`..framework.framework`, the plugins of :mod:`..plugins.builtin`) runs
them, and through it :func:`..sim.greedy.greedy_replay`, the policy tuner's
oracle and the port's own CPU anchor. :mod:`.reference` carries the same
math in torch over S-stacked device tables (the kernels' plain twins); the
two must agree exactly.

Semantics are upstream kube-scheduler plugin semantics ([K8S]).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..models.encode import PAD, TOL_PAD, TOL_WILDCARD, EncodedCluster, EncodedPods
from ..models.core import Effect, Operator
from ..models.state import SchedState

MAX_NODE_SCORE = 100.0


# ---------------------------------------------------------------------------
# Node-selector expression matching
# ---------------------------------------------------------------------------

def expr_match_matrix(ec: EncodedCluster) -> np.ndarray:
    """``M[n, e]`` — does node n satisfy interned expression e.

    Computed once per (scenario) cluster state from the label tensors, so
    label perturbations re-flow without re-encoding. [K8S] semantics:
    In/Gt/Lt require the key present; NotIn/DoesNotExist also match when the
    key is absent.
    """
    nk = ec.node_label_key[:, :, None]  # [N, L, 1]
    nv = ec.node_label_kv[:, :, None]
    ek = ec.expr_key[None, None, :]  # [1, 1, E]
    key_present = np.any((nk == ek) & (nk != PAD), axis=1)  # [N, E]
    # In: node kv ∈ expr value set (kv ids embed the key, so one equality).
    in_set = np.any(
        (nv[:, :, :, None] == ec.expr_vals[None, None, :, :]) & (nv[:, :, :, None] != PAD),
        axis=(1, 3),
    )  # [N, E]
    num = ec.node_label_num[:, :, None]  # [N, L, 1]
    with np.errstate(invalid="ignore"):
        gt = np.any((nk == ek) & (num > ec.expr_num[None, None, :]), axis=1)
        lt = np.any((nk == ek) & (num < ec.expr_num[None, None, :]), axis=1)
    op = ec.expr_op[None, :]
    return (
        ((op == Operator.IN) & key_present & in_set)
        | ((op == Operator.NOT_IN) & ~(key_present & in_set))
        | ((op == Operator.EXISTS) & key_present)
        | ((op == Operator.DOES_NOT_EXIST) & ~key_present)
        | ((op == Operator.GT) & gt)
        | ((op == Operator.LT) & lt)
    )


def selector_terms_match(M: np.ndarray, terms: np.ndarray) -> np.ndarray:
    """OR over terms of AND over expressions. ``terms``: [T, E_slots] expr
    ids (PAD-padded); a term is valid iff its first slot is a real expr.
    Returns [N] bool."""
    valid_term = terms[:, 0] >= 0  # [T]
    safe = np.clip(terms, 0, None)
    per_expr = M[:, safe] | (terms[None, :, :] < 0)  # padding exprs auto-true
    per_term = np.all(per_expr, axis=2) & valid_term[None, :]
    if not valid_term.any():
        return np.zeros(M.shape[0], dtype=bool)
    return np.any(per_term, axis=1)


# ---------------------------------------------------------------------------
# NodeResourcesFit ([K8S] noderesources; [BASELINE] LeastAllocated)
# ---------------------------------------------------------------------------

def fit_mask(ec: EncodedCluster, st: SchedState, pods: EncodedPods, p: int) -> np.ndarray:
    req = pods.requests[p]  # [R]
    return np.all(st.used + req[None, :] <= ec.allocatable + 1e-6, axis=1)


# Scores are INTEGER-valued f32 ([K8S] computes int64 node scores; we floor
# through single-op chains — sub/div/mul/floor, nothing XLA can FMA-fuse —
# so the CPU and device paths are bit-identical and argmax ties break the
# same way; SURVEY.md §7 hard part #6).


def _int_resource_score(frac: np.ndarray, weights: np.ndarray) -> np.ndarray:
    """floor(frac_r·100) per resource, exact weighted mean, floored."""
    s = np.floor(frac * np.float32(MAX_NODE_SCORE))  # [N, R], integral
    acc = np.zeros(frac.shape[0], dtype=np.float32)
    wsum = 0.0
    for r in range(frac.shape[1]):
        w = float(weights[r])
        if w != 0:
            acc = acc + s[:, r] * np.float32(w)  # exact: small ints
            wsum += w
    if wsum == 0:
        return acc
    return np.floor(acc / np.float32(wsum))


def least_allocated_score(
    ec: EncodedCluster, st: SchedState, pods: EncodedPods, p: int, weights: np.ndarray
) -> np.ndarray:
    """``floor(Σ_r w_r·floor(100·(alloc_r−used_r−req_r)/alloc_r) / Σw)``;
    rows with alloc==0 contribute 0 ([K8S] leastAllocatedScorer, integer
    node scores)."""
    req = pods.requests[p][None, :]
    alloc = ec.allocatable
    with np.errstate(divide="ignore", invalid="ignore"):
        frac = np.where(alloc > 0, (alloc - st.used - req) / np.where(alloc > 0, alloc, 1.0), 0.0)
    frac = np.clip(frac, 0.0, 1.0)
    return _int_resource_score(frac, weights)


def most_allocated_score(
    ec: EncodedCluster, st: SchedState, pods: EncodedPods, p: int, weights: np.ndarray
) -> np.ndarray:
    req = pods.requests[p][None, :]
    alloc = ec.allocatable
    with np.errstate(divide="ignore", invalid="ignore"):
        frac = np.where(alloc > 0, (st.used + req) / np.where(alloc > 0, alloc, 1.0), 0.0)
    frac = np.clip(frac, 0.0, 1.0)
    return _int_resource_score(frac, weights)


def piecewise_interp_int(util: np.ndarray, xs, ys) -> np.ndarray:
    """Integer-valued piecewise-linear eval: seg = y0 + floor(t·Δy). Shared
    formula with :mod:`.reference` and the kernels (single-op chains; no
    np.interp)."""
    out = np.full_like(util, np.float32(ys[-1]), dtype=np.float32)
    for i in range(len(xs) - 2, -1, -1):
        x0, x1 = np.float32(xs[i]), np.float32(xs[i + 1])
        y0, y1 = np.float32(ys[i]), np.float32(ys[i + 1])
        t = (util.astype(np.float32) - x0) * (np.float32(1.0) / (x1 - x0))
        seg = y0 + np.floor(t * (y1 - y0))
        out = np.where(util <= x1, seg, out)
    return np.where(util <= np.float32(xs[0]), np.float32(ys[0]), out).astype(np.float32)


def requested_to_capacity_ratio_score(
    ec: EncodedCluster,
    st: SchedState,
    pods: EncodedPods,
    p: int,
    weights: np.ndarray,
    shape_x: np.ndarray,
    shape_y: np.ndarray,
) -> np.ndarray:
    """Piecewise-linear function of utilization ([K8S]
    RequestedToCapacityRatio shape points; x in [0,100] utilization, y in
    [0,100] score)."""
    req = pods.requests[p][None, :]
    alloc = ec.allocatable
    with np.errstate(divide="ignore", invalid="ignore"):
        frac = np.where(alloc > 0, (st.used + req) / np.where(alloc > 0, alloc, 1.0), 0.0)
    util = np.floor(np.clip(frac, 0.0, 1.0) * np.float32(100.0))
    score_r = piecewise_interp_int(util, list(shape_x), list(shape_y))  # [N, R]
    acc = np.zeros(ec.num_nodes, dtype=np.float32)
    wsum = 0.0
    for r in range(score_r.shape[1]):
        w = float(weights[r])
        if w != 0:
            acc = acc + score_r[:, r] * np.float32(w)
            wsum += w
    if wsum == 0:
        return acc
    return np.floor(acc / np.float32(wsum))


# ---------------------------------------------------------------------------
# TaintToleration ([K8S] tainttoleration)
# ---------------------------------------------------------------------------

def _untolerated(ec: EncodedCluster, pods: EncodedPods, p: int, effects: np.ndarray) -> np.ndarray:
    """[N, TT] bool — taint slot active with effect ∈ ``effects`` and not
    tolerated by any of pod p's tolerations."""
    t_eff = ec.taint_effect  # [N, TT]
    active = np.isin(t_eff, effects) & (ec.taint_key != PAD)
    tk = pods.tol_key[p]  # [TO]
    tv = pods.tol_kv[p]
    te = pods.tol_effect[p]
    valid_tol = tk != TOL_PAD  # [TO]
    key_ok = (tk[None, None, :] == TOL_WILDCARD) | (tk[None, None, :] == ec.taint_key[:, :, None])
    val_ok = (tv[None, None, :] == PAD) | (tv[None, None, :] == ec.taint_kv[:, :, None])
    eff_ok = (te[None, None, :] == 0) | (te[None, None, :] == t_eff[:, :, None])
    tolerated = np.any(key_ok & val_ok & eff_ok & valid_tol[None, None, :], axis=2)
    return active & ~tolerated


def taint_mask(ec: EncodedCluster, pods: EncodedPods, p: int) -> np.ndarray:
    """Feasible iff no untolerated NoSchedule/NoExecute taint."""
    bad = _untolerated(
        ec, pods, p, np.array([int(Effect.NO_SCHEDULE), int(Effect.NO_EXECUTE)])
    )
    return ~np.any(bad, axis=1)


def taint_prefer_count(ec: EncodedCluster, pods: EncodedPods, p: int) -> np.ndarray:
    """Count of untolerated PreferNoSchedule taints per node (score input)."""
    bad = _untolerated(ec, pods, p, np.array([int(Effect.PREFER_NO_SCHEDULE)]))
    return bad.sum(axis=1).astype(np.float32)


# ---------------------------------------------------------------------------
# NodeAffinity ([K8S] nodeaffinity)
# ---------------------------------------------------------------------------

def node_affinity_mask(M: np.ndarray, pods: EncodedPods, p: int) -> np.ndarray:
    if not pods.na_has_req[p]:
        return np.ones(M.shape[0], dtype=bool)
    return selector_terms_match(M, pods.na_req[p])


def node_affinity_score(M: np.ndarray, pods: EncodedPods, p: int) -> np.ndarray:
    """Σ weight over matched preferred terms (raw; normalized by caller)."""
    terms = pods.na_pref[p]  # [TP, TE]
    w = pods.na_pref_w[p]  # [TP]
    valid_term = terms[:, 0] >= 0
    safe = np.clip(terms, 0, None)
    per_expr = M[:, safe] | (terms[None, :, :] < 0)
    per_term = np.all(per_expr, axis=2) & valid_term[None, :]
    return (per_term * w[None, :]).sum(axis=1).astype(np.float32)


# ---------------------------------------------------------------------------
# InterPodAffinity ([K8S] interpodaffinity) — reads the count tensors
# ---------------------------------------------------------------------------

def _group_dom_per_node(ec: EncodedCluster) -> np.ndarray:
    """[G, N] domain id of each node under each group's topology key."""
    gt = np.clip(ec.group_topo, 0, None)
    dom = ec.node_domain[gt]  # [G, N]
    return np.where(ec.group_topo[:, None] >= 0, dom, PAD)


def _counts_at_nodes(counts: np.ndarray, gdom: np.ndarray) -> np.ndarray:
    """Gather ``counts[g, dom(g, n)]`` → [G, N]; 0 where the node lacks the key."""
    safe = np.clip(gdom, 0, None)
    vals = np.take_along_axis(counts, safe, axis=1)
    return np.where(gdom >= 0, vals, 0.0)


def interpod_filter_mask(
    ec: EncodedCluster, st: SchedState, pods: EncodedPods, p: int
) -> np.ndarray:
    N = ec.num_nodes
    gdom = _group_dom_per_node(ec)  # [G, N]
    cnt = _counts_at_nodes(st.match_count, gdom)  # [G, N]
    total = st.match_count.sum(axis=1)  # [G]
    ok = np.ones(N, dtype=bool)
    # Required affinity: ≥1 matching placed pod in the node's domain; the
    # bootstrap exception ([K8S]): if nothing matches anywhere and the pod
    # matches its own term, the term is satisfied.
    for g in pods.aff_req[p]:
        if g < 0:
            continue
        boot = (total[g] == 0) and bool(pods.pod_matches_group[p, g])
        term_ok = (cnt[g] >= 1) & (gdom[g] >= 0)
        ok &= term_ok | boot
    # Required anti-affinity (incoming pod's own terms): no matching placed
    # pod in the domain. Nodes without the topology key cannot conflict.
    for g in pods.anti_req[p]:
        if g < 0:
            continue
        ok &= ~((cnt[g] >= 1) & (gdom[g] >= 0))
    # Symmetric: placed pods' required anti-affinity terms reject this pod.
    anti_here = _counts_at_nodes(st.anti_active, gdom)  # [G, N]
    blocked = np.any((anti_here > 0) & pods.pod_matches_group[p][:, None], axis=0)
    return ok & ~blocked


def interpod_score(ec: EncodedCluster, st: SchedState, pods: EncodedPods, p: int) -> np.ndarray:
    """Raw preferred-affinity score: incoming pod's weighted terms counted
    over placed pods, plus the symmetric sum of placed pods' preferred
    weights toward pods matching group g."""
    gdom = _group_dom_per_node(ec)
    cnt = _counts_at_nodes(st.match_count, gdom)  # [G, N]
    raw = np.zeros(ec.num_nodes, dtype=np.float32)
    for g, w in zip(pods.pref_aff[p], pods.pref_aff_w[p]):
        if g >= 0:
            raw += w * cnt[g]
    wsum = _counts_at_nodes(st.pref_wsum, gdom)  # [G, N]
    raw += (wsum * pods.pod_matches_group[p][:, None]).sum(axis=0)
    return raw


# ---------------------------------------------------------------------------
# PodTopologySpread ([K8S] podtopologyspread)
# ---------------------------------------------------------------------------

def spread_filter_mask(
    ec: EncodedCluster, st: SchedState, pods: EncodedPods, p: int
) -> np.ndarray:
    N = ec.num_nodes
    gdom = _group_dom_per_node(ec)
    cnt = _counts_at_nodes(st.match_count, gdom)
    ok = np.ones(N, dtype=bool)
    for g, skew, dns in zip(pods.spread_g[p], pods.spread_skew[p], pods.spread_dns[p]):
        if g < 0 or not dns:
            continue
        ti = ec.group_topo[g]
        nd = int(ec.num_domains[ti])
        if nd == 0:
            ok &= False
            continue
        min_cnt = st.match_count[g, :nd].min()
        self_match = float(pods.pod_matches_group[p, g])
        new = cnt[g] + self_match
        # Nodes missing the topology key fail DoNotSchedule constraints.
        ok &= (gdom[g] >= 0) & (new - min_cnt <= skew)
    return ok


def spread_weight(ec: EncodedCluster, g: int) -> np.float32:
    """topologyNormalizingWeight for match-group ``g``'s topology:
    ``log(size + 2)`` ([K8S] podtopologyspread/scoring.go).

    DOCUMENTED DEVIATION from upstream: ``size`` here is the STATIC
    cluster-wide distinct-domain count of the key, computed once at encode.
    Upstream counts distinct domains among the pod's *filtered* nodes per
    scheduling cycle, and special-cases kubernetes.io/hostname as
    ``len(filteredNodes) − 2``. Scores deviate from upstream whenever
    filtering excludes whole domains. MEASURED (round 5, vs an
    upstream-faithful dynamic-weight oracle,
    tests/test_spread_weight_deviation.py): a pod with ONE spread
    constraint diverges 0.00% in placements even with half its domains
    filtered out (NormalizeScore is scale-invariant up to rounding); a
    pod spreading over MULTIPLE topologies at once (zone + hostname, half
    the zones filtered) flips 5.4% of decisions (cascade-inclusive
    assignment divergence 14.1%, placed counts equal). The static form
    keeps the weight a trace-time constant — a per-pod dynamic count
    would force a per-pod [N]-wide
    domain census into the device hot loop. Cross-backend parity is exact:
    all three backends consume this same value (f64 log cast once to
    f32)."""
    ti = ec.group_topo[g]
    nd = int(ec.num_domains[ti]) if ti >= 0 else 0
    return np.float32(np.log(np.float64(nd) + 2.0))


def spread_score(
    ec: EncodedCluster, st: SchedState, pods: EncodedPods, p: int
) -> Optional[np.ndarray]:
    """Upstream podtopologyspread scoring ([K8S] scoring.go): per
    ScheduleAnyway constraint, ``score += cnt·log(size+2) + (maxSkew−1)``
    over existing matching pods in the node's domain (no self term),
    truncated to an integer per node. Nodes missing any scored topology key
    are ignored — sentinel −1 (they normalize to 0). Returns None when the
    pod has no ScheduleAnyway constraints (PreScore Skip)."""
    gdom = _group_dom_per_node(ec)
    cnt = _counts_at_nodes(st.match_count, gdom)
    raw = np.zeros(ec.num_nodes, dtype=np.float32)
    ignored = np.zeros(ec.num_nodes, dtype=bool)
    any_scored = False
    for g, skew, dns in zip(pods.spread_g[p], pods.spread_skew[p], pods.spread_dns[p]):
        if g < 0 or dns:
            continue
        any_scored = True
        raw = raw + (cnt[g] * spread_weight(ec, g) + np.float32(int(skew) - 1))
        ignored |= gdom[g] < 0
    if not any_scored:
        return None
    # int64(math.Round(score)) upstream — half away from zero; scores are
    # non-negative so floor(x + 0.5), in f32 on every backend.
    raw = np.floor(raw + np.float32(0.5))
    return np.where(ignored, np.float32(-1.0), raw)


def spread_normalize(raw: np.ndarray, feasible: np.ndarray) -> np.ndarray:
    """Upstream two-pass NormalizeScore ([K8S] podtopologyspread):
    ``100·(max+min−s) // max`` with min/max over non-ignored feasible
    nodes; ignored nodes (sentinel −1) → 0; max == 0 → 100. Integer (int32)
    arithmetic, exact while ``100·(max+min) < 2³¹`` — mirrored bit-for-bit
    on the device paths."""
    out = np.zeros_like(raw, dtype=np.float32)
    scored = feasible & (raw >= 0)
    if not scored.any():
        return out
    hi = np.int32(raw[scored].max())
    lo = np.int32(raw[scored].min())
    nz = raw >= 0
    if hi <= 0:
        out[nz] = np.float32(MAX_NODE_SCORE)
        return out
    vals = (np.int32(MAX_NODE_SCORE) * (hi + lo - raw.astype(np.int32))) // hi
    out[nz] = vals[nz].astype(np.float32)
    return out


# ---------------------------------------------------------------------------
# Normalization ([K8S] defaultNormalizeScore) and selection
# ---------------------------------------------------------------------------

def normalize_max(raw: np.ndarray, feasible: np.ndarray, reverse: bool = False) -> np.ndarray:
    """``floor(raw·100/max)`` over feasible nodes ([K8S] defaultNormalizeScore,
    integer scores); reverse flips. Raw inputs are small non-negative
    integers (counts / summed int weights), so the arithmetic is exact."""
    vals = np.where(feasible, raw, 0.0)
    mx = vals.max() if feasible.any() else 0.0
    if mx <= 0:
        out = np.zeros_like(raw, dtype=np.float32)
        return np.full_like(out, MAX_NODE_SCORE) if reverse else out
    out = np.floor((raw.astype(np.float32) * np.float32(MAX_NODE_SCORE)) / np.float32(mx))
    return np.float32(MAX_NODE_SCORE) - out if reverse else out


def normalize_min_max(raw: np.ndarray, feasible: np.ndarray, reverse: bool = False) -> np.ndarray:
    """``floor((raw−lo)·(100/span))`` over feasible nodes (handles negatives —
    [K8S] interpodaffinity normalization). Constant raw → all zeros. The
    single multiply keeps both backends bit-identical."""
    if not feasible.any():
        return np.zeros_like(raw, dtype=np.float32)
    vals = raw[feasible]
    lo, hi = np.float32(vals.min()), np.float32(vals.max())
    if hi == lo:
        return np.zeros_like(raw, dtype=np.float32)
    out = np.floor((raw.astype(np.float32) - lo) * (np.float32(MAX_NODE_SCORE) / (hi - lo)))
    return np.float32(MAX_NODE_SCORE) - out if reverse else out
