"""Scheduler configuration and the CPU scheduler framework.

Counterpart: ``kubernetes_simulator_tpu/framework/framework.py`` —
``FrameworkConfig`` (:44, with ``with_policy`` :50), ``ScheduleResult``
(:33) and ``SchedulerFramework`` (:89-292): one pod through PreFilter →
Filter → (PostFilter: preemption) → PreScore → Score → NormalizeScore →
weighted sum → select, each extension point vectorized over all nodes in
numpy (:mod:`..plugins.builtin`, :mod:`..ops.cpu`). ``greedy_replay``
(:mod:`..sim.greedy`) drives it slot by slot; it is the policy tuner's
oracle and the port's own CPU anchor.

The PostFilter is kube's minimal-victims preemption
(``_post_filter_preempt`` :190-292, with ``_fits_after``): for a pod that
no node admits, the node where evicting the fewest bound non-gang pods of
lower priority, lowest priority first, makes it fit.
``greedy_replay(preemption="kube")`` runs it at chunk boundaries; the
device engines run its twin (:func:`..ops.reference.post_filter`) and K6's
``ksim_post_filter``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..models.encode import PAD, EncodedCluster, EncodedPods
from ..models.state import SchedState, unbind
from ..plugins.builtin import DEFAULT_WEIGHTS, Plugin, SchedulingContext, make_plugins


@dataclass
class ScheduleResult:
    node: int  # PAD = unschedulable
    reason: str = ""
    victims: Tuple[int, ...] = ()  # preempted pods (PostFilter)
    # Per-plugin first-reject node counts (kube "0/N nodes available"),
    # only on a fully-failed attempt with ``want_reasons=True``; they sum
    # to the node count.
    reasons: Optional[Dict[str, int]] = None


@dataclass
class FrameworkConfig:
    plugins: Optional[List[dict]] = None  # [{"name":..., "args": {...}}]
    weights: Optional[Dict[str, float]] = None  # Score weights by plugin name
    # PostFilter preemption of the CPU event engine (profile.preemption).
    enable_preemption: bool = True

    def with_policy(
        self,
        weights: Dict[str, float],
        fit_strategy: Optional[str] = None,
    ) -> "FrameworkConfig":
        """A copy of this config with the given Score weights merged in
        and (optionally) the NodeResourcesFit scoring strategy replaced —
        how the policy tuner re-materializes a searched policy vector as an
        ordinary scheduler config for the CPU-oracle re-evaluation. Plugin
        entries other than NodeResourcesFit are carried unchanged."""
        merged = dict(self.weights or {})
        merged.update(weights)
        plugins = self.plugins
        if fit_strategy is not None:
            entries = (
                [dict(e) for e in plugins]
                if plugins is not None
                else [{"name": n} for n in DEFAULT_WEIGHTS]
            )
            found = False
            for e in entries:
                if e.get("name") == "NodeResourcesFit":
                    e["args"] = {**e.get("args", {}), "strategy": fit_strategy}
                    found = True
            if not found:
                entries.append(
                    {"name": "NodeResourcesFit", "args": {"strategy": fit_strategy}}
                )
            plugins = entries
        return FrameworkConfig(
            plugins=plugins, weights=merged, enable_preemption=self.enable_preemption,
        )


class SchedulerFramework:
    def __init__(self, ec: EncodedCluster, pods: EncodedPods,
                 config: Optional[FrameworkConfig] = None):
        self.config = config or FrameworkConfig()
        self.ctx = SchedulingContext.build(ec, pods)
        self.plugins: List[Plugin] = make_plugins(self.ctx, self.config.plugins)
        weights = dict(DEFAULT_WEIGHTS)
        weights.update(self.config.weights or {})
        self.weights = weights
        self.ec = ec
        self.pods = pods
        # Any required anti-affinity in the trace makes every pod's
        # feasibility state-dependent (symmetric checks): the PostFilter's
        # cumsum fast path is then off for every pod.
        self._trace_has_anti = bool((pods.anti_req >= 0).any())

    # -- Filter + Score over all nodes -------------------------------------

    def feasible_mask(self, st: SchedState, p: int,
                      reject_counts: Optional[Dict[str, int]] = None) -> np.ndarray:
        """Filter chain over all nodes, stopping once the mask is empty.
        ``reject_counts`` gets each plugin's first-reject node count (a
        node charged to the earliest plugin in Filter order that rejects
        it); the early stop loses nothing, since no later plugin can newly
        reject a node then."""
        mask = np.ones(self.ec.num_nodes, dtype=bool)
        for pl in self.plugins:
            if reject_counts is not None:
                reject_counts.setdefault(pl.name, 0)
            m = pl.filter(self.ctx, st, p)
            if m is not None:
                if reject_counts is not None:
                    reject_counts[pl.name] += int((mask & ~m).sum())
                mask &= m
                if not mask.any():
                    break
        return mask

    def score_nodes(self, st: SchedState, p: int, feasible: np.ndarray) -> np.ndarray:
        """Σ w·normalize(raw) in f32, plugin by plugin in list order; a
        zero-weight plugin is skipped."""
        total = np.zeros(self.ec.num_nodes, dtype=np.float32)
        for pl in self.plugins:
            w = self.weights.get(pl.name, 1.0)
            if w == 0:
                continue
            raw = pl.score(self.ctx, st, p)
            if raw is not None:
                total += w * pl.normalize(raw, feasible)
        return total

    def schedule_one(
        self,
        st: SchedState,
        p: int,
        allow_preemption: bool = True,
        want_reasons: bool = False,
    ) -> ScheduleResult:
        """One scheduling cycle. Does NOT bind — the caller owns
        Reserve/Permit/Bind so gang commit stays transactional. A pod no
        node admits runs the PostFilter when ``enable_preemption`` and
        ``allow_preemption`` (the callers pass False for in-wave attempts
        and gang members). ``want_reasons`` attaches the first-reject
        breakdown to a fully-failed result; a pod the PostFilter rescues
        carries none (it nominated a node)."""
        rc: Optional[Dict[str, int]] = {} if want_reasons else None
        feasible = self.feasible_mask(st, p, reject_counts=rc)
        if not feasible.any():
            if self.config.enable_preemption and allow_preemption:
                res = self._post_filter_preempt(st, p)
                if res is not None:
                    return res
            return ScheduleResult(PAD, "Unschedulable", reasons=rc)
        scores = self.score_nodes(st, p, feasible)
        masked = np.where(feasible, scores, -np.inf)
        # Deterministic lowest-index tie-break.
        return ScheduleResult(int(np.argmax(masked)))

    # -- PostFilter: preemption ([K8S] defaultpreemption) -------------------

    def _post_filter_preempt(self, st: SchedState, p: int) -> Optional[ScheduleResult]:
        """The node where evicting the fewest, lowest-priority bound pods of
        lower priority than p makes it fit. Victims on a node are taken in
        (priority, pod index) order; candidate nodes rank by (fewest
        victims, lowest max victim priority, lowest index). Gang members
        are never victims."""
        pods, ec = self.pods, self.ec
        prio = int(pods.priority[p])
        bound_nodes = st.bound  # [P]
        candidates: List[Tuple[int, int, int, List[int]]] = []
        placed = np.nonzero(bound_nodes >= 0)[0]
        lower = placed[(pods.priority[placed] < prio) & (pods.group_id[placed] == PAD)]
        if lower.size == 0:
            return None
        # State-independent filters (taints, node affinity) cannot change
        # under evictions: evaluated once; inside the victim loop a
        # node-local resource check, and the full mask only to confirm a
        # fit (affinity and spread can also unblock from evictions).
        static_mask = np.ones(ec.num_nodes, dtype=bool)
        for pl in self.plugins:
            if pl.name in ("NodeResourcesFit", "InterPodAffinity", "PodTopologySpread"):
                continue
            m = pl.filter(self.ctx, st, p)
            if m is not None:
                static_mask &= m
        req = pods.requests[p]
        names = {pl.name for pl in self.plugins}
        has_fit = "NodeResourcesFit" in names
        # No state-dependent filter can reject the pod (no required
        # inter-pod terms on p, no anti-affinity anywhere in the trace, no
        # DoNotSchedule spread): feasibility at n is static_mask[n] and the
        # resource fit, and no confirm is needed.
        state_free = not (
            (
                "InterPodAffinity" in names
                and (
                    pods.aff_req[p, 0] >= 0
                    or pods.anti_req[p, 0] >= 0
                    or self._trace_has_anti
                )
            )
            or (
                "PodTopologySpread" in names
                and bool(((pods.spread_g[p] >= 0) & pods.spread_dns[p]).any())
            )
        )
        # Victims grouped by node once, each node's sorted by (priority,
        # pod index): the eviction order.
        order_all = np.lexsort((lower, pods.priority[lower], bound_nodes[lower]))
        sorted_lower = lower[order_all]
        node_of = bound_nodes[sorted_lower]
        cand_nodes = np.unique(node_of)
        seg_lo = np.searchsorted(node_of, cand_nodes, side="left")
        seg_hi = np.searchsorted(node_of, cand_nodes, side="right")
        for ci_n, n in enumerate(cand_nodes):
            n = int(n)
            if not static_mask[n]:
                continue
            order = sorted_lower[seg_lo[ci_n] : seg_hi[ci_n]]
            victims: List[int] = []
            fits = False
            if has_fit and state_free:
                # The smallest k where evicting order[:k+1] fits every
                # resource: no state copy.
                cum = np.cumsum(pods.requests[order], axis=0)  # [K, R]
                fit_k = np.all(st.used[n] + req - cum <= ec.allocatable[n] + 1e-6, axis=1)
                hit = np.nonzero(fit_k)[0]
                if hit.size:
                    fits = True
                    victims = [int(v) for v in order[: hit[0] + 1]]
            else:
                # Evict the lowest-priority victims one by one until it fits.
                trial = st.copy()
                for v in order:
                    unbind(ec, pods, trial, int(v))
                    victims.append(int(v))
                    if has_fit and not bool(
                        np.all(trial.used[n] + req <= ec.allocatable[n] + 1e-6)
                    ):
                        continue
                    if state_free or self._fits_after(trial, p, n):
                        fits = True
                        break
            if not fits:
                continue
            max_vprio = int(pods.priority[victims].max()) if victims else -(2**31)
            candidates.append((len(victims), max_vprio, n, victims))
        if not candidates:
            return None
        candidates.sort(key=lambda c: (c[0], c[1], c[2]))
        _, _, n, victims = candidates[0]
        return ScheduleResult(n, "Preempted", tuple(victims))

    def _fits_after(self, st: SchedState, p: int, n: int) -> bool:
        return bool(self.feasible_mask(st, p)[n])
