"""Scheduler configuration and the CPU scheduler framework.

Counterpart: ``kubernetes_simulator_tpu/framework/framework.py`` —
``FrameworkConfig`` (:44, with ``with_policy`` :50), ``ScheduleResult``
(:33) and ``SchedulerFramework`` up to ``schedule_one`` (:89-188): one pod
through PreFilter → Filter → PreScore → Score → NormalizeScore → weighted
sum → select, each extension point vectorized over all nodes in numpy
(:mod:`..plugins.builtin`, :mod:`..ops.cpu`). ``greedy_replay``
(:mod:`..sim.greedy`) drives it slot by slot; it is the policy tuner's
oracle and the port's own CPU anchor.

The PostFilter (kube's minimal-victims preemption, ``_post_filter_preempt``
:190-292) is not carried yet: ``schedule_one`` refuses a call that could
reach it (``enable_preemption`` and ``allow_preemption=True``) by name
(queue A items 13 and 6). ``enable_preemption`` (``profile.preemption``)
is otherwise read only by the reference's CPU event engine.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from ..models.encode import PAD, EncodedCluster, EncodedPods
from ..models.state import SchedState
from ..plugins.builtin import DEFAULT_WEIGHTS, Plugin, SchedulingContext, make_plugins


@dataclass
class ScheduleResult:
    node: int  # PAD = unschedulable
    reason: str = ""


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

    # -- Filter + Score over all nodes -------------------------------------

    def feasible_mask(self, st: SchedState, p: int) -> np.ndarray:
        """Filter chain over all nodes, stopping once the mask is empty."""
        mask = np.ones(self.ec.num_nodes, dtype=bool)
        for pl in self.plugins:
            m = pl.filter(self.ctx, st, p)
            if m is not None:
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
        allow_preemption: bool = False,
    ) -> ScheduleResult:
        """One scheduling cycle. Does NOT bind — the caller owns
        Reserve/Permit/Bind so gang commit stays transactional. A call
        that could reach the PostFilter (``enable_preemption`` and
        ``allow_preemption=True``) is refused: the PostFilter is not
        ported yet."""
        if self.config.enable_preemption and allow_preemption:
            raise NotImplementedError(
                "SchedulerFramework.schedule_one with allow_preemption=True (the kube "
                "PostFilter, _post_filter_preempt) is not ported yet (queue A items 13 and "
                "6); pass allow_preemption=False or FrameworkConfig(enable_preemption=False), "
                "or use the JAX package"
            )
        feasible = self.feasible_mask(st, p)
        if not feasible.any():
            return ScheduleResult(PAD, "Unschedulable")
        scores = self.score_nodes(st, p, feasible)
        masked = np.where(feasible, scores, -np.inf)
        # Deterministic lowest-index tie-break.
        return ScheduleResult(int(np.argmax(masked)))
