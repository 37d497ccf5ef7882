"""What-if scenario engine: S perturbed clusters replayed as one batch.

Counterpart: ``kubernetes_simulator_tpu/sim/whatif.py`` — the
perturbation DSL (``Perturbation``, ``Scenario``), ``ScenarioSet`` (:74),
``WhatIfResult`` (:436), ``WhatIfEngine`` (:503; ``run`` :2657) on its v3
path with no mesh, completions and gangs on, and ``uniform_scenarios``
(:3960). The JAX engine vmaps its chunk program over the scenario axis
(``_build_chunk_fn`` :1285); here the scenario axis is the leading ``S``
dimension of the tables that the three kernels take (:mod:`..ops.kernels`),
driven by the chunk loop and setup the single replay uses
(:class:`.torch_runtime.ChunkEngine`). Completions release on the device
from static per-boundary buckets (``_stage_dev_rel`` :2200, ``_release_fn``
:1742): no per-chunk transfer of choices, one fetch of ``[S, L]`` choices
at the end.

Pod-side tensors, labels and topology domains are shared by the
scenarios (the trace is common); the allocatable ``[S, N, R]`` and the
taints ``[S, N, TT]`` are stacked per scenario. The perturbations ported
are ``node_down``, ``scale_capacity`` and ``add_taint``; ``set_label``
(per-scenario domain tables) and the engine's other modes raise
``NotImplementedError`` naming the queue item that ports them.

Tier preemption (``preemption=True``; the reference's batch of
:590-620, :863-880, :2110-2165 and :2828-3005) runs with completions and
gangs: each scenario carries its own tier planes, eviction record and
victim counter (``WhatIfResult.preemptions [S]``), and the release
buckets drop completed non-gang pods from the tier planes (``_tier_rel_fn``
:2145, ``_npods_rel_fn`` :2161). As in the reference, it refuses pre-bound
pods.

The unschedulable-retry buffer (``retry_buffer=RB``; the retry variant of
``_build_chunk_fn``, :1406-1557) gives each scenario its own FIFO of
failed non-gang pods, retry pass and pending list
(:func:`.torch_runtime.run_retry_boundary`; ``WhatIfResult.retry_dropped
[S]``). It keeps the reference's refusals (no finite durations or
``completions=False``, ``collect_assignments``, tier preemption, fork
checkpoints). The reference also refuses traces whose count planes
need non-singleton host-scale rows (:956-966), a limit of its TPU plane
layout; the port's state has no host planes, so it runs them.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace as dc_replace
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..framework.framework import FrameworkConfig
from ..models.core import Effect
from ..models.encode import PAD, EncodedCluster, EncodedPods
from ..ops import reference as ref
from .telemetry import resolve_granularity
from .torch_runtime import (
    ChunkEngine,
    StepSpec,
    check_retry_buffer,
    completions_gate,
    resolve_device,
    tier_preemption,
)


@dataclass
class Perturbation:
    """One mutation of the base cluster. ``nodes`` is a boolean mask or
    index array over nodes."""

    op: str  # "scale_capacity" | "node_down" | "add_taint" | "set_label"
    nodes: np.ndarray
    resource: Optional[str] = None
    factor: float = 1.0
    key: Optional[str] = None
    value: Optional[str] = None
    effect: str = "NoSchedule"


@dataclass
class Scenario:
    perturbations: List[Perturbation] = field(default_factory=list)
    # Timed failure/recovery timeline (chaos campaigns); not ported yet.
    events: List = field(default_factory=list)


def _later(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet ({item}); the PyTorch what-if engine runs "
        "static node_down / scale_capacity / add_taint batches on one card — "
        "use the JAX package for it"
    )


class ScenarioSet:
    """Stacked per-scenario node tables of a batch: ``alloc [S, N, R]`` f32
    and ``taint_key / taint_kv / taint_effect [S, N, TT]`` i32 on
    ``device``, with two spare taint slots per node for ``add_taint``.
    ``add_taint`` interns its key and key/value pair into ``ec.vocab``, as
    the reference does."""

    def __init__(self, ec: EncodedCluster, scenarios: Sequence[Scenario],
                 spare_taint_slots: int = 2, device="cpu"):
        self.num_scenarios = S = len(scenarios)
        vocab = ec.vocab
        N, TT0 = ec.taint_key.shape
        TT = TT0 + spare_taint_slots
        base_tk = np.full((N, TT), PAD, np.int32)
        base_tv = np.full((N, TT), PAD, np.int32)
        base_te = np.zeros((N, TT), np.int32)
        base_tk[:, :TT0] = ec.taint_key
        base_tv[:, :TT0] = ec.taint_kv
        base_te[:, :TT0] = ec.taint_effect
        alloc = np.repeat(ec.allocatable[None], S, axis=0).copy()
        tk = np.repeat(base_tk[None], S, axis=0).copy()
        tv = np.repeat(base_tv[None], S, axis=0).copy()
        te = np.repeat(base_te[None], S, axis=0).copy()
        for si, sc in enumerate(scenarios):
            for pt in sc.perturbations:
                mask = np.zeros(N, dtype=bool)
                mask[pt.nodes] = True
                if pt.op == "scale_capacity":
                    ri = vocab._r.get(pt.resource)
                    if ri is None:
                        continue
                    alloc[si, mask, ri] = alloc[si, mask, ri] * pt.factor
                elif pt.op == "node_down":
                    alloc[si, mask, :] = 0.0
                elif pt.op == "add_taint":
                    kid = vocab.key(pt.key)
                    kvid = vocab.kv(pt.key, pt.value or "")
                    eff = int(Effect.parse(pt.effect))
                    for n in np.nonzero(mask)[0]:
                        free = np.nonzero(tk[si, n] == PAD)[0]
                        if free.size == 0:
                            raise ValueError("no spare taint slot; raise spare_taint_slots")
                        tk[si, n, free[0]] = kid
                        tv[si, n, free[0]] = kvid
                        te[si, n, free[0]] = eff
                elif pt.op == "set_label":
                    raise _later(
                        "set_label (per-scenario topology domains: the labels-dirty "
                        "DynTables row B11)", "queue A item 7")
                else:
                    raise ValueError(f"unknown perturbation op {pt.op!r}")
        # Injected PreferNoSchedule taints re-enable the taint score row
        # (StepSpec.taint_score is derived from the base cluster only).
        self.injected_prefer_taint = any(
            pt.op == "add_taint"
            and int(Effect.parse(pt.effect)) == int(Effect.PREFER_NO_SCHEDULE)
            for sc in scenarios
            for pt in sc.perturbations
        )
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
        self.alloc = t(alloc.astype(np.float32))
        self.taint_key = t(tk)
        self.taint_kv = t(tv)
        self.taint_effect = t(te)


@dataclass
class WhatIfResult:
    """The reference's result record. This engine fills ``placed``,
    ``unschedulable``, ``total_placed``, ``wall_clock_s``,
    ``placements_per_sec``, ``assignments`` (when collected),
    ``utilization_cpu``, ``completions_on``, ``engine``, under tier
    preemption ``preemptions`` (victims per scenario) and under the retry
    buffer ``retry_dropped`` (failures dropped on a full buffer, per
    scenario); the fields of modes not ported yet stay None."""

    placed: np.ndarray  # [S] i32
    unschedulable: np.ndarray  # [S] i32
    total_placed: int
    wall_clock_s: float
    placements_per_sec: float  # aggregate over all scenarios
    assignments: Optional[np.ndarray] = None  # [S, P] when collected
    utilization_cpu: Optional[np.ndarray] = None  # [S]
    completions_on: bool = False
    engine: str = "v3"
    preemptions: Optional[np.ndarray] = None
    retry_dropped: Optional[np.ndarray] = None
    evictions: Optional[np.ndarray] = None
    evict_rescheduled: Optional[np.ndarray] = None
    evict_stranded: Optional[np.ndarray] = None
    evict_latency_mean: Optional[np.ndarray] = None
    latency_p50: Optional[np.ndarray] = None
    latency_p90: Optional[np.ndarray] = None
    latency_p99: Optional[np.ndarray] = None
    stranded_cpu: Optional[np.ndarray] = None
    frag_index_cpu: Optional[np.ndarray] = None
    packing_efficiency: Optional[np.ndarray] = None
    scenario_telemetry: Optional[list] = None
    fleet_telemetry: Optional[object] = None
    n_devices: int = 1
    mesh_shape: Optional[dict] = None
    process_count: int = 1


class WhatIfEngine(ChunkEngine):
    """Batched scenario evaluation on one device.

    ``device`` defaults to ``"cuda"`` (the kernels; raises without a card)
    and ``device="cpu"`` runs the plain twins; ``plain=True`` runs the
    twins on any device. ``completions`` (None = on when the trace has
    finite durations), ``retry_buffer``, ``granularity_guard`` and
    ``collect_assignments`` behave as in the JAX engine; the result is the
    same whether or not the assignments are collected. ``telemetry`` is
    "off" or "summary".
    Every other mode raises ``NotImplementedError`` naming its queue
    item."""

    def __init__(
        self,
        ec: EncodedCluster,
        pods: EncodedPods,
        scenarios: Sequence[Scenario],
        config: Optional[FrameworkConfig] = None,
        wave_width: int = 8,
        chunk_waves: int = 1024,
        mesh=None,
        collect_assignments: bool = False,
        fork_checkpoint: Optional[str] = None,
        preemption=False,
        completions: Optional[bool] = None,
        retry_buffer: int = 0,
        granularity_guard: bool = True,
        telemetry=None,
        policies=None,
        node_shards: int = 0,
        _dcn_recovery: Optional[dict] = None,
        engine: str = "v3",
        device="cuda",
        plain: bool = False,
    ):
        scenarios = list(scenarios)
        mode = tier_preemption(preemption)
        rb = check_retry_buffer(retry_buffer)
        if rb and (not completions_gate(pods, completions) or collect_assignments or mode
                   or fork_checkpoint is not None):
            raise ValueError(
                "retry_buffer requires the device-release completions path (finite durations, "
                "completions on, no collect_assignments, tier preemption or fork checkpoint)"
            )
        if mode and (engine != "v3" or fork_checkpoint):
            raise ValueError(
                "what-if preemption requires the v3 engine (no label perturbations) and no "
                "fork checkpoint"
            )
        if mode and bool((pods.bound_node >= 0).any()):
            # The reference's aggregate tally cannot tell pre-bound victims
            # from replay placements; the port keeps its refusal.
            raise ValueError("what-if preemption does not support pre-bound pods")
        if engine != "v3":
            raise _later(f"engine={engine!r} (the v2 node-space chain, row B8)",
                         "queue B item 2")
        if mesh is not None:
            raise _later("mesh (the scenario axis over several cards)", "queue A item 10")
        if node_shards and int(node_shards) > 1:
            raise _later("node_shards (node-plane sharding, row B13)", "queue A item 10")
        if fork_checkpoint is not None:
            raise _later("fork_checkpoint (what-if forks from a checkpoint)", "queue A item 7")
        if policies is not None:
            raise _later("policies (traced per-scenario policies)", "queue A item 7")
        if _dcn_recovery is not None:
            raise _later("_dcn_recovery (the multi-process fleet)", "queue A item 11")
        if any(sc.events for sc in scenarios):
            raise _later("Scenario.events (per-scenario chaos timelines)", "queue A item 7")
        if telemetry in ("series", "timeline"):
            raise _later(f"telemetry={telemetry!r} (rejection attribution, row B9)",
                         "queue A item 6")
        self.telemetry = resolve_granularity(telemetry)
        device = resolve_device(device)
        self.collect_assignments = bool(collect_assignments)
        self.engine = "v3"
        spec = StepSpec.from_config(ec, config, pods)
        self.sset = ScenarioSet(ec, scenarios, device=device)
        if self.sset.injected_prefer_taint and not spec.taint_score:
            spec = dc_replace(spec, taint_score=True)
        cluster = ref.cluster_to(ec, device)._replace(
            allocatable=self.sset.alloc, taint_key=self.sset.taint_key,
            taint_kv=self.sset.taint_kv, taint_effect=self.sset.taint_effect,
        )
        self.preemption = mode
        self._prepare(ec, pods, spec, cluster, self.sset.num_scenarios, wave_width, chunk_waves,
                      completions, granularity_guard, "what-if engine", device, plain, mode, rb)

    def _utilization_cpu(self, tb: ref.Tables) -> Optional[np.ndarray]:
        """[S] mean over nodes of used/allocatable cpu (0 where a node has
        none), in f32 on the device as the reference computes it."""
        ri = self.ec.vocab._r.get("cpu")
        if ri is None:
            return None
        a = tb.cluster.allocatable[:, :, ri]
        u = tb.state.used[:, :, ri]
        frac = torch.where(a > 0, u / torch.where(a > 0, a, torch.ones_like(a)),
                           torch.zeros_like(a))
        return frac.mean(dim=1).cpu().numpy()

    def run(self) -> WhatIfResult:
        tb, wall, assignments, placed, to_schedule = self._run()
        total = int(placed.sum())
        return WhatIfResult(
            placed=placed,
            unschedulable=(to_schedule - placed).astype(np.int32),
            total_placed=total,
            wall_clock_s=wall,
            placements_per_sec=total / wall if wall > 0 else 0.0,
            assignments=assignments if self.collect_assignments else None,
            utilization_cpu=self._utilization_cpu(tb),
            completions_on=self.completions_on,
            engine=self.engine,
            preemptions=(tb.preempt.victims.cpu().numpy() if tb.preempt is not None else None),
            retry_dropped=(tb.retry.rdrop.cpu().numpy() if tb.retry is not None else None),
        )


def uniform_scenarios(
    ec: EncodedCluster,
    num_scenarios: int,
    seed: int = 0,
    p_node_down: float = 0.02,
    p_capacity: float = 0.3,
    p_taint: float = 0.1,
) -> List[Scenario]:
    """Random cluster-state perturbation sampler (the [BASELINE] eval shape:
    a batch over cluster-state perturbations), the reference's numpy draws
    in the reference's order. Scenario 0 is always the unperturbed base."""
    rng = np.random.default_rng(seed)
    out = [Scenario()]
    N = ec.num_nodes
    for _ in range(num_scenarios - 1):
        pts: List[Perturbation] = []
        if rng.random() < p_node_down:
            k = int(rng.integers(1, max(2, N // 50)))
            pts.append(Perturbation("node_down", nodes=rng.choice(N, size=k, replace=False)))
        if rng.random() < p_capacity:
            k = int(rng.integers(1, max(2, N // 10)))
            pts.append(
                Perturbation(
                    "scale_capacity",
                    nodes=rng.choice(N, size=k, replace=False),
                    resource="cpu",
                    factor=float(rng.choice([0.5, 0.75, 1.25, 1.5])),
                )
            )
        if rng.random() < p_taint:
            k = int(rng.integers(1, max(2, N // 20)))
            pts.append(
                Perturbation(
                    "add_taint",
                    nodes=rng.choice(N, size=k, replace=False),
                    key="whatif/injected",
                    value="true",
                    effect="NoSchedule",
                )
            )
        out.append(Scenario(pts))
    return out
