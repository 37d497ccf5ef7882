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

Pod-side tensors are shared by the scenarios (the trace is common); the
allocatable ``[S, N, R]`` and the taints ``[S, N, TT]`` are stacked per
scenario. The perturbations are ``node_down``, ``scale_capacity``,
``add_taint`` and ``set_label``.

``set_label`` (row B11: the reference's DynTables, ``ScenarioDyn`` :408,
``make_wave_step3(dyn=...)``, and the labels-dirty role of the v2 chain,
row B8) gives each scenario that relabels nodes a row of its own in the
label tables — expression matches ``[L, N, E]``, node domains ``[L, G,
N]``, domain counts and spread weights ``[L, G]`` — and ``lrow [S]``
names each scenario's row (row 0 is the base cluster, which every other
scenario reads). The kernels read the row of their scenario with one
extra load per block and index the host-layout count planes through it
directly, so none of the reference's per-scenario correction tables
(overrides, ``dexist``, correction matmuls) is needed. Domains are
re-derived as the reference's v2 path derives them (:142-190): per
topology key, the dense rank of each present value, ordered by the value
string. With dense ranks every domain below the count holds a node, so
the DoNotSchedule spread minimum over ``[0, count)`` already skips an
emptied domain: ``dexist`` is not ported. The count planes are as wide
as the batch's largest domain count, and the pre-bound pods' initial
planes are built per row with that row's domains. The step's on/off
flags (StepSpec) depend on the pods and the taints only, not on node
labels; its f32 spread-normalize bound is checked again with the rows'
largest weights (as :900-913 does).

The engine reports what the reference reports: ``engine="v3"`` inside the
DynTables envelope (at most 32 relabelled nodes per scenario, no change
under a hostname-scale topology key, no pre-bound pods, no preemption,
no fork) and ``"v2"`` outside it; completions are off where the
reference cannot honour them (the v2 fallback, and a DynTables batch with
``collect_assignments`` or non-singleton host-scale count planes), with
its warning, or its error under ``completions=True``. Both run on the
same kernels. Tier preemption and the retry buffer refuse relabelled
batches with the reference's errors.

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

Per-scenario policies (``policies=[S, 6]``, row B1w; the reference's
:1101-1133 and ``set_policies`` :1155) give each scenario its own Score
weights and NodeResourcesFit selector (:mod:`..ops.policy`): the rows
live in one device tensor that K1 and K2 read on every path the batch
runs (plain, device release, label rows, the v2 fallback), and
``set_policies`` copies new values into it, so a search runs on one
set-up (``setups``). Kube or tier preemption, the retry buffer and fork
checkpoints refuse policies with the reference's error.

The engine's other modes raise ``NotImplementedError`` naming the queue
item that ports them.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field, replace as dc_replace
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..framework.framework import FrameworkConfig
from ..models.core import Effect
from ..models.encode import PAD, EncodedCluster, EncodedPods
from ..ops import reference as ref
from ..ops.policy import POLICY_COLS
from ..utils.metrics import log
from .telemetry import PhaseTimers, ReplayTelemetry, resolve_granularity
from .tiers import DMAX_COARSE, nonsingleton_host_rows, normalize_preemption
from .torch_runtime import (
    ChunkEngine,
    StepSpec,
    _spread_norm_f32_ok,
    check_retry_buffer,
    completions_gate,
    release_times,
    resolve_device,
    tier_preemption,
)

#: The reference's DynTables envelope: relabelled nodes per scenario.
MAX_RELABELLED = 32


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
    ``device``, with two spare taint slots per node for ``add_taint``, and
    the label tables (:meth:`labels`): one row for the base cluster and one
    for each scenario that ``set_label`` relabels, ``lrow [S]`` each
    scenario's row. ``add_taint`` and ``set_label`` intern their key and
    key/value pair into ``ec.vocab``, as the reference does; ``set_label``
    writes the node's slot for the key, or its first free one, with the
    numeric value ``float(value)`` or NaN."""

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
        lk = np.repeat(ec.node_label_key[None], S, axis=0).copy()
        lv = np.repeat(ec.node_label_kv[None], S, axis=0).copy()
        ln = np.repeat(ec.node_label_num[None], S, axis=0).copy()
        labels_dirty = np.zeros(S, dtype=bool)
        relabelled: Dict[int, set] = {}  # scenario → nodes set_label touched
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
                    kid = vocab.key(pt.key)
                    kvid = vocab.kv(pt.key, pt.value or "")
                    try:
                        num = float(pt.value)
                    except (TypeError, ValueError):
                        num = np.nan
                    for n in np.nonzero(mask)[0]:
                        slots = np.nonzero(lk[si, n] == kid)[0]
                        slot = slots[0] if slots.size else np.nonzero(lk[si, n] == PAD)[0][0]
                        lk[si, n, slot] = kid
                        lv[si, n, slot] = kvid
                        ln[si, n, slot] = num
                        relabelled.setdefault(si, set()).add(int(n))
                    labels_dirty[si] = True
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
        dirty = np.nonzero(labels_dirty)[0]
        nd, ndom = _rank_domains(ec, lk, lv, dirty)
        #: the count planes' domain width (the reference's ``max_domains``)
        self.max_domains = max(int(ndom.max()) if ndom.size else 1, ec.max_domains, 1)
        self.labels_dirty = bool(dirty.size)
        #: relabelled nodes of the scenario that relabels most (DynTables' K)
        self.relabelled = max((len(v) for v in relabelled.values()), default=0)
        #: does a relabel move a node's domain under a hostname-scale key?
        self.host_changed = _host_scale_changed(ec, lk, lv, relabelled)
        #: [S] the label row of each scenario (0: the base cluster's)
        self.lrow_host = np.zeros(S, np.int32)
        self.lrow_host[dirty] = np.arange(1, dirty.size + 1, dtype=np.int32)
        #: [L, T, N] / [L, T] the node domains and domain counts of each row
        self.node_domain = np.concatenate([ec.node_domain[None], nd[dirty]])
        self.num_domains = np.concatenate([ec.num_domains[None], ndom[dirty]])
        self._label_rows = [(None, None, None)] + [
            ((lk[s], lv[s], ln[s]), nd[s], ndom[s]) for s in dirty.tolist()]
        self._ec, self._alloc, self._taints = ec, alloc, (tk, tv, te)
        self.to(device)

    def to(self, device) -> "ScenarioSet":
        """(Re)place the stacked tables on ``device``."""
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
        self.alloc = t(self._alloc.astype(np.float32))
        self.taint_key, self.taint_kv, self.taint_effect = (t(a) for a in self._taints)
        self.lrow = t(self.lrow_host)
        self._labels = None
        self._device = device
        return self

    def host_clusters(self) -> List[EncodedCluster]:
        """Per-scenario host EncodedCluster twins (the reference's
        ``host_clusters`` :223): each scenario's perturbed allocatable and
        taints over the base cluster, for ``greedy_replay``."""
        tk, tv, te = self._taints
        return [dc_replace(self._ec, allocatable=self._alloc[s], taint_key=tk[s],
                           taint_kv=tv[s], taint_effect=te[s])
                for s in range(self.num_scenarios)]

    def labels(self) -> dict:
        """The DevCluster label fields of the batch on its device:
        ``expr_match [L, N, E]``, ``gdom [L, G, N]``, ``gnd`` / ``sp_w [L,
        G]`` and ``lrow [S]``."""
        if self._labels is None:
            self._labels = dict(ref.label_tables(self._ec, self._label_rows, self._device),
                                lrow=self.lrow)
        return self._labels

    def outside_envelope(self, preemption: bool, fork_checkpoint, pods: EncodedPods
                         ) -> List[str]:
        """Why a relabelled batch falls outside the reference's DynTables
        envelope (sim/whatif.py:807-862), in its words; empty inside it."""
        reasons = []
        if self.relabelled == 0:
            reasons.append("no DynTables")
        else:
            if self.host_changed:
                reasons.append("host-scale topology change")
            if self.relabelled > MAX_RELABELLED:
                reasons.append(f">{MAX_RELABELLED} perturbed nodes/scenario "
                               f"(K={self.relabelled})")
        if preemption:
            reasons.append("preemption")
        if fork_checkpoint is not None:
            reasons.append("fork checkpoint")
        if bool((pods.bound_node >= 0).any()):
            reasons.append("pre-bound pods")
        return reasons


def _key_values(lk: np.ndarray, lv: np.ndarray, kid: int) -> np.ndarray:
    """[..., N] the kv id of key ``kid`` on each node of the ``[..., N,
    slots]`` label arrays, -1 where the node lacks the key."""
    is_k = lk == kid
    slot = is_k.argmax(axis=-1)
    return np.where(is_k.any(axis=-1),
                    np.take_along_axis(lv, slot[..., None], -1)[..., 0], -1)


def _rank_domains(ec: EncodedCluster, lk: np.ndarray, lv: np.ndarray, dirty: np.ndarray):
    """(node_domain [S, T, N], num_domains [S, T]): the base cluster's,
    re-derived in the ``dirty`` scenarios as the dense ranks of the values
    present under each topology key, ordered by the value string (the
    reference's v2 re-derivation, sim/whatif.py:142-190)."""
    S = lk.shape[0]
    vocab = ec.vocab
    nd = np.repeat(ec.node_domain[None], S, axis=0).copy()
    ndom = np.repeat(ec.num_domains[None], S, axis=0).copy()
    if not dirty.size:
        return nd, ndom
    n_kv = len(vocab.kvs)
    for ti, tkey in enumerate(vocab.topo_keys):
        kid = vocab._k.get(tkey)
        if kid is None:
            continue
        # Each kv id's position among this key's values in string order.
        kv_of_key = sorted((i for i in range(n_kv) if vocab.kvs[i][0] == tkey),
                           key=lambda i: vocab.kvs[i][1])
        gpos = np.full(n_kv + 1, -1, np.int64)
        gpos[kv_of_key] = np.arange(len(kv_of_key))
        vals = _key_values(lk[dirty], lv[dirty], kid)  # [Sd, N]
        g = np.where(vals >= 0, gpos[np.clip(vals, 0, n_kv)], -1)
        for row, si in zip(g, dirty):
            present = row >= 0
            uniq = np.unique(row[present])
            out = np.full(ec.num_nodes, PAD, np.int32)
            out[present] = np.searchsorted(uniq, row[present]).astype(np.int32)
            nd[si, ti] = out
            ndom[si, ti] = len(uniq)
    return nd, ndom


def _host_scale_changed(ec: EncodedCluster, lk: np.ndarray, lv: np.ndarray,
                        relabelled: Dict[int, set]) -> bool:
    """Does a relabelled node change its value (so its domain) under a
    topology key of more than DMAX_COARSE base domains (the reference's
    ``host_changed``, sim/whatif.py:352-360)?"""
    vocab = ec.vocab
    for ti, tkey in enumerate(vocab.topo_keys):
        kid = vocab._k.get(tkey)
        if kid is None or int(ec.num_domains[ti]) <= DMAX_COARSE:
            continue
        for si, nodes in relabelled.items():
            n = np.array(sorted(nodes))
            new = _key_values(lk[si, n], lv[si, n], kid)
            old = _key_values(ec.node_label_key[n], ec.node_label_kv[n], kid)
            if (new != old).any():
                return True
    return False


@dataclass
class WhatIfResult:
    """The reference's result record. This engine fills ``placed``,
    ``unschedulable``, ``total_placed``, ``wall_clock_s``,
    ``placements_per_sec``, ``assignments`` (when collected),
    ``utilization_cpu``, ``completions_on``, ``engine``,
    ``fleet_telemetry`` (above telemetry "off"), under tier
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
    any granularity; above "off" the result's ``fleet_telemetry`` carries
    it and the batch's phase timers, and, as the reference's batch off the
    kube path, no per-scenario reasons or series. ``policies`` ([S, 6]
    f32, :mod:`..ops.policy`) gives each scenario its own Score weights and
    fit strategy; ``set_policies`` swaps their values.
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
        pol = self._check_policies(policies, len(scenarios), preemption, retry_buffer,
                                   fork_checkpoint)
        mode = tier_preemption(preemption)
        rb = check_retry_buffer(retry_buffer)
        sset = ScenarioSet(ec, scenarios)
        self.engine = "v3"
        if sset.labels_dirty:
            reasons = sset.outside_envelope(mode, fork_checkpoint, pods)
            if reasons:
                # The reference's v2 fallback: the same kernels run the
                # batch here; completions follow the reference's gate below.
                self.engine = "v2"
                log.info("what-if: labels_dirty batch outside the DynTables envelope (%s) — "
                         "the v2 fallback engine; WhatIfResult.engine reports it",
                         ", ".join(reasons))
        if rb and (not completions_gate(pods, completions) or collect_assignments or mode
                   or fork_checkpoint is not None or sset.labels_dirty):
            raise ValueError(
                "retry_buffer requires the device-release completions path (finite durations, "
                "completions on, no collect_assignments, tier preemption or fork checkpoint) "
                "without label-perturbation DynTables"
            )
        if mode and (engine != "v3" or self.engine != "v3" or fork_checkpoint):
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
        if _dcn_recovery is not None:
            raise _later("_dcn_recovery (the multi-process fleet)", "queue A item 11")
        if any(sc.events for sc in scenarios):
            raise _later("Scenario.events (per-scenario chaos timelines)", "queue A item 7")
        # Off the kube path the reference's batch collects the same at every
        # granularity above "off": the batch's phase timers in one fleet
        # telemetry and no per-scenario reasons (those come from the kube
        # mirrors, sim/whatif.py:2847-2863, :3576-3588).
        self.telemetry = resolve_granularity(telemetry)
        device = resolve_device(device)
        self.collect_assignments = bool(collect_assignments)
        spec = StepSpec.from_config(ec, config, pods)
        completions = self._completions_gate(ec, pods, completions, sset, spec)
        self.sset = sset.to(device)
        if sset.injected_prefer_taint and not spec.taint_score:
            spec = dc_replace(spec, taint_score=True)
        cluster = ref.cluster_to(ec, device, sset.num_scenarios)._replace(
            allocatable=sset.alloc, taint_key=sset.taint_key, taint_kv=sset.taint_kv,
            taint_effect=sset.taint_effect,
        )
        domains = None
        if sset.labels_dirty:
            labels = sset.labels()
            cluster = cluster._replace(**labels)
            # The relabelled rows' spread weights may exceed the bound of
            # the f32 normalize division (sim/whatif.py:900-913).
            w_max = tuple(float(x) for x in labels["sp_w"].amax(dim=0).cpu())
            if spec.sp_norm_f32 and not _spread_norm_f32_ok(w_max, pods):
                spec = dc_replace(spec, sp_norm_f32=False)
            domains = (sset.node_domain, sset.num_domains, sset.lrow_host, sset.max_domains)
        self.preemption = mode
        wrow = torch.tensor(pol, device=device) if pol is not None else None
        self._prepare(ec, pods, spec, cluster, sset.num_scenarios, wave_width, chunk_waves,
                      completions, granularity_guard, "what-if engine", device, plain, mode, rb,
                      domains, wrow)

    @staticmethod
    def _check_policies(policies, S: int, preemption, retry_buffer, fork_checkpoint
                        ) -> Optional[np.ndarray]:
        """The ``[S, K]`` f32 policy rows, or None: the reference's shape
        checks and its refusals of the paths that carry no policy axis
        (sim/whatif.py:1101-1133). The granularity guard never turns a
        retry buffer on, so the requested one decides."""
        if policies is None:
            return None
        pol = np.asarray(policies, dtype=np.float32)
        K = len(POLICY_COLS)
        if pol.ndim != 2 or pol.shape[1] != K:
            raise ValueError(f"policies must be [num_scenarios, {K}] (columns {POLICY_COLS}), "
                             f"got shape {pol.shape}")
        if pol.shape[0] != S:
            raise ValueError(f"policies rows ({pol.shape[0]}) must match num_scenarios ({S})")
        mode = normalize_preemption(preemption)
        blockers = [what for what, on in (
            ("kube preemption", mode == "kube"), ("tier preemption", mode == "tier"),
            ("retry_buffer", bool(retry_buffer)),
            ("fork checkpoints", fork_checkpoint is not None),
        ) if on]
        if blockers:
            raise ValueError("per-scenario policies run on the plain/completions what-if "
                             "paths — not supported with " + ", ".join(blockers))
        return pol

    def set_policies(self, policies) -> None:
        """Swap the per-scenario policy VALUES in place: the new ``[S, K]``
        rows are copied into the engine's device tensor, which every K1
        and K2 launch reads; no set-up runs again (``setups`` stays 1).
        The reference's DCN slicing of a global population
        (sim/whatif.py:1170-1176) belongs to the fleet, which this engine
        refuses at construction (queue A item 11)."""
        if self._wrow is None:
            raise ValueError(
                "engine was built without policies — pass policies=[S, K] at construction "
                "to enable the policy axis"
            )
        pol = np.asarray(policies, dtype=np.float32)
        if pol.shape != tuple(self._wrow.shape):
            raise ValueError(f"policies shape {pol.shape} must match the engine's "
                             f"{tuple(self._wrow.shape)} (the device rows are updated in place)")
        self._wrow.copy_(torch.from_numpy(np.ascontiguousarray(pol)))

    def _completions_gate(self, ec: EncodedCluster, pods: EncodedPods,
                          completions: Optional[bool], sset: ScenarioSet, spec: StepSpec
                          ) -> Optional[bool]:
        """The reference's gate for a relabelled batch (sim/whatif.py:940-1000):
        completions cannot be honoured on the v2 fallback, nor on a DynTables
        batch off the device-release path (``collect_assignments``, or
        count planes of non-singleton host-scale rows). Such a batch warns
        and runs arrivals-only, or raises under ``completions=True``.
        Returns the ``completions`` argument the chunk loop takes."""
        if self.engine != "v3":
            blocker = ("the v2 fallback engine (label perturbations outside the DynTables "
                       "envelope)")
        elif sset.labels_dirty and (self.collect_assignments or nonsingleton_host_rows(
                ec, pods, spec.interpod, spec.spread)):
            why = ("collect_assignments" if self.collect_assignments
                   else "non-singleton host-scale count planes")
            blocker = (f"labels_dirty DynTables batches off the device-release path ({why} — "
                       "per-scenario release domain corrections need the device path)")
        else:
            return completions
        if completions is not False and bool(np.isfinite(release_times(pods)).any()):
            msg = (f"what-if completions cannot be honored with {blocker} — this batch runs "
                   "ARRIVALS-ONLY (placed pods never release resources)")
            if completions is True:
                raise ValueError(msg)
            warnings.warn(msg, stacklevel=3)
        return False

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
        timers = PhaseTimers() if self.telemetry != "off" else None
        tb, wall, assignments, placed, to_schedule = self._run(timers)
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
            fleet_telemetry=(ReplayTelemetry(granularity=self.telemetry, phases=timers.summary())
                             if timers is not None else None),
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
