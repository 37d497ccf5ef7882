"""What-if scenario engine: S perturbed clusters replayed as one batch.

Counterpart: ``kubernetes_simulator_tpu/sim/whatif.py`` — the
perturbation DSL (``Perturbation``, ``Scenario``), ``ScenarioSet`` (:74),
``WhatIfResult`` (:436), ``WhatIfEngine`` (:503; ``run`` :2657) on its v3
path, completions and gangs on, over one device or a scenario mesh, and
``uniform_scenarios`` (:3960). The JAX engine vmaps its chunk program over the scenario axis
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
failed non-gang pods, retry pass and pending list (on the chunk route
inside each chunk's K6 launch, K6's retry mode, as the reference runs them
inside its chunk program; on the per-slot route
:func:`.torch_runtime.run_retry_boundary`; ``WhatIfResult.retry_dropped
[S]``). It keeps the reference's refusals (no finite durations or
``completions=False``, ``collect_assignments``, tier preemption, fork
checkpoints). The reference also refuses traces whose count planes
need non-singleton host-scale rows (:956-966), a limit of its TPU plane
layout; the port's state has no host planes, so it runs them.

Kube preemption (``preemption="kube"``, ``retry_buffer > 0``; the
reference's per-scenario host mirrors, :591-620, :864-866, :2830-2883)
runs each scenario's retry pass, PostFilter and victims in its own cluster
of K6's retry-mode launches, over the scenario's own allocatable and taints
(:mod:`.torch_runtime`), with the trailing boundary after the last chunk;
``WhatIfResult.preemptions``, ``retry_dropped`` and the ``evictions`` /
``evict_*`` counters come back per scenario (sim/boundary.py:401-412), and
so do the fragmentation gauges and, with telemetry on, the latency
quantiles and (at ``series`` and above) ``scenario_telemetry``: one
collector a scenario, filled on the host after the run as the single
replay fills its own (the reference's result assembly, :3536-3590). A
kube batch takes a chaos timeline a scenario (``Scenario.events``; the
reference's :757-781, :3266-3330): at a boundary each scenario's events
rewrite its allocatable rows from its own t = 0 row (after its static
perturbations), K10 evicts the pods of its down nodes before the releases,
and the run restores the stacks. It
keeps the reference's refusals (a mesh, fork checkpoints, no buffer,
``completions=False``, label perturbations or ``engine="v2"``) and the
port's refusal of pre-bound pods (queue A item 7); ``collect_assignments``
runs.

Per-scenario policies (``policies=[S, 6]``, row B1w; the reference's
:1101-1133 and ``set_policies`` :1155) give each scenario its own Score
weights and NodeResourcesFit selector (:mod:`..ops.policy`): the rows
live in one device tensor that K1 and K2 read on every path the batch
runs (plain, device release, label rows, the v2 fallback), and
``set_policies`` copies new values into it, so a search runs on one
set-up (``setups``). Kube or tier preemption, the retry buffer and fork
checkpoints refuse policies with the reference's error.

``set_scenarios`` (the reference's :1185-1283) swaps the scenario batch the
same way: a new :class:`ScenarioSet`'s allocatable and taint stacks replace
the engine's, and each scenario's chaos timeline the old ones, with no new
set-up; the resident query service (:mod:`.service`) answers its warm
queries so. It refuses where the reference refuses, in its words; the
reference's check of the compiled shapes is a check of the shapes and
dtypes of the stacks against the tables the engine set up.

The batch's chunks take the route its mode chooses
(:func:`.torch_runtime.choose_route`): one K6 launch a chunk on every path
above, the v2 fallback included, but the plain twins, which run K1 → K2
→ K3 a slot; ``WhatIfResult.route`` records it.

A scenario mesh (``mesh=``, :mod:`..parallel.mesh`: an ordered list of
devices; the reference shards the scenario axis over a ``jax`` mesh with a
collective-free ``shard_map``, :1291-1320) splits the S scenarios into
contiguous blocks of S / ndev, block i on device i. The set-up is built
once (trace, waves, chunk plan, step constants, scenario stacks); each
block holds its slice of the scenario-strided tables (allocatable, taints,
label rows ``lrow``, policy rows, and the tier and retry state its tables
make) on its device, with the pod and label tables once a device, and
enqueues the chunk route it would run unsplit on a stream of its own; the
blocks' choice buffers come back with one fetch each, in scenario order, so
a block holds exactly the scenarios it would hold unsplit. The reference's
mesh semantics hold at any ndev, one included: S must divide over the
devices (its ``ValueError``), tier preemption with completions turns
arrivals-only with its warning, and so does a DynTables batch, which
leaves the device-release path under a mesh (:979-997); kube (the reference's
error) and node shards stay refused. ``WhatIfResult.n_devices`` and ``mesh_shape`` say how
the batch ran.

A fork (``fork_checkpoint=``, a plain checkpoint of the single replay;
the reference's ``_load_fork_or_init`` / ``_init_states``, :1854-1934,
and its fork paths, :2738-2810, :2939-2962) starts every scenario from the
file's planes (its domain axis padded to the batch's; a relabelled batch
reads its own domain ids in them, on the v2 fallback, as the reference's)
and runs the waves after the fork point on its own chunk grid: the source's
choices, clamped to the real wave count, are a tail of the choice buffer
common to every scenario (:func:`.torch_runtime.fork_tail`), the pods of
its last chunk release from boundary 1 and the others from boundary 0, and
the file's released mask leaves out every release its state already
carries. ``placed`` counts the waves after the fork, as the reference's.
The reference's refusals hold: a boundary-mode file, kube, tier
preemption, the retry buffer and policies with a fork.

The engine's other modes raise ``NotImplementedError`` naming the queue
item that ports them.
"""

from __future__ import annotations

import contextlib
import copy
import time
import warnings
from dataclasses import dataclass, field, replace as dc_replace
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..framework.framework import FrameworkConfig
from ..models.core import Effect
from ..models.encode import PAD, EncodedCluster, EncodedPods
from ..ops import kernels as K
from ..ops import reference as ref
from ..ops.policy import POLICY_COLS
from ..parallel.mesh import make_mesh, mesh_shape
from ..utils.metrics import fragmentation_gauges, log
from .runtime import validate_node_events
from .telemetry import (PhaseTimers, ReplayTelemetry, TelemetryCollector, TelemetryConfig,
                        resolve_granularity)
from .tiers import DMAX_COARSE, nonsingleton_host_rows, normalize_preemption
from .torch_runtime import (
    ChunkEngine,
    StepSpec,
    _spread_norm_f32_ok,
    assignments_from_choices,
    chaos_counters,
    check_retry_buffer,
    choose_route,
    completions_gate,
    make_tick,
    new_choices,
    release_times,
    resolve_device,
    run_waves,
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
    # Timed failure/recovery timeline (chaos campaigns: sim.runtime.NodeEvent,
    # sorted by time); needs kube preemption.
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
    ``fleet_telemetry`` (above telemetry "off"), under tier or kube
    preemption ``preemptions`` (victims per scenario), under the retry
    buffer ``retry_dropped`` (failures and victims dropped on a full
    buffer, per scenario), under kube the chaos counters ``evictions`` /
    ``evict_*`` (zero in a scenario without a timeline), the fragmentation
    gauges ``stranded_cpu`` / ``frag_index_cpu`` / ``packing_efficiency``
    (always, against each scenario's restored t = 0 allocatable), with
    telemetry on the first-bind latency quantiles ``latency_p50`` /
    ``_p90`` / ``_p99`` (NaN where a scenario bound nothing) and at
    ``series`` and above ``scenario_telemetry`` (one ReplayTelemetry a
    scenario: reasons, series and, at ``timeline``, its events); the
    fields of modes not ported yet stay None."""

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
    n_devices: int = 1  # the mesh's devices (1 without one)
    mesh_shape: Optional[dict] = None  # {"scenarios": n_devices} under a mesh
    process_count: int = 1
    #: the route the chunks' waves took: "chunk" (K6) or "slot" (K1 -> K2 -> K3)
    route: Optional[str] = None


class WhatIfEngine(ChunkEngine):
    """Batched scenario evaluation on one device, or over a scenario mesh.

    ``device`` defaults to ``"cuda"`` (the kernels; raises without a card)
    and ``device="cpu"`` runs the plain twins; ``plain=True`` runs the
    twins on any device. ``mesh`` (a list of devices,
    :func:`..parallel.mesh.make_mesh`) splits the scenarios into a block a
    device (module docstring); its devices replace ``device``. ``completions`` (None = on when the trace has
    finite durations), ``retry_buffer``, ``granularity_guard`` and
    ``collect_assignments`` behave as in the JAX engine; the result is the
    same whether or not the assignments are collected. ``telemetry`` is
    any granularity; above "off" the result's ``fleet_telemetry`` carries
    it and the batch's phase timers, and, as the reference's batch off the
    kube path, no per-scenario reasons or series; a kube batch collects
    each scenario's on the card as the single replay does (its latency
    quantiles, and at ``series`` and above ``scenario_telemetry``). ``policies`` ([S, 6]
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
        rb = check_retry_buffer(retry_buffer)
        kube = normalize_preemption(preemption) == "kube"
        # Tier preemption with a buffer meets the batch's own refusal below,
        # in the reference's words; kube without one, the engines' error.
        mode = tier_preemption(preemption, retry_buffer=rb if kube else 0)
        # Per-scenario timed failure/recovery timelines (chaos campaigns):
        # the reference applies them through its per-scenario kube mirrors
        # (sim/whatif.py:757-781), so they need kube; kept as given (an
        # unsorted timeline must error, not be silently fixed).
        timelines = [list(getattr(sc, "events", None) or []) for sc in scenarios]
        if any(timelines):
            if not kube:
                raise ValueError(
                    "per-scenario timed event timelines (Scenario.events) require "
                    "preemption='kube' with retry_buffer > 0: events apply through the "
                    "per-scenario host mirrors at chunk boundaries, and node_down evictions "
                    "requeue victims through the boundary retry pass. Use static t=0 "
                    "Perturbations for mirror-free batches."
                )
            for si, tl in enumerate(timelines):
                try:
                    validate_node_events(tl, ec.num_nodes)
                except ValueError as e:
                    raise ValueError(f"scenario {si}: {e}") from None
        #: each scenario's chaos timeline (None: no scenario has an event)
        self._events = timelines if any(timelines) else None
        if kube:
            # The reference's kube guards (sim/whatif.py:598-620).
            if mesh is not None:
                raise ValueError("kube preemption requires a no-mesh batch (the eager per-chunk "
                                 "folds would serialize the scenario axis)")
            if fork_checkpoint is not None:
                raise ValueError("kube preemption does not support fork checkpoints")
            if completions is False:
                raise ValueError(
                    "completions=False is not supported with kube preemption (the boundary "
                    "pass owns releases) — same rule as the single-replay engine"
                )
        sset = ScenarioSet(ec, scenarios)
        self.engine = "v3"
        if sset.labels_dirty:
            reasons = sset.outside_envelope(mode is not None, fork_checkpoint, pods)
            if reasons:
                # The reference's v2 fallback: the same kernels run the
                # batch here; completions follow the reference's gate below.
                self.engine = "v2"
                log.info("what-if: labels_dirty batch outside the DynTables envelope (%s) — "
                         "the v2 fallback engine; WhatIfResult.engine reports it",
                         ", ".join(reasons))
        if kube and (engine != "v3" or sset.labels_dirty):
            raise ValueError(
                "kube preemption requires the v3 engine with no label perturbations (the "
                "per-scenario host mirrors share the base topology-domain tables)"
            )
        if rb and not kube and (not completions_gate(pods, completions) or collect_assignments
                                or mode or fork_checkpoint is not None or sset.labels_dirty):
            raise ValueError(
                "retry_buffer requires the device-release completions path (finite durations, "
                "completions on, no collect_assignments, tier preemption or fork checkpoint) "
                "without label-perturbation DynTables"
            )
        if mode == "tier" and (engine != "v3" or self.engine != "v3" or fork_checkpoint):
            raise ValueError(
                "what-if preemption requires the v3 engine (no label perturbations) and no "
                "fork checkpoint"
            )
        if mode and bool((pods.bound_node >= 0).any()):
            # The reference's aggregate tally cannot tell pre-bound victims
            # from replay placements; the port keeps its refusal (with kube:
            # ROADMAP queue A item 7).
            raise ValueError("what-if preemption does not support pre-bound pods")
        if engine != "v3":
            # The reference's WhatIfEngine takes no engine= argument: its v2
            # fallback runs on its own when a batch's labels are dirty
            # (WhatIfResult.engine says so), as it does here.
            raise NotImplementedError(
                f"WhatIfEngine(engine={engine!r}) is refused: the reference's WhatIfEngine has "
                "no engine= argument, and the v2 fallback runs on its own when label "
                "perturbations leave the DynTables envelope"
            )
        if mesh is not None:
            mesh = make_mesh(devices=mesh)
            if len(scenarios) % len(mesh) != 0:
                raise ValueError(f"num scenarios {len(scenarios)} must divide over "
                                 f"{len(mesh)} devices")
        if node_shards and int(node_shards) > 1:
            # As the reference's what-if (sim/whatif.py:583-589): the batch
            # spends its device axis on scenarios; node shards are the
            # single replay's (TorchReplayEngine(node_shards=...)).
            raise NotImplementedError(
                "node_shards (intra-scenario node-plane sharding) is not supported by the "
                "what-if batch, as in the reference: it shards the single replay — run it "
                "through TorchReplayEngine(node_shards=...) / the CLI run (ROADMAP queue A "
                "item 10, node sharding)"
            )
        fork = None
        if fork_checkpoint is not None:
            from .checkpoint import ReplayCheckpoint

            fork = ReplayCheckpoint.load(fork_checkpoint)
        if _dcn_recovery is not None:
            raise _later("_dcn_recovery (the multi-process fleet)", "queue A item 11")
        # Off the kube path the reference's batch collects the same at every
        # granularity above "off": the batch's phase timers in one fleet
        # telemetry and no per-scenario reasons (those come from the kube
        # mirrors, sim/whatif.py:2847-2863, :3576-3588).
        self.telemetry = resolve_granularity(telemetry)
        #: the scenario mesh (:mod:`..parallel.mesh`), or None
        self.mesh = mesh
        if mesh is not None:
            for d in mesh:
                resolve_device(d)
            device = mesh[0]
        device = resolve_device(device)
        self.collect_assignments = bool(collect_assignments)
        spec = StepSpec.from_config(ec, config, pods)
        completions = self._completions_gate(ec, pods, completions, sset, spec, mode == "tier")
        # Under a mesh the stacks stay on the host, and each block takes its
        # slice to its device (_make_blocks).
        home = device if mesh is None else torch.device("cpu")
        self.sset = sset.to(home)
        if sset.injected_prefer_taint and not spec.taint_score:
            spec = dc_replace(spec, taint_score=True)
        cluster = ref.cluster_to(ec, home, sset.num_scenarios)._replace(
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
        #: tier preemption (True) or not; kube is ``self.kube``
        self.preemption = mode == "tier"
        wrow = torch.tensor(pol, device=device) if pol is not None else None
        #: the count planes' domain capacity, and whether a scenario scales
        #: the "pods" capacity up (the reference's bf16 host-plane gate):
        #: what ``set_scenarios`` holds a swapped batch to
        self._D = max(sset.max_domains, 1)
        self._scales_pods = self.engine == "v3" and any(
            pt.op == "scale_capacity" and pt.resource == "pods" and pt.factor > 1
            for sc in scenarios for pt in sc.perturbations)
        self._prepare(ec, pods, spec, cluster, sset.num_scenarios, wave_width, chunk_waves,
                      completions, granularity_guard, "what-if engine", device, plain,
                      mode == "tier", rb, domains, wrow, kube=kube, fork=fork)
        self._blocks = self._make_blocks(mesh, rb) if mesh is not None else None

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
        for blk in self._blocks or ():
            blk.engine._wrow.copy_(torch.from_numpy(np.ascontiguousarray(pol[blk.lo:blk.hi])))

    def set_scenarios(self, scenarios) -> None:
        """Swap the scenario BATCH without a new set-up: the per-scenario
        cluster stacks (allocatable and taints) and the chaos timelines are
        rebuilt, everything else the engine set up (the plan, the pod and
        label tables, the step constants) stays (``setups`` stays), the way
        :meth:`set_policies` swaps the policy rows. The reference's refusals
        (sim/whatif.py:1185-1283), in its words: a meshed engine (the
        reference's DCN slice; its ``service`` refuses meshes, cli.py:604-607),
        the v2 engine, label perturbations at build or in the new batch, a
        wrong scenario count, timelines without kube, a timeline that does
        not validate (with the scenario's index), a different domain
        capacity, prefer-taints injected into an engine built without taint
        scoring, a ``pods`` scale-up where the engine was built without one,
        and stacks whose shapes or dtypes differ from the engine's tables."""
        if self.mesh is not None:
            raise ValueError(
                "set_scenarios is single-process only: a meshed engine's blocks each hold a "
                "contiguous slice of the batch and cannot swap scenarios underneath the slice "
                "bookkeeping"
            )
        if self.engine != "v3":
            raise ValueError(
                "set_scenarios requires the v3 engine (the v2 parity fallback rebuilds "
                "per-batch state at trace time)"
            )
        if self.sset.labels_dirty:
            raise ValueError(
                "set_scenarios does not support engines built with label perturbations "
                "(DynTables are baked per batch) — rebuild the engine instead"
            )
        scenarios = list(scenarios)
        if len(scenarios) != self.S:
            raise ValueError(
                f"scenario count ({len(scenarios)}) must match the engine's ({self.S}) — the "
                "compiled program is shape-specialized"
            )
        timelines = [list(getattr(sc, "events", None) or []) for sc in scenarios]
        if any(timelines):
            if not self.kube:
                raise ValueError(
                    "per-scenario timed event timelines (Scenario.events) require "
                    "preemption='kube' with retry_buffer > 0"
                )
            for si, tl in enumerate(timelines):
                try:
                    validate_node_events(tl, self.ec.num_nodes)
                except ValueError as e:
                    raise ValueError(f"scenario {si}: {e}") from None
        sset = ScenarioSet(self.ec, scenarios, device=self.device)
        if sset.labels_dirty:
            raise ValueError(
                "set_scenarios does not support label perturbations (the swapped batch would "
                "need fresh DynTables) — rebuild the engine instead"
            )
        if max(sset.max_domains, 1) != self._D:
            raise ValueError(
                f"scenario batch needs domain capacity {max(sset.max_domains, 1)} but the "
                f"engine compiled with {self._D}"
            )
        if sset.injected_prefer_taint and not self.spec.taint_score:
            raise ValueError(
                "scenario batch injects prefer-taints but the engine compiled without taint "
                "scoring — rebuild the engine"
            )
        if not self._scales_pods and any(
            pt.op == "scale_capacity" and pt.resource == "pods" and pt.factor > 1
            for sc in scenarios for pt in sc.perturbations
        ):
            raise ValueError(
                "scenario batch scales the 'pods' capacity up but the engine compiled on the "
                "bf16 host plane — rebuild the engine with such a scenario present"
            )
        new = dict(allocatable=sset.alloc, taint_key=sset.taint_key, taint_kv=sset.taint_kv,
                   taint_effect=sset.taint_effect)
        sig = lambda ts: [(tuple(t.shape), t.dtype) for t in ts]
        if sig(new.values()) != sig(getattr(self._cluster, f) for f in new):
            raise ValueError(
                "scenario batch changes the compiled array shapes/dtypes — the executable is "
                "shape-specialized; rebuild the engine for this batch"
            )
        self.sset = sset
        self._cluster = self._cluster._replace(**new)
        self._events = timelines if any(timelines) else None

    def _completions_gate(self, ec: EncodedCluster, pods: EncodedPods,
                          completions: Optional[bool], sset: ScenarioSet, spec: StepSpec,
                          tier: bool = False) -> Optional[bool]:
        """The reference's gate (sim/whatif.py:940-1000): completions cannot
        be honoured on the v2 fallback, with tier preemption under a mesh,
        nor on a DynTables batch off the device-release path (a mesh,
        ``collect_assignments``, or count planes of non-singleton
        host-scale rows). Such a batch warns and runs arrivals-only, or
        raises under ``completions=True``. Returns the ``completions``
        argument the chunk loop takes."""
        blockers = []
        if self.engine != "v3":
            blockers.append("the v2 fallback engine (label perturbations outside the "
                            "DynTables envelope)")
        if tier and self.mesh is not None:
            blockers.append("device tier preemption under a mesh")
        if self.engine == "v3" and sset.labels_dirty:
            why = [w for w, on in (("mesh", self.mesh is not None),
                                   ("collect_assignments", self.collect_assignments)) if on]
            if not why and nonsingleton_host_rows(ec, pods, spec.interpod, spec.spread):
                why.append("non-singleton host-scale count planes")
            if why:
                blockers.append(
                    f"labels_dirty DynTables batches off the device-release path "
                    f"({'/'.join(why)} — per-scenario release domain corrections need the "
                    "device path)")
        if not blockers:
            return completions
        if completions is not False and bool(np.isfinite(release_times(pods)).any()):
            msg = ("what-if completions cannot be honored with " + "; ".join(blockers)
                   + " — this batch runs ARRIVALS-ONLY (placed pods never release resources)")
            if completions is True:
                raise ValueError(msg)
            warnings.warn(msg, stacklevel=3)
        return False

    def _alloc0(self) -> np.ndarray:
        """[S, N, R] f32: each scenario's allocatable after its static
        perturbations, the row a ``node_up`` restores (the reference's
        ``ksaved_alloc``, sim/whatif.py:2915)."""
        return self.sset._alloc.astype(np.float32)

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

    def _make_blocks(self, mesh: List[torch.device], rb: int) -> List["_Block"]:
        """The mesh's blocks: scenarios [i·S/n, (i+1)·S/n) on device i, each an
        engine of its own that shares this one's set-up (trace, waves, chunk
        plan, step constants) and holds its slice of the scenario-strided
        tables — allocatable, taints and label rows (``lrow``), the policy
        rows, the tier and retry state its tables make — on its device, with
        the pod and label tables once a device. Each block enqueues on a
        stream of its own; under the retry buffer the blocks of one device
        share its stream, because K6's retry mode passes its arguments
        through the module's constant memory, which a launch on another
        stream of the same card could overwrite before the first one reads
        it."""
        n = self.S // len(mesh)
        host = self._cluster  # every field on the host, S-stacked where per scenario
        per_scenario = ("allocatable", "taint_key", "taint_kv", "taint_effect", "lrow")
        shared, pods, streams, blocks = {}, {self.device: self._pods}, {}, []
        for i, dev in enumerate(mesh):
            lo, hi = i * n, (i + 1) * n
            if dev not in shared:
                shared[dev] = {f: getattr(host, f).to(dev) for f in ref.DevCluster._fields
                               if f not in per_scenario}
                pods[dev] = pods.get(dev) or ref.pods_to(self.pods, dev)
            view = copy.copy(self)
            view._blocks, view.mesh = None, None
            view.S, view.device = n, dev
            view._cluster = ref.DevCluster(**shared[dev], **{
                f: getattr(host, f)[lo:hi].contiguous().to(dev) for f in per_scenario})
            view._pods = pods[dev]
            if self._wrow is not None:
                view._wrow = self._wrow[lo:hi].contiguous().to(dev)
            if self._domains is not None:
                nd, ndom, lrow, D = self._domains
                view._domains = (nd, ndom, lrow[lo:hi], D)
            stream = None
            if dev.type == "cuda":
                if rb:
                    stream = streams.setdefault(dev, torch.cuda.Stream(device=dev))
                else:
                    stream = torch.cuda.Stream(device=dev)
            blocks.append(_Block(lo, hi, view, stream))
        return blocks

    def _run(self, timers=None, series: bool = False, route: Optional[str] = None,
             joint: bool = False, recorder=None, timeline: bool = False):
        """:meth:`ChunkEngine._run`; under a mesh, every block's chunks are
        enqueued (block by block, each on its device and stream) before one
        fetch a block, in scenario order, so the blocks run at once; the
        blocks that share a card plan their launches for their share of its
        SMs (:func:`..ops.kernels.sm_share`). The tables are then a list, one
        a block (``last_tables``)."""
        if self._blocks is None:
            return super()._run(timers, series, route, joint, recorder, timeline)
        tick = make_tick(timers)
        plan, bound = self.plan, self.pods.bound_node
        self.last_route = route = route or choose_route(self.plain)
        tbs = [blk.engine._tables() for blk in self._blocks]
        chs = [new_choices(plan, blk.hi - blk.lo, blk.engine.device)
               for blk in self._blocks]
        share = {}
        for blk in self._blocks:
            share[blk.engine.device] = share.get(blk.engine.device, 0) + 1
        t0 = time.perf_counter()
        for blk, tb, ch in zip(self._blocks, tbs, chs):
            with blk.on_device(), K.sm_share(share[blk.engine.device]):
                run_waves(plan, tb, ch, 0, plan.idx.shape[0], self.plain, None, route,
                          timers=timers)
        with tick("device_wait"):
            host = []
            for blk, ch in zip(self._blocks, chs):
                with blk.on_device():
                    host.append(ch.cpu().numpy())
        wall = time.perf_counter() - t0
        self.last_tables, self.last_series, self.last_pager = tbs, None, None
        self.last_choices = host_choices = np.concatenate(host)
        rnode = (np.concatenate([tb.retry.rnode.cpu().numpy() for tb in tbs])
                 if tbs[0].retry is not None else None)
        return (tbs, wall) + assignments_from_choices(plan, host_choices, bound, rnode)

    def run(self) -> WhatIfResult:
        timers = PhaseTimers() if self.telemetry != "off" else None
        tcfg = TelemetryConfig.resolve(self.telemetry)
        # Under kube each scenario has its own collector (the reference's
        # per-scenario host mirrors, sim/whatif.py:2847-2863): series and
        # timeline attribute and sample on the card, as the single replay.
        tb, wall, assignments, placed, to_schedule = self._run(
            timers, series=self.kube and tcfg.want_series,
            timeline=self.kube and tcfg.want_timeline)
        tbs = tb if isinstance(tb, list) else [tb]

        def per_block(f):
            """``f`` of each block's tables, concatenated in scenario order."""
            parts = [f(t) for t in tbs]
            return None if parts[0] is None else np.concatenate(parts)

        total = int(placed.sum())
        return WhatIfResult(
            placed=placed,
            unschedulable=(to_schedule - placed).astype(np.int32),
            total_placed=total,
            wall_clock_s=wall,
            placements_per_sec=total / wall if wall > 0 else 0.0,
            assignments=assignments if self.collect_assignments else None,
            utilization_cpu=per_block(self._utilization_cpu),
            completions_on=self.completions_on,
            engine=self.engine,
            preemptions=per_block(lambda t: t.preempt.victims.cpu().numpy()
                                  if t.preempt is not None else t.retry.preempt.cpu().numpy()
                                  if self.kube else None),
            retry_dropped=per_block(lambda t: t.retry.rdrop.cpu().numpy()
                                    if t.retry is not None else None),
            # kube batches report the reference's counters() tuple
            # (sim/boundary.py:401-412): zeros in a scenario without a timeline
            **({} if not self.kube else dict(zip(
                ("evictions", "evict_rescheduled", "evict_stranded", "evict_latency_mean"),
                chaos_counters(tbs[0].retry)))),
            fleet_telemetry=(ReplayTelemetry(granularity=self.telemetry, phases=timers.summary())
                             if timers is not None else None),
            n_devices=len(self.mesh) if self.mesh is not None else 1,
            mesh_shape=mesh_shape(self.mesh),
            route=self.last_route,
            **(self._kube_results(tb, assignments, placed, tcfg) if self.kube else {}),
        )

    def _kube_results(self, tb: ref.Tables, assignments: np.ndarray, placed: np.ndarray,
                      tcfg: TelemetryConfig) -> dict:
        """The kube batch's per-scenario result fields (the reference's
        result assembly, sim/whatif.py:3536-3590): fragmentation gauges of
        each scenario's fetched ``used`` over its restored t = 0
        allocatable and its still-pending pods' requests; with telemetry on
        one collector a scenario (:meth:`.torch_runtime.ChunkEngine._collect`,
        with its own chaos timeline's events), its latency quantiles
        (NaN where it bound nothing) and, at series and above, the
        collectors' results."""
        S = self.S
        used = tb.state.used.cpu().numpy()
        alloc0 = self._alloc0()
        pending = (self.pods.bound_node == PAD)[None] & (assignments == PAD)
        frag = np.zeros((3, S), np.float64)
        for s in range(S):
            fr = fragmentation_gauges(alloc0[s], used[s], self.pods.requests[pending[s]],
                                      self.ec.vocab._r)
            frag[:, s] = (fr["stranded"].get("cpu", 0.0), fr["frag_index"].get("cpu", 0.0),
                          fr["packing_efficiency"])
        out = dict(stranded_cpu=frag[0], frag_index_cpu=frag[1], packing_efficiency=frag[2])
        if not tcfg.enabled:
            return out
        timelines = self._timelines()
        stel = []
        for s in range(S):
            tel = TelemetryCollector(tcfg)
            self._collect(tel, tb, int(placed[s]), s, timelines[s] if timelines else None,
                          interleave=True)
            stel.append(tel.result())
        lat = np.full((3, S), np.nan, np.float64)
        for s, t in enumerate(stel):
            if t.latency is not None:
                lat[:, s] = t.latency["p50"], t.latency["p90"], t.latency["p99"]
        out.update(latency_p50=lat[0], latency_p90=lat[1], latency_p99=lat[2],
                   scenario_telemetry=stel if tcfg.want_series else None)
        return out


@dataclass
class _Block:
    """One block of a meshed batch: scenarios [lo, hi), the engine that
    holds their tables on its device, and the CUDA stream it enqueues on
    (None off a card)."""

    lo: int
    hi: int
    engine: ChunkEngine
    stream: Optional[torch.cuda.Stream]

    def on_device(self):
        """The block's device and stream as the current ones; the stream
        first waits for the work its tables' set-up enqueued."""
        if self.stream is None:
            return contextlib.nullcontext()
        dev = self.engine.device
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(dev))
        self.stream.wait_stream(torch.cuda.current_stream(dev))
        stack.enter_context(torch.cuda.stream(self.stream))
        return stack


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
