"""The ``torch`` scheduling strategy: the single-scenario replay on the
card, through the hand-written kernels of :mod:`..ops.kernels`, and the
S-batched chunk loop it shares with the what-if engine
(:mod:`.whatif`).

Counterpart: ``kubernetes_simulator_tpu/sim/jax_runtime.py`` —
``StepSpec`` (:122, with ``from_config``), ``_spread_norm_f32_ok`` (:215),
``_spread_w_table`` (:236), ``wave_start_times`` (:764), the plain path
of ``JaxReplayEngine.replay`` (:2012) with the chunk program
``make_chunk_fn3_src`` (:742), and ``_apply_release`` (:1414); and the
device-release staging of ``kubernetes_simulator_tpu/sim/whatif.py``
(``_stage_dev_rel`` :2200), which both engines use.

Semantics are :mod:`kubernetes_simulator_tpu.sim.greedy`'s
``greedy_replay`` exactly (the parity anchor of both packages), in every
scenario: arrival-order waves of W slots; within a wave, slots run in
order and each sees the speculative binds of the slots before it; at the
wave end a gang commits whole or rolls back; completed pods release at
chunk boundaries under the one-chunk-slack rule (boundary b sees the
binds of chunks ≤ b−2). Unlike the reference's v3 program, which commits
a wave's ``used`` in one reduction, the port adds per pod, as
``greedy_replay`` does.

Four routes run a chunk's waves, chosen from the run's mode alone
(:func:`choose_route`), never from a failure:

- ``"chunk"`` (the main path): one K6 (chunk_replay) launch a chunk runs
  every slot's K1 → K2 → K3 and each gang wave's rollback on the card,
  reading the pods from the plan's device descriptor (:class:`ChunkDesc`,
  uploaded once a run) — the counterpart of the reference's one dispatch a
  chunk (``make_chunk_fn3_src``). Telemetry ``series``/``timeline`` takes it
  too: on the plain path K6's attributed mode charges each failed slot as
  K5 would, before its bind (the reference's ``make_chunk_fn_rej``, one
  dispatch a chunk); on the retry path K5 folds each chunk and runs in the
  retry pass between K6 launches;
- ``"slot"``: per slot the host enqueues K1 (filter_score) → K2
  (normalize_select) → (K5 at series on the plain path) → K3
  (apply_placements, bind) and a K3 rollback after a wave holding gang
  members. The plain twins (``plain=True``) take it, and ``_run(route=
  "slot")`` holds the chunk route against it;
- ``"shard"`` (node-plane shards, ``node_shards > 1``; row B13, the
  reference's node-sharded v2 program, sim/jax_runtime.py:494
  ``make_wave_step_sharded`` and :548 ``make_chunk_fn_sharded``, one
  dispatch a chunk): the tables span the padded node axis of
  :mod:`..parallel.shards`; a boundary's K8 (shard_apply) release, then one
  K9 (shard_chunk_replay) launch a chunk runs every slot's K1 over the
  rank's shards (pad rows infeasible) → K7 (each shard's packed extrema, the
  two-stage choice, the owner's domain ids) → K8 bind and each gang wave's
  K8 rollback on the card, reading the pods from the plan's
  :class:`ChunkDesc`;
- ``"shard_slot"``: the same tables, and per slot the host enqueues K1 over
  the padded axis → K7 (shard_select) → K8 (shard_apply, bind), with K8's
  rollback after a gang wave and K8's release at a boundary. The plain
  twins (``plain=True``) on sharded tables take it; it places as
  ``"shard"`` bit for bit (K9 runs K1's, K7's and K8's bodies).

Paged pod waves (``paged=True``, :mod:`.pager`) run on the chunk and shard
routes (both): each chunk reads the pod rows of its page, streamed while the
previous chunk runs.

Either way every launch covers all S scenarios; K2 writes each scenario's
choice into the device-resident choice buffer ``[S, L]`` and K3 reads it
there, so nothing returns to the host per pod, and the two routes place
alike bit for bit (K6 runs K1's, K2's and K3's bodies). The boundary at
which a completed pod releases is the same in every scenario and is
bucketed once per engine on the host (:func:`plan_chunks`); at a boundary,
before the chunk's waves, one K3 release launch walks that bucket, reading
each scenario's own choice (PAD for unplaced and rolled-back pods). The
host synchronises once per run, to fetch the choice buffer.

Tier preemption (``preemption=True`` / ``"tier"``; :mod:`.tiers`, the
``st.preemption`` sections of ``ops/tpu3.py`` and the results of
``JaxReplayEngine`` :2486-2515) adds no launch: K1 also writes the
candidate row of a pod that may preempt, K2 takes its masked argmin where
nothing is feasible (once per wave and scenario) and records the
eviction, and K3's bind first writes PAD over the victims' columns of the
choice buffer, frees their usage and counts them. The victims' PAD keeps
them out of every later release, and the final fetch yields the
assignments with no host walk (``preemption_walk`` :788 is not needed).

The unschedulable-retry buffer (``retry_buffer=RB``; the semantics of
``greedy_replay(retry_buffer=...)``, sim/greedy.py:110, which the JAX
package runs as the host boundary pass of sim/boundary.py:350-678 in the
single replay and as the retry variant of ``_build_chunk_fn``,
sim/whatif.py:1406-1557, in the what-if) runs on the device in both
engines: a main-path K3 bind appends a failed non-gang pod to its
scenario's FIFO (overflow drops the newest, counted); at each boundary
after the static release, K3 releases the due entries of the pending
list, the retry pass runs K1 → K2 → K3 over the buffer slots with one
pod per scenario, and K4 (retry_boundary) records the retried binds,
schedules their releases on the pending list and compacts the buffer. A
retried pod's slot column keeps PAD, so its static bucket never releases
it; its node comes back in ``Retry.rnode``.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, replace as dc_replace
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..framework.framework import FrameworkConfig
from ..framework.registry import register_strategy
from ..models.core import Effect
from ..models.encode import PAD, EncodedCluster, EncodedPods
from ..models.state import SchedState, init_state
from ..ops import kernels as K
from ..ops import reference as ref
from ..plugins.builtin import DEFAULT_WEIGHTS, PLUGIN_NAMES
from ..utils.metrics import fragmentation_gauges, log, series_gauges, utilization_means
from .runtime import ReplayResult
from ..parallel.shards import make_layout, shard_cluster
from .telemetry import TelemetryCollector, TelemetryConfig, resolve_granularity
from .tiers import check_tier_mode, normalize_preemption, tier_planes
from .waves import pack_waves


@dataclass(frozen=True)
class StepSpec:
    """Static description of the fused Filter+Score step (the JAX
    package's StepSpec, field for field)."""

    fit: bool = True
    taints: bool = True
    node_affinity: bool = True
    interpod: bool = True
    spread: bool = True
    fit_strategy: str = "LeastAllocated"
    weights: Tuple[Tuple[str, float], ...] = ()
    resource_weights: Tuple[float, ...] = ()  # [R]
    shape_x: Tuple[float, ...] = (0.0, 100.0)
    shape_y: Tuple[float, ...] = (0.0, 100.0)
    # Static trace properties: gate work the trace can never trigger.
    has_symmetric_pref: bool = True
    has_gangs: bool = True
    # Any PreferNoSchedule taint can exist; when False the taint score row
    # is a constant 100 (never changes the argmax) and is dropped.
    taint_score: bool = True
    # [G] upstream topologyNormalizingWeight log(size + 2) per group.
    sp_w_g: Tuple[float, ...] = ()
    # Every spread raw ≤ 83886: the f32 normalize division equals the
    # integer one (ops.reference.spread_normalize).
    sp_norm_f32: bool = False

    @classmethod
    def from_config(
        cls,
        ec: EncodedCluster,
        config: Optional[FrameworkConfig],
        pods: Optional[EncodedPods] = None,
    ) -> "StepSpec":
        entries = (config.plugins if config and config.plugins is not None else None)
        if entries is None:
            entries = [{"name": n} for n in PLUGIN_NAMES]
        names = {e["name"] for e in entries}
        unknown = names - set(PLUGIN_NAMES)
        if unknown:
            raise ValueError(
                f"unknown plugin(s) {sorted(unknown)}; known: {', '.join(PLUGIN_NAMES)}"
            )
        weights = dict(DEFAULT_WEIGHTS)
        if config and config.weights:
            weights.update(config.weights)
        fit_strategy = "LeastAllocated"
        res = {"cpu": 1.0, "memory": 1.0}
        shape = [{"utilization": 0, "score": 0}, {"utilization": 100, "score": 10}]
        for e in entries:
            if e["name"] == "NodeResourcesFit":
                args = e.get("args", {})
                fit_strategy = args.get("strategy", fit_strategy)
                res = args.get("resources", res)
                shape = args.get("shape", shape)
        if fit_strategy not in ref.FIT_STRATEGIES:
            raise ValueError(
                f"NodeResourcesFit strategy {fit_strategy!r} must be one of "
                f"{', '.join(ref.FIT_STRATEGIES)}"
            )
        rw = np.zeros(ec.num_resources, dtype=np.float32)
        for rname, w in res.items():
            ri = ec.vocab._r.get(rname)
            if ri is not None:
                rw[ri] = w
        # A plugin whose terms never occur in the trace contributes exactly
        # 0 to every mask and normalized score, so disabling it is exact.
        na_on = "NodeAffinity" in names
        ip_on = "InterPodAffinity" in names
        sp_on = "PodTopologySpread" in names
        if pods is not None:
            na_on = na_on and bool(pods.na_has_req.any() or (pods.na_pref >= 0).any())
            ip_on = ip_on and bool(
                (pods.aff_req >= 0).any()
                or (pods.anti_req >= 0).any()
                or (pods.pref_aff >= 0).any()
            )
            sp_on = sp_on and bool((pods.spread_g >= 0).any())
        sp_w = _spread_w_table(ec)
        return cls(
            fit="NodeResourcesFit" in names,
            taints="TaintToleration" in names,
            taint_score=bool((ec.taint_effect == int(Effect.PREFER_NO_SCHEDULE)).any()),
            node_affinity=na_on,
            interpod=ip_on,
            spread=sp_on,
            fit_strategy=fit_strategy,
            weights=tuple(sorted(weights.items())),
            resource_weights=tuple(float(x) for x in rw),
            shape_x=tuple(float(pt["utilization"]) for pt in shape),
            shape_y=tuple(float(pt["score"]) * 10.0 for pt in shape),
            has_symmetric_pref=(
                bool((pods.pref_aff >= 0).any()) if pods is not None else True
            ),
            has_gangs=(bool((pods.group_id >= 0).any()) if pods is not None else True),
            sp_w_g=sp_w,
            sp_norm_f32=_spread_norm_f32_ok(sp_w, pods) if sp_on else False,
        )

    def consts(self, traced: bool = False) -> ref.StepConsts:
        """The kernels' static constants, every float rounded to f32 the
        way the reference's weak-typed arithmetic rounds it. ``traced``
        (per-scenario policy rows, ops/policy.py): every enabled plugin's
        row enters the weighted total, whatever its config weight, and the
        kernels take the weights and the fit strategy from the rows."""
        w = dict(self.weights)
        f32 = lambda v: float(np.float32(v))
        on = lambda name: traced or w.get(name, 1.0) != 0
        rw = [f32(x) for x in self.resource_weights]
        wsum = 0.0
        for x in rw:
            if x != 0:
                wsum += x
        xs = [np.float32(x) for x in self.shape_x]
        ys = [np.float32(y) for y in self.shape_y]
        segs = range(len(xs) - 1)
        return ref.StepConsts(
            fit=self.fit,
            taints=self.taints,
            node_affinity=self.node_affinity,
            interpod=self.interpod,
            spread=self.spread,
            on_fit=self.fit and on("NodeResourcesFit"),
            on_taint=self.taints and self.taint_score and on("TaintToleration"),
            on_na=self.node_affinity and on("NodeAffinity"),
            on_ip=self.interpod and on("InterPodAffinity"),
            on_sp=self.spread and on("PodTopologySpread"),
            has_symmetric_pref=self.has_symmetric_pref,
            sp_norm_f32=self.sp_norm_f32,
            fit_strategy=ref.FIT_STRATEGIES.index(self.fit_strategy),
            res_w=tuple(rw),
            wsum=f32(wsum),
            w_fit=f32(w.get("NodeResourcesFit", 1.0)),
            w_taint=f32(w.get("TaintToleration", 1.0)),
            w_na=f32(w.get("NodeAffinity", 1.0)),
            w_ip=f32(w.get("InterPodAffinity", 1.0)),
            w_sp=f32(w.get("PodTopologySpread", 1.0)),
            seg_x0=tuple(float(xs[i]) for i in segs),
            seg_x1=tuple(float(xs[i + 1]) for i in segs),
            seg_y0=tuple(float(ys[i]) for i in segs),
            seg_inv=tuple(float(np.float32(1.0) / (xs[i + 1] - xs[i])) for i in segs),
            seg_dy=tuple(float(ys[i + 1] - ys[i]) for i in segs),
            x_first=float(xs[0]),
            y_first=float(ys[0]),
            y_last=float(ys[-1]),
        )


def _spread_norm_f32_ok(sp_w, pods: Optional[EncodedPods]) -> bool:
    """True when no trace state can push a spread raw score past 83886 —
    the bound under which the f32 normalize division is exactly the
    integer division. Conservative: per-group counts are bounded by the
    total pods matching the group (plus a wave-correction margin), summed
    over the pod's constraint width at the largest weight/skew."""
    if pods is None:
        return False
    SPw = pods.spread_g.shape[1]
    if SPw == 0:
        return True
    pmg_tot = pods.pod_matches_group.sum(axis=0).astype(np.float64)
    w = np.asarray(sp_w, np.float64)
    L = min(len(pmg_tot), len(w))
    gm = float((pmg_tot[:L] * w[:L]).max()) if L else 0.0
    skew_max = float(pods.spread_skew.max()) if pods.spread_skew.size else 0.0
    bound = SPw * (gm + 64.0 * w.max(initial=0.0) + max(skew_max - 1.0, 0.0))
    return bound <= 80_000.0


def _spread_w_table(ec: EncodedCluster) -> Tuple[float, ...]:
    """[G] upstream topologyNormalizingWeight (log(size + 2)) per group:
    f64 log cast once to f32."""
    return tuple(float(x) for x in ref.group_domains(ec)[2])


def spec_plugin_names(spec: StepSpec) -> Tuple[str, ...]:
    """Filter plugins that are on, in evaluation order: the key order of
    the first-reject counters (kubernetes_simulator_tpu/sim/jax_runtime.py
    :251), K5's plugin order (csrc/ksim.cuh KSIM_PLUGIN_*) and
    :func:`..ops.reference.filter_masks`'."""
    names = []
    if spec.fit:
        names.append("NodeResourcesFit")
    if spec.taints:
        names.append("TaintToleration")
    if spec.node_affinity:
        names.append("NodeAffinity")
    if spec.interpod:
        names.append("InterPodAffinity")
    if spec.spread:
        names.append("PodTopologySpread")
    return tuple(names)


def wave_start_times(pods: EncodedPods, idx: np.ndarray) -> np.ndarray:
    """Arrival time of each wave's first valid pod (inf for padding) — the
    boundary clock of the chunk-granular completions."""
    first = idx[:, 0]
    safe = np.clip(first, 0, None)
    return np.where(first >= 0, pods.arrival[safe], np.inf)


def resolve_device(device) -> torch.device:
    """The engine's device. A CUDA device without a usable card raises —
    the port never carries on on the CPU unless the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain-PyTorch path"
        )
    return dev


def _later(what: str, slice_: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet ({slice_}); the PyTorch engines run the "
        "plain replay and the what-if batch — use the JAX package for it"
    )


def check_retry_buffer(retry_buffer) -> int:
    """The requested buffer as an int (0: off); a negative one raises."""
    rb = int(retry_buffer or 0)
    if rb < 0:
        raise ValueError(f"retry_buffer must be >= 0, got {rb}")
    return rb


def tier_preemption(preemption, engine: str = "v3", retry_buffer: int = 0,
                    node_shards: int = 0) -> bool:
    """True for tier preemption (``True`` / ``"tier"``), False when off;
    the reference's errors for the modes tier preemption excludes, and
    ``"kube"`` (the host boundary pass with the retry buffer) refused by
    name."""
    mode = normalize_preemption(preemption)
    if mode == "kube":
        raise _later("preemption='kube' (the boundary PostFilter pass with the retry buffer)",
                     "queue A item 6 in the replay, queue A item 7 in the what-if")
    if mode == "tier" and engine != "v3":
        raise ValueError("device tier preemption requires engine='v3'")
    if mode == "tier" and retry_buffer:
        raise ValueError("retry_buffer is not supported with tier preemption")
    if mode == "tier" and node_shards and int(node_shards) > 1:
        raise ValueError(
            "node_shards is not supported with tier preemption: the node-sharded chunk "
            "program is the node-space (v2) engine and tier preemption is v3-only — use "
            "preemption='kube'"
        )
    return mode == "tier"


def release_times(pods: EncodedPods) -> np.ndarray:
    """[P] time at which each pod completes (inf for a pod that runs on)."""
    return pods.arrival + np.where(np.isfinite(pods.duration), pods.duration, np.inf)


def completions_gate(pods: EncodedPods, completions: Optional[bool]) -> bool:
    """Completions are on when the trace has finite durations, unless the
    caller passes ``completions=False``."""
    return completions is not False and bool(np.isfinite(release_times(pods)).any())


class ChunkDesc(NamedTuple):
    """The device descriptor of a :class:`ChunkPlan`, K6's per-chunk input:
    the slot index and the gang flags, uploaded once a run."""

    idx: torch.Tensor  # [num_waves * W] i32 pod of each slot (PAD: empty)
    gang: torch.Tensor  # [num_waves] u8: the wave holds a gang member


#: The routes of a chunk's waves (module docstring).
ROUTES = ("chunk", "slot", "shard", "shard_slot")
#: The routes of node-sharded tables.
SHARD_ROUTES = ("shard", "shard_slot")


def choose_route(plain: bool, sharded: bool = False) -> str:
    """The route of a run, from its mode: node-sharded tables take the shard
    route (one K9 a chunk), or with ``plain`` the per-slot shard route (the
    twins of K1 → K7 → K8 a slot); otherwise the per-slot route for the
    plain twins and the chunk route (K6) for everything else —
    ``engine="v2"`` (K1–K3 commit pod by pod, so v2 places as v3 on either
    route) and telemetry series/timeline (K6's attributed mode) included."""
    if sharded:
        return "shard_slot" if plain else "shard"
    return "slot" if plain else "chunk"


def replicated_resident_bytes(ec: EncodedCluster, pods: EncodedPods,
                              pods_resident: bool = True) -> int:
    """Per-device bytes of the REPLICATED single-scenario residency: the
    cluster tensors, the state planes and (``pods_resident``) the whole
    trace's pod rows — the estimate behind ``KSIM_MAX_REPLICATED_BYTES``
    (kubernetes_simulator_tpu/sim/jax_runtime.py:580, the same formula)."""
    dc_fields = (
        ec.allocatable, ec.node_label_key, ec.node_label_kv,
        ec.node_label_num, ec.taint_key, ec.taint_kv, ec.taint_effect,
        ec.node_domain, ec.num_domains, ec.expr_key, ec.expr_op,
        ec.expr_vals, ec.expr_num, ec.group_topo,
    )
    total = sum(int(np.asarray(a).nbytes) for a in dc_fields)
    N, R = ec.num_nodes, ec.num_resources
    G = max(ec.num_groups, 1)
    total += 4 * (N * R + 3 * G * N + G)
    if pods_resident:
        pod_fields = (
            pods.requests, pods.tol_key, pods.tol_kv, pods.tol_effect,
            pods.na_req, pods.na_has_req, pods.na_pref, pods.na_pref_w,
            pods.aff_req, pods.anti_req, pods.pref_aff, pods.pref_aff_w,
            pods.spread_g, pods.spread_skew, pods.spread_dns,
            pods.pod_matches_group, pods.group_id,
        )
        total += sum(int(np.asarray(a).nbytes) for a in pod_fields)
    return total


def check_replicated_budget(ec: EncodedCluster, pods: EncodedPods, node_shards: int,
                            engine: str, paged: bool) -> None:
    """The reference's refusal (sim/jax_runtime.py:1108-1123): with
    ``KSIM_MAX_REPLICATED_BYTES`` set, a replicated run whose residency
    estimate exceeds it raises, pointing at ``node_shards`` / ``paged``."""
    import os

    budget = os.environ.get("KSIM_MAX_REPLICATED_BYTES")
    if not budget or node_shards > 1:
        return
    est = replicated_resident_bytes(ec, pods, pods_resident=(engine == "v3" and not paged))
    if est > int(budget):
        raise ValueError(
            f"replicated single-scenario residency ~{est / 2**20:.0f} MiB/device exceeds "
            f"KSIM_MAX_REPLICATED_BYTES ({int(budget) / 2**20:.0f} MiB): shard the node axis "
            "across devices (node_shards=...) and/or stream pod pages (paged=True) instead of "
            "the replicated path"
        )


@dataclass
class ChunkPlan:
    """Static chunk layout of one trace, built once per engine on the host
    (wave packing, durations and chunk size are fixed per engine).

    The choice buffer has one row per scenario and ``L`` columns: one per
    wave slot (``idx.size``, in wave order) and then a static tail with
    one column per pre-bound pod, whose node every scenario shares.
    ``buckets[b]`` holds the pods that release at boundary b (the start of
    chunk b) and their choice-buffer columns, in pod order; None where
    nothing releases."""

    idx: np.ndarray  # [num_waves, W] i32, padded to a multiple of C
    C: int
    gang_wave: np.ndarray  # [num_waves] bool: the wave holds a gang member
    prebound: np.ndarray  # pre-bound pod ids, in tail order
    buckets: List[Optional[Tuple[np.ndarray, np.ndarray]]]
    #: [L] i32 boundary at which each column's pod releases (ref.NEVER
    #: for a pod that runs on and for a padded slot)
    col_relb: np.ndarray
    #: [nchunks] f64 start time of each boundary (its first pod's arrival)
    tb: np.ndarray
    #: [nchunks] valid non-gang pods in the waves before each boundary: no
    #: more can wait in a scenario's retry buffer there
    nongang_before: np.ndarray

    @property
    def tbt(self) -> np.ndarray:
        """[B] f32 start times of the finite boundaries (the retry pass's
        release search, sim/whatif.py:2316)."""
        return self.tb[np.isfinite(self.tb)].astype(np.float32)

    @property
    def L(self) -> int:
        return self.idx.size + self.prebound.size

    @property
    def col_pod(self) -> np.ndarray:
        """[L] i32 pod of each choice-buffer column (PAD: a padded slot)."""
        return np.concatenate([self.idx.reshape(-1), self.prebound]).astype(np.int32)

    def page_idx(self) -> np.ndarray:
        """[num_waves, W] i32 the page-local row of each slot's pod (paged
        pod waves, :mod:`.pager`): slot s of chunk c names row ``s − c·C·W``
        of its page (PAD: an empty slot)."""
        CW = self.C * self.idx.shape[1]
        pos = np.arange(self.idx.size, dtype=np.int32).reshape(self.idx.shape)
        return np.where(self.idx >= 0, pos % CW, PAD).astype(np.int32)

    def device_desc(self, device, paged: bool = False) -> ChunkDesc:
        """The plan's :class:`ChunkDesc` on ``device`` (``paged``: each slot
        names its pod's page-local row)."""
        idx = self.page_idx() if paged else self.idx
        return ChunkDesc(
            idx=torch.as_tensor(idx.reshape(-1), device=device),
            gang=torch.as_tensor(self.gang_wave.astype(np.uint8), device=device),
        )


def plan_chunks(
    pods: EncodedPods, wave_idx: np.ndarray, C: int, completions_on: bool, has_gangs: bool
) -> ChunkPlan:
    """Pad the waves to whole chunks of C and bucket the completion
    releases (sim/whatif.py ``_stage_dev_rel``): a pod releases at
    ``b_rel = max(first boundary whose start time ≥ its release time,
    chunk_of + 2)`` — the one-chunk slack — where ``chunk_of`` is the
    chunk holding its slot (−2 for a pre-bound pod). Boundaries past the
    last finite one never release."""
    W = wave_idx.shape[1]
    C = min(int(C), max(wave_idx.shape[0], 1))
    pad_to = ((wave_idx.shape[0] + C - 1) // C) * C
    idx = wave_idx
    if pad_to != idx.shape[0]:
        idx = np.concatenate([idx, np.full((pad_to - idx.shape[0], W), PAD, np.int32)])
    idx = np.ascontiguousarray(idx, np.int32)
    gang_wave = (
        (np.where(idx >= 0, pods.group_id[np.clip(idx, 0, None)], PAD) >= 0).any(axis=1)
        if has_gangs
        else np.zeros(idx.shape[0], bool)
    )
    prebound = np.nonzero(pods.bound_node >= 0)[0]
    nchunks = idx.shape[0] // C
    buckets: List[Optional[Tuple[np.ndarray, np.ndarray]]] = [None] * nchunks
    col_relb = np.full(idx.size + prebound.size, ref.NEVER, np.int32)
    tb_all = wave_start_times(pods, idx)[0::C][:nchunks]
    nongang = ((idx >= 0) & (pods.group_id[np.clip(idx, 0, None)] < 0)).sum(axis=1)
    nongang_before = np.concatenate(([0], np.cumsum(nongang)))[0 : nchunks * C : C]
    if completions_on:
        P = pods.num_pods
        flat = idx.reshape(-1)
        vmask = flat >= 0
        Wtot = flat.size
        pos_of = np.full(P, -1, np.int64)
        pos_of[flat[vmask]] = np.nonzero(vmask)[0]
        chunk_of = np.full(P, 1 << 30, np.int64)
        chunk_of[flat[vmask]] = np.nonzero(vmask)[0] // (C * W)
        chunk_of[prebound] = -2
        pos_of[prebound] = Wtot + np.arange(prebound.size)
        rel_time = release_times(pods)
        nfin = int(np.isfinite(tb_all).sum())
        elig = np.searchsorted(tb_all[:nfin], rel_time, side="left").astype(np.int64)
        elig_ok = np.isfinite(rel_time) & (elig < nfin)
        b_rel = np.maximum(elig, chunk_of + 2)
        ok = elig_ok & (b_rel < nchunks) & (pos_of >= 0)
        pods_ok = np.nonzero(ok)[0]
        b_ok = b_rel[pods_ok]
        order = np.lexsort((pods_ok, b_ok))
        pods_s, b_s = pods_ok[order], b_ok[order]
        counts = np.bincount(b_s, minlength=nchunks)
        starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
        for b in np.nonzero(counts)[0]:
            seg = pods_s[starts[b] : starts[b] + counts[b]]
            buckets[b] = (seg.astype(np.int32), pos_of[seg].astype(np.int32))
        col_relb[pos_of[pods_ok]] = b_rel[pods_ok]
    return ChunkPlan(idx=idx, C=C, gang_wave=gang_wave, prebound=prebound, buckets=buckets,
                     col_relb=col_relb, tb=tb_all, nongang_before=nongang_before)


def new_choices(plan: ChunkPlan, S: int, bound_node: np.ndarray, device) -> torch.Tensor:
    """A fresh choice buffer ``[S, L]``: PAD in every slot column, each
    pre-bound pod's node in its tail column."""
    choices = torch.full((S, plan.L), PAD, dtype=torch.int32, device=device)
    if plan.prebound.size:
        choices[:, plan.idx.size :] = torch.as_tensor(
            bound_node[plan.prebound].astype(np.int32), device=device)
    return choices


def retry_slots(plan: ChunkPlan, b: int, RB: int) -> int:
    """Buffer slots the retry pass at boundary b runs: the host cannot
    see the buffer without waiting on the card, so every slot that may
    hold a pod — no more than the valid non-gang pods of the waves before
    b (none at b = 0), at most RB."""
    return min(RB, int(plan.nongang_before[b]))


@dataclass
class Series:
    """The device side of telemetry ``series``/``timeline`` in one run of S
    scenarios over the plan's B boundaries (kubernetes_simulator_tpu/sim/
    jax_runtime.py:2117-2160, :2343-2366; sim/boundary.py:360-398,
    :563-668). Nothing here synchronises: the samples are device-to-device
    copies, read after the run's one fetch.

    - ``attribute``: first-reject attribution into the Tables' ``reject``
      counters (K6's attributed mode, or K5; off under tier preemption and
      node shards, as the reference's);
    - ``fold``: the retry path's form of it — a chunk's failed slots
      charged after its last wave against ``snap``, the planes at its
      start, and each failed retry-pass attempt at its own state; without
      ``fold`` (the plain path) each slot is charged right after its K2;
    - ``used`` / ``rcount`` / ``pend``: ``used``, the buffer's length and
      the pending list after each boundary with a finite start time
      (releases and retry sequence done), for the host's series gauges."""

    attribute: bool
    fold: bool
    snap: Optional[ref.DevState]
    used: torch.Tensor  # [B, S, N, R] f32
    rcount: Optional[torch.Tensor] = None  # [B, S] i32
    pend: Optional[torch.Tensor] = None  # [B, S, RB] i32


def new_series(plan: ChunkPlan, tb: ref.Tables, attribute: bool) -> Series:
    """Zeroed series buffers for a run of ``plan`` over ``tb``."""
    B = len(plan.buckets)
    st, rt = tb.state, tb.retry
    fold = attribute and rt is not None
    return Series(
        attribute=attribute, fold=fold,
        snap=ref.DevState(*(torch.empty_like(x) for x in st)) if fold else None,
        used=torch.zeros((B,) + tuple(st.used.shape), dtype=torch.float32,
                         device=st.used.device),
        rcount=(torch.zeros((B,) + tuple(rt.rcount.shape), dtype=torch.int32,
                            device=st.used.device) if rt is not None else None),
        pend=(torch.full((B,) + tuple(rt.pend_id.shape), PAD, dtype=torch.int32,
                         device=st.used.device) if rt is not None else None),
    )


def joint_release(b: int, h, apply_placements, rt: ref.Retry, choices: torch.Tensor,
                  bucket: Optional[Tuple[torch.Tensor, torch.Tensor]]) -> None:
    """Boundary b's pending and static releases as ONE K3 release (the
    single replay's order, ``joint`` of :func:`run_waves`): each scenario's pairs are its
    pending list's due entries, then the static bucket's pods at their
    choices, and K3 sums each node's requests over them from zero in that
    order and subtracts once — as the single replay's boundary pass sums
    one delta (sim/boundary.py boundary_releases, models/state.py
    release_delta)."""
    ids, nodes, relb = rt.pend_id, rt.pend_node, rt.pend_relb
    if bucket is not None:
        S = ids.shape[0]
        bid, bpos = bucket
        ids = torch.cat([ids, bid.expand(S, -1)], dim=1)
        nodes = torch.cat([nodes, choices[:, bpos.long()]], dim=1)
        relb = torch.cat([relb, torch.full((S, bid.numel()), b, dtype=relb.dtype,
                                           device=relb.device)], dim=1)
    pos = torch.arange(ids.shape[1], dtype=torch.int32, device=ids.device)
    apply_placements(h, ids, pos, nodes, -1.0, due=(relb, b))


def run_retry_boundary(plan: ChunkPlan, b: int, h, fns, rt: ref.Retry,
                       pos_rb: torch.Tensor, reject=None, joint: bool = False) -> None:
    """Boundary b's retry sequence (after its static release): the K3
    release of the pending list's due entries (unless ``joint``, where
    :func:`joint_release` took them with the static bucket), the retry
    pass — K1 → K2 (→ K5 ``reject``, series telemetry) → K3 bind over each
    buffer slot that may hold a pod, one pod per scenario (a scenario whose
    slot is empty does nothing) — and K4."""
    filter_score, normalize_select, apply_placements, retry_boundary = fns[:4]
    RB = rt.rbuf.shape[1]
    if not joint:
        apply_placements(h, rt.pend_id, pos_rb, rt.pend_node, -1.0, due=(rt.pend_relb, b))
    for k in range(retry_slots(plan, b, RB)):
        pod_of_s = rt.rbuf[:, k]
        filter_score(h, PAD, pod_of_s)
        normalize_select(h, PAD, rt.rchoice, k, -1, pod_of_s)
        if reject is not None:
            reject(h, rt.rbuf[:, k : k + 1], rt.rchoice[:, k : k + 1])
        apply_placements(h, rt.rbuf[:, k : k + 1], pos_rb[k : k + 1], rt.rchoice, 1.0)
    retry_boundary(h, b, float(np.float32(plan.tb[b])))


def run_waves(plan: ChunkPlan, tb: ref.Tables, choices: torch.Tensor, first: int, end: int,
              plain: bool, ser: Optional[Series] = None, route: str = "slot",
              pager=None, joint: bool = False) -> None:
    """Enqueue waves ``[first, end)`` of ``plan`` over the S scenarios of
    ``tb`` (state and ``choices`` updated in place, no synchronisation):
    the release bucket of a boundary where a chunk starts, then (under the
    retry buffer, past boundary 0) the boundary's retry sequence
    (:func:`run_retry_boundary`; with ``joint``, the single replay's order,
    the boundary's pending and static releases go out as one,
    :func:`joint_release`), then the chunk's waves on ``route``: one
    K6 launch over the chunk's waves in the range (``"chunk"``, reading the
    plan's :class:`ChunkDesc`, uploaded once a call),
    or per slot K1 → K2 → K3 bind (which appends a failed non-gang pod to
    the buffer) and a K3 rollback after a wave holding a gang member
    (``"slot"``). ``plain`` runs the plain twins on any device; otherwise
    the kernel wrappers run (the kernels for CUDA tensors, the twins for
    CPU tensors).

    With ``ser`` (telemetry series, :class:`Series`; the replicated routes
    only) each boundary also copies its samples, and failures are
    attributed: on the plain path after each slot's K2 (inside K6, its
    attributed mode, on the chunk route; K5 on the per-slot route); on the
    retry path by K5 in each retry-pass slot and, for a chunk's failed
    slots, in one launch when the chunk is done (at the next boundary,
    before its releases, or at the run's end) against the chunk's start
    planes, copied at each boundary. The order is the reference's: chunk
    b−1's fold precedes boundary b's releases and retry pass
    (sim/jax_runtime.py:1716-1745).

    On node-sharded tables (row B13) a boundary's release is K8's, and the
    chunk's waves one K9 launch over the waves in the range (``"shard"``,
    reading the plan's :class:`ChunkDesc`) or per slot K1 (over the padded
    node axis) → K7 (the two-stage choice) → K8 bind, with K8's rollback
    after a gang wave (``"shard_slot"``).

    With ``pager`` (paged pod waves, :class:`.pager.PodPager`; ``first`` on
    a chunk's start) each chunk runs on its page: the pod tables of its
    slots and of its boundary's released pods, named by page-local ids,
    while the next chunk's page is staged."""
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    if route in SHARD_ROUTES and ser is not None:
        raise ValueError("telemetry series runs on the replicated routes: the reference "
                         "attributes nothing under node shards")
    if (route in SHARD_ROUTES) != (tb.shards is not None):
        raise ValueError("node-sharded tables take a shard route, and only they")
    if pager is not None and (ser is not None or tb.retry is not None or tb.preempt is not None
                              or first % plan.C):
        raise ValueError("paged pod waves run from a chunk's start, without series telemetry, "
                         "the retry buffer or tier preemption")
    dev = tb.state.used.device
    idx, C = plan.idx, plan.C
    W = idx.shape[1]
    if plain:
        fns = (ref.filter_score, ref.normalize_select, ref.apply_placements,
               ref.retry_boundary, ref.first_reject, ref.first_reject, ref.chunk_replay,
               ref.shard_select, ref.shard_apply, ref.shard_chunk_replay)
        bind = lambda t: t
    else:
        fns = (K.filter_score, K.normalize_select, K.apply_placements, K.retry_boundary,
               K.first_reject, K.first_reject_fold, K.chunk_replay, K.shard_select,
               K.shard_apply, K.shard_chunk_replay)
        bind = K.Bound
    h = bind(tb)
    filter_score, normalize_select, apply_placements = fns[:3]
    chunk_replay, shard_select, shard_apply, shard_chunk_replay = fns[6:10]
    release = shard_apply if route in SHARD_ROUTES else apply_placements
    rt = tb.retry
    if rt is not None:
        pos_rb = torch.arange(rt.rbuf.shape[1], dtype=torch.int32, device=dev)
    desc = plan.device_desc(dev, paged=pager is not None)
    idx_dev = desc.idx
    if pager is not None:
        idx = plan.page_idx()
        bound_of_slot = {}
    # Every release bucket of the range is staged before the first launch.
    buckets = {
        w // C: tuple(torch.as_tensor(a, device=dev) for a in plan.buckets[w // C])
        for w in range(first, end) if w % C == 0 and plan.buckets[w // C] is not None
    }
    page = None

    def chunk_start(b: int) -> None:
        """Paged: the current page is done, chunk b's page becomes the tables'
        pod tables (its bucket's ids page-local), the next one is staged."""
        nonlocal h, page
        if page is not None:
            pager.done(page)
        page = pager.get(b)
        if page.slot not in bound_of_slot:
            bound_of_slot[page.slot] = bind(tb._replace(pods=page.pods))
        h = bound_of_slot[page.slot]
        if b in buckets:
            buckets[b] = (page.rel_ids, buckets[b][1])
        if (b + 1) * C < min(end, idx.shape[0]):
            pager.prefetch(b + 1)
    preempt = tb.preempt is not None
    append = rt is not None
    reject = fns[4] if ser is not None and ser.attribute else None
    slot_reject = reject if ser is not None and not ser.fold else None
    # K6's attributed mode: the plain path's counters
    k6_reject = tb.reject if slot_reject is not None else None
    fold_reject = fns[5]
    CW = C * W
    if ser is not None and ser.fold:
        snap_tb = tb._replace(state=ser.snap)
        h_snap = snap_tb if plain else K.Bound(snap_tb)

    def fold(c: int) -> None:
        cols = slice(c * CW, (c + 1) * CW)
        fold_reject(h_snap, idx_dev[cols], choices[:, cols])

    def boundary_work(b: int) -> None:
        if pager is not None:
            chunk_start(b)
        if ser is not None and ser.fold and b > 0:
            fold(b - 1)
        if rt is not None and joint and b > 0:
            joint_release(b, h, apply_placements, rt, choices, buckets.get(b))
        elif b in buckets:
            release(h, buckets[b][0], buckets[b][1], choices, -1.0)
        if rt is not None and b > 0:
            run_retry_boundary(plan, b, h, fns, rt, pos_rb, reject, joint)
        if ser is not None:
            if np.isfinite(plan.tb[b]):
                ser.used[b].copy_(tb.state.used)
                if rt is not None:
                    ser.rcount[b].copy_(rt.rcount)
                    ser.pend[b].copy_(rt.pend_id)
            if ser.fold:
                for dst, src in zip(ser.snap, tb.state):
                    dst.copy_(src)

    if route in ("chunk", "shard"):
        w = first
        while w < end:
            b = w // C
            if w % C == 0:
                boundary_work(b)
            hi = min(end, (b + 1) * C)
            if route == "shard":
                shard_chunk_replay(h, desc.idx, desc.gang, choices, w, hi)
            else:
                chunk_replay(h, desc.idx, desc.gang, choices, w, hi,
                             boundary=b if preempt else None, append=append, reject=k6_reject)
            w = hi
    else:
        rows = idx.tolist()
        gang_wave = plan.gang_wave.tolist()
        pos_dev = torch.arange(plan.L, dtype=torch.int32, device=dev)
        shard = route == "shard_slot"
        for w in range(first, end):
            b = w // C
            if w % C == 0:
                boundary_work(b)
            base = w * W
            for k, p in enumerate(rows[w]):
                if p < 0:
                    continue
                s = base + k
                filter_score(h, p)
                if shard:
                    shard_select(h, p, choices, s)
                    shard_apply(h, idx_dev[s : s + 1], pos_dev[s : s + 1], choices, 1.0)
                    continue
                normalize_select(h, p, choices, s, w)
                if slot_reject is not None:
                    slot_reject(h, idx_dev[s : s + 1], choices[:, s : s + 1])
                apply_placements(h, idx_dev[s : s + 1], pos_dev[s : s + 1], choices, 1.0,
                                 boundary=b if preempt else None, append=append)
            if gang_wave[w]:
                rb = (idx_dev[base : base + W], pos_dev[base : base + W], choices, -1.0)
                if shard:
                    shard_apply(h, *rb, rollback=True)
                else:
                    apply_placements(h, *rb, rollback=True)
    if ser is not None and ser.fold and end == idx.shape[0] and end > first:
        fold((end - 1) // C)
    if page is not None:
        pager.done(page)


def run_chunks(
    plan: ChunkPlan, tb: ref.Tables, bound_node: np.ndarray, plain: bool, timers=None,
    ser: Optional[Series] = None, route: Optional[str] = None, pager=None, joint: bool = False,
) -> np.ndarray:
    """Replay every chunk of ``plan`` over the S scenarios of ``tb`` (its
    state is updated in place) on ``route`` (None: :func:`choose_route`
    of ``plain`` and the tables' shards), with ``pager``'s pages
    when given (``joint``: as :func:`run_waves`), and return the host copy
    of the choice buffer ``[S, L]``.
    The one synchronisation is the final fetch."""
    tick = timers.tick if timers is not None else (lambda name: contextlib.nullcontext())
    route = route or choose_route(plain, tb.shards is not None)
    choices = new_choices(plan, tb.state.used.shape[0], bound_node, tb.state.used.device)
    with tick("dispatch"), tick(f"dispatch_{route}"):
        run_waves(plan, tb, choices, 0, plan.idx.shape[0], plain, ser, route, pager, joint)
    with tick("device_wait"):
        return choices.cpu().numpy()


def assignments_from_choices(
    plan: ChunkPlan, host_choices: np.ndarray, bound_node: np.ndarray,
    rnode: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """(assignments [S, P], placed [S], pods to schedule) from a fetched
    choice buffer: every wave pod takes its slot's choice and every
    pre-bound pod its tail column's (PAD = unplaced, rolled back or
    evicted); under the retry buffer a pod placed on retry (``rnode``
    [S, P], its slot PAD) takes its retried node and counts once."""
    flat_idx = plan.idx.reshape(-1)
    valid = flat_idx >= 0
    slot = host_choices[:, : flat_idx.size][:, valid]
    S = host_choices.shape[0]
    assignments = np.full((S, bound_node.shape[0]), PAD, np.int32)
    assignments[:, plan.prebound] = host_choices[:, flat_idx.size :]
    assignments[:, flat_idx[valid]] = slot
    placed = (slot >= 0).sum(axis=1).astype(np.int32)
    if rnode is not None:
        retried = rnode >= 0
        assignments[retried] = rnode[retried]
        placed += retried.sum(axis=1).astype(np.int32)
    return assignments, placed, int(valid.sum())


class ChunkEngine:
    """The setup and the run that the single replay and the what-if batch
    share: wave packing, the completions gate (on when the trace has finite
    durations, unless ``completions=False``), the granularity guard, the
    static chunk plan, the tables of S scenarios on the device (with the
    tier-preemption tables when ``preemption`` is on, the retry tables
    when ``retry_buffer`` is, and the policy rows ``wrow`` every run's
    tables share) and one pass of :func:`run_chunks`. ``setups`` counts
    the set-ups; a value swap of the policy rows adds none.

    The buffer the guard recommends (grown to cover one chunk's failures
    when it shrinks the chunks) is rounded up to a multiple of the wave
    width, as the reference rounds it in both engines (sim/whatif.py:1078
    and, for the single replay, sim/boundary.py ``BoundaryOps``)."""

    def _prepare(
        self, ec: EncodedCluster, pods: EncodedPods, spec: StepSpec, cluster: ref.DevCluster,
        S: int, wave_width, chunk_waves: int, completions: Optional[bool],
        granularity_guard: bool, engine_name: str, device: torch.device, plain: bool,
        preemption: bool = False, retry_buffer: int = 0, domains=None,
        wrow: Optional[torch.Tensor] = None, layout=None, paged: bool = False,
    ) -> None:
        #: set-ups of this engine (plan and device tables): a value swap
        #: (``WhatIfEngine.set_policies``) must not add one
        self.setups = getattr(self, "setups", 0) + 1
        self.ec, self.pods, self.spec, self.S, self.device = ec, pods, spec, S, device
        #: [S, len(POLICY_COLS)] f32 policy rows on the device, or None
        self._wrow = wrow
        #: (node_domain [L, T, N], num_domains [L, T], lrow [S], D) of the
        #: label rows of a batch whose scenarios relabel nodes, else None
        self._domains = domains
        #: the node-shard layout (:mod:`..parallel.shards`), None replicated;
        #: the device tables then span its padded node axis (``_dev_ec``)
        self.layout = layout
        self._dev_ec = shard_cluster(ec, layout) if layout is not None else ec
        #: paged pod waves (:mod:`.pager`): no whole-trace pod tables on the
        #: device
        self.paged = bool(paged)
        #: (tiers, pod_tier) under tier preemption, else None
        self.tiers = (check_tier_mode(ec, pods, spec.interpod, spec.spread)
                      if preemption else None)
        self.consts = spec.consts(traced=wrow is not None)
        self.plain = bool(plain)
        self.wave_width = 8 if wave_width == "auto" else int(wave_width)
        if self.wave_width > 1024:
            raise ValueError("wave_width must be <= 1024 (one rollback block)")
        #: host seconds of the set-up's parts (wave packing, the chunk plan
        #: with its granularity guard, the pod tables' upload)
        self.setup_s = {}
        t0 = time.perf_counter()
        self.waves = pack_waves(pods, self.wave_width,
                                page_pods=int(chunk_waves) * self.wave_width if paged else None)
        t1 = time.perf_counter()
        self.completions_on = completions_gate(pods, completions)
        self.chunk_waves = int(chunk_waves)
        rb = int(retry_buffer)
        if self.completions_on:
            from .granularity import guard

            self.chunk_waves, rb = guard(
                pods, self.waves.idx, self.chunk_waves, rb,
                enabled=granularity_guard, engine_name=engine_name,
            )
        #: effective retry buffer slots per scenario (0: off)
        self.retry_buffer = -(-rb // self.wave_width) * self.wave_width
        #: chunk layout and release buckets, static per engine
        self.plan = plan_chunks(pods, self.waves.idx, self.chunk_waves, self.completions_on,
                                spec.has_gangs)
        t2 = time.perf_counter()
        self._cluster = cluster
        self._pods = None if self.paged else ref.pods_to(pods, device)
        self.setup_s = dict(pack_waves=t1 - t0, plan_chunks=t2 - t1,
                            pod_tables=time.perf_counter() - t2)

    def _initial_planes(self) -> Tuple[np.ndarray, ...]:
        """Host (used, match_count, anti_active, pref_wsum) every scenario
        starts from: the pre-bound pods bound with the scenario's own
        topology domains — one state, or an ``[S, ...]`` stack where the
        label rows differ and pods are pre-bound."""
        fields = ("used", "match_count", "anti_active", "pref_wsum")
        if self._domains is None:
            st = init_state(self._dev_ec, self.pods)
            return tuple(getattr(st, f) for f in fields)
        nd, ndom, lrow, D = self._domains
        row_ec = lambda r: dc_replace(self.ec, node_domain=nd[r], num_domains=ndom[r],
                                      max_domains=D)
        if not bool((self.pods.bound_node >= 0).any()):
            st = init_state(row_ec(0), self.pods)
            return tuple(getattr(st, f) for f in fields)
        rows = [init_state(row_ec(r), self.pods) for r in range(nd.shape[0])]
        return tuple(np.stack([getattr(rows[r], f) for r in lrow]) for f in fields)

    def _tables(self, attribute: bool = False, pods: Optional[ref.DevPods] = None) -> ref.Tables:
        """The tables of one run; ``attribute`` adds zeroed first-reject
        counters (telemetry series). ``pods``: the pod tables (a pager's
        page); by default the whole trace's, uploaded once."""
        if pods is None:
            if self._pods is None:
                self._pods = ref.pods_to(self.pods, self.device)
            pods = self._pods
        pre = None
        if self.tiers is not None:
            tiers, pod_tier = self.tiers
            ut, nt = tier_planes(self.pods, pod_tier, len(tiers), self.ec.num_nodes,
                                 self.ec.num_resources)
            pre = ref.new_preempt(pod_tier, self.pods.group_id, self.plan.col_pod,
                                  self.plan.col_relb, self.plan.idx.size, ut, nt, self.S,
                                  self.device)
        rt = None
        if self.retry_buffer:
            rt = ref.new_retry(self.retry_buffer, self.pods.duration, self.plan.tbt, self.S,
                               self.device)
        sh = None
        if self.layout is not None:
            lay, plan = self.layout, self.plan
            gdom = ref.group_domains(self._dev_ec)[0]  # [G, n_pad]
            tail = self.pods.bound_node[plan.prebound]
            sh = ref.new_shards(lay.P, lay.n_local, lay.n_real, self.S, plan.L, gdom.shape[0],
                                self.device, tail_dom=gdom[:, tail].T)
        return ref.Tables(
            cluster=self._cluster, pods=pods,
            state=ref.stacked_state(*self._initial_planes(), self.S, self.device),
            scratch=ref.new_scratch(self.S, self._dev_ec.num_nodes, self.device),
            consts=self.consts, preempt=pre, retry=rt,
            reject=(ref.new_reject(len(spec_plugin_names(self.spec)), self.pods.num_pods, self.S,
                                   self.device) if attribute else None),
            wrow=self._wrow, shards=sh,
        )

    def _pager(self):
        """A fresh pager of this engine's plan (paged pod waves), or None."""
        if not self.paged:
            return None
        from .pager import PodPager

        return PodPager(self.pods, self.plan.idx, self.plan.C, self.plan.buckets, self.device)

    def _run(self, timers=None, series: bool = False, route: Optional[str] = None,
             joint: bool = False):
        """(tables after the run, wall seconds, assignments [S, P], placed
        [S], pods to schedule). ``series`` (the reference's ``use_rej``)
        takes the boundary samples and the first-reject attribution
        (:class:`Series`; none when no Filter plugin is on). ``route`` (one
        of :data:`ROUTES`) overrides the route the mode chooses
        (:func:`choose_route`), so a kernel run can be held against the
        other route. ``joint``: a retry boundary's pending
        and static releases go out as one (:func:`run_waves`; the single
        replay's order). The tables are kept as
        ``last_tables``, the fetched choice buffer as ``last_choices``, the
        series buffers as ``last_series`` and the route as ``last_route``."""
        attribute = series and bool(spec_plugin_names(self.spec))
        # Paged pod waves stream the pods of a chunk's waves; the attributed
        # run keeps the resident tables, as the reference's attributed program
        # (sim/jax_runtime.py:2253 ``if self.paged and not use_rej``).
        pager = self._pager() if not series else None
        self.last_pager = pager
        tb = self._tables(attribute, pods=pager.pods0 if pager is not None else None)
        self.last_tables = tb
        ser = new_series(self.plan, tb, attribute) if series else None
        self.last_series = ser
        self.last_route = route or choose_route(self.plain, self.layout is not None)
        t0 = time.perf_counter()
        try:
            host_choices = run_chunks(self.plan, tb, self.pods.bound_node, self.plain, timers,
                                      ser, self.last_route, pager, joint)
        finally:
            if pager is not None:
                pager.close()
        wall = time.perf_counter() - t0
        self.last_choices = host_choices
        rnode = tb.retry.rnode.cpu().numpy() if tb.retry is not None else None
        return (tb, wall) + assignments_from_choices(self.plan, host_choices,
                                                     self.pods.bound_node, rnode)


class TorchReplayEngine(ChunkEngine):
    """Single-scenario replay of an encoded trace on one device: the S = 1
    case of the chunk loop (:func:`run_chunks`).

    ``device`` defaults to ``"cuda"`` (the kernels); ``device="cpu"`` runs
    the kernels' plain twins. ``plain=True`` runs the twins on any device
    (a reference run for holding the kernel path against; the wrappers
    never fall back on their own). ``completions`` (None = on when the
    trace has finite durations), ``retry_buffer`` and
    ``granularity_guard`` behave as in ``JaxReplayEngine``; the retry
    pass runs on the chunk grid also when no pod has a duration (nothing
    then releases).

    ``engine`` is "v3" or "v2" (the reference's node-space chain, row B8):
    both run on K1–K3, which commit pod by pod as v2 and greedy_replay do,
    so the two place alike; tier preemption needs "v3", as the
    reference's.

    ``node_shards`` (> 1: row B13 on the shard route, every shard on this
    engine's device; forces ``engine="v2"`` with the reference's log line)
    and ``paged`` (paged pod waves, :mod:`.pager`) behave as in
    ``JaxReplayEngine``, whose refusals they keep (tier preemption with
    shards, ``paged`` with the retry buffer, the
    ``KSIM_MAX_REPLICATED_BYTES`` budget of a replicated run); the retry
    buffer under shards, and ``paged`` with tier preemption, are refused by
    name. At ``series``/``timeline`` a paged replay runs on the resident pod
    tables, as the reference's attributed program does; under node shards
    it attributes nothing and samples no series, as the reference's
    (sim/jax_runtime.py:2137-2144), and runs the shard route (with the
    pager when ``paged``).

    ``telemetry`` is "off", "summary", "series" or "timeline" (a name or
    a :class:`..sim.telemetry.TelemetryConfig`). ``series`` adds the
    first-reject attribution (K6's attributed mode on the plain path, K5 on
    the retry path) and the boundary-sampled series, ``timeline`` the bind
    events (kubernetes_simulator_tpu/sim/jax_runtime.py:2117-2160,
    sim/boundary.py:360-398, :563-668); under tier preemption and node
    shards attribution is off, as the reference's. Every other mode of the
    JAX engine raises ``NotImplementedError`` naming it."""

    def __init__(
        self,
        ec: EncodedCluster,
        pods: EncodedPods,
        config: Optional[FrameworkConfig] = None,
        wave_width: int = 8,
        chunk_waves: int = 2048,
        device="cuda",
        engine: str = "v3",
        preemption=False,
        completions: Optional[bool] = None,
        retry_buffer: int = 0,
        granularity_guard: bool = True,
        telemetry=None,
        node_shards: int = 0,
        paged: bool = False,
        flight_recorder=None,
        plain: bool = False,
    ):
        if engine not in ("v2", "v3"):
            raise ValueError(f"engine must be 'v2' or 'v3', got {engine!r}")
        rb = check_retry_buffer(retry_buffer)
        mode = tier_preemption(preemption, engine, rb, node_shards)
        if rb and completions is False:
            raise ValueError(
                "completions=False is not supported with retry_buffer/kube preemption (the "
                "boundary pass owns releases)"
            )
        #: node-plane shards (0/1: the replicated layout)
        self.node_shards = int(node_shards or 0)
        if self.node_shards < 0:
            raise ValueError(f"node_shards must be >= 0, got {node_shards}")
        if paged and rb:
            raise ValueError(
                "paged=True is not supported with retry_buffer / preemption='kube' yet — the "
                "boundary mirror pre-stages the whole wave index tensor; run paged replays on "
                "the plain path"
            )
        if paged and mode:
            raise _later("paged=True with tier preemption (the eviction walk reads the pod "
                         "tables by global pod id)", "ROADMAP queue A item 6a")
        if flight_recorder is not None:
            raise _later("flight_recorder", "the flight recorder, ROADMAP queue A item 6f")
        self.telemetry = resolve_granularity(telemetry)
        layout = None
        if self.node_shards > 1:
            if rb:
                raise _later("retry_buffer with node_shards (the boundary retry pass over "
                             "node shards)", "ROADMAP queue A item 6a")
            if engine == "v3":
                log.info(
                    "node_shards=%d: forcing engine='v2' — the node-sharded chunk program runs "
                    "on the node-space planes (the v3 domain-space layout replicates exactly "
                    "the per-domain state node sharding is meant to split)", self.node_shards)
                engine = "v2"
        check_replicated_budget(ec, pods, self.node_shards, engine, paged)
        self.engine = engine
        device = resolve_device(device)
        if self.node_shards > 1:
            layout = make_layout(ec.num_nodes, self.node_shards, device)
        self.preemption = mode
        self._prepare(ec, pods, StepSpec.from_config(ec, config, pods),
                      ref.cluster_to(shard_cluster(ec, layout) if layout else ec, device), 1,
                      wave_width, chunk_waves, completions, granularity_guard,
                      "torch replay engine", device, plain, mode, rb, layout=layout,
                      paged=paged)

    # -- one replay --------------------------------------------------------

    def replay(
        self,
        checkpoint_path: Optional[str] = None,
        checkpoint_every: int = 0,
        resume: bool = False,
        node_events=None,
    ) -> ReplayResult:
        if self.preemption and (checkpoint_path or resume):
            raise ValueError(
                "checkpoint/resume is not supported with device preemption (tier planes are "
                "not checkpointed)"
            )
        if checkpoint_path or checkpoint_every or resume:
            raise _later("checkpoint/resume", "engine modes, queue A item 6")
        if node_events:
            raise _later("node_events", "chaos node events, queue A item 6")
        ep = self.pods
        tcfg = TelemetryConfig.resolve(self.telemetry)
        tel = TelemetryCollector(tcfg) if tcfg.enabled else None
        # The reference's use_rej (sim/jax_runtime.py:2117-2144): series and
        # timeline attribute rejections and sample the series, except under
        # tier preemption and node shards.
        use_rej = tcfg.want_series
        if use_rej and self.preemption:
            log.info(
                "telemetry: rejection attribution is not available with in-scan tier "
                "preemption (the attributed chain carries no tier planes) — latency/phase "
                "telemetry still collected"
            )
            use_rej = False
        if use_rej and self.node_shards > 1:
            log.info(
                "telemetry: rejection attribution is disabled under node sharding (the "
                "instrumented reference program carries replicated node planes) — "
                "latency/phase telemetry still collected"
            )
            use_rej = False
        if use_rej and not self.retry_buffer and self.engine == "v3":
            log.info(
                "telemetry series: the plain v3 replay attributes rejections in-scan as the "
                "reference (v2) chunk program does — inside K6 (its attributed mode) on the "
                "pod-by-pod K1–K3 chain, one launch a chunk; placements are bit-identical"
            )
        tb, wall, assignments, placed_s, to_schedule = self._run(
            tel.phases if tel is not None else None, series=use_rej, joint=True)
        assignments = assignments[0]
        placed = int(placed_s[0])

        st = tb.state
        used = st.used[0, : self.ec.num_nodes].cpu().numpy()
        host_state = SchedState(
            used=used,
            match_count=st.match_count[0].cpu().numpy(),
            anti_active=st.anti_active[0].cpu().numpy(),
            pref_wsum=st.pref_wsum[0].cpu().numpy(),
            bound=assignments.copy(),
        )
        util = utilization_means(used, self.ec.allocatable, self.ec.vocab._r)
        pending_m = (ep.bound_node == PAD) & (assignments == PAD)
        frag = fragmentation_gauges(
            self.ec.allocatable, used, ep.requests[pending_m], self.ec.vocab._r
        )
        if tel is not None:
            self._collect(tel, tb, placed)
        return ReplayResult(
            assignments=assignments,
            placed=placed,
            unschedulable=to_schedule - placed,
            preemptions=int(tb.preempt.victims[0]) if tb.preempt is not None else 0,
            retry_dropped=int(tb.retry.rdrop[0]) if tb.retry is not None else 0,
            attempts=to_schedule,
            wall_clock_s=wall,
            placements_per_sec=placed / wall if wall > 0 else 0.0,
            virtual_makespan=float(ep.arrival.max()) if ep.num_pods else 0.0,
            utilization=util,
            state=host_state,
            fragmentation=frag,
            telemetry=tel.result() if tel is not None else None,
            route=self.last_route,
        )

    def _collect(self, tel: TelemetryCollector, tb: ref.Tables, placed: int) -> None:
        """Fill ``tel`` from the fetched run (host work, no device step):
        first-bind latencies, K5's counters, the series gauges (the
        reference's f64 ``series_gauges`` of each boundary's copied
        ``used``) and, at ``timeline``, the bind events in the reference's
        fold order: per chunk c, boundary c's retried binds (at its start
        time, buffer order, which is slot order) and then chunk c's
        wave-placed pods (at their arrival, slot order)."""
        plan, ep, rt = self.plan, self.pods, tb.retry
        order = np.zeros(0, np.int64)
        if rt is not None:
            rnode = rt.rnode[0].cpu().numpy()
            rbind_b = rt.rbind_b[0].cpu().numpy()
            flat = plan.idx.reshape(-1)
            pos_of = np.full(ep.num_pods, -1, np.int64)
            pos_of[flat[flat >= 0]] = np.nonzero(flat >= 0)[0]
            retried = np.nonzero(rnode >= 0)[0]
            order = retried[np.lexsort((pos_of[retried], rbind_b[retried]))]
            later = 0
            for p in order.tolist():
                lat = float(plan.tb[rbind_b[p]]) - float(ep.arrival[p])
                if lat > 0.0:
                    tel.bind_latency(p, lat)
                    later += 1
            tel.bind_zero(placed - later)
        else:
            tel.bind_zero(placed)
        if tb.reject is not None:
            tel.rejection_totals(spec_plugin_names(self.spec),
                                 tb.reject.reasons[0].cpu().numpy(),
                                 tb.reject.attempts[0].cpu().numpy())
        ser = self.last_series
        if ser is not None:
            used = ser.used[:, 0].cpu().numpy()
            rcount = ser.rcount[:, 0].cpu().numpy() if ser.rcount is not None else None
            pend = (ser.pend[:, 0] >= 0).sum(dim=1).cpu().numpy() if ser.pend is not None else None
            for b in range(len(plan.buckets)):
                if not np.isfinite(plan.tb[b]):
                    continue
                depths = ({} if rcount is None
                          else dict(retry_depth=int(rcount[b]), pend_depth=int(pend[b])))
                tel.sample(float(plan.tb[b]), **depths,
                           **series_gauges(used[b], self.ec.allocatable, self.ec.vocab._r))
        if tel.cfg.want_timeline and rt is not None:
            ch = self.last_choices[0, : plan.idx.size]
            flat = plan.idx.reshape(-1)
            CW = plan.C * plan.idx.shape[1]
            bnd = rbind_b[order]
            for c in range(len(plan.buckets)):
                for p in order[bnd == c].tolist():
                    tel.event("bind", float(plan.tb[c]), p, int(rnode[p]))
                pods, nodes = flat[c * CW : (c + 1) * CW], ch[c * CW : (c + 1) * CW]
                m = (pods >= 0) & (nodes >= 0)
                for p, n in zip(pods[m].tolist(), nodes[m].tolist()):
                    tel.event("bind", float(ep.arrival[p]), p, n)


@register_strategy("torch")
def _make_torch(ec: EncodedCluster, pods: EncodedPods, config: Optional[FrameworkConfig] = None, **kw):
    return TorchReplayEngine(ec, pods, config, **kw)
