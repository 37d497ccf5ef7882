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
  chunk (``make_chunk_fn3_src``). Under the retry buffer each K6 launch
  that starts a chunk past the first runs in its retry mode: the
  boundary's pending release, retry pass and bookkeeping, then the waves
  (the reference's one retry chunk program a chunk, sim/whatif.py:1413
  ``per_scenario_retry``). Telemetry ``series``/``timeline`` takes it too:
  on the plain path K6's attributed mode charges each failed slot as K5
  would, before its bind (the reference's ``make_chunk_fn_rej``, one
  dispatch a chunk); on the retry path K6's retry mode charges each failed
  retry-pass slot and copies the boundary's samples, and K5 folds each
  chunk between K6 launches;
- ``"slot"``: per slot the host enqueues K1 (filter_score) → K2
  (normalize_select) → (K5 at series on the plain path) → K3
  (apply_placements, bind) and a K3 rollback after a wave holding gang
  members, and under the retry buffer the boundary's sequence
  (:func:`run_retry_boundary`). The plain twins (``plain=True``) take it,
  and ``_run(route="slot")`` holds the chunk route against it;
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
previous chunk runs (on the pager's worker thread, or the calling thread:
``pager_thread``). The single replay's flight recorder (:mod:`.flight`)
takes a row after each chunk's launches are enqueued, from host clocks and
counters only.

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
after the static release, the due entries of the pending list are
released, the retry pass places each scenario's buffered pods in order
(K1's, K2's and K3's bodies, one pod per scenario), and K4's bookkeeping
records the retried binds, schedules their releases on the pending list
and compacts the buffer — inside the chunk's K6 launch on the chunk route
(K6's retry mode, reading each scenario's buffer count on the card), as
host launches on the per-slot route (K3's release, K1 → K2 → K3 over
every slot that may hold a pod, K4 retry_boundary). A retried pod's slot
column keeps PAD, so its static bucket never releases it; its node comes
back in ``Retry.rnode``.

Kube preemption (``preemption="kube"``, with ``retry_buffer > 0``; the
reference's host boundary pass, sim/boundary.py:547-678 with kube=True,
run against the plain chunk program in both of its engines,
sim/jax_runtime.py:1544-1605 and sim/whatif.py:2830-2883) runs on the card
in both engines, on the chunk route only: each retry-mode K6 launch runs the
kube pass — the retry pass until its queue is empty, the PostFilter
(``ksim_post_filter``; twin :func:`..ops.reference.post_filter`) for a pod
no node admits, its victims rewound in full, their pending releases
cancelled and their choice-buffer columns or retried nodes cleared (no
release fires for them), requeued in the same pass or dropped, the pending
appends at bind time — and after the last chunk one more retry-mode launch
with no waves is the trailing boundary at ``t = inf`` (every pending entry
due there; no static release, no new pending entry). The per-slot route
refuses kube (its pass would need a host sync a slot), and so do node
shards and paged waves (the reference's refusal). The
summary latency counts first binds only (``Retry.first_b``), victims that
end unplaced included; ``ReplayResult.preemptions`` and ``retry_dropped``
come from the card.

Chaos node events (``replay(node_events=...)``, the what-if's
``Scenario.events``; the reference's schedule, sim/jax_runtime.py:1716-1803,
:2299-2310 and sim/whatif.py:3266-3330) fire at the first boundary whose f64
start time is at or after the event's, chunk 0 included, never at the
trailing one. Each boundary's work is staged on the device before the loop
(:func:`chaos_steps`) and runs first at its boundary, before the releases:
the allocatable rows it rewrites (``node_down`` 0, ``node_up`` the
scenario's t = 0 row, ``capacity_scale`` that row times its factor; an
``index_copy_``, no host sync) and, under the retry buffer or kube, K10
(``evict_node``) over the scenarios with a ``node_down`` there — the down
nodes' pods evicted NoExecute and requeued — then K3's releases and the
retry-mode K6, whose pass re-binds the victims (at boundary 0 too, where
K10 evicted pre-bound pods). The plain path rewrites rows only, as the
reference's. The run restores the allocatable after the loop. Refused by
name: events under node shards or paged waves and on the per-slot route
under the retry buffer (queue A item 6b).

Checkpoint/resume of the single replay (``replay(checkpoint_path=,
checkpoint_every=, resume=)``; the reference's :1382-1401, :1614-1640,
:1853-1876, :2165-2232 and :2402-2416, its file format
:mod:`.checkpoint`): the chunk loop runs in ranges cut at the cadence and
saves between two launches, after chunk ci and before boundary ci + 1's
work (:class:`Checkpointing`), with one host sync a save. The plain path
(v3 and v2, completions, pre-bound pods, node shards and paged waves) saves
the planes in host layout (a sharded ``used`` sliced to the real nodes),
each run chunk's choices in the reference's ``[C, W]`` layout and the
released mask; a resume seeds the planes, the choice buffer and, under node
shards, the restored columns' domain ids, and starts the loop at the
cursor (the pager at the cursor's page). Its release buckets are static,
so the file's mask must be the one they imply (the reference's re-pended
last fold is their one-chunk slack). Under the retry buffer, kube and chaos
the port keeps no host mirror: the boundary blob is derived from the
device retry tables (a pod's node from its column, ``rnode`` and ``rrel``,
which a checkpointing run keeps also without kube or chaos; the queue, the
pending list and the counters as they stand) and a resume rebuilds those
tables from it, re-applies the allocatable rows of the events before the
cursor without evicting again and keeps the reference's guards (a mode,
buffer, chunk grid or timeline of another run is refused). Tier preemption
keeps the reference's refusal. Under checkpoints series attribution is off
with the reference's log line; latency and phases are still collected.

Telemetry ``series`` / ``timeline`` under kube and under chaos (the
reference's host pass and mirror, sim/boundary.py:360-398, :430-475,
:547-678) runs on the card too: the kube pass counts a pod no node admits
as K5 counts it before the PostFilter and charges it only when the
PostFilter finds no node, clears the episode marks of its victims and of
the pods it binds, and copies the boundary's samples after the pass; K10
clears its victims' marks; the K5 fold of chunk c runs before boundary c +
1's allocatable rows are rewritten, and the last chunk's before the
trailing boundary. At ``timeline`` K10 and the retry pass append their
``evict`` / ``preempt`` / ``bind`` records to a per-scenario event log
(:class:`..ops.reference.EventLog`, :func:`log_capacity`) that the host
reads once after the run, so the events keep the binds that a later
preemption or eviction undid (:meth:`ChunkEngine._collect`).
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, replace as dc_replace
from typing import Callable, List, NamedTuple, Optional, Tuple

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
from .runtime import ReplayResult, validate_node_events
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
                    node_shards: int = 0) -> Optional[str]:
    """The preemption mode: ``"tier"`` (``True`` / ``"tier"``), ``"kube"``
    (the PostFilter through the retry buffer's boundary pass) or None (off),
    with the reference's errors for the modes each excludes
    (sim/jax_runtime.py:1039-1049): kube needs ``retry_buffer > 0``."""
    mode = normalize_preemption(preemption)
    if mode == "kube" and not retry_buffer:
        raise ValueError(
            "preemption='kube' requires retry_buffer > 0 (failed pods reach the PostFilter "
            "through the boundary retry pass)"
        )
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
    return mode


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


def choose_route(plain: bool, sharded: bool = False, kube: bool = False) -> str:
    """The route of a run, from its mode: node-sharded tables take the shard
    route (one K9 a chunk), or with ``plain`` the per-slot shard route (the
    twins of K1 → K7 → K8 a slot); kube preemption the chunk route (K6, or
    its twin with ``plain``: the per-slot route refuses kube, whose pass
    grows by its victims on the card); otherwise the per-slot route for the
    plain twins and the chunk route (K6) for everything else —
    ``engine="v2"`` (K1–K3 commit pod by pod, so v2 places as v3 on either
    route) and telemetry series/timeline (K6's attributed mode) included."""
    if sharded:
        return "shard_slot" if plain else "shard"
    return "slot" if plain and not kube else "chunk"


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
    one column per pre-bound pod, whose node every scenario shares (in a
    what-if fork, also one per pod of the waves before the fork point, with
    the source replay's choice: :func:`fork_tail`).
    ``buckets[b]`` holds the pods that release at boundary b (the start of
    chunk b) and their choice-buffer columns, in pod order; None where
    nothing releases."""

    idx: np.ndarray  # [num_waves, W] i32, padded to a multiple of C
    C: int
    gang_wave: np.ndarray  # [num_waves] bool: the wave holds a gang member
    prebound: np.ndarray  # the tail's pods (pre-bound, then a fork's prefix), in tail order
    buckets: List[Optional[Tuple[np.ndarray, np.ndarray]]]
    #: [L] i32 boundary at which each column's pod releases (ref.NEVER
    #: for a pod that runs on and for a padded slot)
    col_relb: np.ndarray
    #: [nchunks] f64 start time of each boundary (its first pod's arrival)
    tb: np.ndarray
    #: [nchunks] valid non-gang pods in the waves before each boundary: no
    #: more can wait in a scenario's retry buffer there
    nongang_before: np.ndarray
    #: [len(prebound)] i32 the node of each tail column (PAD: a fork's
    #: unplaced pod)
    tail_node: np.ndarray

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

    def col_of(self, P: int) -> np.ndarray:
        """[P] i32 each pod's choice-buffer column: its wave slot, a
        pre-bound pod's tail column, PAD for a pod in no slot."""
        out = np.full(P, PAD, np.int32)
        flat = self.idx.reshape(-1)
        v = flat >= 0
        out[flat[v]] = np.nonzero(v)[0]
        out[self.prebound] = self.idx.size + np.arange(self.prebound.size)
        return out

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
    pods: EncodedPods, wave_idx: np.ndarray, C: int, completions_on: bool, has_gangs: bool,
    fork: Optional["ForkTail"] = None,
) -> ChunkPlan:
    """Pad the waves to whole chunks of C and bucket the completion
    releases (sim/whatif.py ``_stage_dev_rel``): a pod releases at
    ``b_rel = max(first boundary whose start time ≥ its release time,
    chunk_of + 2)`` — the one-chunk slack — where ``chunk_of`` is the
    chunk holding its slot (−2 for a pre-bound pod). Boundaries past the
    last finite one never release. ``fork`` (:func:`fork_tail`; the waves
    are then those after the fork point) adds the pre-fork pods to the
    tail at their ``chunk_of`` and leaves out of the buckets the pods whose
    release the forked state already carries, and the unplaced ones."""
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
    tail_node = pods.bound_node[prebound].astype(np.int32)
    if fork is not None:
        prebound = np.concatenate([prebound, fork.pods]).astype(np.int64)
        tail_node = np.concatenate([tail_node, fork.nodes]).astype(np.int32)
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
        if fork is not None:
            chunk_of[fork.pods] = fork.chunk_of
            tail_of = np.full(P, PAD, np.int32)
            tail_of[prebound] = tail_node
            elig_ok &= ~fork.released & ~((pos_of >= Wtot) & (tail_of < 0))
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
                     col_relb=col_relb, tb=tb_all, nongang_before=nongang_before,
                     tail_node=tail_node)


class ForkTail(NamedTuple):
    """The pre-fork part of a what-if fork (:func:`fork_tail`)."""

    waves_done: int  # real waves the source replay ran (clamped)
    pods: np.ndarray  # [n] i64 the valid pods of those waves, in slot order
    nodes: np.ndarray  # [n] i32 the source's choice of each (PAD: unplaced)
    chunk_of: np.ndarray  # [n] i64 −2 folded before the fork, −1 the source's last chunk
    released: np.ndarray  # [P] bool releases the forked state already carries


def fork_tail(pods: EncodedPods, wave_idx: np.ndarray, ck) -> ForkTail:
    """The fork point of a plain checkpoint ``ck`` over the waves
    ``wave_idx`` (kubernetes_simulator_tpu/sim/whatif.py:1854-1883,
    :2738-2810, :2939-2962): the source's saved choices clamped to the real
    wave count (a replay pads its waves to whole chunks); the pods of its
    chunks before the last one folded (release from boundary 0 after the
    fork), those of its last chunk one chunk behind (from boundary 1, the
    one-chunk slack); its released mask, or without one (a file written
    before the field) the releases :func:`rebuild_fork_state` reconstructs
    with slack 0, as the reference does. A boundary-mode file is refused in
    the reference's words."""
    if ck.boundary is not None:
        raise ValueError(
            "cannot fork from a boundary-mode (retry/kube) checkpoint: its placements live in "
            "the host mirror, not the saved outs; resume it on a matching JaxReplayEngine "
            "instead")
    W = wave_idx.shape[1]
    done, choices = 0, np.zeros((0, W), np.int32)
    C_src = int(np.asarray(ck.outs[0]).shape[0]) if ck.outs else 0
    if ck.outs:
        fork = np.concatenate([np.asarray(o, np.int32).reshape(-1, W) for o in ck.outs])
        done = min(fork.shape[0], wave_idx.shape[0])
        choices = fork[:done]
    cut = max(min((ck.chunk_cursor - 1) * C_src, done) if C_src else done, 0)
    rows = wave_idx[:done]
    v = rows >= 0
    chunk_of = np.where(np.arange(done)[:, None] < cut, -2, -1) + np.zeros_like(rows)
    if ck.released is not None:
        released = np.asarray(ck.released, bool)
    elif C_src:
        need = ck.chunk_cursor * C_src
        idx_src = wave_idx
        if idx_src.shape[0] < need:
            idx_src = np.concatenate(
                [idx_src, np.full((need - idx_src.shape[0], W), PAD, np.int32)])
        _, released = rebuild_fork_state(pods, idx_src, C_src, ck.outs,
                                         wave_start_times(pods, idx_src), ck.chunk_cursor,
                                         slack=0)
    else:
        released = np.zeros(pods.num_pods, bool)
    return ForkTail(waves_done=done, pods=rows[v].astype(np.int64),
                    nodes=choices[v].astype(np.int32), chunk_of=chunk_of[v].astype(np.int64),
                    released=released)


def new_choices(plan: ChunkPlan, S: int, device) -> torch.Tensor:
    """A fresh choice buffer ``[S, L]``: PAD in every slot column, each
    tail column's node (a pre-bound pod's, a fork's pre-fork choice)."""
    choices = torch.full((S, plan.L), PAD, dtype=torch.int32, device=device)
    if plan.prebound.size:
        choices[:, plan.idx.size :] = torch.as_tensor(plan.tail_node, device=device)
    return choices


def retry_slots(plan: ChunkPlan, b: int, RB: int) -> int:
    """Buffer slots the per-slot route's retry pass at boundary b runs (the
    chunk route reads each scenario's count on the card): the host cannot
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
    """Boundary b's retry sequence on the per-slot route (after its static
    release; the chunk route runs it inside K6's retry mode): the K3
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


def chaos_steps(plan: ChunkPlan, timelines, alloc0: np.ndarray, device) -> dict:
    """``{b: ChaosStep}`` of the boundaries where an event of ``timelines``
    (one list of NodeEvent a scenario) fires (:func:`..ops.reference.
    event_steps` over the plan's f64 boundary times; ``alloc0`` the t = 0
    allocatable, ``[N, R]`` or ``[S, N, R]``), its arrays on ``device``,
    uploaded once before a run, so the chunk loop enqueues each step with
    no host transfer."""
    t = lambda a: torch.as_tensor(a, device=device)
    return {b: st._replace(rows=t(st.rows), vals=t(st.vals), scen=t(st.scen), off=t(st.off),
                           nodes=t(st.nodes))
            for b, st in ref.event_steps(timelines, plan.tb, alloc0).items()}


def log_capacity(plan: ChunkPlan, RB: int, need: int = 0) -> int:
    """Records a scenario's event log (:class:`..ops.reference.EventLog`)
    holds: ``need`` (the most records a scenario of an earlier run of the
    same plan appended) or, if more, twice the pods a run schedules or
    holds bound (its valid slots and pre-bound pods) plus a buffer's worth.
    A pass bind follows a failure or an unbind, and an unbind (``preempt``,
    ``evict``) undoes a bind, so a run that unbinds each pod about once on
    average fits the first time; one that needs more (a node that flaps
    under the same pods, long preemption chains) runs again with ``need``
    set to the count the kernels kept past the capacity
    (:meth:`ChunkEngine._run`)."""
    return max(int(need), 2 * (int((plan.idx >= 0).sum()) + int(plan.prebound.size)) + int(RB))


def alloc_at_boundaries(steps: dict, B: int, alloc0: np.ndarray) -> np.ndarray:
    """``[B, N, R]`` f32: the allocatable rows in force after each of the
    B boundaries' events of one timeline (``steps``, its
    :func:`..ops.reference.event_steps` over ``alloc0``, the t = 0 rows
    ``[N, R]``), the rows :func:`chaos_steps` writes on the device — what
    the series gauges read at each boundary (sim/jax_runtime.py:2343-2360,
    sim/boundary.py:654-672 with the live rows of :1774-1790)."""
    a0 = np.asarray(alloc0, np.float32)
    out = np.repeat(a0[None], B, axis=0)
    cur = a0.copy()
    for b in range(B):
        st = steps.get(b)
        if st is not None:
            cur[st.rows] = st.vals
        out[b] = cur
    return out


def make_tick(timers=None) -> Callable:
    """``tick(phase)``: the phase timer of ``timers`` (a no-op without),
    under a ``torch.profiler`` record of the phase's name while profiling is
    armed (:mod:`..utils.profiling`; the reference's ``_make_tick``,
    sim/jax_runtime.py:63). Asked once a run."""
    from ..utils.profiling import annotate, profiling_active

    base = timers.tick if timers is not None else (lambda name: contextlib.nullcontext())
    if not profiling_active():
        return base

    @contextlib.contextmanager
    def tick(name):
        with annotate(name), base(name):
            yield

    return tick


def chunk_annotation(b: int):
    """The records of chunk b's launches while profiling is armed:
    ``chunk:<b>`` under ``dispatch`` (the reference's ``_chunk_ann``,
    sim/jax_runtime.py:91); else a no-op context."""
    from ..utils.profiling import annotate, profiling_active

    if not profiling_active():
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    stack.enter_context(annotate("dispatch"))
    stack.enter_context(annotate(f"chunk:{b}"))
    return stack


def run_waves(plan: ChunkPlan, tb: ref.Tables, choices: torch.Tensor, first: int, end: int,
              plain: bool, ser: Optional[Series] = None, route: str = "slot",
              pager=None, joint: bool = False, timers=None,
              on_chunk: Optional[Callable[[int], None]] = None,
              chaos: Optional[dict] = None, trailing: Optional[bool] = None) -> None:
    """Enqueue waves ``[first, end)`` of ``plan`` over the S scenarios of
    ``tb`` (state and ``choices`` updated in place, no synchronisation):
    the release bucket of a boundary where a chunk starts (with ``joint``,
    the single replay's order, under the retry buffer past boundary 0 the
    boundary's pending and static releases go out as one,
    :func:`joint_release`), then the chunk's waves on ``route``: one K6
    launch over the chunk's waves in the range (``"chunk"``, reading the
    plan's :class:`ChunkDesc`, uploaded once a call; under the retry
    buffer, at a chunk's start past boundary 0, in K6's retry mode, which
    runs the boundary's retry sequence first — the pending release unless
    ``joint`` took it, the retry pass, K4's bookkeeping), or the retry
    sequence from the host (:func:`run_retry_boundary`) and then per slot
    K1 → K2 → K3 bind (which appends a failed non-gang pod to the buffer)
    and a K3 rollback after a wave holding a gang member (``"slot"``).
    ``plain`` runs the plain twins on any device; otherwise the kernel
    wrappers run (the kernels for CUDA tensors, the twins for CPU
    tensors).

    With ``ser`` (telemetry series, :class:`Series`; the replicated routes
    only) each boundary also copies its samples (inside K6's retry mode on
    the chunk route past boundary 0, after the retry sequence), and
    failures are attributed: on the plain path after each slot's K2
    (inside K6, its attributed mode, on the chunk route; K5 on the
    per-slot route); on the retry path in each retry-pass slot (inside
    K6's retry mode on the chunk route, K5 on the per-slot route) and, for
    a chunk's failed slots, by K5 in one launch when the chunk is done (at
    the next boundary, before its releases, or at the run's end) against
    the chunk's start planes, copied at each boundary. The order is the
    reference's: chunk b−1's fold precedes boundary b's chaos step,
    releases and retry pass (sim/jax_runtime.py:1716-1770), and the last
    chunk's the trailing boundary.

    Under kube preemption (a Retry with ``prio``; the chunk route only) the
    retry-mode K6 runs the kube pass (with ``ser`` its attribution and
    samples), and a range that ends the plan ends with the trailing
    boundary at ``t = inf`` (sim/greedy.py, the reference's :232-239): its
    release (every pending entry due, no static bucket) and one retry-mode
    K6 with no waves (``trailing`` False leaves it to a later call, which
    runs it with ``first == end`` and ``trailing`` True: a checkpoint after
    the last chunk is taken before it, as the reference's). The tables'
    event log (``tb.log``, telemetry timeline) takes K10's and the retry
    pass's records.

    On node-sharded tables (row B13) a boundary's release is K8's, and the
    chunk's waves one K9 launch over the waves in the range (``"shard"``,
    reading the plan's :class:`ChunkDesc`) or per slot K1 (over the padded
    node axis) → K7 (the two-stage choice) → K8 bind, with K8's rollback
    after a gang wave (``"shard_slot"``).

    With ``pager`` (paged pod waves, :class:`.pager.PodPager`; ``first`` on
    a chunk's start) each chunk runs on its page: the pod tables of its
    slots and of its boundary's released pods, named by page-local ids,
    while the next chunk's page is staged.

    ``timers`` (:class:`.telemetry.PhaseTimers`) is charged each chunk's
    host wall, as ``dispatch`` and ``dispatch_<route>``; ``on_chunk(b)`` is
    called once chunk b's launches are enqueued (the flight recorder's
    cadence; it may read clocks and counters, and must not wait on the
    card).

    ``chaos`` (``{b: ChaosStep}``, :func:`chaos_steps`; the replicated
    routes, without a pager) runs each boundary's chaos step
    first, before its releases (sim/jax_runtime.py:1716-1803): the
    allocatable rows it rewrites (an ``index_copy_`` on the stream) and,
    under the retry buffer, K10's NoExecute eviction of its down nodes'
    pods (:func:`..ops.kernels.evict_node`), whose victims the boundary's
    retry pass then re-attempts — at boundary 0 too, in a retry-mode K6
    (the chunk route only: the per-slot route's eviction is not ported)."""
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    if route in SHARD_ROUTES and ser is not None:
        raise ValueError("telemetry series runs on the replicated routes: the reference "
                         "attributes nothing under node shards")
    if (route in SHARD_ROUTES) != (tb.shards is not None):
        raise ValueError("node-sharded tables take a shard route, and only they")
    kube = tb.retry is not None and tb.retry.prio is not None
    if kube and route != "chunk":
        raise _later(f"kube preemption on route {route!r} (its retry pass grows by its victims "
                     "on the card: the per-slot route would need a host sync a pass slot)",
                     "ROADMAP queue A item 6a; kube runs on the chunk route, K6's retry mode")
    if pager is not None and (ser is not None or tb.retry is not None or tb.preempt is not None
                              or first % plan.C):
        raise ValueError("paged pod waves run from a chunk's start, without series telemetry, "
                         "the retry buffer or tier preemption")
    rt = tb.retry
    if chaos:
        if route in SHARD_ROUTES or pager is not None:
            raise _later("chaos node events under node shards or paged pod waves",
                         "ROADMAP queue A item 6b")
        if rt is not None and route != "chunk":
            raise _later(f"chaos evictions on route {route!r} (the per-slot retry sequence's "
                         "eviction step)", "ROADMAP queue A item 6b")
        if rt is not None and rt.evict_t is None:
            raise ValueError("a chaos timeline under the retry buffer needs retry tables "
                             "with its records (ChunkEngine._tables)")
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
    evict = ref.evict_nodes if plain else K.evict_node
    alloc_rows = tb.cluster.allocatable.view(-1, tb.cluster.allocatable.shape[-1])
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

    def boundary_work(b: int):
        """Boundary b's work before its chunk's waves. On the chunk route
        with the retry buffer (b > 0) the retry sequence and the samples go
        to the chunk's K6 launch: returns its ``retry`` and ``samples``
        arguments (else (None, None))."""
        if pager is not None:
            chunk_start(b)
        if ser is not None and ser.fold and b > 0:
            fold(b - 1)  # chunk b - 1 ran on the rows before boundary b's events
        step = chaos.get(b) if chaos else None
        evicted = False
        if step is not None:
            alloc_rows.index_copy_(0, step.rows, step.vals)
            if rt is not None and step.scen.numel():
                evict(h, choices, step.scen, step.off, step.nodes, b, step.t_b)
                evicted = True
        if rt is not None and joint and b > 0:
            joint_release(b, h, apply_placements, rt, choices, buckets.get(b))
        elif b in buckets:
            release(h, buckets[b][0], buckets[b][1], choices, -1.0)
        samples = None
        if ser is not None:  # each boundary with a finite start time, and the fold's planes
            at_b = lambda x: x[b] if x is not None and np.isfinite(plan.tb[b]) else None
            samples = ref.RetrySamples(at_b(ser.used), at_b(ser.rcount), at_b(ser.pend),
                                       ser.snap if ser.fold else None)
        if rt is not None and (b > 0 or evicted) and route == "chunk":
            return (b, float(np.float32(plan.tb[b])), not joint), samples
        if rt is not None and b > 0:
            run_retry_boundary(plan, b, h, fns, rt, pos_rb, reject, joint)
        if samples is not None:
            ref.take_samples(tb, samples)
        return None, None

    t_chunk = [time.perf_counter()]

    def charge() -> None:
        """The host wall since the last charge to the timers."""
        if timers is not None:
            dt = time.perf_counter() - t_chunk[0]
            timers.add("dispatch", dt)
            timers.add(f"dispatch_{route}", dt)

    def chunk_done(b: int) -> None:
        """Chunk b's launches are enqueued: its host wall to the timers, then
        the caller's hook."""
        charge()
        if on_chunk is not None:
            on_chunk(b)
        t_chunk[0] = time.perf_counter()

    if route in ("chunk", "shard"):
        w = first
        while w < end:
            b = w // C
            with chunk_annotation(b):
                retry, samples = boundary_work(b) if w % C == 0 else (None, None)
                hi = min(end, (b + 1) * C)
                if route == "shard":
                    shard_chunk_replay(h, desc.idx, desc.gang, choices, w, hi)
                elif retry is not None:
                    chunk_replay(h, desc.idx, desc.gang, choices, w, hi, append=True,
                                 reject=tb.reject if reject is not None else None, retry=retry,
                                 samples=samples)
                else:
                    chunk_replay(h, desc.idx, desc.gang, choices, w, hi,
                                 boundary=b if preempt else None, append=append,
                                 reject=k6_reject)
            w = hi
            chunk_done(b)
        if trailing is None:
            trailing = end > first
        if kube and end == idx.shape[0] and trailing:
            bt = idx.shape[0] // C
            if ser is not None and ser.fold:
                fold((end - 1) // C)  # the last chunk's failures, before the trailing pass
            if joint:
                joint_release(bt, h, apply_placements, rt, choices, None)
            chunk_replay(h, desc.idx, desc.gang, choices, end, end, append=True,
                         reject=tb.reject if reject is not None else None,
                         retry=(bt, float("inf"), not joint))
            charge()
    else:
        rows = idx.tolist()
        gang_wave = plan.gang_wave.tolist()
        pos_dev = torch.arange(plan.L, dtype=torch.int32, device=dev)
        shard = route == "shard_slot"
        for w in range(first, end):
            b = w // C
            if w % C == 0:
                with chunk_annotation(b):
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
            if (w + 1) % C == 0 or w + 1 == end:
                chunk_done(b)
    if ser is not None and ser.fold and end == idx.shape[0] and end > first and not kube:
        fold((end - 1) // C)
        charge()
    if page is not None:
        pager.done(page)


class Checkpointing(NamedTuple):
    """The checkpoints of one run of the chunk loop (:func:`run_chunks`):
    ``save(cursor, tables, choices)`` after chunk ci when ``(ci + 1) %
    every == 0`` (0: never), before boundary ci + 1's work (the
    reference's save point, sim/jax_runtime.py:2402-2416 and :1853-1876),
    and on a resume ``restore(tables) -> (cursor, choices)``, which seeds
    the tables in place and returns the first chunk to run and the seeded
    choice buffer."""

    every: int = 0
    save: Optional[Callable[[int, ref.Tables, torch.Tensor], None]] = None
    restore: Optional[Callable[[ref.Tables], Tuple[int, torch.Tensor]]] = None


def run_chunks(
    plan: ChunkPlan, tb: ref.Tables, plain: bool, timers=None,
    ser: Optional[Series] = None, route: Optional[str] = None, pager=None, joint: bool = False,
    on_chunk: Optional[Callable[[int], None]] = None, chaos: Optional[dict] = None,
    ckpt: Optional[Checkpointing] = None,
) -> np.ndarray:
    """Replay every chunk of ``plan`` over the S scenarios of ``tb`` (its
    state is updated in place) on ``route`` (None: :func:`choose_route`
    of ``plain`` and the tables' shards), with ``pager``'s pages
    when given (``joint``, ``timers``, ``on_chunk`` and ``chaos``: as
    :func:`run_waves`), and return the host copy of the choice buffer
    ``[S, L]``. The one synchronisation is the final fetch, and each save
    of ``ckpt`` (:class:`Checkpointing`), which splits the waves into
    ranges at its cadence and may resume past chunk 0."""
    tick = make_tick(timers)
    route = route or choose_route(plain, tb.shards is not None,
                                  tb.retry is not None and tb.retry.prio is not None)
    cursor, choices = 0, None
    if ckpt is not None and ckpt.restore is not None:
        cursor, choices = ckpt.restore(tb)
    if choices is None:
        choices = new_choices(plan, tb.state.used.shape[0], tb.state.used.device)
    C, end = plan.C, plan.idx.shape[0]
    every = ckpt.every if ckpt is not None and ckpt.save is not None else 0
    w = cursor * C
    for c in range(cursor + 1, end // C + 1):
        if every and c % every == 0:
            run_waves(plan, tb, choices, w, c * C, plain, ser, route, pager, joint,
                      timers=timers, on_chunk=on_chunk, chaos=chaos, trailing=False)
            ckpt.save(c, tb, choices)
            w = c * C
    run_waves(plan, tb, choices, w, end, plain, ser, route, pager, joint, timers=timers,
              on_chunk=on_chunk, chaos=chaos, trailing=True if w else None)
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
    [S, P], its slot PAD) takes its retried node and counts once, unless it
    is pre-bound (a kube victim re-placed: the reference never counts a
    pre-bound pod)."""
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
        placed += (retried & (bound_node < 0)[None]).sum(axis=1).astype(np.int32)
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
        kube: bool = False, fork=None,
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
        #: kube preemption (the retry tables carry the PostFilter's)
        self.kube = bool(kube)
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
        #: the fork's checkpoint (:class:`.checkpoint.ReplayCheckpoint`; the
        #: what-if's ``fork_checkpoint``) and its pre-fork part
        #: (:class:`ForkTail`), else None
        self._fork_ck, self.fork = fork, None
        wave_idx = self.waves.idx
        if fork is not None:
            self.fork = fork_tail(pods, wave_idx, fork)
            wave_idx = wave_idx[self.fork.waves_done:]
            if wave_idx.shape[0] == 0:
                wave_idx = np.full((1, self.wave_width), PAD, np.int32)
        #: chunk layout and release buckets, static per engine
        self.plan = plan_chunks(pods, wave_idx, self.chunk_waves, self.completions_on,
                                spec.has_gangs, fork=self.fork)
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
        ck = self._fork_ck
        if ck is not None:
            # The forked state: the checkpoint's planes in every scenario, its
            # domain axis padded to the batch's (the reference's v2 fork reads
            # a relabelled scenario's domain ids in them too, sim/whatif.py:
            # 1910-1934).
            D = self._domains[3] if self._domains is not None else self.ec.max_domains
            out = [np.asarray(ck.used, np.float32)]
            for f in fields[1:]:
                a = np.asarray(getattr(ck, f), np.float32)
                pad = np.zeros((a.shape[0], max(int(D), a.shape[1], 1)), np.float32)
                pad[:, : a.shape[1]] = a
                out.append(pad)
            return tuple(out)
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

    def _tables(self, attribute: bool = False, pods: Optional[ref.DevPods] = None,
                timeline: bool = False, log_need: int = 0,
                track_nodes: bool = False) -> ref.Tables:
        """The tables of one run; ``attribute`` adds zeroed first-reject
        counters (telemetry series), ``timeline`` the event log of a run
        whose pods can be unbound (kube or a chaos timeline under the retry
        buffer; :func:`log_capacity` records a scenario, at least
        ``log_need``). A checkpointing replay under the retry buffer
        (``track_nodes``) also takes the node tables (``rrel`` tells a
        retried pod's released node from a held one in its blob). ``pods``: the pod
        tables (a pager's page); by default the whole trace's, uploaded once.
        A meshed what-if batch's tables are its blocks' (``WhatIfEngine._blocks``)."""
        if getattr(self, "_blocks", None) is not None:
            raise ValueError("a meshed batch has no tables of its own: each block of its "
                             "scenarios has its own, on its device (WhatIfEngine._blocks)")
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
        rt = log = None
        if self.retry_buffer:
            kube = chaos = nodes = None
            timelines = self._timelines()
            if timeline and (self.kube or timelines is not None):
                log = ref.new_log(self.S, log_capacity(self.plan, self.retry_buffer, log_need),
                                  self.device)
            if self.kube or timelines is not None or track_nodes:
                nodes = dict(col_of=self.plan.col_of(self.pods.num_pods),
                             col_relb=self.plan.col_relb)
            if self.kube:
                kube = dict(prio=self.pods.priority,
                            trace_has_anti=bool((self.pods.anti_req >= 0).any()), **nodes)
            if timelines is not None:
                chaos = dict(tbd=self.plan.tb, **nodes)
            rt = ref.new_retry(self.retry_buffer, self.pods.duration, self.plan.tbt, self.S,
                               self.device, kube=kube, chaos=chaos,
                               nodes=nodes if track_nodes else None)
        sh = None
        if self.layout is not None:
            lay, plan = self.layout, self.plan
            gdom = ref.group_domains(self._dev_ec)[0]  # [G, n_pad]
            tail = plan.tail_node
            sh = ref.new_shards(lay.P, lay.n_local, lay.n_real, self.S, plan.L, gdom.shape[0],
                                self.device, tail_dom=gdom[:, tail].T)
        return ref.Tables(
            cluster=self._cluster, pods=pods,
            state=ref.stacked_state(*self._initial_planes(), self.S, self.device),
            scratch=ref.new_scratch(self.S, self._dev_ec.num_nodes, self.device),
            consts=self.consts, preempt=pre, retry=rt,
            reject=(ref.new_reject(len(spec_plugin_names(self.spec)), self.pods.num_pods, self.S,
                                   self.device) if attribute else None),
            wrow=self._wrow, shards=sh, log=log,
        )

    def _timelines(self) -> Optional[list]:
        """The chaos timeline of each scenario of the next run (a list of
        NodeEvent lists), or None when no scenario has an event."""
        tl = getattr(self, "_events", None)
        return tl if tl is not None and any(tl) else None

    def _alloc0(self) -> np.ndarray:
        """The host allocatable every scenario starts from (a ``node_up``
        restores its row): ``[N, R]``; the what-if batch's ``[S, N, R]``."""
        return self.ec.allocatable

    def _pager(self):
        """A fresh pager of this engine's plan (paged pod waves), or None;
        threaded unless the engine's ``pager_thread`` is False."""
        if not self.paged:
            return None
        from .pager import PodPager

        return PodPager(self.pods, self.plan.idx, self.plan.C, self.plan.buckets, self.device,
                        threaded=getattr(self, "pager_thread", True))

    def _run(self, timers=None, series: bool = False, route: Optional[str] = None,
             joint: bool = False, recorder=None, timeline: bool = False,
             log_need: int = 0, ckpt: Optional[Checkpointing] = None):
        """(tables after the run, wall seconds, assignments [S, P], placed
        [S], pods to schedule). ``series`` (the reference's ``use_rej``)
        takes the boundary samples and the first-reject attribution
        (:class:`Series`; none when no Filter plugin is on); ``timeline``
        the event log of a run whose pods can be unbound (kube or a chaos
        timeline under the retry buffer), checked after the fetch: where a
        scenario's log filled (the kernels count on past the capacity), the
        run is made once more with a log of that count (``log_need``; the
        wall is both runs', ``recorder`` sees the first), and a log that
        fills again raises: no event is silently lost. ``route`` (one
        of :data:`ROUTES`) overrides the route the mode chooses
        (:func:`choose_route`), so a kernel run can be held against the
        other route. ``joint``: a retry boundary's pending
        and static releases go out as one (:func:`run_waves`; the single
        replay's order). ``ckpt`` (:class:`Checkpointing`) saves and resumes
        the run (the single replay's checkpoints). ``recorder``
        (:class:`.flight.FlightRecorder`) takes
        a row after each chunk's launches (:meth:`_flight_hook`), with the
        phase deltas of ``timers`` (its own timers without them). The tables
        are kept as ``last_tables``, the fetched choice buffer as
        ``last_choices``, the series buffers as ``last_series`` and the
        route as ``last_route``."""
        attribute = series and bool(spec_plugin_names(self.spec))
        # Paged pod waves stream the pods of a chunk's waves; the attributed
        # run keeps the resident tables, as the reference's attributed program
        # (sim/jax_runtime.py:2253 ``if self.paged and not use_rej``).
        pager = self._pager() if not series else None
        self.last_pager = pager
        # Under the retry buffer a checkpointing run keeps each retried pod's
        # release boundary (rrel), which its blob reads.
        tb = self._tables(attribute, pods=pager.pods0 if pager is not None else None,
                          timeline=timeline, log_need=log_need, track_nodes=ckpt is not None)
        self.last_tables = tb
        ser = new_series(self.plan, tb, attribute) if series else None
        self.last_series = ser
        self.last_route = route or choose_route(self.plain, self.layout is not None, self.kube)
        hook = None
        if recorder is not None:
            timers = timers if timers is not None else recorder.phases
            hook = self._flight_hook(recorder, pager, timers)
        timelines = self._timelines()
        chaos = alloc = None
        if timelines is not None:
            # The steps go up before the loop; the allocatable the run
            # rewrites comes back after it (sim/jax_runtime.py:1941-1944).
            chaos = chaos_steps(self.plan, timelines, self._alloc0(), self.device)
            alloc = tb.cluster.allocatable
            alloc0 = alloc.clone()
        t0 = time.perf_counter()
        try:
            host_choices = run_chunks(self.plan, tb, self.plain, timers,
                                      ser, self.last_route, pager, joint, on_chunk=hook,
                                      chaos=chaos, ckpt=ckpt)
        finally:
            if pager is not None:
                pager.close()
            if alloc is not None:
                alloc.copy_(alloc0)
        wall = time.perf_counter() - t0
        self.last_choices = host_choices
        if tb.log is not None:
            full = torch.nonzero(tb.log.n > tb.log.rec.shape[1]).flatten().tolist()
            if full and not log_need:
                # The run is deterministic: the same run with the count the
                # kernels reported keeps every record.
                again = ChunkEngine._run(self, timers, series, route, joint, None, timeline,
                                         log_need=int(tb.log.n.max()), ckpt=ckpt)
                return (again[0], wall + again[1]) + again[2:]
            if full:
                ref.log_records(tb.log, full[0])  # raises: no event is silently lost
        rnode = tb.retry.rnode.cpu().numpy() if tb.retry is not None else None
        return (tb, wall) + assignments_from_choices(self.plan, host_choices,
                                                     self.pods.bound_node, rnode)

    def _collect(self, tel: TelemetryCollector, tb: ref.Tables, placed: int, s: int = 0,
                 timeline=None, interleave: bool = False) -> None:
        """Fill ``tel`` with scenario s of the fetched run (host work, no
        device step; ``timeline`` its chaos events, ``placed`` its placed
        pods): first-bind latencies, K5's counters, the series gauges (the
        reference's f64 ``series_gauges`` of each boundary's copied ``used``
        over the allocatable rows in force there) and, at ``timeline``, the
        events in the reference's order: per chunk c, boundary c's
        ``node_down`` / ``node_up`` events at their own times (with
        ``interleave``, the what-if batch's order, sim/whatif.py:3290-3311,
        each ``node_down`` followed by its node's evictions), then its
        records — K10's ``evict`` and the pass's ``preempt`` and ``bind``,
        from the run's event log (or, where no pod can be unbound, the
        retried binds in buffer order) at the boundary's start time (the
        last finite one on the trailing boundary) — then, on the retry path,
        chunk c's wave binds at their arrival, in slot order, a pod that a
        later preemption or eviction unbound included (its column is PAD
        and its first record an unbind naming its node)."""
        plan, ep, rt = self.plan, self.pods, tb.retry
        choices = self.last_choices[s]
        flat = plan.idx.reshape(-1)
        fin = np.nonzero(np.isfinite(plan.tb))[0]

        def t_at(b: int) -> float:
            """Boundary b's start time, the last finite one past them."""
            if b < plan.tb.size and np.isfinite(plan.tb[b]):
                return float(plan.tb[b])
            return float(plan.tb[fin[fin <= b][-1]]) if (fin <= b).any() else 0.0

        recs = []  # (kind, boundary, pod, node) in the reference's order
        if rt is not None and rt.first_b is not None:
            # First binds only (the reference's ``_ever_bound``,
            # sim/boundary.py:619-627): a wave bind has latency 0, whether
            # the pod still holds its slot or was evicted since (first_b
            # -2); a first bind through the pass waits from arrival to its
            # boundary's start (the last finite one at t = inf). Victims
            # that end unplaced count; pre-bound pods never do.
            first_b = rt.first_b[s].cpu().numpy()
            slot = choices[: flat.size]
            in_wave = np.zeros(ep.num_pods, bool)
            in_wave[flat[(flat >= 0) & (slot >= 0)]] = True
            in_wave |= first_b == ref.FIRST_IN_WAVE
            in_wave &= ep.bound_node < 0
            zero = int(in_wave.sum())
            for p in np.nonzero(first_b >= 0)[0].tolist():
                lat = t_at(int(first_b[p])) - float(ep.arrival[p])
                if lat > 0.0:
                    tel.bind_latency(p, lat)
                else:
                    zero += 1
            tel.bind_zero(zero)
        elif rt is not None:
            rnode = rt.rnode[s].cpu().numpy()
            rbind_b = rt.rbind_b[s].cpu().numpy()
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
                recs.append(("bind", int(rbind_b[p]), p, int(rnode[p])))
            tel.bind_zero(placed - later)
        else:
            tel.bind_zero(placed)
        if tb.reject is not None:
            tel.rejection_totals(spec_plugin_names(self.spec),
                                 tb.reject.reasons[s].cpu().numpy(),
                                 tb.reject.attempts[s].cpu().numpy())
        alloc0 = self._alloc0()
        alloc0 = alloc0[s] if alloc0.ndim == 3 else alloc0
        # The one schedule of the timeline's events: the rows in force at
        # each boundary and the node events fired there.
        steps = ref.event_steps([timeline], plan.tb, alloc0) if timeline else {}
        ser = self.last_series
        if ser is not None:
            used = ser.used[:, s].cpu().numpy()
            rcount = ser.rcount[:, s].cpu().numpy() if ser.rcount is not None else None
            pend = (ser.pend[:, s] >= 0).sum(dim=1).cpu().numpy() if ser.pend is not None else None
            alloc = (alloc_at_boundaries(steps, plan.tb.size, alloc0) if steps
                     else np.broadcast_to(alloc0, (plan.tb.size,) + alloc0.shape))
            for b in range(len(plan.buckets)):
                if not np.isfinite(plan.tb[b]):
                    continue
                depths = ({} if rcount is None
                          else dict(retry_depth=int(rcount[b]), pend_depth=int(pend[b])))
                tel.sample(float(plan.tb[b]), **depths,
                           **series_gauges(used[b], alloc[b], self.ec.vocab._r))
        if not tel.cfg.want_timeline:
            return
        if tb.log is not None:
            recs = ref.log_records(tb.log, s)
        by_b = {}
        first_rec = {}
        for r in recs:
            by_b.setdefault(r[1], []).append(r)
            first_rec.setdefault(r[2], r)
        downs = {b: st.fired[0] for b, st in steps.items()}
        ch = choices[: flat.size]
        CW = plan.C * plan.idx.shape[1]
        nb = len(plan.buckets)
        for c in range(nb + 1):
            at_c, k = by_b.get(c, []), 0
            for ev in downs.get(c, ()):
                if ev.kind in ("node_down", "node_up"):
                    tel.event(ev.kind, float(ev.time), -1, int(ev.node))
                while (interleave and ev.kind == "node_down" and k < len(at_c)
                       and at_c[k][0] == "evict" and at_c[k][3] == ev.node):
                    tel.event("evict", t_at(c), at_c[k][2], at_c[k][3])
                    k += 1
            for kind, b, p, n in at_c[k:]:
                tel.event(kind, t_at(b), p, n)
            if rt is None or c == nb:
                continue
            for p, n in zip(flat[c * CW : (c + 1) * CW].tolist(), ch[c * CW : (c + 1) * CW].tolist()):
                if p < 0:
                    continue
                if n < 0:
                    r = first_rec.get(p)
                    if r is None or r[0] == "bind":
                        continue
                    n = r[3]
                tel.event("bind", float(ep.arrival[p]), p, n)


    def _flight_hook(self, rec, pager, timers) -> Callable[[int], None]:
        """The recorder's call after chunk b's launches (the reference's
        loop tail, sim/jax_runtime.py:2420-2470): a ``page`` row where the
        pager missed or dropped a page since the last row, then the
        ``chunk`` row — chunk b's start time, the valid slots dispatched
        through it, the phase deltas and the pager's gauges. Host clocks
        and counters only (:mod:`.flight`)."""
        plan = self.plan
        CW = plan.C * plan.idx.shape[1]
        valid = np.cumsum((plan.idx.reshape(-1, CW) >= 0).sum(axis=1))
        seen = [0, 0]  # pager stalls, invalidations at the last page row

        def hook(b: int) -> None:
            if pager is not None and (pager.stalls > seen[0] or pager.invalidations > seen[1]):
                rec.page(b, pager.last_stall_s, pager.stalls, invalidations=pager.invalidations)
                seen[:] = pager.stalls, pager.invalidations
            rec.chunk(b, t_virtual=plan.tb[b], dispatched=int(valid[b]), phase_acc=timers.acc,
                      pager=pager)

        return hook


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
    pager when ``paged``). ``pager_thread`` is the pager's gate (False
    gathers each page on the calling thread); placements do not depend on
    it.

    ``flight_recorder`` (None: off; a JSONL path, a
    :class:`.flight.FlightRecorderConfig` or a live
    :class:`.flight.FlightRecorder`) streams a row per chunk boundary and
    per page stall, as the reference's (sim/jax_runtime.py:1288-1318); a
    recorder that the replay opens it also closes, with the ``placed``
    summary. It reads clocks and counters only: placements do not depend
    on it (:mod:`.flight` lists where its rows differ from the
    reference's).

    ``telemetry`` is "off", "summary", "series" or "timeline" (a name or
    a :class:`..sim.telemetry.TelemetryConfig`). ``series`` adds the
    first-reject attribution (K6's attributed mode on the plain path, K5 on
    the retry path, K6's retry mode in the retry or kube pass) and the
    boundary-sampled series, ``timeline`` the events — ``bind``,
    ``preempt``, ``evict`` and the timeline's ``node_down`` / ``node_up``
    (kubernetes_simulator_tpu/sim/jax_runtime.py:1764-1770, :2117-2160,
    :2304-2310, sim/boundary.py:360-398, :430-475, :563-668); under tier
    preemption and node shards attribution is off, as the reference's.

    ``replay(node_events=)`` (a sorted list of :class:`.runtime.NodeEvent`,
    validated as the reference validates it) applies a chaos timeline at
    chunk boundaries (module docstring): on the plain path the allocatable
    rows, under the retry buffer or kube also K10's NoExecute eviction,
    with ``evictions``, ``evict_rescheduled``, ``evict_stranded`` and
    ``evict_latency_mean`` in the result. ``replay(checkpoint_path=,
    checkpoint_every=, resume=)`` saves the run every ``checkpoint_every``
    chunks and resumes it from the file, in the reference's format, on
    every path but tier preemption (module docstring; ``last_saves`` keeps
    each save's cursor, bytes and seconds, and the flight recorder its
    ``checkpoint`` row). Every other mode of the JAX engine raises
    ``NotImplementedError`` naming it."""

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
        pager_thread: bool = True,
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
        if paged and mode == "tier":
            raise _later("paged=True with tier preemption (the eviction walk reads the pod "
                         "tables by global pod id)", "ROADMAP queue A item 6a")
        if mode == "kube" and self.node_shards > 1:
            raise _later("preemption='kube' with node_shards (the retry pass and the PostFilter "
                         "over node shards)", "ROADMAP queue A item 6a")
        from .flight import FlightRecorderConfig

        #: the recorder's spec (None: off), a path, a config or a live recorder
        self.flight_recorder = FlightRecorderConfig.resolve(flight_recorder)
        #: the pager's thread gate (overlap.pagerThread)
        self.pager_thread = bool(pager_thread)
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
        #: tier preemption (True) or not; kube is ``self.kube``
        self.preemption = mode == "tier"
        self._prepare(ec, pods, StepSpec.from_config(ec, config, pods),
                      ref.cluster_to(shard_cluster(ec, layout) if layout else ec, device), 1,
                      wave_width, chunk_waves, completions, granularity_guard,
                      "torch replay engine", device, plain, mode == "tier", rb, layout=layout,
                      paged=paged, kube=mode == "kube")

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
        validate_node_events(node_events, self.ec.num_nodes)
        events = list(node_events or [])
        ep = self.pods
        tcfg = TelemetryConfig.resolve(self.telemetry)
        if events:
            if self.node_shards > 1 or self.paged:
                raise _later("node_events with node_shards or paged=True (the allocatable rows "
                             "and the eviction over node shards and pod pages)",
                             "ROADMAP queue A item 6b")
            if self.retry_buffer and choose_route(self.plain, kube=self.kube) != "chunk":
                raise _later("node_events on the per-slot route under the retry buffer (its "
                             "eviction step; the chunk route runs K10)",
                             "ROADMAP queue A item 6b")
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
        if use_rej and (checkpoint_path or resume):
            log.info(
                "telemetry: rejection attribution is disabled under checkpoint/resume (the "
                "instrumented carry is not part of checkpoints) — latency/phase telemetry "
                "still collected"
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
        #: (cursor, bytes, seconds) of each checkpoint this replay wrote
        self.last_saves = []
        ck = None
        if resume and checkpoint_path:
            from .checkpoint import ReplayCheckpoint

            ck = ReplayCheckpoint.load(checkpoint_path)
            self._check_resume(ck, events)
        rec, rec_own = self._open_recorder()
        self._events = [events] if events else None
        ckpt = None
        if ck is not None or (checkpoint_path and checkpoint_every):
            ckpt = Checkpointing(
                every=int(checkpoint_every or 0) if checkpoint_path else 0,
                save=lambda c, tb, ch: self._save_checkpoint(checkpoint_path, c, tb, ch, events,
                                                             rec),
                restore=(lambda tb: self._restore_checkpoint(ck, tb, events))
                if ck is not None else None)
        try:
            tb, wall, assignments, placed_s, to_schedule = self._run(
                tel.phases if tel is not None else None, series=use_rej, joint=True,
                recorder=rec, timeline=tcfg.want_timeline, ckpt=ckpt)
        except BaseException:
            if rec_own:
                rec.close()
            raise
        finally:
            self._events = None
        assignments = assignments[0]
        placed = int(placed_s[0])
        if rec is not None:
            # The pager's walls join the phases (the reference's keys, only
            # where paging is on and the recorder watched it).
            pager = self.last_pager
            if pager is not None and tel is not None:
                tel.phases.add("pager_stall", pager.stall_s)
                tel.phases.add("pager_prefetch", pager.prefetch_wall_s)
            if rec_own:
                rec.close({"placed": placed})

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
            self._collect(tel, tb, placed, 0, events)
        chaos = chaos_counters(tb.retry)
        return ReplayResult(
            assignments=assignments,
            placed=placed,
            unschedulable=to_schedule - placed,
            preemptions=(int(tb.preempt.victims[0]) if tb.preempt is not None
                         else int(tb.retry.preempt[0]) if self.kube else 0),
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
            evictions=int(chaos[0][0]), evict_rescheduled=int(chaos[1][0]),
            evict_stranded=int(chaos[2][0]), evict_latency_mean=float(chaos[3][0]),
        )

    # -- checkpoints (kubernetes_simulator_tpu/sim/jax_runtime.py:1382-1401,
    # :1614-1640, :1853-1876, :2165-2232, :2402-2416) ------------------------

    def _check_resume(self, ck, events: list) -> None:
        """Refuse a checkpoint this engine cannot resume, before any work:
        the reference's guards in its words (a plain file on a boundary-mode
        engine and the reverse, a different timeline, another mode, buffer
        or chunk grid; sim/jax_runtime.py:1614-1640, :2165-2173,
        sim/boundary.py:247-270), then the port's check that the file's
        shapes fit this engine's plan (the reference's plain path indexes
        the saved outs by its own grid unchecked)."""
        plan, bd = self.plan, ck.boundary
        W = plan.idx.shape[1]
        if self.retry_buffer:
            if bd is None:
                raise ValueError("checkpoint was not written by a boundary-mode (retry/kube) "
                                 "replay — resume it on a plain engine")
            h = bd.get("ev_hash")
            if h is not None and not np.array_equal(np.asarray(h, np.uint8),
                                                    _timeline_hash(events)):
                raise ValueError(
                    "checkpoint was written under a different node_events timeline — resuming "
                    "would re-apply or skip events (evictions are not idempotent); pass the "
                    "original event list or restart the replay from scratch")
            mode = bd.get("mode")
            if mode is not None and (bool(mode[0]) != self.kube
                                     or int(mode[1]) != self.retry_buffer):
                want = "kube" if mode[0] else "retry-only"
                this = "kube" if self.kube else "retry-only"
                raise ValueError(
                    f"checkpoint was written by a {want} boundary replay with retry_buffer="
                    f"{int(mode[1])}; resume with the same configuration (this engine: {this}, "
                    f"retry_buffer={self.retry_buffer})")
            if mode is not None and len(mode) >= 4 and (int(mode[2]) != plan.C
                                                        or int(mode[3]) != W):
                raise ValueError(
                    f"checkpoint was written on a chunk grid of chunk_waves={int(mode[2])}, "
                    f"wave_width={int(mode[3])}; this engine uses chunk_waves={plan.C}, "
                    f"wave_width={W}. Boundary bookkeeping (bind chunks, pending release "
                    "boundaries) does not transfer across grids — resume with the original "
                    "wave_width/completions_chunk_waves or restart the replay from scratch.")
        elif bd is not None:
            raise ValueError(
                "checkpoint was written by a boundary-mode (retry/kube) replay — its "
                "placements live in the host mirror, not the saved outs; resume it with the "
                "same retry_buffer/preemption configuration")
        elif len(ck.outs) != ck.chunk_cursor or any(np.asarray(o).size != plan.C * W
                                                    for o in ck.outs):
            raise ValueError(
                f"checkpoint holds {len(ck.outs)} chunks of choices for cursor "
                f"{ck.chunk_cursor}, not chunks of {plan.C} x {W} slots: this engine's chunk "
                f"grid is chunk_waves={plan.C}, wave_width={W} — resume with the original "
                "wave_width/chunk_waves")
        G, D = self._initial_planes()[1].shape
        want = dict(used=(self.ec.num_nodes, self.ec.num_resources), match_count=(G, D),
                    anti_active=(G, D), pref_wsum=(G, D))
        for name, shape in want.items():
            if tuple(np.shape(getattr(ck, name))) != shape:
                raise ValueError(f"checkpoint {name} has shape {np.shape(getattr(ck, name))}, "
                                 f"this engine's is {shape}: it was written for another "
                                 "cluster or trace")
        if ck.chunk_cursor > len(plan.buckets):
            raise ValueError(f"checkpoint cursor {ck.chunk_cursor} is past this engine's "
                             f"{len(plan.buckets)} chunks")

    def _save_checkpoint(self, path: str, cursor: int, tb: ref.Tables, choices: torch.Tensor,
                         events: list, rec) -> None:
        """Write the checkpoint of the run at ``cursor`` (chunks before it
        done, boundary ``cursor`` not begun): the planes in host layout (the
        real nodes of a sharded ``used``), and the choices of the run chunks
        in the reference's ``[C, W]`` layout with the released mask, or under
        the retry buffer the boundary blob (:meth:`_boundary_blob`). The
        host waits here, once a save, for the card to run the chunks before
        the cursor, then times the save itself: the recorder gets its
        ``checkpoint`` row, ``last_saves`` (cursor, bytes, seconds)."""
        from .checkpoint import ReplayCheckpoint

        if tb.state.used.device.type == "cuda":
            torch.cuda.synchronize(tb.state.used.device)
        t0 = time.perf_counter()
        plan, st, N = self.plan, tb.state, self.ec.num_nodes
        planes = dict(used=st.used[0, :N].cpu().numpy(),
                      match_count=st.match_count[0].cpu().numpy(),
                      anti_active=st.anti_active[0].cpu().numpy(),
                      pref_wsum=st.pref_wsum[0].cpu().numpy())
        ch = choices[0].cpu().numpy()
        if tb.retry is None:
            W = plan.idx.shape[1]
            outs = list(ch[: cursor * plan.C * W].reshape(cursor, plan.C, W))
            ck = ReplayCheckpoint(cursor, outs=outs,
                                  released=released_through(plan, ch, cursor,
                                                            self.pods.num_pods), **planes)
        else:
            blob = self._boundary_blob(tb, ch, cursor, events)
            ck = ReplayCheckpoint(cursor, outs=[], released=blob["released"], boundary=blob,
                                  **planes)
        ck.save(path)
        nbytes, wall = _file_bytes(path), time.perf_counter() - t0
        self.last_saves.append((cursor, nbytes, wall))
        if rec is not None:
            rec.checkpoint(cursor, nbytes, wall)

    def _boundary_blob(self, tb: ref.Tables, ch: np.ndarray, cursor: int, events: list) -> dict:
        """The reference's boundary blob (sim/boundary.py ``to_blob`` with
        ``ev_cursor`` / ``ev_hash``) derived from the device retry tables of
        scenario 0 at ``cursor``: a pod's node is its retried node (``rnode``)
        or its choice-buffer column's, released where that pod's pending
        release (``rrel``) or its column's static one (``col_relb``) came
        before ``cursor``; a pod holding its column's node was bound in its
        wave's chunk (−2 pre-bound), every other pod never statically
        releases; the queue, the pending list and the counters are the
        tables'."""
        from .checkpoint import BIND_NEVER

        plan, ep, rt = self.plan, self.pods, tb.retry
        P = ep.num_pods
        host = lambda t: t[0].cpu().numpy()
        rnode, rrel = host(rt.rnode), host(rt.rrel)
        col_of = plan.col_of(P)
        col = np.clip(col_of, 0, None)
        colv = np.where(col_of >= 0, ch[col], PAD)
        retried = rnode >= 0
        released = ((colv >= 0) & (plan.col_relb[col] < cursor)) | (retried & (rrel < cursor))
        assignments = np.where(retried, rnode, colv).astype(np.int32)
        bound = np.where(released, PAD, assignments).astype(np.int32)
        bind_chunk = np.full(P, BIND_NEVER, np.int64)
        live = colv >= 0
        CW = plan.C * plan.idx.shape[1]
        bind_chunk[live] = np.where(col_of[live] < plan.idx.size, col_of[live] // CW, -2)
        pid = host(rt.pend_id)
        keep = pid >= 0
        pend = np.stack([host(rt.pend_relb)[keep], pid[keep], host(rt.pend_node)[keep]],
                        axis=1).astype(np.int64)
        chaos, lat, times = [0, 0], 0.0, np.zeros((0, 2), np.float64)
        if rt.evict_t is not None:
            et = host(rt.evict_t)
            ev_p = np.nonzero(et >= 0)[0]
            chaos = [int(rt.evictions[0]), int(rt.resched[0])]
            lat = float(rt.evict_lat[0])
            times = np.stack([ev_p.astype(np.float64), et[ev_p]], axis=1)
        return {
            "mode": np.asarray([int(self.kube), self.retry_buffer, plan.C, plan.idx.shape[1]],
                               np.int64),
            "bound": bound,
            "assignments": assignments,
            "released": released,
            "bind_chunk": bind_chunk,
            "retry_q": host(rt.rbuf)[: int(rt.rcount[0])].astype(np.int64),
            "pend": pend,
            "counters": np.asarray([int(((assignments >= 0) & (ep.bound_node < 0)).sum()),
                                    int(rt.preempt[0]) if rt.preempt is not None else 0,
                                    int(rt.rdrop[0])], np.int64),
            "chaos": np.asarray(chaos, np.int64),
            "evict_lat": np.asarray([lat], np.float64),
            "evict_times": times,
            "ev_cursor": np.asarray([self._events_fired(events, cursor)], np.int64),
            "ev_hash": _timeline_hash(events),
        }

    def _events_fired(self, events: list, cursor: int) -> int:
        """The events of ``events`` that fire at the boundaries before
        ``cursor`` (the reference's applied-event cursor)."""
        if not events:
            return 0
        steps = ref.event_steps([events], self.plan.tb, self.ec.allocatable)
        return sum(len(st.fired[0]) for b, st in steps.items() if b < cursor)

    def _restore_checkpoint(self, ck, tb: ref.Tables, events: list
                            ) -> Tuple[int, torch.Tensor]:
        """Seed ``tb`` from a checkpoint checked by :meth:`_check_resume`
        and return (its cursor, the seeded choice buffer): the planes; the
        run chunks' choices (plain) or the retry tables rebuilt from the
        boundary blob (:meth:`_restore_boundary`); under node shards the
        domain ids of the restored columns' nodes; and the allocatable rows
        of the timeline's events before the cursor, which fired there (their
        evictions are in the blob, not run again). The plain path's release
        buckets are static (:func:`plan_chunks`), so the file's released mask
        must be the one they imply: the one-chunk slack of the reference's
        re-pended last fold (sim/jax_runtime.py:2204-2232) is their
        ``chunk_of + 2``."""
        plan, dev, N = self.plan, self.device, self.ec.num_nodes
        c = int(ck.chunk_cursor)
        st = tb.state
        st.used[0, :N].copy_(torch.as_tensor(np.asarray(ck.used, np.float32)))
        for name in ("match_count", "anti_active", "pref_wsum"):
            getattr(st, name)[0].copy_(torch.as_tensor(np.asarray(getattr(ck, name),
                                                                  np.float32)))
        choices = new_choices(plan, 1, dev)
        if tb.retry is None:
            if c:
                ch = np.concatenate([np.asarray(o, np.int32).reshape(-1) for o in ck.outs])
                choices[0, : ch.size] = torch.as_tensor(ch, device=dev)
            if ck.released is not None:
                have = released_through(plan, choices[0].cpu().numpy(), c, self.pods.num_pods)
                if not np.array_equal(have, np.asarray(ck.released, bool)):
                    raise ValueError(
                        "checkpoint's released mask is not the one this engine's completions "
                        "plan implies at its cursor: it was written with another completions "
                        "setting, chunk grid or trace")
        else:
            self._restore_boundary(ck.boundary, tb, choices, c)
        if tb.shards is not None:
            gdom = torch.as_tensor(ref.group_domains(self._dev_ec)[0], device=dev)  # [G, n_pad]
            cols = torch.nonzero(choices[0] >= 0).flatten()
            tb.shards.cdom[0, cols] = gdom[:, choices[0, cols].long()].T
        if events:
            steps = ref.event_steps([events], plan.tb, self.ec.allocatable)
            fired = 0
            rows = tb.cluster.allocatable.view(-1, tb.cluster.allocatable.shape[-1])
            for b in sorted(steps):
                if b < c:
                    rows.index_copy_(0, torch.as_tensor(steps[b].rows, device=dev),
                                     torch.as_tensor(steps[b].vals, device=dev))
                    fired += len(steps[b].fired[0])
            cur = (ck.boundary or {}).get("ev_cursor")
            if cur is not None and int(np.asarray(cur).reshape(-1)[0]) != fired:
                raise ValueError(
                    f"checkpoint's event cursor ({int(np.asarray(cur).reshape(-1)[0])}) is not "
                    f"the {fired} events this engine fires before chunk {c}")
        return c, choices

    def _restore_boundary(self, bd: dict, tb: ref.Tables, choices: torch.Tensor, c: int) -> None:
        """Rebuild the retry tables of scenario 0 and the choice buffer from
        a boundary blob (the inverse of :meth:`_boundary_blob`): a pod bound
        in its wave or pre-bound and never unbound (its ``bind_chunk`` not
        NEVER) takes its node in its column, every other placed pod as its
        retried node, with its pending entry's boundary in ``rrel``
        (``c − 1`` where its release came, NEVER where none was listed); the
        queue, the pending list, the counters and the evictions as saved.
        The blob holds no bind boundaries: a restored retried pod's
        ``rbind_b`` and ``first_b`` are ``c − 1`` (telemetry only)."""
        from .checkpoint import BIND_NEVER

        plan, ep, rt, dev = self.plan, self.pods, tb.retry, self.device
        P = ep.num_pods
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
        asg = np.asarray(bd["assignments"], np.int32)
        released = np.asarray(bd["released"], bool)
        col_of = plan.col_of(P)
        live = (np.asarray(bd["bind_chunk"]) != BIND_NEVER) & (asg >= 0) & (col_of >= 0)
        ch = np.full(plan.L, PAD, np.int32)
        ch[col_of[live]] = asg[live]
        if not np.array_equal(released[live], plan.col_relb[col_of[live]] < c):
            raise ValueError("checkpoint's released mask is not the one this engine's "
                             "completions plan implies at its cursor: it was written for "
                             "another trace")
        choices[0].copy_(t(ch))
        retried = ~live & (asg >= 0)
        pend = np.asarray(bd["pend"], np.int64).reshape(-1, 3)
        RB = rt.rbuf.shape[1]
        q = np.asarray(bd["retry_q"], np.int64)
        if len(q) > RB or len(pend) > RB:
            raise ValueError(f"checkpoint's retry queue ({len(q)}) or pending list "
                             f"({len(pend)}) exceeds this engine's buffer of {RB}")
        rnode = np.full(P, PAD, np.int32)
        rnode[retried] = asg[retried]
        rrel = np.full(P, ref.NEVER, np.int32)
        rrel[retried & released] = c - 1
        rrel[pend[:, 1]] = pend[:, 0]
        at = np.full(P, PAD, np.int32)
        at[retried] = c - 1
        row = lambda vals: np.concatenate([vals, np.full(RB - len(vals), PAD)]).astype(np.int32)
        for name, vals in (("rnode", rnode), ("rbind_b", at), ("rrel", rrel), ("first_b", at),
                           ("rbuf", row(q)), ("pend_id", row(pend[:, 1])),
                           ("pend_node", row(pend[:, 2])), ("pend_relb", row(pend[:, 0]))):
            getattr(rt, name)[0].copy_(t(vals))
        counters = np.asarray(bd["counters"], np.int64)
        rt.rcount[0] = len(q)
        rt.rdrop[0] = int(counters[2])
        if rt.preempt is not None:
            rt.preempt[0] = int(counters[1])
        if rt.evict_t is not None:
            chaos = np.asarray(bd.get("chaos", np.zeros(2)), np.int64)
            times = np.asarray(bd.get("evict_times", np.zeros((0, 2))), np.float64).reshape(-1, 2)
            et = np.full(P, -1.0, np.float64)
            et[times[:, 0].astype(np.int64)] = times[:, 1]
            rt.evict_t[0].copy_(t(et))
            rt.evictions[0], rt.resched[0] = int(chaos[0]), int(chaos[1])
            rt.evict_lat[0] = float(np.asarray(bd.get("evict_lat", [0.0])).reshape(-1)[0])

    def _open_recorder(self):
        """(recorder, owns) of this replay: a fresh stream from the
        configured spec (owns: this replay closes it), a live recorder the
        caller passed (not owned), or (None, False) — off. The ``start``
        row carries the reference's metadata (sim/jax_runtime.py:1303-1316)."""
        from .flight import FlightRecorder, FlightRecorderConfig

        spec = FlightRecorderConfig.resolve(self.flight_recorder)
        if spec is None:
            return None, False
        if isinstance(spec, FlightRecorder):
            return spec, False
        meta = {
            "nodes": int(self.ec.num_nodes),
            "pods": int(self.pods.num_pods),
            "node_shards": int(self.node_shards),
            "paged": bool(self.paged),
            "engine": self.engine,
            "chunk_waves": int(self.chunk_waves),
            "resident_bytes": int(replicated_resident_bytes(
                self.ec, self.pods, pods_resident=(self.engine == "v3" and not self.paged))),
        }
        self._last_flight = FlightRecorder(spec, meta=meta)
        return self._last_flight, True


def released_through(plan: ChunkPlan, ch: np.ndarray, cursor: int, P: int) -> np.ndarray:
    """[P] bool: the pods whose completion release boundaries ``0 ..
    cursor − 1`` applied, from a choice buffer row ``ch [L]``: a placed
    column whose static release boundary comes before ``cursor`` (the
    reference's ``released`` mask of its plain path)."""
    col_pod = plan.col_pod
    m = (col_pod >= 0) & (ch >= 0) & (plan.col_relb < cursor)
    out = np.zeros(P, bool)
    out[col_pod[m]] = True
    return out


def rebuild_fork_state(pods: EncodedPods, idx: np.ndarray, C: int, outs, wave_times: np.ndarray,
                       upto_chunk: int, slack: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """(host_assign [P], released [P]) of a replay through chunk
    ``upto_chunk − 1`` from its saved per-chunk choices ``outs``, and the
    completions it released at each boundary: a pod placed in a chunk ≤ b −
    1 − ``slack`` (pre-bound: chunk −2) whose arrival + duration is at or
    before boundary b's start time. The counterpart of
    kubernetes_simulator_tpu/sim/jax_runtime.py:828-868; the fork of a file
    without a released mask (written before the field) reconstructs it so,
    with ``slack`` 0 as the reference does."""
    host_assign = np.where(pods.bound_node >= 0, pods.bound_node, PAD).astype(np.int32)
    chunk_of = np.where(pods.bound_node >= 0, -2, 1 << 30).astype(np.int64)
    rel_time = release_times(pods)
    for cj in range(upto_chunk):
        rows = idx[cj * C : (cj + 1) * C]
        ch = np.asarray(outs[cj]).reshape(rows.shape)
        v = rows >= 0
        host_assign[rows[v]] = ch[v]
        chunk_of[rows[v]] = cj
    released = np.zeros(pods.num_pods, bool)
    for b in range(upto_chunk):
        tb = wave_times[b * C]
        if np.isfinite(tb):
            released |= ((host_assign != PAD) & (chunk_of < b - slack)
                         & np.isfinite(rel_time) & (rel_time <= tb))
    return host_assign, released


def _timeline_hash(events: list) -> np.ndarray:
    """The reference's ``ev_hash`` of a timeline: :func:`.runtime.events_hash`
    of the events sorted by time (stably), as its replay sorts them."""
    from .runtime import events_hash

    return events_hash(sorted(events, key=lambda e: e.time))


def _file_bytes(path: str) -> int:
    """A file's size (0 where it cannot be read: observation never fails
    the replay; sim/jax_runtime.py:102)."""
    import os

    try:
        return os.path.getsize(path)
    except OSError:
        return 0


def chaos_counters(rt: Optional[ref.Retry]) -> Tuple[np.ndarray, ...]:
    """``(evictions, evict_rescheduled, evict_stranded, evict_latency_mean)``
    of each scenario (``[S]`` each; the reference's ``BoundaryOps``
    counters, sim/boundary.py:401-428): NoExecute victims, their re-binds,
    those still displaced at the end (an eviction time never cleared) and
    the f64 mean latency of the re-binds (0 without one). Zeros without a
    chaos timeline's records."""
    if rt is None or rt.evict_t is None:
        S = rt.rbuf.shape[0] if rt is not None else 1
        z = np.zeros(S, np.int32)
        return z, z, z, np.zeros(S, np.float64)
    resched = rt.resched.cpu().numpy()
    lat = rt.evict_lat.cpu().numpy()
    mean = np.zeros(resched.shape, np.float64)
    for s in np.nonzero(resched)[0]:
        mean[s] = float(lat[s]) / int(resched[s])
    return (rt.evictions.cpu().numpy(), resched,
            (rt.evict_t >= 0).sum(dim=1).to(torch.int32).cpu().numpy(), mean)


@register_strategy("torch")
def _make_torch(ec: EncodedCluster, pods: EncodedPods, config: Optional[FrameworkConfig] = None, **kw):
    return TorchReplayEngine(ec, pods, config, **kw)
