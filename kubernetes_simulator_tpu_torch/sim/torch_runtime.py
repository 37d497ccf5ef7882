"""The ``torch`` scheduling strategy: the single-scenario replay on the
card, through the hand-written kernels of :mod:`..ops.kernels`.

Counterpart: ``kubernetes_simulator_tpu/sim/jax_runtime.py`` —
``StepSpec`` (:122, with ``from_config``), ``_spread_norm_f32_ok`` (:215),
``_spread_w_table`` (:236), ``wave_start_times`` (:764), the plain path
of ``JaxReplayEngine.replay`` (:2012) with the chunk program
``make_chunk_fn3_src`` (:742), and ``_apply_release`` (:1414). The
one-chunk-slack side of ``bind_chunk_of`` (:773) is the fold lag of the
chunk loop, as on the reference's plain path.

Semantics are :mod:`kubernetes_simulator_tpu.sim.greedy`'s
``greedy_replay`` exactly (the parity anchor of both packages):
arrival-order waves of W slots; within a wave, slots run in order and each
sees the speculative binds of the slots before it; at the wave end a gang
commits whole or rolls back; completed pods release at chunk boundaries
under the one-chunk-slack rule (boundary b sees the binds of chunks
≤ b−2). Unlike the reference's v3 program, which commits a wave's ``used``
in one reduction, the port adds per pod, as ``greedy_replay`` does.

Per slot the host enqueues K1 (filter_score) → K2 (normalize_select) → K3
(apply_placements, bind) on the current stream; K2 writes the choice to a
device array and K3 reads it there, so nothing returns to the host per
pod. A wave holding gang members ends with a K3 rollback. The host
synchronises once per chunk, to fetch that chunk's choices for the release
bookkeeping and the result.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Optional, Tuple

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
from ..utils.metrics import fragmentation_gauges, utilization_means
from .runtime import ReplayResult
from .telemetry import PhaseTimers, ReplayTelemetry, latency_summary, resolve_granularity
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

    def consts(self) -> ref.StepConsts:
        """The kernels' static constants, every float rounded to f32 the
        way the reference's weak-typed arithmetic rounds it."""
        w = dict(self.weights)
        f32 = lambda v: float(np.float32(v))
        on = lambda name: w.get(name, 1.0) != 0
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
        f"{what} is not ported yet ({slice_}); the PyTorch engine runs the "
        "plain single-scenario replay — use the JAX package for it"
    )


class TorchReplayEngine:
    """Single-scenario replay of an encoded trace on one device.

    ``device`` defaults to ``"cuda"`` (the kernels); ``device="cpu"`` runs
    the kernels' plain twins. ``plain=True`` runs the twins on any device
    (a reference run for holding the kernel path against; the wrappers
    never fall back on their own). ``completions`` (None = on when the
    trace has finite durations) and ``granularity_guard`` behave as in
    ``JaxReplayEngine``; ``telemetry`` is "off" or "summary". Every other
    mode of the JAX engine raises ``NotImplementedError`` naming it."""

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
        if engine != "v3":
            raise _later(f"engine={engine!r} (the v2 node-space chain)", "queue B row B8")
        if preemption not in (False, None):
            raise _later(f"preemption={preemption!r}", "tier preemption, queue B row B10")
        if retry_buffer:
            raise _later("retry_buffer", "boundary retry and kube modes")
        if node_shards and int(node_shards) > 1:
            raise _later("node_shards", "node sharding, queue B row B13")
        if paged:
            raise _later("paged=True", "the paged pod pager")
        if flight_recorder is not None:
            raise _later("flight_recorder", "the flight recorder")
        self.telemetry = resolve_granularity(telemetry)
        self.device = resolve_device(device)
        self.ec = ec
        self.pods = pods
        self.spec = StepSpec.from_config(ec, config, pods)
        self.consts = self.spec.consts()
        self.chunk_waves = int(chunk_waves)
        self.wave_width = 8 if wave_width == "auto" else int(wave_width)
        if self.wave_width > 1024:
            raise ValueError("wave_width must be <= 1024 (one rollback block)")
        self.completions = completions
        self.granularity_guard = granularity_guard
        self.plain = bool(plain)
        self.waves = pack_waves(pods, self.wave_width)
        self._cluster = ref.cluster_to(ec, self.device)
        self._pods = ref.pods_to(pods, self.device)

    # -- one replay --------------------------------------------------------

    def _tables(self) -> ref.Tables:
        st = init_state(self.ec, self.pods)
        t = lambda a: torch.tensor(a, dtype=torch.float32, device=self.device)
        state = ref.DevState(
            used=t(st.used), match_count=t(st.match_count),
            anti_active=t(st.anti_active), pref_wsum=t(st.pref_wsum),
        )
        return ref.Tables(
            cluster=self._cluster, pods=self._pods, state=state,
            scratch=ref.new_scratch(self.ec.num_nodes, self.device), consts=self.consts,
        )

    def replay(
        self,
        checkpoint_path: Optional[str] = None,
        checkpoint_every: int = 0,
        resume: bool = False,
        node_events=None,
    ) -> ReplayResult:
        if checkpoint_path or checkpoint_every or resume:
            raise _later("checkpoint/resume", "engine modes, queue A item 6")
        if node_events:
            raise _later("node_events", "chaos node events, queue A item 6")
        ep = self.pods
        chunk_req = self.chunk_waves
        if self.completions is not False:
            from .granularity import guard

            chunk_req, _ = guard(
                ep, self.waves.idx, chunk_req, 0,
                enabled=self.granularity_guard, engine_name="torch replay engine",
            )
        idx = self.waves.idx
        W = idx.shape[1]
        C = min(chunk_req, max(idx.shape[0], 1))
        pad_to = ((idx.shape[0] + C - 1) // C) * C
        if pad_to != idx.shape[0]:
            idx = np.concatenate(
                [idx, np.full((pad_to - idx.shape[0], W), PAD, np.int32)]
            )
        timers = PhaseTimers() if self.telemetry != "off" else None
        tick = timers.tick if timers is not None else (lambda name: contextlib.nullcontext())

        tb = self._tables()
        dev = self.device
        if self.plain:
            filter_score = ref.filter_score
            normalize_select = ref.normalize_select
            apply_placements = ref.apply_placements
            handle = tb
        else:
            filter_score = K.filter_score
            normalize_select = K.normalize_select
            apply_placements = K.apply_placements
            handle = K.Bound(tb)
        flat_idx = idx.reshape(-1).astype(np.int32)
        idx_dev = torch.as_tensor(flat_idx, device=dev)
        choices = torch.full((flat_idx.size,), PAD, dtype=torch.int32, device=dev)
        gang_wave = (
            ((np.where(idx >= 0, ep.group_id[np.clip(idx, 0, None)], PAD)) >= 0).any(axis=1)
            if self.spec.has_gangs
            else np.zeros(idx.shape[0], bool)
        )
        rel_time = ep.arrival + np.where(np.isfinite(ep.duration), ep.duration, np.inf)
        completions_on = bool(self.completions is not False and np.isfinite(rel_time).any())
        wave_times = wave_start_times(ep, idx) if completions_on else None
        host_assign = np.where(ep.bound_node >= 0, ep.bound_node, PAD).astype(np.int32)
        released = np.zeros(ep.num_pods, bool)
        on_cuda = dev.type == "cuda"
        fetched = []  # per chunk: (host choices, event or None)
        pending_fold = None  # (chunk rows, host choices, event) not yet folded

        def _fold(rows, ch, ev):
            if ev is not None:
                ev.synchronize()
            ch = ch.numpy().reshape(rows.shape)
            v = rows >= 0
            host_assign[rows[v]] = ch[v]

        t0 = time.perf_counter()
        for c0 in range(0, idx.shape[0], C):
            if completions_on:
                t_chunk = wave_times[c0]
                if np.isfinite(t_chunk):
                    due_p = np.nonzero(
                        (host_assign != PAD) & ~released & np.isfinite(rel_time)
                        & (rel_time <= t_chunk)
                    )[0]
                    if due_p.size:
                        with tick("host_mirror"):
                            apply_placements(
                                handle,
                                torch.as_tensor(due_p.astype(np.int32), device=dev),
                                torch.as_tensor(host_assign[due_p], device=dev),
                                -1.0,
                            )
                        released[due_p] = True
            with tick("dispatch"):
                for w in range(c0, c0 + C):
                    base = w * W
                    for k, p in enumerate(idx[w].tolist()):
                        if p < 0:
                            continue
                        s = base + k
                        filter_score(handle, p)
                        normalize_select(handle, p, choices[s : s + 1])
                        apply_placements(handle, idx_dev[s : s + 1], choices[s : s + 1], 1.0)
                    if gang_wave[w]:
                        apply_placements(
                            handle, idx_dev[base : base + W], choices[base : base + W],
                            -1.0, rollback=True,
                        )
                sl = choices[c0 * W : (c0 + C) * W]
                if on_cuda:
                    host = torch.empty(sl.shape, dtype=torch.int32, pin_memory=True)
                    host.copy_(sl, non_blocking=True)
                    ev = torch.cuda.Event()
                    ev.record()
                else:
                    host, ev = sl.clone(), None
            fetched.append((host, ev))
            if completions_on:
                # Fold the previous chunk after enqueuing this one: boundary
                # b only ever sees chunks <= b-2 (the one-chunk slack).
                if pending_fold is not None:
                    with tick("boundary_fold"):
                        _fold(*pending_fold)
                pending_fold = (idx[c0 : c0 + C], host, ev)
        with tick("device_wait"):
            if on_cuda:
                torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0

        flat_choice = torch.cat([h for h, _ in fetched]).numpy() if fetched else np.zeros(0, np.int32)
        assignments = np.where(ep.bound_node >= 0, ep.bound_node, PAD).astype(np.int32)
        valid = flat_idx >= 0
        assignments[flat_idx[valid]] = flat_choice[valid]
        placed = int((flat_choice[valid] >= 0).sum())
        to_schedule = int(valid.sum())

        st = tb.state
        used = st.used.cpu().numpy()
        host_state = SchedState(
            used=used,
            match_count=st.match_count.cpu().numpy(),
            anti_active=st.anti_active.cpu().numpy(),
            pref_wsum=st.pref_wsum.cpu().numpy(),
            bound=assignments.copy(),
        )
        util = utilization_means(used, self.ec.allocatable, self.ec.vocab._r)
        pending_m = (ep.bound_node == PAD) & (assignments == PAD)
        frag = fragmentation_gauges(
            self.ec.allocatable, used, ep.requests[pending_m], self.ec.vocab._r
        )
        tel = None
        if timers is not None:
            # Every plain-path placement binds in its arrival wave: latency 0.
            tel = ReplayTelemetry(
                granularity=self.telemetry,
                latency=latency_summary(placed, []),
                phases=timers.summary(),
            )
        return ReplayResult(
            assignments=assignments,
            placed=placed,
            unschedulable=to_schedule - placed,
            preemptions=0,
            attempts=to_schedule,
            wall_clock_s=wall,
            placements_per_sec=placed / wall if wall > 0 else 0.0,
            virtual_makespan=float(ep.arrival.max()) if ep.num_pods else 0.0,
            utilization=util,
            state=host_state,
            fragmentation=frag,
            telemetry=tel,
        )


@register_strategy("torch")
def _make_torch(ec: EncodedCluster, pods: EncodedPods, config: Optional[FrameworkConfig] = None, **kw):
    return TorchReplayEngine(ec, pods, config, **kw)
