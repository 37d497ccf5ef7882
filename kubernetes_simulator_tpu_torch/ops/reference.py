"""Plain-PyTorch scheduling chain and the plain twins of the kernels.

Counterpart: ``kubernetes_simulator_tpu/ops/cpu.py`` (all of it: the
per-plugin Filter/Score arithmetic over ``[N]`` node vectors) and
``kubernetes_simulator_tpu/ops/tpu.py`` (``_int_resource_score`` :617,
``spread_norm_from_extrema`` :565, ``_normalize_row`` :699,
``select_node`` :739), re-expressed in torch over the device data model
below. Every expression keeps the reference's operation order, so the
floor-quantized integer-valued f32 scores are bit-identical to the numpy
and JAX chains and argmax ties break on the lowest index.

Three functions are the plain twins of the hand-written kernels in
``csrc/`` (``ops/kernels.py`` wraps both):

- :func:`filter_score` — K1: fused feasibility mask + raw score rows of
  one pod over all nodes of every scenario;
- :func:`normalize_select` — K2: per-plugin normalization, weighted total
  and the lowest-index argmax of every scenario, written to a device
  int32 choice buffer;
- :func:`apply_placements` — K3: ±contribution of K (pod, node) pairs to
  every scenario's carried state (bind, gang rollback, completion
  release), each scenario's node read from its row of the choice buffer.

:func:`chunk_replay` is the plain twin of K6 (``csrc/chunk_replay.cu``):
one chunk's waves walked through the three twins above in K6's order, and
in its retry mode the boundary's :func:`retry_pass` first.
Under node shards, :func:`shard_select` and :func:`shard_apply` are the
twins of K7 and K8, and :func:`shard_chunk_replay` the twin of K9
(``csrc/shard_chunk_replay.cu``): one chunk's waves walked through K1's,
K7's and K8's twins in K9's order.

The fifth twin, :func:`first_reject` (K5, ``csrc/first_reject.cu``), is
the series telemetry's first-reject attribution: the per-plugin Filter
masks of failed slots, in ``spec_plugin_names`` order, counted into the
Tables' ``reject`` counters.

Under a chaos timeline (a Retry with ``evict_t``; the host schedule is
:func:`event_steps`) :func:`evict_node` is the twin of K10
(``csrc/evict_node.cu``): a ``node_down``'s NoExecute eviction before the
boundary's releases; the retry pass's binds then count each victim's
re-bind (:func:`chaos_rebind`).

Under the unschedulable-retry buffer (a Tables with ``retry``) the three
take one pod per scenario (the retry pass over the buffer), K3 also
appends a failed non-gang pod to its scenario's buffer and releases the
due entries of the pending list, and a fourth twin,
:func:`retry_boundary` (K4, ``csrc/retry_boundary.cu``), does the
boundary's bookkeeping. Under kube preemption (a Retry with ``prio``) the
pass runs until its queue is empty, a pod that still fails runs
:func:`post_filter` (the twin of K6's ``ksim_post_filter``), and the
victims' rewind, cancellations and requeue, the binds' records and the
pending appends happen in the pass, in bind order (:func:`retry_pass`).

Every table carries a leading scenario dimension S (the what-if batch of
``sim/whatif.py``; the single-scenario replay is S = 1): the state
``[S, ...]``, the scratch rows ``[S, ...]`` and, per scenario or shared,
the allocatable and the taints. The label tables (expression matches,
node domains, domain counts, spread weights) are a stack of L rows and
scenario s reads row ``lrow[s]``: row 0 is the base cluster, and each
scenario whose ``set_label`` perturbations relabel nodes has a row of its
own. Each scenario's arithmetic is the single-scenario chain's, element
for element, so slice s of a batched twin equals the same twin at S = 1
on scenario s's tables.

With per-scenario policy rows (``Tables.wrow [S, 6]``, :mod:`.policy`)
the K1 twin takes each scenario's NodeResourcesFit strategy from its row's
selector and the K2 twin weights the normalized rows with its row's
columns 0–4 (ops/tpu.py:62 ``policy_weight_fns``, ops/tpu3.py:1316-1329).

The twins run on any device; the wrappers take them only for CPU tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models.core import Effect, Operator
from ..models.encode import PAD, TOL_PAD, TOL_WILDCARD, EncodedCluster, EncodedPods
from .policy import IDX_FIT_LEAST, TRACED_FIT_STRATEGIES

MAX_NODE_SCORE = 100.0

#: Rows of the per-slot score block (csrc/ksim.cuh KSIM_ROW_*).
ROW_FIT, ROW_TAINT, ROW_NA, ROW_IP, ROW_SPREAD = range(5)
NUM_ROWS = 5

#: NodeResourcesFit scoring strategies (csrc/ksim.cuh fit_strategy codes).
FIT_STRATEGIES = ("LeastAllocated", "MostAllocated", "RequestedToCapacityRatio")


# ---------------------------------------------------------------------------
# Device data model
# ---------------------------------------------------------------------------


class DevCluster(NamedTuple):
    """Static node-side tensors (device copies of EncodedCluster plus the
    derived expression-match matrix and per-group domain maps). The
    allocatable and the taints are either shared by every scenario
    (``[N, *]``) or stacked per scenario (``[S, N, *]``, the what-if
    ScenarioSet). The label tables are L rows (L = 1 unless a what-if
    scenario relabels nodes) and scenario s reads row ``lrow[s]``."""

    allocatable: torch.Tensor  # [N, R] or [S, N, R] f32
    taint_key: torch.Tensor  # [N, TT] or [S, N, TT] i32
    taint_kv: torch.Tensor  # like taint_key
    taint_effect: torch.Tensor  # like taint_key
    expr_match: torch.Tensor  # [L, N, E] bool
    gdom: torch.Tensor  # [L, G, N] i32 domain of node n under group g's key (PAD)
    gnd: torch.Tensor  # [L, G] i32 domain count of group g's key
    sp_w: torch.Tensor  # [L, G] f32 spread topologyNormalizingWeight
    lrow: torch.Tensor  # [S] i32 the label row of each scenario


class DevPods(NamedTuple):
    """Encoded pod tables resident on the device (indexed by pod id)."""

    requests: torch.Tensor  # [P, R] f32
    tol_key: torch.Tensor  # [P, TO] i32
    tol_kv: torch.Tensor
    tol_effect: torch.Tensor
    na_req: torch.Tensor  # [P, TR, TE] i32
    na_has_req: torch.Tensor  # [P] bool
    na_pref: torch.Tensor  # [P, TP, TE] i32
    na_pref_w: torch.Tensor  # [P, TP] f32
    aff_req: torch.Tensor  # [P, AR] i32
    anti_req: torch.Tensor  # [P, AA] i32
    pref_aff: torch.Tensor  # [P, PA] i32
    pref_aff_w: torch.Tensor  # [P, PA] f32
    spread_g: torch.Tensor  # [P, SP] i32
    spread_skew: torch.Tensor  # [P, SP] i32
    spread_dns: torch.Tensor  # [P, SP] bool
    pmg: torch.Tensor  # [P, G] bool
    group_id: torch.Tensor  # [P] i32


class DevState(NamedTuple):
    """Carried scheduling state of S scenarios, each in the host layout of
    models.state (updated in place by :func:`apply_placements` / the K3
    kernel)."""

    used: torch.Tensor  # [S, N, R] f32
    match_count: torch.Tensor  # [S, G, D] f32
    anti_active: torch.Tensor  # [S, G, D] f32
    pref_wsum: torch.Tensor  # [S, G, D] f32


class Scratch(NamedTuple):
    """Per-slot K1 outputs, K2 inputs (reused slot after slot: launches
    are ordered on one stream)."""

    feasible: torch.Tensor  # [S, N] bool
    scores: torch.Tensor  # [S, NUM_ROWS, N] f32
    ignored: torch.Tensor  # [S, N] bool


@dataclass(frozen=True)
class StepConsts:
    """Static step constants, resolved once per engine from the StepSpec
    (sim.torch_runtime.StepSpec.consts)."""

    fit: bool
    taints: bool
    node_affinity: bool
    interpod: bool
    spread: bool
    on_fit: bool  # the row enters the weighted total
    on_taint: bool
    on_na: bool
    on_ip: bool
    on_sp: bool
    has_symmetric_pref: bool
    sp_norm_f32: bool
    fit_strategy: int  # index into FIT_STRATEGIES
    res_w: Tuple[float, ...]  # [R] f32 resource weights (non-zero enter)
    wsum: float  # f32 of the f64 sum of the non-zero weights
    w_fit: float  # f32 plugin weights
    w_taint: float
    w_na: float
    w_ip: float
    w_sp: float
    # RequestedToCapacityRatio shape, per segment i (f32, host-computed
    # exactly as ops/cpu.piecewise_interp_int does)
    seg_x0: Tuple[float, ...]
    seg_x1: Tuple[float, ...]
    seg_y0: Tuple[float, ...]
    seg_inv: Tuple[float, ...]  # f32(1) / (x1 - x0)
    seg_dy: Tuple[float, ...]  # y1 - y0
    x_first: float
    y_first: float
    y_last: float


class Preempt(NamedTuple):
    """Tier preemption (sim/tiers.py) of S scenarios: the static tier and
    choice-buffer tables, the tier planes and the per-scenario eviction
    state (ops/tpu3.py:483-533, ``DevState3.used_tier`` / ``npods_tier``,
    S-stacked; here in the port's ``[N, R]`` layout). None in a Tables
    when preemption is off, which leaves the three kernels' work as it
    was."""

    pod_tier: torch.Tensor  # [P] i32 tier index (0 = lowest priority)
    tier_host: np.ndarray  # [P] i32, the same on the host
    eligible: np.ndarray  # [P] bool, host: non-gang with tier > 0 (may preempt)
    col_pod: torch.Tensor  # [L] i32 pod of each choice-buffer column (PAD: padded slot)
    col_relb: torch.Tensor  # [L] i32 boundary at which that pod releases (INT32_MAX: never)
    n_slots: int  # first column of the pre-bound tail
    used_tier: torch.Tensor  # [S, Tt, N, R] f32 usage of the bound non-gang pods by tier
    npods_tier: torch.Tensor  # [S, Tt, N] f32 their count
    cand: torch.Tensor  # [S, N] f32 K1's candidate row (victims·1024 + max tier, or inf)
    last_wave: torch.Tensor  # [S] i32 the wave of each scenario's last preemption
    ev_node: torch.Tensor  # [S] i32 K2's eviction record for the slot (PAD: none)
    ev_tier: torch.Tensor  # [S] i32 the preempting pod's tier
    victims: torch.Tensor  # [S] i32 victims so far


NEVER = np.iinfo(np.int32).max


def new_preempt(pod_tier: np.ndarray, group_id: np.ndarray, col_pod: np.ndarray,
                col_relb: np.ndarray, n_slots: int, used_tier: np.ndarray,
                npods_tier: np.ndarray, S: int, device) -> Preempt:
    """A Preempt of S scenarios on ``device``, each starting from the host
    tier planes (``[Tt, N, R]`` / ``[Tt, N]``) and no eviction."""
    t = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=device)
    rep = lambda a: t(a, torch.float32)[None].repeat(S, *([1] * a.ndim)).contiguous()
    i32 = torch.int32
    return Preempt(
        pod_tier=t(pod_tier, i32), tier_host=np.asarray(pod_tier, np.int32),
        eligible=(np.asarray(group_id) < 0) & (np.asarray(pod_tier) > 0),
        col_pod=t(col_pod, i32), col_relb=t(col_relb, i32), n_slots=int(n_slots),
        used_tier=rep(used_tier), npods_tier=rep(npods_tier),
        cand=torch.full((S, used_tier.shape[1]), float("inf"), dtype=torch.float32,
                        device=device),
        last_wave=torch.full((S,), -1, dtype=i32, device=device),
        ev_node=torch.full((S,), PAD, dtype=i32, device=device),
        ev_tier=torch.zeros((S,), dtype=i32, device=device),
        victims=torch.zeros((S,), dtype=i32, device=device),
    )


class Retry(NamedTuple):
    """The unschedulable-retry buffer of S scenarios (the retry variant of
    kubernetes_simulator_tpu/sim/whatif.py:1406-1557, S-stacked; the
    host FIFO of sim/boundary.py:350-678): a per-scenario FIFO of failed
    non-gang pods, the pending list of the releases of pods placed on
    retry, and each pod's retried bind. None in a Tables when the buffer
    is off, which leaves the kernels' work as it was."""

    dur: torch.Tensor  # [P] f32 pod durations (inf: runs on)
    tbt: torch.Tensor  # [B] f32 start times of the finite boundaries
    rbuf: torch.Tensor  # [S, RB] i32 buffered pods in FIFO order, then PAD
    rcount: torch.Tensor  # [S] i32 buffered pods
    rdrop: torch.Tensor  # [S] i32 failures dropped on a full buffer
    rchoice: torch.Tensor  # [S, RB] i32 the retry pass's choice per buffer slot
    pend_id: torch.Tensor  # [S, RB] i32 pending releases in list order, then PAD
    pend_node: torch.Tensor  # [S, RB] i32 their nodes
    pend_relb: torch.Tensor  # [S, RB] i32 the boundary at which each releases
    rnode: torch.Tensor  # [S, P] i32 each pod's node from the retry pass (PAD: none)
    rbind_b: torch.Tensor  # [S, P] i32 the boundary of that bind
    # Kube preemption (sim/boundary.py:547-678 with kube=True; None: off).
    # A pod's current node is its retried node while its pending release
    # has not come (rrel > b), else its choice-buffer column's node until
    # that column's static release (col_relb > b).
    prio: Optional[torch.Tensor] = None  # [P] i32 raw priority (not the tier index)
    col_of: Optional[torch.Tensor] = None  # [P] i32 each pod's choice-buffer column (PAD: none)
    col_relb: Optional[torch.Tensor] = None  # [L] i32 each column's static release boundary
    #: [S, P] i32 the boundary at which a retried pod's pending release
    #: fires (NEVER: it holds its node to the end)
    rrel: Optional[torch.Tensor] = None
    #: [S, P] i32 each pod's first bind: PAD none or in its wave (or
    #: pre-bound) and never evicted, -2 in its wave (or pre-bound) and
    #: evicted since, b >= 0 through the retry pass at boundary b
    first_b: Optional[torch.Tensor] = None
    preempt: Optional[torch.Tensor] = None  # [S] i32 victims so far
    #: any required anti-affinity in the trace (the PostFilter's fast path
    #: is off for every pod)
    trace_has_anti: bool = False
    # Chaos node events (sim/boundary.py:401-475; None: no timeline). The
    # retry buffer without kube then carries col_of, col_relb, rrel and
    # first_b too (no prio): K10 derives each pod's node from them.
    #: [S, P] f64 the start time of the boundary that evicted the pod while
    #: it waits for a re-bind (-1: none)
    evict_t: Optional[torch.Tensor] = None
    evictions: Optional[torch.Tensor] = None  # [S] i32 NoExecute victims so far
    resched: Optional[torch.Tensor] = None  # [S] i32 evicted pods re-bound by the retry pass
    #: [S] f64 the sum, in bind order, of (re-bind boundary time − eviction
    #: time) over the re-binds at a finite boundary
    evict_lat: Optional[torch.Tensor] = None
    #: [B] f64 host start time of each boundary (a re-bind's time)
    tbd: Optional[np.ndarray] = None


#: first_b of a pod bound in its wave (or pre-bound) and evicted since.
FIRST_IN_WAVE = -2


def new_retry(RB: int, duration: np.ndarray, tbt: np.ndarray, S: int, device,
              kube: Optional[dict] = None, chaos: Optional[dict] = None,
              nodes: Optional[dict] = None) -> Retry:
    """An empty Retry of S scenarios with a buffer of RB slots on
    ``device``; ``kube`` (``prio [P]``, ``col_of [P]``, ``col_relb [L]``
    host arrays and ``trace_has_anti``) adds kube preemption's tables;
    ``chaos`` (``col_of``, ``col_relb`` and ``tbd``, the boundaries' f64
    start times) the chaos counters, and without kube the node tables K10
    reads (``col_of``, ``col_relb``, ``rrel``, ``first_b``); ``nodes``
    (``col_of``, ``col_relb``) those node tables alone (a checkpointing
    replay's, whose blob reads ``rrel``)."""
    P = int(np.asarray(duration).shape[0])
    i32 = torch.int32
    pad = lambda *shape: torch.full(shape, PAD, dtype=i32, device=device)
    rt = Retry(
        dur=torch.as_tensor(np.asarray(duration, np.float32), device=device),
        tbt=torch.as_tensor(np.ascontiguousarray(tbt, np.float32), device=device),
        rbuf=pad(S, RB), rcount=torch.zeros(S, dtype=i32, device=device),
        rdrop=torch.zeros(S, dtype=i32, device=device), rchoice=pad(S, RB),
        pend_id=pad(S, RB), pend_node=pad(S, RB), pend_relb=pad(S, RB),
        rnode=pad(S, P), rbind_b=pad(S, P),
    )
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.int32), device=device)
    nodes = kube if kube is not None else chaos if chaos is not None else nodes
    if nodes is not None:
        rt = rt._replace(col_of=t(nodes["col_of"]), col_relb=t(nodes["col_relb"]),
                         rrel=torch.full((S, P), NEVER, dtype=i32, device=device),
                         first_b=pad(S, P))
    if kube is not None:
        rt = rt._replace(prio=t(kube["prio"]), preempt=torch.zeros(S, dtype=i32, device=device),
                         trace_has_anti=bool(kube["trace_has_anti"]))
    if chaos is not None:
        f64 = torch.float64
        rt = rt._replace(
            evict_t=torch.full((S, P), -1.0, dtype=f64, device=device),
            evictions=torch.zeros(S, dtype=i32, device=device),
            resched=torch.zeros(S, dtype=i32, device=device),
            evict_lat=torch.zeros(S, dtype=f64, device=device),
            tbd=np.asarray(chaos["tbd"], np.float64))
    return rt


class Reject(NamedTuple):
    """First-reject attribution of S scenarios (telemetry ``series``: the
    carried ``[K]`` counters of kubernetes_simulator_tpu/sim/jax_runtime.py
    :405 make_wave_step_rej, and the episode set of sim/telemetry.py:338
    TelemetryCollector), in ``spec_plugin_names`` order. None in a Tables
    when attribution is off.

    An episode ends with a bind or an eviction (sim/telemetry.py
    ``clear_episode``): the kube pass clears ``attributed`` for each of its
    victims and each pod it binds, K10 for each NoExecute victim, so a pod
    unbound and failing again is charged to ``reasons`` again. Without kube
    or chaos no pod is unbound, and a bound pod is never attempted again."""

    reasons: torch.Tensor  # [S, K] i32 per unschedulable episode
    attempts: torch.Tensor  # [S, K] i32 per failed attempt
    attributed: torch.Tensor  # [S, P] u8 the pod's episode is charged to reasons


def new_reject(K: int, P: int, S: int, device) -> Reject:
    """Zero counters of K plugins for S scenarios of P pods on ``device``."""
    z = lambda *shape, dt=torch.int32: torch.zeros(shape, dtype=dt, device=device)
    return Reject(reasons=z(S, K), attempts=z(S, K), attributed=z(S, P, dt=torch.uint8))


#: EventLog record kinds (csrc/ksim.cuh KSIM_LOG_*), the reference's timeline
#: event names
LOG_KINDS = ("bind", "preempt", "evict")
LOG_BIND, LOG_PREEMPT, LOG_EVICT = range(3)


class EventLog(NamedTuple):
    """The timeline events of S scenarios that undo or redo a bind, in the
    order the reference emits them (sim/boundary.py:450-455, :585-591,
    :611-629): K10's ``evict`` records, and the retry pass's ``preempt``
    and ``bind`` records (the kube pass; the plain pass under a chaos
    timeline, where an evicted pod binds again). A record is (kind,
    boundary, pod, node); the host turns a boundary into its time. None in
    a Tables without a timeline of such events.

    ``n`` counts every record a scenario appended: past ``cap`` the record
    is dropped and the count goes on, so a full log is seen after the run
    (:func:`log_records` raises) and never silently cut."""

    rec: torch.Tensor  # [S, cap, 4] i32 (kind, boundary, pod, node) in append order
    n: torch.Tensor  # [S] i32 records appended (kept: min(n, cap))


def new_log(S: int, cap: int, device) -> EventLog:
    """An empty EventLog of ``cap`` records a scenario."""
    return EventLog(rec=torch.full((S, max(int(cap), 1), 4), PAD, dtype=torch.int32,
                                   device=device),
                    n=torch.zeros(S, dtype=torch.int32, device=device))


def log_append(log: Optional[EventLog], s: int, kind: int, b: int, pod: int, node: int) -> None:
    """Append one record to scenario s's log (a no-op without one)."""
    if log is None:
        return
    i = int(log.n[s])
    if i < log.rec.shape[1]:
        log.rec[s, i] = torch.tensor([kind, b, pod, node], dtype=torch.int32,
                                     device=log.rec.device)
    log.n[s] = i + 1


def log_records(log: EventLog, s: int) -> list:
    """Scenario s's records, ``[(kind name, boundary, pod, node), ...]`` in
    append order, fetched to the host; raises where the log filled."""
    n, cap = int(log.n[s]), log.rec.shape[1]
    if n > cap:
        raise RuntimeError(
            f"the timeline event log of scenario {s} filled: {n} records for a capacity of "
            f"{cap} (sim/torch_runtime.py log_capacity); no event was kept past it")
    return [(LOG_KINDS[k], b, p, v) for k, b, p, v in log.rec[s, :n].tolist()]


class RetrySamples(NamedTuple):
    """Where K6's retry mode copies a boundary's telemetry series samples
    after its retry sequence (sim/torch_runtime.py ``Series``): ``used``
    ``[S, N, R]`` f32, the buffer's count ``rcount [S]`` and the pending ids
    ``pend [S, RB]`` (all three None: none), and on the fold path the
    chunk-start planes ``snap`` (a DevState shaped as the state, or
    None)."""

    used: Optional[torch.Tensor]
    rcount: Optional[torch.Tensor]
    pend: Optional[torch.Tensor]
    snap: Optional[DevState]


class Tables(NamedTuple):
    """Everything a slot step reads or writes, on one device."""

    cluster: DevCluster
    pods: DevPods
    state: DevState
    scratch: Scratch
    consts: StepConsts
    preempt: Optional[Preempt] = None
    retry: Optional[Retry] = None
    reject: Optional[Reject] = None
    #: [S, len(POLICY_COLS)] f32 policy row of each scenario (ops/policy.py),
    #: None in static mode: K1 reads its fit strategy, K2 its Score weights
    wrow: Optional[torch.Tensor] = None
    #: node-plane shards (row B13, :class:`Shards`), None in the replicated
    #: layout
    shards: Optional["Shards"] = None
    #: the timeline's event log (:class:`EventLog`), None without one
    log: Optional[EventLog] = None


class Shards(NamedTuple):
    """The node-plane shards of a Tables (row B13; the layout of
    :mod:`..parallel.shards`): the tables' node axis is the padded axis of
    ``P · n_local`` nodes, shard p's block its rows ``[p · n_local, (p + 1) ·
    n_local)``, and a node of global id ``>= n_real`` is a pad row. The
    count planes stay replicated (one copy). The buffers carry what crosses
    shards, each written by one shard and read through an exchange."""

    P: int
    n_local: int
    n_real: int
    ext: torch.Tensor  # [S, P, NUM_EXT] f32 each shard's packed extrema (K7's exchange)
    best_v: torch.Tensor  # [S, P] f32 each shard's best total (K7's exchange)
    best_i: torch.Tensor  # [S, P] i32 its lowest global id (SHARD_NONE: none)
    #: [S, L, G] i32 the domain ids of each choice-buffer column's node under
    #: each group's key (PAD: unplaced or no domain), written by the owner
    #: shard when it wins the slot (K7) and read by the binds, gang
    #: rollbacks and releases of the replicated planes (K8)
    cdom: torch.Tensor


#: The (score, global id) pair of a shard with no feasible node: an i32 max
#: id (the reference's f32 2**31, ops/tpu.py:1366-1367), which loses every
#: fold on equal (−inf) scores.
SHARD_NONE = np.iinfo(np.int32).max


def _scenario_subset(tb: Tables, idx: torch.Tensor) -> Tables:
    """Copies of the scenarios ``idx`` of ``tb`` (their cluster rows where
    stacked, state and scratch) as a Tables of ``len(idx)`` scenarios."""
    cl = tb.cluster
    pick = lambda t: t[idx] if t.dim() == 3 else t
    return Tables(
        cl._replace(allocatable=pick(cl.allocatable), taint_key=pick(cl.taint_key),
                    taint_kv=pick(cl.taint_kv), taint_effect=pick(cl.taint_effect),
                    lrow=cl.lrow[idx]),
        tb.pods, DevState(*(x[idx] for x in tb.state)), Scratch(*(x[idx] for x in tb.scratch)),
        tb.consts, wrow=tb.wrow[idx] if tb.wrow is not None else None)


def _pods_of_scenarios(pod_of_s: torch.Tensor):
    """(pod, scenario index tensor) for each distinct pod >= 0 of a
    per-scenario pod row ``[S]``."""
    pods = pod_of_s.tolist()
    for q in sorted({v for v in pods if v >= 0}):
        yield q, torch.as_tensor([s for s, v in enumerate(pods) if v == q],
                                 device=pod_of_s.device)


def expr_match_matrix(ec: EncodedCluster, labels=None) -> np.ndarray:
    """``M[n, e]`` — does node n satisfy interned expression e ([K8S]
    semantics: In/Gt/Lt require the key present; NotIn/DoesNotExist also
    match when it is absent). Host numpy, once per engine (ops/cpu.py
    ``expr_match_matrix``). ``labels`` = (key, kv, num) ``[N, L]`` node
    label arrays (a what-if scenario's relabelled ones) in place of
    ``ec``'s."""
    lk, lv, ln = labels if labels is not None else (
        ec.node_label_key, ec.node_label_kv, ec.node_label_num)
    nk = lk[:, :, None]
    nv = lv[:, :, None]
    ek = ec.expr_key[None, None, :]
    key_present = np.any((nk == ek) & (nk != PAD), axis=1)
    in_set = np.any(
        (nv[:, :, :, None] == ec.expr_vals[None, None, :, :]) & (nv[:, :, :, None] != PAD),
        axis=(1, 3),
    )
    num = ln[:, :, None]
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


def group_domains(ec: EncodedCluster, node_domain: Optional[np.ndarray] = None,
                  num_domains: Optional[np.ndarray] = None
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host: (gdom [G, N] i32, gnd [G] i32, sp_w [G] f32) of ``ec``'s
    topology domains, or of the given ``node_domain [T, N]`` /
    ``num_domains [T]`` (a relabelled scenario's). ``sp_w`` is the
    upstream topologyNormalizingWeight ``log(size + 2)`` per group, f64 log
    cast once to f32 (ops/cpu.py spread_weight)."""
    nd = ec.node_domain if node_domain is None else node_domain
    ndom = ec.num_domains if num_domains is None else num_domains
    G = max(ec.num_groups, 1)
    gt = ec.group_topo[:G]
    if gt.shape[0] < G:
        gt = np.full(G, PAD, np.int32)
    safe = np.clip(gt, 0, None)
    gdom = np.where(gt[:, None] >= 0, nd[safe], PAD).astype(np.int32)
    gnd = np.where(gt >= 0, ndom[safe], 0).astype(np.int32)
    sp_w = np.log(gnd.astype(np.float64) + 2.0).astype(np.float32)
    return gdom, gnd, sp_w


def label_tables(ec: EncodedCluster, rows, device) -> dict:
    """The stacked label tables of a DevCluster, one row per entry of
    ``rows``: each a (labels, node_domain, num_domains) triple as
    :func:`expr_match_matrix` and :func:`group_domains` take them (None:
    ``ec``'s own)."""
    t = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=device)
    em, doms = [], []
    for labels, nd, ndom in rows:
        em.append(expr_match_matrix(ec, labels))
        doms.append(group_domains(ec, nd, ndom))
    gdom, gnd, sp_w = (np.stack(x) for x in zip(*doms))
    return dict(expr_match=t(np.stack(em), torch.bool), gdom=t(gdom, torch.int32),
                gnd=t(gnd, torch.int32), sp_w=t(sp_w, torch.float32))


def cluster_to(ec: EncodedCluster, device, S: int = 1) -> DevCluster:
    """``ec`` on ``device`` for S scenarios that all read its labels
    (one label row)."""
    t = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=device)
    return DevCluster(
        allocatable=t(ec.allocatable, torch.float32),
        taint_key=t(ec.taint_key, torch.int32),
        taint_kv=t(ec.taint_kv, torch.int32),
        taint_effect=t(ec.taint_effect, torch.int32),
        lrow=torch.zeros(S, dtype=torch.int32, device=device),
        **label_tables(ec, [(None, None, None)], device),
    )


def pods_to(ep: EncodedPods, device) -> DevPods:
    t = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=device)
    i32, f32, b = torch.int32, torch.float32, torch.bool
    return DevPods(
        requests=t(ep.requests, f32),
        tol_key=t(ep.tol_key, i32),
        tol_kv=t(ep.tol_kv, i32),
        tol_effect=t(ep.tol_effect, i32),
        na_req=t(ep.na_req, i32),
        na_has_req=t(ep.na_has_req, b),
        na_pref=t(ep.na_pref, i32),
        na_pref_w=t(ep.na_pref_w, f32),
        aff_req=t(ep.aff_req, i32),
        anti_req=t(ep.anti_req, i32),
        pref_aff=t(ep.pref_aff, i32),
        pref_aff_w=t(ep.pref_aff_w, f32),
        spread_g=t(ep.spread_g, i32),
        spread_skew=t(ep.spread_skew, i32),
        spread_dns=t(ep.spread_dns, b),
        pmg=t(ep.pod_matches_group, b),
        group_id=t(ep.group_id, i32),
    )


def new_scratch(S: int, N: int, device) -> Scratch:
    return Scratch(
        feasible=torch.zeros((S, N), dtype=torch.bool, device=device),
        scores=torch.zeros((S, NUM_ROWS, N), dtype=torch.float32, device=device),
        ignored=torch.zeros((S, N), dtype=torch.bool, device=device),
    )


def stacked_state(used, match_count, anti_active, pref_wsum, S: int, device) -> DevState:
    """S copies of one host state (numpy ``[N, R]`` / ``[G, D]`` planes,
    models.state layout), or the S host states of an ``[S, N, R]`` /
    ``[S, G, D]`` stack, as an S-stacked DevState on ``device``."""

    def t(a):
        a = np.asarray(a, np.float32)
        if a.ndim == 3:
            if a.shape[0] != S:
                raise ValueError(f"a stacked plane of {a.shape[0]} scenarios, expected {S}")
            return torch.tensor(a, device=device)
        return torch.tensor(a, device=device)[None].repeat(S, *([1] * a.ndim))

    return DevState(t(used), t(match_count), t(anti_active), t(pref_wsum))


def _stacked(t: torch.Tensor) -> torch.Tensor:
    """A shared ``[N, *]`` cluster table as ``[1, N, *]`` (it broadcasts
    over the scenarios); an ``[S, N, *]`` stack as it is."""
    return t.unsqueeze(0) if t.dim() == 2 else t


def _rows(cl: DevCluster, t: torch.Tensor) -> torch.Tensor:
    """Label table ``t`` ([L, ...]) as each scenario reads it: its one row
    as ``[1, ...]`` (it broadcasts over the scenarios) when L = 1, else
    ``t[lrow]`` ([S, ...])."""
    return t[:1] if t.shape[0] == 1 else t[cl.lrow.long()]


# ---------------------------------------------------------------------------
# Filters (ops/cpu.py, one pod p over all nodes of every scenario: [S, N],
# or [1, N] / [N] where the inputs are shared and broadcast)
# ---------------------------------------------------------------------------


def fit_mask(cl: DevCluster, st: DevState, pods: DevPods, p: int) -> torch.Tensor:
    req = pods.requests[p]
    return torch.all(st.used + req <= _stacked(cl.allocatable) + 1e-6, dim=2)


def _untolerated(cl: DevCluster, pods: DevPods, p: int, effects) -> torch.Tensor:
    """[S|1, N, TT] — taint slot active with effect ∈ ``effects`` and not
    tolerated by any of pod p's tolerations."""
    t_key, t_kv, t_eff = (_stacked(t) for t in (cl.taint_key, cl.taint_kv, cl.taint_effect))
    active = torch.zeros_like(t_key, dtype=torch.bool)
    for e in effects:
        active |= t_eff == int(e)
    active &= t_key != PAD
    tk, tv, te = pods.tol_key[p], pods.tol_kv[p], pods.tol_effect[p]
    valid_tol = tk != TOL_PAD
    key_ok = (tk == TOL_WILDCARD) | (tk == t_key[..., None])
    val_ok = (tv == PAD) | (tv == t_kv[..., None])
    eff_ok = (te == 0) | (te == t_eff[..., None])
    tolerated = torch.any(key_ok & val_ok & eff_ok & valid_tol, dim=-1)
    return active & ~tolerated


def taint_mask(cl: DevCluster, pods: DevPods, p: int) -> torch.Tensor:
    bad = _untolerated(cl, pods, p, (Effect.NO_SCHEDULE, Effect.NO_EXECUTE))
    return ~torch.any(bad, dim=-1)


def taint_prefer_count(cl: DevCluster, pods: DevPods, p: int) -> torch.Tensor:
    bad = _untolerated(cl, pods, p, (Effect.PREFER_NO_SCHEDULE,))
    return bad.sum(dim=-1).to(torch.float32)


def _terms_matched(M: torch.Tensor, terms: torch.Tensor) -> torch.Tensor:
    """[S|1, N, T] — term t valid (slot 0 is a real expr) and every real
    expr of it matched by node n (PAD exprs auto-true), per row of the
    ``[S|1, N, E]`` expression matches ``M``."""
    valid_term = terms[:, 0] >= 0
    per_expr = M[:, :, terms.clamp(min=0)] | (terms < 0)
    return torch.all(per_expr, dim=3) & valid_term


def node_affinity_mask(cl: DevCluster, pods: DevPods, p: int) -> torch.Tensor:
    """[S|1, N] required node affinity of pod p."""
    M = _rows(cl, cl.expr_match)
    if not bool(pods.na_has_req[p]):
        return torch.ones(M.shape[:2], dtype=torch.bool, device=M.device)
    return torch.any(_terms_matched(M, pods.na_req[p]), dim=2)


def node_affinity_score(cl: DevCluster, pods: DevPods, p: int) -> torch.Tensor:
    """Σ weight over matched preferred terms (raw), [S|1, N]."""
    per_term = _terms_matched(_rows(cl, cl.expr_match), pods.na_pref[p])
    w = pods.na_pref_w[p]
    raw = torch.zeros(per_term.shape[:2], dtype=torch.float32, device=w.device)
    for t in range(per_term.shape[2]):
        raw = raw + torch.where(per_term[..., t], w[t], torch.zeros_like(w[t]))
    return raw


def _counts_at_nodes(plane: torch.Tensor, gdom: torch.Tensor) -> torch.Tensor:
    """``plane[s, g, dom(s, g, n)]`` → [S, G, N] through each scenario's
    domain map ``gdom`` ([S|1, G, N]); 0 where the node lacks the key (a
    PAD domain never reads column 0)."""
    idx = gdom.clamp(min=0).to(torch.int64).expand(plane.shape[0], -1, -1)
    vals = torch.gather(plane, 2, idx)
    return torch.where(gdom >= 0, vals, torch.zeros_like(vals))


def interpod_filter_mask(cl: DevCluster, st: DevState, pods: DevPods, p: int) -> torch.Tensor:
    gdom = _rows(cl, cl.gdom)
    S, N = st.match_count.shape[0], gdom.shape[2]
    cnt = _counts_at_nodes(st.match_count, gdom)
    total = st.match_count.sum(dim=2)  # [S, G]
    ok = torch.ones((S, N), dtype=torch.bool, device=gdom.device)
    pm = pods.pmg[p]
    # Required affinity, with the [K8S] bootstrap exception: nothing
    # matches anywhere (in that scenario) and the pod matches its own term.
    for g in pods.aff_req[p].tolist():
        if g < 0:
            continue
        boot = (total[:, g] == 0) & pm[g]
        term_ok = (cnt[:, g] >= 1) & (gdom[:, g] >= 0)
        ok &= term_ok | boot[:, None]
    # Required anti-affinity of the incoming pod.
    for g in pods.anti_req[p].tolist():
        if g < 0:
            continue
        ok &= ~((cnt[:, g] >= 1) & (gdom[:, g] >= 0))
    # Symmetric: placed pods' required anti terms reject this pod.
    anti_here = _counts_at_nodes(st.anti_active, gdom)
    blocked = torch.any((anti_here > 0) & pm[None, :, None], dim=1)
    return ok & ~blocked


def interpod_score(
    cl: DevCluster, st: DevState, pods: DevPods, p: int, has_symmetric_pref: bool = True
) -> torch.Tensor:
    gdom = _rows(cl, cl.gdom)
    cnt = _counts_at_nodes(st.match_count, gdom)
    raw = torch.zeros(cnt[:, 0].shape, dtype=torch.float32, device=gdom.device)
    w_row = pods.pref_aff_w[p]
    for i, g in enumerate(pods.pref_aff[p].tolist()):
        if g >= 0:
            raw = raw + w_row[i] * cnt[:, g]
    if has_symmetric_pref:
        wsum = _counts_at_nodes(st.pref_wsum, gdom)
        sym = torch.zeros_like(raw)
        for g in torch.nonzero(pods.pmg[p]).flatten().tolist():
            sym = sym + wsum[:, g]
        raw = raw + sym
    return raw


def spread_filter_mask(cl: DevCluster, st: DevState, pods: DevPods, p: int) -> torch.Tensor:
    """DoNotSchedule spread. The minimum runs over each scenario's domains
    ``[0, gnd)``: domain ids are dense ranks of the values present, so
    every one of them holds a node (an emptied domain has no id)."""
    gdom, gnd = _rows(cl, cl.gdom), _rows(cl, cl.gnd)
    S, N = st.match_count.shape[0], gdom.shape[2]
    ok = torch.ones((S, N), dtype=torch.bool, device=gdom.device)
    d_ar = torch.arange(st.match_count.shape[2], device=gdom.device)
    inf = torch.tensor(float("inf"), device=gdom.device)
    dns_row = pods.spread_dns[p].tolist()
    skew_row = pods.spread_skew[p].tolist()
    for i, g in enumerate(pods.spread_g[p].tolist()):
        if g < 0 or not dns_row[i]:
            continue
        nd = gnd[:, g : g + 1]  # [S|1, 1]
        min_cnt = torch.where(d_ar < nd, st.match_count[:, g], inf).amin(dim=1)  # [S]
        cnt = _counts_at_nodes(st.match_count[:, g : g + 1], gdom[:, g : g + 1])[:, 0]
        self_match = 1.0 if bool(pods.pmg[p, g]) else 0.0
        new = cnt + self_match
        ok &= (nd > 0) & (gdom[:, g] >= 0) & (new - min_cnt[:, None] <= float(skew_row[i]))
    return ok


def spread_score(
    cl: DevCluster, st: DevState, pods: DevPods, p: int
) -> Tuple[torch.Tensor, torch.Tensor, bool]:
    """Upstream podtopologyspread raw score over the ScheduleAnyway
    constraints: ``floor(Σ cnt·log(size+2) + (maxSkew−1) + 0.5)`` per
    scenario and node [S, N], the ignored mask [S|1, N] (node missing a
    scored key) and the any-scored flag (PreScore Skip when False)."""
    gdom, sp_w = _rows(cl, cl.gdom), _rows(cl, cl.sp_w)
    S, N = st.match_count.shape[0], gdom.shape[2]
    raw = torch.zeros((S, N), dtype=torch.float32, device=gdom.device)
    ignored = torch.zeros(gdom[:, 0].shape, dtype=torch.bool, device=gdom.device)
    any_scored = False
    dns_row = pods.spread_dns[p].tolist()
    skew_row = pods.spread_skew[p].tolist()
    for i, g in enumerate(pods.spread_g[p].tolist()):
        if g < 0 or dns_row[i]:
            continue
        any_scored = True
        cnt = _counts_at_nodes(st.match_count[:, g : g + 1], gdom[:, g : g + 1])[:, 0]
        contrib = cnt * sp_w[:, g : g + 1] + torch.tensor(
            float(skew_row[i] - 1), dtype=torch.float32, device=gdom.device
        )
        raw = raw + contrib
        ignored |= gdom[:, g] < 0
    raw = torch.floor(raw + 0.5)
    return raw, ignored, any_scored


# ---------------------------------------------------------------------------
# Resource scores (integer-valued f32 floor chains)
# ---------------------------------------------------------------------------


def _resource_frac(cl: DevCluster, st: DevState, pods: DevPods, p: int, least: bool):
    req = pods.requests[p]
    alloc = _stacked(cl.allocatable)
    denom = torch.where(alloc > 0, alloc, torch.ones_like(alloc))
    num = (alloc - st.used) - req if least else st.used + req
    frac = torch.where(alloc > 0, num / denom, torch.zeros_like(alloc))
    return frac.clamp(0.0, 1.0)


def piecewise_interp_int(util: torch.Tensor, k: StepConsts) -> torch.Tensor:
    """Integer-valued piecewise-linear eval (ops/cpu.py
    piecewise_interp_int) with the segment constants precomputed in f32."""
    f = lambda x: torch.tensor(x, dtype=torch.float32, device=util.device)
    out = torch.full_like(util, k.y_last)
    for i in range(len(k.seg_x0) - 1, -1, -1):
        t = (util - f(k.seg_x0[i])) * f(k.seg_inv[i])
        seg = f(k.seg_y0[i]) + torch.floor(t * f(k.seg_dy[i]))
        out = torch.where(util <= f(k.seg_x1[i]), seg, out)
    return torch.where(util <= f(k.x_first), f(k.y_first), out)


def _fit_score_of(cl: DevCluster, st: DevState, pods: DevPods, p: int, k: StepConsts,
                  strategy: str) -> torch.Tensor:
    frac = _resource_frac(cl, st, pods, p, least=strategy == "LeastAllocated")
    s = torch.floor(frac * 100.0)
    if strategy == "RequestedToCapacityRatio":
        s = piecewise_interp_int(s, k)
    acc = torch.zeros(s.shape[:-1], dtype=torch.float32, device=s.device)
    for r, w in enumerate(k.res_w):
        if w != 0:
            acc = acc + s[..., r] * torch.tensor(w, dtype=torch.float32, device=s.device)
    if k.wsum == 0:
        return acc
    return torch.floor(acc / torch.tensor(k.wsum, dtype=torch.float32, device=s.device))


def fit_score(cl: DevCluster, st: DevState, pods: DevPods, p: int, k: StepConsts,
              wrow: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``floor(Σ_r w_r·s_r / Σw)`` with ``s_r = floor(100·frac_r)``
    (Least/MostAllocated) or the shape value of ``floor(100·util_r)``
    (RequestedToCapacityRatio), [S, N]. With policy rows ``wrow`` [S, K]
    and a static Least/MostAllocated, scenario s takes LeastAllocated
    where ``wrow[s, IDX_FIT_LEAST] > 0.5`` and MostAllocated elsewhere
    (ops/tpu3.py:1316-1329)."""
    strategy = FIT_STRATEGIES[k.fit_strategy]
    if wrow is None or strategy not in TRACED_FIT_STRATEGIES:
        return _fit_score_of(cl, st, pods, p, k, strategy)
    least = (wrow[:, IDX_FIT_LEAST] > 0.5)[:, None]
    return torch.where(least, _fit_score_of(cl, st, pods, p, k, "LeastAllocated"),
                       _fit_score_of(cl, st, pods, p, k, "MostAllocated"))


# ---------------------------------------------------------------------------
# K1 twin
# ---------------------------------------------------------------------------


def filter_score(tb: Tables, p: int, pod_of_s: Optional[torch.Tensor] = None) -> None:
    """Plain twin of K1 (csrc/filter_score.cu): writes the fused mask and
    the raw score rows of pod ``p`` in every scenario into
    ``tb.scratch``. With ``pod_of_s`` ([S] i32, the retry pass) scenario s
    takes pod ``pod_of_s[s]`` instead, and a PAD pod gets an all-zero
    mask, rows and ignored mask."""
    if tb.shards is not None:
        if pod_of_s is not None:
            raise ValueError("node shards take one pod for every scenario")
        shard_filter_score(tb, p)
        return
    if pod_of_s is not None:
        out = tb.scratch
        for x in out:
            x.zero_()
        for q, idx in _pods_of_scenarios(pod_of_s):
            sub = _scenario_subset(tb, idx)
            filter_score(sub, q)
            for x, y in zip(out, sub.scratch):
                x[idx] = y
        return
    cl, pods, st, k, out = tb.cluster, tb.pods, tb.state, tb.consts, tb.scratch
    S, N = out.feasible.shape
    dev = out.feasible.device
    ok = torch.ones((S, N), dtype=torch.bool, device=dev)  # every filter but the fit
    fit_ok = torch.ones((S, N), dtype=torch.bool, device=dev)
    rows = torch.zeros((S, NUM_ROWS, N), dtype=torch.float32, device=dev)
    ignored = torch.zeros((S, N), dtype=torch.bool, device=dev)
    if k.fit:
        fit_ok = fit_mask(cl, st, pods, p)
        rows[:, ROW_FIT] = fit_score(cl, st, pods, p, k, tb.wrow)
    if k.taints:
        ok &= taint_mask(cl, pods, p)
        rows[:, ROW_TAINT] = taint_prefer_count(cl, pods, p)
    if k.node_affinity:
        ok &= node_affinity_mask(cl, pods, p)
        rows[:, ROW_NA] = node_affinity_score(cl, pods, p)
    if k.interpod:
        ok &= interpod_filter_mask(cl, st, pods, p)
        rows[:, ROW_IP] = interpod_score(cl, st, pods, p, k.has_symmetric_pref)
    if k.spread:
        ok &= spread_filter_mask(cl, st, pods, p)
        rows[:, ROW_SPREAD], ign, _ = spread_score(cl, st, pods, p)
        ignored[:] = ign
    out.feasible.copy_(ok & fit_ok)
    out.scores.copy_(rows)
    out.ignored.copy_(ignored)
    pre = tb.preempt
    if pre is not None and bool(pre.eligible[p]):
        pre.cand.copy_(preempt_candidates(cl, st, pods, pre, p, ok))


def preempt_candidates(cl: DevCluster, st: DevState, pods: DevPods, pre: Preempt, p: int,
                       non_fit_ok: torch.Tensor) -> torch.Tensor:
    """[S, N] f32 candidate row of pod ``p`` (sim/greedy.py
    ``_try_tier_preempt``; ops/tpu3.py:1510-1560): ``victims·1024 + max
    victim tier`` where evicting every non-gang pod of a lower tier makes
    the pod fit, the other filters pass at their current values and there
    is a victim; +inf elsewhere. The lower-tier usage sums the tier planes
    from tier 0 up; the fit after eviction is ``(used − lower) + req ≤
    alloc + 1e-6``."""
    tp = int(pre.tier_host[p])
    lower = torch.zeros_like(st.used)
    victims = torch.zeros_like(pre.npods_tier[:, 0])
    maxtier = torch.full_like(victims, -1.0)
    for t in range(tp):
        lower = lower + pre.used_tier[:, t]
        cnt = pre.npods_tier[:, t]
        victims = victims + cnt
        maxtier = torch.where(cnt > 0, torch.full_like(maxtier, float(t)), maxtier)
    pre_fit = torch.all((st.used - lower) + pods.requests[p] <= _stacked(cl.allocatable) + 1e-6,
                        dim=2)
    cand = pre_fit & non_fit_ok & (victims > 0)
    return torch.where(cand, victims * 1024.0 + maxtier, torch.full_like(victims, float("inf")))


# ---------------------------------------------------------------------------
# Normalization and selection (K2 twin), per scenario row
# ---------------------------------------------------------------------------


def normalize_max(raw: torch.Tensor, hi: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """``floor(raw·100/max)`` with ``hi`` ([..., 1]) the row's max over its
    feasible nodes (0-filled); ``reverse`` flips (ops/tpu.py
    _normalize_row, max form)."""
    pos = hi > 0
    out = torch.floor((raw * 100.0) / torch.where(pos, hi, torch.ones_like(hi)))
    out = torch.where(pos, out, torch.zeros_like(out))
    if reverse:
        out = torch.where(pos, 100.0 - out, torch.full_like(out, MAX_NODE_SCORE))
    return out


def normalize_min_max(raw: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                      any_f: torch.Tensor) -> torch.Tensor:
    """``floor((raw−lo)·(100/span))`` with ``lo`` / ``hi`` the row's extrema
    over its feasible nodes and ``any_f`` whether it has one ([..., 1]
    each); constant or empty → 0 (ops/tpu.py _normalize_row, min-max
    form)."""
    span = hi - lo
    ok = any_f & (span > 0)
    one = torch.ones_like(span)
    # A true f32 division: torch evaluates ``scalar / tensor`` as
    # ``reciprocal(tensor) * scalar``, which rounds differently.
    k = torch.div(torch.full_like(span, MAX_NODE_SCORE), torch.where(ok, span, one))
    out = torch.floor((raw - torch.where(ok, lo, 0 * one)) * k)
    return torch.where(ok, out, torch.zeros_like(out))


def spread_normalize(
    raw: torch.Tensor, ignored: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
    any_scored: bool, f32ok: bool,
) -> torch.Tensor:
    """Upstream two-pass NormalizeScore ``100·(max+min−s) // max`` with
    ``lo`` / ``hi`` ([..., 1]) the extrema over the row's feasible & ~ignored
    nodes (ops/tpu.py spread_norm_from_extrema): the int32 floor division,
    or its f32 form under the static ``f32ok`` bound."""
    has = hi > -float("inf")
    zero = torch.zeros_like(hi)
    hi_f = torch.where(has, hi, zero)
    lo_f = torch.where(has, lo, zero)
    if f32ok:
        pos = hi_f > 0
        vals = torch.floor((100.0 * ((hi_f + lo_f) - raw)) / torch.where(pos, hi_f, zero + 1))
        out = torch.where(pos, vals, torch.full_like(vals, MAX_NODE_SCORE))
    else:
        hi_i = hi_f.to(torch.int32)
        lo_i = lo_f.to(torch.int32)
        num = 100 * ((hi_i + lo_i) - raw.to(torch.int32))
        vals = torch.div(num, torch.where(hi_i > 0, hi_i, torch.ones_like(hi_i)),
                         rounding_mode="floor")
        out = torch.where(hi_i > 0, vals.to(torch.float32),
                          torch.full_like(raw, MAX_NODE_SCORE))
    drop = ignored | ~has | torch.tensor(not any_scored, device=raw.device)
    return torch.where(drop, torch.zeros_like(out), out)


#: Columns of the packed normalization extrema (csrc/ksim.cuh KSIM_EXT_*):
#: the max of the taint and node-affinity rows (0-filled over the feasible
#: nodes), the inter-pod row's −min and max, the spread row's −min and max
#: over the feasible, not ignored nodes, and the any-feasible bit. Every
#: column folds by max, so the exchange of shards' extrema is one packed max
#: (ops/tpu.py:1211-1223); −(+inf) = −inf is the identity of an empty shard.
EXT_TAINT_HI, EXT_NA_HI, EXT_IP_NLO, EXT_IP_HI, EXT_SP_NLO, EXT_SP_HI, EXT_ANY = range(7)
NUM_EXT = 7


def row_extrema(x: Scratch) -> torch.Tensor:
    """[S, NUM_EXT] f32 packed extrema of the scratch rows ``x`` over their
    nodes (K2's pass 1; under node shards, K7's per-shard phase 0)."""
    f, s, ign = x.feasible, x.scores, x.ignored
    inf = torch.tensor(float("inf"), dtype=s.dtype, device=s.device)
    zero = torch.zeros_like(s[:, 0])
    okn = f & ~ign
    return torch.stack([
        torch.where(f, s[:, ROW_TAINT], zero).amax(dim=-1),
        torch.where(f, s[:, ROW_NA], zero).amax(dim=-1),
        -torch.where(f, s[:, ROW_IP], inf).amin(dim=-1),
        torch.where(f, s[:, ROW_IP], -inf).amax(dim=-1),
        -torch.where(okn, s[:, ROW_SPREAD], inf).amin(dim=-1),
        torch.where(okn, s[:, ROW_SPREAD], -inf).amax(dim=-1),
        f.any(dim=-1).to(s.dtype),
    ], dim=-1)


def normalized_rows(tb: Tables, p: int, ext: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[S, NUM_ROWS, N] — each plugin's NormalizeScore of the scratch rows:
    the fit score as is, the taint count reverse max-normalized, the
    node-affinity sum max-normalized, the inter-pod sum min-max
    normalized, the spread raw by the upstream two-pass form. Rows of
    plugins off in the step stay 0. The extrema are ``ext`` ([S, NUM_EXT],
    packed: a node shard's rows against the exchanged extrema), by default
    the rows' own (:func:`row_extrema`)."""
    k, x, pods = tb.consts, tb.scratch, tb.pods
    s = x.scores
    ext = row_extrema(x) if ext is None else ext
    col = lambda c: ext[:, c : c + 1]
    out = torch.zeros_like(s)
    if k.fit:
        out[:, ROW_FIT] = s[:, ROW_FIT]
    if k.taints:
        out[:, ROW_TAINT] = normalize_max(s[:, ROW_TAINT], col(EXT_TAINT_HI), reverse=True)
    if k.node_affinity:
        out[:, ROW_NA] = normalize_max(s[:, ROW_NA], col(EXT_NA_HI))
    if k.interpod:
        out[:, ROW_IP] = normalize_min_max(s[:, ROW_IP], -col(EXT_IP_NLO), col(EXT_IP_HI),
                                           col(EXT_ANY) > 0.5)
    if k.spread:
        any_scored = bool(((pods.spread_g[p] >= 0) & ~pods.spread_dns[p]).any())
        out[:, ROW_SPREAD] = spread_normalize(s[:, ROW_SPREAD], x.ignored, -col(EXT_SP_NLO),
                                              col(EXT_SP_HI), any_scored, k.sp_norm_f32)
    return out


def weighted_total(tb: Tables, p: int, ext: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[S, N] — Σ w·normalized row in the reference's plugin order (fit,
    taint, node affinity, inter-pod, spread), each product rounded to f32
    and added to a running f32 total from 0. The weights are the static
    constants, or with policy rows (``tb.wrow``) each scenario's columns
    0–4. ``ext``: as :func:`normalized_rows`."""
    k = tb.consts
    rows = normalized_rows(tb, p, ext)
    total = torch.zeros_like(rows[:, 0])
    for col, (on, w, r) in enumerate((
        (k.on_fit, k.w_fit, ROW_FIT),
        (k.on_taint, k.w_taint, ROW_TAINT),
        (k.on_na, k.w_na, ROW_NA),
        (k.on_ip, k.w_ip, ROW_IP),
        (k.on_sp, k.w_sp, ROW_SPREAD),
    )):
        if on:
            wt = (tb.wrow[:, col : col + 1] if tb.wrow is not None
                  else torch.tensor(w, dtype=torch.float32, device=rows.device))
            total = total + wt * rows[:, r]
    return total


def select_node(scores: torch.Tensor, feasible: torch.Tensor) -> torch.Tensor:
    """int32 choice per row of ``scores`` (``[..., N]`` → ``[...]``): the
    lowest-index argmax of the masked scores, PAD when nothing is feasible
    (ops/tpu.py select_node)."""
    masked = torch.where(feasible, scores, torch.full_like(scores, float("-inf")))
    mx = masked.amax(dim=-1, keepdim=True)
    N = scores.shape[-1]
    ar = torch.arange(N, device=scores.device)
    first = torch.where(masked == mx, ar, torch.full_like(ar, N)).amin(dim=-1)
    placed = mx.squeeze(-1) > float("-inf")
    return torch.where(placed, first, torch.full_like(first, PAD)).to(torch.int32)


def masked_argmin(scores: torch.Tensor, mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(choice int32, any bool) per row of ``scores`` (``[..., N]``): the
    lowest-index argmin over the masked entries, PAD where nothing is
    masked in (ops/tpu.py:788 ``masked_argmin``)."""
    inf = torch.full_like(scores, float("inf"))
    masked = torch.where(mask, scores, inf)
    lo = masked.amin(dim=-1, keepdim=True)
    N = scores.shape[-1]
    ar = torch.arange(N, device=scores.device)
    hit = mask & (masked == lo)
    first = torch.where(hit, ar, torch.full_like(ar, N)).amin(dim=-1)
    ok = lo.squeeze(-1) < float("inf")
    return torch.where(ok, first, torch.full_like(first, PAD)).to(torch.int32), ok


def normalize_select(tb: Tables, p: int, choices: torch.Tensor, slot: int,
                     wave: int = -1, pod_of_s: Optional[torch.Tensor] = None) -> None:
    """Plain twin of K2 (csrc/normalize_select.cu): writes pod ``p``'s
    choice in each scenario s (PAD when unplaced) into the int32
    ``choices[s, slot]``. With tier preemption (``tb.preempt``), a scenario
    where nothing is feasible, the pod may preempt and no preemption fired
    yet in ``wave`` takes the lowest-index argmin of the candidate row
    instead, and records the eviction (node, the pod's tier) for K3;
    every other scenario records none. With ``pod_of_s`` ([S] i32, the
    retry pass) scenario s selects for pod ``pod_of_s[s]`` (PAD: writes
    PAD)."""
    if pod_of_s is not None:
        out = torch.full((choices.shape[0],), PAD, dtype=torch.int32, device=choices.device)
        for q, idx in _pods_of_scenarios(pod_of_s):
            sub = _scenario_subset(tb, idx)
            out[idx] = select_node(weighted_total(sub, q), sub.scratch.feasible)
        choices[:, slot] = out
        return
    choice = select_node(weighted_total(tb, p), tb.scratch.feasible)
    pre = tb.preempt
    if pre is not None:
        if bool(pre.eligible[p]):
            node, ok = masked_argmin(pre.cand, pre.cand < float("inf"))
            fire = (choice < 0) & (pre.last_wave != wave) & ok
            choice = torch.where(fire, node, choice)
            pre.ev_node.copy_(torch.where(fire, node, torch.full_like(node, PAD)))
            pre.ev_tier.copy_(torch.where(fire, pre.pod_tier[p], pre.ev_tier))
            pre.last_wave.copy_(torch.where(fire, torch.full_like(node, wave), pre.last_wave))
        else:
            pre.ev_node.fill_(PAD)
    choices[:, slot] = choice


# ---------------------------------------------------------------------------
# State update (K3 twin)
# ---------------------------------------------------------------------------


def gang_rollback_mask(pods: DevPods, pod_ids: torch.Tensor, nodes: torch.Tensor) -> torch.Tensor:
    """``[..., K]`` bool — placed pairs whose gang has an unplaced member
    among the K slots (the wave-end all-or-nothing commit), per row of
    ``nodes`` (``[K]`` or ``[S, K]``; the pods are shared)."""
    valid = pod_ids >= 0
    g = torch.where(valid, pods.group_id[pod_ids.clamp(min=0).long()], torch.full_like(pod_ids, PAD))
    failed = valid & (nodes < 0) & (g >= 0)
    same = (g[:, None] == g[None, :]) & failed[..., None, :]
    return valid & (nodes >= 0) & (g >= 0) & same.any(dim=-1)


def evict(tb: Tables, slot: int, choices: torch.Tensor, boundary: int) -> None:
    """The eviction step of K3's bind (sim/greedy.py:182-215, the victim
    walk of sim/jax_runtime.py:788 ``preemption_walk``): in each scenario
    whose eviction record names a node, every column of the choice buffer
    before ``slot`` or in the pre-bound tail that holds a non-gang pod of
    a lower tier at that node, not yet released at ``boundary``, is
    overwritten with PAD and counted; the node's ``used`` drops by the
    lower tiers' usage (summed from tier 0 up) and those tier cells are
    zeroed. Counts stay (phantom counts)."""
    pre, pods, st = tb.preempt, tb.pods, tb.state
    ev = pre.ev_node
    has = ev >= 0
    if not bool(has.any()):
        return
    S, N, R = st.used.shape
    dev = ev.device
    L = choices.shape[1]
    cols = torch.cat([torch.arange(slot, device=dev), torch.arange(pre.n_slots, L, device=dev)])
    p = pre.col_pod[cols].long()
    pc = p.clamp(min=0)
    n = choices[:, cols]
    victim = (has[:, None] & (p >= 0)[None] & (n == ev[:, None])
              & (pods.group_id[pc] < 0)[None] & (pre.pod_tier[pc][None] < pre.ev_tier[:, None])
              & (pre.col_relb[cols] > boundary)[None])
    choices[:, cols] = torch.where(victim, torch.full_like(n, PAD), n)
    pre.victims.add_(victim.sum(dim=1).to(torch.int32))
    s_ar = torch.arange(S, device=dev)
    evc = ev.clamp(min=0).long()
    Tt = pre.used_tier.shape[1]
    lower = torch.zeros((S, R), dtype=torch.float32, device=dev)
    for t in range(Tt):
        below = (has & (t < pre.ev_tier))
        cell = pre.used_tier[s_ar, t, evc]  # [S, R]
        lower = torch.where(below[:, None], lower + cell, lower)
        pre.used_tier[s_ar, t, evc] = torch.where(below[:, None], torch.zeros_like(cell), cell)
        cnt = pre.npods_tier[s_ar, t, evc]
        pre.npods_tier[s_ar, t, evc] = torch.where(below, torch.zeros_like(cnt), cnt)
    row = st.used[s_ar, evc]
    st.used[s_ar, evc] = torch.where(has[:, None], row - lower, row)


def append_failures(tb: Tables, pod_ids: torch.Tensor, nodes: torch.Tensor) -> None:
    """The failure append of a main-path bind (sim/boundary.py:350
    ``offer_failure``; sim/whatif.py:1502-1528): in each scenario, in pair
    order, a valid non-gang pod whose node is PAD enters the scenario's
    FIFO at ``rbuf[s, rcount[s]]``, or, with the buffer full, is dropped
    and counted in ``rdrop[s]``."""
    rt, gid = tb.retry, tb.pods.group_id
    RB = rt.rbuf.shape[1]
    s_ar = torch.arange(rt.rbuf.shape[0], device=rt.rbuf.device)
    fail = (pod_ids >= 0) & (nodes < 0) & (gid[pod_ids.clamp(min=0).long()] < 0)
    for k in range(fail.shape[1]):
        f = fail[:, k]
        room = rt.rcount < RB
        put = f & room
        rt.rbuf[s_ar[put], rt.rcount[put].long()] = pod_ids[put, k]
        rt.rcount.add_(put.to(torch.int32))
        rt.rdrop.add_((f & ~room).to(torch.int32))


def _apply_planes(tb: Tables, ss: torch.Tensor, p: torch.Tensor, dom: torch.Tensor,
                  sign: float) -> None:
    """``sign`` × the count-plane contribution of M pairs, in pair order:
    pod ``p[m]`` of scenario ``ss[m]`` whose node lies in domain ``dom[g,
    m]`` under group g's key (PAD: none)."""
    pods, st = tb.pods, tb.state
    G, D = st.match_count.shape[1:]
    hit = (dom >= 0) & pods.pmg[p].T
    gg, mm = torch.nonzero(hit, as_tuple=True)
    flat = (ss[mm] * G + gg) * D + dom[gg, mm].long()
    st.match_count.view(-1).index_add_(
        0, flat, torch.full(flat.shape, sign, dtype=torch.float32, device=flat.device)
    )
    m_ar = torch.arange(p.shape[0], device=p.device)
    for col in range(pods.anti_req.shape[1]):
        g = pods.anti_req[p, col].long()
        d = dom[g.clamp(min=0), m_ar]
        ok = (g >= 0) & (d >= 0)
        st.anti_active.view(-1).index_add_(
            0, (ss[ok] * G + g[ok]) * D + d[ok].long(),
            torch.full((int(ok.sum()),), sign, dtype=torch.float32, device=p.device),
        )
    for col in range(pods.pref_aff.shape[1]):
        g = pods.pref_aff[p, col].long()
        d = dom[g.clamp(min=0), m_ar]
        ok = (g >= 0) & (d >= 0)
        st.pref_wsum.view(-1).index_add_(
            0, (ss[ok] * G + g[ok]) * D + d[ok].long(), sign * pods.pref_aff_w[p, col][ok]
        )


def _add_in_pair_order(target: torch.Tensor, rows: torch.Tensor, vals: torch.Tensor,
                       unique: bool = False) -> None:
    """``target[rows[k]] += vals[k]`` for k in order, on any device: the
    k-th pair on a node joins its row in the k-th pass, one ``index_add_``
    a pass over rows that are unique within it, so each row's sum runs in
    pair order whatever order a device's ``index_add_`` keeps among equal
    rows (CUDA's atomics keep none). ``unique``: the caller knows the rows
    differ (one pair a scenario), one pass."""
    M = rows.numel()
    if M == 0:
        return
    if unique:
        target.index_add_(0, rows, vals)
        return
    srt = torch.sort(rows, stable=True)
    ar = torch.arange(M, device=rows.device)
    head = torch.ones(M, dtype=torch.bool, device=rows.device)
    head[1:] = srt.values[1:] != srt.values[:-1]
    rank = torch.empty_like(ar)
    rank[srt.indices] = ar - torch.cummax(torch.where(head, ar, 0), dim=0).values
    for r in range(int(rank.max()) + 1):
        sel = rank == r
        target.index_add_(0, rows[sel], vals[sel])


def apply_placements(
    tb: Tables, pod_ids: torch.Tensor, pos: torch.Tensor, choices: torch.Tensor, sign: float,
    rollback: bool = False, boundary: Optional[int] = None,
    due: Optional[Tuple[torch.Tensor, int]] = None, append: bool = False,
) -> None:
    """Plain twin of K3 (csrc/apply_placements.cu): add ``sign`` × the
    state contribution of each pair (``pod_ids[k]``, node
    ``choices[s, pos[k]]``) to scenario s's state, in pair order
    (models/state._apply) — except that a release (``sign < 0``, not a
    rollback) subtracts each node's ``used`` delta summed from zero in pair
    order, as the reference subtracts ``release_delta`` (a difference only
    where requests are not exact binary fractions, such as 0.1 cpu); PAD
    pods and nodes are skipped. ``pod_ids`` is
    ``[K]`` (shared by the scenarios) or ``[S, K]`` (per scenario: the
    retry pass's bind and the pending release). ``rollback`` restricts the
    pairs to failed-gang members and overwrites their choices with PAD.
    ``due = (relb [S, K], b)`` keeps only the pairs with ``relb <= b`` (the
    pending release). ``append`` (a main-path bind under the retry buffer)
    then appends each failed non-gang pod to its scenario's buffer
    (:func:`append_failures`). With tier preemption the tier planes follow
    the non-gang pairs, and a bind given the current ``boundary`` first
    applies the slot's eviction record (:func:`evict`)."""
    pods, cl, st = tb.pods, tb.cluster, tb.state
    S, N, R = st.used.shape
    pre = tb.preempt
    if pre is not None and boundary is not None:
        evict(tb, int(pos[0]), choices, boundary)
    posl = pos.long()
    nodes = choices[:, posl]  # [S, K]
    pid = pod_ids if pod_ids.dim() == 2 else pod_ids.expand(S, -1)
    if rollback:
        keep = gang_rollback_mask(pods, pod_ids, nodes)
    else:
        keep = (pid >= 0) & (nodes >= 0)
    if due is not None:
        keep = keep & (due[0] <= due[1])
    ss, kk = torch.nonzero(keep, as_tuple=True)  # scenario-major, pair order within
    if ss.numel():
        p = pid[ss, kk].long()
        n = nodes[ss, kk].long()
        one = pid.shape[1] == 1  # one pair a scenario: the rows differ
        if sign < 0 and not rollback:
            # A release subtracts each node's requests summed in pair order
            # from zero (models/state.py release_delta, the reference's delta).
            delta = torch.zeros_like(st.used).view(S * N, R)
            _add_in_pair_order(delta, ss * N + n, pods.requests[p], one)
            st.used.sub_(delta.view(S, N, R))
        else:
            _add_in_pair_order(st.used.view(S * N, R), ss * N + n, sign * pods.requests[p], one)
        if pre is not None:
            ng = pods.group_id[p] < 0
            tcell = (ss[ng] * pre.used_tier.shape[1] + pre.pod_tier[p[ng]].long()) * N + n[ng]
            _add_in_pair_order(pre.used_tier.view(-1, R), tcell, sign * pods.requests[p[ng]],
                               one)
            pre.npods_tier.view(-1).index_add_(
                0, tcell, torch.full(tcell.shape, sign, dtype=torch.float32, device=tcell.device))
        # [G, M]: each pair's node under its scenario's label row
        dom = cl.gdom[0][:, n] if cl.gdom.shape[0] == 1 else cl.gdom[cl.lrow[ss].long(), :, n].T
        _apply_planes(tb, ss, p, dom, sign)
    if rollback:
        choices[:, posl] = torch.where(keep, torch.full_like(nodes, PAD), nodes)
    if append:
        append_failures(tb, pid, nodes)


def retry_pass(tb: Tables, bnd: int, t_b: float, pending: bool = True,
               reject: Optional[Reject] = None, choices: Optional[torch.Tensor] = None) -> None:
    """Boundary ``bnd``'s retry sequence in every scenario, the twin of K6's
    retry mode before its waves (sim/whatif.py:1433-1494, in its order): the
    pending list's due entries released (unless ``pending`` is False), the
    retry pass — each buffered pod of a scenario, slot by slot, through
    :func:`filter_score` and :func:`normalize_select` (its choice into
    ``rchoice``), with ``reject`` :func:`first_reject` of the slot, and the
    bind of :func:`apply_placements`; a scenario whose buffer is shorter
    does nothing in the later slots and its ``rchoice`` there is PAD — then
    :func:`retry_boundary` at the f32 start time ``t_b``. Under kube
    preemption (``tb.retry.prio``; ``choices`` the choice buffer) the pass
    is :func:`kube_pass`. With ``tb.log`` (a chaos timeline) each bind of
    the pass appends its ``bind`` record, scenario by scenario in slot
    order."""
    rt = tb.retry
    RB = rt.rbuf.shape[1]
    pos_rb = torch.arange(RB, dtype=torch.int32, device=rt.rbuf.device)
    if pending:
        apply_placements(tb, rt.pend_id, pos_rb, rt.pend_node, -1.0, due=(rt.pend_relb, bnd))
    if rt.prio is not None:
        kube_pass(tb, choices, bnd, t_b, reject)
        return
    rtb = tb._replace(reject=reject) if reject is not None else None
    for k in range(int(rt.rcount.max()) if rt.rcount.numel() else 0):
        pod_of_s = rt.rbuf[:, k]
        filter_score(tb, PAD, pod_of_s)
        normalize_select(tb, PAD, rt.rchoice, k, -1, pod_of_s)
        if rtb is not None:
            first_reject(rtb, rt.rbuf[:, k : k + 1], rt.rchoice[:, k : k + 1])
        apply_placements(tb, rt.rbuf[:, k : k + 1], pos_rb[k : k + 1], rt.rchoice, 1.0)
        if tb.log is not None:
            for s, (p, n) in enumerate(zip(pod_of_s.tolist(), rt.rchoice[:, k].tolist())):
                if p >= 0 and n >= 0:
                    log_append(tb.log, s, LOG_BIND, bnd, p, n)
    rt.rchoice.masked_fill_(pos_rb[None, :] >= rt.rcount[:, None], PAD)
    retry_boundary(tb, bnd, t_b)


# ---------------------------------------------------------------------------
# Kube preemption: the PostFilter (the twin of K6's ksim_post_filter) and the
# retry pass that runs it (sim/boundary.py:547-678 with kube=True)
# ---------------------------------------------------------------------------


def bound_nodes(tb: Tables, choices: torch.Tensor, s: int, b: int) -> torch.Tensor:
    """[P] i64 each pod's current node in scenario s during boundary b's
    pass (PAD: not bound): its retried node while its pending release has
    not fired (``rrel > b``), else its choice-buffer column's node while the
    column's static release has not (``col_relb > b``)."""
    rt = tb.retry
    col = rt.col_of.long()
    has = col >= 0
    ch = torch.where(has, choices[s, col.clamp(min=0)], torch.full_like(rt.col_of, PAD))
    relb = torch.where(has, rt.col_relb[col.clamp(min=0)], torch.full_like(rt.col_of, NEVER))
    rn = rt.rnode[s]
    cur = torch.where((rn < 0) & (ch >= 0) & (relb > b), ch, torch.full_like(ch, PAD))
    cur = torch.where((rn >= 0) & (rt.rrel[s] > b), rn, cur)
    return cur.long()


def _unbind_planes(tb: Tables, s: int, v: int, n: int) -> None:
    """Pod v leaves node n in scenario s (models/state.py unbind): ``used``
    minus its requests, its count-plane contributions rewound."""
    st = tb.state
    st.used[s, n] = st.used[s, n] - tb.pods.requests[v]
    cl = tb.cluster
    row = cl.gdom[0] if cl.gdom.shape[0] == 1 else cl.gdom[int(cl.lrow[s])]
    dev = st.used.device
    _apply_planes(tb, torch.tensor([s], device=dev), torch.tensor([v], device=dev),
                  row[:, n : n + 1], -1.0)


def post_filter(tb: Tables, choices: torch.Tensor, s: int, p: int, b: int
                ) -> Optional[Tuple[int, list]]:
    """Plain twin of K6's ``ksim_post_filter`` for pod ``p`` in scenario s
    at boundary b (framework/framework.py ``_post_filter_preempt``, decision
    for decision): ``(node, victims)`` or None. Victims are the bound
    non-gang pods of lower raw priority, each node's in (priority, pod
    index) order; the static mask is every Filter but NodeResourcesFit,
    InterPodAffinity and PodTopologySpread at the current planes; with no
    state-dependent filter on the pod (``state_free``) the smallest fitting
    prefix by the reference's f32 cumsum (``used + req - cum <= alloc +
    1e-6``), else victims evicted one by one from a copy of the planes, each
    step followed by the resource check and the full Filter chain at the
    node; candidates ranked by (victims, max victim priority, node)."""
    rt, pods, k = tb.retry, tb.pods, tb.consts
    cur = bound_nodes(tb, choices, s, b)
    prio = rt.prio.long()
    pp = int(prio[p])
    lower = torch.nonzero((cur >= 0) & (prio < pp) & (pods.group_id < 0)).flatten()
    if lower.numel() == 0:
        return None
    sub = _scenario_subset(tb, torch.tensor([s], device=cur.device))
    cl = sub.cluster
    static = torch.ones(sub.state.used.shape[1], dtype=torch.bool, device=cur.device)
    if k.taints:
        static = static & taint_mask(cl, pods, p).reshape(-1)
    if k.node_affinity:
        static = static & node_affinity_mask(cl, pods, p).reshape(-1)
    req = pods.requests[p]
    alloc = _stacked(cl.allocatable)[0]
    used = sub.state.used[0]
    state_free = not (
        (k.interpod and (int(pods.aff_req[p, 0]) >= 0 or int(pods.anti_req[p, 0]) >= 0
                         or rt.trace_has_anti))
        or (k.spread and bool(((pods.spread_g[p] >= 0) & pods.spread_dns[p]).any()))
    )
    host_cur = cur[lower].tolist()
    host_prio = prio[lower].tolist()
    host_ids = lower.tolist()
    by_node: dict = {}
    for q, n, pr in sorted(zip(host_ids, host_cur, host_prio), key=lambda x: (x[1], x[2], x[0])):
        by_node.setdefault(n, []).append(q)
    eps = torch.tensor(1e-6, dtype=torch.float32, device=cur.device)
    best = None
    for n in sorted(by_node):
        if not bool(static[n]):
            continue
        order = by_node[n]
        victims: list = []
        fits = False
        if k.fit and state_free:
            cum = torch.zeros_like(req)
            for i, v in enumerate(order):
                cum = cum + pods.requests[v]
                if bool(torch.all((used[n] + req) - cum <= alloc[n] + eps)):
                    fits, victims = True, order[: i + 1]
                    break
        else:
            trial = sub._replace(state=DevState(*(x.clone() for x in sub.state)))
            for v in order:
                _unbind_planes(trial, 0, v, n)
                victims.append(v)
                if k.fit and not bool(torch.all(trial.state.used[0, n] + req <= alloc[n] + eps)):
                    continue
                if state_free or all(bool(m.reshape(-1)[n]) for m in filter_masks(trial, p)):
                    fits = True
                    break
        if not fits:
            continue
        key = (len(victims), int(prio[victims[-1]]), n)
        if best is None or key < best[0]:
            best = (key, list(victims))
    if best is None:
        return None
    return best[0][2], best[1]


def kube_pass(tb: Tables, choices: torch.Tensor, bnd: int, t_b: float,
              reject: Optional[Reject] = None) -> None:
    """Boundary ``bnd``'s retry pass under kube preemption in every
    scenario, the twin of K6's retry mode there (sim/boundary.py:547-678,
    ``boundary_retry`` with kube=True): the pending list drops its due
    entries (released before the pass); each scenario walks its FIFO
    ``rbuf[:rcount]`` until its queue is empty, step by step over the
    scenarios at once through :func:`filter_score` and
    :func:`normalize_select` (one pod a scenario, the choice into
    ``rchoice[:, 0]``); a scenario whose pod no node admits runs
    :func:`post_filter`. With a node, each victim in order: its node's
    ``used`` minus its requests and its count planes rewound, its pending
    entry cancelled, its retried node (and ``rrel``) or its choice-buffer
    column cleared (so no release fires for it), its ``first_b`` marked
    when it was first bound in its wave, ``preempt`` counted, and it joins
    the queue while the unwalked and kept entries number fewer than RB
    (else ``rdrop``); then the pod binds (:func:`apply_placements`),
    records ``rnode``, ``rbind_b``, its first bind, and a pending release
    at ``max(searchsorted_left(tbt, f32(t_b) + f32(duration)), b + 1)``
    where that boundary exists and the list holds fewer than RB entries
    (``rrel``; else NEVER). A pod that fails is kept, in walk order. After
    the walk ``rbuf`` holds the kept pods (``rcount``) and ``rchoice`` is
    PAD.

    With ``reject`` (telemetry series; sim/boundary.py:563-582 and
    framework/framework.py ``schedule_one(want_reasons=True)``) a pod no
    node admits is counted as K5 counts it, at the pass's state before the
    PostFilter, and charged (``attempts``, and ``reasons`` on an unmarked
    episode) only when the PostFilter finds no node: a rescued pod carries
    no reasons. Each victim's and each bound pod's episode mark is cleared.
    With ``tb.log`` each commit appends its victims' ``preempt`` records,
    in victim order, and then the pod's ``bind``."""
    rt = tb.retry
    S, RB = rt.rbuf.shape
    dev = rt.rbuf.device
    i32 = torch.int32
    B = rt.tbt.shape[0]
    tb32 = rt.tbt.cpu().numpy()
    pend = []
    for s in range(S):
        ids, nodes, relb = (x[s].tolist() for x in (rt.pend_id, rt.pend_node, rt.pend_relb))
        pend.append([[q, n, r] for q, n, r in zip(ids, nodes, relb) if q >= 0 and r > bnd])
    queues = [rt.rbuf[s, : int(rt.rcount[s])].tolist() for s in range(S)]
    head = [0] * S
    kept: list = [[] for _ in range(S)]
    pos0 = torch.zeros(1, dtype=i32, device=dev)
    rt.rchoice.fill_(PAD)
    while any(head[s] < len(queues[s]) for s in range(S)):
        pod = [queues[s][head[s]] if head[s] < len(queues[s]) else PAD for s in range(S)]
        pod_of_s = torch.tensor(pod, dtype=i32, device=dev)
        # a scenario whose queue is empty leaves its scratch rows as they
        # are (its cluster has left the loop)
        idle = pod_of_s < 0
        kept_rows = [x[idle].clone() for x in tb.scratch] if bool(idle.any()) else None
        filter_score(tb, PAD, pod_of_s)
        if kept_rows is not None:
            for x, y in zip(tb.scratch, kept_rows):
                x[idle] = y
        normalize_select(tb, PAD, rt.rchoice, 0, -1, pod_of_s)
        node = rt.rchoice[:, 0].tolist()
        for s in range(S):
            p = pod[s]
            if p < 0:
                continue
            head[s] += 1
            if node[s] < 0:
                counts = None
                if reject is not None:
                    sub = _scenario_subset(tb, torch.tensor([s], device=dev))
                    counts = first_reject_counts(filter_masks(sub, p))[0][0]
                hit = post_filter(tb, choices, s, p, bnd)
                if hit is None:
                    kept[s].append(p)
                    if counts is not None:
                        reject.attempts[s] += counts
                        if int(reject.attributed[s, p]) == 0:
                            reject.attributed[s, p] = 1
                            reject.reasons[s] += counts
                    continue
                node[s], victims = hit
                for v in victims:
                    if reject is not None:
                        reject.attributed[s, v] = 0
                    log_append(tb.log, s, LOG_PREEMPT, bnd, v, node[s])
                    _unbind_planes(tb, s, v, node[s])
                    rt.preempt[s] += 1
                    pend[s] = [e for e in pend[s] if e[0] != v]
                    if int(rt.rnode[s, v]) >= 0:
                        rt.rnode[s, v] = PAD
                        rt.rrel[s, v] = NEVER
                    else:
                        choices[s, int(rt.col_of[v])] = PAD
                    if int(rt.first_b[s, v]) == PAD:
                        rt.first_b[s, v] = FIRST_IN_WAVE
                    if (len(queues[s]) - head[s]) + len(kept[s]) < RB:
                        queues[s].append(v)
                    else:
                        rt.rdrop[s] += 1
        rt.rchoice[:, 0] = torch.tensor(node, dtype=i32, device=dev)
        apply_placements(tb, pod_of_s[:, None], pos0, rt.rchoice, 1.0)
        for s in range(S):
            p, n = pod[s], node[s]
            if p < 0 or n < 0:
                continue
            if reject is not None:
                reject.attributed[s, p] = 0
            log_append(tb.log, s, LOG_BIND, bnd, p, n)
            rt.rnode[s, p] = n
            rt.rbind_b[s, p] = bnd
            if int(rt.first_b[s, p]) == PAD:
                rt.first_b[s, p] = bnd
            if rt.evict_t is not None:
                chaos_rebind(rt, s, p, bnd)
            rrel = NEVER
            v = np.float32(t_b) + np.float32(float(rt.dur[p]))
            rb = int(np.searchsorted(tb32, v, side="left"))
            if rb < B and len(pend[s]) < RB:
                rrel = max(rb, bnd + 1)
                pend[s].append([p, n, rrel])
            rt.rrel[s, p] = rrel
        rt.rchoice.fill_(PAD)
    for s in range(S):
        e = pend[s] + [[PAD, PAD, PAD]] * (RB - len(pend[s]))
        for x, col in zip((rt.pend_id, rt.pend_node, rt.pend_relb), zip(*e)):
            x[s] = torch.tensor(col, dtype=i32, device=dev)
        rt.rbuf[s] = torch.tensor(kept[s] + [PAD] * (RB - len(kept[s])), dtype=i32, device=dev)
        rt.rcount[s] = len(kept[s])


def chaos_rebind(rt: Retry, s: int, p: int, b: int) -> None:
    """Pod p is bound by boundary b's retry pass in scenario s: if a
    node_down evicted it and it waits for a re-bind, it is re-bound — its
    eviction time cleared, ``resched`` counted, and, at a finite boundary,
    ``t_b − t_evict`` added to ``evict_lat`` in f64 (sim/boundary.py:632-639;
    the trailing boundary counts the re-bind and adds nothing)."""
    t_ev = float(rt.evict_t[s, p])
    if t_ev < 0.0:
        return
    rt.evict_t[s, p] = -1.0
    rt.resched[s] += 1
    t_b = float(rt.tbd[b]) if b < rt.tbd.shape[0] else float("inf")
    if np.isfinite(t_b):
        rt.evict_lat[s] = float(rt.evict_lat[s]) + (t_b - t_ev)


def event_steps(timelines, tb: np.ndarray, alloc0: np.ndarray) -> dict:
    """The chaos timeline of each scenario (``timelines [S]`` lists of
    NodeEvent, each sorted by time) as the device work of each boundary
    (the reference's schedule, sim/jax_runtime.py:1755-1793 and
    sim/whatif.py:3266-3330): an event fires at the first boundary b whose
    f64 start time ``tb[b]`` is at or after its time (chunk 0 included; no
    event fires at the trailing boundary). ``alloc0`` is the allocatable
    every scenario starts from, ``[N, R]`` (shared) or ``[S, N, R]``, f32: a
    ``node_down`` sets the node's row to 0, a ``node_up`` back to the
    scenario's own t = 0 row and a ``capacity_scale`` to that row times its
    factor. Returns ``{b: ChaosStep}`` for each boundary where an event
    fires, with the events themselves (``fired``)."""
    a0 = np.asarray(alloc0, np.float32)
    S = len(timelines)
    N, R = a0.shape[-2:]
    row0 = (lambda s, n: a0[n]) if a0.ndim == 2 else (lambda s, n: a0[s, n])
    cur = [0] * S
    out = {}
    for b, t in enumerate(np.asarray(tb, np.float64)):
        rows, downs, fired = {}, [], []
        for s in range(S):
            tl, i = timelines[s], cur[s]
            nodes = []
            while i < len(tl) and tl[i].time <= t:
                ev = tl[i]
                i += 1
                n = int(ev.node)
                if ev.kind == "node_down":
                    rows[(s, n)] = np.zeros(R, np.float32)
                    nodes.append(n)
                elif ev.kind == "node_up":
                    rows[(s, n)] = row0(s, n).copy()
                elif ev.kind == "capacity_scale":
                    rows[(s, n)] = (row0(s, n) * ev.scale).astype(np.float32)
            fired.append(tuple(tl[cur[s] : i]))
            cur[s] = i
            if nodes:
                downs.append((s, nodes))
        if not rows:
            continue
        keys = sorted(rows)
        out[b] = ChaosStep(
            rows=np.asarray([s * N + n for s, n in keys], np.int64),
            vals=np.stack([rows[k] for k in keys]).astype(np.float32),
            scen=np.asarray([s for s, _ in downs], np.int32),
            off=np.concatenate(([0], np.cumsum([len(x) for _, x in downs]))).astype(np.int32),
            nodes=np.asarray([n for _, x in downs for n in x], np.int32),
            t_b=float(t),
            fired=tuple(fired),
        )
    return out


class ChaosStep(NamedTuple):
    """The device work of one boundary of a chaos timeline
    (:func:`event_steps`; numpy arrays, or their device copies): the
    allocatable rows that change (flat row ids ``s · N + n`` of an ``[S · N,
    R]`` view, each once, and their new values), and for K10 the scenarios
    with a ``node_down`` here and their down nodes in timeline order
    (``nodes[off[i]:off[i + 1]]`` for scenario ``scen[i]``); ``t_b`` the
    boundary's f64 start time; ``fired`` each scenario's events that fire
    here, in timeline order (host objects: the telemetry's node events)."""

    rows: np.ndarray  # [k] i64
    vals: np.ndarray  # [k, R] f32
    scen: np.ndarray  # [m] i32
    off: np.ndarray  # [m + 1] i32
    nodes: np.ndarray  # [off[m]] i32
    t_b: float
    fired: tuple = ()  # [S] tuples of NodeEvent


def evict_node(tb: Tables, choices: torch.Tensor, s: int, nodes, b: int, t_b: float) -> None:
    """Plain twin of K10 (csrc/evict_node.cu) in scenario s at boundary b
    (f64 start time ``t_b``), before the boundary's releases: for each down
    node in ``nodes``, in order, the NoExecute eviction of every pod bound
    there (sim/boundary.py:430-475 ``evict_node``) — the pods whose node
    before this boundary's releases is that node (:func:`bound_nodes` at b −
    1: a release that falls due at b has not fired yet), in ascending pod
    index; each one's node row loses its requests and its count planes are
    rewound (models/state.py unbind), its pending entry is cancelled, its
    retried node (and ``rrel``) or its choice-buffer column cleared (no
    release fires for it), its ``first_b`` marked when it was first bound in
    its wave, its eviction time ``t_b`` recorded, ``evictions`` counted, and
    a non-gang victim joins the retry buffer while it has room (else
    ``rdrop``); a gang victim stays displaced. With ``tb.reject`` each
    victim's episode mark is cleared (an eviction starts a new episode),
    with ``tb.log`` its ``evict`` record appended, in victim order."""
    rt = tb.retry
    RB = rt.rbuf.shape[1]
    gid = tb.pods.group_id
    for n in nodes:
        cur = bound_nodes(tb, choices, s, b - 1)
        for v in torch.nonzero(cur == int(n)).flatten().tolist():
            if tb.reject is not None:
                tb.reject.attributed[s, v] = 0
            log_append(tb.log, s, LOG_EVICT, b, v, int(n))
            _unbind_planes(tb, s, v, int(n))
            keep = rt.pend_id[s] != v
            m = int(keep.sum())
            for x in (rt.pend_id, rt.pend_node, rt.pend_relb):
                row = x[s][keep].clone()
                x[s].fill_(PAD)
                x[s, :m] = row
            if int(rt.rnode[s, v]) >= 0:
                rt.rnode[s, v] = PAD
                rt.rrel[s, v] = NEVER
            else:
                choices[s, int(rt.col_of[v])] = PAD
            if int(rt.first_b[s, v]) == PAD:
                rt.first_b[s, v] = FIRST_IN_WAVE
            rt.evict_t[s, v] = float(t_b)
            rt.evictions[s] += 1
            if int(gid[v]) < 0:
                c = int(rt.rcount[s])
                if c < RB:
                    rt.rbuf[s, c] = v
                    rt.rcount[s] = c + 1
                else:
                    rt.rdrop[s] += 1


def evict_nodes(tb: Tables, choices: torch.Tensor, scen: torch.Tensor, off: torch.Tensor,
                nodes: torch.Tensor, b: int, t_b: float) -> None:
    """K10's launch as its twin: :func:`evict_node` in scenario ``scen[i]``
    over its down nodes ``nodes[off[i]:off[i + 1]]``, scenario by scenario
    (each scenario's eviction touches only its own state)."""
    off_h, nodes_h = off.tolist(), nodes.tolist()
    for i, s in enumerate(scen.tolist()):
        evict_node(tb, choices, s, nodes_h[off_h[i] : off_h[i + 1]], b, t_b)


def take_samples(tb: Tables, samples: RetrySamples) -> None:
    """Copy a boundary's series samples from ``tb`` into ``samples`` (each
    buffer given: ``used``, the buffer's count, the pending ids, the
    chunk-start planes)."""
    rt = tb.retry
    for dst, src in ((samples.used, tb.state.used),
                     (samples.rcount, rt.rcount if rt is not None else None),
                     (samples.pend, rt.pend_id if rt is not None else None)):
        if dst is not None:
            dst.copy_(src)
    for dst, src in zip(samples.snap or (), tb.state):
        dst.copy_(src)


def chunk_replay(tb: Tables, idx: torch.Tensor, gang: torch.Tensor, choices: torch.Tensor,
                 first: int, end: int, boundary: Optional[int] = None,
                 append: bool = False, reject: Optional[Reject] = None,
                 retry: Optional[Tuple[int, float, bool]] = None,
                 samples: Optional[RetrySamples] = None) -> None:
    """Plain twin of K6 (csrc/chunk_replay.cu): waves ``[first, end)`` of the
    device slot index ``idx [num_waves * W]`` with gang flags ``gang
    [num_waves]``, in K6's order — for each non-PAD slot ``s`` of wave ``w``,
    :func:`filter_score`, :func:`normalize_select` (into ``choices[:, s]``,
    wave ``w``), with ``reject`` (K6's attributed mode) :func:`first_reject`
    of the slot into those counters, and the bind of
    :func:`apply_placements` (with ``boundary`` and ``append``), and after
    the last such slot of a gang wave the rollback over the wave's W
    columns. With ``retry = (b, t_b, pending)`` (K6's retry mode) the
    boundary's :func:`retry_pass` runs first (``reject`` charges its slots,
    and the waves are not charged: the chunk fold charges them), then
    ``samples`` (:class:`RetrySamples`) are copied."""
    if retry is not None:
        retry_pass(tb, *retry, reject=reject, choices=choices)
        reject = None
        if samples is not None:
            take_samples(tb, samples)
    rtb = tb._replace(reject=reject) if reject is not None else None
    W = idx.numel() // gang.numel()
    rows = idx[first * W : end * W].tolist()
    flags = gang.tolist()
    pos = torch.arange(choices.shape[1], dtype=torch.int32, device=choices.device)
    for w in range(first, end):
        base = w * W
        for s in range(base, base + W):
            p = rows[s - first * W]
            if p < 0:
                continue
            filter_score(tb, p)
            normalize_select(tb, p, choices, s, w)
            if rtb is not None:
                first_reject(rtb, idx[s : s + 1], choices[:, s : s + 1])
            apply_placements(tb, idx[s : s + 1], pos[s : s + 1], choices, 1.0,
                             boundary=boundary, append=append)
        if flags[w]:
            apply_placements(tb, idx[base : base + W], pos[base : base + W], choices, -1.0,
                             rollback=True)


# ---------------------------------------------------------------------------
# Node-plane shards (row B13): the twins of K1 on sharded tables, K7 and K8,
# written per shard over the P shard blocks. A twin reads node-axis data only
# from its own block; what another shard holds comes in through an exchange
# function, each the counterpart of one collective of the reference
# (ops/tpu.py:1316-1470 and eval_pod_fused's shard_ctx sections).
# ---------------------------------------------------------------------------


def new_shards(P: int, n_local: int, n_real: int, S: int, L: int, G: int, device,
               tail_dom: Optional[np.ndarray] = None) -> Shards:
    """The Shards of S scenarios over a choice buffer of L columns; the
    last ``len(tail_dom)`` columns (the pre-bound tail) take the domain ids
    ``tail_dom [n_tail, G]`` of their nodes, every other column PAD."""
    cdom = torch.full((S, L, max(G, 1)), PAD, dtype=torch.int32, device=device)
    if tail_dom is not None and len(tail_dom):
        cdom[:, L - len(tail_dom):] = torch.as_tensor(
            np.ascontiguousarray(tail_dom, np.int32), device=device)
    return Shards(
        P=int(P), n_local=int(n_local), n_real=int(n_real),
        ext=torch.zeros((S, P, NUM_EXT), dtype=torch.float32, device=device),
        best_v=torch.zeros((S, P), dtype=torch.float32, device=device),
        best_i=torch.zeros((S, P), dtype=torch.int32, device=device),
        cdom=cdom,
    )


def shard_view(tb: Tables, i: int) -> Tables:
    """Shard ``i``'s block of a sharded Tables: its rows of every node-axis
    table (allocatable, taints, expression matches, node → domain, ``used``
    and the scratch rows), as views; the replicated count planes and the
    pod tables as they are."""
    sh = tb.shards
    b = slice(i * sh.n_local, (i + 1) * sh.n_local)
    cl, st, x = tb.cluster, tb.state, tb.scratch
    return tb._replace(
        cluster=cl._replace(
            allocatable=cl.allocatable[..., b, :], taint_key=cl.taint_key[..., b, :],
            taint_kv=cl.taint_kv[..., b, :], taint_effect=cl.taint_effect[..., b, :],
            expr_match=cl.expr_match[:, b], gdom=cl.gdom[:, :, b]),
        state=st._replace(used=st.used[:, b]),
        scratch=Scratch(feasible=x.feasible[:, b], scores=x.scores[:, :, b],
                        ignored=x.ignored[:, b]),
        shards=None,
    )


def exchange_pmax(rows) -> torch.Tensor:
    """The packed max of the shards' normalization extrema and any-feasible
    bits (ops/tpu.py:1211-1223, one ``pmax``): the P ``[S, NUM_EXT]`` rows →
    ``[S, NUM_EXT]``. Exact: an f32 max of maxes is the max."""
    return torch.stack(list(rows), dim=1).amax(dim=1)


def exchange_all_gather(parts) -> torch.Tensor:
    """Every shard's ``[S, ...]`` part, stacked ``[S, P, ...]`` in shard
    order (ops/tpu.py:1390, the ``all_gather`` of the (score, gid) pair)."""
    return torch.stack(list(parts), dim=1)


def exchange_owner_psum(rows, mine) -> torch.Tensor:
    """The owner-masked sum of the shards' ``[S, G]`` i32 domain rows
    (ops/tpu.py:1395-1400): shard i contributes its row where ``mine[i]``
    ([S] bool) and 0 elsewhere, so the sum is the owner's row exactly (and
    0 where no shard owns the slot)."""
    out = None
    for r, m in zip(rows, mine):
        part = torch.where(m[:, None], r, torch.zeros_like(r))
        out = part if out is None else out + part
    return out


def shard_filter_score(tb: Tables, p: int) -> None:
    """Plain twin of K1 under node shards: each shard block's mask and raw
    Score rows of pod ``p`` (:func:`filter_score` on the block, the replicated
    count planes read where they are), its pad rows (global id >= n_real)
    masked infeasible whatever their fill (ops/tpu.py:1096-1100) — K1's
    launch over the padded node axis. The reference's per-constraint
    spread ``pmin`` (:1134-1137) has no counterpart here: the domain-space
    count planes are replicated, so each shard's spread minimum over the
    domains is already the global one."""
    sh = tb.shards
    for i in range(sh.P):
        v = shard_view(tb, i)
        filter_score(v, p)
        gid = torch.arange(i * sh.n_local, (i + 1) * sh.n_local, device=v.scratch.feasible.device)
        v.scratch.feasible.logical_and_(gid < sh.n_real)


def shard_select(tb: Tables, p: int, choices: torch.Tensor, slot: int) -> None:
    """Plain twin of K7 (csrc/shard_select.cu; ops/tpu.py:1316
    ``select_node_sharded`` with the sharded normalize of eval_pod_fused,
    :1200-1225): (0) each shard block's packed extrema of its scratch rows
    into ``shards.ext[:, i]``; (a) their fold through :func:`exchange_pmax`;
    (b) each block's weighted total against them (K2's order) and its
    (max total, lowest global id) pair, ``SHARD_NONE`` for a shard with no
    feasible node; (c) the pairs through :func:`exchange_all_gather`,
    folded in shard order — the larger total wins, the lower id on equal
    totals; (d) the choice (PAD: unplaced) into ``choices[:, slot]`` and
    the winner's domain ids, read by the owner shard in its own block and
    passed on by :func:`exchange_owner_psum`, into ``shards.cdom[:, slot]``.
    The choice equals :func:`normalize_select`'s on the unsharded tables."""
    sh = tb.shards
    nl = sh.n_local
    for i in range(sh.P):
        sh.ext[:, i] = row_extrema(shard_view(tb, i).scratch)
    ext = exchange_pmax(sh.ext[:, i] for i in range(sh.P))
    for i in range(sh.P):
        v = shard_view(tb, i)
        total = weighted_total(v, p, ext)
        masked = torch.where(v.scratch.feasible, total, torch.full_like(total, float("-inf")))
        mx = masked.amax(dim=-1)
        ar = torch.arange(nl, device=total.device)
        loc = torch.where(masked == mx[:, None], ar, torch.full_like(ar, nl)).amin(dim=-1)
        sh.best_v[:, i] = mx
        sh.best_i[:, i] = torch.where(mx > float("-inf"), i * nl + loc,
                                      torch.full_like(loc, SHARD_NONE)).to(torch.int32)
    V = exchange_all_gather(sh.best_v[:, i] for i in range(sh.P))
    I = exchange_all_gather(sh.best_i[:, i] for i in range(sh.P))
    bv, bi = V[:, 0], I[:, 0]
    for q in range(1, sh.P):
        better = (V[:, q] > bv) | ((V[:, q] == bv) & (I[:, q] < bi))
        bv, bi = torch.where(better, V[:, q], bv), torch.where(better, I[:, q], bi)
    placed = bv > float("-inf")
    choice = torch.where(placed, bi, torch.full_like(bi, PAD))
    owner = torch.where(placed, choice // nl, torch.full_like(choice, -1))
    rows = []
    for i in range(sh.P):
        gd = _rows(tb.cluster, tb.cluster.gdom)[:, :, i * nl:(i + 1) * nl]  # [S|1, G, nl]
        local = (choice - i * nl).clamp(0, nl - 1).long()
        rows.append(torch.gather(gd.expand(choice.shape[0], -1, -1), 2,
                                 local[:, None, None].expand(-1, gd.shape[1], 1))[:, :, 0])
    dom = exchange_owner_psum(rows, [owner == i for i in range(sh.P)])
    choices[:, slot] = choice
    sh.cdom[:, slot] = torch.where(placed[:, None], dom, torch.full_like(dom, PAD))


def shard_apply(tb: Tables, pod_ids: torch.Tensor, pos: torch.Tensor, choices: torch.Tensor,
                sign: float, rollback: bool = False) -> None:
    """Plain twin of K8 (csrc/shard_apply.cu; ops/tpu.py:1406
    ``apply_binding_sharded``, :1435 ``apply_unbind_wave_sharded`` and the
    sharded release, sim/jax_runtime.py:1224-1240): ``sign`` × the
    contribution of each pair (``pod_ids[k]`` [K], the node ``choices[s,
    pos[k]]``), in pair order. Each shard block takes the pairs whose node
    it owns into its ``used`` rows — a release (``sign < 0``, not a
    rollback) each node's requests summed from zero in pair order and
    subtracted once, as K3's — and the replicated count planes take every
    pair at the domain ids of its column (``shards.cdom``), never another
    shard's node tables. ``rollback`` (a gang wave's end) restricts the pairs
    to failed-gang members and writes PAD over their choices."""
    sh, pods, st = tb.shards, tb.pods, tb.state
    S, N, R = st.used.shape
    posl = pos.long()
    nodes = choices[:, posl]
    pid = pod_ids.expand(S, -1)
    keep = (gang_rollback_mask(pods, pod_ids, nodes) if rollback
            else (pid >= 0) & (nodes >= 0))
    ss, kk = torch.nonzero(keep, as_tuple=True)
    if ss.numel():
        p = pid[ss, kk].long()
        n = nodes[ss, kk].long()
        flat = st.used.view(S * N, R)
        for i in range(sh.P):
            own = (n // sh.n_local) == i
            if not bool(own.any()):
                continue
            rows, req = ss[own] * N + n[own], pods.requests[p[own]]
            if sign < 0 and not rollback:
                delta = torch.zeros_like(flat)
                _add_in_pair_order(delta, rows, req, pid.shape[1] == 1)
                flat.sub_(delta)
            else:
                _add_in_pair_order(flat, rows, sign * req, pid.shape[1] == 1)
        _apply_planes(tb, ss, p, sh.cdom[ss, posl[kk]].T, sign)
    if rollback:
        choices[:, posl] = torch.where(keep, torch.full_like(nodes, PAD), nodes)


def shard_chunk_replay(tb: Tables, idx: torch.Tensor, gang: torch.Tensor, choices: torch.Tensor,
                       first: int, end: int) -> None:
    """Plain twin of K9 (csrc/shard_chunk_replay.cu; sim/jax_runtime.py:548
    ``make_chunk_fn_sharded``): waves ``[first, end)`` of the device slot
    index ``idx [num_waves * W]`` with gang flags ``gang [num_waves]`` on
    node-sharded tables, in K9's order — for each non-PAD slot ``s``,
    :func:`filter_score` (K1 over the padded node axis), :func:`shard_select`
    (into ``choices[:, s]`` and ``shards.cdom[:, s]``) and the bind of
    :func:`shard_apply`, and after the last such slot of a gang wave K8's
    rollback over the wave's W columns."""
    W = idx.numel() // gang.numel()
    rows = idx[first * W : end * W].tolist()
    flags = gang.tolist()
    pos = torch.arange(choices.shape[1], dtype=torch.int32, device=choices.device)
    for w in range(first, end):
        base = w * W
        for s in range(base, base + W):
            p = rows[s - first * W]
            if p < 0:
                continue
            filter_score(tb, p)
            shard_select(tb, p, choices, s)
            shard_apply(tb, idx[s : s + 1], pos[s : s + 1], choices, 1.0)
        if flags[w]:
            shard_apply(tb, idx[base : base + W], pos[base : base + W], choices, -1.0,
                        rollback=True)


# ---------------------------------------------------------------------------
# Boundary bookkeeping of the retry buffer (K4 twin)
# ---------------------------------------------------------------------------


def _stable_front(flags: torch.Tensor, RB: int) -> torch.Tensor:
    """[S, RB] indices that bring each row's True entries to the front in
    their order (the first RB of them)."""
    return torch.argsort((~flags).to(torch.int8), dim=1, stable=True)[:, :RB]


def retry_boundary(tb: Tables, b: int, t_b: float) -> None:
    """Plain twin of K4 (csrc/retry_boundary.cu): boundary ``b``'s
    bookkeeping after the retry pass (sim/whatif.py:1456-1497; the host
    pass of sim/boundary.py:547-678), in each scenario:

    1. each buffered pod the pass placed (``rchoice >= 0``) records its
       node in ``rnode`` and ``b`` in ``rbind_b``;
    2. the pending list drops its due entries (``relb <= b``: K3 released
       them before the pass) and then appends, in buffer order, each
       placed pod whose release boundary ``relb = max(searchsorted_left(
       tbt, f32(t_b) + f32(duration)), b + 1)`` exists (the search below
       ``len(tbt)``), stably, capped at RB (a release that does not fit is
       lost: the pod keeps its node to the end);
    3. the buffer keeps its unplaced pods, stably (``rcount`` their
       number).

    Entries past a list's end are PAD in every field. With chaos tables (a
    Retry with ``rrel``, no kube) each placed pod also records the boundary
    of its pending release in ``rrel`` (NEVER where none was listed) and its
    first bind in ``first_b``; with ``evict_t``, an evicted pod placed here
    is counted re-bound (:func:`chaos_rebind`), in buffer order."""
    rt = tb.retry
    RB = rt.rbuf.shape[1]
    rbuf, ch = rt.rbuf, rt.rchoice
    valid = rbuf >= 0
    placed = valid & (ch >= 0)
    s_i, k_i = torch.nonzero(placed, as_tuple=True)
    q = rbuf[s_i, k_i].long()
    rt.rnode[s_i, q] = ch[s_i, k_i]
    rt.rbind_b[s_i, q] = b
    if rt.evict_t is not None:
        for s_, q_ in zip(s_i.tolist(), q.tolist()):  # scenario-major, buffer order
            chaos_rebind(rt, s_, q_, b)
    v = torch.tensor(t_b, dtype=torch.float32, device=rbuf.device) + rt.dur[rbuf.clamp(min=0).long()]
    rbn = torch.searchsorted(rt.tbt, v.contiguous(), right=False).to(torch.int32)
    add = placed & (rbn < rt.tbt.shape[0])
    relb_new = torch.clamp(rbn, min=b + 1)
    keep_old = (rt.pend_id >= 0) & (rt.pend_relb > b)
    if rt.rrel is not None:
        # a new entry is listed while the kept ones and the new ones before
        # it number fewer than RB
        listed = add & (keep_old.sum(dim=1, keepdim=True) + add.cumsum(dim=1) <= RB)
        rt.rrel[s_i, q] = torch.where(listed[s_i, k_i], relb_new[s_i, k_i],
                                      torch.full_like(relb_new[s_i, k_i], NEVER))
        first = rt.first_b[s_i, q]
        rt.first_b[s_i, q] = torch.where(first == PAD, torch.full_like(first, b), first)
    ids = torch.cat([torch.where(keep_old, rt.pend_id, torch.full_like(rbuf, PAD)),
                     torch.where(add, rbuf, torch.full_like(rbuf, PAD))], dim=1)
    node = torch.cat([rt.pend_node, ch], dim=1)
    relb = torch.cat([rt.pend_relb, relb_new], dim=1)
    o = _stable_front(ids >= 0, RB)
    kept = torch.gather(ids, 1, o) >= 0
    padded = lambda t: torch.where(kept, torch.gather(t, 1, o), torch.full_like(kept, PAD,
                                                                                 dtype=t.dtype))
    new_id, new_node, new_relb = padded(ids), padded(node), padded(relb)
    rt.pend_id.copy_(new_id)
    rt.pend_node.copy_(new_node)
    rt.pend_relb.copy_(new_relb)
    keep_q = valid & (ch < 0)
    oq = _stable_front(keep_q, RB)
    rt.rbuf.copy_(torch.where(torch.gather(keep_q, 1, oq), torch.gather(rbuf, 1, oq),
                              torch.full_like(rbuf, PAD)))
    rt.rcount.copy_(keep_q.sum(dim=1).to(torch.int32))


# ---------------------------------------------------------------------------
# First-reject attribution (K5 twin)
# ---------------------------------------------------------------------------


def filter_masks(tb: Tables, p: int) -> list:
    """The Filter masks of pod ``p`` in every scenario (``[S, N]`` bool
    each), one per plugin that is on, in ``spec_plugin_names`` order —
    the ``masks`` of eval_pod(want_masks=True)
    (kubernetes_simulator_tpu/sim/jax_runtime.py:270), from the same
    per-plugin functions :func:`filter_score` ANDs."""
    cl, pods, st, k = tb.cluster, tb.pods, tb.state, tb.consts
    S, N = st.used.shape[:2]
    full = lambda m: m.expand(S, N)  # a [1, N] mask of shared inputs broadcasts
    out = []
    if k.fit:
        out.append(full(fit_mask(cl, st, pods, p)))
    if k.taints:
        out.append(full(taint_mask(cl, pods, p)))
    if k.node_affinity:
        out.append(full(node_affinity_mask(cl, pods, p)))
    if k.interpod:
        out.append(full(interpod_filter_mask(cl, st, pods, p)))
    if k.spread:
        out.append(full(spread_filter_mask(cl, st, pods, p)))
    return out


def first_reject_counts(masks) -> Tuple[torch.Tensor, torch.Tensor]:
    """(``[S, K]`` i32 nodes each plugin rejects first, ``[S]`` bool some
    node passes every plugin) of ordered ``[S, N]`` masks
    (kubernetes_simulator_tpu/ops/tpu.py:816 first_reject_counts, per
    scenario and ungated)."""
    so_far = torch.ones_like(masks[0])
    outs = []
    for m in masks:
        outs.append((so_far & ~m).sum(dim=-1).to(torch.int32))
        so_far = so_far & m
    return torch.stack(outs, dim=-1), so_far.any(dim=-1)


def first_reject(tb: Tables, pod_ids: torch.Tensor, gate: torch.Tensor) -> None:
    """Plain twin of K5 (csrc/first_reject.cu): for each of M slots, pod
    ``pod_ids[m]`` (``[M]``, shared) or ``pod_ids[s, m]`` (``[S, M]``, one
    pod per scenario: the retry pass), in each scenario s where the pod is
    valid, its gate choice ``gate[s, m]`` is PAD and no node passes every
    Filter at ``tb.state``: add the first-reject counts to
    ``tb.reject.attempts[s]`` and, when the pod's episode is not charged
    yet, to ``reasons[s]`` and mark it (sim/telemetry.py:338-404). Slots
    are taken in order (a pod occurs in at most one slot per call)."""
    rj = tb.reject
    S = gate.shape[0]
    for m in range(gate.shape[1]):
        col = pod_ids[:, m] if pod_ids.dim() == 2 else pod_ids[m].expand(S)
        for q, idx in _pods_of_scenarios(col):
            fail = gate[idx, m] < 0
            if not bool(fail.any()):
                continue
            sub = _scenario_subset(tb, idx)
            counts, feasible = first_reject_counts(filter_masks(sub, q))
            charge = fail & ~feasible
            new = charge & (rj.attributed[idx, q] == 0)
            rj.attempts[idx] += torch.where(charge[:, None], counts, torch.zeros_like(counts))
            rj.reasons[idx] += torch.where(new[:, None], counts, torch.zeros_like(counts))
            rj.attributed[idx, q] = torch.where(new, torch.ones_like(rj.attributed[idx, q]),
                                                rj.attributed[idx, q])
