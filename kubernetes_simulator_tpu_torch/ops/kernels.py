"""The replay's hand-written Hopper kernels: build, binding and wrappers.

Ten CUDA C++ kernels (``csrc/*.cu``, compiled for ``sm_90a``) carry the
device work of the replay and of the scenario-batched what-if: every
kernel takes the S-stacked tables of :mod:`.reference` (the
single-scenario replay is S = 1) and runs each scenario in its own
blocks:

============================  ================================================
wrapper                       replaces (kubernetes_simulator_tpu/...)
============================  ================================================
:func:`filter_score` (K1)     ops/tpu3.py:944 make_wave_step3 Filter+Score,
                              with build_wave_pre3 :712, class_masks :923,
                              _fit_score_r :869 folded in
:func:`normalize_select` (K2) ops/tpu.py:739 select_node (+ :840 packed) and
                              the normalize of make_wave_step3
                              (_normalize_row :699, spread_norm_from_extrema
                              :565)
:func:`apply_placements` (K3) sim/jax_runtime.py:1414 _apply_release / :1475
                              _donated_subtract, sim/whatif.py:1620
                              _release_core / :1742 _release_fn, and
                              make_wave_step3's wave commit and gang rollback
:func:`retry_boundary` (K4)   sim/whatif.py:1456-1497, the boundary
                              bookkeeping of the retry variant of
                              _build_chunk_fn (pending list, compaction)
:func:`first_reject` (K5)     ops/tpu.py:816 first_reject_counts over
                              eval_pod(want_masks=True) (sim/jax_runtime.py
                              :270, :405), and the retry pass's host
                              attribution (sim/boundary.py:563-582)
:func:`first_reject_fold`     K5 as the retry path's chunk fold
                              (sim/boundary.py:360-398), counted apart
:func:`chunk_replay` (K6)     sim/jax_runtime.py:742 make_chunk_fn3_src (the
                              chunk program: one launch a chunk), with the
                              slot gathers ops/tpu.py:285, ops/tpu3.py:633;
                              attributed: :443 make_chunk_fn_rej (+ :405);
                              retry: sim/whatif.py:1413 per_scenario_retry
                              (the boundary sequence :1433-1494)
:func:`shard_select` (K7)     ops/tpu.py:1316 select_node_sharded and the
                              sharded normalize of eval_pod_fused
                              (:1200-1225, the packed pmax)
:func:`shard_apply` (K8)      ops/tpu.py:1406 apply_binding_sharded, :1435
                              apply_unbind_wave_sharded and the sharded
                              release (sim/jax_runtime.py:1224-1240)
:func:`shard_chunk_replay`    sim/jax_runtime.py:548 make_chunk_fn_sharded
(K9)                          (the node-sharded chunk program: one launch a
                              chunk) with :494 make_wave_step_sharded
:func:`evict_node` (K10)      sim/boundary.py:430 evict_node (a chaos
                              node_down's NoExecute eviction; applied at
                              sim/jax_runtime.py:1755-1793, sim/whatif.py
                              :3266-3330)
============================  ================================================

K6 runs K1's, K2's and K3's bodies (``csrc/ksim.cuh``) for every slot of
a chunk's waves in one launch, one thread-block cluster a scenario with no
grid barrier, so a chunk on the chunk route equals the same chunk on the
per-slot route (K1 → K2 → K3 a slot) bit for bit; :mod:`..sim.torch_runtime`
chooses the route from the run's mode.

K3's release (``sign < 0``, not a rollback) is two launches of its own in
``csrc/apply_placements.cu`` (``ksim_release``): each tile of a scenario's
pairs sorted by (node, pair) in shared memory, then each node's requests
summed tile by tile in pair order by one thread a (node, resource) and
subtracted once; the count planes take integer sums
(:func:`apply_placements`).

The selects — K2, K6 and K7 — launch as thread-block clusters (Hopper,
``sm_90a``): a scenario is one cluster of C blocks on neighbouring SMs, each
block reducing its part of the node axis (K7: its shards), the C results
folded through distributed shared memory after a cluster barrier.
:func:`cluster_plan` chooses C, the block width, the grid and each block's
nodes or shards from the shapes and the card's SM count alone; a refused
launch raises.

First-reject attribution runs only at telemetry ``series``/``timeline``:
on the plain path inside K6 (its attributed mode, ``chunk_replay(reject=)``,
a second instantiation of the kernel, compiled in
``csrc/chunk_replay_attributed.cu``, that runs K5's count body from
``ksim.cuh`` for each failed slot before its bind — sim/jax_runtime.py:443
make_chunk_fn_rej); on the retry path inside K6's retry mode for the retry
pass (``chunk_replay(retry=, reject=)``; under kube the kube pass counts a
pod before the PostFilter and charges it only where the PostFilter finds no
node, and clears the episode marks of its victims and bound pods) and as K5
for the chunk folds; on the per-slot route as K5. K10 clears its victims'
marks. At ``timeline`` under kube or a chaos timeline the tables' event log
(:class:`.reference.EventLog`, :func:`check_log`) takes K10's ``evict`` and
the retry pass's ``preempt`` / ``bind`` records. The default ``summary``
runs K6's summary instantiation, unchanged.

Under node shards (a Tables with ``shards``, row B13: sim/jax_runtime.py:494
make_wave_step_sharded, :548 make_chunk_fn_sharded) a slot is K1 over the
padded node axis (pad rows infeasible) → K7 (each shard's packed
normalization extrema over its own block, then the two-stage choice) →
K8's bind, with K8's rollback after a gang wave and K8's release at a
boundary; K9 runs K1's per-node body and K7's and K8's bodies
(``csrc/ksim.cuh``) for every slot of a chunk in one launch, one
thread-block cluster a scenario (K7's geometry) with no grid barrier, so a
chunk on K9 equals the same chunk on K1 → K7 → K8 bit for bit; K2, K3, K5
and K6 refuse sharded tables.

Under the retry buffer (a Tables with ``retry``) K1–K3 also take one pod
per scenario (the retry pass), K3 appends failed non-gang pods to the
buffer on a main-path bind (sim/whatif.py:1502-1528) and releases the
pending list's due entries (:1437-1443 through ``_release_core``). On the
chunk route K6's retry mode (``chunk_replay(retry=)``, a third
instantiation compiled in ``csrc/chunk_replay_retry.cu``) runs that
boundary sequence — the pending release, the retry pass over each
scenario's buffered pods with K1's, K2's and K3's bodies, K4's
bookkeeping (``ksim.cuh`` ``ksim_retry_bookkeeping``, K4's own body) —
in the chunk's launch before its waves; K1–K4 launch it on the per-slot
route. Under kube preemption the retry mode runs the kube pass instead
(``chunk_replay(retry=)`` on Retry tables with ``prio``; the PostFilter is
``ksim.cuh`` ``ksim_post_filter``; its tables reach the kernel in
``KsimRetryPhase``'s ``KsimKube``, the scratch is :class:`Bound`'s); the
per-slot route refuses kube.

Under a chaos timeline (a Retry with ``evict_t``) K10 runs at a boundary
where a ``node_down`` falls due, before the boundary's releases, one block
a scenario with one: it evicts the down nodes' pods (its twin
:func:`.reference.evict_node`), and K6's retry mode then counts each
victim's re-bind (``KsimRetryPhase``'s chaos fields).

In a what-if batch whose scenarios relabel nodes (``set_label``; row B11,
the dyn sections of ops/tpu3.py:944 make_wave_step3 and the dyn release
of sim/whatif.py:1760-1817) K1 and K3 read the label tables (expression
matches, node domains, domain counts, spread weights) from the row
``lrow[s]`` of their scenario; K2 and K4 read no label table.

With per-scenario policies (a Tables with ``wrow``, row B1w: ops/tpu.py:62
policy_weight_fns and the ``wvec`` sections of ops/tpu3.py:947-985,
:1316-1329) K1 takes each scenario's NodeResourcesFit strategy and K2 its
five Score weights from the scenario's row of ``wrow [S, 6]``; a null
``wrow`` keeps the static constants, byte for byte.

Under tier preemption (a Tables with ``preempt``) the same three kernels
carry ops/tpu3.py's preemption sections: K1 the candidate row (:1510), K2
the masked argmin (ops/tpu.py:788 masked_argmin) and the eviction record,
K3 the eviction and per-tier commit (:1629-1730, :1796) and the tier
releases (sim/whatif.py:2145 _tier_rel_fn, :2161 _npods_rel_fn).

Each wrapper takes its plain twin (:mod:`.reference`) for CPU tensors and
launches its kernel for CUDA tensors — it never falls back: a failed
build or launch raises. A launch adds one to the wrapper's ``launches``
count (``reset_launch_counts`` zeroes them), so a run can show that it
went through the kernels; K3 and K8 also count each launch under its mode
(``modes``: bind, rollback, release).

Build at first use: every ``csrc/*.cu`` is compiled by ``nvcc`` — one
process per source, all started together — into a shared library with a
plain C interface under ``_build/`` (listed in ``.gitignore``), keyed by
a hash of the sources and flags, and loaded with ``ctypes``. The flags
keep the floor-quantized scores bit-identical to the reference:
``--fmad=false`` (no a·b+c contraction), IEEE division and square root,
never ``-use_fast_math``.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
import dataclasses
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import torch

from . import reference as ref
from .policy import POLICY_COLS

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    "--fmad=false", "--prec-div=true", "--prec-sqrt=true",
    "-shared", "-Xcompiler", "-fPIC",
)

#: kernel name → source file (its C entry point is ``ksim_<name>``)
KERNELS = {
    "filter_score": "filter_score.cu",
    "normalize_select": "normalize_select.cu",
    "apply_placements": "apply_placements.cu",
    "retry_boundary": "retry_boundary.cu",
    "first_reject": "first_reject.cu",
    "chunk_replay": "chunk_replay.cu",
    "shard_select": "shard_select.cu",
    "shard_apply": "shard_apply.cu",
    "shard_chunk_replay": "shard_chunk_replay.cu",
    "evict_node": "evict_node.cu",
}

#: argtypes of each C entry point (every one returns a cudaError_t as int)
_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_ARGTYPES = {
    # (args, pod, pod_of_s, pod_ss, stream)
    "filter_score": [_P, _I, _P, _LL, _P],
    # (args, pod, choice_out, choice_ss, wave, pod_of_s, pod_ss, C, threads, span, stream)
    "normalize_select": [_P, _I, _P, _LL, _I, _P, _LL, _I, _I, _I, _P],
    # (args, pods, pod_ss, pos, choices, K, choice_ss, sign, rollback, boundary, append,
    #  stream)
    "apply_placements": [_P, _P, _LL, _P, _P, _I, _LL, _F, _I, _I, _I, _P],
    # (args, b, t_b, stream)
    "retry_boundary": [_P, _I, _F, _P],
    # (args, pods, pod_ss, M, gate, gate_ss, reasons, attempts, attributed, K, attr_ss,
    #  stream)
    "first_reject": [_P, _P, _LL, _I, _P, _LL, _P, _P, _P, _I, _LL, _P],
    # (args, idx, gang, choices, choice_ss, W, first, end, boundary, append, C, threads, span,
    #  reasons, attempts, attributed, K, attr_ss, retry, retry_size, stream)
    "chunk_replay": [_P, _P, _P, _P, _LL, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _I, _LL,
                     _P, _I, _P],
    # K6's attributes (chunk_replay.cu): (mode, regs, shared_bytes, max_threads)
    "chunk_replay_attrs": [_I, _P, _P, _P],
    # K3's release (apply_placements.cu): (args, pods, pod_ss, pos, choices, K, choice_ss,
    #  due_relb, due_b, P, keys, run, dplane, stream)
    "release": [_P, _P, _LL, _P, _P, _I, _LL, _P, _I, _I, _P, _P, _P, _P],
    # (args, pod, choices, choice_ss, slot, C, threads, stream)
    "shard_select": [_P, _I, _P, _LL, _I, _I, _I, _P],
    # (args, pods, pos, choices, K, choice_ss, sign, rollback, stream)
    "shard_apply": [_P, _P, _P, _P, _I, _LL, _F, _I, _P],
    # (args, idx, gang, choices, choice_ss, W, first, end, C, threads, stream)
    "shard_chunk_replay": [_P, _P, _P, _P, _LL, _I, _I, _I, _I, _I, _P],
    # K9's attributes (shard_chunk_replay.cu): (regs, shared_bytes, max_threads)
    "shard_chunk_replay_attrs": [_P, _P, _P],
    # (args, ev, ev_size, m, stream)
    "evict_node": [_P, _P, _I, _I, _P],
}

_MAX_SEG = 16
_MAX_TERMS = 64
_MAX_WAVE = 1024
_MAX_RB = 4096  # the granularity guard's cap (sim/granularity.py)
#: Most pairs a block of K3's release sorts (K3R_TILE in apply_placements.cu).
RELEASE_TILE = 4096
#: Fewest pairs a block of K3's release sorts where K allows more.
RELEASE_MIN_TILE = 1024
#: Entry points a library exports beside its kernel's ``ksim_<name>``.
_EXTRA_ENTRIES = {"apply_placements": ("release",),
                  "chunk_replay": ("chunk_replay_attrs",),
                  "shard_chunk_replay": ("shard_chunk_replay_attrs",)}
#: Sources a library links beside its kernel's own: K6's attributed and
#: retry instantiations compile in translation units of their own, so the
#: summary build's code is what it is without the modes (chunk_replay.cu).
EXTRA_SOURCES = {"chunk_replay": ("chunk_replay_attributed.cu", "chunk_replay_retry.cu")}
#: K6's builds, in the order ``ksim_chunk_replay_attrs`` numbers them.
CHUNK_REPLAY_MODES = ("summary", "attributed", "retry")


#: Largest cluster of the selects: the portable size, which every Hopper part
#: schedules without the non-portable opt-in.
CLUSTER_CAP = 8
#: The selects' full block width (K6's and K9's always, K6_THREADS in
#: chunk_replay.cu and K9_THREADS in shard_chunk_replay.cu; K2's and K7's
#: above the narrow case).
SELECT_THREADS = 1024
#: Narrowest block of K2 and K7 (a small node axis takes fewer warps per
#: block reduction).
MIN_THREADS = 256


def _round32(n: int) -> int:
    return -(-n // 32) * 32


@dataclass(frozen=True)
class ClusterPlan:
    """Launch geometry of a cluster-per-scenario select: scenario s is the
    cluster of blocks ``[s*C, (s+1)*C)``; block rank r owns the nodes
    :meth:`node_range` (K2, both phases of K6) or the shards :meth:`shards`
    (K7)."""

    S: int
    N: int  #: the node axis (K7: the padded one, NP shard blocks)
    NP: int  #: node shards (1 unsharded)
    C: int  #: blocks a cluster
    threads: int  #: block width
    span: int  #: nodes of a rank (unsharded) / of a shard (K7)
    grid: int  #: blocks of the launch, a multiple of C

    def node_range(self, r: int) -> Tuple[int, int]:
        """The nodes ``[lo, hi)`` of block rank r (unsharded)."""
        lo = min(self.N, r * self.span)
        return lo, min(self.N, lo + self.span)

    def shards(self, r: int) -> Tuple[int, ...]:
        """The shards block rank r reduces, in shard order (K7)."""
        return tuple(range(r, self.NP, self.C))


def cluster_plan(S: int, N: int, NP: Optional[int] = None, *, sms: int) -> ClusterPlan:
    """The launch geometry of a select over S scenarios of N nodes (``NP``:
    K7 over NP shards of N / NP nodes), a pure function of the shapes and
    the card's SM count: S clusters of C blocks, grid S·C.

    - ``sms``: the card's SMs, each running one block of
      :data:`SELECT_THREADS` threads of a select at a time. Where S alone
      fills the card (S >= sms) C = 1, the one-block select; otherwise C =
      min(:data:`CLUSTER_CAP`, the 1,024-node tiles (K7: NP), sms // S). A
      second block resident on an SM (K2 and K7 fit two of 1,024 threads)
      adds warps, not an SM: at S = 128, N = 2,000 a cluster of two ran
      slower than one block (``scripts/cluster_sweep.py``).
    - Unsharded, rank r owns ``span`` nodes (a multiple of 32, C·span >= N;
      C shrinks so no rank is empty). K2's and K7's block is one thread a
      node of a rank (a shard), between :data:`MIN_THREADS` and
      :data:`SELECT_THREADS` (K6's: :func:`chunk_plan`).
    - Nothing caps S: a launch's clusters beyond what the card holds at once
      wait for free SMs (no select's cluster waits on another)."""
    if S < 1 or N < 1 or sms < 1:
        raise ValueError(f"cluster_plan: S={S}, N={N}, sms={sms}")
    if NP is not None and (NP < 1 or N % NP):
        raise ValueError(f"cluster_plan: {NP} shards do not tile {N} nodes")
    tiles = -(-N // SELECT_THREADS)
    want = min(CLUSTER_CAP, NP if NP is not None else tiles)
    C = 1 if S >= sms else max(1, min(want, sms // S))
    if NP is not None:
        span = N // NP
    else:
        span = _round32(-(-N // C))
        C = -(-N // span)
    threads = min(SELECT_THREADS, max(MIN_THREADS, _round32(span)))
    return ClusterPlan(S=S, N=N, NP=NP or 1, C=C, threads=threads, span=span, grid=S * C)


def chunk_plan(S: int, N: int, *, sms: int) -> ClusterPlan:
    """K6's launch geometry: K2's C and span (:func:`cluster_plan`; rank r
    owns its nodes in both phases) in blocks of :data:`SELECT_THREADS`,
    since phase 1 runs K1's body a node a thread (``ksim_chunk_replay``
    refuses any other width)."""
    return dataclasses.replace(cluster_plan(S, N, sms=sms), threads=SELECT_THREADS)


def shard_chunk_plan(S: int, N: int, NP: int, *, sms: int) -> ClusterPlan:
    """K9's launch geometry: K7's C over the NP shards of the padded node
    axis N (:func:`cluster_plan`; rank r owns :meth:`ClusterPlan.shards`
    in every phase) in blocks of :data:`SELECT_THREADS`, since phase 1 runs
    K1's body a node a thread (``ksim_shard_chunk_replay`` refuses any
    other width, and any C outside 1..min(8, NP))."""
    return dataclasses.replace(cluster_plan(S, N, NP, sms=sms), threads=SELECT_THREADS)


def release_tile(K: int, S: int = 1, sms: int = 1) -> int:
    """Pairs a block of K3's release sorts, a power of two (``ksim_release``
    refuses any other): the one >= K, at most :data:`RELEASE_TILE`, halved
    down to :data:`RELEASE_MIN_TILE` while the S · tiles sort blocks leave
    some of the card's ``sms`` SMs idle."""
    P = min(RELEASE_TILE, max(2, 1 << (K - 1).bit_length()))
    while P > RELEASE_MIN_TILE and S * -(-K // P) < sms:
        P //= 2
    return P


class KsimKube(ctypes.Structure):
    """Mirror of ``struct KsimKube`` in csrc/ksim.cuh (K6's retry mode under
    kube preemption: the Retry's kube tables, Bound's scratch and the choice
    buffer)."""

    _fields_ = (
        [(name, ctypes.c_void_p) for name in (
            "prio", "col_of", "col_relb", "rrel", "first_b", "preempt", "kq", "kst", "kvic",
            "koff", "kcnt", "choices")]
        + [("choice_ss", ctypes.c_int64), ("trace_has_anti", ctypes.c_int32),
           ("pad0", ctypes.c_int32)]
    )


class KsimLog(ctypes.Structure):
    """Mirror of ``struct KsimLog`` in csrc/ksim.cuh (the timeline's event
    log, :class:`.reference.EventLog`; null ``rec``: none)."""

    _fields_ = [("rec", ctypes.c_void_p), ("n", ctypes.c_void_p), ("cap", ctypes.c_int32),
                ("pad0", ctypes.c_int32)]


class KsimRetryPhase(ctypes.Structure):
    """Mirror of ``struct KsimRetryPhase`` in csrc/chunk_replay.cuh (K6's
    retry mode: the boundary, its series samples, with ``kube`` the kube
    pass's tables, under a chaos timeline the re-bind records and the
    boundary's f64 start time, and the event log; the C entry checks
    sizeof())."""

    _fields_ = (
        [("b", ctypes.c_int32), ("t_b", ctypes.c_float), ("pending", ctypes.c_int32),
         ("kube", ctypes.c_int32)]
        + [(name, ctypes.c_void_p) for name in (
            "used_out", "rcount_out", "pend_out", "snap_used", "snap_mc", "snap_aa", "snap_pw")]
        + [("k", KsimKube), ("t_bd", ctypes.c_double)]
        + [(name, ctypes.c_void_p) for name in ("evict_t", "resched", "evict_lat")]
        + [("log", KsimLog)]
    )


class KsimEvict(ctypes.Structure):
    """Mirror of ``struct KsimEvict`` in csrc/evict_node.cu (one K10 launch:
    its scenarios and down nodes, the node tables, the chaos records, the
    boundary, and the episode marks and event log of telemetry; the C entry
    checks sizeof())."""

    _fields_ = (
        [(name, ctypes.c_void_p) for name in (
            "scen", "off", "nodes", "col_of", "col_relb", "rrel", "first_b", "choices")]
        + [("choice_ss", ctypes.c_int64)]
        + [(name, ctypes.c_void_p) for name in ("evict_t", "evictions")]
        + [("t_bd", ctypes.c_double), ("b", ctypes.c_int32), ("pad0", ctypes.c_int32)]
        + [("attributed", ctypes.c_void_p), ("attr_ss", ctypes.c_int64), ("log", KsimLog)]
    )


class KsimArgs(ctypes.Structure):
    """Mirror of ``struct KsimArgs`` in csrc/ksim.cuh (same field order)."""

    _fields_ = (
        [(name, ctypes.c_void_p) for name in (
            "alloc", "taint_key", "taint_kv", "taint_effect", "expr_match", "gdom",
            "gnd", "sp_w", "lrow",
            "requests", "tol_key", "tol_kv", "tol_effect", "na_req", "na_has_req",
            "na_pref", "na_pref_w", "aff_req", "anti_req", "pref_aff", "pref_aff_w",
            "spread_g", "spread_skew", "spread_dns", "pmg", "group_id",
            "used", "match_count", "anti_active", "pref_wsum",
            "feasible", "scores", "ignored", "res_w",
            "pod_tier", "used_tier", "npods_tier", "cand", "last_wave", "ev_node", "ev_tier",
            "victims", "col_pod", "col_relb",
            "dur", "tbt", "rbuf", "rcount", "rdrop", "rchoice", "pend_id", "pend_node",
            "pend_relb", "rnode", "rbind_b", "wrow", "rel",
            "ext", "best_v", "best_i", "cdom",
        )]
        + [(name, ctypes.c_int64) for name in (
            "alloc_ss", "taint_ss", "used_ss", "plane_ss", "feas_ss", "scores_ss",
        )]
        + [(name, ctypes.c_int32) for name in (
            "S", "N", "R", "TT", "E", "G", "D", "TO", "TR", "TE", "TP", "AR", "AA", "PA", "SP",
            "fit", "taints", "node_affinity", "interpod", "spread",
            "on_fit", "on_taint", "on_na", "on_ip", "on_sp",
            "has_symmetric_pref", "sp_norm_f32", "fit_strategy", "n_seg",
            "preempt", "Tt", "n_slots",
            "retry", "RB", "B", "P",
            "n_real", "NP", "n_local",
        )]
        + [(name, ctypes.c_float) for name in (
            "wsum", "w_fit", "w_taint", "w_na", "w_ip", "w_sp",
            "x_first", "y_first", "y_last", "pad0",
        )]
        + [(name, ctypes.c_float * _MAX_SEG) for name in (
            "seg_x0", "seg_x1", "seg_y0", "seg_inv", "seg_dy",
        )]
    )


# ---------------------------------------------------------------------------
# Build and load
# ---------------------------------------------------------------------------

_lock = threading.Lock()
_libs: Dict[str, Callable] = {}  # kernel name (and _EXTRA_ENTRIES) → its C entry point
#: Wall seconds of the last build (0 when every library came from _build/).
last_build_s = 0.0


def _nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the replay "
        "kernels are built from csrc/ at first use"
    )


def _lib_path(src: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(src.encode())
    return BUILD_DIR / f"{Path(src).stem}-{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> float:
    """Compile every kernel source that has no library in ``_build/`` yet
    and load all of them: one ``nvcc`` per translation unit, all started
    together — a library of one source straight to its shared object, one
    with :data:`EXTRA_SOURCES` (K6's three builds) an object a source, then
    linked. Returns the wall seconds spent compiling."""
    global last_build_s
    with _lock:
        if set(KERNELS) <= set(_libs):
            return 0.0
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        todo = {}
        for name, src in KERNELS.items():
            out = _lib_path(src)
            if not out.exists():
                todo[name] = (src, out, out.with_name(f"{out.stem}.{os.getpid()}.tmp.so"))
        t0 = time.perf_counter()
        compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
        procs, links = [], []
        for name, (src, out, tmp) in todo.items():
            srcs = (src, *EXTRA_SOURCES.get(name, ()))
            if len(srcs) == 1:
                jobs = [([*NVCC_FLAGS, "-o", str(tmp)], srcs[0])]
            else:
                objs = [tmp.with_name(f"{tmp.stem}.{Path(f).stem}.o") for f in srcs]
                jobs = [([*compile_flags, "-c", "-o", str(o)], f) for o, f in zip(objs, srcs)]
                links.append((name, tmp, objs))
            for flags, f in jobs:
                cmd = [_nvcc(), *flags, "-I", str(CSRC), str(CSRC / f)]
                if verbose:
                    cmd.insert(1, "-Xptxas=-v")
                procs.append((name, f, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                )))
        errors = []
        for name, f, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{name} ({f}): nvcc exit {proc.returncode}\n{log}")
            elif verbose and log:
                print(f"[nvcc {name} {f}]\n{log}", flush=True)
        for name, tmp, objs in ([] if errors else links):
            proc = subprocess.run([_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            if proc.returncode != 0:
                errors.append(f"{name} (link): nvcc exit {proc.returncode}\n{proc.stdout}")
            for o in objs:
                o.unlink(missing_ok=True)
        if errors:
            raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
        for src, out, tmp in todo.values():
            os.replace(tmp, out)
        last_build_s = time.perf_counter() - t0 if procs else 0.0
        for name, src in KERNELS.items():
            lib = ctypes.CDLL(str(_lib_path(src)))
            size = lib.ksim_args_size()
            if size != ctypes.sizeof(KsimArgs):
                raise RuntimeError(
                    f"KsimArgs layout mismatch: C {size} B, ctypes "
                    f"{ctypes.sizeof(KsimArgs)} B"
                )
            for entry in (name, *_EXTRA_ENTRIES.get(name, ())):
                fn = getattr(lib, f"ksim_{entry}")
                fn.argtypes = _ARGTYPES[entry]
                fn.restype = ctypes.c_int
                _libs[entry] = fn
        return last_build_s


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"kernel {name}: launch failed with CUDA error {rc}")


_share = threading.local()


@contextlib.contextmanager
def sm_share(n: int):
    """Plans made inside (:func:`select_plan`) see the card's SMs divided by
    ``n``: n batches enqueued on one card at once — the blocks of a meshed
    what-if that share a card (:mod:`..sim.whatif`) — each plan for their
    share, so together they fill the card as one batch would. The geometry
    changes, not what a launch computes."""
    prev = getattr(_share, "n", 1)
    _share.n = max(1, int(n))
    try:
        yield
    finally:
        _share.n = prev


def select_plan(name: str, tb: ref.Tables) -> ClusterPlan:
    """:func:`cluster_plan` of the select ``name`` (``normalize_select``,
    ``chunk_replay``, ``shard_select``, ``shard_chunk_replay``) on the CUDA
    tables ``tb``, over the card's SMs (their share under :func:`sm_share`)."""
    S, N = tb.state.used.shape[:2]
    dev = tb.state.used.device
    sms = max(1, torch.cuda.get_device_properties(dev).multi_processor_count
              // getattr(_share, "n", 1))
    if name == "chunk_replay":
        return chunk_plan(S, N, sms=sms)
    if name == "shard_chunk_replay":
        return shard_chunk_plan(S, N, tb.shards.P, sms=sms)
    NP = tb.shards.P if name == "shard_select" else None
    return cluster_plan(S, N, NP, sms=sms)


# ---------------------------------------------------------------------------
# Argument block
# ---------------------------------------------------------------------------


def _scenario_stride(t: torch.Tensor, S: int, name: str) -> int:
    """Elements between two scenarios' rows of a cluster table: 0 for a
    table shared by every scenario (no leading S), its row size for an
    [S, ...] stack."""
    if t.dim() == 2:
        return 0
    if t.dim() == 3 and t.shape[0] == S:
        return t.shape[1] * t.shape[2]
    raise ValueError(f"{name}: expected [N, *] (shared) or [{S}, N, *], got {tuple(t.shape)}")


def pack_args(tb: ref.Tables, res_w: torch.Tensor, rel: torch.Tensor) -> KsimArgs:
    """The ctypes argument block of one Tables (CUDA tensors only; every
    tensor is contiguous and keeps its storage for the engine's life —
    state updates are in place). ``res_w`` holds the resource weights on
    the device and ``rel`` K3's all-zero release accumulator (the state's
    ``used`` shape); the caller keeps both alive with the block."""
    c, p, s, x, k = tb.cluster, tb.pods, tb.state, tb.scratch, tb.consts
    S, N, R = s.used.shape
    G, D = s.match_count.shape[1:]
    L = c.gdom.shape[0]
    dims = dict(
        S=S, N=N, R=R, TT=c.taint_key.shape[-1],
        E=c.expr_match.shape[-1], G=G, D=D,
        TO=p.tol_key.shape[1], TR=p.na_req.shape[1], TE=p.na_req.shape[2],
        TP=p.na_pref.shape[1], AR=p.aff_req.shape[1], AA=p.anti_req.shape[1],
        PA=p.pref_aff.shape[1], SP=p.spread_g.shape[1],
    )
    if S > 65535:
        raise ValueError(f"{S} scenarios: the kernels' grids take at most 65535")
    if dims["AR"] > _MAX_TERMS or dims["SP"] > _MAX_TERMS:
        raise ValueError(
            f"a pod carries more than {_MAX_TERMS} affinity or spread terms "
            f"(AR={dims['AR']}, SP={dims['SP']}); the kernel's shared-memory "
            "term tables hold at most that many"
        )
    w = p.pref_aff_w
    if not bool(((w == w.round()) & (w.abs() <= 2 ** 20)).all()):
        raise ValueError("pref_aff_w: preferred inter-pod affinity weights are integers "
                         "(Kubernetes' 1-100); K3's release sums them as integers")
    if p.na_pref.shape[2] != dims["TE"]:
        raise ValueError("na_req and na_pref must share the expression width")
    if len(k.seg_x0) > _MAX_SEG:
        raise ValueError(f"RequestedToCapacityRatio shape has more than {_MAX_SEG + 1} points")
    taint_ss = _scenario_stride(c.taint_key, S, "taint_key")
    for name in ("taint_kv", "taint_effect"):
        if getattr(c, name).shape != c.taint_key.shape:
            raise ValueError(f"{name} must have taint_key's shape")
    strides = dict(
        alloc_ss=_scenario_stride(c.allocatable, S, "allocatable"), taint_ss=taint_ss,
        used_ss=N * R, plane_ss=G * D, feas_ss=N, scores_ss=ref.NUM_ROWS * N,
    )
    for name, t in (("alloc", c.allocatable), ("taint_key", c.taint_key)):
        if t.shape[-2:-1] != (N,):
            raise ValueError(f"{name}: {tuple(t.shape)} does not have the state's {N} nodes")
    for name, t, shape in (
        ("anti_active", s.anti_active, (S, G, D)), ("pref_wsum", s.pref_wsum, (S, G, D)),
        ("feasible", x.feasible, (S, N)), ("scores", x.scores, (S, ref.NUM_ROWS, N)),
        ("ignored", x.ignored, (S, N)), ("gdom", c.gdom, (L, G, N)),
        ("expr_match", c.expr_match, (L, N, dims["E"])), ("gnd", c.gnd, (L, G)),
        ("sp_w", c.sp_w, (L, G)), ("lrow", c.lrow, (S,)),
    ):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if c.lrow.dtype != torch.int32 or not bool(((c.lrow >= 0) & (c.lrow < L)).all()):
        raise ValueError(f"lrow: int32 label rows in [0, {L}) expected")
    tensors = {
        "alloc": c.allocatable, "taint_key": c.taint_key, "taint_kv": c.taint_kv,
        "taint_effect": c.taint_effect, "expr_match": c.expr_match, "gdom": c.gdom,
        "gnd": c.gnd, "sp_w": c.sp_w, "lrow": c.lrow,
        **{f: getattr(p, f) for f in ref.DevPods._fields if f != "pmg"},
        "pmg": p.pmg,
        "used": s.used, "match_count": s.match_count, "anti_active": s.anti_active,
        "pref_wsum": s.pref_wsum,
        "feasible": x.feasible, "scores": x.scores, "ignored": x.ignored,
    }
    pre = tb.preempt
    if pre is not None:
        Tt = pre.used_tier.shape[1]
        L = pre.col_pod.shape[0]
        for name, t, shape in (
            ("pod_tier", pre.pod_tier, tuple(p.group_id.shape)),
            ("used_tier", pre.used_tier, (S, Tt, N, R)), ("npods_tier", pre.npods_tier, (S, Tt, N)),
            ("cand", pre.cand, (S, N)), ("last_wave", pre.last_wave, (S,)),
            ("ev_node", pre.ev_node, (S,)), ("ev_tier", pre.ev_tier, (S,)),
            ("victims", pre.victims, (S,)), ("col_pod", pre.col_pod, (L,)),
            ("col_relb", pre.col_relb, (L,)),
        ):
            if tuple(t.shape) != shape:
                raise ValueError(f"preempt.{name}: expected shape {shape}, got {tuple(t.shape)}")
            tensors[name] = t
        if not 0 <= pre.n_slots <= L:
            raise ValueError(f"preempt.n_slots {pre.n_slots} outside the {L} columns")
    rt = tb.retry
    if rt is not None:
        if pre is not None:
            raise ValueError("the retry buffer does not run with tier preemption")
        RB = rt.rbuf.shape[1]
        P = p.group_id.shape[0]
        if not 0 < RB <= _MAX_RB:
            raise ValueError(f"retry buffer of {RB} slots: the kernels take 1..{_MAX_RB}")
        for name, t, shape, dt in (
            ("dur", rt.dur, (P,), torch.float32), ("tbt", rt.tbt, (rt.tbt.shape[0],),
                                                   torch.float32),
            ("rbuf", rt.rbuf, (S, RB), torch.int32), ("rcount", rt.rcount, (S,), torch.int32),
            ("rdrop", rt.rdrop, (S,), torch.int32), ("rchoice", rt.rchoice, (S, RB), torch.int32),
            ("pend_id", rt.pend_id, (S, RB), torch.int32),
            ("pend_node", rt.pend_node, (S, RB), torch.int32),
            ("pend_relb", rt.pend_relb, (S, RB), torch.int32),
            ("rnode", rt.rnode, (S, P), torch.int32), ("rbind_b", rt.rbind_b, (S, P), torch.int32),
        ):
            if tuple(t.shape) != shape or t.dtype != dt:
                raise ValueError(f"retry.{name}: expected {dt} {shape}, got {t.dtype} "
                                 f"{tuple(t.shape)}")
            tensors[name] = t
        if rt.tbt.shape[0] < 1:
            raise ValueError("retry.tbt: no finite boundary")
        if rt.col_of is not None:
            L = rt.col_relb.shape[0]
            for name, t, shape in (
                ("prio", rt.prio, (P,)), ("col_of", rt.col_of, (P,)), ("col_relb", rt.col_relb, (L,)),
                ("rrel", rt.rrel, (S, P)), ("first_b", rt.first_b, (S, P)),
                ("preempt", rt.preempt, (S,)),
            ):
                if t is None and name in ("prio", "preempt"):
                    continue  # a chaos timeline without kube
                if tuple(t.shape) != shape or t.dtype != torch.int32:
                    raise ValueError(f"retry.{name}: expected int32 {shape}, got {t.dtype} "
                                     f"{tuple(t.shape)}")
                tensors[f"kube.{name}"] = t
        if rt.evict_t is not None:
            if rt.col_of is None:
                raise ValueError("retry: a chaos timeline needs the node tables (col_of, ...)")
            for name, t, shape, dt in (
                ("evict_t", rt.evict_t, (S, P), torch.float64),
                ("evictions", rt.evictions, (S,), torch.int32),
                ("resched", rt.resched, (S,), torch.int32),
                ("evict_lat", rt.evict_lat, (S,), torch.float64),
            ):
                if tuple(t.shape) != shape or t.dtype != dt:
                    raise ValueError(f"retry.{name}: expected {dt} {shape}, got {t.dtype} "
                                     f"{tuple(t.shape)}")
                tensors[f"kube.{name}"] = t
    sh = tb.shards
    if sh is not None:
        if pre is not None or rt is not None:
            raise ValueError("node shards run without tier preemption and the retry buffer")
        if sh.P < 1 or sh.P * sh.n_local != N or not 0 < sh.n_real <= N:
            raise ValueError(f"shards: {sh.P} x {sh.n_local} nodes ({sh.n_real} real) do not "
                             f"tile the tables' {N} nodes")
        for name, t, shape, dt in (
            ("ext", sh.ext, (S, sh.P, ref.NUM_EXT), torch.float32),
            ("best_v", sh.best_v, (S, sh.P), torch.float32),
            ("best_i", sh.best_i, (S, sh.P), torch.int32),
        ):
            if tuple(t.shape) != shape or t.dtype != dt:
                raise ValueError(f"shards.{name}: expected {dt} {shape}, got {t.dtype} "
                                 f"{tuple(t.shape)}")
            tensors[name] = t
        if (sh.cdom.dim() != 3 or sh.cdom.shape[0] != S or sh.cdom.shape[2] != G
                or sh.cdom.dtype != torch.int32):
            raise ValueError(f"shards.cdom: expected int32 ({S}, L, {G}), got {sh.cdom.dtype} "
                             f"{tuple(sh.cdom.shape)}")
        tensors["cdom"] = sh.cdom
    if tb.wrow is not None:
        if tuple(tb.wrow.shape) != (S, len(POLICY_COLS)) or tb.wrow.dtype != torch.float32:
            raise ValueError(f"wrow: expected float32 ({S}, {len(POLICY_COLS)}), got "
                             f"{tb.wrow.dtype} {tuple(tb.wrow.shape)}")
        tensors["wrow"] = tb.wrow
    dev = s.used.device
    for name, t in tensors.items():
        if not t.is_cuda or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"{name}: kernels take contiguous CUDA tensors on one device")
    a = KsimArgs()
    for name, t in tensors.items():
        if not name.startswith("kube."):  # K6's retry mode takes them (KsimKube)
            setattr(a, name, t.data_ptr())
    a.res_w = res_w.data_ptr()
    if rel.shape != s.used.shape or rel.dtype != torch.float32 or rel.device != dev:
        raise ValueError("rel: an f32 tensor of the state's used shape on its device")
    a.rel = rel.data_ptr()
    if pre is not None:
        a.preempt, a.Tt, a.n_slots = 1, pre.used_tier.shape[1], pre.n_slots
    if rt is not None:
        a.retry, a.RB, a.B, a.P = 1, rt.rbuf.shape[1], rt.tbt.shape[0], rt.rnode.shape[1]
    a.n_real, a.NP, a.n_local = (sh.n_real, sh.P, sh.n_local) if sh is not None else (N, 1, N)
    for name, v in {**dims, **strides}.items():
        setattr(a, name, int(v))
    for name in ("fit", "taints", "node_affinity", "interpod", "spread", "on_fit",
                 "on_taint", "on_na", "on_ip", "on_sp", "has_symmetric_pref",
                 "sp_norm_f32", "fit_strategy"):
        setattr(a, name, int(getattr(k, name)))
    a.n_seg = len(k.seg_x0)
    for name in ("wsum", "w_fit", "w_taint", "w_na", "w_ip", "w_sp",
                 "x_first", "y_first", "y_last"):
        setattr(a, name, float(getattr(k, name)))
    for name in ("seg_x0", "seg_x1", "seg_y0", "seg_inv", "seg_dy"):
        arr = getattr(a, name)
        for i, v in enumerate(getattr(k, name)):
            arr[i] = float(v)
    return a


def check_reject(tb: ref.Tables) -> None:
    """The reject counters of a Tables, as K5 takes them: contiguous
    ``[S, K]`` i32 reasons / attempts and ``[S, P]`` u8 episode marks on
    the state's device, K the number of Filter plugins that are on."""
    rj, k = tb.reject, tb.consts
    S = tb.state.used.shape[0]
    K_, P = rj.reasons.shape[1], tb.pods.group_id.shape[0]
    for name, t, shape, dt in (("reasons", rj.reasons, (S, K_), torch.int32),
                               ("attempts", rj.attempts, (S, K_), torch.int32),
                               ("attributed", rj.attributed, (S, P), torch.uint8)):
        if (tuple(t.shape) != shape or t.dtype != dt or t.device != tb.state.used.device
                or not t.is_contiguous()):
            raise ValueError(f"reject.{name}: expected contiguous {dt} {shape}")
    if not 0 < K_ == sum(map(bool, (k.fit, k.taints, k.node_affinity, k.interpod, k.spread))):
        raise ValueError(f"reject tables of {K_} plugins for a step with another number on")


def check_log(tb: ref.Tables) -> KsimLog:
    """The event log of a Tables as K6's retry mode and K10 take it
    (contiguous ``[S, cap, 4]`` i32 records and ``[S]`` i32 counts on the
    state's device), or a null one without a log."""
    lg = tb.log
    if lg is None:
        return KsimLog()
    S, dev = tb.state.used.shape[0], tb.state.used.device
    for name, t, shape in (("rec", lg.rec, (S, lg.rec.shape[1], 4)), ("n", lg.n, (S,))):
        if (tuple(t.shape) != shape or t.dtype != torch.int32 or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(f"log.{name}: expected contiguous int32 {shape}")
    if tb.retry is None or (tb.retry.prio is None and tb.retry.evict_t is None):
        raise ValueError("an event log rides the retry tables of kube or a chaos timeline")
    return KsimLog(lg.rec.data_ptr(), lg.n.data_ptr(), lg.rec.shape[1], 0)


class Bound:
    """A Tables plus, on a CUDA device, its packed argument block — what
    the wrappers take. The tables are checked here, once; the wrappers
    check what each call adds."""

    def __init__(self, tb: ref.Tables):
        self.tables = tb
        self.cuda = tb.cluster.allocatable.is_cuda
        self.args: Optional[KsimArgs] = None
        if self.cuda:
            build()
            c = tb.cluster.allocatable
            self._res_w = torch.tensor(tb.consts.res_w, dtype=torch.float32, device=c.device)
            self._rel = torch.zeros_like(tb.state.used)
            self.args = pack_args(tb, self._res_w, self._rel)
            self._dplane: Optional[torch.Tensor] = None
            self._kube: Optional[Dict[str, torch.Tensor]] = None
            self._sms: Optional[int] = None
            self._args_ptr = ctypes.addressof(self.args)
            if tb.reject is not None:
                check_reject(tb)
            #: the event log's mirror (null without one)
            self.log = check_log(tb)
        self._plans: Dict[str, ClusterPlan] = {}

    def release_workspace(self, K: int):
        """K3's release workspace for K pairs a scenario, tiles of P =
        :func:`release_tile` pairs: P, ``keys`` [S, tiles, P] and ``run``
        [S, tiles, N, 2] (u16: each node's keys [begin, end) in a tile; the
        kernels set them, and read a ``run`` entry only where the key it
        begins at has its node, so neither needs clearing) and ``dplane``
        [S, 3, G, D], the count planes' integer deltas, zero between
        releases (allocated at the first)."""
        s = self.tables.state
        S, N = s.used.shape[:2]
        G, D = s.match_count.shape[1:]
        dev = s.used.device
        if self._dplane is None:
            self._dplane = torch.zeros(S * 3 * G * D, dtype=torch.int32, device=dev)
        if self._sms is None:
            self._sms = torch.cuda.get_device_properties(dev).multi_processor_count
        P = release_tile(K, S, self._sms)
        tiles = -(-K // P)
        return (P, torch.empty(S * tiles * P, dtype=torch.int32, device=dev),
                torch.empty(S * tiles * N * 2, dtype=torch.int16, device=dev), self._dplane)

    def kube_phase(self, choices: torch.Tensor) -> KsimKube:
        """The kube tables of K6's retry mode on these tables (their Retry's
        kube fields) with its scratch, allocated at the first call and kept
        with the Bound: the pass's ring ``kq [S, RB]`` and state ``kst [S,
        4]``, the PostFilter's ``kvic [S, P]``, ``koff`` / ``kcnt [S, N]``
        (each call rewrites what it reads). Without kube (a chaos timeline,
        a checkpointing replay's retry buffer): the node tables alone
        (``col_of``, ``col_relb``, ``rrel``, ``first_b``, the choice
        buffer), the rest null."""
        tb = self.tables
        rt = tb.retry
        S, N = tb.state.used.shape[:2]
        RB, P = rt.rbuf.shape[1], rt.rnode.shape[1]
        kube = rt.prio is not None
        if kube and self._kube is None:
            z = lambda *shape: torch.zeros(shape, dtype=torch.int32, device=rt.rbuf.device)
            self._kube = dict(kq=z(S, RB), kst=z(S, 4), kvic=z(S, P), koff=z(S, N), kcnt=z(S, N))
        k = KsimKube()
        for name in ("prio", "col_of", "col_relb", "rrel", "first_b", "preempt"):
            t = getattr(rt, name)
            if t is not None:
                setattr(k, name, t.data_ptr())
        for name, t in (self._kube.items() if kube else ()):
            setattr(k, name, t.data_ptr())
        k.choices, k.choice_ss = choices.data_ptr(), choices.shape[1]
        k.trace_has_anti = int(bool(rt.trace_has_anti))
        return k

    def plan(self, name: str) -> ClusterPlan:
        """The launch geometry of the select ``name`` on these tables
        (:func:`select_plan`, computed at its first launch)."""
        p = self._plans.get(name)
        if p is None:
            p = self._plans[name] = select_plan(name, self.tables)
        return p


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _pod_row(b: Bound, pod_of_s: Optional[torch.Tensor]):
    """(pointer, scenario stride) of a per-scenario pod row ``[S]`` i32 on
    the tables' device (a column of the retry buffer), or (None, 0)."""
    if pod_of_s is None:
        return None, 0
    S = b.tables.state.used.shape[0]
    if (pod_of_s.dtype != torch.int32 or tuple(pod_of_s.shape) != (S,)
            or pod_of_s.device != b.tables.state.used.device):
        raise ValueError(f"pod_of_s must be an int32 [{S}] tensor on the tables' device")
    if b.tables.preempt is not None:
        raise ValueError("per-scenario pods do not run with tier preemption")
    return pod_of_s.data_ptr(), pod_of_s.stride(0)


def _no_shards(b: Bound, name: str) -> None:
    if b.tables.shards is not None:
        raise ValueError(f"{name} takes the replicated layout; node-sharded tables run "
                         "K1 -> K7 (shard_select) -> K8 (shard_apply)")


def filter_score(b: Bound, pod: int, pod_of_s: Optional[torch.Tensor] = None) -> None:
    """K1: mask + raw score rows of pod ``pod`` in every scenario, into the
    scratch rows; with ``pod_of_s`` ([S] i32, the retry pass) of pod
    ``pod_of_s[s]`` in scenario s (PAD: all-zero rows, nothing
    feasible). On node-sharded tables the launch spans the padded node
    axis, pad rows infeasible."""
    if b.tables.shards is not None and pod_of_s is not None:
        raise ValueError("node shards take one pod for every scenario")
    if not b.cuda:
        ref.filter_score(b.tables, pod, pod_of_s)
        return
    ptr, ss = _pod_row(b, pod_of_s)
    _check(_libs["filter_score"](b._args_ptr, int(pod), ptr, ss, _stream()),
           "filter_score")
    filter_score.launches += 1


def _check_choices(b: Bound, choices: torch.Tensor) -> None:
    S = b.tables.state.used.shape[0]
    if (choices.dtype != torch.int32 or choices.dim() != 2 or choices.shape[0] != S
            or not choices.is_contiguous()
            or choices.device != b.tables.state.used.device):
        raise ValueError(
            f"choices must be a contiguous int32 [{S}, L] tensor on the tables' device"
        )


def normalize_select(b: Bound, pod: int, choices: torch.Tensor, slot: int,
                     wave: int = -1, pod_of_s: Optional[torch.Tensor] = None) -> None:
    """K2: normalized total and lowest-index argmax of the scratch rows of
    every scenario; scenario s's choice (PAD when unplaced) lands in the
    int32 ``choices[s, slot]`` on the device. Under tier preemption a
    scenario with no feasible node, once per ``wave``, takes the
    lowest-index argmin of the candidate row and records the eviction.
    With ``pod_of_s`` (the retry pass) scenario s selects for pod
    ``pod_of_s[s]`` (PAD: writes PAD)."""
    _no_shards(b, "normalize_select")
    if not b.cuda:
        ref.normalize_select(b.tables, pod, choices, slot, wave, pod_of_s)
        return
    _check_choices(b, choices)
    if not 0 <= slot < choices.shape[1]:
        raise ValueError(f"slot {slot} outside the choice buffer's {choices.shape[1]} columns")
    ptr, ss = _pod_row(b, pod_of_s)
    plan = normalize_select.plan = b.plan("normalize_select")
    _check(_libs["normalize_select"](
        b._args_ptr, int(pod), choices.data_ptr() + 4 * int(slot), choices.shape[1],
        int(wave), ptr, ss, plan.C, plan.threads, plan.span, _stream()), "normalize_select")
    normalize_select.launches += 1


def apply_placements(
    b: Bound, pod_ids: torch.Tensor, pos: torch.Tensor, choices: torch.Tensor, sign: float,
    rollback: bool = False, boundary: Optional[int] = None,
    due: Optional[Tuple[torch.Tensor, int]] = None, append: bool = False,
) -> None:
    """K3: ``sign`` × the contribution of each pair (``pod_ids[k]``, the
    node ``choices[s, pos[k]]``), in pair order, into each scenario s's
    state; PAD pods and nodes are skipped. A release (``sign`` -1, not a
    rollback) launches K3's release kernels: the pairs grouped by node (each
    tile of pairs sorted by node, stably), each node's requests summed from
    zero in pair order and subtracted once, its tier cells moved pair by
    pair, the count planes' integer sums subtracted once a cell. Each
    launch counts under its mode too (``modes``: bind, rollback, release). ``pod_ids`` is ``[K]``
    (shared) or ``[S, K]`` (one list per scenario, rows may be strided). ``rollback``
    undoes only failed-gang members and writes PAD over their choices.
    ``due = (relb, b)`` (``relb`` laid out like ``pod_ids``) keeps the
    pairs with ``relb <= b``. ``append`` adds each failed non-gang pod to
    its scenario's retry buffer. Under tier preemption the tier planes
    follow the non-gang pairs, and a bind given the current ``boundary``
    first applies the slot's eviction record."""
    _no_shards(b, "apply_placements")
    if not b.cuda:
        ref.apply_placements(b.tables, pod_ids, pos, choices, sign, rollback, boundary, due,
                             append)
        return
    S = b.tables.state.used.shape[0]
    dev = b.tables.state.used.device
    per_scenario = pod_ids.dim() == 2
    K = pod_ids.shape[-1]
    if pos.numel() != K or (per_scenario and pod_ids.shape[0] != S):
        raise ValueError(f"pod_ids must be [K] or [{S}, K] and pos [K]")
    pod_ss = pod_ids.stride(0) if per_scenario else 0
    for name, t in (("pod_ids", pod_ids), ("pos", pos)):
        if (t.dtype != torch.int32 or t.device != dev
                or (t.shape[-1] > 1 and t.stride(-1) != 1)):
            raise ValueError(f"{name} must be int32 rows of unit stride on the tables' device")
    _check_choices(b, choices)
    if rollback and (K > _MAX_WAVE or per_scenario):
        raise ValueError(f"a rollback covers at most {_MAX_WAVE} shared slots")
    relb_ptr, due_b = None, 0
    if due is not None:
        relb, due_b = due
        if (not per_scenario or relb.shape != pod_ids.shape or relb.stride() != pod_ids.stride()
                or relb.dtype != torch.int32 or relb.device != dev):
            raise ValueError("due: relb must be laid out like per-scenario pod_ids")
        relb_ptr = relb.data_ptr()
    if (append or due is not None or per_scenario) and b.tables.retry is None:
        raise ValueError("per-scenario pods, due pairs and failure appends need retry tables")
    if append and (rollback or sign <= 0 or per_scenario):
        raise ValueError("a failure append rides a main-path bind")
    if boundary is not None:
        pre = b.tables.preempt
        if pre is None or K != 1 or rollback or sign <= 0 or int(boundary) < 0:
            raise ValueError("an eviction step takes one bind under tier preemption and a "
                             "boundary >= 0")
        if choices.shape[1] != pre.col_pod.shape[0]:
            raise ValueError("the choice buffer must have one column per preempt.col_pod entry")
    release = sign < 0 and not rollback
    if release and sign != -1.0:
        raise ValueError("a release subtracts its pairs once (sign -1)")
    if due is not None and not release:
        raise ValueError("due pairs belong to a release")
    if K == 0:
        return
    if release:
        P, keys, run, dplane = b.release_workspace(K)
        _check(_libs["release"](
            b._args_ptr, pod_ids.data_ptr(), pod_ss, pos.data_ptr(), choices.data_ptr(), int(K),
            choices.shape[1], relb_ptr, int(due_b), P, keys.data_ptr(), run.data_ptr(),
            dplane.data_ptr(), _stream()), "apply_placements")
    else:
        _check(_libs["apply_placements"](
            b._args_ptr, pod_ids.data_ptr(), pod_ss, pos.data_ptr(), choices.data_ptr(), int(K),
            choices.shape[1], float(sign), int(bool(rollback)),
            -1 if boundary is None else int(boundary), int(bool(append)), _stream()),
            "apply_placements")
    apply_placements.launches += 1
    apply_placements.modes["release" if release else "rollback" if rollback else "bind"] += 1


def retry_boundary(b: Bound, bnd: int, t_b: float) -> None:
    """K4: boundary ``bnd``'s retry bookkeeping after the retry pass, in
    each scenario (start time ``t_b``, an f32): the retried binds into
    ``rnode`` / ``rbind_b``, the pending list without its due entries and
    with the new releases, the buffer compacted."""
    if not b.cuda:
        ref.retry_boundary(b.tables, bnd, t_b)
        return
    if b.tables.retry is None:
        raise ValueError("retry_boundary needs retry tables")
    _check(_libs["retry_boundary"](b._args_ptr, int(bnd), float(t_b), _stream()),
           "retry_boundary")
    retry_boundary.launches += 1


def _launch_first_reject(b: Bound, pod_ids: torch.Tensor, gate: torch.Tensor) -> bool:
    """K5 over M slots into ``b.tables.reject`` (see :func:`first_reject`);
    True when the kernel was launched."""
    _no_shards(b, "first_reject")
    rj = b.tables.reject
    if rj is None:
        raise ValueError("first_reject needs reject tables")
    S = b.tables.state.used.shape[0]
    dev = b.tables.state.used.device
    M = gate.shape[-1]
    per_scenario = pod_ids.dim() == 2
    if gate.dim() != 2 or gate.shape[0] != S or pod_ids.shape[-1] != M or (
            per_scenario and pod_ids.shape[0] != S):
        raise ValueError(f"gate must be [{S}, M] and pod_ids [M] or [{S}, M]")
    for name, t in (("pod_ids", pod_ids), ("gate", gate)):
        if t.dtype != torch.int32 or t.device != dev or (M > 1 and t.stride(-1) != 1):
            raise ValueError(f"{name} must be int32 rows of unit stride on the tables' device")
    if M == 0:
        return False
    _check(_libs["first_reject"](
        b._args_ptr, pod_ids.data_ptr(), pod_ids.stride(0) if per_scenario else 0, int(M),
        gate.data_ptr(), gate.stride(0), rj.reasons.data_ptr(), rj.attempts.data_ptr(),
        rj.attributed.data_ptr(), rj.reasons.shape[1], rj.attributed.shape[1], _stream()),
        "first_reject")
    return True


def first_reject(b: Bound, pod_ids: torch.Tensor, gate: torch.Tensor) -> None:
    """K5: first-reject attribution of M slots in every scenario, into
    ``b.tables.reject``: the pod of slot m (``pod_ids [M]`` shared, or
    ``[S, M]`` one per scenario) is charged where its gate choice
    (``gate [S, M]``, a view of a choice buffer) is PAD and no node passes
    every Filter at the tables' state — ``attempts`` always, ``reasons``
    and the episode mark on its first charge. The per-slot use (plain
    path, retry pass)."""
    if not b.cuda:
        ref.first_reject(b.tables, pod_ids, gate)
        return
    if _launch_first_reject(b, pod_ids, gate):
        first_reject.launches += 1


def first_reject_fold(b: Bound, pod_ids: torch.Tensor, gate: torch.Tensor) -> None:
    """K5 as the retry path's chunk fold: a chunk's C·W slots in one launch
    against the chunk-start planes ``b`` holds (:func:`first_reject`'s
    kernel, counted apart)."""
    if not b.cuda:
        ref.first_reject(b.tables, pod_ids, gate)
        return
    if _launch_first_reject(b, pod_ids, gate):
        first_reject_fold.launches += 1


def _check_retry_phase(b: Bound, retry, append: bool, reject, samples) -> None:
    """K6's retry-mode arguments against the tables (:func:`chunk_replay`),
    on any device: what the reference refuses with the retry buffer is
    refused here too."""
    tb = b.tables
    if retry is None:
        if samples is not None:
            raise ValueError("samples are taken at a retry boundary (retry=)")
        if reject is not None and tb.retry is not None:
            raise ValueError("under the retry buffer the waves' failures are charged by the "
                             "chunk fold (K5); K6 charges the retry pass, given retry=")
        return
    if tb.retry is None:
        raise ValueError("a retry boundary needs retry tables")
    if tb.preempt is not None:
        raise ValueError("retry_buffer is not supported with tier preemption (the reference "
                         "refuses it, sim/jax_runtime.py:1041-1043)")
    bnd, _, _ = retry
    if int(bnd) < (0 if tb.retry.evict_t is not None else 1) or not append:
        raise ValueError("a retry boundary is a chunk's boundary b > 0 (b >= 0 under a chaos "
                         "timeline), with failure appends")
    if samples is not None:
        S, N, R = tb.state.used.shape
        RB = tb.retry.rbuf.shape[1]
        dev = tb.state.used.device
        trio = (samples.used, samples.rcount, samples.pend)
        if any(t is None for t in trio) != all(t is None for t in trio):
            raise ValueError("samples: used, rcount and pend go together")
        want = []
        if samples.used is not None:
            want += [("used", samples.used, (S, N, R), torch.float32),
                     ("rcount", samples.rcount, (S,), torch.int32),
                     ("pend", samples.pend, (S, RB), torch.int32)]
        if samples.snap is not None:
            want += [(f"snap.{f}", x, tuple(y.shape), torch.float32)
                     for f, x, y in zip(ref.DevState._fields, samples.snap, tb.state)]
        for name, t, shape, dt in want:
            if (tuple(t.shape) != shape or t.dtype != dt or t.device != dev
                    or not t.is_contiguous()):
                raise ValueError(f"samples.{name}: expected contiguous {dt} {shape}")


def chunk_replay(b: Bound, idx: torch.Tensor, gang: torch.Tensor, choices: torch.Tensor,
                 first: int, end: int, boundary: Optional[int] = None,
                 append: bool = False, reject: Optional[ref.Reject] = None,
                 retry: Optional[Tuple[int, float, bool]] = None,
                 samples: Optional[ref.RetrySamples] = None) -> None:
    """K6: waves ``[first, end)`` of one chunk in every scenario, one
    launch: for each slot ``s`` of wave ``w`` whose pod ``idx[s]`` (``idx``
    the plan's ``[num_waves * W]`` i32 slot index on the device) is not PAD,
    K1 → K2 (the choice into ``choices[:, s]``, ``w`` the wave of the tier
    preemption's once-a-wave rule) → K3 bind, and after the last slot of a
    wave whose ``gang`` flag (``[num_waves]`` u8) is set, K3's rollback over
    the wave. ``boundary`` (tier preemption: the chunk's boundary, where a
    bind's eviction releases nothing later) and ``append`` (the retry
    buffer's failure append) are K3's bind options. ``reject`` (first-reject
    counters as K5 takes them, :func:`check_reject`; not with tier
    preemption) runs K6's attributed mode: a slot whose K2 choice is PAD is
    charged as K5 charges it, before its bind.

    ``retry = (b, t_b, pending)`` (retry tables, a chunk starting at
    boundary ``b > 0`` whose f32 start time is ``t_b``) runs K6's retry
    mode: before the waves, the boundary's sequence in the reference's order
    (sim/whatif.py:1433-1494) — the pending list's due entries released
    (unless ``pending`` is False: the host's K3 took them with the static
    bucket), the retry pass over each scenario's ``rcount`` buffered pods
    (K1 → K2 into ``rchoice`` → K3 bind; ``rchoice`` past the count PAD),
    K4's bookkeeping — and, with ``samples`` (:class:`ref.RetrySamples`,
    telemetry series), the boundary's samples copied after it. There
    ``reject`` charges the retry pass's failed slots (the waves' are the
    chunk fold's, K5). Refused: tier preemption with the retry buffer (as
    the reference refuses it), node shards (ROADMAP A6a). Under kube
    preemption (Retry tables with ``prio``) the pass is the kube pass
    (csrc/chunk_replay.cuh): the PostFilter for a pod no node admits, its
    victims' rewind and requeue, the pending appends at bind time; a launch
    with no waves (``first == end``) is the trailing boundary; ``reject``
    charges a pod the PostFilter does not rescue with its counts taken before
    it, and clears the episode marks of the victims and the bound pods. The
    tables' event log (``b.tables.log``: telemetry timeline under kube or a
    chaos timeline) takes the pass's ``preempt`` and ``bind`` records.

    Each launch counts in ``launches``, an attributed one also in
    ``attributed``, a retry-mode one in ``retry``, a kube-pass one also in
    ``kube``."""
    _no_shards(b, "chunk_replay")
    if reject is not None:
        if b.tables.preempt is not None:
            raise ValueError("K6's attributed mode runs without tier preemption")
        check_reject(b.tables._replace(reject=reject))
    _check_retry_phase(b, retry, append, reject, samples)
    if not b.cuda:
        ref.chunk_replay(b.tables, idx, gang, choices, first, end, boundary, append, reject,
                         retry, samples)
        return
    _check_choices(b, choices)
    W = _check_chunk_desc(b, idx, gang, choices, first, end)
    if (boundary is not None) != (b.tables.preempt is not None):
        raise ValueError("a boundary goes with tier preemption, and only with it")
    if append and b.tables.retry is None:
        raise ValueError("a failure append needs retry tables")
    kube = retry is not None and b.tables.retry.prio is not None
    if end == first and not kube:  # under kube: the trailing boundary
        return
    plan = chunk_replay.plan = b.plan("chunk_replay")
    rj = (reject.reasons.data_ptr(), reject.attempts.data_ptr(), reject.attributed.data_ptr(),
          reject.reasons.shape[1], reject.attributed.shape[1]) if reject is not None else (
          None, None, None, 0, 0)
    phase = None
    if retry is not None:
        bnd, t_b, pending = retry
        ptr = lambda t: t.data_ptr() if t is not None else None
        sm = samples or ref.RetrySamples(None, None, None, None)
        snap = sm.snap or (None,) * 4
        phase = KsimRetryPhase(int(bnd), float(t_b), int(bool(pending)), int(kube), ptr(sm.used),
                               ptr(sm.rcount), ptr(sm.pend), *map(ptr, snap))
        rt = b.tables.retry
        if rt.rrel is not None:  # kube, a chaos timeline or a checkpointing replay
            phase.k = b.kube_phase(choices)
        if rt.evict_t is not None:
            phase.t_bd = float(rt.tbd[bnd]) if bnd < rt.tbd.shape[0] else float("inf")
            phase.evict_t, phase.resched, phase.evict_lat = (
                rt.evict_t.data_ptr(), rt.resched.data_ptr(), rt.evict_lat.data_ptr())
        phase.log = b.log
    _check(_libs["chunk_replay"](
        b._args_ptr, idx.data_ptr(), gang.data_ptr(), choices.data_ptr(), choices.shape[1],
        int(W), int(first), int(end), -1 if boundary is None else int(boundary),
        int(bool(append)), plan.C, plan.threads, plan.span, *rj,
        ctypes.byref(phase) if phase is not None else None, ctypes.sizeof(KsimRetryPhase),
        _stream()), "chunk_replay")
    chunk_replay.launches += 1
    if retry is not None:
        chunk_replay.retry += 1
        chunk_replay.kube += int(kube)
    elif reject is not None:
        chunk_replay.attributed += 1


def chunk_replay_attrs(mode: str = "summary") -> Dict[str, int]:
    """K6's registers a thread, static shared bytes and largest block on the
    current card (cudaFuncGetAttributes) in one of its builds,
    :data:`CHUNK_REPLAY_MODES`, after :func:`build`."""
    build()
    out = [ctypes.c_int() for _ in range(3)]
    _check(_libs["chunk_replay_attrs"](CHUNK_REPLAY_MODES.index(mode),
                                       *(ctypes.addressof(x) for x in out)), "chunk_replay")
    return dict(zip(("regs", "shared_bytes", "max_threads"), (x.value for x in out)))


def _check_shards(b: Bound, choices: torch.Tensor) -> None:
    sh = b.tables.shards
    if sh is None:
        raise ValueError("shard_select / shard_apply need node-sharded tables")
    _check_choices(b, choices)
    if sh.cdom.shape[1] != choices.shape[1]:
        raise ValueError(f"shards.cdom has {sh.cdom.shape[1]} columns, the choice buffer "
                         f"{choices.shape[1]}")


def shard_select(b: Bound, pod: int, choices: torch.Tensor, slot: int) -> None:
    """K7: the two-stage choice of pod ``pod`` over the node shards of every
    scenario, after K1: each shard's packed extrema over its own block (into
    ``shards.ext``), their fold, each shard's (max total, lowest global id)
    pair, their fold in shard order; the owner shard writes the choice
    (PAD: unplaced) into ``choices[s, slot]`` and the winner's domain ids
    into ``shards.cdom[s, slot]``."""
    _check_shards(b, choices)
    if not 0 <= slot < choices.shape[1]:
        raise ValueError(f"slot {slot} outside the choice buffer's {choices.shape[1]} columns")
    if not b.cuda:
        ref.shard_select(b.tables, pod, choices, slot)
        return
    plan = shard_select.plan = b.plan("shard_select")
    _check(_libs["shard_select"](b._args_ptr, int(pod), choices.data_ptr(), choices.shape[1],
                                 int(slot), plan.C, plan.threads, _stream()), "shard_select")
    shard_select.launches += 1


def shard_apply(b: Bound, pod_ids: torch.Tensor, pos: torch.Tensor, choices: torch.Tensor,
                sign: float, rollback: bool = False) -> None:
    """K8: ``sign`` × the contribution of each pair (``pod_ids[k]`` [K], the
    node ``choices[s, pos[k]]``), in pair order, into the node-sharded state
    of each scenario: each shard's ``used`` rows by its own block (a release
    summed per node from zero, then subtracted once), the replicated count
    planes at the columns' domain ids (``shards.cdom``). ``rollback``
    undoes only failed-gang members and writes PAD over their choices.
    Each launch also counts under its mode (``modes``: a bind, ``sign >
    0``; a rollback; a release, ``sign < 0`` without rollback)."""
    _check_shards(b, choices)
    K = pod_ids.shape[-1]
    dev = b.tables.state.used.device
    if pod_ids.dim() != 1 or pos.numel() != K:
        raise ValueError("pod_ids must be [K] and pos [K]")
    for name, t in (("pod_ids", pod_ids), ("pos", pos)):
        if t.dtype != torch.int32 or t.device != dev or (K > 1 and t.stride(-1) != 1):
            raise ValueError(f"{name} must be int32 rows of unit stride on the tables' device")
    if rollback and K > _MAX_WAVE:
        raise ValueError(f"a rollback covers at most {_MAX_WAVE} slots")
    if not b.cuda:
        ref.shard_apply(b.tables, pod_ids, pos, choices, sign, rollback)
        return
    if K == 0:
        return
    _check(_libs["shard_apply"](b._args_ptr, pod_ids.data_ptr(), pos.data_ptr(),
                                choices.data_ptr(), int(K), choices.shape[1], float(sign),
                                int(bool(rollback)), _stream()), "shard_apply")
    shard_apply.launches += 1
    shard_apply.modes["rollback" if rollback else "bind" if sign > 0 else "release"] += 1


def _check_chunk_desc(b: Bound, idx: torch.Tensor, gang: torch.Tensor, choices: torch.Tensor,
                      first: int, end: int) -> int:
    """The width W of a chunk's device descriptor (``idx`` [num_waves * W]
    i32, ``gang`` [num_waves] u8 on the tables' device) after checking it
    and the waves ``[first, end)`` against the choice buffer."""
    dev = b.tables.state.used.device
    if (idx.dtype != torch.int32 or gang.dtype != torch.uint8 or idx.dim() != 1
            or gang.dim() != 1 or gang.numel() < 1 or idx.numel() % gang.numel()
            or not idx.is_contiguous() or not gang.is_contiguous()
            or idx.device != dev or gang.device != dev):
        raise ValueError("idx must be int32 [num_waves * W] and gang uint8 [num_waves], "
                         "contiguous on the tables' device")
    W = idx.numel() // gang.numel()
    if not 0 <= first <= end <= gang.numel() or W > _MAX_WAVE:
        raise ValueError(f"waves [{first}, {end}) of {gang.numel()} (width {W}, at most "
                         f"{_MAX_WAVE})")
    if end * W > choices.shape[1]:
        raise ValueError("the choice buffer has no column for every slot of the waves")
    return W


def shard_chunk_replay(b: Bound, idx: torch.Tensor, gang: torch.Tensor, choices: torch.Tensor,
                       first: int, end: int) -> None:
    """K9: waves ``[first, end)`` of one chunk on node-sharded tables in
    every scenario, one launch: for each slot ``s`` of wave ``w`` whose pod
    ``idx[s]`` is not PAD, K1 over the rank's shards → K7 (the choice into
    ``choices[:, s]``, the winner's domain ids into ``shards.cdom[:, s]``)
    → K8 bind, and after the last slot of a wave whose ``gang`` flag is set,
    K8's rollback over the wave (``idx``, ``gang``: as :func:`chunk_replay`).
    Refuses, on any device, what K9 refuses: tables without shards, with
    tier preemption or the retry buffer, shards that do not tile the node
    axis, a wave wider than 1,024 slots."""
    _check_shards(b, choices)
    tb = b.tables
    sh = tb.shards
    if tb.preempt is not None or tb.retry is not None:
        raise ValueError("shard_chunk_replay runs without tier preemption and the retry buffer")
    if sh.P < 1 or sh.P * sh.n_local != tb.state.used.shape[1]:
        raise ValueError(f"shards: {sh.P} x {sh.n_local} nodes do not tile the tables' "
                         f"{tb.state.used.shape[1]} nodes")
    W = _check_chunk_desc(b, idx, gang, choices, first, end)
    if not b.cuda:
        ref.shard_chunk_replay(tb, idx, gang, choices, first, end)
        return
    if end == first:
        return
    plan = shard_chunk_replay.plan = b.plan("shard_chunk_replay")
    _check(_libs["shard_chunk_replay"](
        b._args_ptr, idx.data_ptr(), gang.data_ptr(), choices.data_ptr(), choices.shape[1],
        int(W), int(first), int(end), plan.C, plan.threads, _stream()), "shard_chunk_replay")
    shard_chunk_replay.launches += 1


def shard_chunk_replay_attrs() -> Dict[str, int]:
    """K9's registers a thread, static shared bytes and largest block on the
    current card (cudaFuncGetAttributes), after :func:`build`."""
    build()
    out = [ctypes.c_int() for _ in range(3)]
    _check(_libs["shard_chunk_replay_attrs"](*(ctypes.addressof(x) for x in out)),
           "shard_chunk_replay")
    return dict(zip(("regs", "shared_bytes", "max_threads"), (x.value for x in out)))


def evict_node(b: Bound, choices: torch.Tensor, scen: torch.Tensor, off: torch.Tensor,
               nodes: torch.Tensor, bnd: int, t_b: float) -> None:
    """K10: the NoExecute eviction of chaos ``node_down`` events at boundary
    ``bnd`` (f64 start time ``t_b``), before its releases: scenario
    ``scen[i]`` evicts the pods of its down nodes ``nodes[off[i]:off[i +
    1]]`` in order (``scen [m]``, ``off [m + 1]``, ``nodes`` int32 on the
    tables' device; one block a scenario) — each node's pods in pod order,
    their state rewound, pending entries cancelled, records cleared, each
    non-gang one requeued (:func:`.reference.evict_node`); with the tables'
    reject counters each victim's episode mark cleared, with their event log
    its ``evict`` record appended. Needs retry
    tables with the chaos records (a Retry with ``evict_t``)."""
    rt = b.tables.retry
    if rt is None or rt.evict_t is None:
        raise ValueError("evict_node needs retry tables with a chaos timeline's records")
    if b.tables.shards is not None or b.tables.preempt is not None:
        raise ValueError("evict_node runs on the replicated tables of the retry buffer")
    if not b.cuda:
        ref.evict_nodes(b.tables, choices, scen, off, nodes, bnd, t_b)
        return
    _check_choices(b, choices)
    dev = b.tables.state.used.device
    m = scen.numel()
    for name, t, n in (("scen", scen, m), ("off", off, m + 1), ("nodes", nodes, None)):
        if (t.dtype != torch.int32 or t.device != dev or not t.is_contiguous()
                or (n is not None and t.numel() != n)):
            raise ValueError(f"{name}: contiguous int32 on the tables' device expected")
    if m == 0:
        return
    rj = b.tables.reject
    ev = KsimEvict(scen.data_ptr(), off.data_ptr(), nodes.data_ptr(), rt.col_of.data_ptr(),
                   rt.col_relb.data_ptr(), rt.rrel.data_ptr(), rt.first_b.data_ptr(),
                   choices.data_ptr(), choices.shape[1], rt.evict_t.data_ptr(),
                   rt.evictions.data_ptr(), float(t_b), int(bnd), 0,
                   rj.attributed.data_ptr() if rj is not None else None,
                   rj.attributed.shape[1] if rj is not None else 0, b.log)
    _check(_libs["evict_node"](b._args_ptr, ctypes.byref(ev), ctypes.sizeof(KsimEvict), int(m),
                               _stream()), "evict_node")
    evict_node.launches += 1


WRAPPERS = (filter_score, normalize_select, apply_placements, retry_boundary, first_reject,
            first_reject_fold, chunk_replay, shard_select, shard_apply, shard_chunk_replay,
            evict_node)


#: The wrappers that also count their launches by mode.
MODE_WRAPPERS = (apply_placements, shard_apply)


def reset_launch_counts() -> None:
    for w in WRAPPERS:
        w.launches = 0
    for w in MODE_WRAPPERS:
        w.modes = dict(bind=0, rollback=0, release=0)
    chunk_replay.attributed = chunk_replay.retry = chunk_replay.kube = 0


def launch_counts() -> Dict[str, int]:
    """Launches by wrapper, and K3's and K8's by mode
    (``apply_placements_bind``, ``_rollback``, ``_release``, the same for
    ``shard_apply``; each wrapper's sum to its count). K6's attributed
    launches, also in ``chunk_replay``, are ``chunk_replay.attributed``, its
    retry-mode launches ``chunk_replay.retry`` (of which kube passes
    ``chunk_replay.kube``)."""
    out = {w.__name__: w.launches for w in WRAPPERS}
    for w in MODE_WRAPPERS:
        out.update({f"{w.__name__}_{k}": n for k, n in w.modes.items()})
    return out


reset_launch_counts()
#: The geometry of each select's last launch (a ClusterPlan; None before one).
normalize_select.plan = chunk_replay.plan = shard_select.plan = shard_chunk_replay.plan = None
