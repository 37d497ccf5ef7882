"""The replay's hand-written Hopper kernels: build, binding and wrappers.

Five CUDA C++ kernels (``csrc/*.cu``, compiled for ``sm_90a``) carry the
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
============================  ================================================

K5 runs only at telemetry ``series``/``timeline``: the default ``summary``
launches K1–K4 as before.

Under the retry buffer (a Tables with ``retry``) K1–K3 also take one pod
per scenario (the retry pass), K3 appends failed non-gang pods to the
buffer on a main-path bind (sim/whatif.py:1502-1528) and releases the
pending list's due entries (:1437-1443 through ``_release_core``).

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
went through the kernels.

Build at first use: every ``csrc/*.cu`` is compiled by ``nvcc`` — one
process per source, all started together — into a shared library with a
plain C interface under ``_build/`` (listed in ``.gitignore``), keyed by
a hash of the sources and flags, and loaded with ``ctypes``. The flags
keep the floor-quantized scores bit-identical to the reference:
``--fmad=false`` (no a·b+c contraction), IEEE division and square root,
never ``-use_fast_math``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
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
}

#: argtypes of each C entry point (every one returns a cudaError_t as int)
_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_ARGTYPES = {
    # (args, pod, pod_of_s, pod_ss, stream)
    "filter_score": [_P, _I, _P, _LL, _P],
    # (args, pod, choice_out, choice_ss, wave, pod_of_s, pod_ss, stream)
    "normalize_select": [_P, _I, _P, _LL, _I, _P, _LL, _P],
    # (args, pods, pod_ss, pos, choices, K, choice_ss, sign, rollback, boundary,
    #  due_relb, due_b, append, stream)
    "apply_placements": [_P, _P, _LL, _P, _P, _I, _LL, _F, _I, _I, _P, _I, _I, _P],
    # (args, b, t_b, stream)
    "retry_boundary": [_P, _I, _F, _P],
    # (args, pods, pod_ss, M, gate, gate_ss, reasons, attempts, attributed, K, attr_ss,
    #  stream)
    "first_reject": [_P, _P, _LL, _I, _P, _LL, _P, _P, _P, _I, _LL, _P],
}

_MAX_SEG = 16
_MAX_TERMS = 64
_MAX_WAVE = 1024
_MAX_RB = 4096  # the granularity guard's cap (sim/granularity.py)


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
            "pend_relb", "rnode", "rbind_b", "wrow",
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
_libs: Dict[str, Callable] = {}  # kernel name → its C entry point
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
    (one ``nvcc`` per source, in parallel) and load all of them. Returns
    the wall seconds spent compiling."""
    global last_build_s
    with _lock:
        if len(_libs) == len(KERNELS):
            return 0.0
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        todo = {}
        for name, src in KERNELS.items():
            out = _lib_path(src)
            if not out.exists():
                todo[name] = (src, out)
        t0 = time.perf_counter()
        procs = []
        for name, (src, out) in todo.items():
            tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
            cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / src)]
            if verbose:
                cmd.insert(1, "-Xptxas=-v")
            procs.append((name, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )))
        errors = []
        for name, out, tmp, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
                continue
            if verbose and log:
                print(f"[nvcc {name}]\n{log}", flush=True)
            os.replace(tmp, out)
        if errors:
            raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
        last_build_s = time.perf_counter() - t0 if procs else 0.0
        for name, src in KERNELS.items():
            lib = ctypes.CDLL(str(_lib_path(src)))
            size = lib.ksim_args_size()
            if size != ctypes.sizeof(KsimArgs):
                raise RuntimeError(
                    f"KsimArgs layout mismatch: C {size} B, ctypes "
                    f"{ctypes.sizeof(KsimArgs)} B"
                )
            fn = getattr(lib, f"ksim_{name}")
            fn.argtypes = _ARGTYPES[name]
            fn.restype = ctypes.c_int
            _libs[name] = fn
        return last_build_s


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"kernel {name}: launch failed with CUDA error {rc}")


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


def pack_args(tb: ref.Tables, res_w: torch.Tensor) -> KsimArgs:
    """The ctypes argument block of one Tables (CUDA tensors only; every
    tensor is contiguous and keeps its storage for the engine's life —
    state updates are in place). ``res_w`` holds the resource weights on
    the device; the caller keeps it alive with the block."""
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
        setattr(a, name, t.data_ptr())
    a.res_w = res_w.data_ptr()
    if pre is not None:
        a.preempt, a.Tt, a.n_slots = 1, pre.used_tier.shape[1], pre.n_slots
    if rt is not None:
        a.retry, a.RB, a.B, a.P = 1, rt.rbuf.shape[1], rt.tbt.shape[0], rt.rnode.shape[1]
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
            self.args = pack_args(tb, self._res_w)
            self._args_ptr = ctypes.addressof(self.args)
            if tb.reject is not None:
                check_reject(tb)


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


def filter_score(b: Bound, pod: int, pod_of_s: Optional[torch.Tensor] = None) -> None:
    """K1: mask + raw score rows of pod ``pod`` in every scenario, into the
    scratch rows; with ``pod_of_s`` ([S] i32, the retry pass) of pod
    ``pod_of_s[s]`` in scenario s (PAD: all-zero rows, nothing
    feasible)."""
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
    if not b.cuda:
        ref.normalize_select(b.tables, pod, choices, slot, wave, pod_of_s)
        return
    _check_choices(b, choices)
    if not 0 <= slot < choices.shape[1]:
        raise ValueError(f"slot {slot} outside the choice buffer's {choices.shape[1]} columns")
    ptr, ss = _pod_row(b, pod_of_s)
    _check(_libs["normalize_select"](
        b._args_ptr, int(pod), choices.data_ptr() + 4 * int(slot), choices.shape[1],
        int(wave), ptr, ss, _stream()), "normalize_select")
    normalize_select.launches += 1


def apply_placements(
    b: Bound, pod_ids: torch.Tensor, pos: torch.Tensor, choices: torch.Tensor, sign: float,
    rollback: bool = False, boundary: Optional[int] = None,
    due: Optional[Tuple[torch.Tensor, int]] = None, append: bool = False,
) -> None:
    """K3: ``sign`` × the contribution of each pair (``pod_ids[k]``, the
    node ``choices[s, pos[k]]``), in pair order, into each scenario s's
    state; PAD pods and nodes are skipped. ``pod_ids`` is ``[K]`` (shared)
    or ``[S, K]`` (one list per scenario, rows may be strided). ``rollback``
    undoes only failed-gang members and writes PAD over their choices.
    ``due = (relb, b)`` (``relb`` laid out like ``pod_ids``) keeps the
    pairs with ``relb <= b``. ``append`` adds each failed non-gang pod to
    its scenario's retry buffer. Under tier preemption the tier planes
    follow the non-gang pairs, and a bind given the current ``boundary``
    first applies the slot's eviction record."""
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
    if K == 0:
        return
    _check(_libs["apply_placements"](
        b._args_ptr, pod_ids.data_ptr(), pod_ss, pos.data_ptr(), choices.data_ptr(), int(K),
        choices.shape[1], float(sign), int(bool(rollback)),
        -1 if boundary is None else int(boundary), relb_ptr, int(due_b), int(bool(append)),
        _stream()), "apply_placements")
    apply_placements.launches += 1


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


WRAPPERS = (filter_score, normalize_select, apply_placements, retry_boundary, first_reject,
            first_reject_fold)


def reset_launch_counts() -> None:
    for w in WRAPPERS:
        w.launches = 0


def launch_counts() -> Dict[str, int]:
    return {w.__name__: w.launches for w in WRAPPERS}


reset_launch_counts()
