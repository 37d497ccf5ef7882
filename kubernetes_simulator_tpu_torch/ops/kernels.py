"""The replay's hand-written Hopper kernels: build, binding and wrappers.

Three CUDA C++ kernels (``csrc/*.cu``, compiled for ``sm_90a``) carry the
single-scenario replay's device work:

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
                              _donated_subtract, and make_wave_step3's wave
                              commit and gang rollback
============================  ================================================

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
from typing import Callable, Dict, Optional

import torch

from . import reference as ref

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
}

#: argtypes of each C entry point (every one returns a cudaError_t as int)
_ARGTYPES = {
    "filter_score": [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p],
    "normalize_select": [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p],
    "apply_placements": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                         ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
}

_MAX_SEG = 16
_MAX_TERMS = 64
_MAX_WAVE = 1024


class KsimArgs(ctypes.Structure):
    """Mirror of ``struct KsimArgs`` in csrc/ksim.cuh (same field order)."""

    _fields_ = (
        [(name, ctypes.c_void_p) for name in (
            "alloc", "taint_key", "taint_kv", "taint_effect", "expr_match", "gdom",
            "gnd", "sp_w",
            "requests", "tol_key", "tol_kv", "tol_effect", "na_req", "na_has_req",
            "na_pref", "na_pref_w", "aff_req", "anti_req", "pref_aff", "pref_aff_w",
            "spread_g", "spread_skew", "spread_dns", "pmg", "group_id",
            "used", "match_count", "anti_active", "pref_wsum",
            "feasible", "scores", "ignored", "res_w",
        )]
        + [(name, ctypes.c_int32) for name in (
            "N", "R", "TT", "E", "G", "D", "TO", "TR", "TE", "TP", "AR", "AA", "PA", "SP",
            "fit", "taints", "node_affinity", "interpod", "spread",
            "on_fit", "on_taint", "on_na", "on_ip", "on_sp",
            "has_symmetric_pref", "sp_norm_f32", "fit_strategy", "n_seg",
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


def pack_args(tb: ref.Tables, res_w: torch.Tensor) -> KsimArgs:
    """The ctypes argument block of one Tables (CUDA tensors only; every
    tensor is contiguous and keeps its storage for the engine's life —
    state updates are in place). ``res_w`` holds the resource weights on
    the device; the caller keeps it alive with the block."""
    c, p, s, x, k = tb.cluster, tb.pods, tb.state, tb.scratch, tb.consts
    dims = dict(
        N=c.allocatable.shape[0], R=c.allocatable.shape[1], TT=c.taint_key.shape[1],
        E=c.expr_match.shape[1], G=c.gdom.shape[0], D=s.match_count.shape[1],
        TO=p.tol_key.shape[1], TR=p.na_req.shape[1], TE=p.na_req.shape[2],
        TP=p.na_pref.shape[1], AR=p.aff_req.shape[1], AA=p.anti_req.shape[1],
        PA=p.pref_aff.shape[1], SP=p.spread_g.shape[1],
    )
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
    tensors = {
        "alloc": c.allocatable, "taint_key": c.taint_key, "taint_kv": c.taint_kv,
        "taint_effect": c.taint_effect, "expr_match": c.expr_match, "gdom": c.gdom,
        "gnd": c.gnd, "sp_w": c.sp_w,
        **{f: getattr(p, f) for f in ref.DevPods._fields if f != "pmg"},
        "pmg": p.pmg,
        "used": s.used, "match_count": s.match_count, "anti_active": s.anti_active,
        "pref_wsum": s.pref_wsum,
        "feasible": x.feasible, "scores": x.scores, "ignored": x.ignored,
    }
    for name, t in tensors.items():
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError(f"{name}: kernels take contiguous CUDA tensors")
    a = KsimArgs()
    for name, t in tensors.items():
        setattr(a, name, t.data_ptr())
    a.res_w = res_w.data_ptr()
    for name, v in dims.items():
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


class Bound:
    """A Tables plus, on a CUDA device, its packed argument block — what
    the wrappers take."""

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


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def filter_score(b: Bound, pod: int) -> None:
    """K1: mask + raw score rows of pod ``pod`` into the scratch rows."""
    if not b.cuda:
        ref.filter_score(b.tables, pod)
        return
    _check(_libs["filter_score"](b._args_ptr, int(pod), _stream()),
           "filter_score")
    filter_score.launches += 1


def normalize_select(b: Bound, pod: int, choice_out: torch.Tensor) -> None:
    """K2: normalized total and lowest-index argmax of the scratch rows;
    the choice (PAD when unplaced) lands in the int32 element
    ``choice_out`` on the device."""
    if not b.cuda:
        ref.normalize_select(b.tables, pod, choice_out)
        return
    if choice_out.dtype != torch.int32 or choice_out.numel() != 1 or not choice_out.is_cuda:
        raise ValueError("choice_out must be one CUDA int32 element")
    _check(_libs["normalize_select"](
        b._args_ptr, int(pod), choice_out.data_ptr(), _stream()), "normalize_select")
    normalize_select.launches += 1


def apply_placements(
    b: Bound, pod_ids: torch.Tensor, nodes: torch.Tensor, sign: float, rollback: bool = False
) -> None:
    """K3: ``sign`` × the contribution of each (pod, node) pair, in pair
    order, into the state; ``rollback`` undoes only failed-gang members and
    sets their ``nodes`` entries to PAD."""
    if not b.cuda:
        ref.apply_placements(b.tables, pod_ids, nodes, sign, rollback)
        return
    K = pod_ids.numel()
    if nodes.numel() != K:
        raise ValueError("pod_ids and nodes must have the same length")
    for t in (pod_ids, nodes):
        if t.dtype != torch.int32 or not t.is_cuda or not t.is_contiguous():
            raise ValueError("pod_ids / nodes must be contiguous CUDA int32")
    if rollback and K > _MAX_WAVE:
        raise ValueError(f"a rollback covers at most {_MAX_WAVE} slots")
    if K == 0:
        return
    _check(_libs["apply_placements"](
        b._args_ptr, pod_ids.data_ptr(), nodes.data_ptr(), int(K), float(sign),
        int(bool(rollback)), _stream()), "apply_placements")
    apply_placements.launches += 1


WRAPPERS = (filter_score, normalize_select, apply_placements)


def reset_launch_counts() -> None:
    for w in WRAPPERS:
        w.launches = 0


def launch_counts() -> Dict[str, int]:
    return {w.__name__: w.launches for w in WRAPPERS}


reset_launch_counts()
