"""Profiling hooks on ``torch.profiler``.

Counterpart: ``kubernetes_simulator_tpu/utils/profiling.py`` (its
``jax.profiler`` hooks), call for call:

- ``profile_dir()`` / ``profiling_active()``: the sink named by
  ``KSIM_PROFILE_DIR`` (the CLI's ``--profile-dir`` sets it), which arms
  the annotations;
- ``annotate(name)``: ``torch.profiler.record_function(name)`` while
  profiling is active, else a no-op context. The chunk loop
  (:mod:`..sim.torch_runtime`) annotates its phases (``dispatch``,
  ``device_wait``) and each chunk's launches (``chunk:<b>``), so a
  kernel's device time sits under the chunk that launched it in the trace.
  Annotations never change results;
- ``device_trace(dir)``: a ``torch.profiler`` trace of the host and, where
  a card is present, its CUDA activity (CUPTI), written to ``dir`` as a
  Chrome trace (``ksim_trace.<pid>.json``, Perfetto-loadable);
- ``live_buffer_stats()``: the caching allocator's live tensors
  (``torch.cuda.memory_stats``: count, bytes, peak); empty off the card;
- ``timed(fn)``: (result, seconds) with the card synchronized.

``live_buffer_stats`` and ``timed`` are helpers for a user's own scripts,
as in the reference; nothing in the port calls them.

The reference's ``cost_analysis`` reads XLA's cost model of a compiled
program; a hand-written kernel launched through ctypes has no such model
in PyTorch, so it has no counterpart here (the bounds in ``chip_smoke.py``
count each kernel's bytes and operations instead).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Optional


def profile_dir() -> Optional[str]:
    """The profiler sink (``KSIM_PROFILE_DIR``), or None when profiling is
    off."""
    return os.environ.get("KSIM_PROFILE_DIR") or None


def profiling_active() -> bool:
    """True when the hooks should annotate (one environment lookup; the
    chunk loop asks once a run)."""
    return bool(profile_dir())


def annotate(name: str):
    """``torch.profiler.record_function(name)`` while profiling is active,
    else a no-op context (outside a live trace a record is harmless)."""
    if not profiling_active():
        return contextlib.nullcontext()
    import torch

    return torch.profiler.record_function(name)


def live_buffer_stats() -> dict:
    """The card's live allocations (``count``, ``bytes``) and the peak
    (``peak_bytes_in_use``) from ``torch.cuda.memory_stats``; empty without
    a card."""
    import torch

    if not torch.cuda.is_available():
        return {}
    ms = torch.cuda.memory_stats()
    return {
        "count": int(ms.get("active.all.current", 0)),
        "bytes": int(ms.get("active_bytes.all.current", 0)),
        "peak_bytes_in_use": int(ms.get("allocated_bytes.all.peak", 0)),
    }


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """Trace the body with ``torch.profiler`` into ``log_dir`` (nothing
    when it is None); CUDA activity is recorded where a card is present.
    The trace file is written when the body ends, also on an error."""
    if not log_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, f"ksim_trace.{os.getpid()}.json"))


def timed(fn: Callable, *args, **kw):
    """(result, seconds) of ``fn(*args, **kw)`` with the card's queued work
    awaited."""
    import torch

    t0 = time.perf_counter()
    out = fn(*args, **kw)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0
