"""Granularity-envelope guard for chunk-boundary completions (SURVEY §4.3
determinism row).

Counterpart: ``kubernetes_simulator_tpu/sim/granularity.py`` (a copy, so
chunk sizes shrink exactly as the reference engine's do).

The chunk-granular release semantics are a measured-faithful
approximation of exact-timestamp completions only while the chunk
arrival span stays ≲ the mean pod duration: releases then land at most
one boundary late. When durations are ≪ the span, every release batches
at a few boundaries, capacity placed early in a chunk stays invisible
for the whole chunk, and arrival-order greedy silently loses most
placements — measured 89% loss at duration/span ≈ 0.05 on a 100-node
shape (COVERAGE.md, test_divergence_pin.py docstring). The measured-safe
regime is ratio ≥ 0.67 (0.53% gap) with 0.00% at 1.33.

This module computes the ratio ON HOST before a completions-on run and,
below the safe regime, WARNS with the projected-loss reference and
auto-shrinks ``chunk_waves`` toward the duration scale — a pure fidelity
mitigation (smaller chunks converge on the CPU event engine's
semantics; the cost is more per-chunk dispatches, which the warning
states). When a retry buffer is already enabled but smaller than the
per-chunk failure burst, it is grown to cover one chunk (retry is a
semantics opt-in, so the guard never turns it ON by itself). Engines
pass ``granularity_guard=False`` to opt out.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass

import numpy as np

from ..models.encode import EncodedPods

# Below this duration/chunk-span ratio the guard fires (measured: 0.67
# → 0.53% gap is safe; 0.05 → 89% loss is the cliff).
SAFE_RATIO = 0.5
# The guard never shrinks chunks below this (dispatch-count sanity; a
# trace needing finer granularity than 8 waves/chunk is flagged as
# unhonorable instead).
MIN_CHUNK_WAVES = 8


@dataclass(frozen=True)
class GranularityAssessment:
    ratio: float  # mean finite duration / mean finite chunk span
    mean_duration: float
    mean_span: float
    chunk_waves: int  # recommended (== input when safe)
    retry_buffer: int  # recommended (== input when safe / retry off)
    honorable: bool  # False: even MIN_CHUNK_WAVES can't reach SAFE_RATIO


def assess(
    ep: EncodedPods,
    wave_idx: np.ndarray,
    chunk_waves: int,
    retry_buffer: int = 0,
) -> GranularityAssessment:
    """Pure computation — no warning, no mutation."""
    dur = ep.duration[np.isfinite(ep.duration)]
    first = wave_idx[:, 0]
    wt = np.where(first >= 0, ep.arrival[np.clip(first, 0, None)], np.inf)
    wt = wt[np.isfinite(wt)]
    if dur.size == 0 or wt.size < 2:
        return GranularityAssessment(
            np.inf, 0.0, 0.0, chunk_waves, retry_buffer, True
        )
    mean_dur = float(dur.mean())
    # Mean arrival span of one chunk of C waves, from the per-wave span
    # (robust to a trailing partial chunk and to C > num_waves: the span
    # of the chunks the run will actually have).
    total_span = float(wt[-1] - wt[0])
    num_waves = wt.size
    C_eff = min(chunk_waves, num_waves)
    mean_span = total_span * C_eff / max(num_waves - 1, 1)
    if mean_span <= 0:
        return GranularityAssessment(
            np.inf, mean_dur, mean_span, chunk_waves, retry_buffer, True
        )
    ratio = mean_dur / mean_span
    if ratio >= SAFE_RATIO:
        return GranularityAssessment(
            ratio, mean_dur, mean_span, chunk_waves, retry_buffer, True
        )
    # Shrink C so the new span ≈ mean duration (target ratio 1.0, i.e.
    # the 0.00%-gap regime, not merely the 0.5 threshold).
    span_per_wave = mean_span / C_eff
    want = int(mean_dur / span_per_wave) if span_per_wave > 0 else MIN_CHUNK_WAVES
    new_c = max(MIN_CHUNK_WAVES, want)
    honorable = new_c * span_per_wave * SAFE_RATIO <= mean_dur + 1e-12
    new_rb = retry_buffer
    if retry_buffer > 0:
        # Cover one (new) chunk's worth of failures.
        burst = new_c * wave_idx.shape[1]
        new_rb = max(retry_buffer, min(burst, 4096))
    return GranularityAssessment(
        ratio, mean_dur, mean_span, min(new_c, chunk_waves), new_rb, honorable
    )


def guard(
    ep: EncodedPods,
    wave_idx: np.ndarray,
    chunk_waves: int,
    retry_buffer: int = 0,
    enabled: bool = True,
    engine_name: str = "device engine",
) -> tuple:
    """Returns (chunk_waves, retry_buffer) to run with; warns when the
    trace is outside the measured-safe envelope."""
    if not enabled:
        return chunk_waves, retry_buffer
    a = assess(ep, wave_idx, chunk_waves, retry_buffer)
    changed = (
        a.chunk_waves != chunk_waves or a.retry_buffer != retry_buffer
    )
    if a.honorable and not changed:
        # In the safe regime (or already at the recommendation with the
        # target ratio reachable) — silent.
        return chunk_waves, retry_buffer
    if changed:
        fix = (
            f"auto-shrinking chunk_waves {chunk_waves} -> {a.chunk_waves}"
            + (
                f" and retry_buffer {retry_buffer} -> {a.retry_buffer}"
                if a.retry_buffer != retry_buffer
                else ""
            )
        )
    else:
        # Already at/below the floor but still outside the envelope —
        # nothing to shrink, but the user MUST hear about it (a silent
        # beyond-cliff run was the whole bug class this module guards).
        fix = (
            f"chunk_waves {chunk_waves} is already at the shrink floor "
            f"({MIN_CHUNK_WAVES}) — no finer chunking applied"
        )
    residual = (
        ""
        if a.honorable
        else (
            " Even at the floor the ratio stays below the safe regime — "
            "expect residual divergence; the CPU event engine (strategy: "
            "cpu) is the exact-timestamp reference for this trace."
        )
    )
    warnings.warn(
        f"{engine_name}: mean pod duration ({a.mean_duration:.3g}s) is "
        f"{a.ratio:.2f}x the chunk arrival span ({a.mean_span:.3g}s) — "
        f"below the measured-safe completions regime (>= {SAFE_RATIO}; "
        f"an 0.05x shape measured an 89% placement loss). {fix} (more, "
        f"smaller chunks: higher fidelity, more per-chunk dispatches)."
        + residual
        + " Pass granularity_guard=False to keep the requested chunking.",
        stacklevel=3,
    )
    return a.chunk_waves, a.retry_buffer
