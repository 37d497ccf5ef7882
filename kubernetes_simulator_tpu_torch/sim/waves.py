"""Wave packing — the rectangular schedule the device scan walks.

Counterpart: ``kubernetes_simulator_tpu/sim/waves.py`` (the numpy path only;
the native C++ packer stays with the JAX package).

Pods (in arrival order) are packed into fixed-width "waves" of W slots such
that no pod-group (gang) spans waves. The JAX engine scans waves; within a
wave, slots are processed sequentially (pod k sees pod k-1's speculative
bindings — SURVEY.md §7 hard part #1), and gang commit/rollback happens at
the wave boundary as one masked update (hard part #3).

Gangs larger than the wave width raise; callers size W from the trace's max
group size (Borg alloc sets are small).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from ..models.encode import PAD, EncodedPods


@dataclass
class WaveBatch:
    idx: np.ndarray  # [num_waves, W] i32 pod ids (PAD = empty slot)
    wave_width: int

    @property
    def num_waves(self) -> int:
        return self.idx.shape[0]


def pack_waves(
    ep: EncodedPods, wave_width: int = 8, order: Optional[np.ndarray] = None,
    page_pods: Optional[int] = None,
) -> WaveBatch:
    """Pack schedulable pods into waves. ``order`` defaults to arrival order
    of unbound pods (stable; deterministic). This is the JAX package's
    Python packer, its semantic reference (the JAX package also has a
    native C++ packer that gives the same waves).

    ``page_pods`` (paged mode): number of pod SLOTS per streamed
    page. Validated here against the largest gang — a gang split across
    pages could see its later members arrive after the page carrying its
    earlier ones was evicted, so the guard mirrors the wave-width check
    (and runs on BOTH the native and reference paths)."""
    if order is None:
        unbound = np.nonzero(ep.bound_node == PAD)[0]
        order = unbound[np.argsort(ep.arrival[unbound], kind="stable")]
    if page_pods is not None:
        gids = ep.group_id[np.asarray(order)]
        gids = gids[gids != PAD]
        max_gang = int(np.bincount(gids).max()) if gids.size else 1
        if page_pods < max_gang:
            raise ValueError(
                f"paged mode: page of {page_pods} pod slots is smaller than "
                f"the largest gang ({max_gang} pods) — a gang must fit in "
                f"one page; raise chunk_waves/wave_width so that "
                f"chunk_waves * wave_width >= {max_gang}, or disable paging"
            )
    members: Dict[int, List[int]] = {}
    for p in order:
        g = int(ep.group_id[p])
        if g != PAD:
            members.setdefault(g, []).append(int(p))
    max_group = max((len(v) for v in members.values()), default=1)
    if max_group > wave_width:
        raise ValueError(
            f"gang of size {max_group} exceeds wave width {wave_width}; "
            f"use wave_width >= {max_group}"
        )
    waves: List[List[int]] = []
    current: List[int] = []
    consumed = set()

    def flush():
        nonlocal current
        if current:
            waves.append(current)
            current = []

    for p in order:
        p = int(p)
        if p in consumed:
            continue
        g = int(ep.group_id[p])
        batch = [p] if g == PAD else members[g]
        if len(current) + len(batch) > wave_width:
            flush()
        current.extend(batch)
        consumed.update(batch)
    flush()

    idx = np.full((max(len(waves), 1), wave_width), PAD, dtype=np.int32)
    for i, w in enumerate(waves):
        idx[i, : len(w)] = w
    return WaveBatch(idx=idx, wave_width=wave_width)
