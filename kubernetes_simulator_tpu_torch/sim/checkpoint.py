"""Checkpoint / resume of the single replay, and the what-if fork point.

Counterpart: ``kubernetes_simulator_tpu/sim/checkpoint.py`` —
``ReplayCheckpoint`` with ``save`` / ``load``, the file format byte for
byte in its keys, shapes, dtypes and meaning — and the host converters
``domain_to_node_space`` / ``node_space_to_domain``
(``kubernetes_simulator_tpu/ops/tpu.py:160``, ``:168``), on numpy. A file
either package writes resumes on the other.

The file is a plain ``.npz``: ``chunk_cursor`` (the next chunk to run),
``used [N, R]`` and the count planes ``match_count`` / ``anti_active`` /
``pref_wsum`` in domain space ``[G, D]``, ``num_outs`` and ``out_i`` (each
run chunk's choices in the reference's ``[C, W]`` chunk layout, a padded
tail chunk included; none in a boundary-mode file), ``released [P]``
(the pods whose completion release is already in the planes) and, from a
retry or kube replay, the ``bd_*`` boundary blob (``mode``, ``bound``,
``assignments``, ``released``, ``bind_chunk``, ``retry_q``, ``pend``,
``counters``, ``chaos``, ``evict_lat``, ``evict_times``, ``ev_cursor``,
``ev_hash``; kubernetes_simulator_tpu/sim/boundary.py:203-245 and
sim/jax_runtime.py:1853-1876), which the port derives from its device
retry tables (:mod:`.torch_runtime` ``boundary_blob``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

#: ``bind_chunk`` of a pod that no static release may free (never bound in
#: its wave, or unbound since): sim/boundary.py ``_NEVER``
BIND_NEVER = 1 << 30


@dataclass
class ReplayCheckpoint:
    """One snapshot of the replay (module docstring)."""

    chunk_cursor: int  # next chunk index to execute
    used: np.ndarray  # [N, R] f32
    match_count: np.ndarray  # [G, D] f32 domain space
    anti_active: np.ndarray  # [G, D] f32
    pref_wsum: np.ndarray  # [G, D] f32
    outs: List[np.ndarray]  # per-chunk choices [C, W] i32 so far
    #: [P] bool pods whose completion release the saved planes already
    #: carry (None: a file written before the field existed)
    released: Optional[np.ndarray] = None
    #: the boundary blob of a retry / kube replay (None: a plain replay)
    boundary: Optional[dict] = None

    def save(self, path: str) -> None:
        """Write the file atomically (a temporary beside it, then a rename)."""
        tmp = path + ".tmp"
        extra = {}
        if self.released is not None:
            extra["released"] = self.released.astype(bool)
        if self.boundary is not None:
            extra.update({f"bd_{k}": v for k, v in self.boundary.items()})
        np.savez_compressed(
            tmp,
            chunk_cursor=np.int64(self.chunk_cursor),
            used=self.used,
            match_count=self.match_count,
            anti_active=self.anti_active,
            pref_wsum=self.pref_wsum,
            num_outs=np.int64(len(self.outs)),
            **{f"out_{i}": o for i, o in enumerate(self.outs)},
            **extra,
        )
        os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)

    @classmethod
    def load(cls, path: str) -> "ReplayCheckpoint":
        with np.load(path) as z:
            n = int(z["num_outs"])
            bd = {k[len("bd_"):]: z[k] for k in z.files if k.startswith("bd_")}
            return cls(
                chunk_cursor=int(z["chunk_cursor"]),
                used=z["used"],
                match_count=z["match_count"],
                anti_active=z["anti_active"],
                pref_wsum=z["pref_wsum"],
                outs=[z[f"out_{i}"] for i in range(n)],
                released=z["released"] if "released" in z.files else None,
                boundary=bd or None,
            )


def domain_to_node_space(arr_gd: np.ndarray, gdom: np.ndarray) -> np.ndarray:
    """``[G, D]`` domain-space counts → ``[G, N]`` node space (0 where the
    node has no domain under that group's topology key). Kept as the
    reference module's public helper for tools that read a file's planes in
    node space; nothing in the port calls it: its count planes stay in
    domain space under node shards too, so a save reads them as they are."""
    safe = np.clip(gdom, 0, None)
    out = np.take_along_axis(arr_gd, safe, axis=1).astype(np.float32)
    return np.where(gdom >= 0, out, 0.0)


def node_space_to_domain(arr_gn: np.ndarray, gdom: np.ndarray, D: int) -> np.ndarray:
    """The inverse of :func:`domain_to_node_space` (every domain holds a
    node; a domain's nodes agree on its value). Like it, a public helper
    that nothing in the port calls."""
    G, N = arr_gn.shape
    out = np.zeros((G, D), np.float32)
    valid = gdom >= 0
    gi = np.broadcast_to(np.arange(G)[:, None], (G, N))
    out[gi[valid], gdom[valid]] = arr_gn[valid]
    return out
