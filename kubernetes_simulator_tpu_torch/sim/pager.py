"""Paged pod waves: each chunk's pod rows streamed host → device in pages.

Counterparts: ``_PodPager`` (kubernetes_simulator_tpu/sim/jax_runtime.py:621),
the paged branch of ``JaxReplayEngine.replay`` (:2249-2275),
``SlotSource.page`` (ops/tpu.py:252) and ``ExtraSource.page``
(ops/tpu3.py:610).

Paged, the device holds no whole-trace pod tables: chunk c runs on a page
whose rows are the pods of its C·W slots, in slot order (a PAD slot's row
is a filler no launch reads), followed by the pods that release at
boundary c (its static bucket, in bucket order). The page's rows carry
page-local ids, as the reference's v3 pages do: slot s of chunk c names row
``s − c·C·W`` (the plan's :meth:`..torch_runtime.ChunkPlan.page_idx`) and the
bucket's k-th pod row ``C·W + k``; the choice buffer's columns stay global.
The kernels read a pod's rows by id only, so a page places as the resident
tables do, bit for bit.

Two pages are in flight (the chunk's own and the next), each a slot of
pinned host buffers and device buffers. :meth:`PodPager.prefetch` stages
the next chunk's page: threaded (the reference's default; its gate,
sim/jax_runtime.py:612 and :2275, is the ``overlap.pagerThread`` config
key) it hands the gather to ONE worker thread, otherwise it gathers on the
calling thread, as the reference's unthreaded pager does. The gather waits until the slot's previous
host→device copy has left its pinned buffers, fills them, and issues the
copies on a side stream behind a CUDA event recorded after the slot's
previous chunk (:meth:`PodPager.done`), so no launch still reading the slot
is overwritten. :meth:`PodPager.get` makes the current stream wait for the
page's copies. On the CPU (the twins) the gather fills the slot's tensors
directly. A page is a function of its chunk alone, so placements do not
depend on the gate.

The counters are the reference's ``_PodPager``'s, which the flight
recorder (:mod:`.flight`) reads: ``stalls`` counts the misses the loop
fetches itself (the first page, a page not prefetched), a deterministic
count; ``waits`` / ``wait_s`` the loop's waits on a prefetch still in
flight (a race outcome); ``stall_s`` the loop's exposed wall (misses and
waits), ``last_stall_s`` the latest of them; ``prefetch_wall_s`` the
prefetches' own wall (hidden when threaded); ``invalidations`` the staged
pages dropped because another chunk was asked for; ``depth`` the pages
staged ahead (0 or 1).
"""

from __future__ import annotations

import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..models.encode import EncodedPods
from ..ops import reference as ref

#: DevPods field → EncodedPods field (ops/reference.py pods_to)
_FIELDS = {f: ("pod_matches_group" if f == "pmg" else f) for f in ref.DevPods._fields}
_DTYPES = {"na_has_req": torch.bool, "spread_dns": torch.bool, "pmg": torch.bool,
           "requests": torch.float32, "na_pref_w": torch.float32, "pref_aff_w": torch.float32}


class Page(NamedTuple):
    """One chunk's page: the pod tables of its slot (``slot`` 0 or 1) and the
    page-local ids of the boundary's released pods (None: none release)."""

    slot: int
    pods: ref.DevPods
    rel_ids: Optional[torch.Tensor]  # [K] i32


class _Slot:
    def __init__(self, shapes: Dict[str, tuple], dtypes: Dict[str, torch.dtype], device,
                 cuda: bool):
        self.dev = {f: torch.zeros(shapes[f], dtype=dtypes[f], device=device) for f in shapes}
        self.host = ({f: torch.zeros(shapes[f], dtype=dtypes[f], pin_memory=True)
                      for f in shapes} if cuda else None)
        self.copied = torch.cuda.Event() if cuda else None  # the slot's last copies are done
        self.consumed = torch.cuda.Event() if cuda else None  # its last chunk's launches are
        self.used = False


class PodPager:
    """Rolling two-deep pager of the pod rows of a chunk plan (module
    docstring). ``idx`` [num_waves, W] and ``buckets`` are the plan's; C its
    chunk length."""

    def __init__(self, pods: EncodedPods, idx: np.ndarray, C: int,
                 buckets: List[Optional[tuple]], device, threaded: bool = True):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self._pods, self._idx, self.C = pods, idx, int(C)
        self._buckets = buckets
        self.W = idx.shape[1]
        self.CW = self.C * self.W
        kmax = max((len(bk[0]) for bk in buckets if bk is not None), default=0)
        #: rows of a page: the chunk's slots, then room for the largest bucket
        self.rows = self.CW + kmax
        shapes, dtypes = {}, {}
        for f, src in _FIELDS.items():
            a = getattr(pods, src)
            shapes[f] = (self.rows,) + a.shape[1:]
            dtypes[f] = _DTYPES.get(f, torch.int32)
        self._slots = [_Slot(shapes, dtypes, self.device, self.cuda) for _ in range(2)]
        #: the page-local ids of a bucket's rows (a page's first k of them)
        self._rel_ids = torch.arange(self.CW, self.rows, dtype=torch.int32, device=self.device)
        self._side = torch.cuda.Stream(device=self.device) if self.cuda else None
        self.threaded = bool(threaded)
        self._pool = (ThreadPoolExecutor(max_workers=1, thread_name_prefix="ksim-pager")
                      if self.threaded else None)
        self._next: Optional[tuple] = None  # (chunk, Future or Page)
        self.stalls = 0
        self.stall_s = 0.0
        self.last_stall_s = 0.0
        self.prefetches = 0
        self.waits = 0
        self.wait_s = 0.0
        self.prefetch_wall_s = 0.0
        self.invalidations = 0

    @property
    def depth(self) -> int:
        """Pages staged ahead: 0 or 1 (two deep, counting the chunk's own)."""
        return 0 if self._next is None else 1

    @property
    def pods0(self) -> ref.DevPods:
        """Slot 0's pod tables (a Tables' ``pods`` before the first page)."""
        return self._page_pods(0)

    def _page_pods(self, slot: int) -> ref.DevPods:
        return ref.DevPods(**self._slots[slot].dev)

    def _rows_of(self, c: int):
        """(pod ids of page c's rows, the bucket's length)."""
        flat = self._idx[c * self.C:(c + 1) * self.C].reshape(-1)
        bk = self._buckets[c] if c < len(self._buckets) else None
        rel = bk[0] if bk is not None else np.zeros(0, np.int32)
        rows = np.concatenate([np.clip(flat, 0, None), rel]).astype(np.int64)
        return rows, len(rel)

    def _fetch(self, c: int) -> Page:
        """Gather page c into its slot and issue its copies (the worker
        thread, or the calling thread unthreaded and on a miss)."""
        slot = c % 2
        sl = self._slots[slot]
        rows, k = self._rows_of(c)
        n = rows.size
        if self.cuda:
            sl.copied.synchronize()  # the pinned buffers' last copies have left
            for f, src in _FIELDS.items():
                sl.host[f][:n].numpy()[...] = getattr(self._pods, src)[rows]
            with torch.cuda.stream(self._side):
                if sl.used:
                    self._side.wait_event(sl.consumed)  # the slot's last chunk has run
                for f in _FIELDS:
                    sl.dev[f][:n].copy_(sl.host[f][:n], non_blocking=True)
                sl.copied.record(self._side)
        else:
            for f, src in _FIELDS.items():
                sl.dev[f][:n].copy_(torch.from_numpy(getattr(self._pods, src)[rows]))
        sl.used = True
        return Page(slot=slot, pods=self._page_pods(slot),
                    rel_ids=self._rel_ids[:k] if k else None)

    def _timed_fetch(self, c: int) -> Page:
        t0 = time.perf_counter()
        page = self._fetch(c)
        self.prefetch_wall_s += time.perf_counter() - t0
        return page

    @staticmethod
    def _drain(staged) -> None:
        if isinstance(staged, Future):
            staged.result()

    def get(self, c: int) -> Page:
        """Chunk c's page, staged; the current stream waits for its copies."""
        staged, self._next = self._next, None
        if staged is not None and staged[0] != c:
            # A page staged for another chunk: dropped once its gather is done.
            self.invalidations += 1
            self._drain(staged[1])
            staged = None
        if staged is None:
            t0 = time.perf_counter()
            page = self._fetch(c)
            self.last_stall_s = time.perf_counter() - t0
            self.stall_s += self.last_stall_s
            self.stalls += 1
        elif isinstance(staged[1], Future) and not staged[1].done():
            t0 = time.perf_counter()
            page = staged[1].result()
            self.last_stall_s = time.perf_counter() - t0
            self.waits += 1
            self.wait_s += self.last_stall_s
            self.stall_s += self.last_stall_s
        else:
            page = staged[1].result() if isinstance(staged[1], Future) else staged[1]
        if self.cuda:
            torch.cuda.current_stream(self.device).wait_event(self._slots[page.slot].copied)
        return page

    def prefetch(self, c: int) -> None:
        """Stage chunk c's page (on the worker when threaded)."""
        self.prefetches += 1
        self._next = (c, self._pool.submit(self._timed_fetch, c) if self._pool is not None
                      else self._timed_fetch(c))

    def done(self, page: Page) -> None:
        """The launches of ``page``'s chunk are enqueued: its slot may be
        refilled once the card has run them."""
        if self.cuda:
            self._slots[page.slot].consumed.record(torch.cuda.current_stream(self.device))

    def close(self) -> None:
        if self._next is not None:
            self._drain(self._next[1])
            self._next = None
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
