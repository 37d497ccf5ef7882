"""Scheduling queue of the CPU event engine.

Counterpart: ``kubernetes_simulator_tpu/framework/queue.py`` (a copy).
kube-scheduler queue semantics: an active heap ordered by QueueSort
(priority desc, then FIFO: ``(-priority, seq)``), a backoff queue with
exponential per-pod backoff (1 s → 10 s, the exponent capped at 8), and an
unschedulable set that is flushed back to active (or to backoff, while a
pod's backoff has not expired) when a cluster event might make pods
schedulable. Time here is the simulator's virtual clock.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

INITIAL_BACKOFF = 1.0
MAX_BACKOFF = 10.0


@dataclass
class _Entry:
    pod: int
    priority: int
    seq: int

    def sort_key(self) -> Tuple[int, int]:
        return (-self.priority, self.seq)


class SchedulingQueue:
    def __init__(self):
        self._heap: List[Tuple[Tuple[int, int], _Entry]] = []
        self._backoff: List[Tuple[float, Tuple[int, int], _Entry]] = []
        self._unschedulable: Dict[int, _Entry] = {}
        self._attempts: Dict[int, int] = {}
        self._fail_time: Dict[int, float] = {}
        self._seq = 0

    def push(self, pod: int, priority: int) -> None:
        e = _Entry(pod, priority, self._seq)
        self._seq += 1
        heapq.heappush(self._heap, (e.sort_key(), e))

    def pop(self) -> Optional[int]:
        if not self._heap:
            return None
        return heapq.heappop(self._heap)[1].pod

    def requeue_backoff(self, pod: int, priority: int, now: float) -> None:
        """Pod failed a scheduling attempt for a transient reason — retry
        after exponential backoff. The exponent is capped: the delay
        saturates at MAX_BACKOFF by n=4, and an uncapped 2**n overflows
        float for pods that fail thousands of times in a long trace."""
        n = self._attempts.get(pod, 0)
        self._attempts[pod] = n + 1
        delay = min(INITIAL_BACKOFF * (2 ** min(n, 8)), MAX_BACKOFF)
        e = _Entry(pod, priority, self._seq)
        self._seq += 1
        heapq.heappush(self._backoff, (now + delay, e.sort_key(), e))

    def mark_unschedulable(self, pod: int, priority: int, now: Optional[float] = None) -> None:
        """Record a failed scheduling attempt. With ``now``, the failure
        time and attempt count feed the backoff computed at flush time
        (pods moved out of the unschedulable set go through the backoff
        queue until their per-pod backoff expires)."""
        e = _Entry(pod, priority, self._seq)
        self._seq += 1
        self._unschedulable[pod] = e
        if now is not None:
            self._attempts[pod] = self._attempts.get(pod, 0) + 1
            self._fail_time[pod] = now

    def _backoff_expiry(self, pod: int) -> float:
        if pod not in self._fail_time:
            # No recorded failed attempt (parked without an attempt): no
            # backoff to serve, eligible for active immediately.
            return float("-inf")
        n = min(max(self._attempts.get(pod, 1) - 1, 0), 8)
        delay = min(INITIAL_BACKOFF * (2**n), MAX_BACKOFF)
        return self._fail_time[pod] + delay

    def flush_unschedulable(self, now: Optional[float] = None) -> None:
        """A cluster event occurred (binding freed resources, node change):
        move unschedulable pods back toward active (kube's
        MoveAllToActiveOrBackoffQueue). With ``now``, pods whose backoff has
        not yet expired land in the backoff queue instead of active."""
        for e in self._unschedulable.values():
            if now is not None:
                exp = self._backoff_expiry(e.pod)
                if exp > now:
                    heapq.heappush(self._backoff, (exp, e.sort_key(), e))
                    continue
            heapq.heappush(self._heap, (e.sort_key(), e))
        self._unschedulable.clear()

    def flush_backoff(self, now: float) -> None:
        while self._backoff and self._backoff[0][0] <= now:
            _, _, e = heapq.heappop(self._backoff)
            heapq.heappush(self._heap, (e.sort_key(), e))

    def next_backoff_time(self) -> Optional[float]:
        return self._backoff[0][0] if self._backoff else None

    def __len__(self) -> int:
        return len(self._heap)

    @property
    def num_unschedulable(self) -> int:
        return len(self._unschedulable)

    @property
    def num_backoff(self) -> int:
        return len(self._backoff)
