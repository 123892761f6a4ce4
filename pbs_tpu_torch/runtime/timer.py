"""Deadline timers fired from the executor loop.

Analog of Xen's timer substrate (``xen/common/timer.c``) as used by the
credit scheduler, which arms four per-pCPU tickers in
``csched_alloc_pdata`` (``sched_credit.c:646-692``): master_ticker
(accounting), slice_ticker (slice re-application), ticker (per-domain
tick) and metric_ticker (1 ms PMC sampling). Timers here are fired
synchronously from the executor loop against the injected clock, which
keeps every policy test deterministic under ``VirtualClock``.
"""

from __future__ import annotations

import heapq
import itertools
from typing import Callable


class Timer:
    __slots__ = ("when_ns", "period_ns", "fn", "name", "dead")

    def __init__(self, when_ns: int, fn: Callable[[int], None], period_ns: int = 0,
                 name: str = ""):
        self.when_ns = when_ns
        self.period_ns = period_ns  # 0 = one-shot
        self.fn = fn
        self.name = name
        self.dead = False

    def stop(self) -> None:
        self.dead = True


class TimerWheel:
    """Min-heap of timers, popped by the executor before each schedule."""

    def __init__(self):
        self._heap: list[tuple[int, int, Timer]] = []
        self._seq = itertools.count()

    def arm(self, when_ns: int, fn: Callable[[int], None], period_ns: int = 0,
            name: str = "") -> Timer:
        t = Timer(when_ns, fn, period_ns, name)
        heapq.heappush(self._heap, (when_ns, next(self._seq), t))
        return t

    def next_deadline(self) -> int | None:
        while self._heap and self._heap[0][2].dead:
            heapq.heappop(self._heap)
        return self._heap[0][0] if self._heap else None

    def fire_due(self, now_ns: int, limit: int = 10_000) -> int:
        """Fire all timers due at or before ``now_ns``. Returns count."""
        h = self._heap
        # Nothing due: the per-quantum common case (the executor calls
        # this twice per dispatch) exits on one peek. A dead timer at
        # the head parked before its deadline falls through unharvested
        # until it comes due — same observable behavior.
        if not h or h[0][0] > now_ns:
            return 0
        fired = 0
        while self._heap and fired < limit:
            when, _, t = self._heap[0]
            if t.dead:
                heapq.heappop(self._heap)
                continue
            if when > now_ns:
                break
            heapq.heappop(self._heap)
            if t.period_ns > 0:
                # Re-arm before firing so handlers may stop() it.
                t.when_ns = when + t.period_ns
                heapq.heappush(self._heap, (t.when_ns, next(self._seq), t))
            t.fn(now_ns)
            fired += 1
        return fired
