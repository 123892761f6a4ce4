"""Clock abstraction: virtual time for deterministic simulation tests.

The reference validates its scheduler on live hardware only (SURVEY.md §4:
zero dedicated tests for the research delta). We instead follow the one
scalable pattern the reference does have — the x86_emulator fake-backend
pattern (``tools/tests/x86_emulator/test_x86_emulator.c``): policy code is
written against an injectable clock so the entire scheduler stack runs
deterministically on a host with no accelerator and no wall-clock dependence.

All times are integer nanoseconds (the hypervisor's ``s_time_t`` is signed
ns since boot; we keep the same unit so the reference's µs constants —
e.g. ``CSCHED_DEFAULT_TSLICE_US`` at ``sched_credit.c:52`` — translate
directly).
"""

from __future__ import annotations

import time
from typing import Protocol


class Clock(Protocol):
    def now_ns(self) -> int:
        """Current time in integer nanoseconds."""
        ...


class MonotonicClock:
    """Wall-clock backend (``time.monotonic_ns``)."""

    def now_ns(self) -> int:
        return time.monotonic_ns()


class VirtualClock:
    """Manually-advanced clock for deterministic scheduler simulation."""

    def __init__(self, start_ns: int = 0):
        self._now = start_ns

    def now_ns(self) -> int:
        return self._now

    def advance(self, delta_ns: int) -> int:
        if delta_ns < 0:
            raise ValueError("virtual clock cannot go backwards")
        self._now += delta_ns
        return self._now

    def advance_us(self, delta_us: float) -> int:
        return self.advance(int(delta_us * 1_000))

    def advance_ms(self, delta_ms: float) -> int:
        return self.advance(int(delta_ms * 1_000_000))


US = 1_000
MS = 1_000_000
SEC = 1_000_000_000
