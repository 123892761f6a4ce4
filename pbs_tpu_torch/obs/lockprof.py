"""Lock-contention profiling (LOCK_PROFILE / xenlockprof analog).

The port of ``pbs_tpu.obs.lockprof``. Reference: Xen's ``LOCK_PROFILE``
infrastructure wraps spinlocks with per-lock block counts and
cumulative block time (``xen-4.2.1/xen/common/spinlock.c:1-608``),
dumped/reset via console keys 'l'/'L' (``keyhandler.c:561-563``). The
same capability here: ``ProfiledLock`` wraps framework locks, and a
global registry aggregates per-lock acquire counts, contended-acquire
counts, wait and hold times (``dump``/``reset``).

Profiling is gated by the ``lock_profile`` boot param (off by default,
like Xen's compile-time gate): when off, acquire/release take the
no-bookkeeping fast path.
"""

from __future__ import annotations

import threading
import time

from pbs_tpu_torch.utils.params import boolean_param

#: Gate (Xen builds LOCK_PROFILE in conditionally; we flip at runtime).
lock_profile = boolean_param("lock_profile", False)


class LockStats:
    """Shared by every lock with the same name (Xen aggregates per lock
    *site*), so updates are serialized by ``_mu``, not by any one
    instance's underlying lock."""

    __slots__ = ("name", "acquires", "contended", "wait_ns", "hold_ns",
                 "max_wait_ns", "_mu")

    def __init__(self, name: str):
        self.name = name
        self._mu = threading.Lock()
        self._zero()

    def _zero(self) -> None:
        self.acquires = 0
        self.contended = 0
        self.wait_ns = 0
        self.hold_ns = 0
        self.max_wait_ns = 0

    def note_acquire(self, wait_ns: int | None) -> None:
        with self._mu:
            self.acquires += 1
            if wait_ns is not None:
                self.contended += 1
                self.wait_ns += wait_ns
                if wait_ns > self.max_wait_ns:
                    self.max_wait_ns = wait_ns

    def note_hold(self, hold_ns: int) -> None:
        with self._mu:
            self.hold_ns += hold_ns

    def reset(self) -> None:
        with self._mu:
            self._zero()

    def as_dict(self) -> dict:
        with self._mu:
            return {
                "name": self.name,
                "acquires": self.acquires,
                "contended": self.contended,
                "wait_ns": self.wait_ns,
                "hold_ns": self.hold_ns,
                "max_wait_ns": self.max_wait_ns,
            }


_reg_lock = threading.Lock()
_stats: dict[str, LockStats] = {}


def _stats_for(name: str) -> LockStats:
    with _reg_lock:
        s = _stats.get(name)
        if s is None:
            s = _stats[name] = LockStats(name)
        return s


class ProfiledLock:
    """A named lock with optional contention bookkeeping.

    Mirrors ``struct lock_profile`` hanging off ``spinlock_t``
    (``spinlock.c``): the stats object is shared by every lock with the
    same name (Xen aggregates per lock *site*).
    """

    def __init__(self, name: str, recursive: bool = False):
        self._lock = threading.RLock() if recursive else threading.Lock()
        self.stats = _stats_for(name)
        # Owner-only state: touched strictly between acquire and release,
        # so the underlying lock serializes access. _t_acq is the
        # outermost-acquire timestamp (None when hold isn't being timed,
        # e.g. profiling was off at acquire time); _depth handles RLock
        # re-entry so nested acquires neither re-stamp nor double-count.
        self._depth = 0
        self._t_acq: int | None = None

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        # Signature-compatible with threading.Lock so a ProfiledLock
        # can drop in anywhere a raw lock was (RemusSession's
        # time-bounded epoch quiesce depends on ``timeout=``); a failed
        # try/timed acquire touches no owner-only state.
        if not lock_profile.value:
            if not self._lock.acquire(blocking, timeout):
                return False
            self._depth += 1
            return True
        wait: int | None = None
        if not self._lock.acquire(blocking=False):
            if not blocking:
                return False
            t0 = time.monotonic_ns()
            if not self._lock.acquire(timeout=timeout):
                return False
            wait = time.monotonic_ns() - t0
        self._depth += 1
        self.stats.note_acquire(wait)
        if self._depth == 1:
            self._t_acq = time.monotonic_ns()
        return True

    def release(self) -> None:
        self._depth -= 1
        if self._depth == 0 and self._t_acq is not None:
            self.stats.note_hold(time.monotonic_ns() - self._t_acq)
            self._t_acq = None
        self._lock.release()

    def __enter__(self) -> "ProfiledLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


def dump() -> list[dict]:
    """The 'l' console key / xenlockprof surface: per-lock stats sorted
    by cumulative wait time (worst first)."""
    with _reg_lock:
        rows = [s.as_dict() for s in _stats.values()]
    return sorted(rows, key=lambda r: -r["wait_ns"])


def reset() -> None:
    """The 'L' console key: zero all lock statistics."""
    with _reg_lock:
        for s in _stats.values():
            s.reset()
