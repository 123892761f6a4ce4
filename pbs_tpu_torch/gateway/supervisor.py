"""Member-process supervision: liveness, restart-with-backoff, raw
process plumbing.

The port of ``pbs_tpu.gateway.supervisor``, transition for transition.
Two layers, deliberately separated (docs/GATEWAY.md "Process mode"):

- :class:`MemberSupervisor` — the pure liveness state machine. Every
  decision is a function of ``now_ns`` arguments, never of a clock it
  reads itself, so tests drive the whole lifecycle under an injected
  :class:`~pbs_tpu_torch.utils.clock.VirtualClock` with zero processes
  involved. States::

      spawning -> live <-> suspect -> restarting -> live ...
                                   -> failed        (budget exhausted)

  A member misses heartbeats into ``suspect``; ``miss_budget``
  consecutive misses declare it dead. Deaths restart with exponential
  backoff (``restart_backoff_ns * 2^k``) until ``max_restarts`` is
  exhausted, after which the member is ``failed`` and drained.

- :class:`ProcessHandle` — the one place in the package that touches
  raw process primitives (``multiprocessing`` spawn, ``os.kill``,
  ``SIGKILL``). ``kill9`` is a literal ``SIGKILL`` — no atexit, no
  finally blocks, no flush — so recovery works from the journal bytes
  that were durable *before* the kill.

The process federation (``procfed``) drives both. Port-only:
:func:`kill_group`, which ends a child started in a session of its own
together with every process it started; a raw process primitive, so it
lives here.
"""

from __future__ import annotations

import os
import signal
import subprocess

#: Spawn waits, port-file polls and reaps ride the host scheduler;
#: everything digest-covered consumes now_ns arguments instead.
REAL_CLOCK_SEAM = (
    "process supervision is wall-clock by nature: spawn latency and "
    "kill delivery are host-scheduler facts, not simulation state")

#: Liveness states (docs/GATEWAY.md "Process mode").
STATES = ("spawning", "live", "suspect", "restarting", "failed")


class MemberSupervisor:
    """Liveness bookkeeping for ONE member process. Pure: callers feed
    observations (``spawned``/``beat_ok``/``beat_missed``/``died``)
    with explicit timestamps and act on the returned verdicts."""

    def __init__(self, name: str, *, heartbeat_ns: int, miss_budget: int,
                 restart_backoff_ns: int, max_restarts: int, now_ns: int):
        if miss_budget < 1:
            raise ValueError("miss_budget must be >= 1")
        self.name = name
        self.heartbeat_ns = int(heartbeat_ns)
        self.miss_budget = int(miss_budget)
        self.restart_backoff_ns = int(restart_backoff_ns)
        self.max_restarts = int(max_restarts)
        self.state = "spawning"
        self.pid: int | None = None
        self.misses = 0
        self.restarts = 0  # restarts PERFORMED (spawn count - 1)
        self.next_beat_ns = int(now_ns) + self.heartbeat_ns
        self.restart_due_ns: int | None = None
        #: Every state change, in order: (now_ns, from, to, reason) —
        #: the process-mode report's lifecycle record.
        self.transitions: list[tuple[int, str, str, str]] = []

    def _to(self, state: str, now_ns: int, reason: str) -> None:
        if state not in STATES:
            raise ValueError(f"unknown supervisor state {state!r}")
        self.transitions.append((int(now_ns), self.state, state, reason))
        self.state = state

    # -- observations ----------------------------------------------------

    def spawned(self, pid: int, now_ns: int) -> None:
        """The member process is up and answered its port handshake."""
        if self.state not in ("spawning", "restarting"):
            raise ValueError(
                f"{self.name}: spawned() in state {self.state!r}")
        self.pid = int(pid)
        self.misses = 0
        self.restart_due_ns = None
        self.next_beat_ns = int(now_ns) + self.heartbeat_ns
        self._to("live", now_ns, f"pid={pid}")

    def beat_due(self, now_ns: int) -> bool:
        return (self.state in ("live", "suspect")
                and int(now_ns) >= self.next_beat_ns)

    def beat_ok(self, now_ns: int) -> None:
        self.misses = 0
        self.next_beat_ns = int(now_ns) + self.heartbeat_ns
        if self.state == "suspect":
            self._to("live", now_ns, "heartbeat resumed")

    def beat_missed(self, now_ns: int) -> str:
        """One missed heartbeat. Returns ``"wait"`` (stay suspect) or
        ``"dead"`` — the miss budget is spent; the caller must kill
        the pid (a half-dead process must not keep the journal fd) and
        then report :meth:`died`."""
        self.misses += 1
        self.next_beat_ns = int(now_ns) + self.heartbeat_ns
        if self.state == "live":
            self._to("suspect", now_ns, f"missed {self.misses}")
        if self.misses >= self.miss_budget:
            return "dead"
        return "wait"

    def died(self, now_ns: int) -> str:
        """The process is gone (SIGKILL observed, exit, or the miss
        budget spent). Returns ``"backoff"`` — a restart is scheduled
        at :attr:`restart_due_ns` — or ``"drain"``: the restart budget
        is exhausted; the federation must drain this member from the
        ring and hand its journaled queue off to survivors."""
        self.pid = None
        self.misses = 0
        if self.restarts >= self.max_restarts:
            self._to("failed", now_ns, "restart budget exhausted")
            return "drain"
        backoff = self.restart_backoff_ns * (2 ** self.restarts)
        self.restarts += 1
        self.restart_due_ns = int(now_ns) + backoff
        self._to("restarting", now_ns, f"backoff {backoff} ns")
        return "backoff"

    def restart_due(self, now_ns: int) -> bool:
        return (self.state == "restarting"
                and self.restart_due_ns is not None
                and int(now_ns) >= self.restart_due_ns)


class ProcessHandle:
    """One spawned member process. Owns every raw primitive: spawn
    (``multiprocessing`` spawn context — a fresh interpreter, never a
    fork of the parent's threads and locks), ``SIGKILL``, and the reap.
    Callers hold handles, not pids."""

    def __init__(self, target, args: tuple = ()):
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        self._proc = ctx.Process(target=target, args=args, daemon=True)
        self._closed = False
        self.exitcode: int | None = None

    def start(self) -> None:
        self._proc.start()

    @property
    def pid(self) -> int | None:
        return None if self._closed else self._proc.pid

    def alive(self) -> bool:
        return not self._closed and self._proc.is_alive()

    def kill9(self) -> None:
        """Literal ``SIGKILL`` — the kernel reclaims the process with
        no userspace cleanup, emulating a power cut for everything but
        the filesystem. Idempotent: a dead pid is already the goal."""
        pid = self.pid
        if pid is None:
            return
        try:
            os.kill(pid, signal.SIGKILL)
        except ProcessLookupError:
            pass  # already gone
        self.reap(timeout_s=5.0)

    def reap(self, timeout_s: float = 5.0) -> int | None:
        """Join the process so it never lingers as a zombie; escalate
        to SIGKILL if a graceful join times out. Returns the exit
        code (negative signal number for a killed child). Idempotent."""
        if self._closed:
            return self.exitcode
        self._proc.join(timeout_s)
        if self._proc.is_alive():
            pid = self._proc.pid
            if pid is not None:
                try:
                    os.kill(pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
            self._proc.join(timeout_s)
        self.exitcode = self._proc.exitcode
        self._proc.close()
        self._closed = True
        return self.exitcode


def kill_group(proc, grace_s: float) -> int:
    """End the process group that ``proc`` (a ``subprocess.Popen``
    started with ``start_new_session=True``) leads: SIGTERM, SIGKILL
    after ``grace_s`` to whatever of the group is left, then the reap.
    Returns the leader's exit code."""
    for sig, wait_s in ((signal.SIGTERM, grace_s), (signal.SIGKILL, None)):
        try:
            os.killpg(proc.pid, sig)
        except ProcessLookupError:
            break  # the whole group is gone
        try:
            proc.wait(timeout=wait_s)
        except subprocess.TimeoutExpired:
            continue
    return proc.wait()
