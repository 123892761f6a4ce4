"""Watchdogs and crash dumps: failure detection for a partition.

The port of ``pbs_tpu.runtime.watchdog``.

Reference mapping (SURVEY.md §5 "failure detection"):

- The hypervisor's NMI watchdog drives a PMU counter so it can fire even
  when a CPU is wedged with interrupts off (``xen/arch/x86/nmi.c:38,
  249-302``). The device analog of "wedged with interrupts off" is a step
  that never returns (hung collective, tunnel loss): the cooperative run
  loop cannot observe it, so :class:`WallWatchdog` watches progress from
  its own thread — out-of-band by construction, like the NMI.
- Per-domain watchdogs (``tools/misc/xenwatchdogd.c``) require the guest
  to pet a timer or the domain is acted upon; :class:`Watchdog` is the
  in-loop equivalent, sampling executor/context progress from the timer
  wheel and flagging logical stalls (runnable work, no dispatch).
- On a fatal error Xen kexecs into a crash kernel and dumps state
  (``xen/common/kexec.c``); :func:`write_crash_dump` captures the
  postmortem (scheduler dump, per-context counters, trace tail,
  exception) as JSON next to the workload.
"""

from __future__ import annotations

import json
import os
import threading
import time
import traceback
from typing import TYPE_CHECKING, Any, Callable

import itertools

from pbs_tpu_torch.obs.trace import format_records
from pbs_tpu_torch.runtime.events import Virq
from pbs_tpu_torch.telemetry.counters import counters_dict
from pbs_tpu_torch.utils.clock import MS

if TYPE_CHECKING:
    from pbs_tpu_torch.runtime.job import Job
    from pbs_tpu_torch.runtime.partition import Partition


class WatchdogStallError(RuntimeError):
    """A partition with runnable work dispatched nothing — raised out of
    the run loop when no ``on_stall`` policy is installed (the NMI
    watchdog's default action is likewise panic, ``xen/arch/x86/nmi.c``),
    which also keeps the stalled loop from spinning on the watchdog's
    own periodic timer forever."""


class Watchdog:
    """In-loop logical-stall detector (xenwatchdogd analog).

    Every ``period_ns`` of partition time, compare the partition's total
    dispatch count against the last sample. Runnable work with *nothing
    dispatched anywhere* for ``threshold`` consecutive periods is a
    stall — a scheduler/policy bug (e.g. everything parked with no
    unpark timer armed). The check is deliberately partition-global:
    with work stealing, any single busy executor proves the scheduler
    is alive, while a per-executor check would flag lanes that simply
    have fewer contexts than executors. Fires ``Virq.WATCHDOG``, then
    either invokes ``on_stall`` or raises :class:`WatchdogStallError`.
    """

    def __init__(
        self,
        partition: "Partition",
        period_ns: int = 100 * MS,
        threshold: int = 2,
        on_stall: Callable[["Partition"], None] | None = None,
    ):
        self.partition = partition
        self.threshold = threshold
        self.on_stall = on_stall
        self.stalls: list[int] = []  # now_ns of each flagged stall
        self._last: int | None = None
        self._quiet = 0
        now = partition.clock.now_ns()
        self.timer = partition.timers.arm(
            now + period_ns, self._tick, period_ns=period_ns, name="watchdog"
        )

    def cancel(self) -> None:
        """Disarm: a watchdog left ticking after its run can panic an
        unrelated later run of the same partition."""
        self.timer.stop()

    def _tick(self, now_ns: int) -> None:
        part = self.partition
        if not part.pending_work():
            self._quiet = 0
            self._last = None
            return
        cur = sum(ex.dispatch_count for ex in part.executors)
        if cur != self._last:
            self._last = cur
            self._quiet = 0
            return
        self._quiet += 1
        if self._quiet == self.threshold:
            self.stalls.append(now_ns)
            part.events.send_virq(Virq.WATCHDOG)
            if self.on_stall is not None:
                self.on_stall(part)
            else:
                raise WatchdogStallError(
                    f"partition {part.name!r}: runnable work but no "
                    f"dispatch for {self.threshold} watchdog periods")


class WallWatchdog:
    """Out-of-band hung-step detector (the NMI watchdog analog).

    Runs in its own thread on wall time, so it fires even when the run
    loop is blocked inside a step that never completes. Progress is the
    partition's quantum epoch; ``on_bark(partition, idle_s)`` is invoked
    once per continuous hang (re-armed by new progress).
    """

    def __init__(
        self,
        partition: "Partition",
        timeout_s: float = 30.0,
        poll_s: float | None = None,
        on_bark: Callable[["Partition", float], None] | None = None,
    ):
        self.partition = partition
        self.timeout_s = timeout_s
        self.poll_s = poll_s if poll_s is not None else max(timeout_s / 4, 0.01)
        self.on_bark = on_bark
        self.barks = 0
        self._armed = False
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> "WallWatchdog":
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="pbst-wall-watchdog")
        self._thread.start()
        return self

    def _loop(self) -> None:
        part = self.partition
        last_epoch = part.progress_epoch
        last_change = time.monotonic()
        barked = False
        while not self._stop.wait(self.poll_s):
            if not self._armed:
                last_epoch = part.progress_epoch
                last_change = time.monotonic()
                continue
            epoch = part.progress_epoch
            if epoch != last_epoch:
                last_epoch = epoch
                last_change = time.monotonic()
                barked = False
                continue
            idle = time.monotonic() - last_change
            if idle >= self.timeout_s and not barked:
                barked = True
                self.barks += 1
                if self.on_bark is not None:
                    self.on_bark(part, idle)

    def arm(self) -> None:
        """Watch only while armed (i.e. while a run loop is active);
        an idle partition is not a hang."""
        self._armed = True

    def disarm(self) -> None:
        self._armed = False

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)

    def __enter__(self) -> "WallWatchdog":
        if self._thread is None or not self._thread.is_alive():
            # Re-entry after a previous stop(): restart the monitor
            # thread, otherwise this context would silently watch nothing.
            self._stop = threading.Event()
            self.start()
        self.arm()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.disarm()
        self.stop()  # idempotent; context-manager use must not leak the thread


#: Distinguishes dumps sharing a (virtual) timestamp — two jobs can
#: fault in the same scheduler round before the clock advances.
_dump_seq = itertools.count()


def write_crash_dump(
    crash_dir: str,
    partition: "Partition",
    reason: str,
    job: "Job | None" = None,
    exc: BaseException | None = None,
    max_trace: int = 256,
) -> str:
    """Capture a postmortem (kexec crash-kernel analog). Returns path."""
    os.makedirs(crash_dir, exist_ok=True)
    doc: dict[str, Any] = {
        "reason": reason,
        "time_ns": partition.clock.now_ns(),
        "partition": partition.dump(),
        "jobs": [
            {
                "job": j.name,
                "error": getattr(j, "error", None),
                "contexts": [
                    {
                        "ctx": c.name,
                        "state": c.state.value,
                        "sched_count": c.sched_count,
                        "counters": counters_dict(c.counters),
                    }
                    for c in j.contexts
                ],
            }
            for j in partition.jobs
        ],
        # peek, not drain: a second dump in the same run must still see
        # the tail, and a live xentrace-style consumer must not lose
        # records to a postmortem snapshot.
        "trace_tail": format_records(partition.peek_traces(max_trace)),
    }
    if job is not None:
        doc["failed_job"] = job.name
    if exc is not None:
        doc["exception"] = {
            "type": type(exc).__name__,
            "message": str(exc),
            "traceback": traceback.format_exception(exc),
        }
    fname = (f"crash-{partition.name}-{partition.clock.now_ns()}"
             f"-{next(_dump_seq)}.json")
    path = os.path.join(crash_dir, fname)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1, default=str)
    os.replace(tmp, path)
    return path


def install_crash_handler(partition: "Partition", crash_dir: str) -> None:
    """Wire job-failure containment to crash dumps: every contained
    failure leaves a postmortem file."""

    def _handler(job: "Job", exc: BaseException) -> None:
        write_crash_dump(crash_dir, partition,
                         reason=f"job {job.name} failed", job=job, exc=exc)

    partition.on_job_failure = _handler
