"""Partitions: cpupool analogs owning devices, a scheduler, and jobs.

The port of ``pbs_tpu.runtime.partition``. A Partition owns a set of
device lanes, one scheduler instance chosen from the registry, the
telemetry ledger for its contexts, and the timer substrate. The
cooperative ``run()`` loop drives executors round-robin on one host
thread; under a ``VirtualClock`` it is fully deterministic and jumps
the clock to the next timer deadline when every executor is idle.

Admission (the optional compile-cache claim, then the optional HBM
claim through a ``MemoryManager``), run-state control with the pager's
fault path (waking a paged job restores its state first), fault
containment, the overflow sampler, the job consoles, the loop and
``dump()`` keep the reference's decision order. Not ported yet
(ROADMAP): security labels (xsm), lifecycle hooks, trace rings, the run
recorder, and the file-backed ledger with its monitor sidecar. None of
them changes a dispatch decision.
"""

from __future__ import annotations

import time
from typing import TYPE_CHECKING, Any, Callable

from pbs_tpu_torch.runtime.events import EventBus, Virq
from pbs_tpu_torch.runtime.executor import Executor
from pbs_tpu_torch.runtime.job import ContextState, Job
from pbs_tpu_torch.runtime.memory import nbytes_of
from pbs_tpu_torch.runtime.timer import TimerWheel
from pbs_tpu_torch.sched.base import Scheduler, make_scheduler
from pbs_tpu_torch.telemetry.ledger import Ledger
from pbs_tpu_torch.telemetry.source import TelemetrySource
from pbs_tpu_torch.utils.clock import Clock, VirtualClock

if TYPE_CHECKING:
    from pbs_tpu_torch.runtime.compile_gate import CompileAdmission
    from pbs_tpu_torch.runtime.memory import MemoryManager

DEFAULT_LEDGER_SLOTS = 128


class Partition:
    def __init__(
        self,
        name: str,
        source: TelemetrySource,
        scheduler: str = "credit",
        n_executors: int = 1,
        devices: list[Any] | None = None,
        clock: Clock | None = None,
        ledger_slots: int = DEFAULT_LEDGER_SLOTS,
        sched_params: dict[str, Any] | None = None,
        memory: "MemoryManager | None" = None,
        compile_admission: "CompileAdmission | None" = None,
    ):
        self.name = name
        self.source = source
        self.clock = clock if clock is not None else source.clock
        self.timers = TimerWheel()
        self.ledger = Ledger(ledger_slots)
        # Async signaling fabric (event_channel.c analog); delivered by
        # the run loop between quanta.
        self.events = EventBus()
        # i-mode counter sampling: thresholds -> Virq.TELEMETRY -> rearm
        # (the VIRQ_PERFCTR overflow path, telemetry/sampler.py; imported
        # here because the sampler imports runtime.events, so a
        # module-level import would cycle).
        from pbs_tpu_torch.telemetry.sampler import OverflowSampler

        self.sampler = OverflowSampler(self.events)
        # Optional HBM accounting/admission (runtime.memory).
        self.memory = memory
        # Optional compile-cache admission (runtime.compile_gate):
        # distinct programs per partition and cumulative compile time.
        self.compile_admission = compile_admission
        self._free_slots = list(range(ledger_slots - 1, -1, -1))
        self.jobs: list[Job] = []
        # Monotone quantum counter.
        self.progress_epoch = 0
        # Hook invoked on contained job failures (crash-dump wiring).
        self.on_job_failure: Callable[[Job, BaseException], None] | None = None
        self.executors: list[Executor] = []
        self.scheduler: Scheduler = make_scheduler(
            scheduler, self, **(sched_params or {}))
        devices = devices or [None] * n_executors
        for i, dev in enumerate(devices):
            ex = Executor(self, i, device=dev)
            self.executors.append(ex)
            self.scheduler.executor_added(ex)

    # -- admission (domain_create analog, xen/common/domain.c) -----------

    def add_job(self, job: Job) -> Job:
        if self.compile_admission is not None:
            # Fail-fast compile-cache claim FIRST: it touches no shared
            # state beyond its own table, so rejection leaves nothing
            # to unwind (the XENMEM_claim_pages ordering).
            self.compile_admission.admit(job)
        if self.memory is not None:
            # Fail-fast HBM admission (XENMEM_claim_pages): account +
            # claim the working set before touching scheduler state, so
            # a denied job leaves nothing behind.
            need = (job.mem_bytes if job.mem_bytes is not None
                    else nbytes_of(job.state))
            self.memory.open_account(job.name)
            try:
                self.memory.claim_or_balloon(job.name, need)
            except Exception:
                self.memory.close_account(job.name)
                if self.compile_admission is not None:
                    self.compile_admission.release(job.name)
                raise
        try:
            for ctx in job.contexts:
                if not self._free_slots:
                    raise RuntimeError("ledger slots exhausted")
                ctx.ledger_slot = self._free_slots.pop()
                self.ledger.reset(ctx.ledger_slot)
        except Exception:
            # Unwind fully — slots back on the freelist, account closed —
            # so a failed admission leaves nothing behind and the name
            # stays retryable.
            self._release_slots(job)
            self._release_admission(job)
            raise
        # Scheduler enrollment is part of the same atomic admission.
        enrolled = False
        try:
            self.jobs.append(job)
            self.scheduler.job_added(job)
            enrolled = True
            for ctx in job.contexts:
                if ctx.state is ContextState.RUNNABLE:
                    self.scheduler.wake(ctx)
            job.console.write(
                f"admitted to {self.name} "
                f"({len(job.contexts)} ctx, scheduler "
                f"{self.scheduler.name})")
        except Exception:
            if enrolled:
                try:
                    self.scheduler.job_removed(job)
                except Exception:  # noqa: BLE001 — best-effort unwind
                    pass
            if job in self.jobs:
                self.jobs.remove(job)
            self._release_slots(job)
            self._release_admission(job)
            raise
        return job

    def _release_slots(self, job: Job) -> None:
        for ctx in job.contexts:
            if ctx.ledger_slot >= 0:
                self._free_slots.append(ctx.ledger_slot)
                ctx.ledger_slot = -1

    def _release_admission(self, job: Job) -> None:
        """Close the job's HBM account and give back its compile-cache
        claim."""
        if self.memory is not None:
            self.memory.close_account(job.name)
        if self.compile_admission is not None:
            self.compile_admission.release(job.name)

    def remove_job(self, job: Job) -> None:
        job.console.write("destroyed")
        self._release_admission(job)
        # Dead jobs must not pin their contexts via armed samples (or
        # keep getting scanned by every overflow check).
        self.sampler.disarm_job(job)
        self.scheduler.job_removed(job)
        self.jobs.remove(job)
        self._release_slots(job)

    def job(self, name: str) -> Job:
        for j in self.jobs:
            if j.name == name:
                return j
        raise KeyError(name)

    # -- run-state control (vcpu_sleep/wake, schedule.c) -----------------

    def sleep_job(self, job: Job) -> None:
        for ctx in job.contexts:
            if ctx.runnable():
                ctx.state = ContextState.BLOCKED
                self.scheduler.sleep(ctx)

    def wake_job(self, job: Job) -> None:
        if job.paged is not None:
            # xenpaging fault path: touching a paged tenant restores
            # its device state first (claiming HBM back; may raise
            # OutOfDeviceMemory, leaving the job asleep+paged).
            from pbs_tpu_torch.runtime.paging import page_in_job

            page_in_job(self, job)
        for ctx in job.contexts:
            if ctx.state is ContextState.BLOCKED:
                ctx.state = ContextState.RUNNABLE
                self.scheduler.wake(ctx)

    def fail_job(self, job: Job, exc: BaseException) -> None:
        """Contain a fault to one job (the MCE-containment model): mark
        every context FAILED and notify — the partition and its other
        tenants keep running. The job's overflow samples go with it."""
        job.error = f"{type(exc).__name__}: {exc}"
        job.console.write(f"FAULT contained: {job.error}")
        self.sampler.disarm_job(job)
        for c in job.contexts:
            if c.state is not ContextState.FAILED:
                c.state = ContextState.FAILED
                self.scheduler.sleep(c)
        self.events.send_virq(Virq.JOB_FAILED)
        if self.on_job_failure is not None:
            self.on_job_failure(job, exc)

    # -- the loop --------------------------------------------------------

    def pending_work(self) -> bool:
        # PARKED counts: a timer (acct refill) will unpark it.
        live = (ContextState.RUNNABLE, ContextState.RUNNING,
                ContextState.PARKED)
        return any(
            ctx.state in live for j in self.jobs for ctx in j.contexts
        )

    def run(
        self,
        until_ns: int | None = None,
        max_rounds: int | None = None,
    ) -> int:
        """Drive executors until no runnable work (or bounds hit).

        Returns the number of quanta executed.
        """
        rounds = 0
        quanta = 0
        now_ns = self.clock.now_ns
        deliver_pending = self.events.deliver_pending
        executors = self.executors
        while True:
            if until_ns is not None and now_ns() >= until_ns:
                break
            if max_rounds is not None and rounds >= max_rounds:
                break
            rounds += 1
            deliver_pending()
            ran_any = False
            for ex in executors:
                if until_ns is not None and now_ns() >= until_ns:
                    break
                if ex.schedule_once():
                    ran_any = True
                    quanta += 1
            if not ran_any:
                if not self.pending_work():
                    break
                # Runnable work exists but nothing was dispatched (e.g.
                # parked for cap enforcement): jump to the next timer
                # event under virtual time, else sleep until it.
                deadline = self.timers.next_deadline()
                if deadline is None:
                    break
                if isinstance(self.clock, VirtualClock):
                    if deadline > self.clock.now_ns():
                        self.clock.advance(deadline - self.clock.now_ns())
                    self.timers.fire_due(self.clock.now_ns())
                else:
                    time.sleep(min(0.001, max(0.0, (deadline - self.clock.now_ns()) / 1e9)))
        return quanta

    # -- observability ---------------------------------------------------

    def dump(self) -> dict[str, Any]:
        """The 'r'/'z' console-key dump surface (``keyhandler.c:543-563``,
        ``schedule_customized_dump`` ``schedule.c:1442-1451``)."""
        return {
            "partition": self.name,
            "scheduler": self.scheduler.dump_settings(),
            "executors": [
                {
                    "index": ex.index,
                    "sched_invocations": ex.sched_invocations,
                    **self.scheduler.dump_executor(ex),
                }
                for ex in self.executors
            ],
            "contexts": self.scheduler.dump_admin_conf(),
        }
