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
``dump()`` keep the reference's decision order, and so do the security
label checks (``runtime.xsm``) at admission and removal, the lifecycle
hooks (``runtime.hooks``; a required ``job-add`` hook failing unwinds
the whole admission), the per-executor trace rings (file-backed under
``trace_dir=``) with their batching, and the file-backed ledger
(``ledger_path=``) with its monitor sidecar. The scheduler defaults to
the ``sched=`` boot parameter. ``Partition.recorder`` is the run
recorder's seat: a ``sim.trace.TraceRecorder`` there gets one record per
dispatched quantum and per feedback decision, so a live run replays
offline in the simulator (``sim.trace.replay_partition``).
"""

from __future__ import annotations

import json
import os
import time
from typing import TYPE_CHECKING, Any, Callable

from pbs_tpu_torch.obs.trace import Ev, EmitBatch, TraceBuffer, merge_records
from pbs_tpu_torch.runtime import xsm
from pbs_tpu_torch.runtime.events import EventBus, Virq
from pbs_tpu_torch.runtime.executor import Executor
from pbs_tpu_torch.runtime.hooks import HookError, HookRegistry
from pbs_tpu_torch.runtime.job import ContextState, Job, SchedParams
from pbs_tpu_torch.runtime.memory import nbytes_of
from pbs_tpu_torch.runtime.timer import TimerWheel
from pbs_tpu_torch.sched.base import Scheduler, make_scheduler
from pbs_tpu_torch.telemetry.ledger import Ledger
from pbs_tpu_torch.telemetry.source import TelemetrySource
from pbs_tpu_torch.utils.clock import Clock, VirtualClock
from pbs_tpu_torch.utils.params import string_param

if TYPE_CHECKING:
    from pbs_tpu_torch.runtime.compile_gate import CompileAdmission
    from pbs_tpu_torch.runtime.job import ExecutionContext
    from pbs_tpu_torch.runtime.memory import MemoryManager

DEFAULT_LEDGER_SLOTS = 128

# ``sched=`` boot param (schedule.c:65-70): the scheduler a partition
# gets when its creator doesn't pick one explicitly.
_sched_param = string_param("sched", "credit")


class Partition:
    def __init__(
        self,
        name: str,
        source: TelemetrySource,
        scheduler: str | None = None,
        n_executors: int = 1,
        devices: list[Any] | None = None,
        clock: Clock | None = None,
        ledger_slots: int = DEFAULT_LEDGER_SLOTS,
        ledger_path: str | None = None,
        trace_dir: str | None = None,
        sched_params: dict[str, Any] | None = None,
        memory: "MemoryManager | None" = None,
        compile_admission: "CompileAdmission | None" = None,
    ):
        self.name = name
        self.source = source
        self.clock = clock if clock is not None else source.clock
        self.timers = TimerWheel()
        # File-backed ledger lets external monitors read live telemetry
        # lock-free across processes.
        self._ledger_path = ledger_path
        if ledger_path is not None:
            self.ledger = Ledger.file_backed(ledger_path, ledger_slots)
        else:
            self.ledger = Ledger(ledger_slots)
        # Per-executor lockless trace rings (per-CPU rings, trace.c).
        self.traces: list[TraceBuffer] = []
        # Master trace switch (the tb_init_done analog): drivers that
        # consume no ring turn it off so dispatch events skip the ring.
        self.trace_enabled = True
        # Optional per-ring staging batches (enable_trace_batching).
        self._trace_batches: list[EmitBatch] | None = None
        # Async signaling fabric (event_channel.c analog); delivered by
        # the run loop between quanta.
        self.events = EventBus()
        # i-mode counter sampling: thresholds -> Virq.TELEMETRY -> rearm
        # (the VIRQ_PERFCTR overflow path, telemetry/sampler.py; imported
        # here because the sampler imports runtime.events, so a
        # module-level import would cycle).
        from pbs_tpu_torch.telemetry.sampler import OverflowSampler

        self.sampler = OverflowSampler(self.events)
        # Optional quantum/tick recorder (sim.trace.TraceRecorder): when
        # set, every dispatched quantum and feedback tick is appended as
        # a JSONL record so the run can be replayed in the simulator.
        self.recorder = None
        # Optional HBM accounting/admission (runtime.memory).
        self.memory = memory
        # Optional compile-cache admission (runtime.compile_gate):
        # distinct programs per partition and cumulative compile time.
        self.compile_admission = compile_admission
        # Lifecycle hook scripts (the /etc/xen/scripts hotplug analog):
        # required job-add hooks gate admission.
        self.hooks = HookRegistry()
        self._free_slots = list(range(ledger_slots - 1, -1, -1))
        self.jobs: list[Job] = []
        # Monotone quantum counter; WallWatchdog reads it out-of-band.
        self.progress_epoch = 0
        # Hook invoked on contained job failures (crash-dump wiring).
        self.on_job_failure: Callable[[Job, BaseException], None] | None = None
        self.executors: list[Executor] = []
        self.scheduler: Scheduler = make_scheduler(
            scheduler if scheduler is not None else _sched_param.value,
            self, **(sched_params or {}))
        # File-backed rings let an external monitor attach live;
        # otherwise rings live in process memory. Absolute path: the
        # meta sidecar publishes it for monitors that run elsewhere.
        self._trace_dir = (
            os.path.abspath(trace_dir) if trace_dir is not None else None)
        if self._trace_dir is not None:
            os.makedirs(self._trace_dir, exist_ok=True)
        devices = devices or [None] * n_executors
        for i, dev in enumerate(devices):
            ex = Executor(self, i, device=dev)
            self.executors.append(ex)
            if self._trace_dir is not None:
                self.traces.append(TraceBuffer.file_backed(
                    os.path.join(self._trace_dir, f"trace{i}.ring")))
            else:
                self.traces.append(TraceBuffer())
            self.scheduler.executor_added(ex)
        # Overflow crossings land in ring 0 as TELEM_OVERFLOW in every
        # mode (trace content must not depend on whether trace batching
        # is enabled): the sampler stages a quantum's firings and
        # flushes at the end of each check() call.
        if self.traces:
            self.sampler.bind_trace(
                EmitBatch(self.traces[0], capacity=64), self.clock)

    # -- admission (domain_create analog, xen/common/domain.c) -----------

    def add_job(self, job: Job, subject: str = xsm.SYSTEM) -> Job:
        xsm.xsm_check(subject, "job.create", job.label)
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
        # Scheduler enrollment is part of the same atomic admission: a
        # job_added/wake failure or a required job-add hook failing
        # unwinds jobs-list membership, the ledger slots and the claims.
        enrolled = False
        try:
            self.jobs.append(job)
            self.scheduler.job_added(job)
            enrolled = True
            for ctx in job.contexts:
                if ctx.state is ContextState.RUNNABLE:
                    self.scheduler.wake(ctx)
            self._publish_meta()
            # Hotplug: a REQUIRED job-add hook failing aborts the whole
            # admission (the vif-attach-fails semantics) via the unwind
            # below; optional failures are contained inside fire().
            self.hooks.fire("job-add", self._hook_env(job),
                            console=job.console)
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
            try:
                # A required-hook failure lands AFTER the sidecar was
                # published: republish so monitors never attribute the
                # freed slots to a job that was never admitted.
                self._publish_meta()
            except Exception:  # noqa: BLE001 — unwind must complete
                pass
            raise
        return job

    def create_job(
        self,
        name: str,
        step_fn: Callable | None = None,
        state: Any = None,
        params: SchedParams | None = None,
        **kw: Any,
    ) -> Job:
        job = Job(name, step_fn=step_fn, state=state, params=params, **kw)
        return self.add_job(job)

    def _hook_env(self, job: Job, **extra: str) -> dict[str, str]:
        return {
            "PBST_JOB": job.name,
            "PBST_PARTITION": self.name,
            "PBST_LABEL": job.label,
            **extra,
        }

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

    def remove_job(self, job: Job, subject: str = xsm.SYSTEM) -> None:
        xsm.xsm_check(subject, "job.destroy", job.label)
        try:
            # Teardown hooks run while the job still exists (the detach
            # script sees the device); failure cannot block destruction.
            self.hooks.fire("job-remove", self._hook_env(job),
                            console=job.console)
        except HookError:
            pass
        job.console.write("destroyed")
        self._release_admission(job)
        # Dead jobs must not pin their contexts via armed samples (or
        # keep getting scanned by every overflow check).
        self.sampler.disarm_job(job)
        self.scheduler.job_removed(job)
        self.jobs.remove(job)
        self._release_slots(job)
        self._publish_meta()

    def job(self, name: str) -> Job:
        for j in self.jobs:
            if j.name == name:
                return j
        raise KeyError(name)

    # -- run-state control (vcpu_sleep/wake, schedule.c) -----------------

    def sleep_job(self, job: Job, notify: bool = True) -> None:
        """``notify=False`` is the internal-quiesce form (Remus epoch
        capture, migration save): a sub-second suspend/resume cycle is
        not a lifecycle event, and hotplug scripts must not run inside
        it."""
        changed = False
        for ctx in job.contexts:
            if ctx.runnable():
                ctx.state = ContextState.BLOCKED
                self.scheduler.sleep(ctx)
                changed = True
        if changed and notify:
            try:
                self.hooks.fire("job-sleep", self._hook_env(job),
                                console=job.console)
            except HookError:
                pass  # run-state changes cannot be vetoed

    def wake_job(self, job: Job, notify: bool = True) -> None:
        if job.paged is not None:
            # xenpaging fault path: touching a paged tenant restores
            # its device state first (claiming HBM back; may raise
            # OutOfDeviceMemory, leaving the job asleep+paged).
            from pbs_tpu_torch.runtime.paging import page_in_job

            page_in_job(self, job)
        changed = False
        for ctx in job.contexts:
            if ctx.state is ContextState.BLOCKED:
                ctx.state = ContextState.RUNNABLE
                self.scheduler.wake(ctx)
                changed = True
        if changed and notify:
            try:
                self.hooks.fire("job-wake", self._hook_env(job),
                                console=job.console)
            except HookError:
                pass

    def fail_job(self, job: Job, exc: BaseException,
                 ctx: "ExecutionContext | None" = None,
                 lane: int = 0) -> None:
        """Contain a fault to one job (the MCE-containment model): mark
        every context FAILED, notify, dump — the partition and its other
        tenants keep running. The job's overflow samples go with it.
        ``ctx``/``lane`` identify the faulting context and executor so
        the postmortem trace names the right victim."""
        job.error = f"{type(exc).__name__}: {exc}"
        job.console.write(f"FAULT contained: {job.error}")
        self.sampler.disarm_job(job)
        try:
            self.hooks.fire(
                "job-fail",
                self._hook_env(job, PBST_ERROR=job.error),
                console=job.console)
        except HookError:
            pass  # containment must complete regardless
        for c in job.contexts:
            if c.state is not ContextState.FAILED:
                c.state = ContextState.FAILED
                self.scheduler.sleep(c)
        if ctx is None and job.contexts:
            ctx = job.contexts[0]
        self.trace_emit(lane, Ev.JOB_FAILED,
                        ctx.ledger_slot if ctx is not None else 0)
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
        # Refresh the monitor sidecar so adapted tslice/weights are
        # visible after the run; staged trace batches land in the rings
        # so attached monitors see the full stream.
        self.flush_traces()
        self._publish_meta()
        return quanta

    # -- observability ---------------------------------------------------

    def _publish_meta(self) -> None:
        """Sidecar slot map so external monitors can label ledger slots
        (the xenstore-registered device metadata analog)."""
        if self._ledger_path is None:
            return
        meta = {
            "partition": self.name,
            "scheduler": self.scheduler.name,
            "trace_dir": self._trace_dir,
            "n_rings": len(self.traces),
            # Counter-source provenance: sources that can say what they
            # are do, so a monitor never reports sim-sourced numbers as
            # live.
            "source": (self.source.describe()
                       if hasattr(self.source, "describe") else
                       {"tier": type(self.source).__name__}),
            "slots": {
                str(ctx.ledger_slot): {
                    "ctx": ctx.name,
                    "job": job.name,
                    "weight": job.params.weight,
                    "cap": job.params.cap,
                    "tslice_us": job.params.tslice_us,
                }
                for job in self.jobs
                for ctx in job.contexts
                if ctx.ledger_slot >= 0
            },
        }
        tmp = self._ledger_path + ".meta.json.tmp"
        with open(tmp, "w") as f:
            json.dump(meta, f, indent=1)
        os.replace(tmp, self._ledger_path + ".meta.json")

    def enable_trace_batching(self, capacity: int = 256,
                              flush_ns: int = 1_000_000) -> None:
        """Stage trace events per ring through :class:`EmitBatch` (one
        vectorized ``emit_many`` per watermark instead of a scalar emit
        per event). Only for single-threaded drivers that own every
        producer, because staged records reach the ring at flush
        granularity."""
        self._trace_batches = [
            EmitBatch(t, capacity=capacity, flush_ns=flush_ns)
            for t in self.traces
        ]

    def flush_traces(self) -> None:
        if self._trace_batches is not None:
            for b in self._trace_batches:
                b.flush()

    def trace_emit(self, exi: int, event: int, *args: int) -> None:
        if self.trace_enabled and 0 <= exi < len(self.traces):
            if self._trace_batches is not None:
                self._trace_batches[exi].emit(
                    self.clock.now_ns(), event, *args)
            else:
                self.traces[exi].emit(self.clock.now_ns(), event, *args)

    def peek_traces(self, max_records: int = 4096):
        """Non-destructive tail of all rings, merged and time-sorted —
        for postmortems/snapshots that must not race a live consumer."""
        self.flush_traces()
        return merge_records([t.peek(max_records) for t in self.traces])

    def drain_traces(self, max_records: int = 4096):
        """xentrace analog: drain all rings, merged and time-sorted."""
        self.flush_traces()
        return merge_records([t.consume(max_records) for t in self.traces])

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
