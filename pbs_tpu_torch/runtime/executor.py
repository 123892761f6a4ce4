"""Executors: the pCPU + ``schedule()`` softirq loop analog.

The port of ``pbs_tpu.runtime.executor``. Each executor multiplexes
execution contexts over one device lane of its partition, mirroring
Xen's per-pCPU scheduling loop (``xen/common/schedule.c:1082-1185``):
fire due timers, ask the policy for (next, quantum), context-switch
with telemetry save/restore, run, account.

There is no device preemption, so a quantum is realized as N steps, N
derived from the policy's nanosecond slice and the context's measured
per-step time. The dispatch arithmetic and its order are the
reference's, with its compile-admission charge and overflow-sampler
check at the quantum boundary; the trace and recorder taps are not
ported yet (ROADMAP).
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np

from pbs_tpu_torch import knobs
from pbs_tpu_torch.runtime.job import ContextState, ExecutionContext
from pbs_tpu_torch.telemetry.counters import NUM_COUNTERS, Counter

if TYPE_CHECKING:
    from pbs_tpu_torch.runtime.partition import Partition

#: Upper bound on steps per quantum, so a mispredicted avg_step_ns can't
#: starve the partition (no analog needed in Xen — timers preempt).
MAX_STEPS_PER_QUANTUM = knobs.default(
    "runtime.executor.max_steps_per_quantum")

# Plain-int counter indices for the dispatch hot path.
_I_DEVICE_TIME = int(Counter.DEVICE_TIME_NS)
_I_SCHED_COUNT = int(Counter.SCHED_COUNT)
_I_COMPILE_TIME = int(Counter.COMPILE_TIME_NS)


def quantum_to_steps(quantum_ns: int, avg_step_ns: float) -> int:
    if avg_step_ns <= 0:
        return 1
    return max(1, min(MAX_STEPS_PER_QUANTUM, round(quantum_ns / avg_step_ns)))


class Executor:
    """One schedulable device lane (pCPU analog)."""

    def __init__(self, partition: "Partition", index: int, device=None):
        self.partition = partition
        self.index = index
        self.device = device
        self.current: ExecutionContext | None = None
        self.sched_invocations = 0
        # Quanta actually dispatched (sched_invocations counts no-work
        # trips too).
        self.dispatch_count = 0
        self._micro_ok = hasattr(partition.source, "execute_micro")

    # ------------------------------------------------------------------

    def schedule_once(self) -> bool:
        """One trip through the scheduler loop. Returns True if work ran."""
        part = self.partition
        now = part.clock.now_ns()
        part.timers.fire_due(now)
        decision = part.scheduler.do_schedule(self, now)
        self.sched_invocations += 1
        ctx = decision.ctx
        if ctx is None:
            return False
        self._run(ctx, decision.quantum_ns)
        return True

    def _run(self, ctx: ExecutionContext, quantum_ns: int) -> None:
        part = self.partition
        job = ctx.job
        now = part.clock.now_ns()

        if job.finished():
            # Admitted with max_steps already reached (e.g. 0): retire
            # without executing anything.
            for c in job.contexts:
                if c.state is not ContextState.DONE:
                    c.state = ContextState.DONE
                    part.scheduler.sleep(c)
            return

        # -- context switch in: pmu_restore_regs + sched_count++ --------
        self.current = ctx
        ctx.state = ContextState.RUNNING
        ctx.sched_count += 1
        self.dispatch_count += 1
        if ctx.ledger_slot >= 0:
            part.ledger.resume(ctx.ledger_slot, now)

        # Sub-step latency bounding: a job with micro_per_step > 1 is
        # dispatched in micro units, so a long step no longer floors
        # the quantum.
        K = job.micro_per_step
        micro = K > 1 and self._micro_ok
        if micro:
            n_units = quantum_to_steps(quantum_ns, ctx.avg_step_ns / K)
            if job.max_steps is not None:
                rem = ((job.max_steps - job.steps_retired()) * K
                       - ctx.micro_progress)
                n_units = max(1, min(n_units, rem))
            n_steps_equiv = n_units / K
        else:
            n_units = quantum_to_steps(quantum_ns, ctx.avg_step_ns)
            if job.max_steps is not None:
                remaining = job.max_steps - job.steps_retired()
                n_units = max(1, min(n_units, remaining))
            n_steps_equiv = n_units

        try:
            if micro:
                deltas = part.source.execute_micro(ctx, n_units)
            else:
                deltas = part.source.execute(ctx, n_units)
        except Exception as exc:  # noqa: BLE001 — contained below
            # Fault containment (the MCE model): a step fault poisons
            # only the faulting job; the partition and its other
            # tenants keep running.
            if ctx.ledger_slot >= 0:
                part.ledger.suspend(
                    ctx.ledger_slot, np.zeros(NUM_COUNTERS, dtype=np.uint64))
            self.current = None
            part.fail_job(ctx.job, exc)
            return

        # -- context switch out: pmu_save_regs --------------------------
        ran_ns = int(deltas[_I_DEVICE_TIME])
        deltas[_I_SCHED_COUNT] = 1
        np.add(ctx.counters, deltas, out=ctx.counters)
        ctx.observe_step_time(ran_ns, n_steps_equiv)
        if part.compile_admission is not None:
            # Measured compile spend tightens the admission projections
            # (runtime.compile_gate) — the accounting leg of the claim.
            c_ns = int(deltas[_I_COMPILE_TIME])
            if c_ns:
                part.compile_admission.charge(job.name, c_ns)
        if ctx.ledger_slot >= 0:
            part.ledger.suspend(ctx.ledger_slot, deltas)
        self.current = None
        part.progress_epoch += 1

        end = part.clock.now_ns()
        part.timers.fire_due(end)
        part.scheduler.descheduled(self, ctx, ran_ns, end)
        # Overflow check at the quantum boundary (pmu_ihandler analog):
        # counters only advance here, so this is where i-mode thresholds
        # can cross; the virq is delivered by the run loop between quanta.
        part.sampler.check(ctx)

        if job.finished():
            for c in job.contexts:
                if c.state is not ContextState.DONE:
                    c.state = ContextState.DONE
                    part.scheduler.sleep(c)
        elif ctx.state is ContextState.RUNNING:
            ctx.state = ContextState.RUNNABLE

    def __repr__(self) -> str:
        return f"Executor({self.partition.name}#{self.index})"
