"""Gang scheduling support: co-placement and skew-derived contention.

The port of ``pbs_tpu.parallel.gang``, a copy.

SURVEY.md §7's design note: a ring/sequence-sharded job is the analog of
a multi-vCPU SMP guest — preempting one member stalls the whole ring
(lock-holder preemption reborn). The reference detects that condition
from inside the guest via the spin-latency hypercall
(``__ticket_spin_lock`` -> ``vcrd_op``, ``asm/spinlock.h:55-80``); here
the equivalent *observable* is progress skew between gang members, which
the GangMonitor converts into the batched contention hint
(``Job.report_contention``) consumed by the feedback policies.

Placement side: the credit scheduler's ``pick_executor`` consults
``anti_stack_pick`` so gang members land on distinct executors — the
atc variant's anti-stacking affinity rewrite
(``sched_credit_atc.c:545-570``) generalized to "never stack ring
members on one lane".
"""

from __future__ import annotations

from typing import TYPE_CHECKING

from pbs_tpu_torch.obs.trace import Ev
from pbs_tpu_torch.telemetry.counters import Counter
from pbs_tpu_torch.utils.clock import MS

if TYPE_CHECKING:
    from pbs_tpu_torch.runtime.job import ExecutionContext, Job
    from pbs_tpu_torch.runtime.partition import Partition


# Re-exported for compatibility; the implementation lives torch-free in
# pbs_tpu_torch.sched.placement so the scheduler core never imports torch.
from pbs_tpu_torch.sched.placement import anti_stack_pick  # noqa: F401


class GangMonitor:
    """Per-tick skew watcher for multi-context jobs.

    Every tick, compute each gang job's progress spread
    (max - min of member device time this interval); report the spread
    as contention and mirror it into the GANG_SKEW counter. Feeds the
    same channel the reference fills from guest spinlocks — the policies
    (FeedbackPolicy / AtcFeedbackPolicy) are agnostic to the source.
    """

    def __init__(self, partition: "Partition", tick_ns: int = 1 * MS):
        self.partition = partition
        self._last: dict[str, list[int]] = {}
        now = partition.clock.now_ns()
        self.timer = partition.timers.arm(
            now + tick_ns, self._tick, period_ns=tick_ns, name="gang_monitor"
        )

    def _tick(self, now_ns: int) -> None:
        for job in self.partition.jobs:
            if len(job.contexts) < 2:
                continue
            cur = [int(c.counters[Counter.DEVICE_TIME_NS])
                   for c in job.contexts]
            last = self._last.get(job.name)
            self._last[job.name] = cur
            if last is None or len(last) != len(cur):
                continue
            deltas = [c - p for c, p in zip(cur, last)]
            if not any(deltas):
                continue  # gang idle this tick
            skew = max(deltas) - min(deltas)
            if skew <= 0:
                continue
            job.report_contention(skew, events=1)
            for ctx in job.contexts:
                ctx.counters[Counter.GANG_SKEW_NS] += skew
            self.partition.trace_emit(
                0, Ev.CONTENTION, job.contexts[0].ledger_slot, skew, 1)
