"""Credit2: per-runqueue credits, wake tickling, load balancing.

The port of ``pbs_tpu.sched.credit2``, decision for decision.

Semantic re-derivation of Xen's credit2 scheduler
(``xen-4.2.1/xen/common/sched_credit2.c``, 2,130 LoC; registered in
``schedule.c:65-70``) for step-quanta executors — the distinguishing
mechanisms, not a transliteration:

- **Per-runqueue design** (``struct csched2_runqueue_data``): executors
  are grouped into runqueues (per-socket there; per group of
  ``executors_per_runq`` lanes here). Each runqueue owns its own credit
  ordering, max_weight, and load average — cross-runqueue interaction
  happens ONLY through explicit load balancing, preserving locality
  (cache affinity there; device locality here).
- **Weight-relative burn** (``t2c`` conversion): running burns credit at
  ``elapsed x (runqueue max_weight / weight)`` — the heaviest tenant
  burns 1:1 and lighter tenants burn proportionally faster, so relative
  credit decay directly encodes the weight ratio (credit1 instead
  redistributes on a 30 ms accounting tick).
- **Credit reset** (``reset_credit``): when the best candidate's credit
  has sunk below zero, every context on THAT runqueue resets to
  ``CREDIT_INIT`` plus a bounded carryover of its remaining credit —
  preserving earned spacing without letting debt accumulate forever.
- **Wake tickling** (``runq_tickle``): there the IPI preempts the pCPU
  running the lowest-credit vcpu. Here preemption is quantum-boundary
  only, and the runqueue's credit-ordered shared queue makes the
  urgency *emergent*: a waker with more credit than any resident sorts
  to the head and is served at the very next boundary on ANY of the
  runqueue's executors — the wake-to-dispatch bound is the in-flight
  quantum, which micro-stepped jobs already make sub-step
  (runtime/executor.py). The ``tickles`` counter records exactly when
  Xen would have fired the IPI, so the latency behavior is observable
  and testable; contrast credit1, where an unboosted waker enters at
  UNDER tail and waits a full rotation.
- **Load balancing** (``balance_load``): runqueues track an EWMA of
  instantaneous load; every ``BALANCE_EVERY`` dispatches, if the
  busiest and idlest runqueues diverge enough, the highest-credit
  unpinned context migrates — locality is given up only on measured
  imbalance, never by default (credit1's work stealing grabs from any
  peer on any idle trip).
"""

from __future__ import annotations

import dataclasses

from pbs_tpu_torch import knobs
from pbs_tpu_torch.sched.base import (
    Decision,
    Scheduler,
    clamp_tslice_us,
    register_scheduler,
)
from pbs_tpu_torch.utils.clock import US

# Declared in the knob registry (sched.credit2.*); defaults are the
# reference values.
CREDIT_INIT = knobs.default("sched.credit2.credit_init")
#: Reset when the dispatch candidate has burned below zero
#: (CSCHED2_CREDIT_RESET).
RESET_THRESHOLD = knobs.default("sched.credit2.reset_threshold")
#: Carryover bound on reset: at most this fraction of CREDIT_INIT of
#: earned (or owed) spacing survives a reset.
CARRY_FRAC = knobs.default("sched.credit2.carry_frac")
#: Tickle margin (CSCHED2_MIGRATE_RESIST in spirit): a waker must beat
#: a resident by this many credit-µs to count as a preempting wake.
TICKLE_MARGIN = knobs.default("sched.credit2.tickle_margin")
#: Dispatches between load-balance checks (opt_load_balance tick).
BALANCE_EVERY = knobs.default("sched.credit2.balance_every")
#: Load divergence (EWMA runnable contexts) that justifies migration.
BALANCE_THRESHOLD = knobs.default("sched.credit2.balance_threshold")
#: EWMA decay for runqueue load (newer samples weigh 1/8).
LOAD_ALPHA = knobs.default("sched.credit2.load_alpha")

DEFAULT_WEIGHT = knobs.default("sched.credit2.default_weight")


@dataclasses.dataclass
class C2Ctx:
    credit: float = CREDIT_INIT
    runq: int = 0


class RunQueue:
    """One credit domain: a group of executors sharing an ordered queue
    (csched2_runqueue_data)."""

    def __init__(self, index: int):
        self.index = index
        self.executors: list[int] = []
        self.queue: list = []  # contexts, highest credit first
        self.max_weight = DEFAULT_WEIGHT
        self.load = 0.0  # EWMA of runnable depth
        self.resets = 0

    def observe_load(self) -> None:
        self.load += LOAD_ALPHA * (len(self.queue) - self.load)


@register_scheduler
class Credit2Scheduler(Scheduler):
    name = "credit2"

    def __init__(self, partition, executors_per_runq: int = 2):
        super().__init__(partition)
        self.executors_per_runq = max(1, int(executors_per_runq))
        self.runqs: list[RunQueue] = []
        self._ex_to_rq: dict[int, int] = {}
        self._dispatches = 0
        self.migrations = 0  # cross-runqueue moves (balancing only)
        self.tickles = 0

    # -- topology --------------------------------------------------------

    def _rq_of_ex(self, exi: int) -> RunQueue:
        return self.runqs[self._ex_to_rq[exi]]

    def executor_added(self, ex) -> None:
        rqi = ex.index // self.executors_per_runq
        while len(self.runqs) <= rqi:
            self.runqs.append(RunQueue(len(self.runqs)))
        self.runqs[rqi].executors.append(ex.index)
        self._ex_to_rq[ex.index] = rqi

    @staticmethod
    def _cc(ctx) -> C2Ctx:
        if not isinstance(ctx.sched_priv, C2Ctx):
            ctx.sched_priv = C2Ctx()
        return ctx.sched_priv

    # -- weight bookkeeping (csched2_dom_cntl updates max_weight) --------

    def _note_weight(self, rq: RunQueue, weight: int) -> None:
        if weight > rq.max_weight:
            rq.max_weight = weight

    def _refresh_max_weights(self) -> None:
        """Recompute every runqueue's max over the contexts ASSIGNED to
        it — including ones currently running (dequeued), whose burn
        rate depends on it. One pass over the partition, grouped by
        assignment."""
        maxes = [0] * len(self.runqs)
        for j in self.partition.jobs:
            for c in j.contexts:
                cc = c.sched_priv
                if isinstance(cc, C2Ctx) and cc.runq < len(maxes):
                    maxes[cc.runq] = max(maxes[cc.runq], j.params.weight)
        for rq in self.runqs:
            rq.max_weight = maxes[rq.index] or DEFAULT_WEIGHT

    def adjust_job(self, job, **params) -> None:
        super().adjust_job(job, **params)
        if "weight" in params:
            self._refresh_max_weights()

    # -- queue ops -------------------------------------------------------

    def _insert(self, rq: RunQueue, ctx) -> None:
        c = self._cc(ctx).credit
        i = 0
        while i < len(rq.queue) and self._cc(rq.queue[i]).credit >= c:
            i += 1
        rq.queue.insert(i, ctx)
        self._note_weight(rq, ctx.job.params.weight)

    def _remove(self, ctx) -> None:
        cc = self._cc(ctx)
        if cc.runq < len(self.runqs):
            rq = self.runqs[cc.runq]
            if ctx in rq.queue:
                rq.queue.remove(ctx)

    def job_removed(self, job) -> None:
        for ctx in job.contexts:
            self._remove(ctx)
            ctx.sched_priv = None  # drop from max_weight scans (the
            # partition still lists the job at this hook's call time)
        self._refresh_max_weights()

    def sleep(self, ctx) -> None:
        self._remove(ctx)

    def pick_executor(self, ctx) -> int:
        if ctx.executor_hint is not None:
            return ctx.executor_hint
        if not self.runqs:
            return 0
        rq = min(self.runqs, key=lambda r: (r.load, len(r.queue)))
        return rq.executors[0] if rq.executors else 0

    def wake(self, ctx) -> None:
        cc = self._cc(ctx)
        if cc.runq < len(self.runqs) and ctx in self.runqs[cc.runq].queue:
            return
        exi = self.pick_executor(ctx)
        rqi = self._ex_to_rq.get(exi, 0)
        cc.runq = rqi
        rq = self.runqs[rqi]
        self._insert(rq, ctx)
        # runq_tickle accounting: the waker out-credits a resident
        # (queued behind it, or currently running on one of the
        # runqueue's executors) by the margin — in Xen this fires the
        # preemption IPI; here the credit-ordered queue serves the
        # waker at the next boundary anyway (see module docstring), so
        # the counter records the event without extra machinery.
        residents = [c for c in rq.queue if c is not ctx]
        residents += [
            ex.current for ex in self.partition.executors
            if ex.index in rq.executors and ex.current is not None
        ]
        if any(cc.credit > self._cc(r).credit + TICKLE_MARGIN
               for r in residents):
            self.tickles += 1

    # -- dispatch --------------------------------------------------------

    def do_schedule(self, ex, now_ns: int) -> Decision:
        rq = self._rq_of_ex(ex.index)
        self._dispatches += 1
        if self._dispatches % BALANCE_EVERY == 0:
            self._balance()
        rq.observe_load()

        if not rq.queue:
            return Decision(None, 0)
        ctx = rq.queue.pop(0)
        # reset_credit: candidate under zero -> per-RUNQUEUE reset with
        # bounded carryover (spacing survives, debt doesn't).
        if self._cc(ctx).credit <= RESET_THRESHOLD:
            self._reset(rq, including=ctx)
        # Clamped at the Decision site (see sched/base.py): out-of-band
        # writes must not dispatch an out-of-band quantum.
        return Decision(ctx, clamp_tslice_us(ctx.job.params.tslice_us) * US)

    def _reset(self, rq: RunQueue, including=None) -> None:
        """reset_credit: every context ASSIGNED to the runqueue —
        queued, sleeping, or mid-dispatch — re-baselines, matching
        Xen's reset over all svcs. A sleeper skipped here would wake a
        full CREDIT_INIT behind its peers and serve a whole cycle of
        undeserved latency."""
        rq.resets += 1
        carry_bound = CREDIT_INIT * CARRY_FRAC
        members = {
            id(c): c
            for j in self.partition.jobs for c in j.contexts
            if isinstance(c.sched_priv, C2Ctx)
            and c.sched_priv.runq == rq.index
        }
        if including is not None:
            members[id(including)] = including
        for ctx in members.values():
            cc = self._cc(ctx)
            carry = max(-carry_bound, min(carry_bound, cc.credit))
            cc.credit = CREDIT_INIT + carry

    def descheduled(self, ex, ctx, ran_ns: int, now_ns: int) -> None:
        cc = self._cc(ctx)
        rq = self._rq_of_ex(ex.index)
        # t2c: burn scaled by max_weight/weight — the heaviest tenant
        # burns 1:1, lighter ones proportionally faster.
        w = max(1, ctx.job.params.weight)
        cc.credit -= (ran_ns / US) * (rq.max_weight / w)
        if ctx.runnable():
            cc.runq = rq.index
            self._insert(rq, ctx)

    # -- load balancing (balance_load) -----------------------------------

    def _balance(self) -> None:
        if len(self.runqs) < 2:
            return
        busiest = max(self.runqs, key=lambda r: r.load)
        idlest = min(self.runqs, key=lambda r: r.load)
        if busiest.load - idlest.load < BALANCE_THRESHOLD:
            return
        for ctx in busiest.queue:  # highest credit first
            if ctx.executor_hint is not None:
                continue  # pinned (hard affinity): not migratable
            busiest.queue.remove(ctx)
            self._cc(ctx).runq = idlest.index
            self._insert(idlest, ctx)
            self.migrations += 1
            return

    # -- observability ---------------------------------------------------

    def dump_settings(self) -> dict:
        return {
            "name": self.name,
            "executors_per_runq": self.executors_per_runq,
            "runqueues": [
                {"index": rq.index, "executors": rq.executors,
                 "load": round(rq.load, 3), "max_weight": rq.max_weight,
                 "resets": rq.resets}
                for rq in self.runqs
            ],
            "migrations": self.migrations,
            "tickles": self.tickles,
        }

    def dump_executor(self, ex) -> dict:
        rq = self._rq_of_ex(ex.index)
        return {
            "runq": [
                {"ctx": c.name, "credit": round(self._cc(c).credit, 1)}
                for c in rq.queue
            ],
            "runq_index": rq.index,
        }
