"""SEDF scheduler: EDF reservations + weighted extra-time distribution.

The port of ``pbs_tpu.sched.sedf``, decision for decision.

Semantic port of Xen's SEDF (``xen-4.2.1/xen/common/sched_sedf.c``,
1,544 LoC), the full design — not just the EDF core:

- **Reservations** (``sedf_adjust``, sched_sedf.c:1369-1478): a job
  holds ``slice_us`` of device time per ``period_us``; budget
  replenishes each period; earliest deadline with remaining budget
  runs.  Deadline misses are detected and repaired with modulo
  catch-up and a fresh slice (``update_queues``, sched_sedf.c:509-546),
  and counted.
- **Weight-driven parameters** (``sedf_adjust_weights``,
  sched_sedf.c:1294-1365): jobs given a *weight* instead of explicit
  (period, slice) all share ``WEIGHT_PERIOD``; slices are derived
  ``weight_i / Σweights`` of what is left after explicit reservations
  are carved out (``WEIGHT_SAFETY`` margin kept free).
- **Two-level extra-time queues** (``sedf_do_extra_schedule``,
  sched_sedf.c:667-723): slack time goes first to the L0 *penalty*
  queue (jobs owed compensation for short-block loss, lowest score
  first), then the L1 *utilization* queue — weighted round-robin where
  a job's score is the inverse of its reserved utilization, or
  ``(1<<17)/extraweight`` for pure best-effort tenants
  (sched_sedf.c:618-631).  New jobs default to best-effort with
  ``extraweight=1`` (``sedf_alloc_vdata``, sched_sedf.c:311-335).
- **Unblocking policies** (the case analysis at sched_sedf.c:895-955):
  *short* blocks (wake before the old deadline) forfeit realtime
  execution for the period but earn a penalty-queue claim sized by the
  lost slice (``unblock_short_extra_support``, sched_sedf.c:957-1010);
  *long* blocks restart the period at the wake ("conservative 2b",
  ``unblock_long_cons_b``, sched_sedf.c:1013-1020); wakes *before* the
  period begins only re-join the extra queues (``sedf_wake``,
  sched_sedf.c:1117-1133).
- **Latency scaling** (Atropos case 2c, sched_sedf.c:944-947, and the
  burst-mode doubling in ``desched_edf_dom``, sched_sedf.c:430-444): a
  job with a ``latency_us`` hint wakes from a long block with its
  period shrunk to the hint (slice scaled proportionally) and
  *doubles* back toward the configured period each completed slice —
  fast first service after I/O without breaking other reservations.

Device adaptation: a step is not preemptible, so slice edges are
honored at step granularity (quanta are advisory minima, as for every
policy here) and the reference's wake-preemption check
(``should_switch``, sched_sedf.c:1073-1105) reduces to class priority
at the next natural decision point: EDF > penalty > utilization > idle.
Queues are re-sorted at decision time instead of insertion-sorted
lists — tenant counts are tiny compared to a Xen box's vcpu counts.
"""

from __future__ import annotations

import dataclasses

from pbs_tpu_torch import knobs
from pbs_tpu_torch.sched.base import Decision, Scheduler, register_scheduler
from pbs_tpu_torch.utils.clock import MS, US

# sched_sedf.c:37-43, declared in the knob registry (sched.sedf.*).
EXTRA_QUANTUM_NS = knobs.default("sched.sedf.extra_quantum_ns")
WEIGHT_PERIOD_US = knobs.default("sched.sedf.weight_period_us")
WEIGHT_SAFETY_US = knobs.default("sched.sedf.weight_safety_us")
PERIOD_MAX_US = knobs.default("sched.sedf.period_max_us")
PERIOD_MIN_US = knobs.default("sched.sedf.period_min_us")
SLICE_MIN_US = knobs.default("sched.sedf.slice_min_us")

# Run classes for the last dispatch (get_run_type, sched_sedf.c:1022-1037).
RUN_EDF = "edf"
RUN_PEN = "pen"
RUN_UTIL = "util"


@dataclasses.dataclass
class SedfCtx:
    """Per-context state (struct sedf_vcpu_info, sched_sedf.c:59-105)."""

    # Reservation (current; latency scaling shrinks these temporarily).
    period_us: int = WEIGHT_PERIOD_US
    slice_us: int = 0                      # 0 = best-effort
    period_orig_us: int = WEIGHT_PERIOD_US
    slice_orig_us: int = 0
    latency_us: int = 0
    weight: int = 0                        # weight-driven reservation
    extraweight: int = 1                   # best-effort share (default 1)
    extratime: bool = True                 # EXTRA_AWARE

    # EDF accounting.
    cputime_ns: int = 0                    # consumed in current slice
    deadline_ns: int = 0
    block_ns: int = 0                      # when the context slept

    # Extra-time machinery.
    want_pen_q: bool = False               # EXTRA_WANT_PEN_Q
    score_pen: float = 0.0                 # lower = served sooner
    score_util: float = 0.0
    util_vtime: float = 0.0                # weighted-RR virtual time
    short_block_lost_ns: int = 0
    run_type: str = RUN_EDF

    # Stats (SEDF_STATS block, sched_sedf.c:88-103).
    block_tot: int = 0
    short_block_tot: int = 0
    long_block_tot: int = 0
    pen_extra_blocks: int = 0
    pen_extra_slices: int = 0
    extra_time_tot_ns: int = 0
    deadline_misses: int = 0

    def period_begin_ns(self) -> int:      # PERIOD_BEGIN, sched_sedf.c:125
        return self.deadline_ns - self.period_us * US


@register_scheduler
class SedfScheduler(Scheduler):
    name = "sedf"

    def __init__(self, partition):
        super().__init__(partition)
        self.contexts: list = []

    @staticmethod
    def _sc(ctx) -> SedfCtx:
        if not isinstance(ctx.sched_priv, SedfCtx):
            ctx.sched_priv = SedfCtx()
        return ctx.sched_priv

    # -- lifecycle -------------------------------------------------------

    def job_added(self, job) -> None:
        for ctx in job.contexts:
            self._sc(ctx)

    def job_removed(self, job) -> None:
        for ctx in job.contexts:
            if ctx in self.contexts:
                self.contexts.remove(ctx)
        # Called while the departing job is still on partition.jobs:
        # exclude it so its weight/carve-out stop counting and the
        # freed capacity is redistributed immediately.
        self._reweigh(exclude=job)

    # -- control plane (sedf_adjust, sched_sedf.c:1369-1478) -------------

    def set_reservation(self, job, period_us: int, slice_us: int,
                        latency_us: int = 0, extratime: bool = False) -> None:
        """Time-driven reservation: explicit (period, slice) on every
        context, plus the latency hint and extra-time awareness.
        ``extratime`` defaults off — ``sedf_adjust`` *clears*
        EXTRA_AWARE unless the flag is passed (sched_sedf.c:1471-1474),
        so a reserved tenant takes only its slice unless it opts into
        slack."""
        if slice_us > period_us:
            raise ValueError("slice must not exceed period")
        if not (PERIOD_MIN_US <= period_us <= PERIOD_MAX_US):
            raise ValueError(
                f"period {period_us}us outside "
                f"[{PERIOD_MIN_US}, {PERIOD_MAX_US}]us")
        if 0 < slice_us < SLICE_MIN_US:
            raise ValueError(f"slice must be 0 or >= {SLICE_MIN_US}us")
        if slice_us == 0 and not extratime:
            # sedf_adjust's starvation guard: no reserved time AND no
            # extra-time awareness means the job could never run.
            raise ValueError(
                "slice_us=0 requires extratime=True (the job would "
                "otherwise never be scheduled)")
        now = self.partition.clock.now_ns()
        for ctx in job.contexts:
            sc = self._sc(ctx)
            sc.weight = 0
            sc.extraweight = 0 if slice_us else 1
            sc.period_us = sc.period_orig_us = period_us
            sc.slice_us = sc.slice_orig_us = slice_us
            sc.latency_us = latency_us
            sc.extratime = extratime
            sc.cputime_ns = 0
            # Only stamp a deadline for contexts currently competing;
            # a blocked context keeps deadline 0 so its eventual wake
            # initializes the first period there instead of
            # misclassifying as a short block (sedf_adjust leaves
            # deadl_abs alone; first wake sets it, sched_sedf.c:1108).
            sc.deadline_ns = (now + period_us * US
                              if ctx in self.contexts else 0)
        self._reweigh()

    def set_weight(self, job, weight: int, extratime_only: bool = False,
                   latency_us: int = 0) -> None:
        """Weight-driven reservation: this job's slice is derived from
        its share of all weights within WEIGHT_PERIOD.  With
        ``extratime_only`` the weight instead ranks the job on the
        utilization extra queue (extraweight, sched_sedf.c:1410-1424)."""
        if weight <= 0:
            raise ValueError("weight must be positive")
        for ctx in job.contexts:
            sc = self._sc(ctx)
            sc.latency_us = latency_us
            if extratime_only:
                sc.extraweight = weight
                sc.weight = 0
                sc.slice_us = sc.slice_orig_us = 0
                sc.period_us = sc.period_orig_us = WEIGHT_PERIOD_US
                sc.extratime = True
            else:
                sc.weight = weight
                sc.extraweight = 0
        self._reweigh()

    def _reweigh(self, exclude=None) -> None:
        """sedf_adjust_weights (sched_sedf.c:1294-1365): explicit
        reservations are projected onto WEIGHT_PERIOD and carved out;
        weighted jobs split the remainder in weight proportion."""
        pairs = [(c, self._sc(c)) for j in self.partition.jobs
                 if j is not exclude for c in j.contexts]
        sumw = sum(sc.weight for _, sc in pairs if sc.weight)
        if not sumw:
            return
        sumt = sum(
            WEIGHT_PERIOD_US * sc.slice_orig_us // sc.period_orig_us
            for _, sc in pairs if not sc.weight)
        now = self.partition.clock.now_ns()
        free_us = max(0, WEIGHT_PERIOD_US - WEIGHT_SAFETY_US - sumt)
        for ctx, sc in pairs:
            if not sc.weight:
                continue
            sc.period_us = sc.period_orig_us = WEIGHT_PERIOD_US
            sc.slice_us = sc.slice_orig_us = sc.weight * free_us // sumw
            # Refresh deadlines only for contexts currently competing;
            # a blocked context keeps deadline 0 / stale so its wake
            # initializes the period there (same guard as
            # set_reservation — avoids short-block misclassification).
            if sc.deadline_ns <= now and ctx in self.contexts:
                sc.deadline_ns = now + sc.period_us * US
                sc.cputime_ns = 0

    # -- run-state transitions -------------------------------------------

    def sleep(self, ctx) -> None:
        if ctx not in self.contexts:
            return  # already asleep (e.g. retire path re-sleeps): no stat
        self.contexts.remove(ctx)
        sc = self._sc(ctx)
        sc.block_ns = self.partition.clock.now_ns()
        sc.block_tot += 1

    def wake(self, ctx) -> None:
        """sedf_wake (sched_sedf.c:1088-1180): classify the unblock."""
        if ctx in self.contexts:
            return
        sc = self._sc(ctx)
        now = self.partition.clock.now_ns()
        if sc.deadline_ns == 0:
            # First wake: first deadline after one slice's worth.
            sc.deadline_ns = now + max(sc.slice_us, 1) * US
        elif now < sc.period_begin_ns():
            # Woke in extra time, before its period begins: extra
            # queues only — handled by queue membership below.
            pass
        elif now < sc.deadline_ns:
            self._unblock_short(sc, now)
        else:
            self._unblock_long(sc, now)
        # Joining the slack competition: clamp virtual time to the
        # queue minimum so a newcomer neither monopolizes (vtime 0 vs
        # incumbents' accumulated hours) nor is starved by time it
        # never competed for.
        vt = [self._sc(c).util_vtime for c in self.contexts
              if self._sc(c).extratime]
        if vt:
            sc.util_vtime = max(sc.util_vtime, min(vt))
        self.contexts.append(ctx)

    def _unblock_short(self, sc: SedfCtx, now: int) -> None:
        """unblock_short_extra_support (sched_sedf.c:957-1010): no more
        realtime time this period; compensate via the penalty queue."""
        sc.short_block_tot += 1
        if sc.slice_us:
            sc.deadline_ns += sc.period_us * US
            pen = max(0, sc.slice_us * US - sc.cputime_ns)
            sc.short_block_lost_ns = pen
            # Compensation rides the slack: only tenants that opted
            # into extra time may claim it (EXTRA_AWARE gating —
            # keeps the set_reservation isolation contract exact).
            if pen and sc.extratime:
                sc.pen_extra_blocks += 1
                sc.want_pen_q = True
                # score = period<<10 / lost (sched_sedf.c:996-998):
                # small loss => high score => served later.
                sc.score_pen = (sc.period_us * US * 1024) / pen
            sc.cputime_ns = 0

    def _unblock_long(self, sc: SedfCtx, now: int) -> None:
        """unblock_long_cons_b (sched_sedf.c:1013-1020) + Atropos
        latency scaling (case 2c, sched_sedf.c:944-947)."""
        sc.long_block_tot += 1
        if sc.latency_us and sc.slice_us and \
                sc.latency_us < sc.period_orig_us:
            # Shrink the period to the latency hint; slice scales
            # proportionally. desched doubles both back toward orig.
            sc.period_us = max(sc.latency_us, PERIOD_MIN_US)
            sc.slice_us = max(
                sc.slice_orig_us * sc.period_us // sc.period_orig_us, 1)
        sc.deadline_ns = now + sc.period_us * US
        sc.cputime_ns = 0

    # -- queue maintenance ------------------------------------------------

    def _update_queues(self, now_ns: int) -> None:
        """update_queues (sched_sedf.c:469-546): deadline-miss repair
        with modulo catch-up and a fresh slice."""
        for ctx in self.contexts:
            sc = self._sc(ctx)
            if not sc.slice_us:
                continue
            missed = sc.deadline_ns < now_ns
            exhausted = sc.cputime_ns >= sc.slice_us * US
            if not (missed or exhausted):
                continue
            if missed:
                sc.deadline_misses += 1
                period_ns = sc.period_us * US
                sc.deadline_ns += period_ns
                if sc.deadline_ns < now_ns:  # still behind: modulo jump
                    behind = now_ns - sc.deadline_ns
                    sc.deadline_ns += (behind // period_ns + 1) * period_ns
                sc.cputime_ns = 0
            elif exhausted:
                self._finish_slice(sc)

    def _finish_slice(self, sc: SedfCtx) -> None:
        """Slice consumed: advance the period (desched_edf_dom,
        sched_sedf.c:405-446) and unwind latency/burst scaling."""
        sc.cputime_ns -= sc.slice_us * US
        if sc.period_us < sc.period_orig_us:
            sc.period_us = min(sc.period_us * 2, sc.period_orig_us)
            sc.slice_us = min(max(sc.slice_us * 2, 1), sc.slice_orig_us)
        sc.deadline_ns += sc.period_us * US

    # -- the hot path -----------------------------------------------------

    def _runnable_here(self, ex) -> list:
        return [c for c in self.contexts
                if c.runnable() and (c.executor_hint in (None, ex.index))]

    def do_schedule(self, ex, now_ns: int) -> Decision:
        self._update_queues(now_ns)
        mine = self._runnable_here(ex)
        if not mine:
            return Decision(None, 0)

        # EDF among reserved contexts whose period has begun and whose
        # slice has budget left (runq, sched_sedf.c:816-838).
        runq = [c for c in mine
                if (sc := self._sc(c)).slice_us > 0
                and sc.period_begin_ns() <= now_ns
                and sc.cputime_ns < sc.slice_us * US]
        waitq = [c for c in mine
                 if self._sc(c).slice_us > 0 and c not in runq]
        if runq:
            ctx = min(runq, key=lambda c: self._sc(c).deadline_ns)
            sc = self._sc(ctx)
            sc.run_type = RUN_EDF
            left = sc.slice_us * US - sc.cputime_ns
            if waitq:
                nxt = min(self._sc(c).period_begin_ns() for c in waitq)
                left = min(left, max(nxt - now_ns, US))
            # Honor the generic per-job quantum knob (adjust_job
            # tslice_us): the slice is consumed across several finer
            # dispatches so latency interleaving stays tunable.
            left = min(left, max(ctx.job.params.tslice_us * US, US))
            return Decision(ctx, max(int(left), US))

        # Slack until the next reserved period begins.
        end_xt = (min(self._sc(c).period_begin_ns() for c in waitq)
                  if waitq else now_ns + WEIGHT_PERIOD_US * US)
        horizon = end_xt - now_ns
        if horizon >= EXTRA_QUANTUM_NS:
            d = self._extra_schedule(mine, horizon)
            if d is not None:
                return d

        # Reserved jobs exist but none can run: idle until the earliest
        # period begin (run loop's timer jump covers the wait).
        if waitq:
            self.partition.timers.arm(
                end_xt, lambda now: None, name="sedf_replenish")
        return Decision(None, 0)

    def _extra_schedule(self, mine: list, horizon: int) -> Decision | None:
        """sedf_do_extra_schedule (sched_sedf.c:667-723): L0 penalty
        queue first (lowest score), else L1 utilization weighted-RR."""
        quantum = min(EXTRA_QUANTUM_NS, horizon)
        pen = [c for c in mine if self._sc(c).want_pen_q]
        if pen:
            ctx = min(pen, key=lambda c: self._sc(c).score_pen)
            sc = self._sc(ctx)
            sc.run_type = RUN_PEN
            sc.pen_extra_slices += 1
            return Decision(ctx, quantum)
        util = [c for c in mine if self._sc(c).extratime]
        if util:
            # Weighted RR: each run advances the job's virtual time by
            # its score (inverse weight); lowest virtual time runs next
            # — long-run extra time ∝ extraweight (sched_sedf.c:615-631).
            ctx = min(util, key=lambda c: (self._sc(c).util_vtime,
                                           self._sc(c).score_util))
            self._sc(ctx).run_type = RUN_UTIL
            return Decision(ctx, quantum)
        return None

    def descheduled(self, ex, ctx, ran_ns: int, now_ns: int) -> None:
        sc = self._sc(ctx)
        if sc.run_type == RUN_EDF:
            sc.cputime_ns += ran_ns
            if sc.cputime_ns >= sc.slice_us * US:
                self._finish_slice(sc)
            return
        # Extra-time bookkeeping (desched_extra_dom, sched_sedf.c:561-665).
        sc.extra_time_tot_ns += ran_ns
        if sc.run_type == RUN_PEN:
            sc.short_block_lost_ns -= ran_ns
            if sc.short_block_lost_ns <= 0:
                # Penalty repaid: off the L0 queue.
                sc.short_block_lost_ns = 0
                sc.want_pen_q = False
            else:
                sc.score_pen = (sc.period_us * US * 1024) / \
                    sc.short_block_lost_ns
        else:
            sc.score_util = self._util_score(sc)
            sc.util_vtime += sc.score_util * (ran_ns / EXTRA_QUANTUM_NS)
        sc.run_type = RUN_EDF

    @staticmethod
    def _util_score(sc: SedfCtx) -> float:
        # sched_sedf.c:618-631: inverse utilization, or inverse
        # extraweight for pure best-effort (128 extraweight == 100%).
        if sc.extraweight:
            return (1 << 17) / sc.extraweight
        if sc.slice_us:
            return (sc.period_us * 1024) / sc.slice_us
        return float(1 << 17)

    # -- observability ----------------------------------------------------

    def dump_settings(self) -> dict:
        return {"name": self.name,
                "weight_period_us": WEIGHT_PERIOD_US,
                "extra_quantum_us": EXTRA_QUANTUM_NS // US}

    def dump_executor(self, ex) -> dict:
        out = []
        # All admitted contexts, not just currently-queued ones: DONE
        # and blocked tenants keep their stats visible (sedf_dump_domain
        # walks every domain, sched_sedf.c:1183-1214).
        for c in (c for j in self.partition.jobs for c in j.contexts):
            sc = self._sc(c)
            out.append({
                "ctx": c.name,
                "period_us": sc.period_us,
                "slice_us": sc.slice_us,
                "weight": sc.weight,
                "extraweight": sc.extraweight,
                "cputime_us": sc.cputime_ns // US,
                "deadline_ns": sc.deadline_ns,
                "deadline_misses": sc.deadline_misses,
                "extra_time_ms": sc.extra_time_tot_ns // MS,
                "blocks": {"total": sc.block_tot,
                           "short": sc.short_block_tot,
                           "long": sc.long_block_tot,
                           "pen_blocks": sc.pen_extra_blocks,
                           "pen_slices": sc.pen_extra_slices},
            })
        return {"contexts": out}
