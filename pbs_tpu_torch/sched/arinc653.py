"""ARINC653 scheduler: static cyclic major-frame schedule.

The port of ``pbs_tpu.sched.arinc653``, decision for decision.

Semantic port of Xen's ARINC653 scheduler
(``xen-4.2.1/xen/common/sched_arinc653.c``, 697 LoC): a fixed *major
frame* is divided into minor-frame windows, each granting one job an
exclusive window; the cycle repeats verbatim — hard temporal isolation
with zero cross-tenant interference (the avionics-partitioning model;
useful on a shared accelerator for strict-SLO tenants).

Faithful semantics beyond the happy path:

- **Schedule changes land at the major-frame boundary**, never
  mid-frame (``arin653_sched_set`` stores the new table; the running
  frame completes under the old one). ``set_schedule`` validates every
  named job against the partition, mirroring the reference's
  domain-handle validation at set time.
- **Default schedule**: until an explicit table is set, every admitted
  job gets one equal default window (the reference boots with a
  single-entry schedule for dom0 and grows per domain).
- **Overrun containment** — the accelerator-specific part: a step
  cannot be preempted, so a job whose step outruns its window eats
  into foreign time. The overrun is tracked per job and *debited from
  its own next windows* (the window runs idle, or shortened, until the
  debt is repaid), so long-run time shares converge to the table even
  with ill-fitting steps. The reference needs no such mechanism —
  hardware timers preempt at the window edge.
"""

from __future__ import annotations

import dataclasses

from pbs_tpu_torch import knobs
from pbs_tpu_torch.sched.base import Decision, Scheduler, register_scheduler
from pbs_tpu_torch.utils.clock import US

DEFAULT_WINDOW_US = knobs.default("sched.arinc653.default_window_us")


@dataclasses.dataclass
class SlotStats:
    dispatches: int = 0
    idle: int = 0  # slot visits with no runnable owner (or debt)


@register_scheduler
class Arinc653Scheduler(Scheduler):
    name = "arinc653"

    def __init__(self, partition, schedule=None):
        super().__init__(partition)
        # [(job_name|None, duration_us)]
        self.schedule: list[tuple[str | None, int]] = []
        self.pending: list[tuple[str | None, int]] | None = None
        self.frame_start_ns: int | None = None
        self.frame_count = 0
        self.explicit = False  # an operator table replaced the default
        self.overrun_ns: dict[str, int] = {}
        self.slot_stats: dict[int, SlotStats] = {}
        self._granted: dict[str, int] = {}  # ctx.name -> granted ns
        # (frame, slot) windows that already repaid debt this frame —
        # multiple do_schedule calls inside one window (multi-executor,
        # or a real clock polling) must not repay the debt repeatedly.
        self._repaid: set[tuple[int, int]] = set()
        if schedule:
            # Constructed before any job is admitted: defer name checks.
            self.set_schedule(schedule, require_jobs=False)

    # -- table management ---------------------------------------------------

    def _validate(self, entries,
                  require_jobs: bool = True) -> list[tuple[str | None, int]]:
        if not entries:
            raise ValueError("schedule must have at least one entry")
        known = {j.name for j in self.partition.jobs}
        for name, dur in entries:
            if dur <= 0:
                raise ValueError(
                    f"schedule entry {name!r} needs a positive duration")
            if require_jobs and name is not None and name not in known:
                raise ValueError(
                    f"schedule names unknown job {name!r} (admitted: "
                    f"{sorted(known)})")
        return list(entries)

    def set_schedule(self, entries: list[tuple[str | None, int]],
                     require_jobs: bool = True) -> None:
        """arin653_sched_set analog: validate now, apply at the next
        major-frame boundary (the running frame completes first).
        ``require_jobs=False`` (the constructor path, where no job is
        admitted yet) skips name validation — windows naming absent
        jobs simply idle until the job arrives."""
        entries = self._validate(entries, require_jobs)
        self.explicit = True
        if self.frame_start_ns is None or not self.schedule:
            self.schedule = entries
            self.slot_stats = {i: SlotStats() for i in range(len(entries))}
            self._repaid.clear()
        else:
            self.pending = entries

    def adjust_global(self, **params) -> None:
        """CLI surface: ``schedule=[(job, us), ...]``."""
        sched = params.pop("schedule", None)
        if params:
            raise KeyError(f"unknown arinc653 knobs {sorted(params)}")
        if sched is None:
            raise KeyError("arinc653 adjust_global needs schedule=[...]")
        self.set_schedule(sched)

    def major_frame_us(self) -> int:
        return sum(d for _, d in self.schedule)

    def _default_schedule(self) -> None:
        """One equal window per admitted job (boot-time default)."""
        entries = [(j.name, DEFAULT_WINDOW_US)
                   for j in self.partition.jobs] or []
        self.schedule = entries
        self.slot_stats = {i: SlotStats() for i in range(len(entries))}
        self.frame_start_ns = None
        # The frame epoch restarts: stale (frame, slot) keys would
        # alias the new epoch's windows and block their repayment.
        self._repaid.clear()

    def job_added(self, job) -> None:
        self.overrun_ns.setdefault(job.name, 0)
        if not self.explicit:
            self._default_schedule()

    def job_removed(self, job) -> None:
        self.overrun_ns.pop(job.name, None)
        if self.explicit:
            # A removed job's windows become idle gaps; the table itself
            # is the operator's to change.
            self.schedule = [
                (None if n == job.name else n, d) for n, d in self.schedule
            ]
            if self.pending:
                self.pending = [
                    (None if n == job.name else n, d)
                    for n, d in self.pending
                ]
        else:
            self._default_schedule()

    def wake(self, ctx) -> None:
        pass  # dispatch is purely table-driven

    # -- dispatch -----------------------------------------------------------

    def _slot_at(self, now_ns: int) -> tuple[int, str | None, int]:
        """(slot_index, job_name, remaining_ns) covering ``now``;
        rolls frames forward and applies a pending table at the
        boundary."""
        frame_ns = self.major_frame_us() * US
        if self.frame_start_ns is None:
            self.frame_start_ns = now_ns
        while now_ns - self.frame_start_ns >= frame_ns:
            self.frame_start_ns += frame_ns
            self.frame_count += 1
            self._repaid.clear()  # old-frame window keys cannot recur
            if self.pending is not None:
                self.schedule = self.pending
                self.pending = None
                self.slot_stats = {
                    i: SlotStats() for i in range(len(self.schedule))
                }
                frame_ns = self.major_frame_us() * US
        off = now_ns - self.frame_start_ns
        acc = 0
        for i, (name, dur) in enumerate(self.schedule):
            nxt = acc + dur * US
            if off < nxt:
                return i, name, nxt - off
            acc = nxt
        return -1, None, 0  # unreachable

    def do_schedule(self, ex, now_ns: int) -> Decision:
        if not self.schedule:
            return Decision(None, 0)
        slot, name, remaining_ns = self._slot_at(now_ns)
        stats = self.slot_stats.setdefault(slot, SlotStats())
        window_key = (self.frame_count, slot)
        if name is not None:
            if window_key in self._repaid:
                # This window already took the repayment path: it stays
                # idle for its remainder — a later poll must not turn a
                # repaid window into a dispatch (that would both run
                # the debtor and forgive its residual debt).
                stats.idle += 1
                self._arm(now_ns + remaining_ns)
                return Decision(None, 0)
            debt = self.overrun_ns.get(name, 0)
            if debt >= remaining_ns:
                # Whole window consumed repaying a previous overrun:
                # idle it and shrink the debt (temporal isolation —
                # the overrun never costs the *other* tenants' windows).
                # At most one repayment per window, whatever the call
                # cadence.
                if window_key not in self._repaid:
                    self._repaid.add(window_key)
                    self.overrun_ns[name] = debt - remaining_ns
                stats.idle += 1
                self._arm(now_ns + remaining_ns)
                return Decision(None, 0)
            grant = remaining_ns - debt
            try:
                job = self.partition.job(name)
            except KeyError:
                job = None
            if job is not None:
                for ctx in job.contexts:
                    if ctx.runnable() and ctx.executor_hint in (
                            None, ex.index):
                        # The debt is settled only on a real dispatch —
                        # a blocked job or hint mismatch must not have
                        # its debt forgiven.
                        if debt:
                            self.overrun_ns[name] = 0
                        stats.dispatches += 1
                        self._granted[ctx.name] = grant
                        return Decision(ctx, grant)
        # Idle slot (or absent/blocked job): wake at the next window.
        stats.idle += 1
        self._arm(now_ns + remaining_ns)
        return Decision(None, 0)

    def _arm(self, deadline_ns: int) -> None:
        self.partition.timers.arm(
            deadline_ns, lambda now: None, name="a653_slot")

    def descheduled(self, ex, ctx, ran_ns: int, now_ns: int) -> None:
        granted = self._granted.pop(ctx.name, None)
        if granted is not None and ran_ns > granted:
            # The step outran its window (no preemption on the device): debit
            # this job's future windows by the spill.
            self.overrun_ns[ctx.job.name] = (
                self.overrun_ns.get(ctx.job.name, 0) + ran_ns - granted)

    # -- observability -------------------------------------------------------

    def dump_settings(self) -> dict:
        return {
            "name": self.name,
            "major_frame_us": self.major_frame_us(),
            "frames": self.frame_count,
            "slots": [
                {
                    "job": n or "<idle>",
                    "duration_us": d,
                    "dispatches": self.slot_stats.get(
                        i, SlotStats()).dispatches,
                    "idle": self.slot_stats.get(i, SlotStats()).idle,
                }
                for i, (n, d) in enumerate(self.schedule)
            ],
            "pending": (
                [{"job": n or "<idle>", "duration_us": d}
                 for n, d in self.pending]
                if self.pending is not None else None
            ),
            "overrun_ns": dict(self.overrun_ns),
        }

    def dump_executor(self, ex) -> dict:
        return {"frame_count": self.frame_count}
