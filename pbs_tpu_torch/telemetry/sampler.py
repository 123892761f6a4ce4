"""i-mode counter sampling: thresholds, overflow events, rearm.

Reference flow (the interrupt-mode perfctr path): a PMU counter armed
with a threshold overflows -> LAPIC vector -> ``pmu_ihandler`` ->
``send_guest_vcpu_virq(current, VIRQ_PERFCTR)``
(``xen-4.2.1/xen/arch/x86/pmustate.c:66-80``) -> guest evtchn upcall ->
``vperfctr_ihandler`` delivers signal ``SI_PMC_OVF`` to the user and the
counter stays *suspended* until the user rearms with ``VPERFCTR_IRESUME``
(``linux-3.2.30/drivers/perfctr/virtual.c:348-420``, the
``PERFCTROP_ISUSPEND`` pairing).

TPU re-expression: there is no counter interrupt — telemetry counters
advance at quantum boundaries when the executor folds the quantum's
deltas into the context (``runtime/executor.py``). So "overflow" is a
threshold crossing detected at deschedule time; delivery is
``Virq.TELEMETRY`` on the partition's EventBus (dispatched between
quanta by the run loop, like the evtchn upcall); and the
suspend-until-rearm contract is kept literally: a fired sample is
disarmed and will not fire again — no matter how far the counter runs
past the threshold — until the consumer calls :meth:`rearm`, which sets
the next threshold ``period`` past the *current* value.

Event payloads don't fit an edge-triggered doorbell (the virq is just
"something fired", like the pending bit), so the sampler keeps a
drainable event queue — the ``siginfo`` analog.

The port's copy of ``pbs_tpu.telemetry.sampler``: the same arming,
crossing and rearm rules. The reference also stages each crossing into
a trace ring (``bind_trace``); the port has no trace rings yet
(ROADMAP), so that channel is not here.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import TYPE_CHECKING

from pbs_tpu_torch.runtime.events import EventBus, Virq
from pbs_tpu_torch.telemetry.counters import Counter

if TYPE_CHECKING:
    from pbs_tpu_torch.runtime.job import ExecutionContext


@dataclasses.dataclass(frozen=True)
class OverflowEvent:
    """One threshold crossing (the SI_PMC_OVF siginfo analog)."""

    sample_id: int
    job: str
    ctx: str
    counter: Counter
    threshold: int
    value: int  # counter value observed at the crossing quantum
    seq: int  # per-sample firing sequence number


class _Sample:
    __slots__ = ("sample_id", "ctx", "counter", "period", "threshold",
                 "armed", "fired")

    def __init__(self, sample_id: int, ctx: "ExecutionContext",
                 counter: Counter, period: int, threshold: int):
        self.sample_id = sample_id
        self.ctx = ctx
        self.counter = counter
        self.period = period
        self.threshold = threshold
        self.armed = True
        self.fired = 0


class OverflowSampler:
    """Per-partition registry of armed counter thresholds.

    Hot-path shape: :meth:`check` runs at every quantum boundary, so
    samples are indexed per context — a partition with hundreds of
    armed samples costs each deschedule only the samples armed on the
    descheduled context, not a full-registry scan.
    """

    def __init__(self, events: EventBus):
        self._events = events
        self._samples: dict[int, _Sample] = {}
        # id(ctx) -> {sample_id: _Sample}. Keyed by identity (contexts
        # are not hashable by value); safe because every _Sample holds a
        # strong ref to its ctx, so a key can never be recycled while
        # its group is non-empty, and empty groups are deleted.
        self._by_ctx: dict[int, dict[int, _Sample]] = {}
        self._ids = itertools.count(1)
        self._queue: list[OverflowEvent] = []

    # -- arming (VPERFCTR_CONTROL with si_signo set) ---------------------

    def arm(self, ctx: "ExecutionContext", counter: Counter,
            period: int, threshold: int | None = None) -> int:
        """Arm a sample on ``ctx``'s ``counter``; fires once when the
        counter reaches ``threshold`` (default: current value +
        ``period``). Returns the sample id used for rearm/disarm."""
        if period <= 0 and threshold is None:
            raise ValueError("period must be > 0 (or give a threshold)")
        if threshold is None:
            threshold = int(ctx.counters[counter]) + period
        sid = next(self._ids)
        s = _Sample(sid, ctx, counter, period, threshold)
        self._samples[sid] = s
        self._by_ctx.setdefault(id(ctx), {})[sid] = s
        return sid

    def _unindex(self, s: _Sample) -> None:
        group = self._by_ctx.get(id(s.ctx))
        if group is not None:
            group.pop(s.sample_id, None)
            if not group:
                del self._by_ctx[id(s.ctx)]

    def disarm(self, sample_id: int) -> None:
        s = self._samples.pop(sample_id, None)
        if s is not None:
            self._unindex(s)

    def disarm_job(self, job) -> int:
        """Drop every sample on the job's contexts (called at job
        removal so dead samples don't pin contexts or get scanned
        forever). Returns the number dropped."""
        doomed = [sid for sid, s in self._samples.items()
                  if s.ctx.job is job]
        for sid in doomed:
            self._unindex(self._samples.pop(sid))
        return len(doomed)

    def rearm(self, sample_id: int, period: int | None = None) -> None:
        """IRESUME analog: re-enable a fired sample, next threshold
        ``period`` past the counter's *current* value (overshoot during
        the suspended interval is not retro-delivered, matching the
        reference's suspended-counter semantics)."""
        s = self._samples.get(sample_id)
        if s is None:
            raise KeyError(f"unknown sample {sample_id}")
        if period is not None:
            if period <= 0:
                raise ValueError("period must be > 0")
            s.period = period
        if s.period <= 0:
            # Armed with an explicit threshold and no period: rearming
            # with "current + 0" would fire on every quantum.
            raise ValueError(
                "sample was armed with an explicit threshold; rearm "
                "needs a positive period")
        s.threshold = int(s.ctx.counters[s.counter]) + s.period
        s.armed = True

    # -- overflow check (pmu_ihandler analog, called between quanta) -----

    def check(self, ctx: "ExecutionContext") -> int:
        """Test every armed sample on ``ctx`` after a quantum folded new
        deltas in. Each crossing queues one event, disarms the sample,
        and raises ``Virq.TELEMETRY``. Returns events queued."""
        group = self._by_ctx.get(id(ctx))
        if not group:
            return 0
        n = 0
        for s in group.values():
            if not s.armed:
                continue
            value = int(ctx.counters[s.counter])
            if value >= s.threshold:
                s.armed = False  # suspended until rearm
                s.fired += 1
                self._queue.append(OverflowEvent(
                    sample_id=s.sample_id,
                    job=ctx.job.name,
                    ctx=ctx.name,
                    counter=s.counter,
                    threshold=s.threshold,
                    value=value,
                    seq=s.fired,
                ))
                n += 1
        if n:
            self._events.send_virq(Virq.TELEMETRY)
        return n

    # -- consumption -----------------------------------------------------

    def drain(self) -> list[OverflowEvent]:
        """Take all queued events (the signal-handler read)."""
        out, self._queue = self._queue, []
        return out

    def pending(self) -> int:
        return len(self._queue)

    def dump(self) -> list[dict]:
        return [
            {
                "sample": s.sample_id,
                "ctx": s.ctx.name,
                "counter": s.counter.name,
                "period": s.period,
                "threshold": s.threshold,
                "armed": s.armed,
                "fired": s.fired,
            }
            for s in self._samples.values()
        ]
