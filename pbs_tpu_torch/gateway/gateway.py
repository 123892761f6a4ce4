"""The multi-tenant serving front door (``pbs_tpu_torch.gateway``).

A copy of ``pbs_tpu.gateway.gateway``: the same pump, in the same
decision order, with the same trace records, spans, histograms, class
ledger and write-ahead journal intents, so a seeded run gives the same
results, words and bytes in both packages
(``tests/test_torch_gateway.py``, ``tests/test_torch_journal.py``).

PBS-T's loop is guest-reported contention latency steering the
scheduler's quantum. One layer up, the serving-tier analog of spin
latency is *request queue delay*: time an admitted request waits at
the gateway before a backend takes it. This module closes the same
loop at that layer — requests flow

    submit → admission (token bucket, backpressure, explicit shed)
           → fair queue (weighted DRR across tenants, SLO classes)
           → routing   (least-loaded live backend; breaker-aware via
                        an attached Controller's health view)
           → completion (latency accounting, telemetry ledger, GW_*
                        trace events)

and sustained interactive queue delay feeds ``sched/feedback.py`` as a
BOOST/tslice-shrink signal (the vcrd_op analog) through a pluggable
``feedback_sink``. The invariant the chaos harness gates on: once
admitted, a request is COMPLETED or REQUEUED — backend loss drains its
uncompleted requests back to the front of the fair queue; nothing is
ever silently dropped (sheds are explicit, with retry-after, and only
happen at admission).

Single-threaded by construction: callers own the pump (``tick``); all
state mutation happens on the caller's thread, so the whole gateway is
lock-free the honest way — there is nothing to lock.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
from collections import deque
from typing import Any, Callable

import numpy as np

from pbs_tpu_torch import knobs
from pbs_tpu_torch.faults import injector as _faults
from pbs_tpu_torch.gateway.admission import (
    INTERACTIVE,
    SLO_CLASSES,
    AdmissionController,
    Shed,
    TenantQuota,
)
from pbs_tpu_torch.gateway.backends import Backend
from pbs_tpu_torch.gateway.fairqueue import (
    DEFAULT_QUANTUM as DEFAULT_DRR_QUANTUM,
    DeficitRoundRobin,
    Request,
)
from pbs_tpu_torch.gateway import journal as _jr
from pbs_tpu_torch.obs.spans import HistBatch, LatencyHistograms, SpanRecorder
from pbs_tpu_torch.obs.trace import EmitBatch, Ev, TraceBuffer
from pbs_tpu_torch.telemetry.counters import NUM_COUNTERS, Counter
from pbs_tpu_torch.telemetry.ledger import Ledger
from pbs_tpu_torch.utils.clock import MS, MonotonicClock

#: Ledger counter reuse for the per-class gateway slots (the ledger
#: layout is the fixed 18-counter page; the gateway maps its stats onto
#: the semantically closest counters — documented in docs/GATEWAY.md):
#:   RUNQ_WAIT_NS   cumulative queue delay of dispatched requests
#:   DEVICE_TIME_NS cumulative backend service time
#:   STEPS_RETIRED  requests completed
#:   SCHED_COUNT    dispatches (>= completions; includes re-dispatches)
#:   YIELDS         requeues after backend loss
#:   COMPILES       sheds (explicit rejections)
#:   TOKENS         cost units completed
GW_LEDGER_SLOTS = {cls: i for i, cls in enumerate(SLO_CLASSES)}

#: Queue-delay feedback export cadence (knob registry,
#: gateway.gateway.feedback_period_ns).
DEFAULT_FEEDBACK_PERIOD_NS = knobs.default(
    "gateway.gateway.feedback_period_ns")


@dataclasses.dataclass(frozen=True)
class SubmitResult:
    admitted: bool
    rid: str | None = None
    reason: str = ""
    retry_after_ns: int = 0


class Gateway:
    """The front door. See module docstring for the pipeline."""

    def __init__(
        self,
        backends: list[Backend],
        quotas: dict[str, TenantQuota] | None = None,
        clock=None,
        max_inflight: int | None = None,
        max_queued: int = 256,
        default_quota: TenantQuota | None = None,
        controller=None,
        trace_capacity: int = 0,
        ledger_path: str | None = None,
        feedback_sink: Callable[[str, int, int], None] | None = None,
        feedback_period_ns: int = DEFAULT_FEEDBACK_PERIOD_NS,
        drr_quantum: int = DEFAULT_DRR_QUANTUM,
        name: str = "gw",
        spans: SpanRecorder | None = None,
        hist_slots: int = 256,
        journal=None,
        hw_source=None,
    ):
        if not backends:
            raise ValueError("gateway needs at least one backend")
        names = [b.name for b in backends]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate backend names: {names}")
        #: Identity within a federation (gateway/federation.py); also
        #: the request-id prefix, so rids stay unique across members.
        self.name = str(name)
        self.backends = list(backends)
        self.clock = clock or MonotonicClock()
        now = self.clock.now_ns()
        self.admission = AdmissionController(
            max_queued_total=max_queued, default_quota=default_quota)
        self.queue = DeficitRoundRobin(quantum=drr_quantum)
        #: Shadow-trace capture seam (pbs_tpu/autopilot/recorder.py):
        #: when attached, every arrival (admitted OR shed — the
        #: workload is arrivals, admission is the policy under test)
        #: is recorded before any fault consult. None = zero cost.
        #: Initialized before tenant registration: register_tenant
        #: describes each tenant contract to an attached recorder.
        self.shadow = None
        #: Live hardware-counter plane (the reference's hwtelem; any
        #: object with ``sample``/``describe``/``clock``): when
        #: attached, each ``tick()`` samples it —
        #: observer-only, like the shadow recorder: the sample touches
        #: no admission/dispatch decision and no RNG, so arming it
        #: moves no digest. None = zero cost.
        self.hw = None
        self.hw_recorder = None
        self._hw_totals: dict[str, int] = {}
        #: Write-ahead intent journal (gateway/journal.py,
        #: docs/DURABILITY.md): when attached, every ADMIT/DISPATCH/
        #: COMPLETE/SHED/REQUEUE intent is journaled BEFORE the
        #: in-memory state machine moves, and ``tick()`` group-commits
        #: the round's intents as one frame. None = zero cost. Set
        #: before tenant registration: register_tenant journals each
        #: contract.
        self._journal = None
        self.journal_autocommit = True
        #: Recovery epoch of this gateway's rid namespace: 0 = the
        #: plain pre-crash form (rids byte-identical to un-journaled
        #: gateways); recovery bumps it so new rids can never collide
        #: with an UNACKED pre-crash rid (gateway/recovery.py).
        self.rid_generation = 0
        for tenant, q in (quotas or {}).items():
            self.register_tenant(tenant, q, now_ns=now)
        #: Global concurrency bound across backends; default: the sum
        #: of backend capacities (each backend also bounds itself).
        self.max_inflight = (int(max_inflight) if max_inflight is not None
                             else sum(b.capacity for b in self.backends))
        #: Controller whose breaker/liveness view vetoes routing
        #: targets whose names match cluster agents (dist/controller).
        self.controller = controller
        self.trace = (TraceBuffer(trace_capacity)
                      if trace_capacity else None)
        # Staged GW_* events: the pump is single-threaded (module
        # docstring), so a tick's worth of admits/dispatches/completes
        # is one vectorized ring write, flushed at tick end and before
        # any external read (stats).
        self._trace_batch = (EmitBatch(self.trace, capacity=128)
                             if self.trace is not None else None)
        self._ledger = None
        self._ledger_path = ledger_path
        if ledger_path is not None:
            self._ledger = Ledger.file_backed(
                ledger_path, num_slots=len(SLO_CLASSES))
            # file_backed attaches to an existing file as-is; a fresh
            # gateway must not accumulate onto a previous run's counts.
            for slot in GW_LEDGER_SLOTS.values():
                self._ledger.reset(slot)
            self._write_ledger_meta()
        #: Allocation-free log2 latency histograms per (tenant, class,
        #: stage) + per-backend service rows, living in ledger slots —
        #: file-backed next to the class ledger so `pbst gateway stats`
        #: and `pbst slo report` attach like any monitor
        #: (docs/TRACING.md). Always on: stats()/feedback read these.
        self.hist = LatencyHistograms(
            num_slots=hist_slots,
            path=(ledger_path + ".hist") if ledger_path else None)
        # The batched pump: a tick's histogram samples stage here and
        # land as ONE record_many flush — flushed before _feedback
        # reads the quantiles and before stats(), so readers see
        # exactly what per-request scalar records showed.
        self._hist_batch = HistBatch(self.hist)
        # Per-tick ledger staging: one add_many per touched class per
        # tick instead of a seqlock write per request event. Sheds
        # (submit-time, outside the pump) keep the direct scalar add.
        self._ld_acc = {cls: np.zeros(NUM_COUNTERS, dtype="<u8")
                        for cls in SLO_CLASSES}
        self._ld_dirty: set[str] = set()
        #: Request-span recorder (docs/TRACING.md): injected by a
        #: federation (shared across members so chains stitch), or
        #: derived from this gateway's own trace ring when tracing is
        #: on — span records ride the same EmitBatch as the GW_* class.
        self.spans: SpanRecorder | None = None
        if spans is not None:
            self.attach_spans(spans)
        elif self.trace is not None:
            self.attach_spans(SpanRecorder(ring=self.trace,
                                           batch=self._trace_batch))
        #: Member-level knob adoption: what this gateway adopted from
        #: per-member (canary-scoped) pushes, and the switch-overhead
        #: constant of the serving profile model (0 = model off; a
        #: canary harness arms it).
        self.applied_knobs: dict[str, int | float] = {}
        self.profile_switch_cost_ns = 0
        self.feedback_sink = feedback_sink
        self.feedback_period_ns = int(feedback_period_ns)
        self._last_feedback_ns = now
        # Feedback accumulators since the last feedback tick.
        self._fb_delay_ns = {cls: 0 for cls in SLO_CLASSES}
        self._fb_events = {cls: 0 for cls in SLO_CLASSES}
        if journal is not None:
            self.attach_journal(journal)
        if hw_source is not None:
            self.attach_hw(hw_source)
        # Bookkeeping.
        self._rids = itertools.count()
        self._tenant_slot: dict[str, int] = {}  # stable ints for trace
        self.inflight: dict[str, Request] = {}
        self.admitted = 0
        self.completed = 0
        self.requeued = 0
        self.dispatched = 0
        self.adopted = 0  # requests admitted at ANOTHER federated member
        #: Raw queue-delay window; the feedback watermark tests sum it
        #: (latency percentiles come from the histograms, not a deque).
        self._delays = {cls: deque(maxlen=1024) for cls in SLO_CLASSES}
        self.completions: deque = deque(maxlen=4096)  # (rid, info)

    # -- journal (docs/DURABILITY.md) ------------------------------------

    def attach_journal(self, journal, autocommit: bool = True) -> None:
        """Arm the write-ahead intent journal: subsequent admission,
        dispatch, completion, shed, and requeue decisions are staged
        as journal intents BEFORE the in-memory move, and (when
        ``autocommit``) each ``tick()`` seals them as one group-commit
        frame. A federation passes ``autocommit=False`` and commits
        once per federation round for all members.

        The gateway journals its own identity image on attach — a
        MEMBER add plus a TENANT record per registered contract — so
        replay always starts from a complete topology whether the
        journal was armed at construction or mid-run (replay treats
        re-registration as idempotent)."""
        self._journal = journal
        self.journal_autocommit = bool(autocommit)
        now = self.clock.now_ns()
        journal.member_event(now, self.name, "add")
        for tenant, quota in sorted(self.admission.quotas.items()):
            journal.tenant(now, tenant, quota)

    # -- spans (docs/TRACING.md) -----------------------------------------

    def attach_spans(self, recorder: SpanRecorder) -> None:
        """Install the span recorder and wire the backend execution
        hooks. A federation calls this on every member with ONE shared
        recorder, so a request handed off between members keeps one
        stitched chain in one ring."""
        self.spans = recorder
        for b in self.backends:
            b.exec_hook = self._span_exec
            b.handoff_hook = self._span_handoff

    def _span_exec(self, req: Request, now_ns: int) -> None:
        if self.spans is not None:
            self.spans.exec(now_ns, req.rid,
                            self._backend_slot(req.backend), self.name)

    def _span_handoff(self, req: Request, now_ns: int,
                      from_member: str, to_member: str) -> None:
        """Intra-backend pool handoff (docs/SERVING.md): the HANDOFF
        re-queues the span state machine, so an internal re-DISPATCH
        follows immediately — the same stitch a federation's
        cross-member handoff emits, with pool names as members."""
        if self.spans is not None:
            self.spans.handoff(now_ns, req.rid, from_member, to_member)
            self.spans.dispatch(now_ns, req.rid,
                                self._backend_slot(req.backend),
                                0, 0, self.name)

    # -- shadow capture (pbs_tpu/autopilot, docs/AUTOPILOT.md) -----------

    def attach_shadow(self, recorder) -> None:
        """Install a shadow-trace recorder: every subsequent arrival is
        captured (time, tenant, class, cost) into its bounded ring, and
        the tenants registered so far are described to it so a captured
        window is replayable stand-alone."""
        self.shadow = recorder
        for tenant, quota in sorted(self.admission.quotas.items()):
            recorder.note_tenant(tenant, quota)

    # -- hardware-counter plane (docs/HWTELEM.md) ------------------------

    def attach_hw(self, source, recorder=None) -> None:
        """Arm the live hardware-counter plane: each subsequent
        ``tick()`` samples ``source`` (an ``hwtelem.HwCounterSource``)
        and accumulates per-event totals for ``stats()``; with a
        ``recorder`` (``hwtelem.HwRecorder``) every sample also lands
        in its bounded ring for window capture. Observer-only — the
        pump's decisions never read the sample, so arming this on a
        virtual-time run leaves every digest byte-identical. The
        ledger meta sidecar is rewritten so ``pbst gateway stats``
        names the active tier instead of passing sim numbers off as
        live."""
        self.hw = source
        self.hw_recorder = recorder
        self._hw_totals = {}
        source.sample()  # prime the delta baseline at attach
        if self._ledger_path is not None:
            self._write_ledger_meta()

    def _hw_sample(self) -> None:
        if self.hw is None:
            return
        deltas = self.hw.sample()
        for ev, v in deltas.items():
            if v:
                self._hw_totals[ev] = self._hw_totals.get(ev, 0) + int(v)
        if self.hw_recorder is not None:
            self.hw_recorder.sample(self.hw.clock.now_ns(), deltas)

    # -- member knob adoption (the canary path) ---------------------------

    def apply_member_knobs(self, changed: dict, values: dict) -> list:
        """Adopt the member-relevant slice of a knob push delivered by
        this member's own :class:`~pbs_tpu_torch.knobs.channel.KnobWatcher`
        (the federation creates one per member, keyed on the member
        name, so canary-scoped pushes reach exactly the canary set).

        Only the scheduler-profile knobs (the tuned-profile space a
        canary rolls out — derived from ``knobs.profile
        .PARAM_KNOBS``, the declared authority, so a new tunable
        policy family is adoptable the day its mapping lands) adopt
        here; federation-level knobs like the admission rate scale
        stay with the federation's global watcher. When the
        profile model is armed (``profile_switch_cost_ns > 0``), the
        adopted band re-rates every backend exposing
        ``set_service_scale`` by the declared first-order overhead
        ``1 + switch_cost / band_cap`` — short slices buy latency
        multiplexing at a context-switch cost, the paper's core
        trade-off applied at serving granularity. Returns the adopted
        knob names (empty = nothing member-relevant changed)."""
        from pbs_tpu_torch.knobs.profile import PARAM_KNOBS

        adoptable = {knob_name for mapping in PARAM_KNOBS.values()
                     for knob_name in mapping.values()}
        adopted = sorted(k for k in changed if k in adoptable)
        if not adopted:
            return []
        self.applied_knobs.update({k: changed[k] for k in adopted})
        if self.profile_switch_cost_ns > 0:
            # The binding band cap comes from the policy FAMILY the
            # push steered (an atc canary pushes sched.atc.* — reading
            # the untouched feedback cap would let a collapsed atc
            # band sail through the guard unfelt). Both families in
            # one push: the tighter cap binds.
            fams = {k.rsplit(".", 1)[0] for k in adopted}
            caps = [
                float(values.get(f"{fam}.tslice_max_us",
                                 knobs.default(f"{fam}.tslice_max_us")))
                for fam in sorted(fams)
            ]
            cap_us = min(caps)
            scale = 1.0 + (self.profile_switch_cost_ns
                           / max(1.0, cap_us * 1000.0))
            for b in self.backends:
                setter = getattr(b, "set_service_scale", None)
                if setter is not None:
                    setter(scale)
        return adopted

    # -- tenants ---------------------------------------------------------

    def register_tenant(self, tenant: str, quota: TenantQuota,
                        now_ns: int | None = None) -> None:
        if self._journal is not None:
            # Contract before books: replay re-creates the tenant's
            # bank before any of its intents replays.
            self._journal.tenant(
                self.clock.now_ns() if now_ns is None else now_ns,
                tenant, quota)
        self.admission.register(
            tenant, quota,
            now_ns=self.clock.now_ns() if now_ns is None else now_ns)
        self.queue.set_weight(tenant, quota.weight)
        if self.shadow is not None:
            self.shadow.note_tenant(tenant, quota)

    def _slot_of(self, tenant: str) -> int:
        slot = self._tenant_slot.get(tenant)
        if slot is None:
            slot = self._tenant_slot[tenant] = len(self._tenant_slot)
        return slot

    # -- intake ----------------------------------------------------------

    def submit(self, tenant: str, payload: Any, cost: int = 1,
               slo: str | None = None) -> SubmitResult:
        """Admit or shed. ``slo`` defaults to the tenant quota's class."""
        now = self.clock.now_ns()
        cost = max(1, int(cost))
        quota = self.admission.quota_of(tenant)
        cls = slo or (quota.slo if quota is not None else "batch")
        if cls not in SLO_CLASSES:
            # Before the fault consult and before any accounting: a bad
            # override must not burn a fault-stream draw, charge a shed,
            # or crash deep in the fair queue with a bare KeyError.
            raise ValueError(
                f"unknown SLO class {cls!r}; known: {SLO_CLASSES}")
        if self.shadow is not None:
            # Before the fault consult: an injected shed is an
            # admission outcome, the ARRIVAL still happened and must
            # replay (the recorder consumes no randomness).
            self.shadow.on_submit(now, tenant, cls, cost)
        penalty_ns = 0
        f = _faults.consult("gateway.admit", tenant)
        if f is not None:
            if f.fault == "shed":
                shed = self.admission.record_shed(
                    "injected-shed",
                    int(f.args.get("retry_after_ns", 10 * MS)))
                self._emit_shed(now, tenant, cls, shed)
                return SubmitResult(False, None, shed.reason,
                                    shed.retry_after_ns)
            if f.fault == "delay":
                penalty_ns = int(f.args.get("delay_ns", 1 * MS))
        jr = self._journal
        if jr is not None:
            # Spend-kind watermarks: which lease odometer the admission
            # charge is about to move (the ADMIT intent records it, so
            # recovery can re-derive the exact spend books).
            b = self.admission._buckets.get(tenant)
            pre_leased = getattr(b, "leased_spent", None)
            pre_cons = getattr(b, "conservative_spent", None)
        shed = self.admission.admit(
            tenant, cost, now,
            # The tenant's slots across BOTH classes: max_queued bounds
            # what a tenant parks at the gateway, and a per-request slo
            # override must not open a second, separately-bounded queue.
            tenant_queued=sum(self.queue.depth(c, tenant)
                              for c in SLO_CLASSES),
            total_queued=self.queue.depth())
        if shed is not None:
            self._emit_shed(now, tenant, cls, shed)
            return SubmitResult(False, None, shed.reason,
                                shed.retry_after_ns)
        rid = _jr.rid_string(self.name, self.rid_generation,
                             next(self._rids))
        if jr is not None:
            spend = _jr.SPEND_NONE
            b = self.admission._buckets.get(tenant)
            if b is not None and hasattr(b, "leased_spent"):
                if pre_leased is not None:
                    if b.leased_spent > pre_leased:
                        spend = _jr.SPEND_LEASED
                    elif b.conservative_spent > pre_cons:
                        spend = _jr.SPEND_CONSERVATIVE
                elif b.leased_spent > 0:  # lazily-built leased bucket
                    spend = _jr.SPEND_LEASED
                elif b.conservative_spent > 0:
                    spend = _jr.SPEND_CONSERVATIVE
            # The ADMIT intent lands before the queue/books move — the
            # write-ahead ordering dur-unjournaled-mutation enforces.
            jr.admit(now, self.name, rid, tenant, self._cls_code(cls),
                     cost, spend)
        req = Request(rid=rid, tenant=tenant, slo=cls, cost=cost,
                      payload=payload, submit_ns=now,
                      penalty_ns=penalty_ns)
        self.queue.push(req)
        self.admitted += 1
        self._emit(now, Ev.GW_ADMIT, self._slot_of(tenant),
                   self._cls_code(cls), cost, self.queue.depth())
        if self.spans is not None:
            cc = self._cls_code(cls)
            self.spans.admit(now, rid, tenant, cc, cost, self.name)
            self.spans.enqueue(now, rid, tenant, cc, self.name)
        return SubmitResult(True, rid)

    # -- federation custody transfer (docs/GATEWAY.md "Federation") ------

    def adopt(self, req: Request) -> None:
        """Take custody of one request admitted at ANOTHER gateway —
        the federation failover path for a dead member's in-flight
        casualties. No admission charge (the request already paid at
        its original front door); it enters at the head of the fair
        queue exactly like a backend-loss casualty."""
        now = self.clock.now_ns()
        if self._journal is not None:
            self._journal.adopt(now, self.name, req.rid)
        req.backend = None
        req.requeues += 1
        self.adopted += 1
        self.queue.requeue_front(req)
        self._emit(now, Ev.GW_REQUEUE, self._slot_of(req.tenant),
                   self._cls_code(req.slo), self._backend_slot(None))
        if self.spans is not None:
            self.spans.requeue(now, req.rid, self._backend_slot(None),
                               self.name)

    def adopt_tenant(self, cls: str, tenant: str, requests: list[Request],
                     deficit: float = 0.0,
                     from_member: str = "") -> None:
        """Batch custody transfer of a tenant's queued FIFO from a
        draining or dead federated member: order preserved at the front
        of the queue, DRR deficit carried so the tenant resumes its
        cycle instead of restarting with fresh credit. ``from_member``
        names the source (the journal's custody-move intent needs
        both ends)."""
        if self._journal is not None:
            self._journal.adopt_tenant(
                self.clock.now_ns(), self.name, from_member, tenant,
                self._cls_code(cls), int(max(0.0, deficit) * 1e6))
        self.queue.restore_tenant(cls, tenant, requests, deficit)
        self.adopted += len(requests)

    # -- the pump --------------------------------------------------------

    def tick(self) -> list[tuple[str, dict]]:
        """One gateway round: reap completions, repair backend loss,
        dispatch from the fair queue, export feedback. Returns this
        tick's completions as (rid, info) pairs.

        The batched pump: per-request span emits, histogram samples,
        and ledger counter adds stage into per-tick slabs and land in
        bulk — the observability slabs BEFORE ``_feedback`` (its
        quantile reads and the stats surface must see this tick's
        samples), the trace batch at tick end."""
        now = self.clock.now_ns()
        done = self._reap(now)
        self._repair(now)
        self._dispatch(now)
        self._hist_batch.flush()
        self._ledger_flush()
        self._feedback(now)
        self.flush_trace()
        if self._journal is not None and self.journal_autocommit:
            # Group commit AFTER the observability flushes: the span
            # ring is always a superset of the committed journal, so a
            # crash mid-commit can only leave EXTRA span records (for
            # the unacked suffix), never a committed intent without
            # its span (docs/DURABILITY.md "Crash windows").
            self._journal.commit()
        self._hw_sample()
        return done

    def flush_trace(self) -> None:
        """Land staged GW_* records, histogram samples, and ledger
        adds (consumers reading ``gw.trace``/``gw.hist``/the ledger
        file between ticks call this first; ``stats()`` does)."""
        if self._trace_batch is not None:
            self._trace_batch.flush()
        self._hist_batch.flush()
        self._ledger_flush()

    def busy(self) -> bool:
        return bool(self.queue.depth() or self.inflight)

    # poll completions from every live backend
    def _reap(self, now: int) -> list[tuple[str, dict]]:
        out: list[tuple[str, dict]] = []
        for b in self.backends:
            if not b.alive():
                continue
            for req, info in b.poll(now):
                if self._journal is not None:
                    self._journal.complete(now, self.name, req.rid)
                self.inflight.pop(req.rid, None)
                self.completed += 1
                cls = req.slo
                lat = now - req.submit_ns + req.penalty_ns
                service_ns = int(info.get("service_ns", 0))
                hist_rec = self._hist_batch.record
                hist_rec(req.tenant, cls, "e2e", lat)
                hist_rec(req.tenant, cls, "service", service_ns)
                hist_rec(f"be:{b.name}", "*", "service", service_ns)
                info = {**info, "tenant": req.tenant, "slo": cls,
                        "latency_ns": lat,
                        "queue_delay_ns": req.queue_delay_ns,
                        # Admission time: lets windowed consumers (the
                        # canary guard) judge only requests submitted
                        # inside their window.
                        "submit_ns": req.submit_ns}
                out.append((req.rid, info))
                self.completions.append((req.rid, info))
                self._ledger_stage(cls, Counter.STEPS_RETIRED, 1)
                self._ledger_stage(cls, Counter.TOKENS, req.cost)
                self._ledger_stage(cls, Counter.DEVICE_TIME_NS,
                                   service_ns)
                self._emit(now, Ev.GW_COMPLETE, self._slot_of(req.tenant),
                           self._cls_code(cls),
                           self._backend_slot(req.backend),
                           service_ns)
                if self.spans is not None:
                    self.spans.complete(now, req.rid,
                                        self._backend_slot(b.name),
                                        service_ns, lat, self.name)
        return out

    # backend loss: drain + requeue, never drop
    def _repair(self, now: int) -> None:
        for b in self.backends:
            if b.alive():
                continue
            casualties = list(b.drain())
            # Inflight requests mapped to the dead backend that drain()
            # could not return (already consumed) are requeued from the
            # gateway's own inflight table — the authoritative record.
            drained = {r.rid for r in casualties}
            for rid, req in list(self.inflight.items()):
                if req.backend == b.name and rid not in drained:
                    casualties.append(req)
            # Reversed so sequential requeue_front/appendleft leaves
            # the FIFO oldest-first: the longest-waiting casualty must
            # re-dispatch first, not last.
            for req in reversed(casualties):
                if self._journal is not None:
                    self._journal.requeue(now, self.name, req.rid)
                self.inflight.pop(req.rid, None)
                req.backend = None
                req.requeues += 1
                self.requeued += 1
                self.queue.requeue_front(req)
                self._ledger_stage(req.slo, Counter.YIELDS, 1)
                self._emit(now, Ev.GW_REQUEUE, self._slot_of(req.tenant),
                           self._cls_code(req.slo),
                           self._backend_slot(b.name))
                if self.spans is not None:
                    self.spans.requeue(now, req.rid,
                                       self._backend_slot(b.name),
                                       self.name)

    def _eligible(self, health: dict | None = None) -> list[Backend]:
        """Live backends, controller-health vetted (breaker-open or
        dead agents of the same name never take dispatches), ranked
        least-loaded first, name-tiebroken for determinism. ``health``
        lets the dispatch loop snapshot the controller view once per
        tick instead of rebuilding it per request.

        A STALE health entry (older than the controller's
        ``health_ttl_ns`` — nobody has heartbeat the agent inside the
        breaker's half-open window) is treated as *unknown*, not as
        truth: it neither vetoes the backend (a stale "dead" may have
        recovered) nor vouches for it (a stale "alive" may have died) —
        the backend stays eligible on its own liveness but ranks behind
        every backend with a fresh healthy view."""
        if health is None:
            health = (self.controller.backend_health()
                      if self.controller is not None else {})
        out = []
        for b in self.backends:
            if not b.alive():
                continue
            h = health.get(b.name)
            stale = bool(h.get("stale", False)) if h is not None else False
            if (h is not None and not stale
                    and (not h["alive"] or h["breaker"] == "open")):
                continue
            out.append((1 if stale else 0, b))
        out.sort(key=lambda p: (p[0], p[1].depth(), p[1].name))
        return [b for _, b in out]

    def _dispatch(self, now: int) -> None:
        health = (self.controller.backend_health()
                  if self.controller is not None else {})
        while len(self.inflight) < self.max_inflight:
            eligible = self._eligible(health)
            ranked = [b for b in eligible if b.depth() < b.capacity]
            if not ranked:
                return
            req = self.queue.pop()
            if req is None:
                return
            target = ranked[0]
            f = _faults.consult("gateway.route", req.tenant)
            if f is not None and f.fault == "misroute":
                # Wrong placement, still a LIVE placement: the worst
                # eligible backend, capacity bound waived — latency
                # degrades, the request is never lost.
                target = eligible[-1]
            first_dispatch = req.dispatch_ns < 0
            req.backend = target.name
            req.dispatch_ns = now
            req.queue_delay_ns = now - req.submit_ns + req.penalty_ns
            self._delays[req.slo].append(req.queue_delay_ns)
            if first_dispatch:
                # Requeued casualties re-dispatch with a CUMULATIVE
                # delay; one histogram sample per request keeps the
                # quantiles a per-request distribution.
                self._hist_batch.record(req.tenant, req.slo, "queue",
                                        req.queue_delay_ns)
            # Settle the feedback watermark: only the wait not already
            # exported by the stuck-queue sentinel (or a previous
            # dispatch, for requeued casualties) enters the channel, so
            # each ns of delay reaches the scheduler exactly once.
            self._fb_delay_ns[req.slo] += max(
                0, req.queue_delay_ns - req.reported_wait_ns)
            req.reported_wait_ns = max(req.reported_wait_ns,
                                       req.queue_delay_ns)
            self._fb_events[req.slo] += 1
            if self._journal is not None:
                self._journal.dispatch(
                    now, self.name, req.rid,
                    int(max(0.0, self.queue.last_deficit) * 1e6))
            self.inflight[req.rid] = req
            self.dispatched += 1
            if self.spans is not None:
                # BEFORE dispatch_request: a backend with a free run
                # slot fires the exec hook synchronously, and SPAN_EXEC
                # must land after SPAN_DISPATCH on the chain.
                self.spans.dispatch(
                    now, req.rid, self._backend_slot(target.name),
                    req.queue_delay_ns,
                    int(max(0.0, self.queue.last_deficit) * 1000),
                    self.name)
            target.dispatch_request(req, now)
            self._ledger_stage(req.slo, Counter.SCHED_COUNT, 1)
            self._ledger_stage(req.slo, Counter.RUNQ_WAIT_NS,
                               req.queue_delay_ns)
            self._emit(now, Ev.GW_DISPATCH, self._slot_of(req.tenant),
                       self._cls_code(req.slo),
                       self._backend_slot(target.name),
                       req.queue_delay_ns)

    # -- feedback export (the serving-tier vcrd_op analog) ---------------

    def _feedback(self, now: int) -> None:
        if now - self._last_feedback_ns < self.feedback_period_ns:
            return
        self._last_feedback_ns = now
        shed_total = sum(self.admission.sheds.values())
        denom = self.admitted + shed_total
        shed_ppm = int(1_000_000 * shed_total / denom) if denom else 0
        for cls in SLO_CLASSES:
            # The exported quantiles come from the SAME histograms
            # stats() and `pbst slo report` read, so shed/boost
            # decisions and the operator surfaces agree on one
            # estimator (docs/TRACING.md).
            self._emit(now, Ev.GW_QDELAY, self._cls_code(cls),
                       self.hist.class_quantile(cls, "queue", 0.50),
                       self.hist.class_quantile(cls, "queue", 0.99),
                       shed_ppm)
        if self.controller is not None and hasattr(
                self.controller, "note_backend_service"):
            # Backend attribution for the routing view: the controller
            # health entries carry each backend's observed service p99
            # so cross-gateway routing ranks on measured service time,
            # not just queue depth.
            for b in self.backends:
                p99 = self.hist.quantile(f"be:{b.name}", "*",
                                         "service", 0.99)
                if p99:
                    self.controller.note_backend_service(b.name, p99)
        if self.feedback_sink is not None:
            wait_ns = self._fb_delay_ns[INTERACTIVE]
            events = self._fb_events[INTERACTIVE]
            # Sustained pressure also counts queued-but-undispatched
            # age: a stuck queue must not read as "no delay samples".
            # Incremental against the request's watermark — the age
            # already exported last period (and later settled at
            # dispatch) is never counted twice.
            req = self.queue.oldest(INTERACTIVE)
            if req is not None:
                age = now - req.submit_ns + req.penalty_ns
                inc = age - req.reported_wait_ns
                if inc > 0:
                    req.reported_wait_ns = age
                    wait_ns += inc
                    events += 1
            if events:
                self.feedback_sink(INTERACTIVE, int(wait_ns), int(events))
        self._fb_delay_ns = {cls: 0 for cls in SLO_CLASSES}
        self._fb_events = {cls: 0 for cls in SLO_CLASSES}

    # -- telemetry plumbing ----------------------------------------------

    @staticmethod
    def _cls_code(cls: str) -> int:
        return SLO_CLASSES.index(cls)

    def _backend_slot(self, name: str | None) -> int:
        for i, b in enumerate(self.backends):
            if b.name == name:
                return i
        return len(self.backends)  # unknown/None sentinel

    def _emit(self, now: int, ev: int, *args: int) -> None:
        if self._trace_batch is not None:
            self._trace_batch.emit(now, ev, *args)

    def _emit_shed(self, now: int, tenant: str, cls: str,
                   shed: Shed) -> None:
        if self._journal is not None:
            self._journal.shed(now, self.name, tenant,
                               self._cls_code(cls), shed.reason_code)
        self._ledger_add(cls, Counter.COMPILES, 1)
        self._emit(now, Ev.GW_SHED, self._slot_of(tenant),
                   self._cls_code(cls), shed.reason_code,
                   shed.retry_after_ns)
        if self.spans is not None:
            self.spans.shed(now, tenant, self._cls_code(cls),
                            shed.reason_code, self.name)

    def _ledger_add(self, cls: str, counter: int, delta: int) -> None:
        if self._ledger is not None and delta:
            self._ledger.add(GW_LEDGER_SLOTS[cls], int(counter), int(delta))

    def _ledger_stage(self, cls: str, counter: int, delta: int) -> None:
        """Pump-side ledger accounting: accumulate into the per-tick
        per-class delta vector; ``_ledger_flush`` lands each touched
        class as ONE seqlock ``add_many``. External monitors see
        counters advance at tick granularity instead of per event —
        the same visibility watermark as the staged trace records."""
        if self._ledger is not None and delta:
            self._ld_acc[cls][int(counter)] += np.uint64(delta)
            self._ld_dirty.add(cls)

    def _ledger_flush(self) -> None:
        if not self._ld_dirty:
            return
        for cls in sorted(self._ld_dirty):
            acc = self._ld_acc[cls]
            self._ledger.add_many(GW_LEDGER_SLOTS[cls], acc)
            acc[:] = 0
        self._ld_dirty.clear()

    def _write_ledger_meta(self) -> None:
        """Sidecar so ``pbst dump/top --ledger`` render the gateway
        slots like any partition's (one row per SLO class)."""
        meta = {
            "partition": "gateway",
            "scheduler": "drr",
            "slots": {
                str(slot): {"ctx": f"gw/{cls}", "job": f"gw/{cls}",
                            "weight": "", "cap": "", "tslice_us": ""}
                for cls, slot in GW_LEDGER_SLOTS.items()
            },
        }
        if self.hw is not None:
            # Counter-source provenance (docs/HWTELEM.md): external
            # monitors must see which ladder tier (if any) is live.
            meta["source"] = self.hw.describe()
        tmp = self._ledger_path + ".meta.json.tmp"
        with open(tmp, "w") as f:
            json.dump(meta, f, indent=1)
        os.replace(tmp, self._ledger_path + ".meta.json")

    # -- observability ---------------------------------------------------

    def stats(self) -> dict:
        self.flush_trace()
        per_class = {}
        for cls in SLO_CLASSES:
            # Histogram-backed (docs/TRACING.md): the same estimator
            # `pbst slo report` and the feedback export use — not a
            # windowed deque mean drifting away from the SLO view.
            per_class[cls] = {
                "queued": self.queue.depth(cls),
                "qdelay_p50_ns": self.hist.class_quantile(
                    cls, "queue", 0.50),
                "qdelay_p99_ns": self.hist.class_quantile(
                    cls, "queue", 0.99),
                "latency_p50_ns": self.hist.class_quantile(
                    cls, "e2e", 0.50),
                "latency_p95_ns": self.hist.class_quantile(
                    cls, "e2e", 0.95),
                "latency_p99_ns": self.hist.class_quantile(
                    cls, "e2e", 0.99),
            }
        shed_total = sum(self.admission.sheds.values())
        denom = self.admitted + shed_total
        bypass = sum(getattr(b, "bypass_submits", 0)
                     for b in self.backends)
        out = {
            "name": self.name,
            "admitted": self.admitted,
            "completed": self.completed,
            "dispatched": self.dispatched,
            "requeued": self.requeued,
            "adopted": self.adopted,
            "inflight": len(self.inflight),
            "queued": self.queue.depth(),
            "shed": dict(sorted(self.admission.sheds.items())),
            "shed_rate": round(shed_total / denom, 6) if denom else 0.0,
            "bypass_submits": bypass,
            "classes": per_class,
            "backends": {
                b.name: {"alive": b.alive(), "depth": b.depth(),
                         "capacity": b.capacity,
                         "service_p99_ns": self.hist.quantile(
                             f"be:{b.name}", "*", "service", 0.99)}
                for b in self.backends
            },
        }
        if self.hw is not None:
            # Additive: unarmed gateways never carry the key, so the
            # stats shape (and every golden over it) is untouched.
            out["hw"] = {**self.hw.describe(),
                         "totals": dict(sorted(self._hw_totals.items())),
                         "recorded": (self.hw_recorder.recorded
                                      if self.hw_recorder is not None
                                      else 0)}
        return out
