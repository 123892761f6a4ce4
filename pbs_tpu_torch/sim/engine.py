"""Discrete-event scheduler simulator driving the real policy stack.

The port of ``pbs_tpu.sim.engine``: the same probes, the same report and
trace digest for every (workload, policy, seed). Sweep-mode runs of the
hot policies ride the port's native C dispatch core
(``sim/native_core.py``) when the library builds; the pure-Python loop
stays as the witness, bit-identical on every tier.

The partition/executor/timer machinery already runs deterministically
under a ``VirtualClock`` (the x86_emulator fake-backend pattern,
SURVEY.md §4); what this engine adds is everything needed to turn that
substrate into an offline policy-evaluation instrument:

- **Policy adapters** — the *unmodified* schedulers from the
  ``pbs_tpu_torch.sched`` registry, wrapped in a
  :class:`SchedulerProbe` that observes the ``sched.base`` interface
  from outside: runqueue wait per
  dispatch (filling the so-far-unused ``RUNQ_WAIT_NS`` counter),
  context-switch counts, and the dispatched-quantum timeline per job.
  ``feedback``/``atc`` are credit plus the corresponding adaptive-quantum
  policy armed on the partition.
- **Workloads** — tenant specs from ``pbs_tpu_torch.sim.workload``
  executed by ``telemetry.source.SimBackend`` (seeded; all noise via
  its Generator), with arrival schedules realized as virtual-time
  sleep/wake timers.
- **Recording** — a ``sim.trace.TraceRecorder`` hooked into the
  partition so every run yields a canonical JSONL trace and a stable
  digest: two runs with equal (workload, policy, seed) are byte-equal.

Two probe implementations share one accessor contract:

- :class:`SchedulerProbe` — the production accumulator: preallocated
  grow-by-doubling numpy arrays, zero per-dispatch Python object
  allocation (the sweep fast path).
- :class:`ListSchedulerProbe` — the original list-append reference
  implementation, kept as the equivalence witness: bit-identical
  metrics reports and trace digests across the workload catalog.

``record=False`` (the sweep mode) skips the trace recorder, the obs
trace ring, the telemetry-ledger mirror, and the probe's
quantum-timeline accounting — a sweep cell pays for scheduling, not for
observability nobody reads.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from pbs_tpu_torch.runtime.job import ContextState, Job
from pbs_tpu_torch.runtime.partition import Partition
from pbs_tpu_torch.sched.atc import AtcFeedbackPolicy
from pbs_tpu_torch.sched.base import Decision, scheduler_names
from pbs_tpu_torch.sched.feedback import FeedbackPolicy
from pbs_tpu_torch.sim.trace import TraceRecorder
from pbs_tpu_torch.sim.workload import TenantSpec, build_workload
from pbs_tpu_torch.telemetry.counters import Counter
from pbs_tpu_torch.telemetry.source import SimBackend
from pbs_tpu_torch.utils.clock import SEC, VirtualClock
from pbs_tpu_torch.utils.stats import nearest_rank_sorted

#: policy name -> (scheduler registry name, adaptive-quantum policy class)
POLICIES: dict[str, tuple[str, type | None]] = {
    "credit": ("credit", None),
    "credit2": ("credit2", None),
    "sedf": ("sedf", None),
    "arinc653": ("arinc653", None),
    "feedback": ("credit", FeedbackPolicy),
    "atc": ("credit", AtcFeedbackPolicy),
}


def policy_names() -> list[str]:
    """Schedulers usable as-is plus the adaptive-policy composites."""
    return sorted(set(scheduler_names()) | set(POLICIES))


def resolve_policy(policy: str) -> tuple[str, type | None]:
    if policy in POLICIES:
        return POLICIES[policy]
    if policy in scheduler_names():
        return policy, None
    raise KeyError(
        f"unknown policy {policy!r}; available: {policy_names()}")


class _NullSampler:
    """Overflow-sampler stand-in for sweep cells: the sim arms no
    i-mode thresholds, so the per-quantum ``check`` is pure overhead.
    Every other sampler call degrades to the real one (arming through
    it un-nulls nothing — sweeps must not arm samplers)."""

    __slots__ = ("_inner",)

    def __init__(self, inner):
        self._inner = inner

    def check(self, ctx) -> None:
        pass

    def __getattr__(self, name):
        return getattr(self._inner, name)


class _TenantAcc:
    """Per-tenant numpy accumulator: wait samples, dispatch count and
    the quantum-change timeline on preallocated grow-by-doubling
    arrays. Growth happens outside the dispatch edge (amortized O(1));
    the dispatch edge itself is two scalar stores and an index bump."""

    __slots__ = ("t", "w", "n", "dispatches", "qt", "qq", "qn", "last_q")

    def __init__(self, cap: int = 256):
        self.t = np.empty(cap, dtype=np.int64)  # dispatch timestamps
        self.w = np.empty(cap, dtype=np.int64)  # wait sample per dispatch
        self.n = 0
        self.dispatches = 0
        self.qt = np.empty(16, dtype=np.int64)  # quantum change-points
        self.qq = np.empty(16, dtype=np.int64)
        self.qn = 0
        self.last_q = -1


class SchedulerProbe:
    """Transparent wrapper around a real scheduler instance.

    Forwards the full ``sched.base`` interface unmodified (lifecycle and
    control-plane calls via ``__getattr__``) and instruments the three
    run-state edges the metrics need: wake/requeue (enqueue timestamp),
    pick (wait sample + dispatch count + quantum timeline), deschedule
    (requeue timestamp). The wait each context experienced also lands in
    its ``RUNQ_WAIT_NS`` counter (accumulated as a plain int per
    dispatch, published by :meth:`flush_counters` before metrics are
    read), so waits show up in reports and recorded traces like any
    other telemetry.

    ``timeline=False`` (sweep mode) skips the quantum-timeline
    accounting entirely — the adaptation change-points are a debugging
    surface, not a sweep score input.
    """

    def __init__(self, inner, clock, timeline: bool = True):
        self.inner = inner
        self.clock = clock
        self.switches = 0
        self.timeline = timeline
        self._acc: dict[str, _TenantAcc] = {}
        self._enqueued: dict[Any, int] = {}
        self._last_pick: dict[int, Any] = {}
        self._wait: dict[Any, int] = {}  # ctx -> pending RUNQ_WAIT_NS

    def _acc_of(self, job_name: str) -> _TenantAcc:
        a = self._acc.get(job_name)
        if a is None:
            a = self._acc[job_name] = _TenantAcc()
        return a

    @staticmethod
    def _grow(a: _TenantAcc) -> None:
        cap = a.t.shape[0] * 2
        for name in ("t", "w"):
            arr = np.empty(cap, dtype=np.int64)
            arr[:a.n] = getattr(a, name)[:a.n]
            setattr(a, name, arr)

    @staticmethod
    def _grow_qt(a: _TenantAcc) -> None:
        cap = a.qt.shape[0] * 2
        for name in ("qt", "qq"):
            arr = np.empty(cap, dtype=np.int64)
            arr[:a.qn] = getattr(a, name)[:a.qn]
            setattr(a, name, arr)

    # -- instrumented edges ---------------------------------------------

    def wake(self, ctx) -> None:
        self._enqueued.setdefault(ctx, self.clock.now_ns())
        self.inner.wake(ctx)

    def sleep(self, ctx) -> None:
        self._enqueued.pop(ctx, None)
        self.inner.sleep(ctx)

    def do_schedule(self, ex, now_ns: int) -> Decision:
        d = self.inner.do_schedule(ex, now_ns)
        ctx = d.ctx
        if ctx is not None:
            wait = now_ns - self._enqueued.pop(ctx, now_ns)
            if wait < 0:
                wait = 0
            if wait:  # zero adds nothing to the counter: skip the dict
                wa = self._wait
                wa[ctx] = wa.get(ctx, 0) + wait
            a = self._acc.get(ctx.job.name)
            if a is None:
                a = self._acc_of(ctx.job.name)
            n = a.n
            if n == a.t.shape[0]:
                self._grow(a)
            a.t[n] = now_ns
            a.w[n] = wait
            a.n = n + 1
            a.dispatches += 1
            if self.timeline:
                q_us = int(d.quantum_ns) // 1000
                if q_us != a.last_q:
                    m = a.qn
                    if m == a.qt.shape[0]:
                        self._grow_qt(a)
                    a.qt[m] = now_ns
                    a.qq[m] = q_us
                    a.qn = m + 1
                    a.last_q = q_us
            lp = self._last_pick
            if lp.get(ex.index) is not ctx:
                self.switches += 1
                lp[ex.index] = ctx
        return d

    def descheduled(self, ex, ctx, ran_ns: int, now_ns: int) -> None:
        self.inner.descheduled(ex, ctx, ran_ns, now_ns)
        if ctx.state is ContextState.RUNNABLE or \
                ctx.state is ContextState.RUNNING:
            self._enqueued[ctx] = now_ns

    # -- metrics accessors (shared with ListSchedulerProbe) --------------

    def flush_counters(self) -> None:
        """Publish the deferred per-context wait sums into the
        ``RUNQ_WAIT_NS`` counters (one numpy add per context instead of
        one per dispatch). Call before reading context counters."""
        for ctx, w in self._wait.items():
            ctx.counters[Counter.RUNQ_WAIT_NS] += np.uint64(w)
        self._wait.clear()

    def wait_arrays(self, job_name: str) -> tuple[np.ndarray, np.ndarray]:
        a = self._acc.get(job_name)
        if a is None:
            z = np.empty(0, dtype=np.int64)
            return z, z
        return a.t[:a.n], a.w[:a.n]

    def dispatches_of(self, job_name: str) -> int:
        a = self._acc.get(job_name)
        return a.dispatches if a is not None else 0

    def timeline_of(self, job_name: str) -> list[tuple[int, int]]:
        a = self._acc.get(job_name)
        if a is None:
            return []
        return list(zip(a.qt[:a.qn].tolist(), a.qq[:a.qn].tolist()))

    # -- everything else is the real scheduler --------------------------

    def __getattr__(self, name: str):
        return getattr(self.inner, name)


@dataclasses.dataclass
class TenantStats:
    """Per-tenant observations accumulated by the reference probe."""

    waits: list[tuple[int, int]] = dataclasses.field(default_factory=list)
    dispatches: int = 0
    # (t_ns, quantum_us) appended only on change — the adaptation timeline.
    quantum_timeline: list[tuple[int, int]] = dataclasses.field(
        default_factory=list)


class ListSchedulerProbe:
    """The original list-append probe, kept as the equivalence witness
    for :class:`SchedulerProbe`: same
    instrumented edges, per-dispatch Python-object accumulation. Do not
    use for sweeps — this is the slow path the numpy probe replaced."""

    def __init__(self, inner, clock, timeline: bool = True):
        self.inner = inner
        self.clock = clock
        self.timeline = timeline
        self.stats: dict[str, TenantStats] = {}
        self.switches = 0
        self._enqueued: dict[Any, int] = {}
        self._last_pick: dict[int, Any] = {}

    def _stats(self, job_name: str) -> TenantStats:
        st = self.stats.get(job_name)
        if st is None:
            st = self.stats[job_name] = TenantStats()
        return st

    def wake(self, ctx) -> None:
        self._enqueued.setdefault(ctx, self.clock.now_ns())
        self.inner.wake(ctx)

    def sleep(self, ctx) -> None:
        self._enqueued.pop(ctx, None)
        self.inner.sleep(ctx)

    def do_schedule(self, ex, now_ns: int) -> Decision:
        d = self.inner.do_schedule(ex, now_ns)
        ctx = d.ctx
        if ctx is not None:
            wait = max(0, now_ns - self._enqueued.pop(ctx, now_ns))
            ctx.counters[Counter.RUNQ_WAIT_NS] += np.uint64(wait)
            st = self._stats(ctx.job.name)
            st.waits.append((now_ns, wait))  # pbst: ignore[perf-dispatch-alloc] -- reference equivalence witness, deliberately list-based
            st.dispatches += 1
            if self.timeline:
                q_us = int(d.quantum_ns) // 1000
                if not st.quantum_timeline or \
                        st.quantum_timeline[-1][1] != q_us:
                    st.quantum_timeline.append((now_ns, q_us))  # pbst: ignore[perf-dispatch-alloc] -- reference equivalence witness, deliberately list-based
            if self._last_pick.get(ex.index) is not ctx:
                self.switches += 1
            self._last_pick[ex.index] = ctx
        return d

    def descheduled(self, ex, ctx, ran_ns: int, now_ns: int) -> None:
        self.inner.descheduled(ex, ctx, ran_ns, now_ns)
        if ctx.runnable():
            self._enqueued[ctx] = now_ns

    # -- metrics accessors (the SchedulerProbe contract) -----------------

    def flush_counters(self) -> None:
        pass  # counters were updated per dispatch

    def wait_arrays(self, job_name: str) -> tuple[np.ndarray, np.ndarray]:
        st = self.stats.get(job_name)
        if st is None or not st.waits:
            z = np.empty(0, dtype=np.int64)
            return z, z
        arr = np.asarray(st.waits, dtype=np.int64)
        return arr[:, 0], arr[:, 1]

    def dispatches_of(self, job_name: str) -> int:
        st = self.stats.get(job_name)
        return st.dispatches if st is not None else 0

    def timeline_of(self, job_name: str) -> list[tuple[int, int]]:
        st = self.stats.get(job_name)
        return list(st.quantum_timeline) if st is not None else []

    def __getattr__(self, name: str):
        return getattr(self.inner, name)


class SimEngine:
    """One simulated run: workload × policy × seed → metrics + trace."""

    def __init__(
        self,
        workload: str = "mixed",
        policy: str = "feedback",
        seed: int = 0,
        n_tenants: int = 4,
        n_executors: int = 1,
        horizon_ns: int = 2 * SEC,
        trace_path: str | None = None,
        record: bool = True,
        keep_lines: bool = True,
        warmup_frac: float = 0.1,
        policy_params: dict | None = None,
        probe_cls: type | None = None,
        native: bool | str | None = None,
    ):
        self.workload = workload
        self.policy = policy
        self.seed = int(seed)
        self.horizon_ns = int(horizon_ns)
        self.warmup_frac = float(warmup_frac)
        #: Native dispatch-core request: None = auto (ride the C core
        #: for sweep-mode runs when available, degrade silently
        #: otherwise), False = force the pure-Python loop (the witness
        #: tier), True = require the native core (raise when
        #: unavailable/unsupported), or a tier name ("fastcall"/
        #: "ctypes") to pin the binding.
        self.native = native
        #: Which binding tier actually executed the run (None = the
        #: pure-Python engine) — stamped into sweep metadata.
        self.native_tier_used: str | None = None
        sched_name, policy_cls = resolve_policy(policy)
        if policy_params and policy_cls is None:
            raise KeyError(
                f"policy {policy!r} takes no policy_params (only the "
                f"adaptive composites do: "
                f"{sorted(n for n, (_, c) in POLICIES.items() if c)})")

        recording = bool(record or trace_path)
        self._recording = recording
        self.clock = VirtualClock()
        self.backend = SimBackend(self.clock, seed=self.seed)
        self.partition = Partition(
            f"sim-{workload}", source=self.backend, scheduler=sched_name,
            n_executors=n_executors)
        if recording:
            # The engine owns every producer on one thread under virtual
            # time, so dispatch events stage through EmitBatch: one
            # vectorized ring write per watermark instead of two scalar
            # emits per quantum (watermarks key on record timestamps, so
            # batching is as deterministic as the run itself).
            self.partition.enable_trace_batching()
        else:
            # Sweep mode: nothing consumes the obs ring, so dispatch
            # events skip it entirely, and the overflow sampler (which
            # the sim never arms) drops out of the quantum boundary
            # (the reference's sweep mode, decision for decision).
            self.partition.trace_enabled = False
            self.partition.sampler = _NullSampler(self.partition.sampler)
        self.probe = (probe_cls or SchedulerProbe)(
            self.partition.scheduler, self.clock, timeline=recording)
        self.partition.scheduler = self.probe
        self.feedback = (policy_cls(self.partition, **(policy_params or {}))
                         if policy_cls is not None else None)

        self.specs: list[TenantSpec] = build_workload(
            workload, seed=self.seed, n_tenants=n_tenants,
            horizon_ns=self.horizon_ns)
        self.jobs: list[Job] = []
        self._start_ns = self.clock.now_ns()
        for spec in self.specs:
            self.backend.register(spec.name, spec.profile)
            job = Job(spec.name, params=spec.params,
                      max_steps=spec.max_steps)
            for ctx in job.contexts:
                ctx.avg_step_ns = float(spec.profile.phases[0].step_time_ns)
            self.partition.add_job(job)
            self.jobs.append(job)
            if spec.arrival:
                self._arm_arrivals(job, spec.arrival)
        if not recording:
            # Sweep mode: detach the telemetry-ledger mirror too — the
            # report reads context counters directly, no monitor ever
            # attaches to a sweep cell's throwaway heap ledger, and the
            # per-quantum resume/suspend seqlock writes are the single
            # largest observability cost left on the dispatch path.
            for job in self.jobs:
                for ctx in job.contexts:
                    ctx.ledger_slot = -1

        self.recorder: TraceRecorder | None = None
        if recording:
            self.recorder = TraceRecorder(trace_path, keep_lines=keep_lines)
            self.recorder.meta(
                workload=workload, policy=policy, seed=self.seed,
                scheduler=sched_name, n_tenants=len(self.specs),
                n_executors=n_executors, horizon_ns=self.horizon_ns,
                jobs=[{
                    "name": j.name,
                    "weight": j.params.weight,
                    "cap": j.params.cap,
                    "tslice_us": j.params.tslice_us,
                    "n_contexts": len(j.contexts),
                    "avg_step_ns": int(j.contexts[0].avg_step_ns),
                } for j in self.jobs],
            )
            self.partition.recorder = self.recorder
        self._report: dict | None = None

    def _arm_arrivals(self, job: Job, arrival) -> None:
        part = self.partition
        for t_ns, awake in arrival:
            fn = ((lambda now, j=job: part.wake_job(j, notify=False))
                  if awake else
                  (lambda now, j=job: part.sleep_job(j, notify=False)))
            part.timers.arm(self._start_ns + int(t_ns), fn,
                            name="sim_arrival")
        # If the first flip is a wake, the tenant starts asleep until its
        # first burst arrives (first flip = sleep means it starts awake).
        if arrival and arrival[0][1]:
            part.sleep_job(job, notify=False)

    # -- run + metrics ---------------------------------------------------

    def run(self) -> dict:
        try:
            if not self._run_native():
                self.partition.run(
                    until_ns=self._start_ns + self.horizon_ns)
        finally:
            # Close on failure too: a policy raising mid-run must still
            # flush the on-disk JSONL for the post-mortem.
            if self.recorder is not None:
                self.recorder.close()
        self._report = self._gather()
        return self._report

    def _run_native(self) -> bool:
        """Ride the C dispatch core when the request/configuration
        allows it; False = run the pure-Python witness loop. Auto mode
        (``native=None``) engages only for sweep-mode (``record=False``)
        runs — the record path stays on the witness engine unless a
        caller opts in — and degrades silently when the toolchain or
        the configuration doesn't support the core; an explicit
        request (True or a tier name) raises instead."""
        if self.native is False:
            return False
        if self.native is None and self._recording:
            return False
        from pbs_tpu_torch.sim import native_core

        tier = self.native if isinstance(self.native, str) else None
        reason = native_core.unsupported_reason(self, tier=tier)
        if reason is not None:
            if self.native is None:
                return False
            raise RuntimeError(
                f"native sim core requested but unusable: {reason}")
        self.native_tier_used = native_core.run_native(self, tier=tier)
        return True

    def elapsed_ns(self) -> int:
        return self.clock.now_ns() - self._start_ns

    def _gather(self) -> dict:
        warmup_at = self._start_ns + int(self.warmup_frac * self.horizon_ns)
        self.probe.flush_counters()
        tenants: dict[str, dict] = {}
        device_ns: list[int] = []
        per_tenant_waits: list[np.ndarray] = []
        for job in self.jobs:
            dev = sum(int(c.counters[Counter.DEVICE_TIME_NS])
                      for c in job.contexts)
            # One masked slice + one sort per tenant: every quantile
            # below reads the same sorted array (nearest-rank, the
            # estimator every latency surface in the tree reports —
            # utils/stats.py).
            t_arr, w_arr = self.probe.wait_arrays(job.name)
            waits = np.sort(w_arr[t_arr >= warmup_at]) if t_arr.size \
                else w_arr
            per_tenant_waits.append(waits)
            device_ns.append(dev)
            tenants[job.name] = {
                "device_ns": dev,
                "steps": job.steps_retired(),
                "stall_ns": sum(int(c.counters[Counter.HBM_STALL_NS])
                                for c in job.contexts),
                "collective_wait_ns": sum(
                    int(c.counters[Counter.COLLECTIVE_WAIT_NS])
                    for c in job.contexts),
                "runq_wait_ns": sum(int(c.counters[Counter.RUNQ_WAIT_NS])
                                    for c in job.contexts),
                "sched_count": sum(c.sched_count for c in job.contexts),
                "dispatches": self.probe.dispatches_of(job.name),
                "wait_p99_us": _pct_us_sorted(waits, 0.99),
                "tslice_us": job.params.tslice_us,
                "quantum_timeline_us": [
                    [int(t - self._start_ns), int(q)]
                    for t, q in self.probe.timeline_of(job.name)],
            }
        all_waits = np.sort(np.concatenate(per_tenant_waits)) \
            if per_tenant_waits else np.empty(0, dtype=np.int64)
        busy = sum(device_ns)
        elapsed = self.elapsed_ns()
        n_ex = len(self.partition.executors)
        report = {
            "workload": self.workload,
            "policy": self.policy,
            "seed": self.seed,
            "horizon_ns": self.horizon_ns,
            "elapsed_ns": elapsed,
            "busy_ns": busy,
            "utilization": round(busy / max(1, elapsed * n_ex), 4),
            "quanta": sum(ex.dispatch_count
                          for ex in self.partition.executors),
            "switches": self.probe.switches,
            "jain_fairness": round(jain_index(device_ns), 4),
            "wait_p50_us": _pct_us_sorted(all_waits, 0.50),
            "wait_p99_us": _pct_us_sorted(all_waits, 0.99),
            "tenants": tenants,
        }
        if self.feedback is not None:
            report["feedback"] = self.feedback.dump()
        if self.recorder is not None:
            report["trace_digest"] = self.recorder.digest()
            report["trace_records"] = self.recorder.records_emitted
        return report


def jain_index(xs: list[int]) -> float:
    """Jain's fairness index over per-tenant service: (Σx)²/(n·Σx²);
    1.0 = perfectly even, 1/n = one tenant got everything."""
    xs = [x for x in xs if x >= 0]
    if not xs:
        return 1.0
    sq = sum(float(x) * float(x) for x in xs)
    if sq == 0:
        return 1.0
    s = float(sum(xs))
    return (s * s) / (len(xs) * sq)


def _pct_us_sorted(sorted_waits_ns, q: float) -> float:
    """Nearest-rank percentile of a SORTED wait array, in µs.

    Nearest-rank (not ``np.percentile``'s linear interpolation) so the
    sim's quantiles are the same estimator the serving and gateway SLO
    surfaces report (``utils/stats.nearest_rank``).
    """
    if len(sorted_waits_ns) == 0:
        return 0.0
    return round(nearest_rank_sorted(sorted_waits_ns, q) / 1000.0, 1)
