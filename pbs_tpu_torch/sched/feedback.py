"""Telemetry-feedback adaptive quantum policy — the research core.

The port of ``pbs_tpu.sched.feedback``: the same windows, thresholds,
grow/shrink arithmetic and stale-counter fallback, decision for
decision, with the knob surface (``from_profile``/``from_knobs``/
``apply_knobs``: tuned profiles and live pushes through
``knobs.channel``), the live hardware-counter constructor
(``from_source``, over ``hwtelem.HwCounterSource``) and the run
recorder's ``tick`` tap. The reference's PMU-feedback loop
(``xen-4.2.1/xen/common/sched_credit.c``):

- ``csched_metric_tick`` (1 ms, ``sched_credit.c:450-465``): sample each
  context's counters.
- ``csched_dom_metric_update`` (``sched_credit.c:391-448``): per job, sum
  counter deltas over contexts (``pmc - prev_pmc``), derive the rate
  metrics — cache-miss rate (misses × 10⁵ / instruction) and CPI.
- ``csched_submilli_metric_update`` (``sched_credit.c:302-389``): a
  5-sample window over the average contention latency per event
  (``spinlock_metric_update / spinlock_count``, fed by the ``vcrd_op``
  channel); the window is *stable* when every sample lies within
  [70%, 130%] of the window mean (``sched_credit.c:114,354-357``);
  stable + miss-rate ≥ 100 → LOW_PHASE, grow the slice +100 µs (cap
  1.1 ms); stable + miss-rate < 100 → HIGH_PHASE, shrink ÷3 (or −200 µs)
  floor 100 µs; unstable → reset window, shrink if contention is rising.

Counter translation (see ``pbs_tpu_torch.telemetry.counters``):

- instructions → steps retired; cycles → device ns.
- LLC miss rate → HBM-stall rate: ``HBM_STALL_NS × 1000 / DEVICE_TIME_NS``
  (scaled so the reference's phase threshold of 100
  (``sched_credit.c:360-369``) means "10% of device time stalled on HBM").
- spinlock latency → collective/barrier wait reported through
  ``Job.report_contention`` (batched per step, not per event — fixing the
  hypercall storm flagged at SURVEY.md §3.5) plus the
  ``COLLECTIVE_WAIT_NS`` counter.

On a device the slice in µs is realized as N steps (see
``pbs_tpu_torch.runtime.executor.quantum_to_steps``): growing the slice
amortizes dispatch overhead for steady memory-bound phases; shrinking it
bounds the latency impact on co-tenants during contended/interactive
phases — the same tradeoff the reference's 100 µs–1.1 ms band encodes.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

import numpy as np

from pbs_tpu_torch import knobs
from pbs_tpu_torch.telemetry.counters import NUM_COUNTERS, Counter

if TYPE_CHECKING:
    from pbs_tpu_torch.runtime.job import Job
    from pbs_tpu_torch.runtime.partition import Partition

# Constants from the reference (BASELINE.md), declared in the knob
# registry (knobs/registry.py) — the defaults ARE the reference values,
# and a live policy is retuned through ``apply_knobs``.
METRIC_TICK_PERIOD_NS = knobs.default("sched.feedback.metric_tick_period_ns")
WINDOW = knobs.default("sched.feedback.window")
STABLE_LO = knobs.default("sched.feedback.stable_lo")
STABLE_HI = knobs.default("sched.feedback.stable_hi")
STALL_RATE_THRESHOLD = knobs.default("sched.feedback.stall_threshold")
TSLICE_MIN_US = knobs.default("sched.feedback.tslice_min_us")
TSLICE_MAX_US = knobs.default("sched.feedback.tslice_max_us")
GROW_STEP_US = knobs.default("sched.feedback.grow_step_us")
SHRINK_SUB_US = knobs.default("sched.feedback.shrink_sub_us")

LOW_PHASE = "low"  # SPIN_LOW_PHASE: grow
HIGH_PHASE = "high"  # SPIN_HIGH_PHASE: shrink

# Gateway queue-delay feedback (docs/GATEWAY.md): an interactive
# request waiting longer than this per event at the front door means
# the serving tier is falling behind its SLO class.
GW_QDELAY_THRESHOLD_NS = knobs.default("sched.feedback.qdelay_threshold_ns")
# Consecutive over-threshold reports before the policy reacts —
# sustained pressure, not one burst (the window-stability idea applied
# to the serving-tier signal).
GW_HOT_AFTER = knobs.default("sched.feedback.gw_hot_after")


@dataclasses.dataclass
class JobMetricState:
    """Per-job filter state (``struct metric_state``/``event_sample``,
    ``sched_credit.c:173-191``).

    The sample window is a preallocated float64 ring in arrival order
    (shift-in-place on the full window) — the metric tick runs every
    millisecond for every job, so the filter must not allocate or walk
    Python lists per tick. ``wfill`` is the filled prefix; resets just
    zero it."""

    window: np.ndarray | None = None  # allocated lazily to window_len
    wfill: int = 0
    phase: str = LOW_PHASE
    last_contention: tuple[int, int] = (0, 0)
    ticks: int = 0
    grows: int = 0
    shrinks: int = 0
    resets: int = 0
    # Stale-telemetry tracking: consecutive ticks where the job retired
    # steps but the device-time channel read zero (a dead counter
    # readout, not idleness). Past the stale window the policy stops
    # steering and parks the slice on the default band value.
    stale_ticks: int = 0
    fallbacks: int = 0
    # Gateway queue-delay channel (the serving-tier vcrd_op analog):
    # consecutive over-threshold reports, and how often the sustained
    # condition fired the BOOST/shrink response.
    gw_reports: int = 0
    gw_hot: int = 0
    gw_boosts: int = 0


class FeedbackPolicy:
    """Arms the metric tick on a partition and adapts each job's
    ``tslice_us`` in place. Scheduler-agnostic: any policy that honors
    ``job.params.tslice_us`` at dispatch (credit does,
    ``sched_credit.c:1796-1805``) gets adaptive quanta."""

    def __init__(
        self,
        partition: "Partition",
        tick_ns: int = METRIC_TICK_PERIOD_NS,
        min_us: int = TSLICE_MIN_US,
        max_us: int = TSLICE_MAX_US,
        stall_threshold: float = STALL_RATE_THRESHOLD,
        window: int = WINDOW,
        stale_after: int = WINDOW,
        fallback_us: int | None = None,
        grow_step_us: int = GROW_STEP_US,
        shrink_sub_us: int = SHRINK_SUB_US,
        qdelay_threshold_ns: int = GW_QDELAY_THRESHOLD_NS,
        gw_hot_after: int = GW_HOT_AFTER,
    ):
        self.partition = partition
        self.min_us = min_us
        self.max_us = max_us
        self.stall_threshold = stall_threshold
        self.window_len = window
        # The hand-picked reference constants, as instance knobs;
        # defaults are the reference values.
        self.grow_step_us = int(grow_step_us)
        self.shrink_sub_us = int(shrink_sub_us)
        self.qdelay_threshold_ns = int(qdelay_threshold_ns)
        self.gw_hot_after = int(gw_hot_after)
        # Metric-tick scratch (one subtraction + one accumulate per
        # context, zero allocation per tick).
        self._delta = np.zeros(NUM_COUNTERS, dtype=np.uint64)
        self._tot = np.zeros(NUM_COUNTERS, dtype=np.uint64)
        #: Degraded mode (docs/FAULTS.md): after ``stale_after``
        #: consecutive dead-counter ticks the policy stops steering and
        #: parks the job's slice at ``fallback_us`` — the boot-param
        #: default band value, NOT whatever the last (possibly garbage)
        #: adaptation left behind. Steering on dead counters would walk
        #: the slice to a band edge and pin it there.
        self.stale_after = max(1, int(stale_after))
        if fallback_us is None:
            from pbs_tpu_torch.runtime.job import SchedParams

            fallback_us = SchedParams().tslice_us
        self.fallback_us = self._clamp(int(fallback_us))
        #: Live hardware-counter provenance: set by :meth:`from_source`
        #: so observability surfaces can name the ladder tier feeding
        #: this policy. Never read on the steering path — counters
        #: arrive through the partition's TelemetrySource like any
        #: other backend.
        self.hw_source = None
        self.states: dict[str, JobMetricState] = {}
        now = partition.clock.now_ns()
        self.timer = partition.timers.arm(
            now + tick_ns, self._metric_tick, period_ns=tick_ns,
            name="csched_metric_tick",
        )

    #: Profile keys `from_profile` accepts — exactly the constructor
    #: knobs the reference's tuner searches.
    TUNABLE_PARAMS = (
        "min_us", "max_us", "window", "stall_threshold",
        "grow_step_us", "shrink_sub_us", "qdelay_threshold_ns",
        "gw_hot_after",
    )

    #: Registry policy key (knobs/profile.py PARAM_KNOBS): which knob
    #: family maps onto this policy's constructor params.
    KNOB_POLICY = "feedback"

    @classmethod
    def from_profile(cls, partition: "Partition",
                     profile: dict) -> "FeedbackPolicy":
        """Build a policy from a tuned profile document (the
        ``sched/tuned/*.json`` format): unknown keys are rejected so a
        stale profile fails loudly instead of silently running
        reference constants."""
        params = dict(profile.get("params", profile))
        unknown = set(params) - set(cls.TUNABLE_PARAMS)
        if unknown:
            raise KeyError(
                f"profile carries unknown policy params "
                f"{sorted(unknown)}; tunable: {list(cls.TUNABLE_PARAMS)}")
        return cls(partition, **params)

    @classmethod
    def from_source(cls, partition: "Partition", source,
                    **params) -> "FeedbackPolicy":
        """Build a policy for a partition fed by a LIVE hwtelem counter
        source (``hwtelem.HwCounterSource``). Identical steering to the
        plain constructor — real counters flow through the same
        ``TelemetrySource`` protocol — but ``stale_after`` defaults
        from the ``hwtelem.stale_threshold`` knob (real ladders go
        quiet in ways the sim never does: a cgroup controller unmounts,
        perf fds die on cgroup migration), and the source is stashed
        for provenance so monitors can name the active tier. Raises if
        ``source`` is not the partition's telemetry source or the seam
        it wraps — a policy steering on counters from a DIFFERENT
        source than the one it reports would be the exact silent-sim
        confusion this plane exists to kill."""
        inner = getattr(partition.source, "inner", None)
        if partition.source is not source and inner is not source \
                and getattr(source, "inner", None) is not partition.source:
            raise ValueError(
                f"source {type(source).__name__} is not partition "
                f"{partition.name!r}'s telemetry source (nor wraps it)")
        params.setdefault("stale_after",
                          int(knobs.get("hwtelem.stale_threshold")))
        policy = cls(partition, **params)
        policy.hw_source = source
        return policy

    @classmethod
    def from_knobs(cls, partition: "Partition",
                   values: dict) -> "FeedbackPolicy":
        """Build a policy from registry-named knob values (the knob
        channel's snapshot surface) — the load path a
        tuned-profile-as-knob-file takes."""
        from pbs_tpu_torch.knobs import profile as knob_profile

        return cls(partition,
                   **knob_profile.knobs_to_params(cls.KNOB_POLICY,
                                                  values))

    def apply_knobs(self, values: dict) -> dict:
        """Atomic live reconfiguration from a knob push (KnobWatcher
        applier shape is ``lambda changed, _vals:
        policy.apply_knobs(changed)``). ``values`` is keyed by registry
        knob name; knobs outside this policy's mapping are ignored.

        Validate-then-apply: the whole update is checked (the channel
        already range-checked it; the band sanity re-check here guards
        direct callers), then every field lands — and every live job's
        slice plus the stale-fallback value are re-clamped into the
        new band immediately, so "tslice within the armed band" stays
        an invariant ACROSS a reconfiguration, not just between them.
        Returns the constructor-param view of what changed."""
        from pbs_tpu_torch.knobs import profile as knob_profile
        from pbs_tpu_torch.knobs.registry import KnobError

        params = knob_profile.knobs_to_params(self.KNOB_POLICY,
                                              values)
        params = {p: v for p, v in params.items()
                  if p in self.TUNABLE_PARAMS}
        if not params:
            return {}
        new_min = int(params.get("min_us", self.min_us))
        new_max = int(params.get("max_us", self.max_us))
        new_window = int(params.get("window", self.window_len))
        if new_min > new_max:
            raise KnobError(
                [f"tslice band inverted: min {new_min} > max "
                 f"{new_max} (push rejected, policy untouched)"])
        if new_window < 1:
            raise KnobError([f"window {new_window} < 1"])
        self.min_us, self.max_us = new_min, new_max
        # window_len moving resets each job's filter lazily: the next
        # _submilli_update sees the length mismatch, reallocates, and
        # restarts the fill — a band change never steers on a window
        # sampled under the old config's phase semantics.
        self.window_len = new_window
        if "stall_threshold" in params:
            self.stall_threshold = float(params["stall_threshold"])
        if "grow_step_us" in params:
            self.grow_step_us = int(params["grow_step_us"])
        if "shrink_sub_us" in params:
            self.shrink_sub_us = int(params["shrink_sub_us"])
        if "qdelay_threshold_ns" in params:
            self.qdelay_threshold_ns = int(params["qdelay_threshold_ns"])
        if "gw_hot_after" in params:
            self.gw_hot_after = int(params["gw_hot_after"])
        self.fallback_us = self._clamp(self.fallback_us)
        for job in self.partition.jobs:
            job.params.tslice_us = self._clamp(job.params.tslice_us)
        return params

    def state_of(self, job: "Job") -> JobMetricState:
        st = self.states.get(job.name)
        if st is None:
            st = self.states[job.name] = JobMetricState()
        return st

    # -- csched_metric_tick + csched_dom_metric_update -------------------

    def _metric_tick(self, now_ns: int) -> None:
        for job in self.partition.jobs:
            self._job_update(job)

    def _job_update(self, job: "Job") -> None:
        st = self.state_of(job)
        st.ticks += 1
        # One ndarray subtraction + in-place baseline refresh per
        # context into preallocated scratch (no per-tick allocation at
        # all), then a single int() per consumed counter.
        ctxs = job.contexts
        if not ctxs:
            return
        if len(ctxs) == 1:
            ctx = ctxs[0]
            tot = np.subtract(ctx.counters, ctx.prev_counters,
                              out=self._tot)
            ctx.prev_counters[:] = ctx.counters
        else:
            tot = self._tot
            tot[:] = 0
            delta = self._delta
            for ctx in ctxs:
                np.subtract(ctx.counters, ctx.prev_counters, out=delta)
                ctx.prev_counters[:] = ctx.counters
                np.add(tot, delta, out=tot)
        # One bulk tolist beats four numpy scalar extractions (the
        # IntEnum __index__ round trip per read adds up at tick rate).
        tl = tot.tolist()
        steps = tl[Counter.STEPS_RETIRED]
        dev_ns = tl[Counter.DEVICE_TIME_NS]
        stall_ns = tl[Counter.HBM_STALL_NS]
        coll_ns = tl[Counter.COLLECTIVE_WAIT_NS]
        if steps == 0 and dev_ns == 0:
            return  # job idle this tick — nothing to learn
        if steps > 0 and dev_ns == 0:
            # Steps retired but zero device time: the readout is dead
            # (progress is runtime-observed; device time is a counter
            # read — see telemetry.source._STALLABLE), so every rate
            # metric this tick would be garbage. Never steer on it.
            st.stale_ticks += 1
            if st.stale_ticks == self.stale_after:
                # Trip once per stall episode: park on the default band
                # value and forget the (now meaningless) window.
                st.wfill = 0
                st.fallbacks += 1
                job.params.tslice_us = self.fallback_us
            return
        st.stale_ticks = 0  # live counters again: resume steering
        # Rate metrics (csched_dom_metric_update, s_c.c:427-435).
        if dev_ns > 0:
            job.stall_rate = float(stall_ns) * 1000.0 / float(dev_ns)
        if steps > 0:
            job.nspi = float(dev_ns) / float(steps)
        self._submilli_update(job, st, float(coll_ns), steps)
        # Tick record for the sim trace (sim.trace): captures the
        # adaptation decision stream so live runs replay offline.
        rec = self.partition.recorder
        if rec is not None:
            rec.on_feedback(self.partition.clock.now_ns(), job, st)

    # -- gateway queue-delay channel (docs/GATEWAY.md) -------------------

    def note_queue_delay(self, job: "Job", wait_ns: int,
                         events: int = 1,
                         threshold_ns: int | None = None,
                         hot_after: int | None = None) -> None:
        """Serving-tier contention report from the gateway front door:
        ``wait_ns`` of interactive queue delay over ``events`` requests
        since the last report.

        Two effects, mirroring how spin latency reaches the policy:
        the raw wait rides the job's contention channel (the SAME
        submilli window ``report_contention`` feeds, so queue delay
        participates in phase detection like any other contention),
        and ``hot_after`` CONSECUTIVE over-threshold reports trigger
        the immediate response — shrink the slice (bound co-tenant
        latency now, not a window later) and arm wake-boost — the
        BOOST/tslice-shrink signal the gateway's SLO classes lean on.
        """
        if threshold_ns is None:
            threshold_ns = self.qdelay_threshold_ns
        if hot_after is None:
            hot_after = self.gw_hot_after
        job.report_contention(int(wait_ns), int(events))
        st = self.state_of(job)
        st.gw_reports += 1
        if events > 0 and wait_ns / events >= threshold_ns:
            st.gw_hot += 1
            if st.gw_hot >= max(1, int(hot_after)):
                st.gw_hot = 0
                st.gw_boosts += 1
                job.params.boost_on_wake = True
                self._shrink(job, st)
        else:
            st.gw_hot = 0

    # -- csched_submilli_metric_update (s_c.c:302-389) -------------------

    def _submilli_update(self, job: "Job", st: JobMetricState,
                         coll_wait_ns: float, steps: int) -> None:
        # Average contention latency per event this tick
        # (avg_spinlock = spinlock_metric_update / spinlock_count, :312).
        # In-band counter waits count one event per step (each step's
        # collectives are one batched measurement); out-of-band
        # report_contention carries its own event count. Normalizing per
        # event keeps the sample invariant to how many steps fit in a
        # tick — the reference gets this for free by dividing by the
        # contended-acquisition count.
        wait_ns, events = job.take_contention()
        total_wait = coll_wait_ns + wait_ns
        total_events = max(1, events + (steps if coll_wait_ns > 0 else 0))
        sample = total_wait / total_events

        w = st.window
        if w is None or len(w) != self.window_len:
            w = st.window = np.zeros(self.window_len, dtype=np.float64)
            st.wfill = 0
        if st.wfill < self.window_len:
            w[st.wfill] = sample
            st.wfill += 1
            if st.wfill < self.window_len:
                return
        else:
            # Full window: shift-in-place keeps arrival order (the
            # append+pop(0) semantics) with no allocation.
            w[:-1] = w[1:]
            w[-1] = sample

        mean = float(w.sum()) / self.window_len
        if mean > 0:
            # Tiny fixed-size window: a short Python loop over exact
            # float64 values beats three numpy broadcast kernels at
            # this size (same comparisons, same result, metric tick
            # runs every virtual millisecond for every job).
            lo = STABLE_LO * mean
            hi = STABLE_HI * mean
            stable = True
            for x in w.tolist():
                if x < lo or x > hi:
                    stable = False
                    break
        else:
            stable = True  # no contention at all is maximally stable

        if stable:
            if job.stall_rate >= self.stall_threshold:
                # Memory-bound steady phase: longer quanta amortize
                # switch cost (SPIN_LOW_PHASE, grow +100 µs, cap).
                st.phase = LOW_PHASE
                self._grow(job, st)
            else:
                # Compute/latency phase with steady contention: shrink to
                # bound co-tenant latency (SPIN_HIGH_PHASE).
                st.phase = HIGH_PHASE
                self._shrink(job, st)
        else:
            # Unstable window: reset; shrink if contention is rising
            # (s_c.c:374-384).
            rising = float(w[-1]) > mean
            st.wfill = 0
            st.resets += 1
            if rising:
                self._shrink(job, st)

    def _clamp(self, us: int) -> int:
        return max(self.min_us, min(self.max_us, us))

    def _grow(self, job: "Job", st: JobMetricState) -> None:
        new = self._clamp(job.params.tslice_us + self.grow_step_us)
        if new != job.params.tslice_us:
            st.grows += 1
        job.params.tslice_us = new

    def _shrink(self, job: "Job", st: JobMetricState) -> None:
        cur = job.params.tslice_us
        third = cur // 3
        new = third if third >= self.min_us else cur - self.shrink_sub_us
        # Both arms need the full clamp: a slice pushed above the cap
        # out-of-band (operator sched-credit -t, restore from an old
        # save) has cur//3 possibly still above max_us, so the old
        # floor-only max() let the slice sit outside the band for a
        # whole shrink cascade.
        new = self._clamp(new)
        if new != cur:
            st.shrinks += 1
        job.params.tslice_us = new

    # -- observability ---------------------------------------------------

    def dump(self) -> list[dict]:
        out = []
        for job in self.partition.jobs:
            st = self.state_of(job)
            out.append(
                {
                    "job": job.name,
                    "tslice_us": job.params.tslice_us,
                    "phase": st.phase,
                    "stall_rate": round(job.stall_rate, 2),
                    "nspi": round(job.nspi, 1),
                    "grows": st.grows,
                    "shrinks": st.shrinks,
                    "resets": st.resets,
                    "stale_ticks": st.stale_ticks,
                    "fallbacks": st.fallbacks,
                    "gw_boosts": st.gw_boosts,
                }
            )
        return out
