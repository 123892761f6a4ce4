"""Native sim dispatch core: marshalling for ``pbst_sim_run``.

The port of ``pbs_tpu.sim.native_core``, word for word of the state
block. The paper compiles perfctr straight into the hypervisor; this
module is the seam that lets the simulator do the analog — hand the
whole quantum loop (timer wheel, credit run-queue, per-context
accounting, workload phases, probe accumulators) to the C core in the
port's ``runtime/csrc/pbst_runtime.cc`` while the Python engine remains
the **equivalence witness**: the state block is marshalled FROM the
live engine objects after ``SimEngine`` construction and written BACK
into them after the run, so ``SimEngine._gather`` produces the metrics
report through the exact same Python code either way, and
``tests/test_torch_native_sim.py`` pins bit-identical reports and trace
digests across the python → ctypes → fastcall tiers, and against the
reference's own native core — the ``ListSchedulerProbe`` discipline
applied one layer down.

Determinism contract:

- **Jitter stream.** The C side consumes pre-drawn ``Generator.random``
  buffers produced by the engine's own per-job seeded generators
  (``SimBackend._rng_for``) — ``Generator.random(n)`` consumes the
  exact bit stream of n scalar draws, so pre-drawing a bounded buffer
  and consuming it sequentially in C reproduces the engine's stream
  bit-for-bit. Buffer sizes are hard-bounded by
  ``horizon / min_effective_step`` so the C loop can never run dry.
- **Arithmetic.** Every float64 expression in the C core mirrors the
  Python expression tree (including numpy's pairwise summation for the
  feedback stability window and round-half-even for quantum→steps);
  any divergence fails the digest gate, not a tolerance check.
- **Degradation.** Everything here is optional: ``unsupported_reason``
  names why a configuration (or host) can't ride the C core and the
  engine falls back to the pure-Python loop — toolchain-less hosts run
  the witness path and stay green.
"""

from __future__ import annotations

import numpy as np

from pbs_tpu_torch.runtime.job import ContextState

# -- layout mirrors (keep in lockstep with runtime/csrc/pbst_runtime.cc) ----

SIM_ABI_VERSION = 1

GS_WORDS = 28
(GS_N_JOBS, GS_UNTIL_NS, GS_POLICY, GS_NOW_NS, GS_NEXT_SEQ,
 GS_HEAP_LEN, GS_HEAP_CAP, GS_RUNQ_LEN, GS_SWITCHES, GS_LAST_PICK,
 GS_DISPATCHES, GS_SCHED_INVOC, GS_ACCT_PERIOD_US, GS_ACCT_COUNT,
 GS_TICK_NS, GS_WINDOW_LEN, GS_STALE_AFTER, GS_FALLBACK_US,
 GS_MIN_US, GS_MAX_US, GS_GROW_STEP_US, GS_SHRINK_SUB_US,
 GS_TIMELINE, GS_RECORD, GS_EV_LEN, GS_EV_CAP, GS_STATUS,
 GS_STATUS_ARG) = range(GS_WORDS)

GF_WORDS = 3
GF_CLIP, GF_CREDIT_TOTAL, GF_STALL_THRESHOLD = range(GF_WORDS)

JS_WORDS = 36
(J_WEIGHT, J_CAP, J_TSLICE_US, J_BOOST, J_STATE, J_PRI, J_PARKED,
 J_ACTIVE, J_SCHED_COUNT, J_STEPS_DONE, J_PH_OFF, J_N_PHASES,
 J_STEADY, J_PH_IDX, J_PH_LEFT, J_RNG_POS, J_RNG_LEN, J_ENQ_TS,
 J_ENQ_SET, J_WAIT_N, J_WAIT_CAP, J_DISPATCHES, J_QT_N, J_QT_CAP,
 J_LAST_Q, J_WFILL, J_PHASE, J_TICKS, J_GROWS, J_SHRINKS, J_RESETS,
 J_STALE_TICKS, J_FALLBACKS, J_HFILL, J_APPLIED_BUCKET,
 J_WAIT_ACC) = range(JS_WORDS)

JF_WORDS = 6
(JF_CREDIT, JF_SPENT_US, JF_AVG_STEP_NS, JF_STALL_RATE, JF_NSPI,
 JF_EWMA) = range(JF_WORDS)

PH_I_WORDS = 6
PH_F_WORDS = 2
HP_WORDS = 4
EV_WORDS = 14
TK_ACCT, TK_TICK, TK_WAKE, TK_SLEEP = range(4)
POL_CREDIT, POL_FEEDBACK, POL_ATC = range(3)
_NONE_BUCKET = np.iinfo(np.int64).min

_STATE_CODE = {
    ContextState.RUNNABLE: 0,
    ContextState.RUNNING: 1,
    ContextState.BLOCKED: 2,
    ContextState.PARKED: 3,
    ContextState.DONE: 4,
}
_CODE_STATE = {v: k for k, v in _STATE_CODE.items()}

#: Maximum feedback window the C core's numpy-pairwise summation
#: mirrors (numpy switches to recursive splitting above 128).
MAX_WINDOW = 128

MAX_STEPS_PER_QUANTUM = 1024

# Counter slots (telemetry/counters.py).
_C_STEPS, _C_DEV, _C_HBM, _C_STALL, _C_COLL = 0, 1, 2, 3, 4
_C_FLOPS, _C_TOKENS, _C_SCHED = 8, 16, 15
_NUM_COUNTERS = 18


def available_tier(want: str | None = None) -> str | None:
    """Best available binding tier for the sim core ("fastcall" >
    "ctypes"), or None. ``want`` restricts to one tier."""
    from pbs_tpu_torch.runtime import native

    lib = native.load()
    if lib is None:
        return None
    try:
        if int(lib.pbst_sim_abi()) != SIM_ABI_VERSION or \
                int(lib.pbst_sim_gs_words()) != GS_WORDS or \
                int(lib.pbst_sim_js_words()) != JS_WORDS or \
                int(lib.pbst_sim_jf_words()) != JF_WORDS or \
                int(lib.pbst_sim_ev_words()) != EV_WORDS:
            return None  # stale .so: degrade rather than misread state
    except AttributeError:
        return None
    if want in (None, "fastcall"):
        fc = native.fastcall()
        if fc is not None and hasattr(fc, "sim_run"):
            return "fastcall"
    if want == "fastcall":
        return None
    return "ctypes"


def stamp() -> dict:
    """{"native_available", "native_tier"} for result metadata (the
    ``pbst-torch tune``/``sim`` surfacing; kept OUTSIDE digest
    payloads)."""
    from pbs_tpu_torch.runtime import native

    tier = available_tier()
    out = {"native_available": tier is not None, "native_tier": tier}
    if tier is None:
        out["native_error"] = native.unavailable_reason() or \
            "sim core ABI mismatch (stale native library)"
    return out


def unsupported_reason(engine, tier: str | None = None) -> str | None:
    """Why this engine configuration can't ride the C core (None = it
    can). Anything unsupported degrades to the Python witness engine —
    this function IS the degradation contract."""
    from pbs_tpu_torch.faults import injector
    from pbs_tpu_torch.runtime import native
    from pbs_tpu_torch.sched.atc import AtcFeedbackPolicy
    from pbs_tpu_torch.sched.credit import CreditScheduler
    from pbs_tpu_torch.sched.feedback import FeedbackPolicy
    from pbs_tpu_torch.sim.engine import SchedulerProbe
    from pbs_tpu_torch.telemetry.source import SimBackend
    from pbs_tpu_torch.utils.clock import VirtualClock

    if available_tier(tier) is None:
        return (f"native runtime unavailable "
                f"({native.unavailable_reason() or 'sim tier missing'})")
    if injector._active is not None:
        return "fault injector active (native core has no fault seams)"
    if type(engine.probe) is not SchedulerProbe:
        return f"custom probe {type(engine.probe).__name__}"
    if type(engine.probe.inner) is not CreditScheduler:
        return f"scheduler {type(engine.probe.inner).__name__}"
    fb = engine.feedback
    if fb is not None and type(fb) not in (FeedbackPolicy,
                                           AtcFeedbackPolicy):
        return f"policy class {type(fb).__name__}"
    if fb is not None and fb.window_len > MAX_WINDOW:
        return f"window {fb.window_len} > {MAX_WINDOW}"
    part = engine.partition
    if len(part.executors) != 1:
        return f"{len(part.executors)} executors (native core is the " \
               "single-executor sweep configuration)"
    if not isinstance(engine.clock, VirtualClock):
        return "non-virtual clock"
    if part.memory is not None or part.compile_admission is not None:
        return "memory/compile admission armed"
    if getattr(part.sampler, "_samples", None):
        return "overflow samples armed"
    if type(engine.backend) is not SimBackend:
        return f"backend {type(engine.backend).__name__}"
    for job in engine.jobs:
        if len(job.contexts) != 1 or job.gang:
            return f"job {job.name!r}: multi-context/gang"
        if job.max_steps is not None:
            return f"job {job.name!r}: max_steps"
        if job.micro_per_step != 1:
            return f"job {job.name!r}: micro-step decomposition"
        if job.contexts[0].executor_hint is not None:
            return f"job {job.name!r}: pinned executor"
        if job.contention_wait_ns or job.contention_events:
            return f"job {job.name!r}: pre-seeded contention"
    for _, _, t in part.timers._heap:
        if t.dead:
            return f"dead timer {t.name!r} armed"
        if t.name not in ("csched_acct", "csched_metric_tick",
                          "sim_arrival"):
            return f"foreign timer {t.name!r} armed"
    return None


def _min_effective_step_ns(profile) -> int:
    """Lower bound on per-step clock advance across the profile's
    phases (jitter can shave up to ``jit`` off the base step time)."""
    lo = None
    for ph in profile.phases:
        base = max(1, int(ph.step_time_ns))
        if ph.jitter > 0.0:
            base = max(1, int(base * (1.0 - ph.jitter)) - 1)
        lo = base if lo is None else min(lo, base)
    return max(1, lo)


def _steps_bound(profile, horizon_ns: int) -> int:
    """Hard bound on steps one job can execute inside the horizon
    (+ one over-the-edge quantum): sizes the jitter stream and the
    probe accumulators so the C loop can never overflow them."""
    return (int(horizon_ns) // _min_effective_step_ns(profile)
            + MAX_STEPS_PER_QUANTUM + 16)


def _arrival_kind(timer) -> int:
    """wake vs sleep flip of a ``sim_arrival`` one-shot (the engine
    arms closures; the closed-over call name is the discriminator)."""
    names = timer.fn.__code__.co_names
    if "wake_job" in names:
        return TK_WAKE
    if "sleep_job" in names:
        return TK_SLEEP
    raise RuntimeError(f"unrecognized sim_arrival closure: {names}")


def run_native(engine, tier: str | None = None) -> str:
    """Run the engine's horizon on the C core and write the results
    back into the live engine objects (probe, contexts, policy state,
    recorder), so ``SimEngine._gather`` — the witness code path —
    produces the report. Returns the binding tier used."""
    from pbs_tpu_torch.runtime import native
    from pbs_tpu_torch.sched.atc import AtcFeedbackPolicy, AtcJobState
    from pbs_tpu_torch.sched.feedback import (
        HIGH_PHASE,
        LOW_PHASE,
        JobMetricState,
    )
    from pbs_tpu_torch.sim.engine import _TenantAcc

    used = available_tier(tier)
    if used is None:
        raise RuntimeError("native sim core unavailable")
    part = engine.partition
    probe = engine.probe
    sched = probe.inner
    backend = engine.backend
    jobs = engine.jobs
    n = len(jobs)
    job_idx = {j.name: k for k, j in enumerate(jobs)}
    ctx_idx = {id(j.contexts[0]): k for k, j in enumerate(jobs)}
    fb = engine.feedback
    recording = engine.recorder is not None

    policy = POL_CREDIT
    if fb is not None:
        policy = (POL_ATC if type(fb) is AtcFeedbackPolicy
                  else POL_FEEDBACK)
    wlen = fb.window_len if fb is not None else 1

    # -- global scalar/float blocks --------------------------------------
    gs = np.zeros(GS_WORDS, dtype=np.int64)
    gf = np.zeros(GF_WORDS, dtype=np.float64)
    gs[GS_N_JOBS] = n
    gs[GS_NOW_NS] = engine.clock.now_ns()
    gs[GS_UNTIL_NS] = engine._start_ns + engine.horizon_ns
    gs[GS_POLICY] = policy
    gs[GS_ACCT_PERIOD_US] = sched.acct_period_us
    gs[GS_ACCT_COUNT] = sched.acct_count
    gs[GS_WINDOW_LEN] = wlen
    gs[GS_LAST_PICK] = -1
    gs[GS_TIMELINE] = 1 if probe.timeline else 0
    gs[GS_RECORD] = 1 if recording else 0
    gf[GF_CLIP] = sched.credit_clip_factor * sched.acct_period_us
    gf[GF_CREDIT_TOTAL] = float(
        len(part.executors) * sched.acct_period_us)
    if fb is not None:
        gs[GS_TICK_NS] = fb.timer.period_ns
        gs[GS_STALE_AFTER] = fb.stale_after
        gs[GS_FALLBACK_US] = fb.fallback_us
        gs[GS_MIN_US] = fb.min_us
        gs[GS_MAX_US] = fb.max_us
        gs[GS_GROW_STEP_US] = fb.grow_step_us
        gs[GS_SHRINK_SUB_US] = fb.shrink_sub_us
        gf[GF_STALL_THRESHOLD] = fb.stall_threshold

    # -- phase tables -----------------------------------------------------
    ph_i_rows: list[list[int]] = []
    ph_f_rows: list[list[float]] = []
    js = np.zeros((n, JS_WORDS), dtype=np.int64)
    jf = np.zeros((n, JF_WORDS), dtype=np.float64)
    counters = np.zeros((n, _NUM_COUNTERS), dtype=np.uint64)
    prev = np.zeros((n, _NUM_COUNTERS), dtype=np.uint64)
    window = np.zeros((n, wlen), dtype=np.float64)
    hist = np.zeros((n, 4), dtype=np.int64)
    rng_bufs: list[np.ndarray] = []
    wt_bufs: list[np.ndarray] = []
    ww_bufs: list[np.ndarray] = []
    qt_bufs: list[np.ndarray] = []
    qq_bufs: list[np.ndarray] = []
    total_steps_bound = 0

    for k, job in enumerate(jobs):
        ctx = job.contexts[0]
        cc = ctx.sched_priv
        cj = job.sched_priv
        prof = backend._profiles[job.name]
        s = js[k]
        f = jf[k]
        s[J_WEIGHT] = job.params.weight
        s[J_CAP] = job.params.cap
        s[J_TSLICE_US] = job.params.tslice_us
        s[J_BOOST] = 1 if job.params.boost_on_wake else 0
        s[J_STATE] = _STATE_CODE[ctx.state]
        s[J_PRI] = cc.pri
        s[J_PARKED] = 1 if cc.parked else 0
        s[J_ACTIVE] = 1 if cj.active else 0
        s[J_SCHED_COUNT] = ctx.sched_count
        s[J_PH_OFF] = len(ph_i_rows)
        s[J_N_PHASES] = len(prof.phases)
        s[J_STEADY] = 1 if backend._steady[job.name] is not None else 0
        s[J_LAST_Q] = -1
        s[J_APPLIED_BUCKET] = _NONE_BUCKET
        f[JF_CREDIT] = cc.credit
        f[JF_AVG_STEP_NS] = ctx.avg_step_ns
        f[JF_STALL_RATE] = job.stall_rate
        f[JF_NSPI] = job.nspi
        for ph in prof.phases:
            ph_i_rows.append([int(ph.steps), int(ph.step_time_ns),
                              int(ph.hbm_bytes),
                              int(ph.collective_wait_ns), int(ph.flops),
                              int(ph.tokens)])
            ph_f_rows.append([float(ph.stall_frac), float(ph.jitter)])
        # Phase cursor from the backend's step position (0 for a fresh
        # engine; honors seek()).
        pos = backend._steps_done.get(job.name, 0)
        s[J_STEPS_DONE] = pos
        idx, left = 0, 0
        for idx, ph in enumerate(prof.phases):
            if ph.steps < 0 or pos < ph.steps:
                left = -1 if ph.steps < 0 else ph.steps - pos
                break
            pos -= ph.steps
        else:
            idx, left = len(prof.phases) - 1, -1
        s[J_PH_IDX] = idx
        s[J_PH_LEFT] = left
        # Probe enqueue stamp.
        enq = probe._enqueued.get(ctx)
        if enq is not None:
            s[J_ENQ_SET] = 1
            s[J_ENQ_TS] = int(enq)
        counters[k] = ctx.counters
        prev[k] = ctx.prev_counters
        # Hard-bounded accumulators + jitter stream.
        bound = _steps_bound(prof, engine.horizon_ns)
        total_steps_bound += bound
        draws = 2 * bound if any(ph.jitter > 0.0
                                 for ph in prof.phases) else 0
        rng = (backend._rng_for(job.name).random(draws) if draws
               else np.empty(0, dtype=np.float64))
        s[J_RNG_LEN] = draws
        rng_bufs.append(rng)
        wt_bufs.append(np.empty(bound, dtype=np.int64))
        ww_bufs.append(np.empty(bound, dtype=np.int64))
        s[J_WAIT_CAP] = bound
        qcap = bound if recording else 1
        qt_bufs.append(np.empty(qcap, dtype=np.int64))
        qq_bufs.append(np.empty(qcap, dtype=np.int64))
        s[J_QT_CAP] = qcap

    ph_i = np.asarray(ph_i_rows, dtype=np.int64).reshape(-1)
    ph_f = np.asarray(ph_f_rows, dtype=np.float64).reshape(-1)

    # -- timer heap (live TimerWheel state, arming order = seq order) ----
    heap_rows = []
    max_seq = -1
    for when, seq, t in part.timers._heap:
        max_seq = max(max_seq, seq)
        if t.name == "csched_acct":
            kind, arg = TK_ACCT, 0
        elif t.name == "csched_metric_tick":
            kind, arg = TK_TICK, 0
        else:
            kind = _arrival_kind(t)
            arg = job_idx[t.fn.__defaults__[0].name]
        heap_rows.append([int(when), int(seq), kind, arg])
    heap_cap = len(heap_rows) + 4
    heap = np.zeros((heap_cap, HP_WORDS), dtype=np.int64)
    if heap_rows:
        heap[:len(heap_rows)] = np.asarray(heap_rows, dtype=np.int64)
    gs[GS_HEAP_LEN] = len(heap_rows)
    gs[GS_HEAP_CAP] = heap_cap
    gs[GS_NEXT_SEQ] = max_seq + 1

    # -- run queue --------------------------------------------------------
    runq = np.zeros(max(1, n), dtype=np.int64)
    q = sched.runqs[0]
    for i, ctx in enumerate(q):
        runq[i] = ctx_idx[id(ctx)]
    gs[GS_RUNQ_LEN] = len(q)

    # -- event log (record mode) ------------------------------------------
    if recording:
        tick_ns = int(gs[GS_TICK_NS]) or 10**18
        ev_cap = (total_steps_bound
                  + (engine.horizon_ns // tick_ns + 2) * n + 16)
    else:
        ev_cap = 1
    ev = np.empty(ev_cap * EV_WORDS, dtype=np.int64)
    gs[GS_EV_CAP] = ev_cap

    # Pointer tables (u64 addresses of the per-job buffers; the numpy
    # arrays above stay referenced for the duration of the call).
    def _tab(bufs):
        return np.asarray([b.ctypes.data for b in bufs], dtype=np.uint64)

    rng_tab, wt_tab, ww_tab = _tab(rng_bufs), _tab(wt_bufs), _tab(ww_bufs)
    qt_tab, qq_tab = _tab(qt_bufs), _tab(qq_bufs)

    # -- the call ----------------------------------------------------------
    fc = native.fastcall() if used == "fastcall" else None
    if fc is not None:
        rc = int(fc.sim_run(
            gs, gf, js, jf, counters, prev, ph_i, ph_f, heap, runq,
            window, hist, rng_tab, wt_tab, ww_tab, qt_tab, qq_tab, ev))
    else:
        lib = native.load()
        if lib is None:  # raced unload/rebuild: degrade loudly
            raise RuntimeError("native sim core unavailable")
        rc = int(lib.pbst_sim_run(
            native.as_i64p(gs), native.as_f64p(gf),
            native.as_i64p(js.reshape(-1)), native.as_f64p(jf.reshape(-1)),
            native.as_u64p(counters.reshape(-1)),
            native.as_u64p(prev.reshape(-1)),
            native.as_i64p(ph_i), native.as_f64p(ph_f),
            native.as_i64p(heap.reshape(-1)), native.as_i64p(runq),
            native.as_f64p(window.reshape(-1)),
            native.as_i64p(hist.reshape(-1)),
            native.as_u64p(rng_tab), native.as_u64p(wt_tab),
            native.as_u64p(ww_tab), native.as_u64p(qt_tab),
            native.as_u64p(qq_tab), native.as_i64p(ev)))
    if rc != 0:
        raise RuntimeError(
            f"pbst_sim_run failed: status {rc} "
            f"(arg {int(gs[GS_STATUS_ARG])}) — capacity bounds are "
            "supposed to make this unreachable; please report")

    # -- write-back: the witness state the Python report reads ------------
    engine.clock.advance(int(gs[GS_NOW_NS]) - engine.clock.now_ns())
    ex = part.executors[0]
    ex.dispatch_count = int(gs[GS_DISPATCHES])
    ex.sched_invocations = int(gs[GS_SCHED_INVOC])
    part.progress_epoch += int(gs[GS_DISPATCHES])
    sched.acct_count = int(gs[GS_ACCT_COUNT])
    probe.switches = int(gs[GS_SWITCHES])
    probe._enqueued.clear()
    probe._last_pick.clear()
    sched.runqs[0] = [jobs[int(j)].contexts[0]
                      for j in runq[:int(gs[GS_RUNQ_LEN])]]

    for k, job in enumerate(jobs):
        ctx = job.contexts[0]
        s = js[k]
        f = jf[k]
        ctx.counters[:] = counters[k]
        ctx.prev_counters[:] = prev[k]
        ctx.sched_count = int(s[J_SCHED_COUNT])
        ctx.state = _CODE_STATE[int(s[J_STATE])]
        ctx.avg_step_ns = float(f[JF_AVG_STEP_NS])
        cc = ctx.sched_priv
        cc.credit = float(f[JF_CREDIT])
        cc.pri = int(s[J_PRI])
        cc.parked = bool(s[J_PARKED])
        cj = job.sched_priv
        cj.active = bool(s[J_ACTIVE])
        cj.spent_us = float(f[JF_SPENT_US])
        job.params.tslice_us = int(s[J_TSLICE_US])
        job.stall_rate = float(f[JF_STALL_RATE])
        job.nspi = float(f[JF_NSPI])
        backend._steps_done[job.name] = int(s[J_STEPS_DONE])
        if int(s[J_ENQ_SET]):
            probe._enqueued[ctx] = int(s[J_ENQ_TS])
        if int(s[J_DISPATCHES]):
            # The probe materializes a tenant accumulator on first
            # dispatch; mirror that so never-dispatched tenants look
            # identical to the witness.
            acc = _TenantAcc(cap=1)
            acc.t, acc.w = wt_bufs[k], ww_bufs[k]
            acc.n = int(s[J_WAIT_N])
            acc.dispatches = int(s[J_DISPATCHES])
            acc.qt, acc.qq = qt_bufs[k], qq_bufs[k]
            acc.qn = int(s[J_QT_N])
            acc.last_q = int(s[J_LAST_Q])
            probe._acc[job.name] = acc
        if fb is not None:
            st = fb.state_of(job)
            st.window = window[k].copy()
            st.wfill = int(s[J_WFILL])
            st.phase = HIGH_PHASE if int(s[J_PHASE]) else LOW_PHASE
            st.ticks = int(s[J_TICKS])
            st.grows = int(s[J_GROWS])
            st.shrinks = int(s[J_SHRINKS])
            st.resets = int(s[J_RESETS])
            st.stale_ticks = int(s[J_STALE_TICKS])
            st.fallbacks = int(s[J_FALLBACKS])
            if policy == POL_ATC:
                a = fb.atc[job.name] = AtcJobState()
                a.ewma_ns = float(f[JF_EWMA])
                a.history = hist[k].copy()
                a.hfill = int(s[J_HFILL])
                ab = int(s[J_APPLIED_BUCKET])
                a.applied_bucket = None if ab == _NONE_BUCKET else ab

    if recording:
        _replay_events(engine, jobs, ev, int(gs[GS_EV_LEN]))
    return used


def _replay_events(engine, jobs, ev: np.ndarray, n_ev: int) -> None:
    """Feed the C core's quantum/tick event log through the engine's
    ``TraceRecorder`` in emission order, reproducing the witness
    engine's JSONL byte stream (and therefore its digest)."""
    from pbs_tpu_torch.sched.feedback import HIGH_PHASE, LOW_PHASE

    rec = engine.recorder
    rows = ev[:n_ev * EV_WORDS].reshape(n_ev, EV_WORDS)
    deltas = np.zeros(_NUM_COUNTERS, dtype=np.uint64)
    for row in rows.tolist():
        if row[0] == 0:
            _, t0, end, q_ns, n_units, j, dev, hbm, stall, coll, \
                flops, steps, tokens = row[:13]
            deltas[:] = 0
            deltas[_C_STEPS] = steps
            deltas[_C_DEV] = dev
            deltas[_C_HBM] = hbm
            deltas[_C_STALL] = stall
            deltas[_C_COLL] = coll
            deltas[_C_FLOPS] = flops
            deltas[_C_TOKENS] = tokens
            deltas[_C_SCHED] = 1
            rec.on_quantum(0, jobs[j].contexts[0], q_ns, n_units,
                           deltas, t0, end)
        else:
            # Mirrors FeedbackPolicy._job_update's on_feedback record
            # field-for-field (sim/trace.py schema).
            _, t, j, phase, stall_x1000, nspi_x1000, tslice_us, \
                grows, shrinks, resets = row[:10]
            rec.emit({  # pbst: ignore[perf-emit-in-loop] -- witness replay: the JSONL recorder is fed record-by-record so the byte stream (and digest) matches the live engine's emission order
                "kind": "tick",
                "t": t,
                "job": jobs[j].name,
                "phase": HIGH_PHASE if phase else LOW_PHASE,
                "stall_x1000": stall_x1000,
                "nspi_x1000": nspi_x1000,
                "tslice_us": tslice_us,
                "grows": grows,
                "shrinks": shrinks,
                "resets": resets,
            })
