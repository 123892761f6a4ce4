"""Telemetry sources: who fills the per-job counter deltas.

The port of ``pbs_tpu.telemetry.source``. The ``TelemetrySource`` seam
is the reference's: a backend executes one quantum of a job's work and
reports counter deltas. Two backends:

- ``SimBackend`` — deterministic, host-only synthetic workloads, copied
  from the JAX package so a scheduling trace here is comparable, word
  for word, with one there.
- ``CudaBackend`` — real measurements on an NVIDIA GPU, the counterpart
  of ``TpuBackend``: step wall time closed by a device synchronise,
  measured per-kernel time from periodic ``torch.profiler`` samples
  (``profiler.py`` — the rdpmc-read analog) with a roofline HBM-stall
  estimate from a duck-typed ``cost_analysis()`` as the cold-start
  fallback, compile time (``nvcc`` runs a step triggered) split out of
  the runtime charge (``compile.py``), and the metrics a step function
  returns (instrumented kernels' own counters outrank the static
  estimate).

Both backends end every quantum at the ``telemetry.counters`` fault
seam (``apply_counter_faults``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Protocol

import numpy as np

from pbs_tpu_torch.faults import injector as _faults
from pbs_tpu_torch.obs import phases
from pbs_tpu_torch.telemetry.counters import NUM_COUNTERS, Counter
from pbs_tpu_torch.utils.clock import Clock, MonotonicClock, VirtualClock

#: Channels a ``telemetry.counters`` 'stall' fault freezes: the
#: PMC-grade measurements a dead readout stops delivering. Progress
#: counters (STEPS_RETIRED, TOKENS, YIELDS) are runtime-observed — the
#: job really ran — so a stalled readout must NOT erase progress; that
#: split is exactly what lets the feedback policy *detect* staleness
#: (steps advanced, device time didn't) and stop steering on it.
_STALLABLE = (Counter.DEVICE_TIME_NS, Counter.HBM_BYTES,
              Counter.HBM_STALL_NS, Counter.COLLECTIVE_WAIT_NS,
              Counter.DEVICE_FLOPS)

#: Channels a 'spike' fault multiplies: the noisy-counter adversity the
#: feedback policy's stability window must absorb — rate inputs only,
#: never progress.
_SPIKABLE = (Counter.HBM_STALL_NS, Counter.COLLECTIVE_WAIT_NS)

# Plain-int counter indices for the quantum hot loop: indexing numpy
# with an IntEnum pays an __index__ round trip per store.
_I_DEV = int(Counter.DEVICE_TIME_NS)
_I_HBM = int(Counter.HBM_BYTES)
_I_STALL = int(Counter.HBM_STALL_NS)
_I_COLL = int(Counter.COLLECTIVE_WAIT_NS)
_I_FLOPS = int(Counter.DEVICE_FLOPS)
_I_STEPS = int(Counter.STEPS_RETIRED)
_I_TOKENS = int(Counter.TOKENS)


def apply_counter_faults(job_name: str, deltas: np.ndarray) -> np.ndarray:
    """``telemetry.counters`` injection seam (stream key = job name),
    shared by every backend: consult once per execute call, mutate the
    delta vector in place. No injector installed = one global load."""
    f = _faults.consult("telemetry.counters", job_name)
    if f is None:
        return deltas
    if f.fault == "stall":
        for c in _STALLABLE:
            deltas[c] = 0
    elif f.fault == "spike":
        factor = float(f.args.get("factor", 10.0))
        for c in _SPIKABLE:
            deltas[c] = np.uint64(int(deltas[c]) * factor)
    return deltas


class TelemetrySource(Protocol):
    """Executes one quantum of a job's work and reports counter deltas."""

    clock: Clock

    def execute(self, ctx: Any, n_steps: int) -> np.ndarray:
        """Run ``n_steps`` steps of ``ctx.job`` and return u64 deltas
        (length NUM_COUNTERS)."""
        ...

    def execute_micro(self, ctx: Any, n_micro: int) -> np.ndarray:
        """Run ``n_micro`` micro-steps (1/``job.micro_per_step`` of a
        step each), advancing ``ctx.micro_progress`` and retiring a full
        step on each wrap."""
        ...


# ---------------------------------------------------------------------------
# Simulation backend
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SimPhase:
    """One behavioral phase of a synthetic workload.

    Lets tests reproduce the reference's phase transitions: e.g. a guest
    moving between cache-friendly and cache-thrashing phases, which the
    windowed filter at ``sched_credit.c:302-389`` must track.
    """

    steps: int  # phase length in steps (last phase may be -1 = forever)
    step_time_ns: int = 1_000_000  # device time per step
    hbm_bytes: int = 1 << 20
    stall_frac: float = 0.1  # fraction of step time stalled on HBM
    collective_wait_ns: int = 0  # spin-latency analog per step
    flops: int = 1 << 30
    tokens: int = 0
    # Relative half-width of per-step noise on step time and collective
    # wait (0.1 = ±10%). Drawn from the backend's own seeded Generator —
    # never module-level RNG state — so runs replay bit-for-bit.
    jitter: float = 0.0


@dataclasses.dataclass
class SimProfile:
    phases: list[SimPhase]

    def phase_at(self, step: int) -> SimPhase:
        s = step
        for ph in self.phases:
            if ph.steps < 0 or s < ph.steps:
                return ph
            s -= ph.steps
        return self.phases[-1]

    @staticmethod
    def steady(**kw) -> "SimProfile":
        return SimProfile([SimPhase(steps=-1, **kw)])


class SimBackend:
    """Deterministic synthetic telemetry; advances a VirtualClock.

    Jobs registered here need no real step function — the backend *is*
    the device. This is the CPU-CI substrate mandated by SURVEY.md §4.

    Every stochastic choice (phase jitter) routes through explicit
    seeded ``np.random.Generator``s — one per job, keyed (seed, job
    name) and advanced only by that job's own execution. Two backends
    built with the same seed produce byte-identical telemetry (the
    ``pbs_tpu.sim`` trace-digest determinism gate), and the noise a job
    experiences is a function of its own step sequence alone, not of
    scheduler dispatch order — so policy comparisons over the same
    (workload, seed) are noise-controlled.
    """

    def __init__(self, clock: VirtualClock | None = None, seed: int = 0):
        self.clock: VirtualClock = clock or VirtualClock()
        self.seed = int(seed)
        self._rngs: dict[str, np.random.Generator] = {}
        self._profiles: dict[str, SimProfile] = {}
        self._steps_done: dict[str, int] = {}
        # Single-infinite-phase profiles (most of the sim catalog)
        # resolved once at register time: the quantum hot loop then
        # skips the per-step phase_at() schedule walk.
        self._steady: dict[str, SimPhase | None] = {}

    def _rng_for(self, job_name: str) -> np.random.Generator:
        rng = self._rngs.get(job_name)
        if rng is None:
            import zlib

            rng = self._rngs[job_name] = np.random.default_rng(
                [self.seed, zlib.crc32(job_name.encode())])
        return rng

    @staticmethod
    def _jittered(rng: np.random.Generator, value: int,
                  jitter: float) -> int:
        """±jitter noise on ``value`` via the job's seeded Generator."""
        if jitter <= 0.0 or value <= 0:
            return value
        return max(1, int(value * (1.0 + jitter * (2.0 * rng.random() - 1.0))))

    def register(self, job_name: str, profile: SimProfile) -> None:
        self._profiles[job_name] = profile
        self._steps_done[job_name] = 0  # fresh phase schedule per register
        phases = profile.phases
        self._steady[job_name] = (
            phases[0] if len(phases) == 1 and phases[0].steps < 0 else None)

    def seek(self, job_name: str, steps_done: int) -> None:
        """Reposition the phase schedule — migration restore lands a job
        mid-profile instead of replaying it from phase zero."""
        self._steps_done[job_name] = int(steps_done)

    def position(self, job_name: str) -> int:
        """Current phase-schedule cursor (the save-side peer of
        :meth:`seek`)."""
        return self._steps_done.get(job_name, 0)

    def _charge_phase(self, deltas: np.ndarray, ph: SimPhase,
                      k: int, rng: np.random.Generator) -> int:
        """Advance the clock by 1/k of the phase's step and charge the
        proportional traffic; returns the advanced nanoseconds."""
        t = self._jittered(rng, max(1, ph.step_time_ns // k), ph.jitter)
        self.clock.advance(t)
        deltas[Counter.DEVICE_TIME_NS] += t
        deltas[Counter.HBM_BYTES] += ph.hbm_bytes // k
        deltas[Counter.HBM_STALL_NS] += int(t * ph.stall_frac)
        deltas[Counter.COLLECTIVE_WAIT_NS] += self._jittered(
            rng, ph.collective_wait_ns // k, ph.jitter)
        deltas[Counter.DEVICE_FLOPS] += ph.flops // k
        return t

    def execute(self, ctx: Any, n_steps: int) -> np.ndarray:
        # The quantum hot loop:
        # accumulate in plain Python ints and store each counter ONCE
        # per quantum instead of paying a numpy scalar read-modify-write
        # per counter per step. RNG draw order (step-time draw, then
        # collective draw iff wait>0 — exactly _jittered's skip rule)
        # and all integer rounding match _charge_phase bit-for-bit, so
        # trace digests and golden chaos digests are unchanged.
        name = ctx.job.name
        rng = self._rngs.get(name)
        if rng is None:
            rng = self._rng_for(name)
        random = rng.random
        step = self._steps_done[name]
        steady = self._steady[name]
        t_tot = hbm = stall = coll = flops = tokens = 0
        if steady is not None:
            # Steady single-phase tenant (most of the catalog): phase
            # fields resolve to locals once per quantum, and the
            # per-step loop specializes on (jitter, collective) so it
            # draws exactly the randoms _jittered would — stream and
            # rounding identical to the general path below.
            base = steady.step_time_ns
            if base < 1:
                base = 1
            jit = steady.jitter
            frac = steady.stall_frac
            cw = steady.collective_wait_ns
            hbm = steady.hbm_bytes * n_steps
            flops = steady.flops * n_steps
            tokens = steady.tokens * n_steps
            if jit > 0.0:
                if n_steps >= 8:
                    # Long quantum: one batched draw + vectorized
                    # jitter. Generator.random(n) consumes the exact
                    # bit stream of n scalar random() calls (pinned by
                    # tests/test_sim_trace.py digests), and every
                    # float64 op below mirrors the scalar expression
                    # tree, so totals are bit-identical.
                    if cw > 0:
                        r = random(2 * n_steps)
                        rt, rc = r[0::2], r[1::2]
                    else:
                        rt, rc = random(n_steps), None
                    t = (base * (1.0 + jit * (2.0 * rt - 1.0))) \
                        .astype(np.int64)
                    np.maximum(t, 1, out=t)
                    t_tot = int(t.sum())
                    stall = int((t * frac).astype(np.int64).sum())
                    if rc is not None:
                        c = (cw * (1.0 + jit * (2.0 * rc - 1.0))) \
                            .astype(np.int64)
                        np.maximum(c, 1, out=c)
                        coll = int(c.sum())
                elif cw > 0:
                    for _ in range(n_steps):
                        t = int(base * (1.0 + jit * (2.0 * random() - 1.0)))
                        if t < 1:
                            t = 1
                        c = int(cw * (1.0 + jit * (2.0 * random() - 1.0)))
                        if c < 1:
                            c = 1
                        t_tot += t
                        stall += int(t * frac)
                        coll += c
                else:
                    for _ in range(n_steps):
                        t = int(base * (1.0 + jit * (2.0 * random() - 1.0)))
                        if t < 1:
                            t = 1
                        t_tot += t
                        stall += int(t * frac)
            else:
                t_tot = base * n_steps
                stall = int(base * frac) * n_steps
                coll = cw * n_steps
            step += n_steps
        else:
            prof = self._profiles[name]
            for _ in range(n_steps):
                ph = prof.phase_at(step)
                jit = ph.jitter
                t = ph.step_time_ns
                if t < 1:
                    t = 1
                if jit > 0.0:
                    t = int(t * (1.0 + jit * (2.0 * random() - 1.0)))
                    if t < 1:
                        t = 1
                c = ph.collective_wait_ns
                if c > 0 and jit > 0.0:
                    c = int(c * (1.0 + jit * (2.0 * random() - 1.0)))
                    if c < 1:
                        c = 1
                t_tot += t
                hbm += ph.hbm_bytes
                stall += int(t * ph.stall_frac)
                coll += c
                flops += ph.flops
                tokens += ph.tokens
                step += 1
        self._steps_done[name] = step
        self.clock.advance(t_tot)
        deltas = np.zeros(NUM_COUNTERS, dtype=np.uint64)
        deltas[_I_DEV] = t_tot
        deltas[_I_HBM] = hbm
        deltas[_I_STALL] = stall
        deltas[_I_COLL] = coll
        deltas[_I_FLOPS] = flops
        deltas[_I_STEPS] = n_steps
        deltas[_I_TOKENS] = tokens
        if _faults._active is not None:
            return apply_counter_faults(name, deltas)
        return deltas

    def execute_micro(self, ctx: Any, n_micro: int) -> np.ndarray:
        """Micro-step execution: each unit burns 1/K of the phase's step
        time and traffic; a step retires (and its tokens land) when the
        micro cursor wraps. Ending a quantum mid-step records a YIELD —
        the voluntary early exit the latency bound relies on."""
        name = ctx.job.name
        K = ctx.job.micro_per_step
        prof = self._profiles[name]
        rng = self._rng_for(name)
        deltas = np.zeros(NUM_COUNTERS, dtype=np.uint64)
        for _ in range(n_micro):
            step = self._steps_done[name]
            ph = prof.phase_at(step)
            self._charge_phase(deltas, ph, K, rng)
            ctx.micro_progress += 1
            if ctx.micro_progress >= K:
                ctx.micro_progress = 0
                deltas[Counter.STEPS_RETIRED] += 1
                deltas[Counter.TOKENS] += ph.tokens
                self._steps_done[name] = step + 1
        if ctx.micro_progress:
            deltas[Counter.YIELDS] += 1
        return apply_counter_faults(name, deltas)


# ---------------------------------------------------------------------------
# CUDA backend
# ---------------------------------------------------------------------------

#: Roofline peaks of one NVIDIA H100 SXM (NVIDIA data sheet, dense rates
#: at the 700 W limit): bf16 tensor-core FLOP/s and HBM3 bytes/s.
H100_PEAK_FLOPS = 989e12
H100_PEAK_HBM_BW = 3.35e12


def cost_analysis_of(compiled) -> tuple[int, int]:
    """(flops, hbm_bytes) from an object exposing ``cost_analysis()``
    (a dict, or a list of dicts, with "flops" and "bytes accessed"
    keys), best-effort: anything else reads as (0, 0)."""
    try:
        ca = compiled.cost_analysis()
        if isinstance(ca, (list, tuple)):
            ca = ca[0] if ca else {}
        flops = int(ca.get("flops", 0.0))
        nbytes = int(ca.get("bytes accessed", 0.0))
        return flops, nbytes
    except Exception:
        return 0, 0


class CountedCost:
    """The cost of one counted invocation of a foreign callable: what
    the port has in place of the reference's XLA executable. Its
    ``cost_analysis()`` answers in XLA's keys, so
    :func:`cost_analysis_of` reads it as it reads any other."""

    def __init__(self, flops: int, nbytes: int, n_ops: int):
        self.flops = int(flops)
        self.nbytes = int(nbytes)
        self.n_ops = int(n_ops)

    def cost_analysis(self) -> dict:
        return {"flops": float(self.flops),
                "bytes accessed": float(self.nbytes)}

    def __repr__(self) -> str:
        return (f"CountedCost(flops={self.flops}, bytes={self.nbytes}, "
                f"ops={self.n_ops})")


#: The front-end compile event a counted invocation reports its wall
#: time as (``telemetry.compile.FRONTEND_EVENTS``).
HARVEST_EVENT = "/pbs_tpu_torch/telemetry/cost_harvest_duration"


def _byte_counter():
    """A ``TorchDispatchMode`` that adds the bytes of every aten op's
    tensor inputs and outputs — the analog of XLA's "bytes accessed".
    Views move no data and allocations read none, so neither counts;
    an in-place op reads and writes its operand and counts both."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class ByteCounter(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.nbytes = 0
            self.n_ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            self.n_ops += 1
            aliased = [r.alias_info for r in func._schema.returns
                       if r.alias_info is not None]
            if aliased and not any(a.is_write for a in aliased):
                return out  # a view: no data moved
            ins = [t for t in tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            if not ins and func._schema.name.split("::")[-1].startswith(
                    ("empty", "new_empty")):
                return out  # an allocation writes nothing
            for t in ins + [t for t in tree_leaves(out)
                            if isinstance(t, torch.Tensor)]:
                self.nbytes += t.numel() * t.element_size()
            return out

    return ByteCounter()


def count_invocation(fn: Callable[..., Any], args: tuple, kwargs: dict,
                     sync: Callable[[], None] | None = None
                     ) -> CountedCost | None:
    """Run ``fn(*args, **kwargs)`` once under
    ``torch.utils.flop_counter.FlopCounterMode`` (FLOPs) and a byte
    counter (:func:`_byte_counter`), synchronise, throw the outputs away
    and return the counted cost; None when the invocation runs no aten
    op (nothing was counted). What the invocation raises propagates.

    Kernels launched through ``ctypes`` with raw ``data_ptr``s — the
    port's four (``ops/attention.py``, ``ops/matmul.py``) — bypass the
    dispatcher, so their FLOPs and bytes are not counted; the
    reference's ``pallas_call``s carry no ``cost_estimate`` and XLA
    counts none for them either."""
    from torch.utils.flop_counter import FlopCounterMode

    bytes_mode = _byte_counter()
    with FlopCounterMode(display=False) as flops_mode, bytes_mode:
        out = fn(*args, **kwargs)
        del out
    if sync is not None:
        sync()
    if bytes_mode.n_ops == 0:
        return None
    return CountedCost(flops_mode.get_total_flops(), bytes_mode.nbytes,
                       bytes_mode.n_ops)


class CudaBackend:
    """Measures real PyTorch jobs on a CUDA device: wall time closed by
    ``torch.cuda.synchronize`` + static cost estimate + step metrics.

    A job's ``step_fn(state) -> state`` may instead return
    ``(state, metrics)`` where ``metrics`` is a dict of scalars:
    ``device_flops``/``hbm_bytes`` (an instrumented kernel's own
    counts) outrank the static estimate, and the ``_METRIC_KEYS``
    (collective wait, gang skew, tokens, draft proposals) land in their
    counters.

    ``profile_every=N`` runs every N-th invocation of each job under a
    ``TorchQuantumProfiler`` (``profiler=`` injects another one); the
    measured stall fraction of the latest sample then sets
    HBM_STALL_NS, and the roofline estimate serves only before a job's
    first sample. 0 = roofline estimate only.

    A foreign tenant (``Job.foreign``) has its FLOPs and bytes harvested
    from one counted invocation (:func:`count_invocation`) before its
    first quantum; the result, a :class:`CountedCost`, becomes
    ``job.compiled``.

    ``device`` defaults to ``cuda``; with no card that raises rather
    than measuring the CPU under a device metric's name. The tests pass
    ``device="cpu"``, which times the host, skips the synchronise and
    profiles the host's ops.
    """

    def __init__(
        self,
        clock: Clock | None = None,
        peak_flops: float = H100_PEAK_FLOPS,
        peak_hbm_bw: float = H100_PEAK_HBM_BW,
        profile_every: int = 0,
        profiler=None,
        device: Any = None,
    ):
        import torch

        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "CudaBackend: no CUDA device is available; pass "
                "device='cpu' explicitly to time host-side steps")
        self._sync: Callable[[], None] | None = (
            (lambda: torch.cuda.synchronize(self.device))
            if self.device.type == "cuda" else None)
        self.clock = clock or MonotonicClock()
        self.peak_flops = peak_flops
        self.peak_hbm_bw = peak_hbm_bw
        # per-job (flops, bytes) from cost analysis, captured at first run
        self._costs: dict[str, tuple[int, int]] = {}
        # job name -> (compiles, compile_ns) of a foreign tenant's
        # counted invocation, charged with its first quantum
        self._harvest: dict[str, tuple[int, int]] = {}
        # job name -> why its counted invocation harvested nothing
        self.harvest_errors: dict[str, str] = {}
        # Measured-telemetry sampling: every N-th invocation per job runs
        # under the profiler; the parsed per-kernel time fills the stall/
        # collective counters and its fractions carry forward until the
        # next sample. 0 = roofline-estimate only.
        self.profile_every = int(profile_every)
        if profiler is None and self.profile_every > 0:
            from pbs_tpu_torch.telemetry.profiler import TorchQuantumProfiler

            profiler = TorchQuantumProfiler(self.device)
        self.profiler = profiler
        self._measured: dict[str, Any] = {}  # job name -> TraceStats
        self._since_profile: dict[str, int] = {}
        # job name -> [samples, runtime ns charged for the sampled
        # invocations, the profiler's own ns around them (not charged)]
        self.profile_cost: dict[str, list[int]] = {}
        # Per-job compile attribution (telemetry.compile): every
        # invocation runs in the job's attribution scope, so a kernel
        # build its first call triggers lands in ITS ledger slots.
        from pbs_tpu_torch.telemetry.compile import CompileMeter

        self.compile_meter = CompileMeter.install()

    def _job_cost(self, job) -> tuple[int, int]:
        c = self._costs.get(job.name)
        if c is None:
            compiled = getattr(job, "compiled", None)
            if compiled is None and getattr(job, "_foreign_spec", None):
                # Foreign tenant (Job.foreign): harvest its cost without
                # the workload's help — the MSR-interception analog
                # (vpmu_core2.c:367-418 reads the guest's counter MSRs;
                # here one counted invocation reads its ops). The port
                # has no executable to lower and compile as the
                # reference does: the invocation's wall time is its
                # front-end compile event, in the job's COMPILE_* slots
                # and never its DEVICE_TIME_NS.
                # An invocation that raises or runs no aten op leaves
                # ``compiled`` None (the reference's "not a jit stage"):
                # the profiler alone measures the tenant, and
                # ``harvest_errors`` says why.
                fn, a, k = job._foreign_spec
                t0 = time.monotonic_ns()
                with self.compile_meter.attribute(job.name):
                    try:
                        compiled = count_invocation(fn, a, k,
                                                    sync=self._sync)
                    except Exception as e:  # noqa: BLE001 — the tenant's
                        compiled = None
                        self.harvest_errors[job.name] = (
                            f"{type(e).__name__}: {e}")
                    self.compile_meter._on_event(
                        HARVEST_EVENT, (time.monotonic_ns() - t0) / 1e9)
                job.compiled = compiled
                # Drained here and added to the quantum by execute: left
                # pending, the first step's take() would subtract the
                # harvest from that step's own wall time.
                self._harvest[job.name] = self.compile_meter.take(job.name)
            c = cost_analysis_of(compiled) if compiled is not None else (0, 0)
            self._costs[job.name] = c
        return c

    def _take_harvest(self, job, deltas: np.ndarray) -> None:
        n_c, c_ns = self._harvest.pop(job.name, (0, 0))
        deltas[Counter.COMPILES] += n_c
        deltas[Counter.COMPILE_TIME_NS] += c_ns

    _METRIC_KEYS = (
        ("collective_wait_ns", Counter.COLLECTIVE_WAIT_NS),
        ("gang_skew_ns", Counter.GANG_SKEW_NS),
        ("tokens", Counter.TOKENS),
        ("spec_proposed", Counter.SPEC_PROPOSED),
    )

    def measured(self, job_name: str):
        """Latest measured TraceStats for a job (None before the first
        profiler sample, or with profiling disabled)."""
        return self._measured.get(job_name)

    def _profile_due(self, job) -> bool:
        # Per-job override first (a tenant can carry its own sampling
        # period and get measured phases even when the backend-wide
        # default is roofline-only).
        every = getattr(job, "profile_every", None) or self.profile_every
        if not every:
            return False
        if self.profiler is None:
            from pbs_tpu_torch.telemetry.profiler import TorchQuantumProfiler

            self.profiler = TorchQuantumProfiler(self.device)
        k = self._since_profile.get(job.name, every)
        due = k >= every  # first invocation profiles
        self._since_profile[job.name] = 1 if due else k + 1
        return due

    def _invoke(self, job, fn) -> tuple[int, dict, int, int]:
        """Run one host-callable unit; returns (run_ns, metrics,
        n_compiles, compile_ns). The wall time closes on a device
        synchronise (the ``block_until_ready`` of the JAX backend), so
        it covers the kernels the step queued — and, on a sampled
        invocation, the synchronise sits inside the profiler session,
        so the quantum's kernels are in its trace. Compilation time is
        split OUT of the runtime charge: a tenant's first-call kernel
        build (seconds of ``nvcc``) billed as device time would sink it
        into deep credit debt and starve it for the equivalent share —
        compile spend is tracked in its own counters and governed by
        the admission budget (runtime/compile_gate.py). The profiler's
        own time around a sampled invocation (session start and stop,
        trace export and parse) is split out the same way, into
        ``profile_cost``: billed as device time it would inflate the
        sampled tenant's charge by the size of its trace."""

        def run():
            out = fn(job.state)
            metrics: dict[str, Any] = {}
            if (isinstance(out, tuple) and len(out) == 2
                    and isinstance(out[1], dict)):
                st, metrics = out
            else:
                st = out
            if self._sync is not None:
                with phases.span("backend.sync"):
                    self._sync()
            return st, metrics

        t0 = time.monotonic_ns()
        sampled, prof_ns = False, 0
        with self.compile_meter.attribute(job.name):
            if self._profile_due(job):
                (job.state, metrics), stats = self.profiler.profile(run)
                sampled = True
                prof_ns = getattr(self.profiler, "last_overhead_ns", 0)
                if stats is not None and stats.n_ops:
                    self._measured[job.name] = stats
            else:
                job.state, metrics = run()
        dt = time.monotonic_ns() - t0
        n_c, c_ns = self.compile_meter.take(job.name)
        run_ns = max(0, dt - prof_ns - c_ns)
        if sampled:
            cost = self.profile_cost.setdefault(job.name, [0, 0, 0])
            cost[0] += 1
            cost[1] += run_ns
            cost[2] += prof_ns
        return run_ns, metrics, n_c, c_ns

    def _charge(self, deltas: np.ndarray, dt: int, flops: int,
                nbytes: int, metrics: dict, measured=None) -> None:
        # In-graph instrumented kernels (ops.matmul emits its own tile/
        # byte counters, PMC-style) outrank the static cost-analysis
        # estimate for the same quantity.
        flops = int(metrics.get("device_flops", flops))
        nbytes = int(metrics.get("hbm_bytes", nbytes))
        deltas[Counter.DEVICE_TIME_NS] += dt
        deltas[Counter.HBM_BYTES] += nbytes
        deltas[Counter.DEVICE_FLOPS] += flops
        if measured is not None and measured.n_ops:
            # Measured path (the rdpmc analog): fractions from the latest
            # profiler sample apply to this quantum's wall time — stall
            # tracks what the kernels actually did, so phase changes show
            # up without waiting for the next sample's absolute numbers.
            deltas[Counter.HBM_STALL_NS] += int(dt * measured.stall_frac)
            if "collective_wait_ns" not in metrics and measured.collective_ns:
                deltas[Counter.COLLECTIVE_WAIT_NS] += int(
                    dt * measured.collective_frac)
        elif flops or nbytes:
            # Roofline stall estimate: fraction of the step the program
            # was memory-bound, against this card's peaks.
            t_mem = nbytes / self.peak_hbm_bw
            t_flop = flops / self.peak_flops
            frac = t_mem / (t_mem + t_flop) if (t_mem + t_flop) > 0 else 0.0
            deltas[Counter.HBM_STALL_NS] += int(dt * frac)
        for key, ctr in self._METRIC_KEYS:
            if key in metrics:
                deltas[ctr] += np.uint64(max(0, int(metrics[key])))

    def execute(self, ctx: Any, n_steps: int) -> np.ndarray:
        job = ctx.job
        deltas = np.zeros(NUM_COUNTERS, dtype=np.uint64)
        flops, nbytes = self._job_cost(job)
        self._take_harvest(job, deltas)
        for _ in range(n_steps):
            dt, metrics, n_c, c_ns = self._invoke(job, job.step_fn)
            self._charge(deltas, dt, flops, nbytes, metrics,
                         measured=self._measured.get(job.name))
            deltas[Counter.COMPILES] += n_c
            deltas[Counter.COMPILE_TIME_NS] += c_ns
            deltas[Counter.STEPS_RETIRED] += 1
        return apply_counter_faults(job.name, deltas)

    def execute_micro(self, ctx: Any, n_micro: int) -> np.ndarray:
        """Chunked execution of a long-step job: each call to
        ``micro_step_fn`` advances one chunk; the host checks between
        chunks whether the quantum is spent. A full step (and its
        static FLOPs/bytes) retires when the micro cursor wraps."""
        job = ctx.job
        K = job.micro_per_step
        fn = job.micro_step_fn
        if fn is None:
            # step_fn advances a FULL step; silently substituting it
            # would run K real steps per retired step and mischarge
            # FLOPs/HBM by 1/K.
            raise ValueError(
                f"job {job.name!r} has micro_per_step={K} but no "
                "micro_step_fn; provide a chunk-sized step")
        deltas = np.zeros(NUM_COUNTERS, dtype=np.uint64)
        flops, nbytes = self._job_cost(job)
        self._take_harvest(job, deltas)
        for _ in range(n_micro):
            dt, metrics, n_c, c_ns = self._invoke(job, fn)
            self._charge(deltas, dt, flops // K, nbytes // K, metrics,
                         measured=self._measured.get(job.name))
            deltas[Counter.COMPILES] += n_c
            deltas[Counter.COMPILE_TIME_NS] += c_ns
            ctx.micro_progress += 1
            if ctx.micro_progress >= K:
                ctx.micro_progress = 0
                deltas[Counter.STEPS_RETIRED] += 1
        if ctx.micro_progress:
            deltas[Counter.YIELDS] += 1
        return apply_counter_faults(job.name, deltas)
