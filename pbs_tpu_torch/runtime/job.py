"""Jobs and execution contexts — the domain/vCPU analogs.

The port of ``pbs_tpu.runtime.job``. A ``Job`` is one tenant workload
(a PyTorch step function) with scheduling parameters (weight, cap, the
per-job adaptive time slice — ``csched_dom`` fields at
``sched_credit.c:204-219``) and accumulated contention telemetry. An
``ExecutionContext`` is one schedulable lane of a job, carrying the
per-context counter mirror (``vcpu->pmc[18]``) and ``sched_count``.

A device step cannot be preempted mid-kernel: the scheduling quantum is
realized as a number of steps, with the per-job time slice converted
through the job's measured step time.

Not ported yet (ROADMAP): ``Job.foreign`` (adopting a callable that
follows no protocol, which leans on XLA executables), the console
ring, the label and ``mem_bytes`` admission declarations, and paging.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable

import numpy as np

from pbs_tpu_torch.telemetry.counters import NUM_COUNTERS, Counter


class ContextState(enum.Enum):
    # Mirrors RUNSTATE_* (xen/include/public/vcpu.h) in spirit.
    RUNNABLE = "runnable"
    RUNNING = "running"
    BLOCKED = "blocked"  # sleeping; waits for wake()
    PARKED = "parked"  # cap exceeded (CSCHED_FLAG_VCPU_PARKED analog)
    DONE = "done"
    FAILED = "failed"  # contained fault (MCE-containment analog)


#: Default per-job slice in µs: CSCHED_DEFAULT_TSLICE_US
#: (sched_credit.c:52), the reference package's ``sched_credit_tslice_us``
#: boot-param default.
DEFAULT_TSLICE_US = 100


@dataclasses.dataclass
class SchedParams:
    """Per-job scheduling knobs (the ``xl sched-credit -w/-c/-t`` surface)."""

    weight: int = 256  # CSCHED_DEFAULT_WEIGHT (sched_credit.c)
    cap: int = 0  # percent of one executor; 0 = uncapped
    # Per-job time slice in µs; the feedback policy mutates this.
    tslice_us: int = DEFAULT_TSLICE_US
    # Latency-sensitive jobs get BOOST priority on wake (serving).
    boost_on_wake: bool = True


class Job:
    """One tenant workload.

    ``step_fn(state) -> state`` or ``(state, metrics_dict)`` advances
    the job by exactly one step. ``compiled`` optionally exposes
    ``cost_analysis()`` for the backend's static FLOP/byte estimate.
    For SimBackend jobs, ``step_fn`` may be ``None`` — the backend is
    the device.
    """

    def __init__(
        self,
        name: str,
        step_fn: Callable[[Any], Any] | None = None,
        state: Any = None,
        params: SchedParams | None = None,
        compiled: Any = None,
        max_steps: int | None = None,
        n_contexts: int = 1,
        gang: bool = False,
        micro_per_step: int = 1,
        micro_step_fn: Callable[[Any], Any] | None = None,
        n_programs: int = 1,
        est_compile_ns: int | None = None,
    ):
        self.name = name
        # Compile-cache admission declaration (runtime.compile_gate):
        # how many distinct programs this job brings (cache entries it
        # will occupy) and, optionally, the expected per-program
        # compile cost; undeclared costs are projected from the
        # observed fleet average.
        self.n_programs = max(1, int(n_programs))
        self.est_compile_ns = est_compile_ns
        self.step_fn = step_fn
        # Sub-step latency bounding: a job whose step is long may
        # decompose it into ``micro_per_step`` micro-steps advanced by
        # ``micro_step_fn`` (required when K > 1 on a real backend —
        # step_fn advances a FULL step); the executor then dispatches
        # in micro units and can deschedule mid-step at a chunk
        # boundary. The mid-step position lives in ctx.micro_progress.
        self.micro_per_step = max(1, int(micro_per_step))
        self.micro_step_fn = micro_step_fn
        self.state = state
        self.params = params or SchedParams()
        self.compiled = compiled
        self.max_steps = max_steps
        self.gang = gang and n_contexts > 1
        self.contexts: list[ExecutionContext] = [
            ExecutionContext(self, i) for i in range(n_contexts)
        ]
        # Contention channel accumulators (sdom->spinlock_latency /
        # spinlock_count, filled by do_vcrd_op sched_credit.c:249-259).
        self.contention_wait_ns: int = 0
        self.contention_events: int = 0
        # Metric outputs recomputed by the feedback policy
        # (sdom->cache_miss_rate / cpi, sched_credit.c:427-435).
        self.stall_rate: float = 0.0
        self.nspi: float = 0.0  # ns per step (CPI analog)
        # Set by Partition.fail_job when a fault is contained to this job.
        self.error: str | None = None
        # Scheduler-private per-job state hangs here (sched "domdata").
        self.sched_priv: Any = None
        # Measured-telemetry override: profile every N-th invocation of
        # THIS job regardless of the backend-wide default (None = use
        # the backend's).
        self.profile_every: int | None = None

    # -- contention hints (batched vcrd_op) ------------------------------

    def report_contention(self, wait_ns: int, events: int = 1) -> None:
        """Batched analog of the ``vcrd_op`` hypercall: time spent
        waiting on peers, consumed and cleared by the feedback policy's
        metric tick (sched_credit.c:302-389)."""
        self.contention_wait_ns += int(wait_ns)
        self.contention_events += int(events)

    def take_contention(self) -> tuple[int, int]:
        w, e = self.contention_wait_ns, self.contention_events
        self.contention_wait_ns = 0
        self.contention_events = 0
        return w, e

    # -- progress --------------------------------------------------------

    def steps_retired(self) -> int:
        return int(
            sum(int(c.counters[Counter.STEPS_RETIRED]) for c in self.contexts)
        )

    def finished(self) -> bool:
        if self.max_steps is None:
            return False
        return self.steps_retired() >= self.max_steps

    def __repr__(self) -> str:
        return f"Job({self.name!r}, w={self.params.weight}, cap={self.params.cap})"


class ExecutionContext:
    """One schedulable lane of a job (vCPU analog)."""

    def __init__(self, job: Job, index: int):
        self.job = job
        self.index = index
        self.state = ContextState.RUNNABLE
        # Counter mirror maintained by the executor at deschedule
        # (vcpu->pmc[], published by perfctr_cpu_vsuspend).
        self.counters = np.zeros(NUM_COUNTERS, dtype=np.uint64)
        # Feedback policy's last-seen values (csched_vcpu->prev_pmc).
        self.prev_counters = np.zeros(NUM_COUNTERS, dtype=np.uint64)
        # vcpu->sched_count analog.
        self.sched_count = 0
        # EWMA of step wall time, for quantum(ns) -> steps conversion.
        self.avg_step_ns: float = 1_000_000.0
        # Position within the current step in micro units
        # (0..job.micro_per_step-1); advanced by the telemetry source.
        self.micro_progress: int = 0
        # Assigned executor id (affinity pin; None = any).
        self.executor_hint: int | None = None
        # Ledger slot id, assigned by the partition at admission.
        self.ledger_slot: int = -1
        # Scheduler-private per-context state (sched "vdata").
        self.sched_priv: Any = None

    @property
    def name(self) -> str:
        return f"{self.job.name}/{self.index}"

    def runnable(self) -> bool:
        return self.state in (ContextState.RUNNABLE, ContextState.RUNNING)

    def observe_step_time(self, total_ns: int, n_steps: int) -> None:
        if n_steps <= 0 or total_ns <= 0:
            return
        per = total_ns / n_steps
        # EWMA alpha=0.25: smooth enough to ride one-off spikes, fast
        # enough to track phase changes at the 1 ms metric cadence.
        self.avg_step_ns = 0.75 * self.avg_step_ns + 0.25 * per

    def __repr__(self) -> str:
        return f"Ctx({self.name}, {self.state.value})"
