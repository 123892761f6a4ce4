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

Each job carries its console ring (``Job.log`` is the guest printk),
its security label, its declared HBM working set (``mem_bytes``, which
the partition's memory admission claims) and the paging fields the
pager (``runtime.paging``) fills while its state lives in host memory.
The partition's xsm checks read the label. ``Job.foreign`` adopts a
callable that follows no protocol (the HVM vPMU analog).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable

import numpy as np

from pbs_tpu_torch.obs.console import Console
from pbs_tpu_torch.telemetry.counters import NUM_COUNTERS, Counter
from pbs_tpu_torch.utils.params import integer_param


class ContextState(enum.Enum):
    # Mirrors RUNSTATE_* (xen/include/public/vcpu.h) in spirit.
    RUNNABLE = "runnable"
    RUNNING = "running"
    BLOCKED = "blocked"  # sleeping; waits for wake()
    PARKED = "parked"  # cap exceeded (CSCHED_FLAG_VCPU_PARKED analog)
    DONE = "done"
    FAILED = "failed"  # contained fault (MCE-containment analog)


# Boot-param analog of ``sched_credit_tslice_us=`` (sched_credit.c:126-127):
# overrides the default per-job slice for jobs that don't set one.
_tslice_param = integer_param("sched_credit_tslice_us", 100)


@dataclasses.dataclass
class SchedParams:
    """Per-job scheduling knobs (the ``xl sched-credit -w/-c/-t`` surface)."""

    weight: int = 256  # CSCHED_DEFAULT_WEIGHT (sched_credit.c)
    cap: int = 0  # percent of one executor; 0 = uncapped
    # Per-job time slice in µs; the feedback policy mutates this.
    # CSCHED_DEFAULT_TSLICE_US = 100 (sched_credit.c:52).
    tslice_us: int = dataclasses.field(
        default_factory=lambda: _tslice_param.value)
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
        label: str = "user",
        mem_bytes: int | None = None,
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
        # Security label for XSM checks (the FLASK domain label).
        self.label = label
        # Declared HBM working set; None = estimate from state at
        # admission (runtime.memory.nbytes_of).
        self.mem_bytes = mem_bytes
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
        # the backend's). Foreign tenants set this so they get measured
        # phases without cooperating (the HVM vPMU analog).
        self.profile_every: int | None = None
        # (fn, args, kwargs) of a foreign callable adopted via
        # Job.foreign — lets the backend harvest its cost from one
        # counted invocation, attributed to this job.
        self._foreign_spec: tuple | None = None
        # Per-job console ring (the xl console analog): lifecycle
        # events land here; the workload writes via Job.log.
        self.console = Console()
        # xenpaging analog (runtime.paging): while non-None, the
        # device leaves of ``state`` live in host memory and the job
        # must stay BLOCKED; wake_job restores transparently.
        self.paged = None
        self.paged_bytes = 0
        self.paged_acct_bytes = 0

    @classmethod
    def foreign(
        cls,
        name: str,
        fn: Callable[..., Any],
        *call_args: Any,
        params: "SchedParams | None" = None,
        max_steps: int | None = None,
        profile_every: int = 8,
        **call_kwargs: Any,
    ) -> "Job":
        """Adopt an arbitrary PyTorch callable as a tenant — the HVM
        vPMU analog.

        The reference fully virtualizes the PMU for guests that know
        nothing about the hypervisor: ``vpmu_core2.c`` saves/loads the
        real counter MSRs around each vcpu switch and traps the guest's
        own MSR accesses (``core2_vpmu_save``/``__core2_vpmu_load``,
        ``xen-4.2.1/xen/arch/x86/hvm/vmx/vpmu_core2.c:267-518``), so a
        non-paravirtualized HVM guest still yields measured telemetry.
        Here the same claim: ``fn`` follows no framework protocol — any
        signature, any return value, no metrics dict — yet the job gets
        *measured* stall/collective phases, because the backend samples
        ``torch.profiler`` around its quanta (``telemetry/profiler.py``)
        and harvests its FLOPs and bytes from one counted invocation
        (``CudaBackend._job_cost``), rather than asking the workload to
        report.

        Each step invokes ``fn(*call_args, **call_kwargs)`` (the backend
        synchronises the card after it); the arguments are fixed (a
        tenant that wants to thread state through steps is by definition
        cooperating — use the normal ``Job`` protocol). The port has no
        ahead-of-time executable to dispatch through, so every step
        calls ``fn`` itself; ``job.compiled`` holds only the harvested
        cost.
        """
        job = cls(name, step_fn=None, state=None, params=params,
                  max_steps=max_steps)

        def step_fn(_state):
            # Pin the no-cooperation contract: wrap in (state, {}) so
            # a foreign fn returning (output, some_dict) — an ordinary
            # (out, aux) shape — is never sniffed as the cooperative
            # metrics protocol by the backend.
            return fn(*call_args, **call_kwargs), {}

        job.step_fn = step_fn
        job.profile_every = max(1, int(profile_every))
        job._foreign_spec = (fn, call_args, call_kwargs)
        return job

    def log(self, line: str) -> int:
        """Workload-side console write (the guest printk)."""
        return self.console.write(line)

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
