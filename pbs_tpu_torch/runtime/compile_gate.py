"""Compilation-aware admission control (SURVEY.md §7 "hard parts").

Analog chain: the reference's admission resource is memory —
``XENMEM_claim_pages`` fail-fast claims at domain create. The TPU-new
scarce resource is the XLA compile cache: every distinct program a
tenant brings costs a cache entry plus seconds of compile time, and
multiplexing many programs per core thrashes the cache (each eviction
converts a dispatch into a multi-second recompile stall). This gate
makes that pressure an admitted, accounted quantity, exactly like the
HBM claims in ``runtime.memory``:

- a partition gets a ``CompileBudget`` (max distinct programs = cache
  capacity; optional total compile-time budget);
- each job declares how many distinct programs it brings
  (``Job.n_programs``, default 1) and optionally an expected per-
  program compile cost; undeclared costs are projected from the
  *observed* fleet average (``CompileMeter.mean_compile_ns``);
- admission fail-fast-rejects when the projection overflows the
  budget, before any scheduler/ledger/memory state is touched.

Measured attribution (which job actually spent what) flows separately
through ``telemetry.compile.CompileMeter`` into the COMPILES /
COMPILE_TIME_NS ledger slots.

The port's copy of ``pbs_tpu.runtime.compile_gate``: the same claims,
reservations and projections. On the port a "program" is a kernel
library ``nvcc`` builds (``ops/cuda_build.py``), and the observed mean
is the mean ``nvcc`` run the port's ``CompileMeter`` has seen.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

if TYPE_CHECKING:
    from pbs_tpu_torch.runtime.job import Job


class CompileBudgetExceeded(RuntimeError):
    """Admission denied: projected compile-cache pressure over budget."""


@dataclasses.dataclass
class CompileBudget:
    """Partition-level compile-capacity declaration.

    ``max_programs`` models compile-cache capacity (entries);
    ``budget_ns`` bounds cumulative compile time (spent + projected) —
    None disables that axis.
    """

    max_programs: int | None = None
    budget_ns: int | None = None


class CompileAdmission:
    """Fail-fast compile-cache admission for one partition."""

    def __init__(self, budget: CompileBudget, meter=None):
        self.budget = budget
        if meter is None:
            from pbs_tpu_torch.telemetry.compile import CompileMeter

            meter = CompileMeter.install()
        self.meter = meter
        self.programs: dict[str, int] = {}  # job name -> claimed programs
        self.spent_ns: dict[str, int] = {}  # job name -> measured ns
        # job name -> projected ns reserved at admit time; the claim is
        # HELD until measured spend replaces it (a claim that isn't
        # held would admit unbounded projected load back-to-back).
        self.reserved_ns: dict[str, int] = {}
        self.rejections = 0

    # -- admission --------------------------------------------------------

    def projected_cost_ns(self, job: "Job") -> int:
        est = getattr(job, "est_compile_ns", None)
        per_program = (int(est) if est is not None
                       else self.meter.mean_compile_ns)
        return per_program * max(1, getattr(job, "n_programs", 1))

    def admit(self, job: "Job") -> None:
        """Raise :class:`CompileBudgetExceeded` or claim the job's
        program slots. Call before any other admission state lands (the
        claim is trivially reversible via :meth:`release`)."""
        n = max(1, int(getattr(job, "n_programs", 1)))
        b = self.budget
        if b.max_programs is not None:
            held = sum(self.programs.values())
            if held + n > b.max_programs:
                self.rejections += 1
                raise CompileBudgetExceeded(
                    f"job {job.name!r} brings {n} program(s); cache holds "
                    f"{held}/{b.max_programs} — admitting would thrash "
                    "the compile cache")
        if b.budget_ns is not None:
            projected = self.projected_cost_ns(job)
            committed = self.committed_ns()
            if committed + projected > b.budget_ns:
                self.rejections += 1
                raise CompileBudgetExceeded(
                    f"job {job.name!r} projects {projected} ns compile "
                    f"time; partition holds {committed} of "
                    f"{b.budget_ns} ns budget (measured + reserved)")
            self.reserved_ns[job.name] = projected
        self.programs[job.name] = n

    def committed_ns(self) -> int:
        """Held budget: per job, the larger of measured spend and the
        still-outstanding admission reservation."""
        names = set(self.spent_ns) | set(self.reserved_ns)
        return sum(max(self.spent_ns.get(j, 0), self.reserved_ns.get(j, 0))
                   for j in names)

    def release(self, job_name: str) -> None:
        self.programs.pop(job_name, None)
        self.spent_ns.pop(job_name, None)
        self.reserved_ns.pop(job_name, None)

    # -- measured feedback ------------------------------------------------

    def charge(self, job_name: str, compile_ns: int) -> None:
        """Measured compile time attributed to a job (fed by the
        executor after each quantum) — tightens future projections."""
        if job_name in self.programs:
            self.spent_ns[job_name] = (
                self.spent_ns.get(job_name, 0) + int(compile_ns))

    def dump(self) -> dict:
        return {
            "max_programs": self.budget.max_programs,
            "budget_ns": self.budget.budget_ns,
            "programs_held": dict(self.programs),
            "spent_ns": dict(self.spent_ns),
            "reserved_ns": dict(self.reserved_ns),
            "committed_ns": self.committed_ns(),
            "mean_compile_ns": self.meter.mean_compile_ns,
            "rejections": self.rejections,
        }
