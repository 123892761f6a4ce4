"""Pluggable scheduler framework (the port of ``pbs_tpu.sched.base``).

Analog of Xen's generic scheduler layer: the ops table ``struct scheduler``
(``xen-4.2.1/xen/include/xen/sched-if.h:144-190`` — including the
research-added ``.dump_admin_conf`` hook at ``sched-if.h:186``), the
``schedulers[]`` registry (``xen/common/schedule.c:65-70`` lists sedf,
credit, credit2, arinc653), and the ``schedule()`` dispatch that asks the
policy for (next vcpu, time slice) (``schedule.c:1082-1122``).

Each Partition (cpupool analog, ``xen/common/cpupool.c``) instantiates its
own scheduler — pools with different policies coexist, exactly as Xen
cpupools do.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import TYPE_CHECKING, Any

from pbs_tpu_torch import knobs

if TYPE_CHECKING:
    from pbs_tpu_torch.runtime.executor import Executor
    from pbs_tpu_torch.runtime.job import ExecutionContext, Job
    from pbs_tpu_torch.runtime.partition import Partition

# Dispatch-legal slice band. Distinct from the feedback policy's
# *adaptation* band (sched/feedback.py: 100 µs – 1.1 ms): this is the
# outer envelope any policy may hand the executor — the CSCHED floor
# (sched_credit.c:286-300) to the sysctl ceiling (public/sysctl.h:571).
# Out-of-band writes can land ``params.tslice_us`` anywhere; every
# ``do_schedule`` clamps at the Decision site so a bad stored value
# can never become a dispatched quantum. Values from the port's knob
# table (sched.base.*).
TSLICE_MIN_US = knobs.default("sched.base.tslice_min_us")
TSLICE_MAX_US = knobs.default("sched.base.tslice_max_us")


def clamp_tslice_us(us: int) -> int:
    """Clamp a per-job slice into the dispatch-legal band."""
    return max(TSLICE_MIN_US, min(TSLICE_MAX_US, int(us)))


@dataclasses.dataclass(slots=True)
class Decision:
    """What ``do_schedule`` returns: run this context for this long.

    Mirrors ``struct task_slice { vcpu, time, migrated }``
    (``sched-if.h``); ``quantum_ns`` is the per-job adaptive slice applied
    at ``csched_schedule`` exit (``sched_credit.c:1796-1805``). ``None``
    context = idle.
    """

    ctx: "ExecutionContext | None"
    quantum_ns: int


class Scheduler(abc.ABC):
    """Policy interface. One instance per Partition."""

    name: str = "abstract"

    def __init__(self, partition: "Partition", **params: Any):
        self.partition = partition

    # -- lifecycle hooks (alloc_pdata / insert_vcpu / ... analogs) -------

    def executor_added(self, ex: "Executor") -> None:  # alloc_pdata
        pass

    def executor_removed(self, ex: "Executor") -> None:  # free_pdata
        pass

    def job_added(self, job: "Job") -> None:  # alloc_domdata + insert_vcpu
        pass

    def job_removed(self, job: "Job") -> None:
        pass

    # -- run-state transitions ------------------------------------------

    def sleep(self, ctx: "ExecutionContext") -> None:
        pass

    @abc.abstractmethod
    def wake(self, ctx: "ExecutionContext") -> None:
        """Make ctx runnable (csched_vcpu_wake, incl. BOOST)."""

    def yield_(self, ctx: "ExecutionContext") -> None:
        pass

    def pick_executor(self, ctx: "ExecutionContext") -> int:
        """Placement (csched_cpu_pick). Default: round-robin by index."""
        n = len(self.partition.executors)
        return ctx.index % n if n else 0

    # -- the hot path ----------------------------------------------------

    @abc.abstractmethod
    def do_schedule(self, ex: "Executor", now_ns: int) -> Decision:
        """Pick the next context for this executor."""

    def descheduled(self, ex: "Executor", ctx: "ExecutionContext",
                    ran_ns: int, now_ns: int) -> None:
        """Called after a quantum completes (credit burn happens here —
        burn_credits, sched_credit.c:527-543)."""

    # -- control plane ---------------------------------------------------

    def adjust_job(self, job: "Job", **params: Any) -> None:
        """Per-job knobs (csched_dom_cntl: weight/cap,
        sched_credit.c:1103-1155)."""
        for k, v in params.items():
            if not hasattr(job.params, k):
                raise KeyError(f"unknown sched param {k!r}")
            setattr(job.params, k, v)

    def adjust_global(self, **params: Any) -> None:
        """System knobs (csched_sys_cntl: tslice µs bounds,
        sched_credit.c:1157-1170)."""
        raise NotImplementedError(f"{self.name} has no global knobs")

    # -- observability ---------------------------------------------------

    def dump_settings(self) -> dict[str, Any]:
        return {"name": self.name}

    def dump_executor(self, ex: "Executor") -> dict[str, Any]:
        return {}

    def dump_admin_conf(self) -> list[dict[str, Any]]:
        """The research-added ops hook (sched-if.h:186): per-context
        counter/sched_count dump behind the 'z' console key
        (csched_dump_customized, sched_credit.c:1944-1977)."""
        from pbs_tpu_torch.telemetry.counters import DUMP_EVENTS

        out = []
        for job in self.partition.jobs:
            for ctx in job.contexts:
                out.append(
                    {
                        "ctx": ctx.name,
                        "sched_count": ctx.sched_count,
                        "counters": {
                            c.name: int(ctx.counters[c]) for c in DUMP_EVENTS
                        },
                    }
                )
        return out


# -- registry (schedulers[] analog, schedule.c:65-70) -----------------------

_REGISTRY: dict[str, type[Scheduler]] = {}


def register_scheduler(cls: type[Scheduler]) -> type[Scheduler]:
    _REGISTRY[cls.name] = cls
    return cls


def scheduler_names() -> list[str]:
    return sorted(_REGISTRY)


def make_scheduler(name: str, partition: "Partition", **params: Any) -> Scheduler:
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown scheduler {name!r}; available: {scheduler_names()}"
        ) from None
    return cls(partition, **params)
