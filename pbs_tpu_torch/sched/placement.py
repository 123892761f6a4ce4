"""Placement helpers shared by schedulers — jax-free by design so the
pure-simulation scheduler core never drags the ML stack in."""

from __future__ import annotations

from typing import TYPE_CHECKING

if TYPE_CHECKING:
    from pbs_tpu_torch.runtime.job import ExecutionContext


def anti_stack_pick(scheduler, ctx: "ExecutionContext") -> int | None:
    """Executor choice avoiding siblings of the same job; None if every
    executor already holds a sibling (caller falls back to load).

    The atc variant's anti-stacking affinity rewrite
    (``sched_credit_atc.c:545-570``) generalized: never stack ring/gang
    members on one lane.
    """
    part = scheduler.partition
    siblings = {id(c) for c in ctx.job.contexts if c is not ctx}
    running_on = {
        ex.index for ex in part.executors
        if ex.current is not None and id(ex.current) in siblings
    }
    candidates = []
    for exi in range(len(part.executors)):
        if exi in running_on:
            continue
        q = scheduler.runqs[exi] if hasattr(scheduler, "runqs") else []
        if any(id(c) in siblings for c in q):
            continue
        candidates.append(exi)
    if not candidates:
        return None
    loads = [(len(scheduler.runqs[exi]), exi) for exi in candidates]
    return min(loads)[1]


def holds_sibling(scheduler, exi: int, ctx: "ExecutionContext") -> bool:
    """True if executor ``exi`` runs or queues a sibling of ``ctx``."""
    siblings = {id(c) for c in ctx.job.contexts if c is not ctx}
    ex = scheduler.partition.executors[exi]
    if ex.current is not None and id(ex.current) in siblings:
        return True
    q = scheduler.runqs[exi] if hasattr(scheduler, "runqs") else []
    return any(id(c) in siblings for c in q)
