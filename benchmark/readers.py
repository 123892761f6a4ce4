"""What the metric readers share: percentiles, the window's steps and
ledger deltas."""

from __future__ import annotations

import bisect
import math

def nearest_rank(values, q: float):
    """The ceil(q n)-th smallest value (None for no values)."""
    vals = sorted(values)
    if not vals:
        return None
    return vals[max(0, math.ceil(q * len(vals)) - 1)]


def window_steps(run) -> list:
    """The batch tenant's steps that ended inside the window."""
    return [s for s in run.batch.steps if run.t0 <= s[1] <= run.t_end]


def ledger_delta(run, job: str, counter: str) -> int:
    from pbs_tpu_torch.telemetry.counters import Counter

    i = int(getattr(Counter, counter))
    return int(run.ledger1[job][i]) - int(run.ledger0[job][i])


def due_requests(run) -> list:
    return [r for r in run.serve.requests if r["due_ns"] < run.t_end]


def picks(run) -> list[int]:
    """Times of the serving job's SCHED_PICK records, sorted."""
    from pbs_tpu_torch.obs.trace import Ev

    out = []
    for recs in run.ring:
        for rec in recs.tolist():
            if rec[1] == Ev.SCHED_PICK and rec[2] == run.serve_slot:
                out.append(rec[0])
    return sorted(out)


def next_after(sorted_times: list[int], t: int):
    i = bisect.bisect_left(sorted_times, t)
    return sorted_times[i] if i < len(sorted_times) else None
