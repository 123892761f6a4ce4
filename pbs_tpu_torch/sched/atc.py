"""ATC feedback variant: EWMA + log-bucket quantum law (design history).

The port of ``pbs_tpu.sched.atc``, decision for decision.

The reference ships a second, *unbuilt* scheduler
(``xen-4.2.1/xen/common/sched_credit_atc.c``, 2,251 LoC — absent from
``xen/common/Makefile:21-24``) recording an earlier design of the
adaptive policy. Its distinct mechanisms, re-expressed here as an
alternative FeedbackPolicy so both designs can be A/B'd on the same
scheduler:

- **EWMA of contention latency** with ALPHA=4
  (``sched_credit_atc.c:210-229``): avg = (avg*(ALPHA-1) + sample)/ALPHA.
- **Log-bucketing** (``log()``, ``sched_credit_atc.c:241-262``):
  bucket = floor(log2(avg_latency)).
- **Linear quantum law** (``sched_credit_atc.c:336-347``):
  tslice_us = 49_980 − 3_300·bucket, clamped to [300 µs, 30 ms] — the
  wider adaptation band of the two designs (BASELINE.md).
- **4-entry history state machine** (``update_time_slice``,
  ``sched_credit_atc.c:291-460``): a new bucket is only *applied* after
  the last HISTORY samples agree (hysteresis against noise).
- **Global minimum slice** (``csched_update_acct``,
  ``sched_credit_atc.c:462-501``): the partition-wide applied quantum is
  the minimum over all jobs' suggestions — one contended tenant tightens
  everyone's quantum (the lock-holder-preemption rationale: shorter
  quanta everywhere bound any tenant's wait).
"""

from __future__ import annotations

import dataclasses
import math
from typing import TYPE_CHECKING

import numpy as np

from pbs_tpu_torch import knobs
from pbs_tpu_torch.sched.feedback import FeedbackPolicy, JobMetricState
from pbs_tpu_torch.utils.clock import MS

if TYPE_CHECKING:
    from pbs_tpu_torch.runtime.job import Job

# Reference constants, declared in the knob registry
# (knobs/registry.py sched.atc.*) — defaults are the sched_credit_atc.c
# values, so the unconfigured policy is bit-identical to the pre-knob
# one.
ALPHA = knobs.default("sched.atc.alpha")
HISTORY = knobs.default("sched.atc.history")
SLICE_BASE_US = knobs.default("sched.atc.slice_base_us")
SLICE_STEP_US = knobs.default("sched.atc.slice_step_us")
ATC_MIN_US = knobs.default("sched.atc.tslice_min_us")
ATC_MAX_US = knobs.default("sched.atc.tslice_max_us")


@dataclasses.dataclass
class AtcJobState:
    ewma_ns: float = 0.0
    # Preallocated HISTORY-deep bucket ring (shift-in-place, arrival
    # order; hfill = filled prefix) — same no-allocation contract as
    # the base policy's sample window.
    history: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(HISTORY, dtype=np.int64))
    hfill: int = 0
    applied_bucket: int | None = None


class AtcFeedbackPolicy(FeedbackPolicy):
    """Drop-in alternative to FeedbackPolicy with the atc quantum law."""

    KNOB_POLICY = "atc"

    def __init__(self, partition, tick_ns: int = 1 * MS, **kw):
        # Tunable passthrough (`pbst tune --policy atc`): the atc band
        # defaults stand in for the base policy's, everything else
        # (window, queue-delay knobs) rides the FeedbackPolicy surface.
        kw.setdefault("min_us", ATC_MIN_US)
        kw.setdefault("max_us", ATC_MAX_US)
        super().__init__(partition, tick_ns=tick_ns, **kw)
        self.atc: dict[str, AtcJobState] = {}

    def _atc_state(self, job: "Job") -> AtcJobState:
        st = self.atc.get(job.name)
        if st is None:
            st = self.atc[job.name] = AtcJobState()
        return st

    # Override the phase filter wholesale: atc has no stall-rate phases.
    def _submilli_update(self, job, st: JobMetricState,
                         coll_wait_ns: float, steps: int) -> None:
        wait_ns, events = job.take_contention()
        total_wait = coll_wait_ns + wait_ns
        total_events = max(1, events + (steps if coll_wait_ns > 0 else 0))
        sample = total_wait / total_events

        a = self._atc_state(job)
        a.ewma_ns = (a.ewma_ns * (ALPHA - 1) + sample) / ALPHA
        bucket = int(math.log2(a.ewma_ns)) if a.ewma_ns >= 1 else 0

        h = a.history
        if a.hfill < HISTORY:
            h[a.hfill] = bucket
            a.hfill += 1
        else:
            h[:-1] = h[1:]
            h[-1] = bucket
        # Hysteresis: only adopt a bucket after HISTORY agreeing samples.
        if a.hfill == HISTORY and bool((h == h[0]).all()):
            a.applied_bucket = bucket

        self._apply_global_min()

    def _apply_global_min(self) -> None:
        """Partition-wide quantum = min over per-job suggestions
        (atc csched_update_acct:462-501)."""
        suggestions = []
        for job in self.partition.jobs:
            a = self.atc.get(job.name)
            if a is None or a.applied_bucket is None:
                continue
            us = SLICE_BASE_US - SLICE_STEP_US * a.applied_bucket
            suggestions.append(max(ATC_MIN_US, min(ATC_MAX_US, us)))
        if not suggestions:
            return
        global_us = min(suggestions)
        for job in self.partition.jobs:
            job.params.tslice_us = global_us

    def dump(self) -> list[dict]:
        out = []
        for job in self.partition.jobs:
            a = self._atc_state(job)
            out.append(
                {
                    "job": job.name,
                    "tslice_us": job.params.tslice_us,
                    "ewma_ns": round(a.ewma_ns, 1),
                    "bucket": a.applied_bucket,
                }
            )
        return out
