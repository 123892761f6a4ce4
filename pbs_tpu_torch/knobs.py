"""The defaults the port's scheduling core reads, as one flat table.

The JAX package declares every tunable in a typed registry with units,
ranges and a hot-reload channel. The port's first slice reads only the
defaults below, copied value for value from that registry, so an
unconfigured port schedules exactly as an unconfigured ``pbs_tpu``
does. The registry's roofline peaks (``telemetry.source.peak_*``) are
TPU values and are deliberately absent: ``CudaBackend`` states its own
H100 peaks.
"""

from __future__ import annotations

_MS = 1_000_000

DEFAULTS: dict[str, int | float] = {
    # sched/base.py: the dispatch-legal envelope.
    "sched.base.tslice_min_us": 100,
    "sched.base.tslice_max_us": 1_000_000,
    # sched/credit.py: accounting period and its sysctl bounds.
    "sched.credit.acct_period_us": 30_000,
    "sched.credit.tslice_min_bound_us": 1_000,
    "sched.credit.tslice_max_bound_us": 1_000_000,
    # sched/feedback.py: the adaptation loop.
    "sched.feedback.metric_tick_period_ns": 1 * _MS,
    "sched.feedback.window": 5,
    "sched.feedback.stable_lo": 0.70,
    "sched.feedback.stable_hi": 1.30,
    "sched.feedback.stall_threshold": 100.0,
    "sched.feedback.tslice_min_us": 100,
    "sched.feedback.tslice_max_us": 1_100,
    "sched.feedback.grow_step_us": 100,
    "sched.feedback.shrink_sub_us": 200,
    "sched.feedback.qdelay_threshold_ns": 2 * _MS,
    "sched.feedback.gw_hot_after": 3,
    # runtime/executor.py: steps-per-quantum ceiling.
    "runtime.executor.max_steps_per_quantum": 1024,
}


def default(name: str) -> int | float:
    """The default of knob ``name``; KeyError names the table's knobs."""
    try:
        return DEFAULTS[name]
    except KeyError:
        raise KeyError(
            f"unknown knob {name!r}; the port declares {sorted(DEFAULTS)}"
        ) from None
