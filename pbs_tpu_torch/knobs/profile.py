"""Tuned profiles as knob files: the port of ``pbs_tpu.knobs.profile``.

A tuned profile (``pbs_tpu_torch/sched/tuned/<workload>.json``, copies
of the reference's) carries the winning policy params under their
constructor names (``min_us``, ``window``, ...). This module is the
bijection between that surface and the registry's declared knob names,
so a profile IS a knob document: a profile that cannot round-trip the
registry (unknown param, value outside the declared safe range) fails
loudly at load time instead of running unvalidated constants.
"""

from __future__ import annotations

from typing import Any

from pbs_tpu_torch.knobs import registry
from pbs_tpu_torch.knobs.registry import KnobError

#: Policy constructor param -> registry knob, per tunable policy, in
#: lockstep with ``FeedbackPolicy.TUNABLE_PARAMS``.
PARAM_KNOBS: dict[str, dict[str, str]] = {
    "feedback": {
        "min_us": "sched.feedback.tslice_min_us",
        "max_us": "sched.feedback.tslice_max_us",
        "window": "sched.feedback.window",
        "stall_threshold": "sched.feedback.stall_threshold",
        "grow_step_us": "sched.feedback.grow_step_us",
        "shrink_sub_us": "sched.feedback.shrink_sub_us",
        "qdelay_threshold_ns": "sched.feedback.qdelay_threshold_ns",
        "gw_hot_after": "sched.feedback.gw_hot_after",
    },
    "atc": {
        "min_us": "sched.atc.tslice_min_us",
        "max_us": "sched.atc.tslice_max_us",
        "window": "sched.feedback.window",
        "stall_threshold": "sched.feedback.stall_threshold",
        "grow_step_us": "sched.feedback.grow_step_us",
        "shrink_sub_us": "sched.feedback.shrink_sub_us",
        "qdelay_threshold_ns": "sched.feedback.qdelay_threshold_ns",
        "gw_hot_after": "sched.feedback.gw_hot_after",
    },
}


def params_to_knobs(policy: str, params: dict[str, Any]
                    ) -> dict[str, int | float]:
    """Map a profile's params onto registry knob names and VALIDATE
    them against the declared safe ranges. Raises KnobError on an
    unknown policy/param or an out-of-range value."""
    mapping = PARAM_KNOBS.get(policy)
    if mapping is None:
        raise KnobError(
            [f"no knob mapping for policy {policy!r}; "
             f"tunable: {sorted(PARAM_KNOBS)}"])
    unknown = sorted(set(params) - set(mapping))
    if unknown:
        raise KnobError(
            [f"profile param(s) {unknown} have no declared knob "
             f"(policy {policy!r})"])
    updates = {mapping[p]: v for p, v in params.items()}
    # validate_set also applies the band-pair constraints; base the
    # check on the push itself plus declared defaults (an atc band in
    # a profile validates as the atc band, not against feedback's).
    return registry.validate_set(updates)


def knobs_to_params(policy: str, values: dict[str, int | float]
                    ) -> dict[str, int | float]:
    """Inverse map: knob values -> policy constructor params (only the
    params present in ``values``). The load path the policies consume
    (``FeedbackPolicy.from_knobs``/``apply_knobs``)."""
    mapping = PARAM_KNOBS.get(policy)
    if mapping is None:
        raise KnobError(
            [f"no knob mapping for policy {policy!r}; "
             f"tunable: {sorted(PARAM_KNOBS)}"])
    return {p: values[k] for p, k in mapping.items() if k in values}


def roundtrip_params(policy: str, params: dict[str, Any]
                     ) -> dict[str, Any]:
    """THE knob-file load path for tuned params: map onto the registry
    (validating types + safe ranges + band pairs), map back, and
    verify the round trip is lossless. ``pbst tune --check`` and
    ``policy_from_profile`` both route through here, so a tuned
    profile is exactly as loadable as a knob file — and its replayed
    digests prove the path changes nothing."""
    knobs = params_to_knobs(policy, params)
    back = knobs_to_params(policy, knobs)
    drift = {p: (params[p], back[p]) for p in params
             if back.get(p) != params[p]
             and float(back.get(p, float("nan"))) != float(params[p])}
    if drift:
        raise KnobError(
            [f"{p}: {a!r} -> {b!r} (knob round trip not lossless)"
             for p, (a, b) in sorted(drift.items())])
    return back


def profile_knob_document(prof: dict) -> dict[str, int | float]:
    """A loaded tuned-profile dict -> the knob updates it stands for
    (what ``pbst knobs load-profile`` pushes)."""
    return params_to_knobs(prof.get("policy", "feedback"),
                           dict(prof.get("params", {})))
