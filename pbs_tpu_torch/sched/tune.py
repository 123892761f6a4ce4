"""Tuned policy profiles: the load path of ``pbs_tpu.sched.tune``.

The reference searches the feedback/atc policies' constants over its
simulator's workload catalog (successive halving) and checks in one
**tuned profile** per workload class. The port carries copies of those
profiles (``sched/tuned/<workload>.json``, package data) and the path a
deployment loads them by: ``policy_from_profile`` validates a profile's
params against the knob registry (``knobs/profile.py``), exactly like a
knob push, and arms the policy it names on a partition.

These profiles are the reference's frontier as its simulator scored
it, over that simulator's workload catalog; none was tuned on, or for,
an H100. Their bands (the "serving" profile's 100-700 us, for one) are
inputs to try on the card, not settings measured there. Re-tuning them
on the card waits for the search below.

The search itself (``successive_halving``, ``evaluate_params``,
``check_block``, ``check_profile``, ``write_profile``) scores configs on
the reference's simulator (``sim/``), which the port has not copied yet
(ROADMAP queue 1 item 12); until then each raises, naming that item.
"""

from __future__ import annotations

import json
import os

TUNED_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "tuned")

PROFILE_VERSION = 1

#: Workload classes that get a checked-in profile.
TUNED_WORKLOADS = ("stable", "contended", "phases", "serving", "mixed")

_SEARCH_MISSING = (
    "the tuned-profile search scores configs on the simulator (sim/), "
    "which the port has not copied yet (ROADMAP queue 1 item 12); "
    "profiles load through policy_from_profile")


def _search_missing(*_args, **_kw):
    raise NotImplementedError(_SEARCH_MISSING)


successive_halving = _search_missing
evaluate_params = _search_missing
check_block = _search_missing
check_profile = _search_missing
write_profile = _search_missing


def profile_path(workload: str, tuned_dir: str | None = None) -> str:
    return os.path.join(tuned_dir or TUNED_DIR, f"{workload}.json")


def load_profile(workload: str, tuned_dir: str | None = None) -> dict:
    with open(profile_path(workload, tuned_dir)) as f:
        prof = json.load(f)
    if prof.get("version") != PROFILE_VERSION:
        raise ValueError(
            f"tuned profile {workload!r}: version "
            f"{prof.get('version')!r} != {PROFILE_VERSION}")
    return prof


def tuned_workloads(tuned_dir: str | None = None) -> list[str]:
    d = tuned_dir or TUNED_DIR
    if not os.path.isdir(d):
        return []
    return sorted(f[:-5] for f in os.listdir(d) if f.endswith(".json"))


def policy_from_profile(partition, workload: str,
                        tuned_dir: str | None = None):
    """Arm the tuned policy for a workload class on a partition — the
    load path a deployment uses. Routes through the knob registry
    (knobs/profile.py): the profile's params are validated against the
    declared safe ranges exactly like a knob push, so a hand-edited
    profile outside the bands fails at load."""
    from pbs_tpu_torch.knobs.profile import roundtrip_params
    from pbs_tpu_torch.sched.atc import AtcFeedbackPolicy
    from pbs_tpu_torch.sched.feedback import FeedbackPolicy

    prof = load_profile(workload, tuned_dir)
    cls = AtcFeedbackPolicy if prof["policy"] == "atc" else FeedbackPolicy
    params = roundtrip_params(prof["policy"], dict(prof["params"]))
    return cls.from_profile(partition, {"params": params})
