"""pbs_tpu_torch.autopilot — shadow-replay self-tuning with SLO-guarded
canary knob rollout (docs/AUTOPILOT.md).

The port of ``pbs_tpu.autopilot``, with its exports.

The paper's feedback loop, closed at serving scale: continuously
record live gateway traffic (``recorder``), re-schedule captured
windows in background sim under candidate knob settings from the
tuned-profile space (``shadow``), and roll a winning candidate out
through the knob channel as a canary on a subset of federation
members — SLO-burn-rate guarded, automatically rolled back, every
decision span-traced and digest-covered (``canary``, ``pilot``).
Production only ever sees guarded deltas; a pathological
recommendation degrades to the reference profile, never to an outage
(the ``pbst-torch chaos`` federation harness gates it).

torch-free and deterministic under injected clocks, like the gateway
tier it steers.
"""

from pbs_tpu_torch.autopilot.canary import (  # noqa: F401
    PATHOLOGICAL_PARAMS,
    CanaryRollout,
)
from pbs_tpu_torch.autopilot.pilot import (  # noqa: F401
    Autopilot,
    AutopilotConfig,
    run_autopilot_demo,
)
from pbs_tpu_torch.autopilot.recorder import (  # noqa: F401
    ShadowRecorder,
    ShadowWindow,
)
from pbs_tpu_torch.autopilot.shadow import (  # noqa: F401
    classify_window,
    reference_params,
    replay_window,
    shadow_search,
    window_seed,
)

__all__ = [
    "Autopilot", "AutopilotConfig", "CanaryRollout",
    "PATHOLOGICAL_PARAMS", "ShadowRecorder", "ShadowWindow",
    "classify_window", "reference_params", "replay_window",
    "run_autopilot_demo", "shadow_search", "window_seed",
]
