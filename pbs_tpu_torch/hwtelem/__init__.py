"""pbs_tpu_torch.hwtelem — the live hardware-counter plane.

The port of ``pbs_tpu.hwtelem``: real kernel counter sources
(perf_event → cgroup → rusage degradation ladder) behind the
``TelemetrySource`` protocol, recorded-window capture/replay, and
sim-vs-real fidelity scoring. Torch-free; the same windows, digests and
reports as the reference, and the same ``PBST_HWTELEM_DISABLE`` kill
switch, so one environment variable arms both packages alike.
"""

from pbs_tpu_torch.hwtelem.fidelity import (
    fidelity_report,
    record_serving_window,
    render_report,
)
from pbs_tpu_torch.hwtelem.sources import (
    DECLARED_EVENTS,
    HwCounterSource,
    ladder,
    pick_tier,
    probe_report,
)
from pbs_tpu_torch.hwtelem.window import (
    CounterWindow,
    HwRecorder,
    ReplaySource,
)

__all__ = [
    "DECLARED_EVENTS",
    "CounterWindow",
    "HwCounterSource",
    "HwRecorder",
    "ReplaySource",
    "fidelity_report",
    "ladder",
    "pick_tier",
    "probe_report",
    "record_serving_window",
    "render_report",
]
