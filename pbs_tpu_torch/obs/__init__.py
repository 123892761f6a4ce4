"""Observability of the port: trace rings, request spans, latency
histograms, per-job consoles, the perf counters and the lock profiler.
The reference's monitors, oprofile and self-test wait for ROADMAP queue
1 item 12."""

from pbs_tpu_torch.obs.console import Console, log, read_system, system_console
from pbs_tpu_torch.obs.lockprof import ProfiledLock
from pbs_tpu_torch.obs.perfc import Perfc, perfc
from pbs_tpu_torch.obs.spans import (
    HistBatch,
    LatencyHistograms,
    SpanAssembler,
    SpanRecorder,
    bucket_edges,
    hist_bucket,
    hist_quantile,
    load_span_artifacts,
)
from pbs_tpu_torch.obs.trace import Ev, TraceBuffer, format_records

__all__ = [
    "Console", "Ev", "HistBatch", "LatencyHistograms", "Perfc", "ProfiledLock",
    "SpanAssembler", "SpanRecorder", "TraceBuffer", "bucket_edges", "format_records",
    "hist_bucket", "hist_quantile", "load_span_artifacts", "log", "perfc",
    "read_system", "system_console",
]
