"""Observability of the port: trace rings, request spans, latency
histograms, per-job consoles and the perf counters. The reference's
lock profiler, monitors, oprofile and self-test wait for ROADMAP queue
1 items 9 and 12."""

from pbs_tpu_torch.obs.console import Console, log, read_system, system_console
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
    "Console", "Ev", "HistBatch", "LatencyHistograms", "Perfc",
    "SpanAssembler", "SpanRecorder", "TraceBuffer", "bucket_edges", "format_records",
    "hist_bucket", "hist_quantile", "load_span_artifacts", "log", "perfc",
    "read_system", "system_console",
]
