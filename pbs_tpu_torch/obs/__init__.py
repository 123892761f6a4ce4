"""Observability of the port: trace rings, request spans, latency
histograms, per-job consoles, the perf counters, the lock profiler, the
scheduler-history monitor (xenmon), the sampling profiler (xenoprof),
the hot-path self-test. The obs dump the commands read is
``obs.dumpfile`` (not loaded here: it pulls in ``obs.lockdep`` and its
boot params, which the reference's package init does not)."""

from pbs_tpu_torch.obs.console import Console, log, read_system, system_console
from pbs_tpu_torch.obs.lockprof import ProfiledLock
from pbs_tpu_torch.obs.mon import Monitor, SchedHistory
from pbs_tpu_torch.obs.oprofile import ProfileSession, ProfilerBusy
from pbs_tpu_torch.obs.perfc import Perfc, perfc
from pbs_tpu_torch.obs.selftest import CanaryResult, run_selftest, selftest_ok
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
    "CanaryResult", "Console", "Ev", "HistBatch", "LatencyHistograms",
    "Monitor", "Perfc", "ProfileSession", "ProfiledLock", "ProfilerBusy",
    "SchedHistory", "SpanAssembler", "SpanRecorder", "TraceBuffer",
    "bucket_edges", "format_records", "hist_bucket", "hist_quantile",
    "load_span_artifacts", "log", "perfc", "read_system", "run_selftest",
    "selftest_ok", "system_console",
]
