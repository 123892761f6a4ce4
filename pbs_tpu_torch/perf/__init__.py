"""``pbs_tpu_torch.perf`` — microbenchmark harness for the framework's
own hot paths (``pbst-torch perf``), the port of ``pbs_tpu.perf``.

PBS's premise is that the feedback instrumentation is cheap enough to
run every millisecond on the hot path; this package makes that a
*measured, regression-gated* property instead of a hope. Named benches
cover the per-event/per-sample costs every layer pays (trace emit,
batched emit, vectorized drain, ledger sampling, fair-queue cycling,
the sim dispatch loop, an RPC loopback), emit stable JSON, and
``pbst-torch perf --check`` fails CI only on large (default ≥2×) ns/op
regressions against the checked-in ``baseline.json`` (the port's own,
recorded on the card host's CPU) — the order-of-magnitude canary
philosophy of ``pbst-torch selftest`` extended to a refreshable,
per-path baseline.
"""

from pbs_tpu_torch.perf.bench import (
    BENCHES,
    NATIVE_BENCHES,
    BenchResult,
    bench_names,
    run_bench,
)
from pbs_tpu_torch.perf.report import (
    DEFAULT_THRESHOLD,
    baseline_path,
    compare_to_baseline,
    format_report,
    host_stamp,
    load_baseline,
    native_info,
    run_benches,
    save_baseline,
)

__all__ = [
    "BENCHES", "BenchResult", "DEFAULT_THRESHOLD", "NATIVE_BENCHES",
    "baseline_path", "bench_names", "compare_to_baseline",
    "format_report", "host_stamp", "load_baseline", "native_info",
    "run_bench", "run_benches", "save_baseline",
]
