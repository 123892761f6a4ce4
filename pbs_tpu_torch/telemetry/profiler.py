"""Measured telemetry: per-quantum ``torch.profiler`` sampling.

The port of ``pbs_tpu.telemetry.profiler``. The reference's whole point
is cheap *measured* hardware counters: ``perfctr_cpu_vsuspend``
publishes rdpmc sums into the per-vcpu state at every context switch
(``xen-4.2.1/xen/arch/x86/perfctr.c:1547-1573``), so the feedback
filter sees real miss rates, not estimates. A GPU exposes no
per-tenant counter file to an unprivileged process either, but
``torch.profiler`` records every kernel the card ran (CUPTI activity).
Wrapping a quantum in a profiler session yields a Chrome trace; this
module buckets its per-kernel time into

- **compute** — tensor-core and GEMM work: the port's own kernels
  (flash forward and backward, the instrumented matmul) and library
  GEMM/GEMV/convolution kernels;
- **collective** — NCCL kernels: the measured analog of spin-lock wait;
- **memory** — everything else (elementwise, reductions, copies,
  memsets): bandwidth-bound, so their duration is the measured stand-in
  for the reference's LLC-stall counter.

Device kernels are preferred (``source="device"``); a trace with no
device activity — a quantum that ran on the host — falls back to the
host's ``aten::`` ops (``source="host"``), each billed its *exclusive*
time, because host ops nest (``aten::linear`` spans ``aten::addmm``,
which spans ``aten::copy_``) where device kernels do not.

Profiling every quantum would double step latency; like i-mode
sampling, the backend profiles every N-th quantum and carries the
measured fractions forward until the next sample. The static roofline
estimate (``source.py``) remains the cold-start fallback.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import tempfile
import threading
import time
from typing import Any, Callable, Iterable

__all__ = [
    "TraceStats",
    "TorchQuantumProfiler",
    "classify_kernel",
    "parse_trace_events",
]

#: Chrome-trace categories of device activity in ``torch.profiler``'s
#: export (CUPTI kernel, memcpy and memset records).
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: Category of the host's ATen operators.
HOST_CAT = "cpu_op"

#: The port's own kernels (``ops/csrc/*.cu``), on either route: the
#: counterparts of the Pallas kernels the reference bills to the MXU.
PORT_KERNELS = (
    "flash_fwd_wgmma_kernel", "flash_fwd_simt_kernel",
    "flash_bwd_dq_wgmma_kernel", "flash_bwd_dq_simt_kernel",
    "flash_bwd_dkv_wgmma_kernel", "flash_bwd_dkv_simt_kernel",
    "mm_wgmma_kernel", "instrumented_mm_kernel",
)
# Library matrix kernels: cuBLAS (gemm/gemv, Hopper's nvjet and sm90_
# families), CUTLASS, xmma, and cuDNN convolutions. "conv" only as a
# word stem that "convert" cannot match.
_LIBRARY_COMPUTE_RE = re.compile(
    r"gemm|gemv|cutlass|xmma|nvjet|sm90_|conv(?:olution|olve|_|\d)")
_COLLECTIVE_RE = re.compile(r"nccl")
#: Host ops that run a matrix product or a convolution.
_HOST_COMPUTE_OPS = frozenset((
    "aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm",
    "aten::matmul", "aten::_scaled_mm", "aten::convolution",
))


def classify_kernel(name: str) -> str:
    """Bucket one trace event's name: 'compute' | 'collective' |
    'memory'. Device kernel names (demangled, template arguments and
    all) and host ``aten::`` op names are both accepted."""
    if name.startswith("aten::"):
        return "compute" if name in _HOST_COMPUTE_OPS else "memory"
    low = name.lower()
    if _COLLECTIVE_RE.search(low):
        return "collective"
    if any(k in name for k in PORT_KERNELS) or _LIBRARY_COMPUTE_RE.search(low):
        return "compute"
    return "memory"


@dataclasses.dataclass
class TraceStats:
    """Measured per-op time for one profiled quantum (all ns)."""

    device_time_ns: int = 0  # union of op intervals (busy time)
    compute_ns: int = 0
    collective_ns: int = 0
    memory_ns: int = 0
    n_ops: int = 0
    top_ops: list[tuple[str, int]] = dataclasses.field(default_factory=list)
    source: str = "none"  # 'device' (CUDA kernels) or 'host' (aten ops)

    @property
    def stall_frac(self) -> float:
        """Fraction of busy time NOT on matrix units — the measured
        HBM-stall proxy (reference: LLC-miss-rate, perfctr.c)."""
        busy = self.compute_ns + self.memory_ns + self.collective_ns
        return self.memory_ns / busy if busy > 0 else 0.0

    @property
    def collective_frac(self) -> float:
        busy = self.compute_ns + self.memory_ns + self.collective_ns
        return self.collective_ns / busy if busy > 0 else 0.0


def _merged_span(intervals: list[tuple[int, int]]) -> int:
    """Total length of the union of [start, end) intervals."""
    if not intervals:
        return 0
    intervals.sort()
    total = 0
    cur_s, cur_e = intervals[0]
    for s, e in intervals[1:]:
        if s > cur_e:
            total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s)


def _exclusive(ops: list[tuple[int, int, Any, str]]) -> list[int]:
    """Exclusive time of each (ts, dur, thread, name) host op: its
    duration less that of the ops directly nested in it on the same
    thread. ``ops`` is in trace order; the result is in the same order."""
    excl = [dur for _, dur, _, _ in ops]
    order = sorted(range(len(ops)),
                   key=lambda i: (str(ops[i][2]), ops[i][0], -ops[i][1]))
    stack: list[int] = []  # open ops of the current thread, outermost first
    thread = None
    for i in order:
        ts, dur, tid, _ = ops[i]
        if tid != thread:
            stack, thread = [], tid
        while stack and ops[stack[-1]][0] + ops[stack[-1]][1] <= ts:
            stack.pop()
        if stack:
            excl[stack[-1]] -= dur
        stack.append(i)
    return [max(0, x) for x in excl]


def parse_trace_events(events: Iterable[dict]) -> TraceStats:
    """Aggregate a ``torch.profiler`` Chrome trace's ``traceEvents`` into
    :class:`TraceStats`.

    Prefers device activity (``cat`` kernel/gpu_memcpy/gpu_memset) when
    the trace has any (a quantum on the card); otherwise falls back to
    the host's ``cpu_op`` events billed by exclusive time, so the same
    parser serves CI and production.
    """
    events = [e for e in events if e.get("ph") == "X"]
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    stats = TraceStats(source="device" if device else "host")
    # (ts ns, dur ns, thread, name) of every billable op, trace order;
    # trace timestamps are µs floats, kept to ns precision.
    ops = [(int(float(e.get("ts", 0)) * 1000),
            int(float(e.get("dur", 0)) * 1000),
            (e.get("pid"), e.get("tid")), e.get("name", ""))
           for e in (device or [e for e in events
                                if e.get("cat") == HOST_CAT])]
    ops = [op for op in ops if op[1] > 0]
    billed = [op[1] for op in ops] if device else _exclusive(ops)
    intervals: list[tuple[int, int]] = []
    per_op: dict[str, int] = {}
    for (ts, dur, _, name), bill in zip(ops, billed):
        kind = classify_kernel(name)
        stats.n_ops += 1
        intervals.append((ts, ts + dur))
        per_op[name] = per_op.get(name, 0) + bill
        if kind == "compute":
            stats.compute_ns += bill
        elif kind == "collective":
            stats.collective_ns += bill
        else:
            stats.memory_ns += bill
    stats.device_time_ns = _merged_span(intervals)
    stats.top_ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:8]
    return stats


def parse_trace_file(path: str) -> TraceStats:
    """Parse one exported Chrome trace (``export_chrome_trace``)."""
    with open(path) as f:
        doc = json.load(f)
    return parse_trace_events(doc.get("traceEvents", []))


# One profiler session per process (Kineto/CUPTI enforce this); a
# concurrent quantum skips its sample rather than block the executor.
_PROFILE_LOCK = threading.Lock()


class TorchQuantumProfiler:
    """Wraps host-callable quanta in a ``torch.profiler`` session and
    returns parsed :class:`TraceStats` (the rdpmc-read analog).

    ``device`` picks what is recorded: a CUDA device records the card's
    kernels only (the host's ops are not the quantum's device time and
    would only add overhead); the CPU records the host's ``aten::`` ops.
    The profiled callable must end with a device synchronise, so its
    kernels finish inside the session (``CudaBackend`` profiles such a
    closure). ``keep_dir`` keeps each sample's exported trace there as
    ``trace_<n>.json`` instead of deleting it.

    The profiler's own cost — starting and stopping the session,
    exporting and parsing the trace, everything outside ``fn`` — is kept
    in ``last_overhead_ns`` (the latest call) and ``overhead_ns`` (all
    calls), so a caller can keep it out of the time it charges ``fn``.
    """

    def __init__(self, device: Any = "cuda", keep_dir: str | None = None):
        self.device_type = str(device).split(":")[0]
        self.keep_dir = keep_dir
        self.samples = 0
        self.failures = 0
        self.last_error: str | None = None
        self.last_overhead_ns = 0
        self.overhead_ns = 0

    def _session(self):
        from torch.profiler import ProfilerActivity, profile

        act = (ProfilerActivity.CUDA if self.device_type == "cuda"
               else ProfilerActivity.CPU)
        return profile(activities=[act])

    def _trace_path(self) -> str:
        if self.keep_dir is not None:
            os.makedirs(self.keep_dir, exist_ok=True)
            return os.path.join(self.keep_dir,
                                f"trace_{self.samples + self.failures}.json")
        fd, path = tempfile.mkstemp(prefix="pbst_prof_", suffix=".json")
        os.close(fd)
        return path

    def profile(self, fn: Callable[[], Any]) -> tuple[Any, TraceStats | None]:
        """Run ``fn`` under the profiler; returns (fn(), stats|None).
        Never raises on profiler trouble — the quantum's result always
        comes back; a failed sample just leaves stats None."""
        fn_ns = 0

        def timed():
            nonlocal fn_ns
            t = time.monotonic_ns()
            try:
                return fn()
            finally:
                fn_ns = time.monotonic_ns() - t

        t0 = time.monotonic_ns()
        try:
            return self._profile(timed)
        finally:
            self.last_overhead_ns = max(0, time.monotonic_ns() - t0 - fn_ns)
            self.overhead_ns += self.last_overhead_ns

    def _profile(self, fn: Callable[[], Any]) -> tuple[Any, TraceStats | None]:
        if not _PROFILE_LOCK.acquire(blocking=False):
            return fn(), None  # another quantum holds the one session
        try:
            # Start/stop failures are the profiler's problem and must
            # not affect the quantum — but ``fn`` runs EXACTLY once
            # either way (a data-loading step advances external cursors;
            # re-running it would double-step the job).
            session = None
            try:
                session = self._session()
                session.__enter__()
            except Exception as e:
                self.failures += 1
                self.last_error = f"{type(e).__name__}: {e}"
                session = None
            try:
                out = fn()
            finally:
                if session is not None:
                    try:
                        session.__exit__(None, None, None)
                    except Exception as e:  # noqa: BLE001 — sample lost
                        self.failures += 1
                        self.last_error = f"{type(e).__name__}: {e}"
                        session = None
            if session is None:
                return out, None
            path = None
            try:
                path = self._trace_path()
                session.export_chrome_trace(path)
                stats = parse_trace_file(path)
                self.samples += 1
                return out, stats
            except Exception as e:
                self.failures += 1
                self.last_error = f"{type(e).__name__}: {e}"
                return out, None
            finally:
                if self.keep_dir is None and path is not None:
                    try:
                        os.unlink(path)
                    except OSError:
                        pass
        finally:
            _PROFILE_LOCK.release()
