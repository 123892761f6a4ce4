"""The port's measured-telemetry plane against ``pbs_tpu``'s.

Trace parsing, the kernel classifier, the measured/roofline charge, the
sampling cadence and compile attribution are held against the JAX
package's functions on the same seeded inputs, field for field; the
feedback loop is driven on ``CudaBackend(device="cpu")`` with an
injected profiler of fixed stats, and one real ``torch.profiler``
session runs on the host. No assertion depends on host timing.
"""

from __future__ import annotations

import json
import os
import stat
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax", reason="parity tests need the JAX reference")

import pbs_tpu.runtime as ref_rt  # noqa: E402
import pbs_tpu.telemetry.compile as ref_compile  # noqa: E402
import pbs_tpu.telemetry.profiler as ref_prof  # noqa: E402
import torch  # noqa: E402
from pbs_tpu.telemetry.source import TpuBackend  # noqa: E402

import pbs_tpu_torch.runtime as port_rt  # noqa: E402
import pbs_tpu_torch.telemetry.compile as port_compile  # noqa: E402
import pbs_tpu_torch.telemetry.profiler as port_prof  # noqa: E402
from pbs_tpu_torch.ops import cuda_build  # noqa: E402
from pbs_tpu_torch.sched import FeedbackPolicy  # noqa: E402
from pbs_tpu_torch.telemetry import Counter, CudaBackend  # noqa: E402
from pbs_tpu_torch.telemetry.source import (H100_PEAK_FLOPS,  # noqa: E402
                                            H100_PEAK_HBM_BW)

# The suite runs in parallel worker processes: uncapped, torch's intra-op
# pool takes every core in each of them and oversubscribes the host.
torch.set_num_threads(2)

TRACE_FIXTURE = Path(__file__).resolve().parent / "data" / "h100_trace.json"

# -- trace parsing -------------------------------------------------------------

#: (HLO op name, CUDA kernel name, CUDA trace category), one bucket each:
#: the same op as the two profilers would name it.
PAIRS = (
    ("dot_general.1", "mm_wgmma_kernel", "kernel"),
    ("dot_general.2", "void flash_fwd_wgmma_kernel<128, true>(CUtensorMap, "
     "CUtensorMap, CUtensorMap, __nv_bfloat16*, float*, int, int, int, "
     "int, float)", "kernel"),
    ("convolution.3", "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize"
     "128x128x64_warpgroupsize1x1x1_execute_segment_k_off_kernel__5x_cublas",
     "kernel"),
    ("fusion.4", "void at::native::vectorized_elementwise_kernel<4, "
     "at::native::tanh_kernel_cuda(at::TensorIteratorBase&)::{lambda()#2}"
     "::operator()() const::{lambda(float)#1}, std::array<char*, 2ul> >"
     "(int, at::native::tanh_kernel_cuda(at::TensorIteratorBase&)::"
     "{lambda()#2}::operator()() const::{lambda(float)#1}, "
     "std::array<char*, 2ul>)", "kernel"),
    ("copy.5", "Memcpy DtoD (Device -> Device)", "gpu_memcpy"),
    ("broadcast.6", "Memset (Device)", "gpu_memset"),
    ("reduce.7", "void at::native::reduce_kernel<512, 1, "
     "at::native::ReduceOp<float, at::native::MeanOps<float, float, float, "
     "float>, unsigned int, float, 4, 4> >(at::native::ReduceOp<float, "
     "at::native::MeanOps<float, float, float, float>, unsigned int, "
     "float, 4, 4>)", "kernel"),
    ("all-reduce.8", "ncclDevKernel_AllReduce_Sum_f32_RING_LL("
     "ncclDevComm*, unsigned long, ncclWork*)", "kernel"),
    ("all-gather.9", "ncclKernel_AllGather_RING_LL_Sum_int8_t("
     "ncclDevComm*, unsigned long, ncclWork*)", "kernel"),
)


def _paired_traces(seed: int, n: int = 40):
    """The same ops at the same ts/dur, as the XLA profiler traces them
    (device lane = a '/device:TPU:0' process) and as torch.profiler's
    Chrome trace does (device activity by category), each with host
    events both parsers must ignore."""
    rng = np.random.default_rng(seed)
    xla = [{"ph": "M", "name": "process_name", "pid": 7,
            "args": {"name": "/device:TPU:0"}},
           {"ph": "M", "name": "process_name", "pid": 1,
            "args": {"name": "/host:CPU"}}]
    cuda = [{"ph": "M", "name": "process_name", "pid": 0,
             "args": {"name": "python"}}]
    ts = 1_000_000.0
    for _ in range(n):
        hlo, kernel, cat = PAIRS[rng.integers(len(PAIRS))]
        ts += round(float(rng.uniform(0.0, 40.0)), 3)
        dur = 0.0 if rng.random() < 0.1 else round(
            float(rng.uniform(0.001, 300.0)), 3)
        xla.append({"ph": "X", "pid": 7, "tid": 1, "name": hlo, "ts": ts,
                    "dur": dur})
        cuda.append({"ph": "X", "pid": 0, "tid": 7, "cat": cat,
                     "name": kernel, "ts": ts, "dur": dur})
        # the host side of the same launch: ignored by both
        xla.append({"ph": "X", "pid": 1, "tid": 2, "name": "ExecuteHelper",
                    "ts": ts - 5.0, "dur": 4.0})
        cuda.append({"ph": "X", "pid": 1234, "tid": 1234,
                     "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                     "ts": ts - 5.0, "dur": 4.0})
    cuda.append({"ph": "X", "pid": 0, "tid": 7, "cat": "gpu_user_annotation",
                 "name": "train_step", "ts": 1_000_000.0, "dur": 1e6})
    return xla, cuda


@pytest.mark.parametrize("seed", range(5))
def test_parse_trace_events_matches_reference(seed):
    xla, cuda = _paired_traces(seed)
    want = ref_prof.parse_trace_events(xla)
    got = port_prof.parse_trace_events(cuda)
    to_hlo = {kernel: hlo for hlo, kernel, _ in PAIRS}
    assert want.source == got.source == "device"
    for field in ("device_time_ns", "compute_ns", "collective_ns",
                  "memory_ns", "n_ops"):
        assert getattr(got, field) == getattr(want, field), field
    assert [(to_hlo[k], v) for k, v in got.top_ops] == want.top_ops
    assert got.stall_frac == want.stall_frac
    assert got.collective_frac == want.collective_frac


@pytest.mark.parametrize("name,kind", [
    *[(f"void {k}<128, true>(CUtensorMap, float*, int)", "compute")
      for k in port_prof.PORT_KERNELS],
    ("mm_wgmma_kernel", "compute"),
    ("instrumented_mm_kernel", "compute"),
    ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NTN", "compute"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", "compute"),
    ("ampere_bf16_s16816gemm_bf16_128x128_ldg8_f2f_tn", "compute"),
    ("void gemv2T_kernel_val<int, int, float, float, float, 128, 16, 4>",
     "compute"),
    ("void cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm_relu>",
     "compute"),
    ("void cudnn::engines_precompiled::conv2d_grouped_direct_kernel<float>",
     "compute"),
    ("implicit_convolve_sgemm", "compute"),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevComm*)", "collective"),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::FillFunctor<float>, std::array<char*, 1ul> >", "memory"),
    ("void at::native::unrolled_elementwise_kernel<at::native::"
     "direct_copy_kernel_cuda(at::TensorIteratorBase&), convert_to_bf16>",
     "memory"),
    ("void at::native::reduce_kernel<512, 1, ReduceOp<float>>", "memory"),
    ("Memcpy DtoH (Device -> Pageable)", "memory"),
    ("Memset (Device)", "memory"),
    ("aten::mm", "compute"),
    ("aten::addmm", "compute"),
    ("aten::bmm", "compute"),
    ("aten::_scaled_mm", "compute"),
    ("aten::convolution", "compute"),
    ("aten::linear", "memory"),
    ("aten::copy_", "memory"),
    ("aten::tanh", "memory"),
])
def test_classify_kernel_table(name, kind):
    assert port_prof.classify_kernel(name) == kind


def _host_op(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "cpu_op", "pid": 1, "tid": tid, "name": name,
            "ts": ts, "dur": dur}


def test_host_lane_bills_exclusive_time():
    """aten::linear spans aten::addmm, which spans aten::copy_: each is
    billed only its own time, so nothing is counted twice; another
    thread's op overlapping them is billed on its own."""
    events = [
        _host_op("aten::linear", 0.0, 100.0),
        _host_op("aten::addmm", 10.0, 80.0),
        _host_op("aten::copy_", 20.0, 10.0),
        _host_op("aten::tanh", 100.0, 5.0),  # starts as linear ends
        _host_op("aten::mm", 50.0, 30.0, tid=2),
        {"ph": "X", "cat": "user_annotation", "pid": 1, "tid": 1,
         "name": "step", "ts": 0.0, "dur": 105.0},
    ]
    st = port_prof.parse_trace_events(events)
    assert st.source == "host" and st.n_ops == 5
    assert dict(st.top_ops) == {"aten::linear": 20_000,
                                "aten::addmm": 70_000,
                                "aten::copy_": 10_000,
                                "aten::tanh": 5_000, "aten::mm": 30_000}
    assert st.compute_ns == 100_000  # addmm 70 us + mm 30 us
    assert st.memory_ns == 35_000  # linear 20 + copy_ 10 + tanh 5
    assert st.device_time_ns == 105_000


def test_parses_a_real_h100_trace():
    """A trimmed torch.profiler trace taken on an NVIDIA H100
    (``chip_smoke.py --trace-out``: kernels 2.1-2.4 and a tanh chain in
    one quantum): the device lane is read, the host's runtime calls
    ignored, and each of the port's kernels billed as compute."""
    doc = json.loads(TRACE_FIXTURE.read_text())
    assert doc["deviceProperties"][0]["name"].startswith("NVIDIA H100")
    events = doc["traceEvents"]
    kernels = [e for e in events if e.get("ph") == "X"
               and e.get("cat") in port_prof.DEVICE_CATS]
    assert any(e.get("cat") == "cuda_runtime" for e in events)
    ours = [e for e in kernels
            if any(k in e["name"] for k in port_prof.PORT_KERNELS)]
    found = {k for k in port_prof.PORT_KERNELS for e in ours if k in e["name"]}
    assert found == {"mm_wgmma_kernel", "instrumented_mm_kernel",
                     "flash_fwd_wgmma_kernel", "flash_bwd_dq_wgmma_kernel",
                     "flash_bwd_dkv_wgmma_kernel"}
    assert sum("tanh_kernel" in e["name"] for e in kernels) == 4
    st = port_prof.parse_trace_events(events)
    assert st.source == "device" and st.n_ops == len(kernels)
    assert st.compute_ns == sum(int(float(e["dur"]) * 1000) for e in ours)
    assert st.memory_ns == sum(int(float(e["dur"]) * 1000) for e in kernels
                               if e not in ours)
    assert st.collective_ns == 0
    assert 0.0 < st.stall_frac < 0.5  # the wgmma kernels dominate


# -- the charge and the sampling cadence ---------------------------------------


def _stats(mod, compute, memory, collective, n_ops=3):
    return mod.TraceStats(device_time_ns=compute + memory + collective,
                          compute_ns=compute, memory_ns=memory,
                          collective_ns=collective, n_ops=n_ops,
                          source="device")


@pytest.mark.parametrize("case", [
    # (dt, flops, nbytes, metrics, measured (compute, memory, coll, n_ops))
    (1_000_000, 2 * 4096 ** 3, 1 << 30, {}, None),
    (1_000_000, 2 * 4096 ** 3, 1 << 30, {}, (900, 100, 0, 4)),
    (777_777, 0, 0, {}, (300, 600, 100, 9)),
    (777_777, 0, 0, {"collective_wait_ns": 1234}, (300, 600, 100, 9)),
    (5_000, 10, 10, {"device_flops": 2 ** 40, "hbm_bytes": 2 ** 20,
                     "tokens": 512, "gang_skew_ns": 7,
                     "spec_proposed": 3}, None),
    (5_000, 10, 10, {"device_flops": 2 ** 40, "hbm_bytes": 2 ** 34,
                     "tokens": 8}, (10, 0, 0, 1)),
    (123_456, 1 << 20, 1 << 28, {}, (1, 1, 1, 0)),  # empty sample: roofline
    (0, 0, 0, {}, None),
], ids=["roofline", "measured", "measured-coll", "coll-metric-wins",
        "metric-keys", "measured-over-metrics", "no-ops", "idle"])
def test_charge_matches_tpu_backend(case):
    dt, flops, nbytes, metrics, measured = case
    ref = TpuBackend(peak_flops=H100_PEAK_FLOPS, peak_hbm_bw=H100_PEAK_HBM_BW)
    port = CudaBackend(device="cpu")
    want = np.zeros(len(Counter), dtype=np.uint64)
    got = np.zeros(len(Counter), dtype=np.uint64)
    ref._charge(want, dt, flops, nbytes, metrics,
                measured=None if measured is None
                else _stats(ref_prof, *measured))
    port._charge(got, dt, flops, nbytes, metrics,
                 measured=None if measured is None
                 else _stats(port_prof, *measured))
    assert got.tolist() == want.tolist()


class _NoProfiler:
    """Stands in for a profiler the cadence test never calls."""


@pytest.mark.parametrize("every,override", [(4, None), (2, None), (1, None),
                                            (4, 3), (0, 5), (0, None)])
def test_profile_due_cadence_matches_tpu_backend(every, override):
    ref = TpuBackend(profile_every=every, profiler=_NoProfiler())
    port = CudaBackend(device="cpu", profile_every=every,
                       profiler=_NoProfiler())
    seqs = []
    for be, rt in ((ref, ref_rt), (port, port_rt)):
        a, b = rt.Job("a"), rt.Job("b")
        a.profile_every = override  # b keeps the backend-wide period
        seqs.append([(be._profile_due(a), be._profile_due(b))
                     for _ in range(12)])
    assert seqs[1] == seqs[0]
    assert seqs[0][0][1] == bool(every)  # the first invocation profiles


# -- compile attribution -------------------------------------------------------


def _feed(meter, mod, stream) -> None:
    kinds = {"backend": mod.BACKEND_COMPILE_EVENT,
             "frontend": mod.FRONTEND_EVENTS[0], "other": "/unrelated"}
    for scope, kind, secs in stream:
        if scope is None:
            meter._on_event(kinds[kind], secs)
        else:
            with meter.attribute(scope):
                meter._on_event(kinds[kind], secs)


@pytest.mark.parametrize("seed", range(3))
def test_compile_meter_matches_reference(seed):
    rng = np.random.default_rng(seed)
    stream = [(["a", "b", None][rng.integers(3)],
               ["backend", "frontend", "other"][rng.integers(3)],
               float(rng.uniform(0.001, 20.0))) for _ in range(60)]
    ref, port = ref_compile.CompileMeter(), port_compile.CompileMeter()
    _feed(ref, ref_compile, stream[:40])
    _feed(port, port_compile, stream[:40])
    assert port.peek_all() == ref.peek_all()
    assert port.take("a") == ref.take("a")
    _feed(ref, ref_compile, stream[40:])
    _feed(port, port_compile, stream[40:])
    for name in ("a", "b", "<ambient>", "never"):
        assert port.take(name) == ref.take(name)
    assert (port.total_compiles, port.total_compile_ns,
            port.mean_compile_ns) == (ref.total_compiles,
                                      ref.total_compile_ns,
                                      ref.mean_compile_ns)


def test_compile_attribution_is_per_thread():
    meter = port_compile.CompileMeter()

    def other():
        with meter.attribute("b"):
            meter._on_event(port_compile.BACKEND_COMPILE_EVENT, 2.0)

    with meter.attribute("a"):
        t = threading.Thread(target=other)
        t.start()
        t.join()
        meter._on_event(port_compile.BACKEND_COMPILE_EVENT, 1.0)
    assert meter.take("a") == (1, 1_000_000_000)
    assert meter.take("b") == (1, 2_000_000_000)


_FAKE_NVCC = """#!{python}
import sys, time
out = sys.argv[sys.argv.index("-o") + 1]
time.sleep(0.05)
open(out, "wb").write(b"not a library")
print("ptxas info    : Used 1 registers", file=sys.stderr)
"""


def test_build_reports_each_nvcc_run_to_the_meter(tmp_path, monkeypatch):
    """Every finished nvcc run is one backend-compile event of at least
    its own run time, charged to the scope of the thread that asked for
    the build; an up-to-date library is not rebuilt and reports
    nothing."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(_FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    meter = port_compile.CompileMeter.install()
    names = ("flash_fwd", "instrumented_matmul")
    total = meter.total_compiles
    with meter.attribute("tenant-build"):
        built = cuda_build.build(names)
    n, ns = meter.take("tenant-build")
    assert sorted(built) == list(names)
    assert n == 2 and meter.total_compiles == total + 2
    assert ns >= 2 * 50_000_000 and all(r.seconds >= 0.05
                                        for r in built.values())
    assert ns == sum(int(r.seconds * 1e9) for r in built.values())
    with meter.attribute("tenant-build"):
        again = cuda_build.build(names)
    assert all(r.seconds == 0.0 for r in again.values())
    assert meter.take("tenant-build") == (0, 0)


# -- the loop on the host ------------------------------------------------------


class _FixedProfiler:
    """A profiler that runs the quantum once and reports the stats of
    the tenant's kind, as a card's trace of it would."""

    def __init__(self):
        self.by_kind = {
            "memory": port_prof.TraceStats(device_time_ns=1000,
                                           compute_ns=200, memory_ns=800,
                                           n_ops=12, source="device"),
            "compute": port_prof.TraceStats(device_time_ns=1000,
                                            compute_ns=980, memory_ns=20,
                                            n_ops=2, source="device"),
        }
        self.samples = self.failures = 0
        self.calls: dict[str, int] = {}

    def profile(self, fn):
        state, metrics = fn()
        self.samples += 1
        kind = state["kind"]
        self.calls[kind] = self.calls.get(kind, 0) + 1
        return (state, metrics), self.by_kind[kind]


def test_measured_stall_steers_the_slices():
    """Under Partition + FeedbackPolicy with a sample every 2nd
    invocation, the tenant measured memory-bound grows its slice and
    the one measured compute-bound shrinks its own, although their
    counted FLOPs and bytes (the roofline input) say the opposite."""
    x = torch.ones(16, 16)
    prof = _FixedProfiler()
    be = CudaBackend(device="cpu", profile_every=2, profiler=prof)
    part = port_rt.Partition("p", source=be)
    fb = FeedbackPolicy(part, tick_ns=1)

    def step(kind, metrics):
        def fn(state):
            return {"kind": kind, "x": state["x"] @ x}, dict(metrics)
        return fn

    # counted as compute-bound / memory-bound by the roofline estimate
    mem = part.add_job(port_rt.Job(
        "mem", step_fn=step("memory", {"device_flops": 2 ** 40,
                                       "hbm_bytes": 1}),
        state={"kind": "memory", "x": x},
        params=port_rt.SchedParams(tslice_us=100)))
    mm = part.add_job(port_rt.Job(
        "mm", step_fn=step("compute", {"device_flops": 1,
                                       "hbm_bytes": 2 ** 34}),
        state={"kind": "compute", "x": x},
        params=port_rt.SchedParams(tslice_us=1000)))
    part.run(max_rounds=16)
    by_job = {d["job"]: d for d in fb.dump()}
    assert mem.params.tslice_us > 100 and by_job["mem"]["grows"] > 0
    assert mm.params.tslice_us < 1000 and by_job["mm"]["shrinks"] > 0
    assert mem.stall_rate > 700 > 100 > 30 > mm.stall_rate
    assert be.measured("mem") is prof.by_kind["memory"]
    assert be.measured("mm") is prof.by_kind["compute"]
    assert set(prof.calls) == {"memory", "compute"}


def test_torch_profiler_runs_the_quantum_once_on_the_host():
    prof = port_prof.TorchQuantumProfiler(device="cpu")
    lin = torch.nn.Linear(32, 32)
    x = torch.randn(8, 32)
    calls = []

    def fn():
        calls.append(1)
        return torch.tanh(lin(x))

    out, st = prof.profile(fn)
    assert len(calls) == 1 and out.shape == (8, 32)
    assert (prof.samples, prof.failures) == (1, 0)
    assert st.source == "host" and st.n_ops > 0
    assert st.compute_ns > 0 and st.memory_ns > 0
    # one host thread: exclusive times tile the union of the op spans
    assert st.compute_ns + st.memory_ns == st.device_time_ns


class _BrokenSession:
    def __init__(self, where):
        self.where = where

    def __enter__(self):
        if self.where == "start":
            raise RuntimeError("CUPTI busy")
        return self

    def __exit__(self, *exc):
        if self.where == "stop":
            raise RuntimeError("stop failed")

    def export_chrome_trace(self, path):
        raise OSError("disk full")


@pytest.mark.parametrize("where", ["start", "stop", "export"])
def test_profiler_failure_still_returns_the_result(where, monkeypatch):
    prof = port_prof.TorchQuantumProfiler(device="cpu")
    monkeypatch.setattr(prof, "_session", lambda: _BrokenSession(where))
    calls = []

    def fn():
        calls.append(1)
        return 42

    out, st = prof.profile(fn)
    assert (out, st, len(calls)) == (42, None, 1)
    assert (prof.samples, prof.failures) == (0, 1)
    assert prof.last_error
    # the one session is free again
    assert port_prof._PROFILE_LOCK.acquire(blocking=False)
    port_prof._PROFILE_LOCK.release()


class _SlowSession:
    """A session whose start, stop and export each take a while on the
    fake clock, and whose trace holds one device kernel."""

    def __init__(self, clock):
        self.clock = clock

    def __enter__(self):
        self.clock.advance(300_000_000)
        return self

    def __exit__(self, *exc):
        self.clock.advance(200_000_000)

    def export_chrome_trace(self, path):
        self.clock.advance(400_000_000)
        with open(path, "w") as f:
            json.dump({"traceEvents": [
                {"ph": "X", "cat": "kernel", "name": "mm_wgmma_kernel",
                 "ts": 0.0, "dur": 5.0, "pid": 0, "tid": 7}]}, f)


@pytest.mark.parametrize("every, n_sampled", [(1, 4), (2, 2), (4, 1)])
def test_profiler_cost_is_not_charged_as_device_time(every, n_sampled,
                                                     monkeypatch):
    """A sampled invocation is charged the quantum's own time, as an
    unsampled one is; the profiler's start, stop, export and parse land
    in ``profile_cost`` instead of DEVICE_TIME_NS."""
    import types

    import pbs_tpu_torch.telemetry.source as port_source

    class Clock:
        now = 0

        def advance(self, ns):
            self.now += ns

        def monotonic_ns(self):
            return self.now

    clock = Clock()
    fake_time = types.SimpleNamespace(monotonic_ns=clock.monotonic_ns)
    monkeypatch.setattr(port_prof, "time", fake_time)
    monkeypatch.setattr(port_source, "time", fake_time)
    prof = port_prof.TorchQuantumProfiler(device="cpu")
    monkeypatch.setattr(prof, "_session", lambda: _SlowSession(clock))
    be = CudaBackend(device="cpu", profile_every=every, profiler=prof)

    def step(state):
        clock.advance(10_000_000)
        return state + 1

    job = port_rt.Job("slow", step_fn=step, state=0)
    deltas = be.execute(types.SimpleNamespace(job=job), 4)
    assert job.state == 4 and prof.failures == 0
    assert prof.samples == n_sampled
    assert int(deltas[Counter.DEVICE_TIME_NS]) == 4 * 10_000_000
    assert be.profile_cost["slow"] == [n_sampled, n_sampled * 10_000_000,
                                       n_sampled * 900_000_000]
    assert prof.overhead_ns == n_sampled * 900_000_000
    assert prof.last_overhead_ns == 900_000_000
    assert be.measured("slow").compute_ns == 5000


def test_profiler_keeps_traces_when_asked(tmp_path):
    prof = port_prof.TorchQuantumProfiler(device="cpu",
                                          keep_dir=str(tmp_path))
    prof.profile(lambda: torch.ones(4) + 1)
    kept = sorted(os.listdir(tmp_path))
    assert kept == ["trace_0.json"]
    doc = json.loads((tmp_path / kept[0]).read_text())
    st = port_prof.parse_trace_events(doc["traceEvents"])
    assert st.source == "host" and st.n_ops > 0


def _launch(corr, ts, name="cudaLaunchKernel"):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts,
            "dur": 1, "args": {"correlation": corr}}


def _kernel(corr, ts, name, dur=10.0):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def test_session_pads_absorb_the_head_and_tail_loss():
    """A CUDA session's first ``HEAD_PAD`` and last ``TAIL_PAD``
    launches are its pads: their device records never count, the pads
    that lost theirs are the session's loss on them, and a launch of the
    quantum without a device record is a lost record."""
    head, tail = port_prof.HEAD_PAD, port_prof.TAIL_PAD
    t = float(head + tail)  # past every pad's launch
    events = [_launch(c, float(c)) for c in range(head)]
    events += [_kernel(c, t + c, "spin_kernel") for c in range(5, head)]
    events += [_launch(head, 2 * t, "cuLaunchKernelEx"),
               _launch(head + 1, 2 * t + 1, "cudaMemsetAsync"),
               _launch(head + 2, 2 * t + 2),
               {"ph": "X", "cat": "cuda_runtime",
                "name": "cudaStreamSynchronize", "ts": 2 * t + 3, "dur": 1,
                "args": {"correlation": head + 3}}]
    events += [_kernel(head, 3 * t + 10, "nvjet_tst_256x128_NNT", 40.0),
               {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)",
                "ts": 3 * t, "dur": 2.0, "args": {"correlation": head + 1}}]
    first_tail = head + 4
    events += [_launch(first_tail + c, 4 * t + c) for c in range(tail)]
    events += [_kernel(first_tail + c, 5 * t + c, "spin_kernel")
               for c in range(tail - 3)]
    got = port_prof.parse_trace_events(events, skip_head=head,
                                       skip_tail=tail)
    assert (got.launches, got.lost_records, got.pad_lost) == (3, 1, 5 + 3)
    assert got.n_ops == 2 and got.source == "device"
    assert got.compute_ns == 40_000 and got.memory_ns == 2_000
    # Unpadded, the same trace bills the pads and reports no loss.
    plain = port_prof.parse_trace_events(events)
    assert plain.n_ops == 2 + head - 5 + tail - 3
    assert plain.lost_records == 0


def test_host_sessions_carry_no_pads():
    """Off the card a session launches no pad and reports no loss."""
    prof = port_prof.TorchQuantumProfiler(device="cpu")
    assert prof._pad(port_prof.HEAD_PAD) == 0
    x = torch.ones(16, 16)
    out, stats = prof.profile(lambda: x @ x)
    assert stats is not None and stats.source == "host"
    assert (stats.launches, stats.lost_records, stats.pad_lost) == (0, 0, 0)
    assert (prof.launches, prof.records_lost, prof.samples) == (0, 0, 1)
