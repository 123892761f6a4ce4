"""Named microbenchmarks of the framework's hot paths.

The port of ``pbs_tpu.perf.bench``: the same registry, name for name,
with the reference's op counts, rounds and ``--check`` armor, over the
port's trace rings, spans, histograms, ledger, fair queue, simulator,
sweep, journal, gateway, counter ladder and RPC. The numbers are the
port's own and are gated against the port's own ``baseline.json``.

Each bench is a factory returning ``(run, reset, teardown)``:
``reset()`` restores pre-round state (drain the ring, refill the
slab), ``run()`` executes the timed ops and returns the op count, and
``teardown()`` releases external resources (sockets). The driver times
``rounds`` rounds and keeps the best ns/op (minimum — the standard
microbench estimator for the noise floor), then takes one tracemalloc
snapshot pass for allocation accounting.

Everything runs on the host, torch-free, in one of TWO modes, compared
against its own baseline map:

- **python mode** (default, ``native=False`` everywhere): pins the
  pure-Python hot paths — the verified fallback CI images and
  laptops without a toolchain actually execute. A regression here
  can't hide behind the native library.
- **native mode** (``--native``; substrate benches only): the same
  benches over the C runtime (``native=True`` — fastcall tier when
  Python.h was available at build time, ctypes otherwise), so a
  native-path regression fails CI exactly like a Python one. The C
  runtime is the port's own copy (``runtime/csrc/``), built at first
  use by ``runtime/native.py``.
"""

from __future__ import annotations

import dataclasses
import gc
import time
import tracemalloc
from typing import Callable

import numpy as np

MS_NS = 1_000_000

#: (run, reset, teardown) — see module docstring.
BenchFns = tuple[Callable[[], int], Callable[[], None],
                 Callable[[], None] | None]


@dataclasses.dataclass
class BenchResult:
    name: str
    ops: int  # ops per timed round
    rounds: int
    ns_per_op: float
    ops_per_s: float
    #: Net allocated blocks per op across one traced round (tracemalloc
    #: snapshot diff) — catches per-op garbage accumulation and leaks.
    alloc_blocks_per_op: float
    #: High-water tracemalloc bytes over the traced round — catches
    #: transient per-op allocation storms.
    alloc_peak_kib: float

    def as_dict(self) -> dict:
        return {
            "ops": self.ops,
            "rounds": self.rounds,
            # Sub-ns/op benches (sim.sustained counts simulated ns as
            # ops) need more than one decimal or the regression ratio
            # quantizes to coarse steps.
            "ns_per_op": round(self.ns_per_op,
                               1 if self.ns_per_op >= 10 else 4),
            "ops_per_s": round(self.ops_per_s, 1),
            "alloc_blocks_per_op": round(self.alloc_blocks_per_op, 4),
            "alloc_peak_kib": round(self.alloc_peak_kib, 1),
        }


# -- bench factories --------------------------------------------------------


def _trace_emit(n: int, native: bool = False) -> BenchFns:
    from pbs_tpu_torch.obs.trace import Ev, TraceBuffer

    tb = TraceBuffer(capacity=n, native=native)
    ev = int(Ev.SCHED_PICK)

    def run() -> int:
        emit = tb.emit
        for i in range(n):
            emit(i, ev, 3, 200_000, 7)
        return n

    def reset() -> None:
        while tb.consume(4096).shape[0]:
            pass

    return run, reset, None


def _trace_emit_many(n: int, native: bool = False) -> BenchFns:
    from pbs_tpu_torch.obs.trace import TRACE_REC_WORDS, Ev, TraceBuffer

    batch = 256
    inner = max(1, n // batch)
    tb = TraceBuffer(capacity=inner * batch, native=native)
    recs = np.zeros((batch, TRACE_REC_WORDS), dtype="<u8")
    recs[:, 0] = np.arange(batch)
    recs[:, 1] = int(Ev.SCHED_DESCHED)
    recs[:, 2] = 7

    def run() -> int:
        emit_many = tb.emit_many
        for _ in range(inner):
            emit_many(recs)
        return inner * batch

    def reset() -> None:
        while tb.consume(4096).shape[0]:
            pass

    return run, reset, None


def _trace_consume(n: int, native: bool = False) -> BenchFns:
    from pbs_tpu_torch.obs.trace import TRACE_REC_WORDS, Ev, TraceBuffer

    tb = TraceBuffer(capacity=n, native=native)
    recs = np.zeros((n, TRACE_REC_WORDS), dtype="<u8")
    recs[:, 0] = np.arange(n)
    recs[:, 1] = int(Ev.SCHED_WAKE)

    def run() -> int:
        got = 0
        while got < n:
            chunk = tb.consume(1024).shape[0]
            if chunk == 0:
                break
            got += chunk
        return got or 1

    def reset() -> None:
        tb.consume(10**9)  # drop any leftovers, then refill
        tb.emit_many(recs)

    return run, reset, None


def _span_emit(n: int, native: bool = False) -> BenchFns:
    """One SPAN_* lifecycle emit through the SpanRecorder's EmitBatch
    staging path: the cost every gateway dispatch
    pays when spans are armed, pinned so span overhead is regression-
    gated like the rest of the substrate."""
    from pbs_tpu_torch.obs.spans import SpanRecorder
    from pbs_tpu_torch.obs.trace import TraceBuffer

    ring = TraceBuffer(capacity=n + 512, native=native)
    rec = SpanRecorder(ring=ring)
    rec.dispatch(0, "r0", 1, 500, 1000, "gw")  # intern outside timing

    def run() -> int:
        dispatch = rec.dispatch
        for i in range(n):
            dispatch(i, "r0", 1, 500, 1000, "gw")
        rec.flush()
        return n

    def reset() -> None:
        rec.flush()
        while ring.consume(4096).shape[0]:
            pass

    return run, reset, None


def _hist_record(n: int, native: bool = False) -> BenchFns:
    """One log2-histogram latency sample into a ledger slot
    (LatencyHistograms.record — bucket + seqlock fused into one native
    call in native mode): the per-completion cost of the SLO
    observability layer."""
    from pbs_tpu_torch.obs.spans import LatencyHistograms

    h = LatencyHistograms(num_slots=16, native=native)
    h.record("t0", "interactive", "queue", 1 << 12)  # intern the slot

    def run() -> int:
        record = h.record
        for i in range(n):
            record("t0", "interactive", "queue", 1 << (10 + (i & 15)))
        return n

    return run, lambda: None, None


def _hist_record_many(n: int, native: bool = False) -> BenchFns:
    """Batched histogram samples (LatencyHistograms.record_many, the
    HistBatch flush path of the gateway's batched pump): ns per staged
    sample when a tick's worth lands as one call."""
    from pbs_tpu_torch.obs.spans import LatencyHistograms

    h = LatencyHistograms(num_slots=16, native=native)
    batch = 256
    inner = max(1, n // batch)
    slots = np.zeros(batch, dtype=np.int64)
    slots[:] = h.slot_of("t0", "interactive", "queue")
    values = (np.arange(batch, dtype="<u8") % 24 + 1) << 10

    def run() -> int:
        record_many = h.record_many
        for _ in range(inner):
            record_many(slots, values)
        return inner * batch

    return run, lambda: None, None


def _ledger_snapshot_many(n: int, native: bool = False) -> BenchFns:
    from pbs_tpu_torch.telemetry.counters import NUM_COUNTERS
    from pbs_tpu_torch.telemetry.ledger import Ledger

    slots = 64
    led = Ledger(slots, native=native)
    deltas = np.arange(NUM_COUNTERS, dtype="<u8")
    for s in range(slots):
        led.add_many(s, deltas)
    idx = list(range(slots))
    inner = max(1, n // slots)

    def run() -> int:
        sample = led.snapshot_many
        for _ in range(inner):
            sample(idx)
        return inner * slots

    return run, lambda: None, None


def _fairqueue_cycle(n: int) -> BenchFns:
    from pbs_tpu_torch.gateway.admission import BATCH, INTERACTIVE
    from pbs_tpu_torch.gateway.fairqueue import DeficitRoundRobin, Request

    q = DeficitRoundRobin()
    tenants = ["t0", "t1", "t2", "t3"]
    for t in tenants:
        q.set_weight(t, 256)

    def run() -> int:
        push, pop = q.push, q.pop
        for i in range(n):
            push(Request(
                rid=str(i), tenant=tenants[i & 3],
                slo=INTERACTIVE if i & 1 else BATCH, cost=1,
                payload=None, submit_ns=i))
        while pop() is not None:
            pass
        return n

    return run, lambda: None, None


def _sim_smoke(n: int) -> BenchFns:
    """End-to-end sanity point: virtual-time dispatch loop cost per
    quantum (engine + partition + credit/feedback stack, pinned to the
    pure-Python witness path). ``n`` scales the horizon in virtual
    milliseconds."""
    from pbs_tpu_torch.sim.engine import SimEngine

    def run() -> int:
        eng = SimEngine(workload="stable", policy="feedback", seed=0,
                        n_tenants=2, horizon_ns=n * MS_NS, record=False,
                        native=False)
        rep = eng.run()
        return max(1, int(rep["quanta"]))

    return run, lambda: None, None


def _sim_sustained(n: int, native: bool = False) -> BenchFns:
    """The sweep-throughput headline: simulated-ns per wall-ns of one sweep-mode engine run
    (mixed workload, feedback armed — the exact configuration a
    ``pbst-torch tune`` cell executes). ``n`` scales the horizon in virtual
    milliseconds; ops = simulated ns, so ns/op is wall-ns PER
    SIMULATED-ns (0.125 = the sim runs 8x faster than real time).
    Dual-mode: python mode pins the witness engine (``native=False``),
    native mode requires the C dispatch core — a regression in either
    fails ``pbst-torch perf --check`` like-with-like."""
    from pbs_tpu_torch.sim.engine import SimEngine

    def run() -> int:
        eng = SimEngine(workload="mixed", policy="feedback", seed=0,
                        n_tenants=4, horizon_ns=n * MS_NS, record=False,
                        native=native)  # bool: required OR pinned-off
        rep = eng.run()
        return max(1, int(rep["elapsed_ns"]))

    return run, lambda: None, None


def _sweep_cell(n: int, native: bool = False) -> BenchFns:
    """Per-cell cost of the parallel-sweep substrate (sim/sweep.py,
    inline worker path): seed derivation + sweep-mode engine + report
    reduction, over ``n`` 20 ms cells. Dual-mode like sim.sustained."""
    from pbs_tpu_torch.sim.sweep import build_grid, run_cell

    cells = build_grid(["mixed"], ["feedback"], n_reps=n,
                       horizon_ns=20 * MS_NS)

    def run() -> int:
        for cell in cells:
            run_cell(cell, base_seed=0, native=native)
        return len(cells)

    return run, lambda: None, None


def _journal_append(n: int) -> BenchFns:
    """Write-ahead journal staging + group commit (gateway/journal.py):
    ns per intent record when a tick's worth (256)
    stages through the EmitBatch path and lands as ONE CRC'd frame
    write — the marginal cost every admitted request pays once the
    journal is armed."""
    import os
    import tempfile

    from pbs_tpu_torch.gateway.journal import HEADER_WORDS, GatewayJournal

    d = tempfile.mkdtemp(prefix="pbst-jr-bench-")
    path = os.path.join(d, "bench.jrnl")
    j = GatewayJournal.create(path)
    for name in ("gw", "t0", "r0"):
        j.intern(name)  # steady state: names interned outside timing
    j.commit()
    batch = 256
    inner = max(1, n // batch)

    def run() -> int:
        admit = j.admit
        for _ in range(inner):
            for i in range(batch):
                admit(i, "gw", "r0", "t0", 0, 1, 1)
            j.commit()
        return inner * batch

    def reset() -> None:
        os.ftruncate(j._fd, HEADER_WORDS * 8)
        os.lseek(j._fd, 0, os.SEEK_END)

    def teardown() -> None:
        import shutil

        os.close(j._fd)
        shutil.rmtree(d, ignore_errors=True)

    return run, reset, teardown


def _gateway_pump(n: int) -> BenchFns:
    """Full gateway pump round-trip with the journal ARMED on top of
    the complete observability stack (spans + histograms + ledger +
    trace staging): wall-ns per completed request through submit →
    admit → dispatch → complete → group commit."""
    import os
    import tempfile

    from pbs_tpu_torch.gateway.admission import TenantQuota
    from pbs_tpu_torch.gateway.backends import SimServeBackend
    from pbs_tpu_torch.gateway.gateway import Gateway
    from pbs_tpu_torch.gateway.journal import GatewayJournal
    from pbs_tpu_torch.utils.clock import MS as _MS, VirtualClock

    d = tempfile.mkdtemp(prefix="pbst-pump-bench-")
    clock = VirtualClock()
    j = GatewayJournal.create(os.path.join(d, "gw.jrnl"))
    gw = Gateway(
        [SimServeBackend("b0", n_slots=8, service_ns_per_cost=_MS,
                         seed=0)],
        clock=clock, trace_capacity=4096,
        ledger_path=os.path.join(d, "gw.led"), journal=j,
        max_queued=1 << 16)
    gw.register_tenant("t0", TenantQuota(
        rate=1e9, burst=1e6, slo="interactive", max_queued=1 << 16))

    def run() -> int:
        done = 0
        submit, tick = gw.submit, gw.tick
        while done < n:
            for _ in range(8):
                submit("t0", None, cost=1)
            clock.advance(2 * _MS)
            done += len(tick())
        return max(1, done)

    def reset() -> None:
        # Drain the ring so staged observability never hits the
        # full-ring drop path mid-round.
        while gw.trace.consume(4096).shape[0]:
            pass

    def teardown() -> None:
        import shutil

        os.close(j._fd)
        shutil.rmtree(d, ignore_errors=True)

    return run, reset, teardown


def _hwtelem_sample(n: int) -> BenchFns:
    """One live counter-ladder sample (HwCounterSource.sample): the
    marginal cost every gateway tick pays once ``--hw`` is armed.
    Times whatever tier the box grants — perf_event read(2) per event
    where the host allows it, getrusage at the ladder floor, the
    empty-dict fast path when no tier probes — so the gate pins the
    sampling seam, not one kernel interface."""
    from pbs_tpu_torch.hwtelem.sources import HwCounterSource

    src = HwCounterSource(probe=True)
    src.sample()  # prime the delta baseline outside the timed region

    def run() -> int:
        sample = src.sample
        for _ in range(n):
            sample()
        return n

    def teardown() -> None:
        src.close()

    return run, lambda: None, teardown


def _rpc_roundtrip(n: int) -> BenchFns:
    from pbs_tpu_torch.dist.rpc import RpcClient, RpcServer

    srv = RpcServer().start()
    srv.register("echo", lambda x=0: x)
    cli = RpcClient(srv.address, deadline_s=30.0)
    cli.call("echo", x=0)  # connect outside the timed region

    def run() -> int:
        call = cli.call
        for i in range(n):
            call("echo", x=i)
        return n

    def teardown() -> None:
        cli.close()
        srv.stop()

    return run, lambda: None, teardown


#: name -> (factory, full_n, quick_n). ns/op is per *op*: one record
#: for the trace benches, one slot sample, one queue cycle, one
#: dispatched quantum, one RPC call.
BENCHES: dict[str, tuple[Callable[..., BenchFns], int, int]] = {
    "trace.emit": (_trace_emit, 50_000, 8_192),
    "trace.emit_many": (_trace_emit_many, 65_536, 8_192),
    "trace.consume": (_trace_consume, 65_536, 8_192),
    "span.emit": (_span_emit, 50_000, 8_192),
    "hist.record": (_hist_record, 50_000, 8_192),
    "hist.record_many": (_hist_record_many, 65_536, 8_192),
    # quick keeps >=100 timed snapshot_many calls: fewer lets one
    # scheduler hiccup read as a 2x "regression" in the CI smoke.
    "ledger.snapshot_many": (_ledger_snapshot_many, 12_800, 6_400),
    "fairqueue.cycle": (_fairqueue_cycle, 10_000, 2_000),
    "journal.append": (_journal_append, 65_536, 8_192),
    # ops = completed requests; ns/op is the full armed-journal pump
    # round-trip per request.
    "gateway.pump": (_gateway_pump, 2_000, 400),
    "sim.smoke": (_sim_smoke, 100, 25),
    # n is the horizon in virtual ms / the cell count; ns/op for
    # sim.sustained is wall-ns per simulated-ns (lower = faster sim).
    "sim.sustained": (_sim_sustained, 2_000, 250),
    "sweep.cell": (_sweep_cell, 24, 6),
    # ops = ladder samples; syscall-bound (one read(2) per armed
    # event) so the per-op cost tracks the kernel, not this code.
    "hwtelem.sample": (_hwtelem_sample, 20_000, 2_000),
    "rpc.roundtrip": (_rpc_roundtrip, 300, 50),
}

#: Benches with a native fast path — the ``--native`` matrix. The
#: rest (pure-Python data structures, sockets) have exactly one
#: implementation, so a second mode would gate nothing. sim.sustained
#: and sweep.cell ride the native sim dispatch core in native mode
#: (required, not best-effort) and pin the pure-Python witness engine
#: in python mode, so a regression on either tier fails
#: ``pbst-torch perf --check`` like-with-like.
NATIVE_BENCHES = (
    "trace.emit", "trace.emit_many", "trace.consume", "span.emit",
    "hist.record", "hist.record_many", "ledger.snapshot_many",
    "sim.sustained", "sweep.cell",
)


#: Per-bench --check armor: effective threshold = max(CLI threshold,
#: this). The wall-clock-bound benches ride the OS scheduler — a
#: loopback RPC's socket+thread handoffs measure 2-3x apart run to run
#: on a healthy host, and the sim engine drags the whole runtime stack
#: — so their variance is environment, not code. The single-digit-
#: ns/op BULK-COPY benches are memory-bandwidth-bound: under a loaded
#: host (tier-1 runs the whole suite around them) a 2x swing is cache/
#: bandwidth contention, while a real regression (losing the
#: vectorized/native path) is 10-100x — 3x armor keeps the gate
#: meaningful without flaking. Applies in both modes. The pure-compute
#: benches keep the tight default.
CHECK_THRESHOLDS: dict[str, float] = {
    "rpc.roundtrip": 4.0,
    # Pure syscall round-trips: on a 1-vCPU container the kernel-side
    # cost swings with host load the same way the socket benches do.
    "hwtelem.sample": 4.0,
    # File I/O (page-cache writes) + whole-stack pump: wall-clock-
    # bound like the sim benches, same 3x host-variance armor.
    "journal.append": 3.0,
    "gateway.pump": 3.0,
    "sim.smoke": 3.0,
    "sim.sustained": 3.0,
    "sweep.cell": 3.0,
    "trace.consume": 3.0,
    "trace.emit_many": 3.0,
    "hist.record_many": 3.0,
    "ledger.snapshot_many": 3.0,
}


def bench_names(native: bool = False) -> list[str]:
    return list(NATIVE_BENCHES) if native else list(BENCHES)


def run_bench(name: str, quick: bool = False, rounds: int = 5,
              native: bool = False) -> BenchResult:
    try:
        factory, full_n, quick_n = BENCHES[name]
    except KeyError:
        raise KeyError(
            f"unknown bench {name!r}; available: {bench_names()}") from None
    if native and name not in NATIVE_BENCHES:
        raise KeyError(
            f"bench {name!r} has no native mode; native benches: "
            f"{list(NATIVE_BENCHES)}")
    n = quick_n if quick else full_n
    run, reset, teardown = (
        factory(n, native=True) if native else factory(n))
    try:
        # Warm round: first-touch, caches, lazy imports.
        reset()
        ops = run()
        best = float("inf")
        for _ in range(rounds):
            reset()
            # Collect BEFORE and pause cyclic GC DURING the timed
            # region: a collection pause landing inside a short round
            # reads as a phantom 2x regression (best-of-N can't save a
            # round-count of 1-3 from a determined GC).
            gc.collect()
            gc.disable()
            try:
                t0 = time.perf_counter_ns()
                ops = run()
                dt = time.perf_counter_ns() - t0
            finally:
                gc.enable()
            best = min(best, dt / ops)
        # Allocation pass, untimed (tracing skews timing 2-10x).
        reset()
        gc.collect()
        tracemalloc.start()
        try:
            before = tracemalloc.take_snapshot()
            tracemalloc.reset_peak()
            cur0, _ = tracemalloc.get_traced_memory()
            ops = run()
            _cur1, peak = tracemalloc.get_traced_memory()
            after = tracemalloc.take_snapshot()
        finally:
            tracemalloc.stop()
        diff = after.compare_to(before, "filename")
        net_blocks = float(sum(d.count_diff for d in diff))
        return BenchResult(
            name=name, ops=ops, rounds=rounds, ns_per_op=best,
            ops_per_s=1e9 / best if best > 0 else 0.0,
            alloc_blocks_per_op=net_blocks / ops,
            alloc_peak_kib=max(0, peak - cur0) / 1024.0,
        )
    finally:
        if teardown is not None:
            teardown()
