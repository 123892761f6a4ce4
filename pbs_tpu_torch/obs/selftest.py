"""Init-time perf self-test of the telemetry hot paths (x86_tests.c).

The port of ``pbs_tpu.obs.selftest``. The reference ships
microbenchmarks of its own hot path wired to boot:
``drivers/perfctr/x86_tests.c:1-333`` times rdpmc/rdmsr/cli-sti cycles
at module init and prints the costs, so a driver regression that makes
counter reads expensive is caught the day it lands, not when a guest
notices. Same contract here for the paths every quantum touches:

- ledger ``resume``/``suspend`` (the writer's context-switch cost),
- ledger ``snapshot`` (the monitor's lock-free read),
- trace ``emit`` (per-event record cost),
- doorbell ``send``/``take`` (the virq bridge's cost).

Each canary runs on every tier of the port's runtime the host reaches
(``runtime/native.py``): ``python``, ``native`` (the best tier, the
fastcall module when it builds) and, when that is the fastcall module,
``ctypes`` as well. The reference runs the trace and doorbell canaries
on its best tier only; the port's extra rows are its own.

Thresholds are deliberately loose (order-of-magnitude canaries, not
percent-level watchdogs): the failure mode being guarded is an
accidental O(slots) scan or a lock slipping into the per-quantum path,
which shows up as 10-100x, never 1.2x. ``pbst-torch selftest`` runs it
on demand; tests assert the canary passes in CI.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from pbs_tpu_torch.obs.trace import TraceBuffer
from pbs_tpu_torch.telemetry.counters import NUM_COUNTERS
from pbs_tpu_torch.telemetry.ledger import Ledger

#: ns/op ceilings — an order of magnitude above healthy, far below broken.
DEFAULT_THRESHOLDS_NS = {
    "ledger_resume_suspend": 500_000.0,  # healthy: ~5-40 µs (py), <1 µs (nat)
    "ledger_snapshot": 250_000.0,  # healthy: ~2-20 µs (py), <1 µs (nat)
    "trace_emit": 250_000.0,  # healthy: ~1-10 µs
    "doorbell_send_take": 250_000.0,  # healthy: ~1-10 µs
}


@dataclasses.dataclass
class CanaryResult:
    name: str
    variant: str  # 'python' | 'native' | 'ctypes'
    n_ops: int
    ns_per_op: float
    threshold_ns: float

    @property
    def ok(self) -> bool:
        return self.ns_per_op <= self.threshold_ns

    def row(self) -> str:
        state = "ok" if self.ok else "FAIL"
        return (f"{self.name:<24} {self.variant:<8} "
                f"{self.ns_per_op:>12.0f} ns/op  "
                f"(limit {self.threshold_ns:>9.0f})  {state}")


def _bench(fn, n: int) -> float:
    fn()  # warm (allocations, first-touch)
    t0 = time.perf_counter_ns()
    for _ in range(n):
        fn()
    return (time.perf_counter_ns() - t0) / n


def tiers() -> list[tuple[str, bool | str]]:
    """(variant, ``native=`` argument) of every tier this host reaches."""
    from pbs_tpu_torch.runtime import native as native_mod

    out: list[tuple[str, bool | str]] = [("python", False)]
    if native_mod.available():
        out.append(("native", True))
        if native_mod.fastcall() is not None:
            out.append(("ctypes", "ctypes"))
    return out


def _ledger_canaries(variant: str, native: bool | str, thresholds,
                     n: int) -> list[CanaryResult]:
    try:
        led = Ledger(4, native=native)
    except RuntimeError:
        return []  # native requested but unavailable on this host
    if native is not False and led._nat is None:
        return []
    deltas = np.arange(NUM_COUNTERS, dtype="<u8")
    out = []

    def cycle():
        led.resume(1, 12345)
        led.suspend(1, deltas)

    out.append(CanaryResult(
        "ledger_resume_suspend", variant, n, _bench(cycle, n),
        thresholds["ledger_resume_suspend"]))
    out.append(CanaryResult(
        "ledger_snapshot", variant, n,
        _bench(lambda: led.snapshot(1), n),
        thresholds["ledger_snapshot"]))
    return out


def run_selftest(thresholds: dict[str, float] | None = None,
                 n: int = 2000) -> list[CanaryResult]:
    """Run all canaries on every tier; returns per-path results (the
    ledger, trace and doorbell tiers are byte-compatible)."""
    from pbs_tpu_torch.runtime.doorbell import Doorbell

    th = dict(DEFAULT_THRESHOLDS_NS)
    th.update(thresholds or {})
    results: list[CanaryResult] = []
    avail = tiers()
    for variant, native in avail:
        results += _ledger_canaries(variant, native, th, n)
    for variant, native in avail:
        tb = TraceBuffer(native=native)
        results.append(CanaryResult(
            "trace_emit", variant, n,
            _bench(lambda: tb.emit(1, 7, 42, 43), n), th["trace_emit"]))
    # The doorbell has no fastcall tier: python and the C library.
    for variant, native in avail:
        if variant == "ctypes":
            continue
        db = Doorbell(n_channels=8, native=native)

        def ring():
            db.send(3)
            db.take(3)

        results.append(CanaryResult(
            "doorbell_send_take", variant, n, _bench(ring, n),
            th["doorbell_send_take"]))
    return results


def selftest_ok(results: list[CanaryResult] | None = None) -> bool:
    return all(r.ok for r in (results if results is not None
                              else run_selftest()))
