"""The port's native runtime under ASan/UBSan, in a subprocess.

Twin of the non-``slow`` case of ``tests/test_native_sanitizers.py``:
the port's copy of the runtime, compiled with ``-fsanitize=address`` or
``-fsanitize=undefined`` (``runtime.native.build_library("asan" |
"ubsan")``), is loaded through the ordinary ctypes bindings with nothing
changed but ``PBST_TORCH_NATIVE_LIB``, and runs a ledger, trace-ring,
histogram, doorbell, gather and sim-core round. The variable is the
port's own, so the reference's loader in the same subprocess keeps its
own library. Skips, naming the build failure, where the toolchain
cannot produce a flavor.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import textwrap

import pytest

from pbs_tpu_torch.runtime import native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FLAVORS = ("asan", "ubsan")


def _lib(flavor: str) -> str:
    try:
        return str(native.build_library(flavor))
    except native.BuildError as e:
        pytest.skip(f"native {flavor} runtime unavailable: {e}")


def _san_env(flavor: str, lib_path: str) -> dict:
    env = dict(os.environ)
    env.pop("PBST_NATIVE_LIB", None)
    env["PBST_TORCH_NATIVE_LIB"] = lib_path
    if flavor == "asan":
        # The interpreter is not ASan-built, so the runtime must come
        # first in the link order: preload gcc's own libasan.
        gcc = shutil.which("gcc") or shutil.which("g++")
        if gcc is None:
            pytest.skip("no gcc to locate libasan.so")
        probe = subprocess.run([gcc, "-print-file-name=libasan.so"],
                               capture_output=True, text=True, timeout=30)
        libasan = probe.stdout.strip()
        if not os.path.isabs(libasan):
            pytest.skip("toolchain has no libasan.so")
        env["LD_PRELOAD"] = libasan
        # CPython keeps interned allocations alive on purpose; leak
        # reports would drown an out-of-bounds access in the library.
        env["ASAN_OPTIONS"] = "detect_leaks=0"
    return env


_SMOKE = """
    import numpy as np
    from pbs_tpu_torch.runtime import native
    lib = native.load()
    assert lib is not None, native.unavailable_reason()
    assert lib._name == native._LIB_OVERRIDE, lib._name
    from pbs_tpu_torch.obs.spans import LatencyHistograms
    from pbs_tpu_torch.obs.trace import (
        TRACE_HEADER_WORDS, TRACE_REC_WORDS, EmitBatch, Ev, TraceBuffer)
    from pbs_tpu_torch.runtime.doorbell import HEADER_WORDS, Doorbell
    from pbs_tpu_torch.telemetry.counters import Counter, NUM_COUNTERS
    from pbs_tpu_torch.telemetry.ledger import SLOT_WORDS, Ledger

    assert lib.pbst_ledger_slot_words() == SLOT_WORDS
    assert lib.pbst_trace_rec_words() == TRACE_REC_WORDS
    assert lib.pbst_trace_header_words() == TRACE_HEADER_WORDS
    assert lib.pbst_db_header_words() == HEADER_WORDS

    led = Ledger(4, native="ctypes")
    led.add(2, Counter.STEPS_RETIRED, 9)
    d = np.full(NUM_COUNTERS, 3, dtype=np.uint64)
    led.add_many(2, d)
    led.resume(1, 5, d)
    led.suspend(1, d)
    assert int(led.snapshot(2)[Counter.STEPS_RETIRED]) == 12
    assert led.snapshot_many([1, 2]).shape == (2, NUM_COUNTERS)

    tb = TraceBuffer(64, native="ctypes")
    for i in range(70):
        tb.emit(1000 + i, int(Ev.SCHED_PICK), i, 7)
    recs = tb.consume()
    assert len(recs) == 64 and tb.lost == 6, (len(recs), tb.lost)
    b = EmitBatch(tb, capacity=8)
    for i in range(20):
        b.emit(i, int(Ev.SPAN_EXEC), i, -1)
    b.flush()
    assert len(tb.consume()) == 20

    h = LatencyHistograms(num_slots=8, native="ctypes")
    for v in (0, 1, 1 << 14, (1 << 63) - 1):
        h.record("t", "interactive", "queue", v)
    h.record_many(np.array([0, 1], dtype=np.int64),
                  np.array([5, 1 << 40], dtype="<u8"))

    db = Doorbell(4)
    assert db._nat is not None
    db.send(3)
    assert db.take(3) == 1 and db.wait(0, timeout_s=0.01) == 1

    base = np.arange(4096, dtype=np.uint8)
    import ctypes
    out = np.zeros(64, dtype=np.uint8)
    offs = np.array([0, 4032], dtype=np.uint64)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    n = lib.pbst_gather_rows(base.ctypes.data_as(u8), 4096,
                             native.as_u64p(offs), 2, 32,
                             out.ctypes.data_as(u8))
    assert n == 2 and out[32] == 4032 % 256

    from pbs_tpu_torch.sim.engine import SimEngine
    py = SimEngine(workload="mixed", policy="atc", seed=3, n_tenants=3,
                   horizon_ns=30_000_000, record=True, native=False).run()
    nat = SimEngine(workload="mixed", policy="atc", seed=3, n_tenants=3,
                    horizon_ns=30_000_000, record=True,
                    native="ctypes").run()
    assert nat["trace_digest"] == py["trace_digest"]
    print("SMOKE-OK")
"""


@pytest.mark.parametrize("flavor", FLAVORS)
def test_sanitizer_smoke(flavor):
    """Build the flavor from the port's sources, load it through the
    normal bindings in a subprocess, and run every entry point once."""
    lib_path = _lib(flavor)
    assert os.path.dirname(lib_path) == str(native.BUILD_DIR)
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_SMOKE)], cwd=ROOT,
        env=_san_env(flavor, lib_path), capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0 and "SMOKE-OK" in proc.stdout, (
        f"{flavor} smoke failed\n--- stdout ---\n{proc.stdout}\n"
        f"--- stderr ---\n{proc.stderr[-6000:]}")
