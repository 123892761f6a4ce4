"""The port's native runtime against its Python tier and the reference's.

Twins of ``tests/test_native_fastpath.py`` and
``tests/test_native_and_trace.py``, and the native cases of
``test_trace_vectorized.py`` and ``test_data.py``: the port's C entry
points, on its ctypes and fastcall binding tiers, leave the SAME buffer
bytes (seqlock version words included), drop counters and snapshot
values as its pure-Python tier and as the reference's tiers, on heap-
and file-backed buffers. Across packages: a port-native writer read by
the reference's Python reader and the reverse, and each package driving
its own ``pbst_fastcall`` module in one process. Then the build rules:
digest-named artifacts, concurrent builds that never map half a
library, and copies of the reference's C sources that differ only in
comments.

Native cases skip, naming the cached reason, only where the toolchain
is missing.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import re
import shutil
import subprocess
import sys
import sysconfig
import time

import numpy as np
import pytest

pytest.importorskip("jax", reason="parity tests need the JAX reference")

from pbs_tpu.obs import spans as ref_spans  # noqa: E402
from pbs_tpu.obs import trace as ref_trace  # noqa: E402
from pbs_tpu.runtime import native as ref_native  # noqa: E402
from pbs_tpu.telemetry import ledger as ref_ledger  # noqa: E402
from pbs_tpu_torch.obs import spans  # noqa: E402
from pbs_tpu_torch.obs.trace import (  # noqa: E402
    TRACE_HEADER_WORDS,
    TRACE_REC_WORDS,
    EmitBatch,
    Ev,
    TraceBuffer,
)
from pbs_tpu_torch.runtime import native  # noqa: E402
from pbs_tpu_torch.telemetry.counters import NUM_COUNTERS, Counter  # noqa: E402
from pbs_tpu_torch.telemetry.ledger import (  # noqa: E402
    SLOT_BYTES,
    SLOT_WORDS,
    Ledger,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: The port's tiers: python, ctypes, fastcall (ctypes where it is absent).
TIERS = [False, "ctypes", True]
IDS = ["python", "ctypes", "native"]


def _toolchain() -> bool:
    inc = sysconfig.get_paths()["include"]
    return (shutil.which("g++") is not None
            and os.path.exists(os.path.join(inc, "Python.h")))


def require_native() -> None:
    if not native.available():
        pytest.skip(f"native runtime unavailable: "
                    f"{native.unavailable_reason()}")


def _tier(mode):
    if mode:
        require_native()
    return mode


# -- the library --------------------------------------------------------------


def test_native_builds():
    """Where g++ and Python.h exist, both tiers must load: a compile
    error fails here instead of turning every native case into a skip."""
    if not _toolchain():
        pytest.skip("no g++ or Python.h on this host")
    assert native.available(), native.unavailable_reason()
    assert native.fastcall() is not None, native.last_failure()
    assert native.tier() == "fastcall"


def test_abi_getters_equal_the_python_mirrors():
    require_native()
    from pbs_tpu_torch.runtime import doorbell
    from pbs_tpu_torch.sim import native_core

    lib = native.load()
    assert lib.pbst_ledger_slot_words() == SLOT_WORDS
    assert lib.pbst_trace_rec_words() == TRACE_REC_WORDS
    assert lib.pbst_trace_header_words() == TRACE_HEADER_WORDS
    assert lib.pbst_db_header_words() == doorbell.HEADER_WORDS
    assert lib.pbst_sim_abi() == native_core.SIM_ABI_VERSION
    assert lib.pbst_sim_gs_words() == native_core.GS_WORDS
    assert lib.pbst_sim_js_words() == native_core.JS_WORDS
    assert lib.pbst_sim_jf_words() == native_core.JF_WORDS
    assert lib.pbst_sim_ev_words() == native_core.EV_WORDS
    assert native.fastcall().sim_abi() == native_core.SIM_ABI_VERSION


def _code(path: str) -> str:
    """A C++ source with its comments and blank space taken out."""
    src = open(path).read()
    src = re.sub(r"/\*.*?\*/", "", src, flags=re.S)
    src = re.sub(r"//[^\n]*", "", src)
    return "".join(src.split())


@pytest.mark.parametrize("name", ["pbst_runtime.cc", "pbst_fastcall.cc"])
def test_c_sources_are_the_reference_s_but_for_comments(name):
    """The copies keep the reference's ABI, byte layouts and arithmetic:
    only comments may differ."""
    port = os.path.join(REPO, "pbs_tpu_torch", "runtime", "csrc", name)
    ref = os.path.join(REPO, "native", name)
    assert _code(port) == _code(ref)


def test_artifacts_are_named_by_digest_into_the_port_build_dir(
        monkeypatch):
    paths = {k: native.artifact_path(k) for k in native.KIND_FLAGS}
    assert len(set(paths.values())) == len(paths)
    for p in paths.values():
        assert p.parent == native.BUILD_DIR
        assert re.search(r"-[0-9a-f]{16}\.so$", p.name)
    assert native.BUILD_DIR == (
        native.CSRC_DIR.parent.parent / "build")
    # The digest covers the flags: another flag set names another file.
    before = native.artifact_path("runtime")
    monkeypatch.setitem(native.KIND_FLAGS, "runtime", ("-DPBST_UNUSED",))
    assert native.artifact_path("runtime") != before
    monkeypatch.undo()
    assert native.artifact_path("runtime") == before
    # The git-ignored build directory is the port's.
    ignored = open(os.path.join(REPO, ".gitignore")).read().split()
    assert "pbs_tpu_torch/build/" in ignored


_BUILD = """
import sys
from pathlib import Path
from pbs_tpu_torch.runtime import native
native.BUILD_DIR = Path(sys.argv[1])
p = native.build_library("runtime")
import ctypes
lib = ctypes.CDLL(str(p))
print(lib.pbst_ledger_slot_words())
"""


def test_concurrent_first_builds_never_map_half_a_library(tmp_path):
    """Four processes build the same artifact at once into an empty
    directory: every one loads a whole library, one library is left
    (beside its lock file), and no temporary file survives."""
    if not _toolchain():
        pytest.skip("no g++ on this host")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _BUILD, str(tmp_path)], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == str(SLOT_WORDS)
    name = native.artifact_path("runtime").name
    left = sorted(os.listdir(tmp_path))
    assert left == sorted([name, name[:-3] + ".lock"]), left


def test_build_failure_reason_is_cached_and_logged(monkeypatch, tmp_path):
    """A failed build lands one console ring record and caches the
    reason; every tier then runs the Python paths."""
    from pbs_tpu_torch.obs import console

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_fc", None)
    monkeypatch.setattr(native, "_fc_tried", False)
    monkeypatch.setattr(native, "_fail_reason", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "CSRC_DIR", tmp_path)
    (tmp_path / "pbst_runtime.cc").write_text("this is not C++\n")
    before = console.read_system()["next"]
    assert native.load() is None
    reason = native.unavailable_reason()
    assert reason is not None and reason != "never attempted"
    assert native.last_failure() == reason
    assert native.tier() == "python"
    lines = console.read_system(since=before)["lines"]
    assert any("native" in ln["line"] and "fallback" in ln["line"]
               for ln in lines), lines
    assert TraceBuffer(8).tier == "python"
    assert Ledger(2).tier == "python"
    with pytest.raises(RuntimeError, match="g\\+\\+ exited"):
        Ledger(2, native=True)
    assert not list((tmp_path / "build").glob("*.tmp.so"))


def test_override_names_an_alternate_build(monkeypatch):
    """``PBST_TORCH_NATIVE_LIB`` is used as-is: a missing file is the
    cached reason, and no build is started."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_fail_reason", None)
    monkeypatch.setattr(native, "_LIB_OVERRIDE", "/nonexistent/lib.so")
    assert native.load() is None
    assert "PBST_TORCH_NATIVE_LIB=/nonexistent/lib.so" in \
        native.unavailable_reason()


def test_each_package_drives_its_own_fastcall_module():
    """Both packages load a module called ``pbst_fastcall`` into this
    process from different files; each ring runs on its own."""
    require_native()
    fc = native.fastcall()
    ref_fc = ref_native.fastcall()
    if fc is None or ref_fc is None:
        pytest.skip(f"fastcall tier unavailable: {native.last_failure()}")
    assert fc is not ref_fc
    assert os.path.dirname(fc.__file__) == str(native.BUILD_DIR)
    assert os.path.dirname(os.path.abspath(ref_fc.__file__)) == \
        os.path.join(REPO, "native")
    buf_p, buf_r = bytearray(1024), bytearray(1024)
    tb = TraceBuffer(capacity=8, buf=buf_p, native=True)
    rb = ref_trace.TraceBuffer(capacity=8, buf=buf_r, native=True)
    assert tb._fc is fc and rb._fc is ref_fc
    for i in range(11):
        assert tb.emit(i, Ev.SCHED_PICK, i, -1) == rb.emit(
            i, ref_trace.Ev.SCHED_PICK, i, -1)
    assert buf_p == buf_r and tb.lost == rb.lost == 3


# -- trace rings --------------------------------------------------------------


@pytest.mark.parametrize("mode", TIERS, ids=IDS)
def test_emit_many_random_batches_bit_identical(mode):
    """Random batch sizes over a small ring: every port tier leaves the
    same ring bytes and drop counter as the port's and the reference's
    Python rings after each step (wraps and tail-drops included)."""
    _tier(mode)
    rng = np.random.default_rng(3)
    cap = 8
    bufs = [bytearray(2048) for _ in range(3)]
    rings = [TraceBuffer(capacity=cap, buf=bufs[0], native=mode),
             TraceBuffer(capacity=cap, buf=bufs[1], native=False),
             ref_trace.TraceBuffer(capacity=cap, buf=bufs[2], native=False)]
    for step in range(200):
        k = int(rng.integers(0, 2 * cap + 1))
        recs = rng.integers(0, 2**63, size=(k, TRACE_REC_WORDS),
                            dtype=np.uint64).astype("<u8")
        assert len({r.emit_many(recs) for r in rings}) == 1
        if rng.random() < 0.4:
            n = int(rng.integers(1, cap))
            got = [r.consume(n) for r in rings]
            np.testing.assert_array_equal(got[0], got[1])
            np.testing.assert_array_equal(got[0], got[2])
        assert bufs[0] == bufs[1] == bufs[2], f"diverged at step {step}"
    assert rings[0].lost == rings[1].lost == rings[2].lost


@pytest.mark.parametrize("mode", ["ctypes", True], ids=IDS[1:])
@pytest.mark.parametrize("consumer", ["port", "ref"])
def test_emit_many_file_backed_attach(tmp_path, mode, consumer):
    """A port-native producer over a file-backed ring; a Python consumer
    of either package attached to the same file drains the identical
    stream and sees the shared lost word."""
    _tier(mode)
    path = str(tmp_path / "ring.trace")
    prod = TraceBuffer.file_backed(path, capacity=8, native=mode)
    mod = TraceBuffer if consumer == "port" else ref_trace.TraceBuffer
    cons = mod.file_backed(path, attach=True, native=False)
    recs = np.zeros((5, TRACE_REC_WORDS), dtype="<u8")
    recs[:, 0] = np.arange(5)
    recs[:, 1] = int(Ev.SCHED_PICK)
    assert prod.emit_many(recs) == 5
    np.testing.assert_array_equal(cons.consume(16), recs)
    big = np.zeros((12, TRACE_REC_WORDS), dtype="<u8")
    assert prod.emit_many(big) == 8
    assert cons.lost == 4


@pytest.mark.parametrize("mode", TIERS, ids=IDS)
def test_emit_batch_flush_is_tier_equivalent(mode):
    """EmitBatch lands the same bytes on every tier (the precomputed
    staging-pointer flush included) as the reference's on its own."""
    _tier(mode)
    buf_t, buf_r = bytearray(4096), bytearray(4096)
    tb = TraceBuffer(capacity=32, buf=buf_t, native=mode)
    ref = ref_trace.TraceBuffer(capacity=32, buf=buf_r, native=mode)
    b, rb = EmitBatch(tb, capacity=4), ref_trace.EmitBatch(ref, capacity=4)
    for i in range(11):
        b.emit(i, Ev.SPAN_DISPATCH, i, 500, -1, 2**65 + 3)
        rb.emit(i, Ev.SPAN_DISPATCH, i, 500, -1, 2**65 + 3)
    assert b.flush() == rb.flush()
    assert buf_t == buf_r
    assert b.emitted == rb.emitted and b.flushes == rb.flushes


@pytest.mark.parametrize("mode", TIERS, ids=IDS)
def test_trace_ring_roundtrip(mode):
    _tier(mode)
    tb = TraceBuffer(capacity=8, native=mode)
    for i in range(5):
        assert tb.emit(1000 + i, Ev.SCHED_PICK, i, 7)
    recs = tb.consume()
    assert recs.shape == (5, 8)
    assert [int(r[0]) for r in recs] == [1000, 1001, 1002, 1003, 1004]
    assert all(int(r[1]) == Ev.SCHED_PICK for r in recs)
    assert [int(r[2]) for r in recs] == [0, 1, 2, 3, 4]
    assert tb.tier == ({False: "python", "ctypes": "ctypes"}.get(
        mode) or native.tier())


@pytest.mark.parametrize("mode", TIERS, ids=IDS)
def test_trace_ring_overflow_counts_lost(mode):
    _tier(mode)
    tb = TraceBuffer(capacity=4, native=mode)
    for i in range(6):
        tb.emit(i, Ev.SCHED_WAKE)
    assert tb.lost == 2
    assert tb.consume().shape[0] == 4
    assert tb.emit(99, Ev.SCHED_SLEEP)


@pytest.mark.parametrize("mode", TIERS, ids=IDS)
def test_scalar_emit_masks_like_the_reference(mode):
    """Out-of-range and negative fields mask to two's complement on
    every tier, as the reference's tiers do; past six args are cut."""
    _tier(mode)
    bufs = [bytearray(1024), bytearray(1024)]
    tb = TraceBuffer(capacity=8, buf=bufs[0], native=mode)
    rb = ref_trace.TraceBuffer(capacity=8, buf=bufs[1], native=False)
    for r in (tb, rb):
        r.emit(-3, Ev.GW_ADMIT, -1, 2**64 + 5, 7)
        r.emit(5, Ev.SCHED_PICK, 1, 2, 3, 4, 5, 6, 7, 8)
        r.emit(6, Ev.SCHED_PICK)
    assert bufs[0] == bufs[1]


# -- histograms ---------------------------------------------------------------


@pytest.mark.parametrize("mode", TIERS, ids=IDS)
def test_hist_record_and_many_bit_identical(mode):
    """Scalar record + batched record_many leave byte-identical ledger
    state (version words included) on every port tier and the
    reference's Python tier."""
    _tier(mode)
    rng = np.random.default_rng(11)
    hs = [spans.LatencyHistograms(num_slots=8, native=mode),
          spans.LatencyHistograms(num_slots=8, native=False),
          ref_spans.LatencyHistograms(num_slots=8, native=False)]
    for i in range(300):
        v = int(rng.integers(0, 1 << 62))
        for h in hs:
            h.record("t%d" % (i % 3), "interactive", "queue", v)
    for h in hs:
        h.record("t0", "interactive", "queue", -7)
    slots = rng.integers(0, 7, size=257).astype(np.int64)
    values = rng.integers(0, 1 << 62, size=257,
                          dtype=np.uint64).astype("<u8")
    for h in hs:
        h.record_many(slots, values)
    np.testing.assert_array_equal(hs[0].ledger.raw(), hs[1].ledger.raw())
    np.testing.assert_array_equal(hs[0].ledger.raw(), hs[2].ledger.raw())
    assert hs[0].keys() == hs[2].keys()


@pytest.mark.parametrize("mode", ["ctypes", True], ids=IDS[1:])
def test_hist_record_many_bounds_prevalidated(mode):
    """A batch containing one bad slot mutates nothing on any tier."""
    _tier(mode)
    h = spans.LatencyHistograms(num_slots=4, native=mode)
    before = h.ledger.raw().copy()
    with pytest.raises(IndexError):
        h.record_many(np.array([0, 9], dtype=np.int64),
                      np.array([1, 1], dtype="<u8"))
    np.testing.assert_array_equal(h.ledger.raw(), before)
    with pytest.raises(IndexError):
        h.record_many(np.array([-1], dtype=np.int64),
                      np.array([1], dtype="<u8"))


@pytest.mark.parametrize("mode", TIERS, ids=IDS)
def test_hist_batch_staging_matches_scalar(mode):
    """HistBatch is invisible in the bytes: staged samples equal the
    same scalar records in the reference, slot interning included."""
    _tier(mode)
    rng = np.random.default_rng(5)
    staged = spans.LatencyHistograms(num_slots=16, native=mode)
    scalar = ref_spans.LatencyHistograms(num_slots=16, native=False)
    hb = spans.HistBatch(staged, capacity=8)
    keys = [("a", "interactive", "queue"), ("b", "batch", "e2e"),
            ("be:x", "*", "service")]
    for _ in range(100):
        who, cls, stage = keys[int(rng.integers(0, 3))]
        v = int(rng.integers(0, 1 << 40))
        hb.record(who, cls, stage, v)
        scalar.record(who, cls, stage, v)
    hb.flush()
    np.testing.assert_array_equal(staged.ledger.raw(), scalar.ledger.raw())
    assert staged.keys() == scalar.keys()
    for who, cls, stage in keys:
        assert staged.quantile(who, cls, stage, 0.99) == \
            scalar.quantile(who, cls, stage, 0.99)
    assert hb.flushes == (0 if mode is False else 13)


def test_hist_batch_python_tier_degrades_to_direct():
    h = spans.LatencyHistograms(num_slots=8, native=False)
    hb = spans.HistBatch(h, capacity=64)
    hb.record("t", "interactive", "queue", 1 << 20)
    assert hb.pending() == 0
    assert int(h.counts("t", "interactive", "queue").sum()) == 1
    assert hb.flush() == 0


def test_hist_bucket_edges_pure():
    """The C bucketing equals hist_bucket exactly at the edges."""
    require_native()
    h = spans.LatencyHistograms(num_slots=4, native=True)
    r = ref_spans.LatencyHistograms(num_slots=4, native=False)
    edges = [0, 1, (1 << 13) - 1, 1 << 13, (1 << 14) - 1, 1 << 14,
             1 << 30, (1 << 31) - 1, 1 << 62, (1 << 63) - 1]
    for v in edges:
        h.record("t", "interactive", "queue", v)
        r.record("t", "interactive", "queue", v)
    np.testing.assert_array_equal(h.counts("t", "interactive", "queue"),
                                  r.counts("t", "interactive", "queue"))


# -- ledgers ------------------------------------------------------------------


@pytest.mark.parametrize("mode", TIERS, ids=IDS)
def test_ledger_writes_bit_identical(mode):
    """resume/suspend/add/add_many/reset leave the reference's bytes,
    version words included, and snapshots read the same sums."""
    _tier(mode)
    rng = np.random.default_rng(23)
    bufs = [bytearray(4 * SLOT_BYTES) for _ in range(2)]
    led = Ledger(4, buf=bufs[0], native=mode)
    ref = ref_ledger.Ledger(4, buf=bufs[1], native=False)
    for step in range(300):
        slot = int(rng.integers(0, 4))
        op = int(rng.integers(0, 5))
        d = rng.integers(0, 1 << 40, size=NUM_COUNTERS,
                         dtype=np.uint64).astype("<u8")
        now_ns = int(rng.integers(0, 3)) * 1000
        for lg in (led, ref):
            if op == 0:
                lg.resume(slot, now_ns, d)
            elif op == 1:
                lg.suspend(slot, d)
            elif op == 2:
                lg.add(slot, int(d[0] % NUM_COUNTERS), int(d[1]))
            elif op == 3:
                lg.add_many(slot, d)
            else:
                lg.reset(slot)
        assert bufs[0] == bufs[1], f"diverged at step {step}"
        assert led.tsc_start(slot) == ref.tsc_start(slot)
        np.testing.assert_array_equal(led.snapshot(slot), ref.snapshot(slot))


@pytest.mark.parametrize("mode", TIERS, ids=IDS)
def test_snapshot_many_random_slot_vectors(mode):
    _tier(mode)
    rng = np.random.default_rng(17)
    led = Ledger(16, native=mode)
    for s in range(16):
        led.add_many(s, rng.integers(0, 1 << 30, size=NUM_COUNTERS,
                                     dtype=np.uint64).astype("<u8"))
    for _ in range(20):
        k = int(rng.integers(1, 16))
        idx = rng.integers(0, 16, size=k).tolist()
        many = led.snapshot_many(idx)
        assert many.shape == (k, NUM_COUNTERS)
        for row, s in zip(many, idx):
            np.testing.assert_array_equal(row, led.snapshot(int(s)))


@pytest.mark.parametrize("mode", ["ctypes", True], ids=IDS[1:])
def test_snapshot_many_file_backed_and_bounds(tmp_path, mode):
    _tier(mode)
    path = str(tmp_path / "led.bin")
    led = Ledger.file_backed(path, num_slots=4, native=mode)
    led.add(2, 3, 41)
    mon = Ledger.file_backed(path, readonly=True, native=mode)
    np.testing.assert_array_equal(mon.snapshot_many([2])[0], led.snapshot(2))
    ref_mon = ref_ledger.Ledger.file_backed(path, readonly=True,
                                            native=False)
    np.testing.assert_array_equal(ref_mon.snapshot_many([2])[0],
                                  led.snapshot(2))
    for bad in ([0, 4], [-1]):
        with pytest.raises(IndexError):
            led.snapshot_many(bad)


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_native_python_interop_across_packages(writer):
    """One package's native writer, the other's Python reader, over one
    buffer (and the reverse direction within the same buffer)."""
    require_native()
    buf = bytearray(2 * SLOT_BYTES)
    if writer == "port":
        nat = Ledger(2, buf=buf, native=True)
        py = ref_ledger.Ledger(2, buf=buf, native=False)
    else:
        nat = ref_ledger.Ledger(2, buf=buf, native=True)
        py = Ledger(2, buf=buf, native=False)
    nat.add(0, Counter.STEPS_RETIRED, 7)
    assert py.snapshot(0)[Counter.STEPS_RETIRED] == 7
    py.add(1, Counter.TOKENS, 3)
    assert nat.snapshot(1)[Counter.TOKENS] == 3
    d = np.zeros(NUM_COUNTERS, dtype=np.uint64)
    d[Counter.DEVICE_TIME_NS] = 1000
    nat.resume(0, now_ns=0)
    assert py.is_running(0)
    nat.suspend(0, d)
    assert py.snapshot(0)[Counter.DEVICE_TIME_NS] == 1000
    assert not py.is_running(0)


def _hammer_writer(shm_name, iters):
    from multiprocessing import shared_memory

    from pbs_tpu_torch.telemetry.ledger import Ledger as L

    shm = shared_memory.SharedMemory(name=shm_name)
    led = L(1, buf=shm.buf, native=True)
    d = np.zeros(NUM_COUNTERS, dtype=np.uint64)
    d[Counter.STEPS_RETIRED] = 1
    d[Counter.DEVICE_TIME_NS] = 1
    for _ in range(iters):
        led.add_many(0, d)
    del led
    shm.close()


def test_seqlock_cross_process_consistency():
    """A port-native writer in another process; this process's port and
    reference readers never see the two lockstep counters apart."""
    require_native()
    from multiprocessing import shared_memory

    shm = shared_memory.SharedMemory(create=True, size=SLOT_BYTES)
    led = ref_led = None
    try:
        led = Ledger(1, buf=shm.buf, native=True)
        ref_led = ref_ledger.Ledger(1, buf=shm.buf, native=False)
        iters = 20_000
        p = mp.get_context("spawn").Process(
            target=_hammer_writer, args=(shm.name, iters))
        p.start()
        torn = reads = 0
        deadline = time.monotonic() + 120
        while p.is_alive() and time.monotonic() < deadline:
            for k in range(2):
                try:
                    snap = (led if k == 0 else ref_led).snapshot(0)
                except RuntimeError:
                    time.sleep(0.001)  # writer descheduled mid-write
                    continue
                reads += 1
                if snap[Counter.STEPS_RETIRED] != \
                        snap[Counter.DEVICE_TIME_NS]:
                    torn += 1
        p.join(30)
        assert torn == 0, f"{torn}/{reads} torn snapshots"
        assert reads > 0
        assert led.snapshot(0)[Counter.STEPS_RETIRED] == iters
    finally:
        import gc

        led = ref_led = None
        gc.collect()
        shm.close()
        shm.unlink()


# -- fallbacks ----------------------------------------------------------------


def test_everything_degrades_without_native(monkeypatch):
    """load() -> None: rings, ledgers, histograms and batches all run
    the pure-Python paths; ``native=True`` raises."""
    monkeypatch.setattr(native, "load", lambda: None)
    tb = TraceBuffer(capacity=8)
    assert tb._nat is None and tb._fc is None and tb.tier == "python"
    assert tb.emit(1, Ev.SCHED_PICK, 7)
    led = Ledger(2)
    led.add(0, 1, 5)
    assert int(led.snapshot_many([0])[0][1]) == 5
    h = spans.LatencyHistograms(num_slots=4)
    spans.HistBatch(h).record("t", "interactive", "queue", 1 << 20)
    assert h.quantile("t", "interactive", "queue", 0.5) > 0
    with pytest.raises(RuntimeError, match="unavailable"):
        TraceBuffer(capacity=8, native=True)


def test_ctypes_tier_without_fastcall(monkeypatch):
    require_native()
    monkeypatch.setattr(native, "fastcall", lambda: None)
    tb = TraceBuffer(capacity=8)
    assert tb._nat is not None and tb._fc is None and tb.tier == "ctypes"
    assert tb.emit(1, Ev.SCHED_PICK, 7)
    assert tb.consume(8).shape == (1, TRACE_REC_WORDS)
    h = spans.LatencyHistograms(num_slots=4)
    assert h._fc is None and h._nat is not None
    h.record("t", "interactive", "queue", 1 << 20)
    assert int(h.counts("t", "interactive", "queue").sum()) == 1


# -- the main path picks the native tiers -------------------------------------


def test_partition_and_gateway_pick_the_native_tiers(tmp_path):
    """``Partition()`` and ``Gateway()`` get the native ledger, rings and
    histograms by default, file-backed included, as the reference's do;
    the partition's records are the SCHED_* stream."""
    require_native()
    from pbs_tpu_torch.gateway import Gateway, SimServeBackend
    from pbs_tpu_torch.obs.trace import format_records
    from pbs_tpu_torch.runtime import Job, Partition
    from pbs_tpu_torch.telemetry import SimBackend, SimProfile

    want = native.tier()
    be = SimBackend()
    part = Partition("t", source=be, scheduler="credit",
                     ledger_path=str(tmp_path / "p.led"),
                     trace_dir=str(tmp_path))
    be.register("a", SimProfile.steady())
    part.add_job(Job("a", max_steps=3))
    part.run()
    assert part.ledger.tier == want
    assert {t.tier for t in part.traces} == {want}
    recs = part.drain_traces()
    events = [int(r[1]) for r in recs]
    assert Ev.SCHED_PICK in events and Ev.SCHED_DESCHED in events
    assert any("SCHED_PICK" in ln for ln in format_records(recs))
    gw = Gateway(backends=[SimServeBackend("b0")], trace_capacity=64,
                 ledger_path=str(tmp_path / "gw.led"))
    assert gw.trace.tier == want
    assert gw._ledger.tier == want
    assert gw.hist.ledger.tier == want


# -- the corpus gather ----------------------------------------------------------


@pytest.mark.parametrize("itemsize", [2, 4])
def test_gather_rows_equals_the_numpy_gather(tmp_path, itemsize):
    """``pbst_gather_rows`` behind the token dataset returns the numpy
    gather's bytes, the reference's rows, and refuses a window past the
    end with nothing written."""
    require_native()
    import pbs_tpu.data.tokens as ref_tokens
    import pbs_tpu_torch.data.tokens as tokens

    rng = np.random.default_rng(itemsize)
    vocab = 60_000 if itemsize == 2 else 100_000
    toks = rng.integers(0, vocab, size=50_000).astype(np.int64)
    path = str(tmp_path / "c.bin")
    tokens.write_token_file(path, toks)
    ds = tokens.TokenDataset(path)
    ref = ref_tokens.TokenDataset(path)
    assert ds._nat is not None and ds.itemsize == itemsize
    starts = rng.integers(0, 50_000 - 256, size=64).astype(np.int64)
    got = ds._gather(starts, 256)
    want = np.stack([toks[s:s + 256] for s in starts]).astype(np.int32)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ref._gather(starts, 256))
    with pytest.raises((IndexError, ValueError)):
        ds._gather(np.array([50_000 - 8], dtype=np.int64), 64)
