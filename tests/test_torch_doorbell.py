"""``pbs_tpu_torch.runtime.doorbell`` against ``pbs_tpu.runtime.doorbell``.

Every case of ``tests/test_doorbell.py`` but its slow real-clock soak
is written as a function of a package namespace and a tier: it runs on
both packages, on the Python tier and on the native one, makes the
reference test's own assertions on each, and the observables (counts,
sequences, errors, the block's bytes) must be equal. Then across
packages: a block written by one package's native sender reads the
same through the other's Python tier, and a port sender wakes a
waiter in a second process, with no RPC.
"""

from __future__ import annotations

import importlib
import os
import subprocess
import sys
import time
import types

import numpy as np
import pytest

pytest.importorskip("jax", reason="parity tests need the JAX reference")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MS = 1_000_000


def _ns(root: str) -> types.SimpleNamespace:
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    return types.SimpleNamespace(
        root=root, rt=mod("runtime"), db=mod("runtime.doorbell"),
        native=mod("runtime.native"), tel=mod("telemetry"))


REF = _ns("pbs_tpu")
PORT = _ns("pbs_tpu_torch")
TIERS = [False, True]


def _need(P, tier) -> None:
    if tier and not P.native.available():
        pytest.skip(f"{P.root} native runtime unavailable: "
                    f"{P.native.unavailable_reason()}")


def _bytes(db) -> bytes:
    return db._arr.tobytes()


def c_send_take_counts(P, tier, d):
    db = P.rt.Doorbell(n_channels=8, native=tier)
    out = [db.pending(3), db.send(3), db.send(3), db.seq(), db.pending(3),
           db.take(3), db.pending(3), db.take(3)]
    assert out == [0, 1, 2, 2, 2, 2, 0, 0]
    return [out, _bytes(db)]


def c_channel_bounds(P, tier, d):
    db = P.rt.Doorbell(n_channels=2, native=tier)
    with pytest.raises(IndexError):
        db.send(2)
    return _bytes(db)


def c_wait_returns_on_ring_and_timeout(P, tier, d):
    db = P.rt.Doorbell(n_channels=4, native=tier)
    s0 = db.seq()
    assert db.wait(s0, timeout_s=0.05) == s0
    db.send(1)
    assert db.wait(s0, timeout_s=5.0) == s0 + 1
    assert db.wait(s0, timeout_s=5.0) == s0 + 1
    return [s0, db.seq(), _bytes(db)]


def c_bridge_forwards_virqs(P, tier, d):
    bus = P.rt.EventBus(synchronous=True)
    db = P.rt.Doorbell(n_channels=64, native=tier)
    seen = []
    bus.bind_virq(P.rt.Virq.TELEMETRY, lambda p: seen.append(p))
    P.rt.bridge_events(bus, db)
    bus.send_virq(P.rt.Virq.TELEMETRY)
    bus.send_virq(P.rt.Virq.JOB_FAILED)
    assert seen == [int(P.rt.Virq.TELEMETRY)]
    got = [db.take(int(P.rt.Virq.TELEMETRY)),
           db.take(int(P.rt.Virq.JOB_FAILED))]
    assert got == [1, 1]
    return [seen, got, _bytes(db)]


def c_bind_after_bridge_still_works(P, tier, d):
    bus = P.rt.EventBus(synchronous=True)
    db = P.rt.Doorbell(n_channels=64, native=tier)
    tap = P.rt.bridge_events(bus, db)
    seen = []
    bus.bind_virq(P.rt.Virq.JOB_FAILED, lambda p: seen.append(p))
    bus.send_virq(P.rt.Virq.JOB_FAILED)
    assert seen == [int(P.rt.Virq.JOB_FAILED)]
    assert db.take(int(P.rt.Virq.JOB_FAILED)) == 1
    bus.remove_tap(tap)
    bus.send_virq(P.rt.Virq.JOB_FAILED)
    assert db.pending(int(P.rt.Virq.JOB_FAILED)) == 0
    return [seen, _bytes(db)]


def c_bridge_restricted_to_virqs(P, tier, d):
    bus = P.rt.EventBus(synchronous=True)
    db = P.rt.Doorbell(n_channels=64, native=tier)
    P.rt.bridge_events(bus, db, virqs=[P.rt.Virq.TELEMETRY])
    bus.send_virq(P.rt.Virq.TELEMETRY)
    bus.send_virq(P.rt.Virq.JOB_FAILED)
    return [db.pending(int(P.rt.Virq.TELEMETRY)),
            db.pending(int(P.rt.Virq.JOB_FAILED)), _bytes(db)]


def c_attach_rejects_truncated_block(P, tier, d):
    path = str(d / "db")
    P.rt.Doorbell.file_backed(path, n_channels=64)
    os.truncate(path, (4 + 8) * 8)
    with pytest.raises(ValueError, match="claims 64 channels") as info:
        P.rt.Doorbell.file_backed(path, attach=True)
    return str(info.value).replace(path, "<path>")


def c_negative_channel_rejected_everywhere(P, tier, d):
    db = P.rt.Doorbell(n_channels=4, native=tier)
    for fn in (db.send, db.pending, db.take):
        with pytest.raises(IndexError):
            fn(-1)
        with pytest.raises(IndexError):
            fn(4)
    assert int(db._arr[0]) != 0
    return _bytes(db)


def c_partition_virqs_visible_cross_block(P, tier, d):
    path = str(d / "db")
    db = P.rt.Doorbell.file_backed(path, n_channels=64)
    be = P.tel.SimBackend()
    be.register("j", P.tel.SimProfile.steady(step_time_ns=1 * MS))
    part = P.rt.Partition("p", source=be)
    P.rt.bridge_events(part.events, db)
    job = part.add_job(P.rt.Job("j", max_steps=2_000))
    part.sampler.arm(job.contexts[0], P.tel.Counter.STEPS_RETIRED,
                     period=100)
    part.run(until_ns=int(5e8))
    observer = P.rt.Doorbell.file_backed(path, attach=True)
    n = observer.take(int(P.rt.Virq.TELEMETRY))
    assert n >= 1
    return [n, _bytes(observer)]


def c_attach_rejects_uninitialized(P, tier, d):
    path = str(d / "raw")
    with open(path, "wb") as f:
        f.write(b"\x00" * 1024)
    with pytest.raises(ValueError, match="not an initialized") as info:
        P.rt.Doorbell.file_backed(path, attach=True)
    return str(info.value).replace(path, "<path>")


CASES = [c_send_take_counts, c_channel_bounds,
         c_wait_returns_on_ring_and_timeout, c_bridge_forwards_virqs,
         c_bind_after_bridge_still_works, c_bridge_restricted_to_virqs,
         c_attach_rejects_truncated_block,
         c_negative_channel_rejected_everywhere,
         c_partition_virqs_visible_cross_block,
         c_attach_rejects_uninitialized]


@pytest.mark.parametrize("tier", TIERS, ids=["python", "native"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__)
def test_doorbell_case_twin(case, tier, tmp_path):
    got = []
    for P in (REF, PORT):
        _need(P, tier)
        d = tmp_path / P.root
        d.mkdir()
        got.append(repr(case(P, tier, d)))
    assert got[1] == got[0]


def test_header_and_poll_knob_are_the_reference_s():
    assert PORT.db.HEADER_WORDS == REF.db.HEADER_WORDS
    assert PORT.db._MAGIC == REF.db._MAGIC
    assert PORT.db.DOORBELL_POLL_NS == REF.db.DOORBELL_POLL_NS
    lib = PORT.native.load()
    if lib is not None:
        assert lib.pbst_db_header_words() == PORT.db.HEADER_WORDS


@pytest.mark.parametrize("writer,reader", [(PORT, REF), (REF, PORT)],
                         ids=["port-writes", "ref-writes"])
def test_block_crosses_packages(writer, reader, tmp_path):
    """One package's native sender rings a file-backed block; the
    other's Python tier attaches and reads the same counts."""
    _need(writer, True)
    path = str(tmp_path / "db")
    db = writer.rt.Doorbell.file_backed(path, n_channels=16)
    assert db._nat is not None
    for ch in (1, 3, 3, 15):
        db.send(ch)
    obs = reader.rt.Doorbell(16, buf=db._mmap, native=False, _attach=True)
    assert [obs.pending(c) for c in range(16)] == [
        0, 1, 0, 2] + [0] * 11 + [1]
    assert obs.seq() == 4
    assert obs.take(3) == 2
    assert db.pending(3) == 0
    np.testing.assert_array_equal(obs._arr, db._arr)


def test_cross_process_wait_wakes_on_ring(tmp_path):
    """A second process (importing only the port) blocks in ``wait`` on
    the file-backed block; the parent's port doorbell rings it."""
    _need(PORT, True)
    path = str(tmp_path / "db")
    db = PORT.rt.Doorbell.file_backed(path, n_channels=8)
    waiter = subprocess.Popen(
        [sys.executable, "-c", f"""
import sys, time
sys.path.insert(0, {REPO!r})
from pbs_tpu_torch.runtime.doorbell import Doorbell
db = Doorbell.file_backed({path!r}, attach=True)
assert db._nat is not None
s0 = db.seq()
print("READY", flush=True)
t0 = time.monotonic()
s1 = s0
while s1 == s0 and time.monotonic() - t0 < 120:
    s1 = db.wait(s0, timeout_s=5.0)
assert s1 != s0, "timed out instead of waking"
print(f"WOKE pending={{db.take(5)}}", flush=True)
"""], stdout=subprocess.PIPE, text=True)
    try:
        assert waiter.stdout.readline().strip() == "READY"
        time.sleep(0.2)
        db.send(5)
        line = waiter.stdout.readline().strip()
        assert line == "WOKE pending=1", line
        assert waiter.wait(timeout=60) == 0
    finally:
        if waiter.poll() is None:
            waiter.kill()
        waiter.stdout.close()
