"""The port's seqlock readers wait out a live writer and still refuse a
wedged one.

``KnobChannel.snapshot`` and ``Ledger.snapshot``/``snapshot_many`` read
a version word that goes odd while a write is in progress. Under the
GIL a writer thread can sit preempted between its odd and even stores
for a switch interval or more; the port's readers yield to it and bound
their wait by time (``utils.seqlock.read_attempts``), where the
reference bounds it by a spin count. These cases hold a write open for
several switch intervals on purpose, and check that the reader returns
the written state, that a version left odd with no writer still raises
with the reference's words, and that threaded soaks never tear. The
ledger cases run on each of the ledger's tiers: the Python stores, the
ctypes calls (which release the GIL inside C) and the fastcall module
(which does not); the native snapshot retries its C read on the same
time-bounded schedule.
"""

from __future__ import annotations

import sys
import threading
import time

import numpy as np
import pytest

from pbs_tpu_torch.knobs import KnobError
from pbs_tpu_torch.knobs.channel import KnobChannel
from pbs_tpu_torch.telemetry.counters import NUM_COUNTERS
from pbs_tpu_torch.telemetry.ledger import Ledger
from pbs_tpu_torch.utils.seqlock import SNAPSHOT_WAIT_S

#: How long each held write stays open: well past the interpreter's
#: switch interval (5 ms by default), well inside the readers' wait.
HOLD_S = max(0.05, 10 * sys.getswitchinterval())

_VERSION = 2  # the knob channel's seqlock word

#: The ledger's tiers: Python, ctypes, and fastcall where it builds.
TIERS = [False, "ctypes", True]
TIER_IDS = ["python", "ctypes", "native"]


def _ledger(n: int, tier) -> Ledger:
    if tier:
        from pbs_tpu_torch.runtime import native

        if not native.available():
            pytest.skip(f"native runtime unavailable: "
                        f"{native.unavailable_reason()}")
    return Ledger(n, native=tier)


def _held_channel_push(ch: KnobChannel, name: str, value: int,
                       opened: threading.Event) -> None:
    """One push with its seqlock round held open for HOLD_S: the same
    stores ``KnobChannel.push`` makes, in its order."""
    v0, gen = ch._words(_VERSION, 2)
    ch._store(_VERSION, v0 + 1)
    opened.set()
    time.sleep(HOLD_S)
    ch._store(5 + ch._index[name], value)
    ch._store(_VERSION + 1, gen + 1)
    ch._store(_VERSION, v0 + 2)


def test_channel_snapshot_waits_out_a_held_push(tmp_path):
    path = str(tmp_path / "knobs.led")
    w = KnobChannel.create(path)
    ro = KnobChannel.attach(path)
    opened = threading.Event()
    t = threading.Thread(target=_held_channel_push, args=(
        w, "sched.feedback.grow_step_us", 150, opened))
    t.start()
    assert opened.wait(5)
    t0 = time.monotonic()
    gen, vals = ro.snapshot(max_retries=4)
    waited = time.monotonic() - t0
    t.join(5)
    assert not t.is_alive()
    assert gen == 1
    assert vals["sched.feedback.grow_step_us"] == 150
    assert waited < SNAPSHOT_WAIT_S


def test_channel_snapshot_raises_on_a_wedged_version(tmp_path):
    path = str(tmp_path / "knobs.led")
    ch = KnobChannel.create(path)
    ch.push({"sched.feedback.grow_step_us": 150})
    ch._store(_VERSION, ch._words(_VERSION, 1)[0] + 1)
    t0 = time.monotonic()
    with pytest.raises(KnobError, match="snapshot retries exhausted"):
        KnobChannel.attach(path).snapshot()
    assert time.monotonic() - t0 >= SNAPSHOT_WAIT_S
    with pytest.raises(KnobError, match="wedged"):
        ch.push({"sched.feedback.grow_step_us": 50})


def _held_ledger_add(led: Ledger, slot: int, delta: np.ndarray,
                     opened: threading.Event) -> None:
    led._begin(slot)
    opened.set()
    time.sleep(HOLD_S)
    led._arr[slot, 2:2 + NUM_COUNTERS] += delta
    led._end(slot)


@pytest.mark.parametrize("tier", TIERS, ids=TIER_IDS)
@pytest.mark.parametrize("many", [False, True], ids=["snapshot",
                                                     "snapshot_many"])
def test_ledger_snapshot_waits_out_a_held_write(many, tier):
    led = _ledger(4, tier)
    led.add_many(1, np.full(NUM_COUNTERS, 3, dtype=np.uint64))
    delta = np.arange(1, NUM_COUNTERS + 1, dtype=np.uint64)
    opened = threading.Event()
    t = threading.Thread(target=_held_ledger_add,
                         args=(led, 1, delta, opened))
    t.start()
    assert opened.wait(5)
    got = led.snapshot_many([0, 1])[1] if many else led.snapshot(1)
    t.join(5)
    assert not t.is_alive()
    np.testing.assert_array_equal(got, delta + 3)


@pytest.mark.parametrize("tier", TIERS, ids=TIER_IDS)
def test_ledger_snapshots_raise_on_a_wedged_slot(tier):
    led = _ledger(2, tier)
    led._begin(1)
    with pytest.raises(RuntimeError,
                       match="ledger slot 1: snapshot retries exhausted"):
        led.snapshot(1, max_retries=4)
    with pytest.raises(RuntimeError,
                       match=r"ledger slots \[0, 1\]: snapshot_many "
                             "retries exhausted"):
        led.snapshot_many([0, 1], max_retries=4)
    # The unwedged slot still reads at once.
    np.testing.assert_array_equal(led.snapshot(0),
                                  np.zeros(NUM_COUNTERS, dtype=np.uint64))


@pytest.mark.parametrize("tier", TIERS, ids=TIER_IDS)
def test_ledger_snapshots_never_tear_under_live_writer(tier):
    """The channel soak's twin for the ledger: a writer adds the same
    delta to every counter of two slots in a loop while the reader
    snapshots, with the switch interval cut so the writer is preempted
    mid-write often; a torn read would show unequal counters."""
    led = _ledger(3, tier)
    n_writes = 400
    stop = threading.Event()
    interval = sys.getswitchinterval()

    def writer():
        one = np.ones(NUM_COUNTERS, dtype=np.uint64)
        for _ in range(n_writes):
            led.add_many(0, one)
            led.add_many(2, one)
        stop.set()

    t = threading.Thread(target=writer)
    sys.setswitchinterval(1e-5)
    try:
        t.start()
        last = -1
        while not stop.is_set():
            single = led.snapshot(0)
            pair = led.snapshot_many([0, 2])
            for row in (single, pair[0], pair[1]):
                assert (row == row[0]).all()
            assert int(single[0]) >= last
            last = int(single[0])
        t.join(10)
    finally:
        sys.setswitchinterval(interval)
    assert not t.is_alive()
    np.testing.assert_array_equal(
        led.snapshot_many([0, 2]),
        np.full((2, NUM_COUNTERS), n_writes, dtype=np.uint64))
