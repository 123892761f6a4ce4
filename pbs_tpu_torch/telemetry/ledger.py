"""Seqlock-versioned per-job telemetry ledger.

The port of ``pbs_tpu.telemetry.ledger``: the scheduler (writer)
publishes each context's counter sums into a flat buffer of fixed
little-endian u64 slots; readers take lock-free snapshots under the
seqlock retry contract of the reference's perfctr readout
(``drivers/perfctr/x86.c:228-312``). The byte layout is the JAX
package's, so a slot written here reads the same there.

Two write tiers share that layout. The native tier
(``runtime/native.py`` over the port's copy of the reference's C
runtime) uses real atomics with release/acquire ordering and is safe
for cross-process writers; ``native=None`` picks it when the library
builds, as the reference does, and ``Partition`` and the gateway get it
by default. The pure-Python tier's ``_begin``/``_end`` are plain
read-modify-writes with no fences, safe for the in-process single
writer the partition runs; a cross-process writer must ask for
``native=True``. Readers are safe on either tier. ``Ledger.file_backed``
maps the same slots over a file so an external monitor (or the
gateway's ``ledger_path=``) reads them with no RPC.

Slot layout (all u64, SLOT_WORDS words per execution-context slot):

    [0]      version    — seqlock: odd while a write is in progress
    [1]      tsc_start  — clock at last resume (0 when suspended)
    [2:20]   sums[18]   — accumulated counter values
    [20:38]  start[18]  — live-merge base (value at resume)
"""

from __future__ import annotations

import numpy as np

from pbs_tpu_torch.telemetry.counters import NUM_COUNTERS
from pbs_tpu_torch.utils.seqlock import read_attempts

HEADER_WORDS = 2
SLOT_WORDS = HEADER_WORDS + 2 * NUM_COUNTERS  # 38
SLOT_BYTES = SLOT_WORDS * 8

_V = 0  # version word
_T = 1  # tsc_start word
_SUMS = HEADER_WORDS
_START = HEADER_WORDS + NUM_COUNTERS

class Ledger:
    """A contiguous array of seqlock counter slots, one per context.

    ``buf`` may be any writable buffer (bytearray, mmap, shared memory);
    the default allocates process-local memory.
    """

    @classmethod
    def file_backed(cls, path: str, num_slots: int | None = None,
                    native: bool | str | None = None,
                    readonly: bool = False) -> "Ledger":
        """Slots over a shared mmap of ``path``, created or grown to
        ``num_slots`` slots. ``readonly=True`` is a monitor's attach:
        it never creates or resizes the file, and the slot count comes
        from the file when ``num_slots`` is None."""
        import mmap
        import os

        if readonly:
            fd = os.open(path, os.O_RDONLY)
            try:
                size = os.fstat(fd).st_size
                if num_slots is None:
                    num_slots = size // SLOT_BYTES
                mm = mmap.mmap(fd, num_slots * SLOT_BYTES,
                               prot=mmap.PROT_READ)
            finally:
                os.close(fd)
            led = cls(num_slots, buf=mm, native=native)
            led._mmap = mm
            return led
        if num_slots is None:
            raise ValueError("num_slots required for writable ledgers")
        nbytes = num_slots * SLOT_BYTES
        fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
        try:
            if os.fstat(fd).st_size < nbytes:
                os.ftruncate(fd, nbytes)
            mm = mmap.mmap(fd, nbytes)
        finally:
            os.close(fd)
        led = cls(num_slots, buf=mm, native=native)
        led._mmap = mm  # keep the mapping alive
        return led

    def __init__(self, num_slots: int, buf=None,
                 native: bool | str | None = None):
        self.num_slots = num_slots
        nbytes = num_slots * SLOT_BYTES
        if buf is None:
            buf = bytearray(nbytes)
        mv = memoryview(buf)
        if mv.nbytes < nbytes:
            raise ValueError(f"buffer too small: {mv.nbytes} < {nbytes}")
        self._arr = np.frombuffer(mv, dtype="<u8", count=num_slots * SLOT_WORDS)
        self._arr = self._arr.reshape(num_slots, SLOT_WORDS)
        # Native tier: same byte layout, real atomics. None picks it
        # when the library loads; False pins the Python tier; True
        # requires the library; "ctypes" pins the ctypes binding tier
        # without the fastcall module.
        self._nat = None
        self._fc = None
        self._addr = 0
        if native is not False:
            from pbs_tpu_torch.runtime import native as native_mod

            lib = native_mod.load()
            if lib is not None:
                self._nat = lib
                self._as_u64p = native_mod.as_u64p
                self._as_i64p = native_mod.as_i64p
                self._ptr = native_mod.as_u64p(self._arr.reshape(-1))
                if native != "ctypes":
                    self._fc = native_mod.fastcall()
                    self._addr = self._arr.ctypes.data
            elif native is True:
                raise RuntimeError(
                    "native runtime requested but unavailable: "
                    f"{native_mod.unavailable_reason()}")

    @property
    def tier(self) -> str:
        """The tier this ledger writes and reads on: "fastcall",
        "ctypes" or "python"."""
        if self._nat is None:
            return "python"
        return "fastcall" if self._fc is not None else "ctypes"

    # -- writer side (scheduler/executor only) ---------------------------

    def _begin(self, slot: int) -> None:
        self._arr[slot, _V] += 1  # odd: write in progress

    def _end(self, slot: int) -> None:
        self._arr[slot, _V] += 1  # even: stable

    def resume(self, slot: int, now_ns: int, live: np.ndarray | None = None) -> None:
        """Mark slot running; record the live-counter base for a later
        merge (``pmu_restore_regs`` -> ``perfctr_cpu_resume``)."""
        if self._nat is not None:
            live_p = None
            if live is not None:
                live = np.ascontiguousarray(live, dtype="<u8")
                live_p = self._as_u64p(live)
            self._nat.pbst_ledger_resume(self._ptr, slot, now_ns, live_p)
            return
        self._begin(slot)
        if live is not None:
            self._arr[slot, _START:_START + NUM_COUNTERS] = live
        # tsc_start doubles as the running flag; a clock legitimately
        # reading 0 (VirtualClock at t=0) must still read as running.
        self._arr[slot, _T] = now_ns or 1
        self._end(slot)

    def suspend(self, slot: int, deltas: np.ndarray) -> None:
        """Accumulate deltas and mark slot suspended
        (``pmu_save_regs`` -> ``perfctr_cpu_vsuspend``)."""
        if self._nat is not None:
            d = np.ascontiguousarray(deltas, dtype="<u8")
            self._nat.pbst_ledger_suspend(self._ptr, slot, self._as_u64p(d))
            return
        self._begin(slot)
        self._arr[slot, _SUMS:_SUMS + NUM_COUNTERS] += deltas.astype("<u8")
        self._arr[slot, _T] = 0
        self._end(slot)

    def add(self, slot: int, counter: int, delta: int) -> None:
        """Accumulate a single counter without changing run state."""
        if self._nat is not None:
            self._nat.pbst_ledger_add(self._ptr, slot, counter, delta)
            return
        self._begin(slot)
        self._arr[slot, _SUMS + counter] += np.uint64(delta)
        self._end(slot)

    def add_many(self, slot: int, deltas: np.ndarray) -> None:
        if self._nat is not None:
            d = np.ascontiguousarray(deltas, dtype="<u8")
            self._nat.pbst_ledger_add_many(self._ptr, slot, self._as_u64p(d))
            return
        self._begin(slot)
        self._arr[slot, _SUMS:_SUMS + NUM_COUNTERS] += deltas.astype("<u8")
        self._end(slot)

    def reset(self, slot: int) -> None:
        """Zero a slot for a fresh context (``pmu_init_vcpu``)."""
        if self._nat is not None:
            self._nat.pbst_ledger_reset(self._ptr, slot)
            return
        self._begin(slot)
        self._arr[slot, _T] = 0
        self._arr[slot, _SUMS:] = 0
        self._end(slot)

    # -- reader side (lock-free) -----------------------------------------

    def snapshot(self, slot: int, max_retries: int = 64) -> np.ndarray:
        """Lock-free consistent read of a slot's counter sums: read the
        version, copy the sums, re-read the version; retry if a write
        was in progress (odd) or intervened (changed), yielding to the
        writer between attempts for up to ``utils.seqlock.SNAPSHOT_WAIT_S``.
        On the native tier each attempt is one C read that spins up to
        ``max_retries`` times (the reference's bound); the port retries
        that call on the same time-bounded schedule."""
        if self._nat is not None:
            out = np.empty(NUM_COUNTERS, dtype="<u8")
            out_p = self._as_u64p(out)
            for _ in read_attempts():
                if self._nat.pbst_ledger_snapshot(
                        self._ptr, slot, out_p, max_retries) >= 0:
                    return out
            raise RuntimeError(
                f"ledger slot {slot}: snapshot retries exhausted")
        for _ in read_attempts():
            v0 = int(self._arr[slot, _V])
            if v0 & 1:
                continue
            sums = self._arr[slot, _SUMS:_SUMS + NUM_COUNTERS].copy()
            v1 = int(self._arr[slot, _V])
            if v0 == v1:
                return sums
        raise RuntimeError(f"ledger slot {slot}: snapshot retries exhausted")

    def snapshot_many(self, slots, max_retries: int = 64) -> np.ndarray:
        """Vectorized :meth:`snapshot` over a slot set; returns
        ``(len(slots), NUM_COUNTERS)`` u64 sums. The seqlock contract is
        checked per retry round across all requested slots, on
        ``utils.seqlock.read_attempts``' schedule; the native tier is one
        C call over the whole vector per attempt, with per-slot retries
        inside it."""
        idx = np.asarray(list(slots), dtype=np.intp)
        if idx.size == 0:
            return np.empty((0, NUM_COUNTERS), dtype="<u8")
        if self._nat is not None:
            idx64 = np.ascontiguousarray(idx, dtype=np.int64)
            out = np.empty((idx.size, NUM_COUNTERS), dtype="<u8")
            for _ in read_attempts():
                if self._fc is not None:
                    rc = self._fc.ledger_snapshot_many(
                        self._addr, self.num_slots, idx64, idx64.size,
                        out, max_retries)
                else:
                    rc = self._nat.pbst_ledger_snapshot_many(
                        self._ptr, self.num_slots, self._as_i64p(idx64),
                        idx64.size, self._as_u64p(out.reshape(-1)),
                        max_retries)
                    if rc == -2:
                        raise IndexError(
                            f"ledger slots {list(map(int, idx))}: slot "
                            f"out of range [0, {self.num_slots})")
                if rc >= 0:
                    return out
            raise RuntimeError(
                f"ledger slots {list(map(int, idx))}: snapshot_many "
                "retries exhausted")
        if ((idx < 0) | (idx >= self.num_slots)).any():
            # Tier equivalence: the C paths reject out-of-range slots;
            # numpy fancy indexing would silently WRAP a negative slot
            # to another slot's counters.
            raise IndexError(
                f"ledger slots {list(map(int, idx))}: slot out of "
                f"range [0, {self.num_slots})")
        for _ in read_attempts():
            v0 = self._arr[idx, _V].copy()
            if (v0 & 1).any():
                continue
            sums = self._arr[idx, _SUMS:_SUMS + NUM_COUNTERS]
            v1 = self._arr[idx, _V]
            if (v0 == v1).all():
                return sums
        raise RuntimeError(
            f"ledger slots {list(map(int, idx))}: snapshot_many retries "
            "exhausted")

    def is_running(self, slot: int) -> bool:
        return int(self._arr[slot, _T]) != 0

    def tsc_start(self, slot: int) -> int:
        return int(self._arr[slot, _T])

    def raw(self) -> np.ndarray:
        """Whole-buffer view."""
        return self._arr
