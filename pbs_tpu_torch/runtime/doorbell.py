"""Cross-process doorbells: event channels over shared memory.

The port of ``pbs_tpu.runtime.doorbell``, block for block: a doorbell
file written by either package reads the same in the other.

Reference: Xen event channels notify across domains through pending
bits in the shared_info page plus an upcall
(``xen/common/event_channel.c``; the perfctr overflow virq rides this,
``pmustate.c:66-80``). Inside one process the :class:`EventBus` plays
that role; ACROSS processes round 1 only had the control-plane RPC —
a monitor had to poll over TCP to learn "telemetry event fired".

This module is the missing shared-page notify path: per-channel
pending counts and a global notify sequence over a file-backed mmap
(the same byte-compatible native-or-Python split as the ledger). A
monitor process maps the file, then ``wait()``s on the sequence —
microsecond wakeups, zero RPCs. ``bridge_events`` forwards a
partition's Virq traffic into doorbell channels, so external observers
get the same interrupts in-process subscribers do.

Writer-concurrency contract (same as the ledger): the native path uses
real atomics and is safe for many senders in any process; the pure
Python fallback is in-process safe (GIL) — cross-process SENDERS
require the native library. Waiters are always safe (reads tolerate
races by re-checking).
"""

from __future__ import annotations

import time

import numpy as np

from pbs_tpu_torch import knobs
from pbs_tpu_torch.utils.clock import SEC

HEADER_WORDS = 4
_MAGIC = 0x70627374_6462  # "pbstdb"

# Pure-Python wait() poll period. The native path blocks in the
# library; the fallback polls the notify sequence at this cadence — a
# registry-declared knob (runtime.doorbell.poll_ns) so the unit
# checker and `pbst knobs` both see it instead of a bare sleep literal.
DOORBELL_POLL_NS = knobs.default("runtime.doorbell.poll_ns")


class Doorbell:
    """A channel block over caller-provided or file-backed memory."""

    @classmethod
    def file_backed(cls, path: str, n_channels: int | None = None,
                    attach: bool = False) -> "Doorbell":
        import mmap
        import os

        if attach:
            fd = os.open(path, os.O_RDWR)
            try:
                size = os.fstat(fd).st_size
                mm = mmap.mmap(fd, size)
            finally:
                os.close(fd)
            db = cls(n_channels=(size // 8) - HEADER_WORDS, buf=mm,
                     _attach=True)
            db._mmap = mm
            if int(db._arr[0]) != _MAGIC:
                raise ValueError(f"{path!r} is not an initialized "
                                 "doorbell block")
            claimed = int(db._arr[1])
            if claimed > (size // 8) - HEADER_WORDS:
                # A truncated file with an intact header would let the
                # native sender write past the end of the mapping.
                raise ValueError(
                    f"{path!r} claims {claimed} channels but holds "
                    f"only {(size // 8) - HEADER_WORDS}")
            db.n_channels = claimed
            return db
        if n_channels is None:
            raise ValueError("n_channels required when creating")
        nbytes = (HEADER_WORDS + n_channels) * 8
        fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
        try:
            if os.fstat(fd).st_size < nbytes:
                os.ftruncate(fd, nbytes)
            mm = mmap.mmap(fd, nbytes)
        finally:
            os.close(fd)
        db = cls(n_channels, buf=mm)
        db._mmap = mm
        return db

    def __init__(self, n_channels: int, buf=None, native: bool | None = None,
                 _attach: bool = False):
        self.n_channels = int(n_channels)
        nbytes = (HEADER_WORDS + self.n_channels) * 8
        if buf is None:
            buf = bytearray(nbytes)
        mv = memoryview(buf)
        if mv.nbytes < nbytes:
            raise ValueError(f"buffer too small: {mv.nbytes} < {nbytes}")
        self._arr = np.frombuffer(
            mv, dtype="<u8", count=HEADER_WORDS + self.n_channels)
        self._nat = None
        self._ptr = None
        if native is not False:
            from pbs_tpu_torch.runtime import native as native_mod

            lib = native_mod.load()
            if lib is not None:
                self._nat = lib
                self._ptr = native_mod.as_u64p(self._arr)
            elif native is True:
                raise RuntimeError(
                    "native runtime requested but unavailable: "
                    f"{native_mod.unavailable_reason()}")
        if _attach:
            return  # joiner: creator owns the header
        if self._nat is not None:
            self._nat.pbst_db_init(self._ptr, self.n_channels)
        else:
            self._arr[1] = self.n_channels
            self._arr[2] = 0
            self._arr[3] = 0
            self._arr[HEADER_WORDS:] = 0
            self._arr[0] = _MAGIC

    # -- sender side ------------------------------------------------------

    def send(self, chan: int) -> int:
        """Ring ``chan``; returns its new pending count."""
        self._check_chan(chan)
        if self._nat is not None:
            return int(self._nat.pbst_db_send(self._ptr, chan))
        self._arr[HEADER_WORDS + chan] += 1
        self._arr[2] += 1
        return int(self._arr[HEADER_WORDS + chan])

    # -- consumer side ----------------------------------------------------

    def _check_chan(self, chan: int) -> None:
        # Uniform across paths: a negative index in the Python
        # fallback would read/zero HEADER words (including the magic).
        if not 0 <= chan < self.n_channels:
            raise IndexError(f"channel {chan} out of range")

    def pending(self, chan: int) -> int:
        self._check_chan(chan)
        if self._nat is not None:
            return int(self._nat.pbst_db_pending(self._ptr, chan))
        return int(self._arr[HEADER_WORDS + chan])

    def take(self, chan: int) -> int:
        """Consume (and zero) a channel's pending count."""
        self._check_chan(chan)
        if self._nat is not None:
            return int(self._nat.pbst_db_take(self._ptr, chan))
        n = int(self._arr[HEADER_WORDS + chan])
        self._arr[HEADER_WORDS + chan] = 0
        return n

    def seq(self) -> int:
        if self._nat is not None:
            return int(self._nat.pbst_db_seq(self._ptr))
        return int(self._arr[2])

    def wait(self, last_seq: int, timeout_s: float = 1.0) -> int:
        """Block until the notify sequence moves past ``last_seq`` (any
        channel rang) or timeout. Returns the current sequence."""
        if self._nat is not None:
            return int(self._nat.pbst_db_wait(
                self._ptr, last_seq, int(timeout_s * 1e6)))
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            s = int(self._arr[2])
            if s != last_seq:
                return s
            time.sleep(DOORBELL_POLL_NS / SEC)
        return int(self._arr[2])


def bridge_events(bus, db: Doorbell, virqs=None):
    """Forward a bus's signal traffic into doorbell channels (channel
    index = port number) via a send-time tap — no port is occupied, so
    in-process subscribers may bind before OR after bridging, and the
    doorbell rings even for ports nobody bound locally (an external
    monitor may be the only consumer). ``virqs`` restricts forwarding
    to those ports; default: every port that fits the block. Returns
    the tap (pass to ``bus.remove_tap`` to unbridge)."""
    allowed = (None if virqs is None
               else {int(v) for v in virqs})

    def _tap(port: int, _db=db) -> None:
        if port < _db.n_channels and (allowed is None or port in allowed):
            _db.send(port)

    bus.add_tap(_tap)
    return _tap
