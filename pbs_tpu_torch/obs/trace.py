"""Trace buffers: lockless event rings + taxonomy (xentrace analog).

The port of ``pbs_tpu.obs.trace``: one SPSC ring over a flat u64
buffer, records of (timestamp, event, 6 args), a lost-record counter
instead of blocking, and :class:`EmitBatch` staging so N events cost one
batched ring write. Same event taxonomy, same header and record words:
a ring written here is byte-identical to the reference's ring for the
same emits (``tests/test_torch_spans.py``, ``tests/test_torch_native.py``).

Three tiers write the same bytes and drop counters. The native SPSC
ring (``runtime/native.py`` over the port's copy of the reference's C
runtime) is picked by ``native=None`` when the library builds, as the
reference picks it: ``emit`` is one vectorcall on the fastcall tier (one
ctypes call without it), and ``emit_many``/``consume`` are one
``pbst_trace_emit_many``/``pbst_trace_consume`` call. On the pure-Python
tier ``emit`` writes a record with one ``struct.pack_into``, and
``emit_many``/``consume``/``peek`` move records in at most two
contiguous slice copies.

**Batched-writer concurrency contract** (mirrors the ledger's): the
pure-Python vectorized producer paths (``emit_many``, and any
``EmitBatch`` over a non-native ring) are plain slice stores + a
header store with no fences — in-process SPSC is always safe (stores
are program-ordered under the GIL), and a cross-process consumer
attached to a file-backed ring is safe on TSO hosts (x86: the head
store cannot pass the record stores). A cross-process producer
needing release semantics on weaker memory models must use the native
paths (scalar ``emit`` or ``emit_many``, whose head store is an
atomic release).
"""

from __future__ import annotations

import enum
import struct

import numpy as np

from pbs_tpu_torch import knobs
from pbs_tpu_torch.utils.params import integer_param

TRACE_HEADER_WORDS = 4
TRACE_REC_WORDS = 8

# EmitBatch staging watermarks, declared in the knob registry
# (obs.trace.emit_batch_*): how many records one producer stages, and
# the staged-timestamp span that forces a flush.
EMIT_BATCH_CAPACITY = knobs.default("obs.trace.emit_batch_capacity")
EMIT_BATCH_FLUSH_NS = knobs.default("obs.trace.emit_batch_flush_ns")

_U64_MASK = 2**64 - 1

#: Pack formats for a record prefix of 2 + k words (k = 0..6 args):
#: one C-level struct.pack_into per staged/emitted record replaces the
#: per-word memoryview store loop — the "sub-µs emit" path. The
#: out-of-range fallback masks args exactly like the old store loop.
_PACK_FMTS = tuple("<" + "Q" * (2 + k) for k in range(7))
#: Zero padding for the unwritten tail words of a short record.
_ZERO_TAIL = tuple(bytes((6 - k) * 8) for k in range(7))

# ``tbuf_size=`` boot param analog (xen/common/trace.c): default ring
# capacity in records for rings whose creator doesn't size them.
_tbuf_size = integer_param("tbuf_size", 4096)


class Ev(enum.IntEnum):
    """Event taxonomy (TRC_* analog, public/trace.h:35-74). The top
    byte is the subsystem class, like TRC_SCHED/TRC_MEM/..."""

    # scheduler class (0x01xx)
    SCHED_PICK = 0x0101  # args: ctx_slot, quantum_ns
    SCHED_DESCHED = 0x0102  # args: ctx_slot, ran_ns, credit_mu
    SCHED_WAKE = 0x0103  # args: ctx_slot, boosted
    SCHED_SLEEP = 0x0104  # args: ctx_slot
    SCHED_STEAL = 0x0105  # args: ctx_slot, from_ex, to_ex
    SCHED_PARK = 0x0106  # args: ctx_slot
    SCHED_UNPARK = 0x0107  # args: ctx_slot
    SCHED_ACCT = 0x0108  # args: acct_count, weight_total
    # feedback class (0x02xx)
    FB_TICK = 0x0201  # args: job_slot, stall_rate_x1000, tslice_us
    FB_GROW = 0x0202  # args: job_slot, new_tslice_us
    FB_SHRINK = 0x0203  # args: job_slot, new_tslice_us
    FB_RESET = 0x0204  # args: job_slot
    # job lifecycle (0x03xx)
    JOB_ADD = 0x0301  # args: job_slot, n_contexts, weight
    JOB_REMOVE = 0x0302
    JOB_DONE = 0x0303
    JOB_FAILED = 0x0304  # args: ctx_slot
    # checkpoint (0x04xx)
    CKPT_BEGIN = 0x0401  # args: job_slot, step
    CKPT_END = 0x0402  # args: job_slot, bytes, dur_ns
    # contention channel (0x05xx) — the vcrd_op analog
    CONTENTION = 0x0501  # args: job_slot, wait_ns, events
    # serving gateway (0x06xx) — the front-door class (docs/GATEWAY.md);
    # tenant_slot is the gateway's stable per-tenant index, cls is the
    # SLO-class index (0=interactive, 1=batch)
    GW_ADMIT = 0x0601  # args: tenant_slot, cls, cost, queue_depth
    GW_SHED = 0x0602  # args: tenant_slot, cls, reason_code, retry_after_ns
    GW_DISPATCH = 0x0603  # args: tenant_slot, cls, backend_slot, qdelay_ns
    GW_COMPLETE = 0x0604  # args: tenant_slot, cls, backend_slot, service_ns
    GW_REQUEUE = 0x0605  # args: tenant_slot, cls, backend_slot
    GW_QDELAY = 0x0606  # args: cls, p50_ns, p99_ns, shed_ppm
    # telemetry sampling (0x07xx) — the i-mode overflow path
    # (telemetry/sampler.py): one record per threshold crossing, staged
    # through an EmitBatch so a quantum's firings cost one ring write
    TELEM_OVERFLOW = 0x0701  # args: ledger_slot, sample_id, counter, value
    # request spans (0x08xx) — the causal request timeline through the
    # serving tier (docs/TRACING.md; pbs_tpu_torch.obs.spans). ``span`` is
    # the recorder-interned id of the gateway rid (stitching key across
    # federated members), ``member`` the interned gateway name. All
    # emitted through the SpanRecorder's EmitBatch, never scalar.
    SPAN_ADMIT = 0x0801  # args: span, tenant_slot, cls, cost, member
    SPAN_SHED = 0x0802  # args: tenant_slot, cls, reason_code, member
    SPAN_ENQUEUE = 0x0803  # args: span, tenant_slot, cls, member
    SPAN_DISPATCH = 0x0804  # args: span, backend_slot, qdelay_ns,
    #                               deficit_x1000, member
    SPAN_EXEC = 0x0805  # args: span, backend_slot, member
    SPAN_COMPLETE = 0x0806  # args: span, backend_slot, service_ns,
    #                               latency_ns, member
    SPAN_REQUEUE = 0x0807  # args: span, backend_slot, member
    SPAN_HANDOFF = 0x0808  # args: span, from_member, to_member
    SPAN_RECOVER = 0x0809  # args: span, member, generation — crash
    #   recovery re-anchored this request's chain (docs/DURABILITY.md):
    #   legal from ANY state (including as the chain's first record
    #   when the pre-crash span records died in a staging batch) and
    #   resets the chain to QUEUED — recovery requeues everything it
    #   recovers, and a COMPLETE whose frame never committed may
    #   legitimately be followed by a re-execution.
    # autopilot decisions (0x09xx) — the self-tuning loop's audit trail
    # (docs/AUTOPILOT.md; pbs_tpu.autopilot). Emitted through the
    # shared SpanRecorder ring so every decision lands in emission
    # order next to the request chains it affected; the assembler
    # ignores the class, chain validation is untouched.
    AP_PROPOSE = 0x0901  # args: cand_score_x1e6, live_score_x1e6,
    #                            margin_x1e6 (i64 two's complement —
    #                            scores can be negative), injected
    AP_CANARY = 0x0902  # args: n_members, guard_window_ns
    AP_PROMOTE = 0x0903  # args: n_members, reserved
    AP_ROLLBACK = 0x0904  # args: reason_code, max_burn_x1000


class TraceBuffer:
    """One SPSC ring. Producer: an executor. Consumer: a monitor."""

    def __init__(self, capacity: int | None = None, buf=None,
                 native: bool | str | None = None, _attach: bool = False):
        # ``native``: None auto-detects, True requires the C library,
        # False pins the pure-Python paths, "ctypes" pins the ctypes
        # binding tier (native minus the fastcall accelerator — the
        # tier a host without Python.h runs; tests/benches use it).
        self.capacity = capacity = (
            capacity if capacity is not None else _tbuf_size.value)
        nwords = TRACE_HEADER_WORDS + capacity * TRACE_REC_WORDS
        if buf is None:
            buf = bytearray(nwords * 8)
        self._arr = np.frombuffer(memoryview(buf), dtype="<u8", count=nwords)
        # Cached header/word views: plain-int loads and stores with no
        # numpy scalar boxing on the per-event path. Native-endian 'Q'
        # over the '<u8' layout — this framework targets little-endian
        # hosts (the native library shares the same assumption).
        words = memoryview(buf)[: nwords * 8].cast("B").cast("Q")
        self._hdr = words[:TRACE_HEADER_WORDS]
        self._words = words
        # Byte view for struct.pack_into: the pure-Python emit writes
        # the whole record in one C call, no per-word store loop.
        self._bytes = memoryview(buf)[: nwords * 8].cast("B")
        self._nat = None
        self._ptr = None
        self._fc = None
        self._addr = 0
        if native is not False:
            from pbs_tpu_torch.runtime import native as native_mod

            lib = native_mod.load()
            if lib is not None:
                self._nat = lib
                self._ptr = native_mod.as_u64p(self._arr)
                # Fastcall tier (runtime/csrc/pbst_fastcall.cc): the
                # same C entry points behind vectorcall. The address is
                # cached once — each .ctypes.data access costs more
                # than the emit. native="ctypes" pins the ctypes tier.
                if native != "ctypes":
                    self._fc = native_mod.fastcall()
                    self._addr = self._arr.ctypes.data
            elif native is True:
                raise RuntimeError(
                    "native runtime requested but unavailable: "
                    f"{native_mod.unavailable_reason()}")
        if _attach:
            return  # consumer attach: the producer owns the header
        if self._nat is not None:
            self._nat.pbst_trace_init(self._ptr, capacity)
        else:
            self._arr[0] = 0
            self._arr[1] = 0
            self._arr[2] = capacity
            self._arr[3] = 0

    @property
    def tier(self) -> str:
        """The tier this ring writes on: "fastcall", "ctypes" or
        "python"."""
        if self._nat is None:
            return "python"
        return "fastcall" if self._fc is not None else "ctypes"

    @classmethod
    def file_backed(cls, path: str, capacity: int | None = None,
                    native: bool | str | None = None,
                    attach: bool = False) -> "TraceBuffer":
        """Ring over a shared mmap — xenbaked's view of the hypervisor
        trace pages (``tools/xenmon/xenbaked.c`` maps the per-CPU rings
        dom0-side). ``attach=True`` joins an existing producer's ring as
        the (single) consumer: the header is left alone and capacity
        comes from the file. The mapping is read-write either way — the
        consumer must advance the shared tail word."""
        import mmap
        import os

        if attach:
            fd = os.open(path, os.O_RDWR)
            try:
                mm = mmap.mmap(fd, os.fstat(fd).st_size)
            finally:
                os.close(fd)
            cap = int(np.frombuffer(mm, dtype="<u8", count=3)[2])
            tb = cls(cap, buf=mm, native=native, _attach=True)
        else:
            capacity = capacity if capacity is not None else _tbuf_size.value
            nbytes = (TRACE_HEADER_WORDS + capacity * TRACE_REC_WORDS) * 8
            fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
            try:
                if os.fstat(fd).st_size < nbytes:
                    os.ftruncate(fd, nbytes)
                mm = mmap.mmap(fd, nbytes)
            finally:
                os.close(fd)
            tb = cls(capacity, buf=mm, native=native)
        tb._mmap = mm
        return tb

    # -- producer --------------------------------------------------------

    def emit(self, ts_ns: int, event: int, *args: int) -> bool:
        fc = self._fc
        if fc is not None:
            # Sub-µs native emit: one vectorcall, args masked in C.
            if len(args) > 6:
                args = args[:6]
            return fc.trace_emit(self._addr, ts_ns, event, *args)
        if self._nat is not None:
            a = [int(x) & _U64_MASK for x in args[:6]]
            a += [0] * (6 - len(a))
            return bool(
                self._nat.pbst_trace_emit(self._ptr, ts_ns, int(event), *a))
        hdr = self._hdr
        head = hdr[0]
        cap = self.capacity
        if head - hdr[1] >= cap:
            hdr[3] += 1
            return False
        off = (TRACE_HEADER_WORDS + (head % cap) * TRACE_REC_WORDS) * 8
        n = len(args)
        if n > 6:
            args = args[:6]
            n = 6
        b = self._bytes
        try:
            # Fast path: every field already a 0..2^64-1 int — one C
            # pack writes the whole record prefix.
            struct.pack_into(_PACK_FMTS[n], b, off, ts_ns, event, *args)
        except struct.error:
            # Every field masks to two's complement — including
            # ts_ns/event, matching the native tiers (a negative
            # clock-skew timestamp must not raise on one tier and
            # record on another).
            struct.pack_into(
                _PACK_FMTS[n], b, off, int(ts_ns) & _U64_MASK,
                int(event) & _U64_MASK,
                *[int(x) & _U64_MASK for x in args])
        if n < 6:
            b[off + (2 + n) * 8:off + TRACE_REC_WORDS * 8] = _ZERO_TAIL[n]
        hdr[0] = head + 1
        return True

    def emit_many(self, recs: np.ndarray) -> int:
        """Batched emit of an ``(n, 8)`` u64 record array in at most two
        contiguous slice copies (wrap-aware). Returns the number of
        records written; records that don't fit are dropped tail-first
        with the lost counter charged — exactly the per-record drop
        semantics of ``n`` scalar :meth:`emit` calls. See the module
        docstring for the batched-writer concurrency contract."""
        recs = np.ascontiguousarray(recs, dtype="<u8")
        if recs.ndim != 2 or recs.shape[1] != TRACE_REC_WORDS:
            raise ValueError(
                f"emit_many wants (n, {TRACE_REC_WORDS}) u64 records, "
                f"got shape {recs.shape}")
        n = recs.shape[0]
        if n == 0:
            return 0
        if self._fc is not None:
            return self._fc.trace_emit_many(self._addr, recs, n)
        if self._nat is not None:
            from pbs_tpu_torch.runtime import native as native_mod

            return int(self._nat.pbst_trace_emit_many(
                self._ptr, native_mod.as_u64p(recs.reshape(-1)), n))
        hdr = self._hdr
        head, tail, cap = hdr[0], hdr[1], self.capacity
        space = cap - (head - tail)
        k = n if n <= space else space
        if k < n:
            hdr[3] += n - k
        if k == 0:
            return 0
        flat = recs.reshape(-1)
        arr = self._arr
        start = head % cap
        k1 = min(k, cap - start)
        off = TRACE_HEADER_WORDS + start * TRACE_REC_WORDS
        w = TRACE_REC_WORDS
        arr[off:off + k1 * w] = flat[:k1 * w]
        if k > k1:
            arr[TRACE_HEADER_WORDS:TRACE_HEADER_WORDS + (k - k1) * w] = (
                flat[k1 * w:k * w])
        hdr[0] = head + k
        return k

    # -- consumer --------------------------------------------------------

    def _copy_out(self, first: int, n: int) -> np.ndarray:
        """Wrap-aware bulk copy of records [first, first+n) into a fresh
        (n, 8) array — one or two contiguous slices, no per-record loop."""
        out = np.empty((n, TRACE_REC_WORDS), dtype="<u8")
        if n:
            flat = out.reshape(-1)
            arr = self._arr
            cap = self.capacity
            start = first % cap
            k1 = min(n, cap - start)
            off = TRACE_HEADER_WORDS + start * TRACE_REC_WORDS
            w = TRACE_REC_WORDS
            flat[:k1 * w] = arr[off:off + k1 * w]
            if n > k1:
                flat[k1 * w:] = arr[
                    TRACE_HEADER_WORDS:TRACE_HEADER_WORDS + (n - k1) * w]
        return out

    def consume(self, max_records: int = 1024) -> np.ndarray:
        """(n, 8) u64 array of drained records."""
        if self._fc is not None:
            out = np.empty(max_records * TRACE_REC_WORDS, dtype="<u8")
            n = self._fc.trace_consume(self._addr, out, max_records)
            return out[: n * TRACE_REC_WORDS].reshape(n, TRACE_REC_WORDS)
        if self._nat is not None:
            from pbs_tpu_torch.runtime import native as native_mod

            out = np.empty(max_records * TRACE_REC_WORDS, dtype="<u8")
            n = self._nat.pbst_trace_consume(
                self._ptr, native_mod.as_u64p(out), max_records)
            return out[: n * TRACE_REC_WORDS].reshape(n, TRACE_REC_WORDS)
        hdr = self._hdr
        tail = hdr[1]
        n = min(hdr[0] - tail, max_records)
        recs = self._copy_out(tail, n)
        if n:
            hdr[1] = tail + n
        return recs

    def peek(self, max_records: int = 1024) -> np.ndarray:
        """Last ``max_records`` undrained records WITHOUT consuming them
        — postmortem readers (crash dumps) must not steal records from an
        attached live consumer. Reads the shared header words directly
        (same layout for the native ring), so it also works on a ring the
        native library owns; safe in-process where the producer is
        quiescent or slow relative to the copy."""
        hdr = self._hdr
        head, tail = hdr[0], hdr[1]
        avail = head - tail
        n = min(avail, max_records)
        return self._copy_out(tail + (avail - n), n)  # newest n records

    @property
    def lost(self) -> int:
        if self._nat is not None:
            return int(self._nat.pbst_trace_lost(self._ptr))
        return self._hdr[3]


class EmitBatch:
    """Per-producer staging buffer over one ring: N events become one
    wrap-aware ``emit_many`` instead of N scalar emits.

    Flush happens on a **size watermark** (the staging buffer fills) or
    a **time watermark** (the staged span of event timestamps exceeds
    ``flush_ns`` — timestamps, not wall time, so virtual-clock runs stay
    deterministic), or explicitly via :meth:`flush` (the partition's
    drain/peek paths flush before reading so batched records are never
    invisible to an in-process consumer).

    NOT thread-safe: one batch per producer thread, and only where that
    producer owns the ring (the SPSC contract). Producers needing
    cross-thread ordering keep scalar ``TraceBuffer.emit`` — a staged
    record does not reach the ring until flush, so two threads batching
    into one ring would interleave at flush granularity, not emit order.
    """

    __slots__ = ("ring", "capacity", "flush_ns", "_bytes", "_buf",
                 "_bufp", "_fc_flush", "_n", "_t0", "emitted",
                 "flushes")

    def __init__(self, ring: TraceBuffer, capacity: int = EMIT_BATCH_CAPACITY,
                 flush_ns: int = EMIT_BATCH_FLUSH_NS):
        if capacity <= 0:
            raise ValueError("EmitBatch capacity must be > 0")
        self.ring = ring
        self.capacity = int(capacity)
        self.flush_ns = int(flush_ns)
        # Staging block: a bytearray written by struct.pack_into (one C
        # call per staged record) with a (capacity, 8) u64 numpy view
        # over the same bytes for the flush.
        self._bytes = bytearray(self.capacity * TRACE_REC_WORDS * 8)
        self._buf = np.frombuffer(self._bytes, dtype="<u8").reshape(
            self.capacity, TRACE_REC_WORDS)
        # Precomputed staging pointers: when the ring is native, flush
        # is ONE C call with no per-flush pointer marshalling.
        self._bufp = None
        self._fc_flush = None
        if ring._fc is not None:
            self._fc_flush = (ring._fc.trace_emit_many, ring._addr,
                              self._buf.ctypes.data)
        elif ring._nat is not None:
            from pbs_tpu_torch.runtime import native as native_mod

            self._bufp = native_mod.as_u64p(self._buf.reshape(-1))
        self._n = 0
        self._t0 = -1  # ts of the oldest staged record; -1 = empty
        self.emitted = 0
        self.flushes = 0

    def emit(self, ts_ns: int, event: int, *args: int) -> None:
        off = self._n * (TRACE_REC_WORDS * 8)
        n = len(args)
        if n > 6:
            args = args[:6]
            n = 6
        b = self._bytes
        try:
            struct.pack_into(_PACK_FMTS[n], b, off, ts_ns, event, *args)
        except struct.error:
            struct.pack_into(
                _PACK_FMTS[n], b, off, int(ts_ns) & _U64_MASK,
                int(event) & _U64_MASK,
                *[int(x) & _U64_MASK for x in args])
        if n < 6:
            b[off + (2 + n) * 8:off + TRACE_REC_WORDS * 8] = _ZERO_TAIL[n]
        self._n += 1
        ts_ns = int(ts_ns)
        if self._t0 < 0:
            self._t0 = ts_ns
        if self._n >= self.capacity or ts_ns - self._t0 >= self.flush_ns:
            self.flush()

    def pending(self) -> int:
        return self._n

    def drop_pending(self) -> int:
        """Discard staged records WITHOUT writing them — the kill-9
        model (gateway/chaos.py): records staged in a dead process's
        batch never reached the ring and must not leak into the
        recovered process's stream. Returns the count dropped."""
        n, self._n = self._n, 0
        self._t0 = -1
        return n

    def flush(self) -> int:
        """Push staged records to the ring; returns records written
        (staged minus any the full ring dropped). One
        ``pbst_trace_emit_many`` C call when the ring is native."""
        n, self._n = self._n, 0
        self._t0 = -1
        if not n:
            return 0
        self.flushes += 1
        if self._fc_flush is not None:
            f, ring_addr, buf_addr = self._fc_flush
            written = f(ring_addr, buf_addr, n)
        elif self._bufp is not None:
            ring = self.ring
            written = int(ring._nat.pbst_trace_emit_many(
                ring._ptr, self._bufp, n))
        else:
            written = self.ring.emit_many(self._buf[:n])
        self.emitted += written
        return written


def merge_records(chunks: list[np.ndarray]) -> np.ndarray:
    """Merge per-ring record batches into one time-sorted stream (the
    xentrace multi-CPU merge). Stable sort keeps same-timestamp records
    in ring order."""
    chunks = [c for c in chunks if len(c)]
    if not chunks:
        return np.empty((0, TRACE_REC_WORDS), dtype="<u8")
    allr = np.concatenate(chunks, axis=0)
    return allr[np.argsort(allr[:, 0], kind="stable")]


def format_records(recs: np.ndarray) -> list[str]:
    """xentrace_format analog: human-readable lines."""
    out = []
    # tolist() converts the whole batch to Python ints in one C pass —
    # per-element numpy scalar boxing dominates the scalar version.
    for ts, ev, *args in np.asarray(recs).tolist():
        try:
            name = Ev(ev).name
        except ValueError:
            name = f"0x{ev:04x}"
        out.append(f"[{ts / 1e9:.6f}] {name} {' '.join(map(str, args))}")
    return out


def chrome_trace(recs: np.ndarray, labels: dict[int, str] | None = None,
                 pid: int = 0) -> dict:
    """Convert drained records to the Chrome trace-event format (load
    in chrome://tracing or Perfetto) — the graphical leg of the
    xentrace_format analog. SCHED_PICK/SCHED_DESCHED pairs become
    duration ('X') events on a per-context track (tid = ctx slot, dur
    from the desched's device-true ran_ns); everything else becomes an
    instant event on its slot's track. ``labels`` maps ctx slots to
    display names (e.g. from the ledger sidecar meta)."""
    labels = labels or {}
    events: list[dict] = []
    open_pick: dict[int, int] = {}  # slot -> pick ts
    for ts, ev, *a in np.asarray(recs).tolist():
        slot = a[0] if a else 0
        try:
            name = Ev(ev).name
        except ValueError:
            name = f"0x{ev:04x}"
        if ev == Ev.SCHED_PICK:
            open_pick[slot] = ts
        elif ev == Ev.SCHED_DESCHED and slot in open_pick:
            t0 = open_pick.pop(slot)
            ran_ns = a[1] if len(a) > 1 else ts - t0
            events.append({
                "name": labels.get(slot, f"ctx{slot}"),
                "ph": "X", "cat": "sched",
                "ts": t0 / 1e3, "dur": max(ran_ns, 1) / 1e3,
                "pid": pid, "tid": slot,
                "args": {"ran_ns": ran_ns},
            })
        else:
            events.append({
                "name": name, "ph": "i", "s": "t",
                "cat": name.split("_")[0].lower(),
                "ts": ts / 1e3, "pid": pid, "tid": slot,
                "args": {f"a{i}": v for i, v in enumerate(a)},
            })
    return {"traceEvents": events, "displayTimeUnit": "ms"}
