"""Write-ahead intent journal: the gateway's crash-durable front door.

The port of ``pbs_tpu.gateway.journal``, record for record: the same
header words, frame marker, CRC, interning, record taxonomy and commit
discipline, so a scripted run writes byte-identical journal files in
both packages and each package reads and recovers the other's
(``tests/test_torch_journal.py``). docs/DURABILITY.md describes the
format and the crash windows.

- **Intents before state** — ADMIT/DISPATCH/COMPLETE/SHED/REQUEUE/
  ADOPT custody moves plus lease GRANT/DEPOSIT/DESTROY odometer
  records and periodic sealed lease-book CKPT groups are journaled
  *before* the in-memory state machine moves.
- **Group commit** — producers stage records through the
  :class:`~pbs_tpu_torch.obs.trace.EmitBatch` path (the journal
  duck-types the ring surface the batch flushes into), and
  :meth:`GatewayJournal.commit` seals the staged records into ONE
  CRC-guarded frame written with ONE ``os.write`` per gateway tick,
  ``fsync`` every ``journal.fsync_every`` commits (the knob registry's
  default). The durability watermark is therefore the tick: a crash
  loses at most the current uncommitted frame, and a client ack is
  only *durable* once its frame committed.
- **Torn-tail-safe format** — a fixed u64-word header (magic, abi,
  generation — the generation bumps with ONE atomic 8-byte store at
  every recovery reopen), then append-only frames of fixed-width 8-word
  u64 records sealed by a CRC word. A *torn tail* (partial final frame)
  is detected, reported, and NEVER trusted. A CRC or marker mismatch on
  a *complete* frame is corruption — a hard :class:`JournalCorrupt`
  with the byte offset, never a silent skip.

Recovery lives in :mod:`pbs_tpu_torch.gateway.recovery`; the kill-9
chaos harness that proves it is ``run_federation_chaos(crash_plan=...)``
(``gateway/chaos.py``).
"""

from __future__ import annotations

import dataclasses
import enum
import os
import struct
import zlib

import numpy as np

from pbs_tpu_torch import knobs
from pbs_tpu_torch.faults import injector as _faults
from pbs_tpu_torch.obs.trace import TRACE_REC_WORDS, EmitBatch

JOURNAL_MAGIC = int.from_bytes(b"PBSTJRNL", "little")
JOURNAL_ABI = 1
HEADER_WORDS = 4
_W_MAGIC, _W_ABI, _W_GEN, _W_RESERVED = range(HEADER_WORDS)

#: Frame marker: high 32 bits pin the frame protocol, low 32 bits are
#: the record count — a full-width word that random data is unlikely
#: to fake, so a bad marker is distinguishable corruption.
FRAME_MAGIC = 0x5042464D  # "PBFM"
_MARKER_SHIFT = 32
_U64 = 0xFFFFFFFFFFFFFFFF

#: Group-commit staging watermarks + durability cadence, declared in
#: the knob registry (journal.*).
BATCH_CAPACITY = knobs.default("journal.batch_capacity")
FLUSH_NS = knobs.default("journal.flush_ns")
FSYNC_EVERY = knobs.default("journal.fsync_every")
CHECKPOINT_PERIOD_NS = knobs.default("journal.checkpoint_period_ns")

#: Bytes of interned-string payload per INTERN record (args a3..a5).
_INTERN_CHUNK = 24


class Jr(enum.IntEnum):
    """Journal record taxonomy. Records are the trace layout — (ts,
    op, a0..a5) as 8 little-endian u64 words — so the EmitBatch
    staging path and every u64 tool carry over unchanged."""

    # identity / topology
    INTERN = 0x01  # a0=sid, a1=total_len, a2=chunk_idx, a3..a5=24 bytes
    MEMBER = 0x02  # a0=member_sid, a1=event code (MEMBER_EVENTS)
    TENANT = 0x03  # a0=tenant_sid, a1=rate_bits, a2=burst_bits,
    #                a3=weight, a4=slo_code, a5=max_queued
    # request intents (rids are interned strings like member names —
    # no parsing, no namespace assumptions)
    ADMIT = 0x10  # a0=member_sid, a1=rid_sid, a2=tenant_sid, a3=cls,
    #               a4=cost, a5=spend_kind (SPEND_*)
    DISPATCH = 0x11  # a0=custody_sid, a1=rid_sid, a2=deficit_x1e6
    COMPLETE = 0x12  # a0=custody_sid, a1=rid_sid
    SHED = 0x13  # a0=member_sid, a1=tenant_sid, a2=cls, a3=reason_code
    REQUEUE = 0x14  # a0=custody_sid, a1=rid_sid
    ADOPT = 0x15  # a0=new_custody_sid, a1=rid_sid
    ADOPT_TENANT = 0x16  # a0=to_sid, a1=from_sid, a2=tenant_sid,
    #                      a3=cls, a4=deficit_x1e6
    # lease books (float odometers as float64 bit patterns)
    GRANT = 0x20  # a0=tenant_sid, a1=member_sid, a2=tokens_bits,
    #               a3=bank_minted_bits, a4=bank_level_bits
    DEPOSIT = 0x21  # a0=tenant_sid, a1=member_sid, a2=accepted_bits,
    #                 a3=bank_minted_bits, a4=bank_level_bits
    DESTROY = 0x22  # a0=tenant_sid, a1=member_sid, a2=tokens_bits
    # sealed lease-book checkpoints (journal.checkpoint_period_ns)
    CKPT = 0x30  # a0=tenant_sid, a1=minted_bits, a2=granted_bits,
    #              a3=deposited_bits, a4=level_bits
    CKPT_SEAL = 0x31  # a0=ckpt_seq, a1=n_tenants
    # recovery epoch boundary (written by recover_federation)
    RECOVER = 0x40  # a0=generation, a1=n_queued, a2=n_inflight


#: MEMBER record event codes.
MEMBER_EVENTS = {"add": 0, "kill": 1, "drain": 2, "retire": 3}
MEMBER_EVENT_NAMES = {v: k for k, v in MEMBER_EVENTS.items()}

#: ADMIT spend kinds: which odometer the admission charge moved.
SPEND_NONE = 0  # plain TokenBucket (single gateway, no lease path)
SPEND_LEASED = 1  # LeasedBucket prepaid tokens
SPEND_CONSERVATIVE = 2  # degraded-mode emergency scrip


def rid_string(member: str, generation: int, seq: int) -> str:
    """The rid namespace: generation 0 is the plain pre-crash form
    (byte-identical to un-journaled gateways); every recovery epoch
    opens a fresh ``-r<gen>-`` namespace so a post-recovery rid can
    never collide with an UNACKED pre-crash rid whose sequence number
    the journal, by definition, does not know."""
    if generation == 0:
        return f"{member}-{seq}"
    return f"{member}-r{generation}-{seq}"


def _f2w(value: float) -> int:
    """float64 -> u64 bit pattern (the knobs-channel pack)."""
    return struct.unpack("<Q", struct.pack("<d", float(value)))[0]


def _w2f(word: int) -> float:
    return struct.unpack("<d", struct.pack("<Q", int(word)))[0]


class JournalError(RuntimeError):
    pass


class JournalCorrupt(JournalError):
    """A COMPLETE frame whose marker or CRC does not verify: bit rot
    or an overwrite, never a crash artifact (crashes truncate — they
    cannot mismatch a CRC on a fully-present frame). Recovery refuses
    it outright, with the offset; silent skipping would replay a
    state machine with a hole in the middle."""

    def __init__(self, offset: int, reason: str):
        self.offset = int(offset)
        super().__init__(f"journal corrupt at byte {offset}: {reason}")


class ProcessKill(RuntimeError):
    """The injected kill-9: raised by the ``journal.crash`` seam
    mid-commit (torn frame on disk) or by the chaos harness's
    ``gateway.process.kill`` seam at a tick boundary. The handler
    drops EVERY in-memory object and recovers from journal bytes
    alone (gateway/chaos.py)."""

    def __init__(self, kind: str, position: int):
        self.kind = kind
        self.position = int(position)
        super().__init__(f"process killed ({kind} @ {position})")


@dataclasses.dataclass
class JournalView:
    """One validated read of a journal file (the ONLY sealed read
    surface — ``dur-unsealed-read`` flags frame consumers that bypass
    it). ``records`` holds every record of every sealed frame, in
    append order; a torn tail is reported, truncated at
    ``valid_bytes``, and never parsed."""

    generation: int
    records: list[tuple[int, ...]]  # (ts, op, a0..a5) per record
    valid_bytes: int  # header + sealed frames
    torn_bytes: int  # trailing bytes past the last sealed frame
    frames: int


class GatewayJournal:
    """The writer end: stage intents, group-commit frames.

    Single-writer by construction (the gateway/federation pump owns
    it); readers use :func:`read_journal` on the file at rest.
    """

    # EmitBatch duck-typing: the batch flushes into ``emit_many`` and
    # only takes its native fast paths when these are non-None.
    _fc = None
    _nat = None

    def __init__(self, path: str, fd: int, generation: int,
                 interned: dict[str, int] | None = None,
                 batch_capacity: int = BATCH_CAPACITY,
                 flush_ns: int = FLUSH_NS,
                 fsync_every: int = FSYNC_EVERY):
        self.path = path
        self._fd = fd
        self.generation = int(generation)
        self._interned: dict[str, int] = dict(interned or {})
        self._pending: list[np.ndarray] = []
        self._pending_n = 0
        #: Cumulative records sealed into frames (the ``journal.crash``
        #: seam's ``after=`` position space).
        self.committed_records = 0
        self.commits = 0
        self.fsync_every = int(fsync_every)
        self._ckpt_seq = 0
        self.batch = EmitBatch(self, capacity=int(batch_capacity),
                               flush_ns=int(flush_ns))

    # -- construction ----------------------------------------------------

    @classmethod
    def create(cls, path: str, **kw) -> "GatewayJournal":
        fd = os.open(path, os.O_RDWR | os.O_CREAT | os.O_TRUNC, 0o644)
        hdr = struct.pack(f"<{HEADER_WORDS}Q", JOURNAL_MAGIC,
                          JOURNAL_ABI, 0, 0)
        os.write(fd, hdr)
        return cls(path, fd, generation=0, **kw)

    @classmethod
    def reopen(cls, path: str, view: JournalView | None = None,
               **kw) -> "GatewayJournal":
        """Recovery reopen: validate the file, TRUNCATE the torn tail
        (it was never trusted; leaving the bytes would corrupt the
        next append), and bump the header generation with one atomic
        8-byte store. The returned journal appends after the last
        sealed frame and re-interns the recorded string table so sids
        stay stable across the restart. ``view`` accepts a
        :func:`read_journal` result the caller already validated
        (recovery reads the file to replay it anyway) so reopen does
        not pay a second full-file read + CRC pass."""
        if view is None:
            view = read_journal(path)
        fd = os.open(path, os.O_RDWR)
        os.ftruncate(fd, view.valid_bytes)
        os.lseek(fd, view.valid_bytes, os.SEEK_SET)
        gen = view.generation + 1
        os.pwrite(fd, struct.pack("<Q", gen), _W_GEN * 8)
        interned = {}
        for name, sid in iter_interned(view.records):
            interned[name] = sid
        j = cls(path, fd, generation=gen, interned=interned, **kw)
        j.committed_records = len(view.records)
        return j

    def close(self) -> None:
        self.commit()
        os.close(self._fd)

    def abandon(self) -> None:
        """Kill-9 emulation: drop every staged intent and close the
        descriptor WITHOUT committing — what the kernel does to a
        dead process's fds. The bytes already on disk are the whole
        surviving truth."""
        self._pending = []
        self._pending_n = 0
        self.batch.drop_pending()
        try:
            os.close(self._fd)
        except OSError:
            pass

    # -- the EmitBatch ring surface --------------------------------------

    def emit_many(self, recs: np.ndarray) -> int:
        """Stage a flushed batch into the pending frame (no disk I/O:
        the frame lands at :meth:`commit`)."""
        recs = np.ascontiguousarray(recs, dtype="<u8")
        if recs.ndim != 2 or recs.shape[1] != TRACE_REC_WORDS:
            raise ValueError(
                f"journal wants (n, {TRACE_REC_WORDS}) u64 records, "
                f"got {recs.shape}")
        if recs.shape[0]:
            self._pending.append(recs.copy())
            self._pending_n += recs.shape[0]
        return int(recs.shape[0])

    # -- interning -------------------------------------------------------

    def intern(self, name: str) -> int:
        sid = self._interned.get(name)
        if sid is not None:
            return sid
        sid = self._interned[name] = len(self._interned)
        raw = name.encode()
        for chunk_idx in range(0, max(1, len(raw)), _INTERN_CHUNK):
            chunk = raw[chunk_idx:chunk_idx + _INTERN_CHUNK]
            words = [int.from_bytes(chunk[i:i + 8], "little")
                     for i in range(0, _INTERN_CHUNK, 8)]
            self.batch.emit(0, Jr.INTERN, sid, len(raw),
                            chunk_idx // _INTERN_CHUNK, *words)
        return sid

    # -- intent emits (all through the batch) ----------------------------

    def member_event(self, ts: int, member: str, event: str) -> None:
        self.batch.emit(ts, Jr.MEMBER, self.intern(member),
                        MEMBER_EVENTS[event])

    def tenant(self, ts: int, name: str, quota) -> None:
        self.batch.emit(ts, Jr.TENANT, self.intern(name),
                        _f2w(quota.rate), _f2w(quota.burst),
                        int(quota.weight), _slo_code(quota.slo),
                        int(quota.max_queued))

    def admit(self, ts: int, member: str, rid: str, tenant: str,
              cls_code: int, cost: int, spend_kind: int) -> None:
        self.batch.emit(ts, Jr.ADMIT, self.intern(member),
                        self.intern(rid), self.intern(tenant),
                        cls_code, cost, spend_kind)

    def dispatch(self, ts: int, custody: str, rid: str,
                 deficit_x1e6: int) -> None:
        self.batch.emit(ts, Jr.DISPATCH, self.intern(custody),
                        self.intern(rid), deficit_x1e6)

    def complete(self, ts: int, custody: str, rid: str) -> None:
        self.batch.emit(ts, Jr.COMPLETE, self.intern(custody),
                        self.intern(rid))

    def shed(self, ts: int, member: str, tenant: str, cls_code: int,
             reason_code: int) -> None:
        self.batch.emit(ts, Jr.SHED, self.intern(member),
                        self.intern(tenant), cls_code, reason_code)

    def requeue(self, ts: int, custody: str, rid: str) -> None:
        self.batch.emit(ts, Jr.REQUEUE, self.intern(custody),
                        self.intern(rid))

    def adopt(self, ts: int, custody: str, rid: str) -> None:
        self.batch.emit(ts, Jr.ADOPT, self.intern(custody),
                        self.intern(rid))

    def adopt_tenant(self, ts: int, to_member: str, from_member: str,
                     tenant: str, cls_code: int,
                     deficit_x1e6: int) -> None:
        self.batch.emit(ts, Jr.ADOPT_TENANT, self.intern(to_member),
                        self.intern(from_member), self.intern(tenant),
                        cls_code, deficit_x1e6)

    def grant(self, ts: int, tenant: str, member: str, tokens: float,
              bank_minted: float, bank_level: float) -> None:
        self.batch.emit(ts, Jr.GRANT, self.intern(tenant),
                        self.intern(member), _f2w(tokens),
                        _f2w(bank_minted), _f2w(bank_level))

    def deposit(self, ts: int, tenant: str, member: str,
                accepted: float, bank_minted: float,
                bank_level: float) -> None:
        self.batch.emit(ts, Jr.DEPOSIT, self.intern(tenant),
                        self.intern(member), _f2w(accepted),
                        _f2w(bank_minted), _f2w(bank_level))

    def destroy(self, ts: int, tenant: str, member: str,
                tokens: float) -> None:
        self.batch.emit(ts, Jr.DESTROY, self.intern(tenant),
                        self.intern(member), _f2w(tokens))

    def checkpoint(self, ts: int, books: dict[str, dict[str, float]]
                   ) -> None:
        """One sealed lease-book checkpoint group: a CKPT record per
        tenant (bank odometers) closed by a CKPT_SEAL carrying the
        tenant count — recovery trusts only GROUPS whose seal made it
        into a sealed frame."""
        names = sorted(books)
        for t in names:
            b = books[t]
            self.batch.emit(ts, Jr.CKPT, self.intern(t),
                            _f2w(b["minted"]), _f2w(b["granted"]),
                            _f2w(b["deposited"]), _f2w(b["bank_level"]))
        self.batch.emit(ts, Jr.CKPT_SEAL, self._ckpt_seq, len(names))
        self._ckpt_seq += 1

    def recover_mark(self, ts: int, n_queued: int,
                     n_inflight: int) -> None:
        self.batch.emit(ts, Jr.RECOVER, self.generation, n_queued,
                        n_inflight)

    # -- group commit ----------------------------------------------------

    def pending(self) -> int:
        return self._pending_n + self.batch.pending()

    def commit(self) -> int:
        """Seal staged records into ONE CRC'd frame and write it with
        ONE ``os.write`` (+ fsync per the ``journal.fsync_every``
        cadence). Returns bytes written (0 = nothing staged).

        The ``journal.crash`` fault seam lives here: one consultation
        per record being sealed, so a plan position ``after=k`` kills
        the process with exactly k records durable and the (k+1)-th
        frame torn mid-write — the crash the torn-tail rules exist
        for. The cut lands *inside* the frame bytes (never a clean
        frame boundary), fsync'd so the torn prefix is exactly what a
        real kill-9 would leave."""
        self.batch.flush()
        n = self._pending_n
        if not n:
            return 0
        recs = (self._pending[0] if len(self._pending) == 1
                else np.concatenate(self._pending, axis=0))
        self._pending = []
        self._pending_n = 0
        marker = (FRAME_MAGIC << _MARKER_SHIFT) | (n & 0xFFFFFFFF)
        body = struct.pack("<Q", marker) + recs.tobytes()
        crc = zlib.crc32(body) & _U64
        frame = body + struct.pack("<Q", crc)
        if _faults.active() is not None:
            rec_bytes = TRACE_REC_WORDS * 8  # hoisted: not a rec loop
            for i in range(n):
                f = _faults.consult("journal.crash", "journal")
                if f is not None:
                    cut = 8 + i * rec_bytes \
                        + int(f.args.get("cut_bytes", 12))
                    cut = max(1, min(cut, len(frame) - 3))
                    os.write(self._fd, frame[:cut])
                    os.fsync(self._fd)
                    raise ProcessKill("journal.crash",
                                      self.committed_records + i)
        os.write(self._fd, frame)
        self.committed_records += n
        self.commits += 1
        if self.fsync_every > 0 and self.commits % self.fsync_every == 0:
            os.fsync(self._fd)
        return len(frame)


# -- the sealed read surface -------------------------------------------------


def read_journal(path: str) -> JournalView:
    """Validate and parse a journal file — torn tail tolerated and
    truncated (reported in ``torn_bytes``), corrupt body refused with
    the offending byte offset. This is THE frame consumer; everything
    else (recovery, ``pbst-torch journal``) goes through it."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < HEADER_WORDS * 8:
        raise JournalCorrupt(0, f"file shorter than the {HEADER_WORDS}"
                                f"-word header ({len(data)} bytes)")
    magic, abi, gen, _ = struct.unpack_from(f"<{HEADER_WORDS}Q", data, 0)
    if magic != JOURNAL_MAGIC:
        raise JournalCorrupt(0, "bad magic (not a PBSTJRNL journal)")
    if abi != JOURNAL_ABI:
        raise JournalCorrupt(8, f"abi {abi} != {JOURNAL_ABI}")
    records: list[tuple[int, ...]] = []
    frames = 0
    off = HEADER_WORDS * 8
    size = len(data)
    while off < size:
        if size - off < 8:
            break  # torn: partial marker word
        (marker,) = struct.unpack_from("<Q", data, off)
        if (marker >> _MARKER_SHIFT) != FRAME_MAGIC:
            raise JournalCorrupt(
                off, f"bad frame marker 0x{marker:016x}")
        n = marker & 0xFFFFFFFF
        frame_bytes = 8 * (1 + n * TRACE_REC_WORDS + 1)
        if size - off < frame_bytes:
            break  # torn: the final frame never finished writing
        body = data[off:off + frame_bytes - 8]
        (crc,) = struct.unpack_from("<Q", data, off + frame_bytes - 8)
        if (zlib.crc32(body) & _U64) != crc:
            raise JournalCorrupt(
                off, f"frame CRC mismatch (n={n} records)")
        # One vectorized view + one bulk tolist per frame — never a
        # per-record unpack loop (the perf-rec-loop rule's point).
        arr = np.frombuffer(data, dtype="<u8", offset=off + 8,
                            count=n * TRACE_REC_WORDS)
        records.extend(
            tuple(row)
            for row in arr.reshape(n, TRACE_REC_WORDS).tolist())
        frames += 1
        off += frame_bytes
    return JournalView(generation=int(gen), records=records,
                       valid_bytes=off, torn_bytes=size - off,
                       frames=frames)


def iter_interned(records) -> list[tuple[str, int]]:
    """Rebuild the string table from INTERN records, in sid order."""
    chunks: dict[int, dict[int, bytes]] = {}
    lengths: dict[int, int] = {}
    for rec in records:
        if rec[1] != Jr.INTERN:
            continue
        sid, total, idx = int(rec[2]), int(rec[3]), int(rec[4])
        raw = b"".join(int(w).to_bytes(8, "little") for w in rec[5:8])
        chunks.setdefault(sid, {})[idx] = raw
        lengths[sid] = total
    out: list[tuple[str, int]] = []
    for sid in sorted(chunks):
        raw = b"".join(chunks[sid][i]
                       for i in sorted(chunks[sid]))[:lengths[sid]]
        out.append((raw.decode(), sid))
    return out


def _slo_code(cls: str) -> int:
    from pbs_tpu_torch.gateway.admission import SLO_CLASSES

    return SLO_CLASSES.index(cls)


def format_record(rec: tuple[int, ...],
                  names: dict[int, str] | None = None) -> dict:
    """One record as a stable JSON-able dict (``pbst-torch journal dump``)."""
    ts, op, *args = (int(w) for w in rec)
    try:
        op_name = Jr(op).name
    except ValueError:
        op_name = f"0x{op:04x}"
    d = {"ts": ts, "op": op_name, "args": list(args)}
    if names:
        hints = _ARG_NAMES.get(op)
        if hints:
            d["decoded"] = {
                label: (names.get(args[i], f"#{args[i]}")
                        if kind == "sid" else
                        round(_w2f(args[i]), 6) if kind == "f64"
                        else args[i])
                for i, (label, kind) in enumerate(hints)
            }
    return d


#: Per-op arg decoding hints for ``pbst-torch journal dump`` (label, kind):
#: kind "sid" renders through the intern table, "f64" unpacks float
#: bits, "raw" passes through.
_ARG_NAMES: dict[int, tuple[tuple[str, str], ...]] = {
    Jr.MEMBER: (("member", "sid"), ("event", "raw")),
    Jr.TENANT: (("tenant", "sid"), ("rate", "f64"), ("burst", "f64"),
                ("weight", "raw"), ("slo", "raw"), ("max_queued", "raw")),
    Jr.ADMIT: (("member", "sid"), ("rid", "sid"), ("tenant", "sid"),
               ("cls", "raw"), ("cost", "raw"), ("spend", "raw")),
    Jr.DISPATCH: (("custody", "sid"), ("rid", "sid"),
                  ("deficit_x1e6", "raw")),
    Jr.COMPLETE: (("custody", "sid"), ("rid", "sid")),
    Jr.SHED: (("member", "sid"), ("tenant", "sid"), ("cls", "raw"),
              ("reason", "raw")),
    Jr.REQUEUE: (("custody", "sid"), ("rid", "sid")),
    Jr.ADOPT: (("custody", "sid"), ("rid", "sid")),
    Jr.ADOPT_TENANT: (("to", "sid"), ("from", "sid"), ("tenant", "sid"),
                      ("cls", "raw"), ("deficit_x1e6", "raw")),
    Jr.GRANT: (("tenant", "sid"), ("member", "sid"), ("tokens", "f64"),
               ("bank_minted", "f64"), ("bank_level", "f64")),
    Jr.DEPOSIT: (("tenant", "sid"), ("member", "sid"),
                 ("accepted", "f64"), ("bank_minted", "f64"),
                 ("bank_level", "f64")),
    Jr.DESTROY: (("tenant", "sid"), ("member", "sid"),
                 ("tokens", "f64")),
    Jr.CKPT: (("tenant", "sid"), ("minted", "f64"), ("granted", "f64"),
              ("deposited", "f64"), ("bank_level", "f64")),
    Jr.CKPT_SEAL: (("ckpt_seq", "raw"), ("n_tenants", "raw")),
    Jr.RECOVER: (("generation", "raw"), ("n_queued", "raw"),
                 ("n_inflight", "raw")),
}
