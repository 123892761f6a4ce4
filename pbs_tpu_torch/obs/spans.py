"""Request-scoped span tracing + per-tenant SLO observability.

The port of ``pbs_tpu.obs.spans``. Every admitted gateway request
becomes a **span chain** keyed on its ``rid``: admission, fair-queue
entry, DRR dispatch (deficit attached), backend execution, completion,
and requeues after backend loss. Three pieces:

- :class:`SpanRecorder` — the producer. Interns rids and member names
  to dense u64 ids and emits ``SPAN_*`` records (``obs.trace.Ev``,
  class 0x08xx) through an :class:`~pbs_tpu_torch.obs.trace.EmitBatch`.
- :class:`LatencyHistograms` — log2-bucketed latency histograms per
  ``(who, class, stage)``, living in telemetry **ledger slots** (one
  seqlock slot per histogram; the 18 counter words ARE the buckets),
  so monitors snapshot them lock-free like any other ledger, and
  quantiles come from :func:`hist_quantile` — the nearest-rank
  estimator over bucket upper edges, never an interpolated value.
  ``record`` fuses bucket + seqlock into one native call when the
  runtime is loaded (byte-identical to the Python tier), and
  :class:`HistBatch` stages a pump tick's samples into one
  ``record_many`` flush.
- :class:`SpanAssembler` — the consumer. Reconstructs per-rid
  timelines from drained trace records, validates **gap-free chain**
  invariants, exports Chrome trace JSON, and builds the SLO view:
  per-tenant p50/p95/p99 and SLO burn-rate against the tenant's
  latency target.

The histograms ride their ledger's tier (``native=None`` picks the
native one when the library builds); slot bytes, records and verdicts
equal the reference's on every tier (``tests/test_torch_spans.py``,
``tests/test_torch_native.py``).

Determinism: the recorder adds no randomness and consults no fault
streams, so arming it leaves a run's digests untouched — span
continuity is a pure *observer* invariant.
"""

from __future__ import annotations

import json
import os

import numpy as np

from pbs_tpu_torch.obs.trace import (
    TRACE_REC_WORDS,
    _U64_MASK,
    EmitBatch,
    Ev,
    TraceBuffer,
)
from pbs_tpu_torch.telemetry.counters import NUM_COUNTERS
from pbs_tpu_torch.telemetry.ledger import Ledger
from pbs_tpu_torch.utils.clock import MS

# -- log2 latency histograms -------------------------------------------------

#: Buckets per histogram == counter words per ledger slot: the slot IS
#: the histogram, so every existing ledger surface (file-backed attach,
#: seqlock snapshot, snapshot_many) works on histograms unchanged.
HIST_BUCKETS = NUM_COUNTERS
#: Bucket 0 upper edge is 2**(HIST_SHIFT+1) ns (~16 us): everything
#: faster is "instant" at serving-tier resolution. The top bucket opens
#: at 2**(HIST_SHIFT+HIST_BUCKETS-1) ns (~1.07 s): everything slower
#: is an SLO catastrophe whose exact value no longer matters.
HIST_SHIFT = 13

#: Request lifecycle stages a histogram is kept for (docs/TRACING.md):
#: ``queue`` = admit->dispatch wait, ``service`` = backend execution,
#: ``e2e`` = admit->complete.
SPAN_STAGES = ("queue", "service", "e2e")

#: Default per-class SLO latency targets (e2e) the burn-rate report
#: uses when the tenant spec doesn't pin one (TenantSpec.slo_target_ns).
DEFAULT_SLO_TARGET_NS = {"interactive": 50 * MS, "batch": 500 * MS}
#: The SLO objective burn rates are normalized against: 99% of
#: requests under target; burn 1.0 = exactly spending the 1% budget.
SLO_OBJECTIVE = 0.99


def hist_bucket(value_ns: int) -> int:
    """Bucket index for a latency: pure int ops, nothing allocated.
    Bucket b (0 < b < last) covers [2**(SHIFT+b), 2**(SHIFT+b+1))."""
    b = int(value_ns).bit_length() - 1 - HIST_SHIFT
    if b < 0:
        return 0
    last = HIST_BUCKETS - 1
    return b if b < last else last


def bucket_edges() -> np.ndarray:
    """Upper edges (inclusive representative values) per bucket — the
    value :func:`hist_quantile` reports for a sample landing in the
    bucket. One vectorized table, computed once."""
    return np.array(
        [(1 << (HIST_SHIFT + b + 1)) - 1 for b in range(HIST_BUCKETS)],
        dtype=np.int64)


_EDGES = bucket_edges()


def hist_quantile(counts: np.ndarray, q: float) -> int:
    """Nearest-rank quantile over a bucket-count vector: the bucket
    holding the ``ceil(q*n)``-th smallest sample (1-indexed), reported
    as that bucket's upper edge — the same estimator family as
    ``utils.stats.nearest_rank`` (an edge a real sample sat under,
    never an interpolated value), at log2 resolution. 0 for empty.
    Vectorized (one cumsum + searchsorted): never a per-bucket Python
    scan in a hot path (the ``obs-hist-scan`` rule)."""
    c = np.asarray(counts, dtype=np.int64)
    total = int(c.sum())
    if total <= 0:
        return 0
    k = max(1, int(np.ceil(q * total)))
    b = int(np.searchsorted(np.cumsum(c), k))
    return int(_EDGES[min(b, HIST_BUCKETS - 1)])


class LatencyHistograms:
    """Log2 latency histograms in ledger slots, keyed ``(who, cls,
    stage)`` (``who`` is a tenant name or a ``be:<backend>`` row).

    ``record`` is the hot path: one dict hit + one ledger counter add
    (bucket + seqlock fused into a single native call when the runtime
    is loaded) — no allocation beyond the interning of a key the first
    time it is seen. Slots are allocated densely; when the ledger is
    full, new keys fold into a per-``(cls, stage)`` overflow row
    (counts are never dropped, attribution degrades to the class).
    """

    __slots__ = ("path", "ledger", "num_slots", "_slots", "_next",
                 "_overflow_slot", "_nat", "_natp", "_fc", "_addr",
                 "_fc_record")

    def __init__(self, num_slots: int = 256, path: str | None = None,
                 native: bool | str | None = None):
        if num_slots < 2:
            raise ValueError("LatencyHistograms needs >= 2 slots "
                             "(one is the reserved overflow row)")
        self.path = path
        if path is not None:
            self.ledger = Ledger.file_backed(path, num_slots=num_slots,
                                             native=native)
            for slot in range(num_slots):
                self.ledger.reset(slot)  # never inherit a previous run
        else:
            self.ledger = Ledger(num_slots, native=native)
        # The fused native paths (pbst_hist_record[_many]: log2 bucket
        # + seqlock add in one call) ride the ledger's binding tiers;
        # byte-identical slot state either way.
        self._nat = getattr(self.ledger, "_nat", None)
        self._natp = getattr(self.ledger, "_ptr", None)
        self._fc = getattr(self.ledger, "_fc", None)
        self._addr = getattr(self.ledger, "_addr", 0)
        self._fc_record = (self._fc.hist_record
                           if self._fc is not None else None)
        self.num_slots = int(num_slots)
        self._slots: dict[tuple[str, str, str], int] = {}
        self._next = 0
        #: The last slot is RESERVED as the shared overflow row: it is
        #: never handed to a normal key, so overflow can never corrupt
        #: an allocated histogram (only the overflow row itself mixes
        #: keys, and only once every same-(cls, stage) fold target is
        #: also exhausted).
        self._overflow_slot = self.num_slots - 1

    def slot_of(self, who: str, cls: str, stage: str) -> int:
        """Interned ledger slot for a key (allocating on first sight).
        Public so staged producers (:class:`HistBatch`) can intern at
        record time — slot-allocation order, and therefore the meta
        sidecar, must not depend on when a batch flushes."""
        key = (who, cls, stage)
        slot = self._slots.get(key)
        if slot is not None:
            return slot
        if self._next < self._overflow_slot:
            slot = self._slots[key] = self._next
            self._next += 1
            if self.path is not None:
                self._write_meta()
            return slot
        # Full: fold into an existing row of the same (cls, stage) —
        # counts are never dropped, per-tenant attribution degrades to
        # the class (class aggregates stay exact, and class_counts
        # de-dupes shared slots).
        for (w, c, st), s in sorted(self._slots.items()):
            if c == cls and st == stage and s != self._overflow_slot:
                self._slots[key] = s
                return s
        # No same-class row exists either: the reserved shared
        # overflow row — mixed attribution, but never another
        # histogram's slot.
        slot = self._slots[key] = self._overflow_slot
        return slot

    def record(self, who: str, cls: str, stage: str,
               value_ns: int) -> None:
        """One latency sample: bucket + seqlock add, fused into one
        native call when the runtime is loaded. Values clamp to
        [0, 2^64): a negative (clock-skew) sample lands in bucket 0 on
        every tier."""
        slot = self._slots.get((who, cls, stage))
        if slot is None:
            slot = self.slot_of(who, cls, stage)
        fcr = self._fc_record
        if fcr is not None:
            # Negatives clamp to 0 (= bucket 0, the Python tier's
            # result); values are ns-scale by contract, far below the
            # u64 range where the C mask could matter.
            fcr(self._addr, slot,
                value_ns if value_ns >= 0 else 0, HIST_SHIFT)
            return
        if self._nat is not None:
            v = int(value_ns)
            if not 0 <= v <= _U64_MASK:
                v = 0 if v < 0 else v & _U64_MASK
            self._nat.pbst_hist_record(self._natp, slot, v, HIST_SHIFT)
            return
        self.ledger.add(slot, hist_bucket(value_ns), 1)

    def record_many(self, slots: np.ndarray, values: np.ndarray) -> None:
        """Batched :meth:`record` over parallel (slot, value) vectors
        — slots from :meth:`slot_of`, interned at stage time. One C
        call when native; the pure-Python fallback replays the scalar
        per-record protocol, so every tier leaves byte-identical
        ledger state (per-record seqlock version bumps included)."""
        slots = np.ascontiguousarray(slots, dtype=np.int64)
        values = np.ascontiguousarray(values, dtype="<u8")
        n = slots.size
        if values.size != n:
            raise ValueError(
                f"record_many wants parallel vectors, got {n} slots / "
                f"{values.size} values")
        if n == 0:
            return
        if self._fc is not None:
            self._fc.hist_record_many(self._addr, self.num_slots,
                                      slots, values, n, HIST_SHIFT)
            return
        if self._nat is not None:
            from pbs_tpu_torch.runtime import native as native_mod

            rc = self._nat.pbst_hist_record_many(
                self._natp, self.num_slots, native_mod.as_i64p(slots),
                native_mod.as_u64p(values), n, HIST_SHIFT)
            if rc == -2:
                raise IndexError("hist_record_many: slot out of range")
            return
        if ((slots < 0) | (slots >= self.num_slots)).any():
            # Prevalidated like the C path: a bad batch mutates nothing.
            raise IndexError("hist_record_many: slot out of range")
        add = self.ledger.add
        for s, v in zip(slots.tolist(), values.tolist()):
            add(s, hist_bucket(v), 1)

    # -- read side -------------------------------------------------------

    def counts(self, who: str, cls: str, stage: str) -> np.ndarray:
        slot = self._slots.get((who, cls, stage))
        if slot is None:
            return np.zeros(HIST_BUCKETS, dtype="<u8")
        return self.ledger.snapshot(slot)

    def quantile(self, who: str, cls: str, stage: str, q: float) -> int:
        return hist_quantile(self.counts(who, cls, stage), q)

    def class_counts(self, cls: str, stage: str) -> np.ndarray:
        """Aggregate bucket counts across every tenant of a class
        (backend ``be:`` rows excluded) — one vectorized
        ``snapshot_many`` + column sum, the monitors' fast path."""
        slots = sorted({
            s for (who, c, st), s in self._slots.items()
            if c == cls and st == stage and not who.startswith("be:")})
        if not slots:
            return np.zeros(HIST_BUCKETS, dtype="<u8")
        return self.ledger.snapshot_many(slots).sum(axis=0)

    def class_quantile(self, cls: str, stage: str, q: float) -> int:
        return hist_quantile(self.class_counts(cls, stage), q)

    def over_target(self, who: str, cls: str, stage: str,
                    target_ns: int) -> tuple[int, int]:
        """``(over, total)`` sample counts against an SLO latency
        target, at log2 resolution: a sample counts as over only when
        its whole bucket sits above the target's bucket (the sample
        provably exceeded the target; samples sharing the target's
        bucket count as under — conservative, so a burn rate built on
        this never cries wolf from quantization). The autopilot canary
        guard reads this delta-style over its guard window
        (docs/AUTOPILOT.md)."""
        c = self.counts(who, cls, stage).astype(np.int64)
        first_over = hist_bucket(int(target_ns)) + 1
        return int(c[first_over:].sum()), int(c.sum())

    def keys(self) -> list[tuple[str, str, str]]:
        return sorted(self._slots)

    # -- sidecar (pbst gateway stats / slo report attach) ----------------

    def _write_meta(self) -> None:
        meta = {
            "version": 1,
            "buckets": HIST_BUCKETS,
            "shift": HIST_SHIFT,
            "slots": {str(s): list(k)
                      for k, s in sorted(self._slots.items(),
                                         key=lambda kv: kv[1])},
        }
        tmp = self.path + ".meta.json.tmp"
        with open(tmp, "w") as f:
            json.dump(meta, f, indent=1, sort_keys=True)
        os.replace(tmp, self.path + ".meta.json")

    @classmethod
    def attach(cls, path: str) -> "LatencyHistograms":
        """Monitor attach to a producer's file-backed histogram ledger
        (read side only; the meta sidecar restores the key map)."""
        with open(path + ".meta.json") as f:
            meta = json.load(f)
        self = cls.__new__(cls)
        self.path = None
        self.ledger = Ledger.file_backed(path, readonly=True)
        self.num_slots = self.ledger.num_slots
        # Monitor attach never records; reads go through the ledger's
        # own snapshot paths (which keep their native tiers).
        self._nat = self._natp = self._fc = self._fc_record = None
        self._addr = 0
        self._slots = {tuple(k): int(s)
                       for s, k in meta["slots"].items()}
        self._next = len(self._slots)
        return self


class HistBatch:
    """Per-tick staging for histogram samples — the
    :class:`~pbs_tpu_torch.obs.trace.EmitBatch` of the latency layer: a
    pump's worth of ``record()`` calls land as ONE
    :meth:`LatencyHistograms.record_many` flush (one C call on the
    native tiers) instead of an interpreter round-trip per sample.

    Staging changes WHEN a sample reaches its ledger slot, never the
    bytes: keys intern at record() time (slot-allocation order — and
    therefore the meta sidecar — identical to scalar calls), values
    land in record order, and the flush keeps the per-record seqlock
    protocol. NOT thread-safe: one batch per pump thread, flushed at
    tick end and before any read of the histograms.

    On the pure-Python tier the batch degrades to DIRECT scalar
    records (flush is then a no-op): replaying staged scalars at flush
    would cost strictly more than recording in place, and the
    degraded mode keeps today's verified behavior exactly.
    """

    __slots__ = ("hist", "capacity", "_direct", "_s", "_v", "_sm",
                 "_vm", "_n", "recorded", "flushes")

    def __init__(self, hist: LatencyHistograms, capacity: int = 512):
        if capacity <= 0:
            raise ValueError("HistBatch capacity must be > 0")
        self.hist = hist
        self.capacity = int(capacity)
        self._direct = hist._nat is None and hist._fc is None
        self._s = np.zeros(self.capacity, dtype=np.int64)
        self._v = np.zeros(self.capacity, dtype="<u8")
        self._sm = memoryview(self._s)
        self._vm = memoryview(self._v)
        self._n = 0
        self.recorded = 0
        self.flushes = 0

    def record(self, who: str, cls: str, stage: str,
               value_ns: int) -> None:
        self.recorded += 1
        hist = self.hist
        if self._direct:
            hist.record(who, cls, stage, value_ns)
            return
        slot = hist._slots.get((who, cls, stage))
        if slot is None:
            slot = hist.slot_of(who, cls, stage)
        v = int(value_ns)
        if not 0 <= v <= _U64_MASK:  # the record() clamp contract
            v = 0 if v < 0 else v & _U64_MASK
        i = self._n
        self._sm[i] = slot
        self._vm[i] = v
        self._n = i + 1
        if self._n >= self.capacity:
            self.flush()

    def pending(self) -> int:
        return self._n

    def flush(self) -> int:
        """Land staged samples in the ledger; returns samples flushed."""
        n, self._n = self._n, 0
        if not n:
            return 0
        self.flushes += 1
        self.hist.record_many(self._s[:n], self._v[:n])
        return n


# -- the producer ------------------------------------------------------------


class SpanRecorder:
    """Interns rids/member names and stages ``SPAN_*`` records.

    One recorder per pump thread (the EmitBatch contract). A federated
    tier shares ONE recorder across members — all members pump on the
    federation's single thread, and a shared ring keeps the stitched
    chain in emission order with no cross-ring merge.
    """

    def __init__(self, ring: TraceBuffer | None = None,
                 batch: EmitBatch | None = None, capacity: int = 8192,
                 batch_capacity: int = 128,
                 max_spans: int = 262_144):
        self.ring = ring if ring is not None else TraceBuffer(capacity)
        self.batch = (batch if batch is not None
                      else EmitBatch(self.ring, capacity=batch_capacity))
        #: Intern-table bound: the rid table must stay reconstructable
        #: by the assembler, so ids are never recycled — instead, once
        #: ``max_spans`` rids have been seen, NEW spans are dropped
        #: (counted in ``dropped_spans``; existing chains keep
        #: emitting), the same graceful degradation as a full trace
        #: ring. A long-lived gateway therefore has bounded memory;
        #: size the bound to the run like the ring capacity.
        self.max_spans = int(max_spans)
        self.dropped_spans = 0
        self._span_ids: dict[str, int] = {}
        self._rids: list[str] = []
        self._member_ids: dict[str, int] = {}
        self._members: list[str] = []
        self._tenant_ids: dict[str, int] = {}
        self._tenants: list[str] = []
        self.spans_started = 0
        self.sheds = 0

    def span_id(self, rid: str) -> int | None:
        """Interned id for ``rid``; None once the table is full and
        the rid is new (the caller drops that span's events)."""
        sid = self._span_ids.get(rid)
        if sid is None:
            if len(self._rids) >= self.max_spans:
                self.dropped_spans += 1
                return None
            sid = self._span_ids[rid] = len(self._rids)
            self._rids.append(rid)
        return sid

    def member_id(self, name: str) -> int:
        mid = self._member_ids.get(name)
        if mid is None:
            mid = self._member_ids[name] = len(self._members)
            self._members.append(name)
        return mid

    def tenant_id(self, name: str) -> int:
        """Tenant slots are RECORDER-interned, not per-member: two
        federated members emitting about one tenant agree on the slot,
        so stitched chains attribute uniformly."""
        tid = self._tenant_ids.get(name)
        if tid is None:
            tid = self._tenant_ids[name] = len(self._tenants)
            self._tenants.append(name)
        return tid

    def rid_table(self) -> list[str]:
        return list(self._rids)

    def member_table(self) -> list[str]:
        return list(self._members)

    def tenant_table(self) -> list[str]:
        return list(self._tenants)

    # -- lifecycle emits (all through the batch; docs/TRACING.md) --------

    def admit(self, now: int, rid: str, tenant: str, cls: int,
              cost: int, member: str) -> None:
        sid = self.span_id(rid)
        if sid is None:
            return
        self.spans_started += 1
        self.batch.emit(now, Ev.SPAN_ADMIT, sid,
                        self.tenant_id(tenant), cls, cost,
                        self.member_id(member))

    def shed(self, now: int, tenant: str, cls: int,
             reason_code: int, member: str) -> None:
        self.sheds += 1
        self.batch.emit(now, Ev.SPAN_SHED, self.tenant_id(tenant), cls,
                        reason_code, self.member_id(member))

    def enqueue(self, now: int, rid: str, tenant: str, cls: int,
                member: str) -> None:
        sid = self.span_id(rid)
        if sid is None:
            return
        self.batch.emit(now, Ev.SPAN_ENQUEUE, sid,
                        self.tenant_id(tenant), cls,
                        self.member_id(member))

    def dispatch(self, now: int, rid: str, backend_slot: int,
                 qdelay_ns: int, deficit_x1000: int,
                 member: str) -> None:
        sid = self.span_id(rid)
        if sid is None:
            return
        self.batch.emit(now, Ev.SPAN_DISPATCH, sid,
                        backend_slot, qdelay_ns, deficit_x1000,
                        self.member_id(member))

    def exec(self, now: int, rid: str, backend_slot: int,
             member: str) -> None:
        sid = self.span_id(rid)
        if sid is None:
            return
        self.batch.emit(now, Ev.SPAN_EXEC, sid,
                        backend_slot, self.member_id(member))

    def complete(self, now: int, rid: str, backend_slot: int,
                 service_ns: int, latency_ns: int, member: str) -> None:
        sid = self.span_id(rid)
        if sid is None:
            return
        self.batch.emit(now, Ev.SPAN_COMPLETE, sid,
                        backend_slot, service_ns, latency_ns,
                        self.member_id(member))

    def requeue(self, now: int, rid: str, backend_slot: int,
                member: str) -> None:
        sid = self.span_id(rid)
        if sid is None:
            return
        self.batch.emit(now, Ev.SPAN_REQUEUE, sid,
                        backend_slot, self.member_id(member))

    def handoff(self, now: int, rid: str, from_member: str,
                to_member: str) -> None:
        sid = self.span_id(rid)
        if sid is None:
            return
        self.batch.emit(now, Ev.SPAN_HANDOFF, sid,
                        self.member_id(from_member),
                        self.member_id(to_member))

    def recover(self, now: int, rid: str, member: str,
                generation: int) -> None:
        """Crash-recovery stitch (docs/DURABILITY.md): emitted for
        every request the journal replay re-materialized, re-anchoring
        its chain in the recovery epoch ``generation`` at the member
        that now holds custody. Legal anywhere in a chain — including
        first, when the pre-crash span records died staged in the
        dead process's batch."""
        sid = self.span_id(rid)
        if sid is None:
            return
        self.batch.emit(now, Ev.SPAN_RECOVER, sid,
                        self.member_id(member), int(generation))

    def emit_event(self, now: int, ev: int, *args: int) -> None:
        """Non-span audit record sharing this recorder's ring (the
        autopilot decision events, class 0x09xx): rides the same
        EmitBatch, lands in emission order next to the chains it
        explains. The assembler ignores non-0x08xx classes, so chain
        validation is untouched."""
        self.batch.emit(now, ev, *args)

    def flush(self) -> None:
        self.batch.flush()

    def drain(self) -> np.ndarray:
        """All staged + ringed records, flushed first so a consumer
        never sees a partial stream."""
        self.flush()
        chunks = []
        while True:
            recs = self.ring.consume(4096)
            if not len(recs):
                break
            chunks.append(recs)
        if not chunks:
            return np.empty((0, TRACE_REC_WORDS), dtype="<u8")
        return np.concatenate(chunks, axis=0)

    # -- artifact export (pbst gateway demo --obs) -----------------------

    def export(self, obs_dir: str, run_meta: dict | None = None,
               tenants: dict[str, dict] | None = None,
               recs: np.ndarray | None = None) -> dict[str, str]:
        """Write the span artifacts ``pbst trace spans`` / ``pbst slo
        report`` read: ``spans.npy`` (drained records) + ``spans.json``
        (rid/member tables, per-tenant SLO info, run metadata)."""
        os.makedirs(obs_dir, exist_ok=True)
        recs = recs if recs is not None else self.drain()
        npy = os.path.join(obs_dir, "spans.npy")
        np.save(npy, recs)
        sidecar = {
            "version": 1,
            "rids": self.rid_table(),
            "members": self.member_table(),
            "tenant_table": self.tenant_table(),
            "tenants": tenants or {},
            "run": run_meta or {},
            "lost": int(self.ring.lost),
        }
        side = os.path.join(obs_dir, "spans.json")
        tmp = side + ".tmp"
        with open(tmp, "w") as f:
            json.dump(sidecar, f, indent=1, sort_keys=True)
        os.replace(tmp, side)
        return {"spans": npy, "sidecar": side}


# -- the consumer ------------------------------------------------------------

#: Per-event arg layout AFTER the span id (chain entries store
#: ``(ts, ev, *args_after_span)``): how many args are real (the ring
#: pads to 6) and which one is the member id (None = HANDOFF carries
#: from/to member pair instead).
SPAN_ARGS: dict[int, tuple[int, int | None]] = {
    int(Ev.SPAN_ADMIT): (4, 3),     # tenant, cls, cost, member
    int(Ev.SPAN_ENQUEUE): (3, 2),   # tenant, cls, member
    int(Ev.SPAN_DISPATCH): (4, 3),  # backend, qdelay, deficit, member
    int(Ev.SPAN_EXEC): (2, 1),      # backend, member
    int(Ev.SPAN_COMPLETE): (4, 3),  # backend, service, latency, member
    int(Ev.SPAN_REQUEUE): (2, 1),   # backend, member
    int(Ev.SPAN_HANDOFF): (2, None),  # from_member, to_member
    int(Ev.SPAN_RECOVER): (2, 0),   # member, generation
}

_SPAN_CLASS = 0x0800
_TERMINAL = frozenset({int(Ev.SPAN_COMPLETE)})
#: Events legal FROM each chain state; the assembler walks the machine
#: and any other (state, event) pair is a GAP — the chain invariant the
#: federation chaos harness gates on.
_QUEUED, _INFLIGHT, _DONE = 0, 1, 2
_NEXT_STATE = {
    (_QUEUED, int(Ev.SPAN_ENQUEUE)): _QUEUED,
    (_QUEUED, int(Ev.SPAN_DISPATCH)): _INFLIGHT,
    (_QUEUED, int(Ev.SPAN_HANDOFF)): _QUEUED,
    (_QUEUED, int(Ev.SPAN_REQUEUE)): _QUEUED,
    (_INFLIGHT, int(Ev.SPAN_EXEC)): _INFLIGHT,
    (_INFLIGHT, int(Ev.SPAN_COMPLETE)): _DONE,
    (_INFLIGHT, int(Ev.SPAN_REQUEUE)): _QUEUED,
    (_INFLIGHT, int(Ev.SPAN_HANDOFF)): _QUEUED,
}


class SpanAssembler:
    """Reconstructs rid-keyed timelines from drained trace records.

    Records MUST arrive in emission order (one shared recorder ring —
    the federation stitches by construction; ``merge_records`` streams
    from several rings would interleave same-timestamp events). Only
    0x08xx records are consumed; a mixed GW_*/SPAN_* stream is fine.
    """

    def __init__(self, recs: np.ndarray, rid_table: list[str],
                 member_table: list[str] | None = None,
                 tenant_table: list[str] | None = None):
        self.rids = list(rid_table)
        self.members = list(member_table or [])
        self.tenant_table = list(tenant_table or [])
        #: rid -> [(ts, ev, args...)] in emission order.
        self.chains: dict[str, list[tuple]] = {}
        self.shed_events = 0
        self.unknown_spans = 0
        for row in np.asarray(recs).tolist():
            ts, ev, a = row[0], row[1], row[2:]
            if (ev & 0xFF00) != _SPAN_CLASS:
                continue
            if ev == Ev.SPAN_SHED:
                self.shed_events += 1
                continue
            sid = a[0]
            if not 0 <= sid < len(self.rids):
                self.unknown_spans += 1
                continue
            self.chains.setdefault(self.rids[sid], []).append(
                (ts, ev, *a[1:]))

    # -- the gap-free chain invariant ------------------------------------

    def validate(self, admitted: list[str] | None = None,
                 require_complete: bool = True,
                 aborted: "set[str] | None" = None) -> list[str]:
        """Problems list (empty = every chain holds). ``admitted`` pins
        the expected universe: every admitted rid must HAVE a chain
        (a rid with no records at all is the worst gap), and every
        chain must start with SPAN_ADMIT, walk only legal transitions,
        and (``require_complete``) end in exactly one SPAN_COMPLETE.

        SPAN_RECOVER (docs/DURABILITY.md) is legal from ANY state —
        including as the chain's first record, and after a terminal
        SPAN_COMPLETE whose journal frame never committed — and resets
        the chain to QUEUED with the completion count cleared: the
        recovered request re-executes, and "exactly one complete"
        means one per final recovery epoch.

        ``aborted`` names rids whose admission was never durable (the
        crash harness's unacked suffix): their partial chains are
        excluded from the extras complaint instead of read as
        never-admitted records."""
        problems: list[str] = []
        universe = admitted if admitted is not None else sorted(self.chains)
        for rid in universe:
            chain = self.chains.get(rid)
            if not chain:
                problems.append(f"span {rid}: admitted but no records")
                continue
            ts0, ev0 = chain[0][0], chain[0][1]
            if ev0 not in (Ev.SPAN_ADMIT, Ev.SPAN_RECOVER):
                problems.append(
                    f"span {rid}: chain starts with "
                    f"{Ev(ev0).name}, not SPAN_ADMIT")
                continue
            state = _QUEUED
            completes = 0
            for ts, ev, *a in chain[1:]:
                if ev == Ev.SPAN_RECOVER:
                    # Crash-recovery re-anchor: every recovered
                    # request is requeued, and completes count from
                    # the epoch that finally delivered.
                    state = _QUEUED
                    completes = 0
                    continue
                if ev == Ev.SPAN_ADMIT:
                    problems.append(f"span {rid}: duplicate SPAN_ADMIT")
                    break
                if state == _DONE:
                    problems.append(
                        f"span {rid}: {Ev(ev).name} after terminal "
                        "SPAN_COMPLETE")
                    break
                nxt = _NEXT_STATE.get((state, int(ev)))
                if nxt is None:
                    problems.append(
                        f"span {rid}: gap — {Ev(ev).name} while "
                        f"{'queued' if state == _QUEUED else 'inflight'}")
                    break
                state = nxt
                if ev == Ev.SPAN_COMPLETE:
                    completes += 1
            else:
                if require_complete and completes != 1:
                    problems.append(
                        f"span {rid}: {completes} SPAN_COMPLETE "
                        "records (want exactly 1; chain reaches no "
                        "terminal state)" if completes == 0 else
                        f"span {rid}: {completes} SPAN_COMPLETE records")
        if admitted is not None:
            extras = set(self.chains) - set(admitted) - set(aborted or ())
            for rid in sorted(extras):
                problems.append(
                    f"span {rid}: records exist for a rid never "
                    "admitted")
        if self.unknown_spans:
            problems.append(
                f"{self.unknown_spans} span record(s) referenced ids "
                "outside the rid table")
        return problems

    # -- summaries -------------------------------------------------------

    def summary(self) -> dict:
        handoffs = sum(
            1 for chain in self.chains.values()
            for ts, ev, *a in chain if ev == Ev.SPAN_HANDOFF)
        recovers = sum(
            1 for chain in self.chains.values()
            for ts, ev, *a in chain if ev == Ev.SPAN_RECOVER)
        completes = sum(
            1 for chain in self.chains.values()
            if any(ev == Ev.SPAN_COMPLETE for _, ev, *a in chain))
        return {
            "chains": len(self.chains),
            "complete": completes,
            "handoff_events": handoffs,
            "recover_events": recovers,
            "shed_events": self.shed_events,
        }

    def latencies(self) -> dict[str, dict[str, int]]:
        """Per rid: e2e latency, queue wait (sum across dispatches of
        post-admit waits is overkill; the SLO view is admit->first
        dispatch), service (dispatch->complete), handoffs/requeues."""
        out: dict[str, dict[str, int]] = {}
        for rid, chain in self.chains.items():
            admit_ts = chain[0][0]
            first_dispatch = next(
                (ts for ts, ev, *a in chain if ev == Ev.SPAN_DISPATCH),
                None)
            complete = next(
                ((ts, a) for ts, ev, *a in chain
                 if ev == Ev.SPAN_COMPLETE), None)
            if complete is None:
                continue
            ts_done, args = complete
            out[rid] = {
                "e2e_ns": ts_done - admit_ts,
                "queue_ns": ((first_dispatch - admit_ts)
                             if first_dispatch is not None else 0),
                "service_ns": int(args[1]),
                "requeues": sum(1 for _, ev, *a in chain
                                if ev == Ev.SPAN_REQUEUE),
                "handoffs": sum(1 for _, ev, *a in chain
                                if ev == Ev.SPAN_HANDOFF),
            }
        return out

    # -- chrome trace (the SchedHistory.chrome_trace idiom) --------------

    def chrome_trace(self, pid: int = 0) -> dict:
        """Duration ('X') events per request: one ``queue`` slice from
        admit to each dispatch, one ``service`` slice from dispatch to
        complete, instant events for requeues/handoffs — tid is the
        span id so one request is one track, labelled
        ``tenant/rid`` via the sidecar tenant table."""
        events: list[dict] = []
        sid_of = {rid: i for i, rid in enumerate(self.rids)}
        for rid, chain in sorted(self.chains.items()):
            sid = sid_of.get(rid, 0)
            tslot = chain[0][2]  # admit args: tenant slot
            tenant = (self.tenant_table[tslot]
                      if 0 <= tslot < len(self.tenant_table)
                      else f"tenant{tslot}")
            label = f"{tenant}/{rid}"
            open_ts = chain[0][0]  # queue opens at admit
            for ts, ev, *a in chain:
                if ev == Ev.SPAN_DISPATCH:
                    events.append({
                        "name": f"{label} queue", "ph": "X",
                        "cat": "span.queue",
                        "ts": open_ts / 1e3,
                        "dur": max(ts - open_ts, 1) / 1e3,
                        "pid": pid, "tid": sid,
                        "args": {"qdelay_ns": a[1],
                                 "deficit_x1000": a[2]},
                    })
                    open_ts = ts  # service opens at dispatch
                elif ev in (Ev.SPAN_REQUEUE, Ev.SPAN_HANDOFF):
                    name = ("requeue" if ev == Ev.SPAN_REQUEUE
                            else "handoff")
                    events.append({
                        "name": f"{label} {name}", "ph": "i", "s": "t",
                        "cat": f"span.{name}", "ts": ts / 1e3,
                        "pid": pid, "tid": sid,
                        "args": {f"a{i}": v for i, v in enumerate(a)},
                    })
                    open_ts = ts  # back in a queue somewhere
                elif ev == Ev.SPAN_COMPLETE:
                    events.append({
                        "name": f"{label} service", "ph": "X",
                        "cat": "span.service",
                        "ts": open_ts / 1e3,
                        "dur": max(ts - open_ts, 1) / 1e3,
                        "pid": pid, "tid": sid,
                        "args": {"service_ns": a[1],
                                 "latency_ns": a[2]},
                    })
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    # -- the SLO view (pbst slo report) ----------------------------------

    def slo_report(self, tenants: dict[str, dict] | None = None,
                   run_meta: dict | None = None) -> dict:
        """Stable per-tenant SLO JSON. ``tenants`` maps tenant name ->
        {"slo": class, "slo_target_ns": int|None}; rid->tenant comes
        from the recorder sidecar when available, else from the chain's
        tenant slot (opaque int labels)."""
        tenants = tenants or {}
        lat = self.latencies()
        # rid -> tenant: the admit record carries the recorder-interned
        # tenant slot; the tenant table (sidecar) names it.
        per_tenant: dict[str, list[tuple[str, dict]]] = {}
        for rid, m in lat.items():
            slot = self.chains[rid][0][2]  # admit args: tenant slot
            t = (self.tenant_table[slot]
                 if 0 <= slot < len(self.tenant_table)
                 else f"tenant{slot}")
            per_tenant.setdefault(t, []).append((rid, m))
        report_tenants: dict[str, dict] = {}
        for t in sorted(per_tenant):
            rows = per_tenant[t]
            e2e = sorted(m["e2e_ns"] for _, m in rows)
            n = len(e2e)
            info = tenants.get(t, {})
            cls = info.get("slo", "batch")
            target = info.get("slo_target_ns") or \
                DEFAULT_SLO_TARGET_NS.get(cls, DEFAULT_SLO_TARGET_NS["batch"])
            over = sum(1 for v in e2e if v > target)
            budget = 1.0 - SLO_OBJECTIVE
            burn = (over / n) / budget if n else 0.0

            def _pct(q: float) -> float:
                k = max(1, int(np.ceil(q * n))) - 1 if n else 0
                return round(e2e[min(k, n - 1)] / 1e6, 3) if n else 0.0

            report_tenants[t] = {
                "slo": cls,
                "requests": n,
                "p50_ms": _pct(0.50),
                "p95_ms": _pct(0.95),
                "p99_ms": _pct(0.99),
                "target_ms": round(target / 1e6, 3),
                "over_target": over,
                "burn_rate": round(burn, 4),
                "handoffs": sum(m["handoffs"] for _, m in rows),
                "requeues": sum(m["requeues"] for _, m in rows),
            }
        return {
            "version": 1,
            "objective": SLO_OBJECTIVE,
            "run": run_meta or {},
            "spans": self.summary(),
            "tenants": report_tenants,
        }


def load_span_artifacts(obs_dir: str) -> tuple[np.ndarray, dict]:
    """The reader half of :meth:`SpanRecorder.export`."""
    recs = np.load(os.path.join(obs_dir, "spans.npy"))
    with open(os.path.join(obs_dir, "spans.json")) as f:
        sidecar = json.load(f)
    return recs, sidecar
