"""``pbs_tpu_torch.obs`` against ``pbs_tpu.obs``: trace rings, request
spans and latency histograms, word for word.

Both packages load their native C tier when it builds, and their
records are byte-identical to their Python paths, so every ring and
histogram here is compared against the reference both as it runs
(``native=None``) and pinned to Python (``native=False``); the tiers
against each other are ``tests/test_torch_native.py``.
"""

from __future__ import annotations

import numpy as np
import pytest

from pbs_tpu.obs import spans as ref_spans
from pbs_tpu.obs import trace as ref_trace
from pbs_tpu_torch.obs import spans as port_spans
from pbs_tpu_torch.obs import trace as port_trace

NATIVE = [None, False]
CLASSES = ("interactive", "batch")
STAGES = port_spans.SPAN_STAGES


def _latencies(seed: int, n: int = 400) -> list[int]:
    """Seeded latencies from ~1 us to ~10 s, plus the edges."""
    rng = np.random.default_rng(seed)
    vals = (10 ** rng.uniform(3, 10, n)).astype(np.int64).tolist()
    return vals + [0, -5, 1, 8_191, 8_192, 2**40]


# -- histograms ---------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hist_bucket_and_edges_match(seed):
    assert port_spans.HIST_BUCKETS == ref_spans.HIST_BUCKETS
    assert port_spans.HIST_SHIFT == ref_spans.HIST_SHIFT
    assert np.array_equal(port_spans.bucket_edges(), ref_spans.bucket_edges())
    vals = _latencies(seed)
    assert ([port_spans.hist_bucket(v) for v in vals]
            == [ref_spans.hist_bucket(v) for v in vals])


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("q", [0.50, 0.95, 0.99])
def test_hist_quantile_matches(seed, q):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 50, port_spans.HIST_BUCKETS).astype("<u8")
    counts[rng.integers(0, port_spans.HIST_BUCKETS, 5)] = 0
    assert (port_spans.hist_quantile(counts, q)
            == ref_spans.hist_quantile(counts, q))
    empty = np.zeros(port_spans.HIST_BUCKETS, "<u8")
    assert port_spans.hist_quantile(empty, q) == 0


def _fill(hist, seed: int, tenants: int = 5) -> None:
    rng = np.random.default_rng(seed)
    for v in _latencies(seed, 300):
        who = (f"t{int(rng.integers(0, tenants))}" if rng.random() < 0.8
               else f"be:b{int(rng.integers(0, 2))}")
        hist.record(who, CLASSES[int(rng.integers(0, 2))],
                    STAGES[int(rng.integers(0, 3))], v)


def _hist_view(hist) -> dict:
    out = {"keys": hist.keys(),
           "bytes": bytes(hist.ledger.raw())}
    for cls in CLASSES:
        for st in STAGES:
            out[cls, st] = (hist.class_counts(cls, st).tolist(),
                            [hist.class_quantile(cls, st, q)
                             for q in (0.5, 0.95, 0.99)])
    for who, cls, st in hist.keys():
        out[who, cls, st] = (hist.quantile(who, cls, st, 0.99),
                             hist.over_target(who, cls, st, 50_000_000))
    return out


@pytest.mark.parametrize("native", NATIVE)
@pytest.mark.parametrize("num_slots", [256, 6])
def test_latency_histograms_record_aggregate_and_fold(native, num_slots):
    """Records, class aggregates, quantiles and ledger bytes; at 6
    slots most keys fold into a same-class row or the overflow row."""
    port = port_spans.LatencyHistograms(num_slots=num_slots)
    ref = ref_spans.LatencyHistograms(num_slots=num_slots, native=native)
    _fill(port, 0)
    _fill(ref, 0)
    assert _hist_view(port) == _hist_view(ref)
    if num_slots == 6:
        assert port._slots[("t4", "batch", "e2e")] in range(6)
        assert len(set(port._slots.values())) == 6


@pytest.mark.parametrize("native", NATIVE)
def test_record_many_and_hist_batch_match_scalar_records(native):
    port = port_spans.LatencyHistograms(num_slots=32)
    ref = ref_spans.LatencyHistograms(num_slots=32, native=native)
    vals = [v for v in _latencies(1, 100) if v >= 0]
    for hist in (port, ref):
        slots = [hist.slot_of(f"t{i % 3}", "batch", "queue")
                 for i in range(len(vals))]
        hist.record_many(np.array(slots), np.array(vals, dtype="<u8"))
        batch = (port_spans.HistBatch if hist is port
                 else ref_spans.HistBatch)(hist, capacity=7)
        for i, v in enumerate(vals):
            batch.record(f"t{i % 2}", "interactive", "e2e", v)
        batch.flush()
        assert batch.recorded == len(vals)
        with pytest.raises(IndexError):
            hist.record_many(np.array([99]), np.array([1], dtype="<u8"))
    assert _hist_view(port) == _hist_view(ref)


def test_file_backed_histograms_and_attach(tmp_path):
    paths = {}
    for name, mod in (("port", port_spans), ("ref", ref_spans)):
        p = str(tmp_path / f"{name}.hist")
        hist = mod.LatencyHistograms(num_slots=64, path=p)
        _fill(hist, 2, tenants=3)
        paths[name] = p
        mon = mod.LatencyHistograms.attach(p)
        assert mon.keys() == hist.keys()
        assert all(np.array_equal(mon.counts(*k), hist.counts(*k))
                   for k in hist.keys())
    for suffix in ("", ".meta.json"):
        assert (open(paths["port"] + suffix, "rb").read()
                == open(paths["ref"] + suffix, "rb").read())


def test_native_tiers_are_refused(monkeypatch):
    """``native=True`` is refused, naming the cached reason, when the
    library cannot load; ``native=None`` then degrades to the Python
    tier, as the reference's does."""
    from pbs_tpu_torch.runtime import native as port_native

    monkeypatch.setattr(port_native, "load", lambda: None)
    monkeypatch.setattr(port_native, "_lib", None)
    monkeypatch.setattr(port_native, "_fail_reason", "g++ exited 1: boom")
    with pytest.raises(RuntimeError, match="exited 1: boom"):
        port_trace.TraceBuffer(8, native=True)
    with pytest.raises(RuntimeError, match="exited 1: boom"):
        port_spans.LatencyHistograms(native=True)
    assert port_trace.TraceBuffer(8).tier == "python"
    assert port_spans.LatencyHistograms().ledger.tier == "python"


# -- trace rings --------------------------------------------------------


def _emit_script(ring, batch_cls, seed: int) -> list:
    """Scalar and batched emits with wraps, drops, masking and short
    records; returns what the consumer side saw along the way."""
    rng = np.random.default_rng(seed)
    seen = []
    batch = batch_cls(ring, capacity=5, flush_ns=40)
    for i in range(120):
        n = int(rng.integers(0, 8))
        args = [int(a) for a in rng.integers(0, 2**62, n)]
        if rng.random() < 0.1:
            args = [-1, -(2**40)] + args[:4]  # two's-complement masking
        ts = i * 7
        if rng.random() < 0.5:
            seen.append(("emit", ring.emit(ts, int(port_trace.Ev.GW_ADMIT),
                                           *args)))
        else:
            batch.emit(ts, int(port_trace.Ev.SPAN_EXEC), *args)
        if i % 9 == 0:
            recs = np.zeros((int(rng.integers(0, 6)), 8), "<u8")
            recs[:, 0] = ts
            recs[:, 1:] = rng.integers(0, 2**60, (len(recs), 7))
            seen.append(("many", ring.emit_many(recs)))
        if i % 13 == 0:
            seen.append(("peek", ring.peek(4).tolist()))
        if i % 17 == 0:
            seen.append(("consume", ring.consume(int(rng.integers(1, 20)))
                         .tolist()))
    seen.append(("flush", batch.flush(), batch.emitted, batch.flushes))
    seen.append(("lost", ring.lost))
    seen.append(("ring", bytes(ring._arr)))
    return seen


@pytest.mark.parametrize("native", NATIVE)
@pytest.mark.parametrize("seed", [0, 1])
def test_trace_buffer_and_emit_batch_word_for_word(native, seed):
    port = _emit_script(port_trace.TraceBuffer(16), port_trace.EmitBatch,
                        seed)
    ref = _emit_script(ref_trace.TraceBuffer(16, native=native),
                       ref_trace.EmitBatch, seed)
    assert port == ref


def test_file_backed_ring_attach(tmp_path):
    p = str(tmp_path / "ring")
    prod = port_trace.TraceBuffer.file_backed(p, capacity=8)
    for i in range(5):
        prod.emit(i, int(port_trace.Ev.GW_SHED), i, 2)
    cons = ref_trace.TraceBuffer.file_backed(p, attach=True, native=False)
    assert cons.consume(3).tolist() == [
        [i, int(ref_trace.Ev.GW_SHED), i, 2, 0, 0, 0, 0] for i in range(3)]
    assert prod.consume().tolist()[0][0] == 3  # the tail word is shared


def test_taxonomy_and_formatting_match():
    assert ({e.name: int(e) for e in port_trace.Ev}
            == {e.name: int(e) for e in ref_trace.Ev})
    rng = np.random.default_rng(3)
    evs = [int(e) for e in port_trace.Ev] + [0x7777]
    chunks = []
    for _ in range(3):
        recs = np.zeros((20, 8), "<u8")
        recs[:, 0] = np.sort(rng.integers(0, 10**6, 20))
        recs[:, 1] = rng.choice(evs, 20)
        recs[:, 2] = rng.integers(0, 4, 20)
        recs[:, 3:] = rng.integers(0, 10**5, (20, 5))
        chunks.append(recs)
    merged = port_trace.merge_records(chunks)
    assert np.array_equal(merged, ref_trace.merge_records(chunks))
    assert (port_trace.format_records(merged)
            == ref_trace.format_records(merged))
    labels = {0: "serve", 2: "mm"}
    assert (port_trace.chrome_trace(merged, labels, pid=3)
            == ref_trace.chrome_trace(merged, labels, pid=3))


@pytest.mark.parametrize("native", NATIVE)
def test_tbuf_size_param_resolves_like_the_reference(monkeypatch, tmp_path,
                                                     native):
    """An unsized ring gets the ``tbuf_size`` boot param, declared in the
    port's registry with the reference's name and default."""
    monkeypatch.delenv("PBST_TBUF_SIZE", raising=False)
    from pbs_tpu_torch.utils import params as port_params

    assert port_params.get("tbuf_size") is port_trace._tbuf_size
    assert port_trace._tbuf_size.default == ref_trace._tbuf_size.default
    assert port_trace._tbuf_size.value == ref_trace._tbuf_size.value
    assert (port_trace.TraceBuffer(native=native).capacity
            == ref_trace.TraceBuffer(native=native).capacity)
    rings = [mod.TraceBuffer.file_backed(str(tmp_path / name), native=native)
             for name, mod in (("port", port_trace), ("ref", ref_trace))]
    assert rings[0].capacity == rings[1].capacity == \
        port_trace._tbuf_size.value


# -- the span chain -----------------------------------------------------


def _happy_chain(rec, rid: str, t0: int = 0) -> None:
    rec.admit(t0, rid, "chat", 0, 1, "gw")
    rec.enqueue(t0, rid, "chat", 0, "gw")
    rec.dispatch(t0 + 5, rid, 0, 5, 1000, "gw")
    rec.exec(t0 + 6, rid, 0, "gw")
    rec.complete(t0 + 20, rid, 0, 14, 20, "gw")


def _stream_happy(rec) -> list:
    _happy_chain(rec, "gw-0")
    _happy_chain(rec, "gw-1", t0=7)
    return ["gw-0", "gw-1"]


def _stream_gaps(rec) -> list:
    """Every gap class of the chain invariant."""
    rec.admit(0, "r1", "t", 0, 1, "gw")  # complete while queued
    rec.enqueue(0, "r1", "t", 0, "gw")
    rec.complete(9, "r1", 0, 5, 9, "gw")
    rec.dispatch(1, "r2", 0, 1, 0, "gw")  # starts mid-chain
    rec.complete(2, "r2", 0, 1, 2, "gw")
    rec.admit(0, "r3", "t", 0, 1, "gw")  # never terminates
    rec.enqueue(0, "r3", "t", 0, "gw")
    rec.dispatch(1, "r3", 0, 1, 0, "gw")
    _happy_chain(rec, "r4")  # event after the terminal
    rec.requeue(30, "r4", 0, "gw")
    rec.admit(0, "r5", "t", 0, 1, "gw")  # duplicate admit
    rec.admit(1, "r5", "t", 0, 1, "gw")
    rec.admit(0, "r7", "t", 1, 3, "gw")  # never admitted below
    return ["r1", "r2", "r3", "r4", "r5", "r6"]


def _stream_requeue(rec) -> list:
    rec.admit(0, "x", "t", 0, 1, "gw0")
    rec.enqueue(0, "x", "t", 0, "gw0")
    rec.dispatch(2, "x", 0, 2, 0, "gw0")
    rec.handoff(3, "x", "gw0", "gw1")
    rec.requeue(3, "x", 0, "gw1")
    rec.dispatch(5, "x", 1, 5, 0, "gw1")
    rec.exec(5, "x", 1, "gw1")
    rec.complete(9, "x", 1, 4, 9, "gw1")
    rec.recover(10, "x", "gw1", 1)
    rec.dispatch(11, "x", 1, 1, 0, "gw1")
    rec.complete(12, "x", 1, 1, 12, "gw1")
    rec.shed(4, "t", 1, 2, "gw0")
    rec.emit_event(5, int(port_trace.Ev.AP_CANARY), 2, 100)
    return ["x"]


def _spans_view(rec, stream) -> dict:
    admitted = stream(rec)
    recs = rec.drain()
    asm = type(rec).__module__  # the package under test
    mod = port_spans if asm.startswith("pbs_tpu_torch") else ref_spans
    a = mod.SpanAssembler(recs, rec.rid_table(), rec.member_table(),
                          rec.tenant_table())
    tenants = {"chat": {"slo": "interactive"},
               "t": {"slo": "batch", "slo_target_ns": 8}}
    return {
        "words": recs.tolist(),
        "tables": (rec.rid_table(), rec.member_table(), rec.tenant_table()),
        "validate": a.validate(admitted),
        "validate_open": a.validate(None, require_complete=False),
        "summary": a.summary(),
        "latencies": a.latencies(),
        "chrome": a.chrome_trace(pid=1),
        "slo": a.slo_report(tenants, {"seed": 0}),
        "counts": (rec.spans_started, rec.sheds, rec.dropped_spans),
    }


@pytest.mark.parametrize("stream", [_stream_happy, _stream_gaps,
                                    _stream_requeue],
                         ids=["happy", "gaps", "requeue"])
def test_span_assembler_verdicts_match(stream):
    port = _spans_view(port_spans.SpanRecorder(capacity=256), stream)
    ref = _spans_view(ref_spans.SpanRecorder(
        ring=ref_trace.TraceBuffer(256, native=False)), stream)
    assert port == ref
    if stream is _stream_happy:
        assert port["validate"] == []
    if stream is _stream_gaps:
        text = "\n".join(port["validate"])
        for want in ("r1: gap — SPAN_COMPLETE while queued",
                     "r2: chain starts with SPAN_DISPATCH",
                     "r3: 0 SPAN_COMPLETE", "r4: SPAN_REQUEUE after terminal",
                     "r5: duplicate SPAN_ADMIT", "r6: admitted but no records",
                     "r7: records exist for a rid never admitted"):
            assert want in text


def test_span_table_bound_and_artifacts(tmp_path):
    views = []
    for mod in (port_spans, ref_spans):
        rec = mod.SpanRecorder(capacity=64, max_spans=2)
        for i in range(3):
            _happy_chain(rec, f"r{i}", t0=i)
        out = rec.export(str(tmp_path / mod.__name__), run_meta={"n": 3},
                         tenants={"chat": {"slo": "interactive"}})
        recs, side = mod.load_span_artifacts(str(tmp_path / mod.__name__))
        views.append((recs.tolist(), side, rec.dropped_spans,
                      open(out["sidecar"]).read()))
    assert views[0] == views[1]
    assert views[0][2] == 5  # r2's five events found the table full
