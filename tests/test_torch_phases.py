"""The port's phase spans (``pbs_tpu_torch.obs.phases``): the recorder's
pairing, nesting, self time, interning and lost count; a detached
recorder's silence; the spans the micro-step, the engine tick, the MoE
layer and the executor write, with what they compute unchanged by
recording them; and ``pbst-torch trace FILE --chrome OUT`` over a saved
stream."""

from __future__ import annotations

import gc
import json

import numpy as np
import pytest
import torch

from pbs_tpu_torch.obs import phases
from pbs_tpu_torch.obs.phases import Ph, PhaseRecorder

# The suite runs in parallel worker processes: uncapped, torch's intra-op
# pool takes every core in each of them and oversubscribes the host.
torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _nothing_attached():
    assert phases.attached() is None
    yield
    phases.detach()


def _recorded(fn, capacity=1 << 16):
    """Run ``fn`` with a recorder attached; (its result, the spans)."""
    rec = phases.attach(PhaseRecorder(capacity))
    try:
        out = fn()
    finally:
        phases.detach()
    return out, phases.pair(rec.drain(), rec.names), rec


def _names(spans, prefix=""):
    return [s.name for s in spans if s.name.startswith(prefix)]


# -- the recorder ------------------------------------------------------------


def test_pairs_nesting_and_self_time(monkeypatch):
    clock = iter(range(0, 10_000, 10))
    monkeypatch.setattr(phases, "_now", lambda: next(clock))

    def work():
        with phases.span("outer", owner=7, count=3) as sp:
            with phases.span("inner.a"):
                pass
            with phases.span("inner.b", count=5):
                with phases.span("leaf"):
                    pass
            sp.count = 9

    _, spans, rec = _recorded(work)
    assert [s.name for s in spans] == ["outer", "inner.a", "inner.b", "leaf"]
    outer, a, b, leaf = spans
    assert (outer.owner, outer.count) == (7, 9)  # the count at its end
    assert [s.depth for s in spans] == [0, 1, 1, 2]
    assert [s.parent for s in spans] == [-1, 0, 0, 2]
    assert (a.t0, a.t1) == (10, 20)
    assert (b.t0, leaf.t0, leaf.t1, b.t1) == (30, 40, 50, 60)
    assert outer.t1 - outer.t0 == 70
    # self time: the duration less the children's
    assert outer.self_ns == 70 - 10 - 30
    assert b.self_ns == 30 - 10 and leaf.self_ns == 10
    assert rec.lost == 0


def test_names_are_interned_once():
    def work():
        for _ in range(3):
            with phases.span("x"):
                with phases.span("y"):
                    pass

    _, spans, rec = _recorded(work)
    assert rec.names.count("x") == 1 and rec.names.count("y") == 1
    # the stall phases are interned first, at fixed ids
    assert rec.names[:2] == list(phases.STALL_PHASES)
    assert _names(spans) == ["x", "y"] * 3
    assert PhaseRecorder().ring.capacity == phases.WINDOW_RECORDS


def test_owner_defaults_to_the_dispatched_slot():
    def work():
        phases.own(4)
        with phases.span("a"):
            pass
        with phases.span("b", owner=11):
            pass

    _, spans, _ = _recorded(work)
    assert [s.owner for s in spans] == [4, 11]


def test_a_full_ring_counts_what_it_lost():
    def work():
        for _ in range(40):
            with phases.span("s"):
                pass

    _, spans, rec = _recorded(work, capacity=16)
    assert rec.lost == 80 - 16
    assert len(spans) == 8  # the closed pairs the ring kept


def test_a_span_drained_midway_is_left_out_of_both_halves():
    rec = phases.attach(PhaseRecorder(1 << 10))
    with phases.span("outer"):
        with phases.span("early"):
            pass
        first = phases.pair(rec.drain(), rec.names)
        with phases.span("late"):
            pass
    phases.detach()
    second = phases.pair(rec.drain(), rec.names)
    assert _names(first) == ["early"] and first[0].parent == -1
    assert _names(second) == ["late"] and second[0].parent == -1


def test_an_exception_closes_its_spans():
    def work():
        with phases.span("outer"):
            with pytest.raises(ValueError):
                with phases.span("inner"):
                    raise ValueError("boom")
            with phases.span("after"):
                pass

    _, spans, _ = _recorded(work)
    assert _names(spans) == ["outer", "inner", "after"]
    assert [s.parent for s in spans] == [-1, 0, 0]


def test_other_threads_are_not_recorded():
    import threading

    def other():
        with phases.span("elsewhere"):
            pass

    def work():
        with phases.span("here"):
            t = threading.Thread(target=other)
            t.start()
            t.join()

    _, spans, _ = _recorded(work)
    assert _names(spans) == ["here"]


def test_gc_pauses_over_the_stall_phases():
    def work():
        with phases.span("train.micro"):
            gc.collect()
        with phases.span("engine.tick"):
            pass
        with phases.span("train.feed"):  # no stall record
            pass

    _, spans, rec = _recorded(work)
    micro, tick, feed = spans
    assert micro.gc_runs >= 1 and micro.gc_pause_ns > 0
    assert tick.gc_runs == 0 and tick.gc_pause_ns == 0
    assert (feed.gc_pause_ns, feed.gc_runs) == (0, 0)
    assert rec._on_gc not in gc.callbacks


def test_detached_emits_nothing_and_reads_nothing():
    callbacks = list(gc.callbacks)
    rec = PhaseRecorder()
    with phases.span("train.micro") as sp:
        sp.count = 5
        with phases.span("engine.tick"):
            gc.collect()
    phases.own(3)
    assert gc.callbacks == callbacks
    assert len(rec.drain()) == 0
    assert phases.attached() is None


def test_attach_is_exclusive_and_detach_hands_back():
    rec = phases.attach()
    with pytest.raises(RuntimeError):
        phases.attach()
    assert phases.detach() is rec
    assert phases.detach() is None


def test_chrome_trace_a_track_per_phase(tmp_path):
    def work():
        with phases.span("engine.tick", count=2):
            with phases.span("engine.read", count=2):
                pass
        with phases.span("engine.tick", count=1):
            pass

    rec = phases.attach(PhaseRecorder(1 << 10))
    work()
    phases.detach()
    path = str(tmp_path / "phases.npy")
    rec.save(path)
    with open(phases.sidecar_path(path)) as f:
        side = json.load(f)
    assert side == {"names": rec.names, "lost": 0}
    doc = phases.chrome_trace(np.load(path), side["names"], pid=2)
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert [e["name"] for e in xs] == ["engine.tick", "engine.read",
                                       "engine.tick"]
    assert xs[0]["tid"] == xs[2]["tid"] != xs[1]["tid"]
    assert xs[1]["args"]["count"] == 2
    tracks = {e["args"]["name"] for e in doc["traceEvents"]
              if e["name"] == "thread_name"}
    assert tracks == {"engine.tick", "engine.read"}
    # phases keep the host's monotonic clock: their own process says so
    procs = [e for e in doc["traceEvents"] if e["name"] == "process_name"]
    assert [(e["pid"], e["args"]["name"]) for e in procs] == [
        (2, phases.PROCESS_NAME)]


def test_pbst_trace_chrome_draws_phases_beside_ring_records(tmp_path,
                                                            capsys):
    from pbs_tpu_torch.cli.pbst import main
    from pbs_tpu_torch.obs.trace import Ev

    rec = phases.attach(PhaseRecorder(1 << 10))
    with phases.span("exec.pick"):
        pass
    phases.detach()
    path = str(tmp_path / "mixed.npy")
    rec.save(path)
    recs = np.load(path)
    sched = np.zeros((1, 8), "<u8")
    sched[0, :4] = (int(recs[0, 0]), int(Ev.SCHED_WAKE), 3, 1)
    np.save(path, np.concatenate([sched, recs]))
    out = str(tmp_path / "mixed.json")
    assert main(["trace", path, "--chrome", out]) == 0
    with open(out) as f:
        evs = json.load(f)["traceEvents"]
    assert any(e["name"] == "SCHED_WAKE" for e in evs)
    assert [e["name"] for e in evs if e.get("cat") == "phase"] == [
        "exec.pick"]
    ring_pids = {e["pid"] for e in evs if e["name"] == "SCHED_WAKE"}
    phase_pids = {e["pid"] for e in evs if e.get("cat") == "phase"}
    assert ring_pids.isdisjoint(phase_pids)
    assert "wrote 3 records" in capsys.readouterr().out


def test_event_words_are_the_port_class_and_not_in_ev():
    from pbs_tpu_torch.obs.trace import Ev

    assert {int(e) >> 8 for e in Ph} == {phases.PHASE_CLASS}
    assert not {int(e) for e in Ph} & {int(e) for e in Ev}


# -- the micro-step ---------------------------------------------------------


def _micro(K=3):
    from pbs_tpu_torch.models import (TransformerConfig, init_params,
                                      make_micro_train_step)

    cfg = TransformerConfig(vocab=64, d_model=32, n_layers=2, n_heads=4,
                            n_kv_heads=2, d_ff=64, max_seq=32,
                            dtype=torch.float32)
    g = torch.Generator().manual_seed(0)
    rows = torch.randint(0, 64, (3 * K, 2, 17), generator=g)
    fed = []

    def next_batch(i):
        fed.append(i)
        return rows[len(fed) - 1]

    init, step = make_micro_train_step(cfg, K, learning_rate=1e-2,
                                       next_batch=next_batch)
    params = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    return init(params), step


def _run_micro(n):
    st, step = _micro()
    losses = []
    for _ in range(n):
        st, m = step(st)
        losses.append(m["loss"])
    return st, losses


def test_micro_step_phases_in_order():
    (st, _), spans, rec = _recorded(lambda: _run_micro(5))
    train = [s for s in spans if s.name.startswith("train.")]
    per_micro = ["train.micro", "train.feed", "train.forward",
                 "train.backward", "train.accumulate"]
    want = (per_micro * 3 + ["train.optimizer"]) + per_micro * 2
    assert [s.name for s in train] == want
    micro = [s for s in train if s.name == "train.micro"]
    assert all(s.count == 2 * 16 for s in micro)
    # every other phase lies inside its micro-step
    assert all(spans[s.parent].name == "train.micro"
               for s in train if s.name != "train.micro")
    opt = [s for s in train if s.name == "train.optimizer"]
    assert len(opt) == 1 and opt[0].count == 1
    assert st["step"] == 1 and rec.lost == 0


def test_micro_step_bitwise_the_same_attached_and_detached():
    st0, losses0 = _run_micro(4)
    (st1, losses1), _, _ = _recorded(lambda: _run_micro(4))
    assert [float(a) for a in losses0] == [float(b) for b in losses1]
    from pbs_tpu_torch.models.transformer import tree_leaves

    for key in ("params", "acc"):
        for a, b in zip(tree_leaves(st0[key]), tree_leaves(st1[key])):
            assert torch.equal(a, b)
    for a, b in zip(tree_leaves(st0["opt"]["mu"]),
                    tree_leaves(st1["opt"]["mu"])):
        assert torch.equal(a, b)


def test_backward_phase_holds_gradients_bitwise():
    from pbs_tpu_torch.models import TransformerConfig, init_params
    from pbs_tpu_torch.models.transformer import (loss_and_grads,
                                                  tree_leaves)

    cfg = TransformerConfig(vocab=64, d_model=32, n_layers=2, n_heads=4,
                            n_kv_heads=2, d_ff=64, max_seq=32,
                            dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    toks = torch.randint(0, 64, (2, 17),
                         generator=torch.Generator().manual_seed(3))
    l0, g0 = loss_and_grads(cfg, params, toks)
    (l1, g1), spans, _ = _recorded(
        lambda: loss_and_grads(cfg, params, toks))
    assert _names(spans) == ["train.forward", "train.backward"]
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b)
               for a, b in zip(tree_leaves(g0), tree_leaves(g1)))


# -- the engine tick and the MoE layer --------------------------------------


def _engine(moe: bool):
    from pbs_tpu_torch.models import (ContinuousBatcher, MoEConfig,
                                      TransformerConfig, init_moe_params,
                                      init_params)
    from pbs_tpu_torch.models.moe import moe_slot_mlp

    kw = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
              d_ff=64, max_seq=64, dtype=torch.float32)
    g = torch.Generator().manual_seed(5)
    if moe:
        cfg = MoEConfig(**kw, n_experts=4, top_k=2, dropless=True)
        params = init_moe_params(cfg, g, "cpu")
        mlp = moe_slot_mlp(cfg)
    else:
        cfg = TransformerConfig(**kw)
        params = init_params(cfg, g, "cpu")
        mlp = None
    return ContinuousBatcher(cfg, params, n_slots=2, prompt_bucket=8,
                             max_len=32, mlp_fn=mlp, device="cpu")


def _serve(moe: bool):
    eng = _engine(moe)
    rng = np.random.default_rng(7)
    for n, new in ((5, 4), (3, 6), (8, 2), (2, 5)):
        eng.submit(rng.integers(0, 64, n), new)
    out = {}
    while eng.has_work():
        for c in eng.step():
            out[c.request_id] = c.tokens
    return eng, out


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_engine_tick_phases(moe):
    _, gold = _serve(moe)
    (eng, out), spans, rec = _recorded(lambda: _serve(moe))
    assert out == gold  # the tokens, attached and detached
    ticks = [s for s in spans if s.name == "engine.tick"]
    assert len(ticks) == eng.steps
    prefills = [s for s in spans if s.name == "engine.prefill"]
    assert len(prefills) == eng.prefill_count == 4
    assert sorted(s.owner for s in prefills) == [0, 1, 2, 3]  # engine rids
    assert sorted(s.count for s in prefills) == [2, 3, 5, 8]
    assert all(spans[s.parent].name == "engine.admit" for s in prefills)
    reads = [s for s in spans if s.name == "engine.read"]
    # the first token of each request comes from its prefill
    decoded = sum(len(t) for t in out.values()) - len(out)
    assert sum(s.count for s in reads) == decoded == eng.tokens_emitted - 4
    for name in ("engine.admit", "engine.decode", "engine.read",
                 "engine.emit"):
        assert all(spans[s.parent].name == "engine.tick"
                   for s in spans if s.name == name)
    moe_spans = [s for s in spans if s.name.startswith("moe.")]
    if moe:
        # route, experts, combine in every layer of every forward: the
        # ticks' and the construction's warm-up (one prefill, one decode)
        ticked = [s for s in moe_spans if s.depth > 0]
        assert len(ticked) == 3 * 2 * (len(reads) + len(prefills))
        assert len(moe_spans) - len(ticked) == 3 * 2 * 2
        assert _names(moe_spans)[:3] == ["moe.route", "moe.experts",
                                         "moe.combine"]
    else:
        assert not moe_spans
    assert rec.lost == 0


def test_speculative_engine_ticks_are_spans():
    from pbs_tpu_torch.models import SpeculativeBatcher, TransformerConfig
    from pbs_tpu_torch.models import init_params

    kw = dict(vocab=64, n_heads=4, n_kv_heads=2, max_seq=64,
              dtype=torch.float32)
    cfg = TransformerConfig(d_model=32, n_layers=2, d_ff=64, **kw)
    dcfg = TransformerConfig(d_model=16, n_layers=1, d_ff=32, **kw)
    params = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    dparams = init_params(dcfg, torch.Generator().manual_seed(2), "cpu")

    def serve():
        eng = SpeculativeBatcher(cfg, params, dcfg, dparams, k=2,
                                 n_slots=2, prompt_bucket=8, max_len=32,
                                 device="cpu")
        eng.submit(np.arange(5) % 64, 6)
        while eng.has_work():
            eng.step()
        return eng

    eng, spans, _ = _recorded(serve)
    assert len([s for s in spans if s.name == "engine.tick"]) == eng.steps


# -- the executor and the backend ---------------------------------------------


def test_executor_and_backend_phases():
    from pbs_tpu_torch.runtime import Job, Partition
    from pbs_tpu_torch.telemetry import CudaBackend

    def run():
        be = CudaBackend(device="cpu")
        be._sync = lambda: None  # the card's closing synchronise
        part = Partition("p", source=be, scheduler="credit")
        fired = []
        part.timers.arm(0, fired.append, name="t")
        job = part.add_job(Job("j", step_fn=lambda s: s + 1, state=0,
                               max_steps=3))
        part.run(max_rounds=20)
        return part, job, fired

    (part, job, fired), spans, _ = _recorded(run)
    names = set(_names(spans))
    assert {"exec.timers", "exec.pick", "exec.account"} <= names
    syncs = [s for s in spans if s.name == "backend.sync"]
    assert len(syncs) == 3  # one an invocation
    slot = job.contexts[0].ledger_slot
    assert all(s.owner == slot for s in spans if s.name == "exec.account")
    assert sum(s.count for s in spans if s.name == "exec.timers") \
        == len(fired) == 1
    # the ring the partition keeps holds none of the phase class
    for ring in part.traces:
        recs = ring.peek(1 << 12)
        assert not ((recs[:, 1] >> 8) == phases.PHASE_CLASS).any()
