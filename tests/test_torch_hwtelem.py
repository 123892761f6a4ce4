"""The port's hardware-counter plane against ``pbs_tpu.hwtelem``.

Every case of ``tests/test_hwtelem.py`` is written as a function of a
package namespace (its ``FakeTier`` subclasses each package's own
``CounterTier``) and runs on both packages with equal observables. Then
direct cross-package checks: the copied windows are the reference's
bytes with its pinned digests; ``fidelity_report`` gives equal bytes for
``w0`` and ``w1``; ``record_serving_window`` under a scripted tier
records the same window; ``HwCounterSource`` over ``SimBackend`` steers
a partition the same; ``FeedbackPolicy.from_source`` refuses the same
strangers; and the ``pbst-torch hw`` JSON equals the reference's. The
live-ladder cases are ``slow``, as the reference's are.
"""

from __future__ import annotations

import importlib
import json
import os
import types

import numpy as np
import pytest

pytest.importorskip("jax", reason="parity tests need the JAX reference")

MS = 1_000_000


def _ns(root: str) -> types.SimpleNamespace:
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    P = types.SimpleNamespace(
        root=root, hw=mod("hwtelem"), sources=mod("hwtelem.sources"),
        window=mod("hwtelem.window"), fidelity=mod("hwtelem.fidelity"),
        rt=mod("runtime"), tel=mod("telemetry"),
        feedback=mod("sched.feedback"), clock=mod("utils.clock"),
        trace=mod("sim.trace"), cli=mod("cli.pbst"))
    P.windows = os.path.join(os.path.dirname(P.hw.__file__), "windows")
    P.W0 = os.path.join(P.windows, "w0.jsonl")
    P.W1 = os.path.join(P.windows, "w1.jsonl")
    P.FakeTier = _fake_tier(P.sources)
    return P


def _fake_tier(sources):
    class FakeTier(sources.CounterTier):
        """Forced-tier fake: scripted cumulative readings, no kernel."""

        name = "fake"

        def __init__(self, readings, events=None):
            super().__init__()
            self._readings = [dict(r) for r in readings]
            self._i = 0
            self._reason = None
            self._events = tuple(
                events if events is not None else self._readings[0])
            for ev in sources.DECLARED_EVENTS:
                if ev not in self._events:
                    self._event_reasons[ev] = "not scripted"

        def read(self):
            r = self._readings[min(self._i, len(self._readings) - 1)]
            self._i += 1
            return dict(r)

    return FakeTier


REF = _ns("pbs_tpu")
PORT = _ns("pbs_tpu_torch")

#: The checked-in windows' canonical digests, as the reference pins them.
W0_DIGEST = "99518aa45c49958bd6c8093479792879555df46b7bda65e096f4ab37b18fc9c0"
W1_DIGEST = "2fa4616742e5514cb7459c669815f9b44d166701ca4aacee436a1828753fdc7f"


def _canon(obj) -> str:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"),
                      default=str)


def _twin(case, tmp_path, capsys=None, monkeypatch=None):
    out = {}
    for tag, P in (("ref", REF), ("port", PORT)):
        d = tmp_path / tag
        d.mkdir()
        kw = {}
        if capsys is not None:
            kw["capsys"] = capsys
        if monkeypatch is not None:
            kw["monkeypatch"] = monkeypatch
        got = case(P, d, **kw)
        # Paths and the program's name are the only words that differ.
        out[tag] = _canon(got).replace(str(d), "<tmp>").replace(
            P.windows, "<windows>").replace("pbst-torch", "pbst")
    assert out["port"] == out["ref"]


def _slot(P, name):
    return int(getattr(P.tel.Counter, name))


# -- twins of tests/test_hwtelem.py -----------------------------------------


def h_event_mapping_full(P, d):
    out = P.sources.event_deltas_to_counters(
        {"task-clock": 1000, "cache-references": 10,
         "cache-misses": 4, "instructions": 77}, n_steps=3)
    assert out.dtype == np.uint64
    assert out.shape == (P.tel.counters.NUM_COUNTERS,)
    assert out[_slot(P, "STEPS_RETIRED")] == 3
    assert out[_slot(P, "DEVICE_TIME_NS")] == 1000
    assert out[_slot(P, "HBM_BYTES")] == 10 * P.sources.CACHE_LINE_BYTES
    assert out[_slot(P, "HBM_STALL_NS")] == 1000 * 4 // 10
    assert out[_slot(P, "DEVICE_FLOPS")] == 77
    return out.tolist()


def h_event_mapping_absent_events_stay_zero(P, d):
    out = P.sources.event_deltas_to_counters({}, n_steps=5)
    assert out[_slot(P, "STEPS_RETIRED")] == 5
    assert int(out.sum()) == 5
    return out.tolist()


def h_fake_tier_sampling_deltas(P, d):
    src = P.sources.HwCounterSource(
        tier=P.FakeTier([{"task-clock": 100}, {"task-clock": 340},
                         {"task-clock": 250}]),
        clock=P.clock.VirtualClock())
    assert src.sample() == {"task-clock": 240}
    assert src.sample() == {"task-clock": 0}
    return src.describe()


def h_overlay_writes_only_supplied_slots(P, d):
    src = P.sources.HwCounterSource(
        tier=P.FakeTier([{"task-clock": 0}, {"task-clock": 900}]),
        clock=P.clock.VirtualClock())
    out = src.execute(None, n_steps=4)
    assert out[_slot(P, "STEPS_RETIRED")] == 4
    assert out[_slot(P, "DEVICE_TIME_NS")] == 900
    assert out[_slot(P, "HBM_BYTES")] == 0
    assert out[_slot(P, "DEVICE_FLOPS")] == 0
    desc = src.describe()
    assert desc["tier"] == "fake" and desc["events"] == ["task-clock"]
    return [out.tolist(), desc]


def h_disable_all_is_byte_invisible(P, d, monkeypatch):
    monkeypatch.setenv(P.sources.DISABLE_ENV, "all")
    reasons = []
    for tier in P.sources.ladder():
        assert tier.unavailable_reason() is not None
        assert P.sources.DISABLE_ENV in tier.unavailable_reason()
        assert tier.events() == ()
        reasons.append(tier.describe())
    assert P.sources.pick_tier() is None

    class Inner:
        clock = P.clock.VirtualClock()

        def execute(self, ctx, n_steps):
            arr = np.arange(P.tel.counters.NUM_COUNTERS, dtype=np.uint64)
            arr[_slot(P, "STEPS_RETIRED")] = n_steps
            self.last = arr
            return arr

    inner = Inner()
    src = P.sources.HwCounterSource(inner=inner, probe=True)
    assert src.tier is None
    assert src.sample() == {}
    out = src.execute(None, n_steps=2)
    assert out is inner.last
    assert src.describe() == {"tier": None, "events": [],
                              "reason": "no counter tier available"}
    monkeypatch.delenv(P.sources.DISABLE_ENV)
    return [reasons, P.sources.probe_report(P.sources.ladder()
                                            )["declared_events"]]


def h_disable_single_tier(P, d, monkeypatch):
    monkeypatch.setenv(P.sources.DISABLE_ENV, "perf_event")
    tiers = P.sources.ladder()
    assert tiers[0].unavailable_reason() is not None
    active = P.sources.pick_tier(tiers)
    if active is not None:
        assert active.name in ("cgroup", "rusage")
    monkeypatch.delenv(P.sources.DISABLE_ENV)
    return [tiers[0].describe(), active and active.name]


def h_probe_report_shape(P, d):
    rep = P.sources.probe_report()
    assert rep["version"] == 1
    assert rep["declared_events"] == list(P.sources.DECLARED_EVENTS)
    assert [t["tier"] for t in rep["tiers"]] == list(P.sources.TIER_NAMES)
    for t in rep["tiers"]:
        assert t["available"] == (t["reason"] is None)
    assert rep["active"] is None or rep["active"] in P.sources.TIER_NAMES
    return [rep["version"], rep["declared_events"],
            [t["tier"] for t in rep["tiers"]]]


def _toy_window(P):
    rec = P.window.HwRecorder(events=("task-clock", "instructions"),
                              capacity=8, tier="fake", period_ns=1000)
    for i in range(5):
        rec.sample(10_000 + i * 1000,
                   {"task-clock": 900 + i, "instructions": 40 * i})
    return rec.window()


def h_recorder_ring_wrap_and_dropped(P, d):
    rec = P.window.HwRecorder(events=("task-clock",), capacity=4,
                              tier="fake", period_ns=1000)
    for i in range(6):
        rec.sample(i * 1000, {"task-clock": i})
    assert rec.recorded == 6 and rec.dropped == 2
    w = rec.window()
    assert w.dropped == 2 and len(w.samples) == 4
    assert w.t0_ns == 2000
    assert [x[0] for _, x in w.samples] == [2, 3, 4, 5]
    assert [t for t, _ in w.samples] == [0, 1000, 2000, 3000]
    return w.lines()


def h_window_save_load_digest_roundtrip(P, d):
    w = _toy_window(P)
    p = str(d / "w.jsonl")
    w.save(p)
    w2 = P.window.CounterWindow.load(p)
    assert w2 == w
    assert w2.digest() == w.digest()
    assert w.totals()["task-clock"] == sum(900 + i for i in range(5))
    assert w.span_ns() == w.t1_ns - w.t0_ns > 0
    return [w.digest(), open(p).read()]


def h_window_load_rejects_width_mismatch(P, d):
    p = d / "bad.jsonl"
    lines = P.window.CounterWindow.load(P.W0).lines()
    lines.append('{"d":[1],"kind":"sample","t":99}')
    p.write_text("\n".join(lines) + "\n")
    with pytest.raises(ValueError, match="sample width") as e:
        P.window.CounterWindow.load(str(p))
    return str(e.value)


def h_checked_in_window_digests_pinned(P, d):
    w0 = P.window.CounterWindow.load(P.W0)
    w1 = P.window.CounterWindow.load(P.W1)
    assert w0.digest() == W0_DIGEST
    assert w1.digest() == W1_DIGEST
    for path, w in ((P.W0, w0), (P.W1, w1)):
        with open(path, "rb") as f:
            assert f.read() == ("\n".join(w.lines()) + "\n").encode()
        assert w.events == P.sources.DECLARED_EVENTS
        assert len(w.samples) > 0
    return [w0.totals(), w1.totals()]


def h_replay_byte_identical_twice(P, d):
    w = P.window.CounterWindow.load(P.W0)
    n = 2 * len(w.samples)
    a, b = P.window.ReplaySource(w), P.window.ReplaySource(w)
    assert a.stream_digest(n) == b.stream_digest(n)
    c = P.window.ReplaySource(w)
    c.execute(None, n_steps=1)
    pos, now = c.position, c.clock.now_ns()
    assert c.stream_digest(n) == a.stream_digest(n)
    assert c.position == pos and c.clock.now_ns() == now
    return a.stream_digest(n)


def h_replay_cycles_and_advances_clock(P, d):
    w = _toy_window(P)
    rs = P.window.ReplaySource(w)
    t_prev = rs.clock.now_ns()
    outs = []
    for _ in range(2 * len(w.samples)):
        out = rs.execute(None, n_steps=3)
        assert out[_slot(P, "STEPS_RETIRED")] == 3
        assert rs.clock.now_ns() > t_prev
        t_prev = rs.clock.now_ns()
        outs.append(out.tolist())
    assert rs.position == 2 * len(w.samples)
    rs.reset()
    assert rs.position == 0
    return [outs, t_prev]


def h_replay_empty_window_raises(P, d):
    empty = P.window.CounterWindow(t0_ns=0, t1_ns=0, tier="fake",
                                   events=("task-clock",), samples=(),
                                   period_ns=1000)
    with pytest.raises(ValueError, match="empty") as e:
        P.window.ReplaySource(empty)
    return str(e.value)


def h_feedback_from_source_validates_identity(P, d):
    w = P.window.CounterWindow.load(P.W1)
    src = P.window.ReplaySource(w)
    part = P.rt.Partition("hwtest", source=src, scheduler="credit")
    part.add_job(P.rt.Job("j0", max_steps=1 << 20))
    stranger = P.window.ReplaySource(w)
    with pytest.raises(ValueError) as e:
        P.feedback.FeedbackPolicy.from_source(part, stranger)
    policy = P.feedback.FeedbackPolicy.from_source(part, src)
    try:
        assert policy.hw_source is src
        assert policy.stale_after == 3
    finally:
        policy.timer.stop()
    return str(e.value)


def h_fidelity_report_reproducible(P, d):
    w = P.window.CounterWindow.load(P.W0)
    r1 = P.fidelity.fidelity_report(w, seed=0)
    r2 = P.fidelity.fidelity_report(w, seed=0)
    assert r1 == r2
    assert r1["v"] == 1
    assert r1["window"]["digest"] == W0_DIGEST
    assert 0 <= r1["fidelity_x1e6"] <= 1_000_000
    assert isinstance(r1["margin_x1e6"], int)
    for ax in r1["axes"].values():
        for k in ("predicted_x1e6", "measured_x1e6", "rel_err_x1e6"):
            if k in ax:
                assert isinstance(ax[k], int)
    return r1


def h_cli_hw_probe_json(P, d, capsys):
    rc = P.cli.main(["hw", "probe", "--json"])
    rep = json.loads(capsys.readouterr().out)
    assert [t["tier"] for t in rep["tiers"]] == list(P.sources.TIER_NAMES)
    assert rc == (0 if rep["active"] is not None else 1)
    return [rc, rep]


def h_cli_hw_replay_check_smoke(P, d, capsys):
    assert P.cli.main(["hw", "replay", P.W0, P.W1, "--check"]) == 0
    out = capsys.readouterr().out
    assert "OK" in out or "ok" in out
    return out


def h_cli_hw_replay_no_paths_is_usage_error(P, d, capsys):
    assert P.cli.main(["hw", "replay"]) == 2
    return capsys.readouterr().err


def h_cli_hw_report_renders(P, d, capsys):
    w = P.window.CounterWindow.load(P.W0)
    rep = P.fidelity.fidelity_report(w, seed=0)
    p = d / "fid.json"
    p.write_text(json.dumps(rep))
    assert P.cli.main(["hw", "report", str(p)]) == 0
    out = capsys.readouterr().out
    assert "fidelity" in out
    return out


TWIN_CASES = [
    h_event_mapping_full, h_event_mapping_absent_events_stay_zero,
    h_fake_tier_sampling_deltas, h_overlay_writes_only_supplied_slots,
    h_probe_report_shape, h_recorder_ring_wrap_and_dropped,
    h_window_save_load_digest_roundtrip,
    h_window_load_rejects_width_mismatch,
    h_checked_in_window_digests_pinned, h_replay_byte_identical_twice,
    h_replay_cycles_and_advances_clock, h_replay_empty_window_raises,
    h_feedback_from_source_validates_identity,
    h_fidelity_report_reproducible,
]
ENV_CASES = [h_disable_all_is_byte_invisible, h_disable_single_tier]
CLI_CASES = [h_cli_hw_probe_json, h_cli_hw_replay_check_smoke,
             h_cli_hw_replay_no_paths_is_usage_error,
             h_cli_hw_report_renders]


@pytest.mark.parametrize("case", TWIN_CASES, ids=lambda c: c.__name__)
def test_hwtelem_case_twin(case, tmp_path):
    _twin(case, tmp_path)


@pytest.mark.parametrize("case", ENV_CASES, ids=lambda c: c.__name__)
def test_hwtelem_env_case_twin(case, tmp_path, monkeypatch):
    _twin(case, tmp_path, monkeypatch=monkeypatch)


@pytest.mark.parametrize("case", CLI_CASES, ids=lambda c: c.__name__)
def test_hwtelem_cli_case_twin(case, tmp_path, capsys):
    _twin(case, tmp_path, capsys=capsys)


@pytest.mark.slow
def test_live_record_replay_fidelity_twin(tmp_path, capsys):
    for P in (REF, PORT):
        out = str(tmp_path / f"{P.root}.jsonl")
        assert P.cli.main(["hw", "record", "--out", out, "--seed", "3",
                           "--ticks", "60"]) == 0
        w = P.window.CounterWindow.load(out)
        assert len(w.samples) > 0
        capsys.readouterr()
        assert P.cli.main(["hw", "replay", out, "--check"]) == 0
        rep = P.fidelity.fidelity_report(w, seed=3)
        assert 0 <= rep["fidelity_x1e6"] <= 1_000_000


@pytest.mark.slow
def test_live_sampling_monotone_twin():
    for P in (REF, PORT):
        src = P.sources.HwCounterSource(probe=True)
        if src.tier is None:
            pytest.skip("no counter tier available on this box")
        try:
            src.sample()
            x = 0
            for _ in range(200_000):
                x += 1
            deltas = src.sample()
            assert all(v >= 0 for v in deltas.values())
            assert set(deltas) == set(src.tier.events())
        finally:
            src.close()


# -- across packages ---------------------------------------------------------


@pytest.mark.parametrize("name", ["w0.jsonl", "w1.jsonl"])
def test_copied_windows_are_the_reference_s_bytes(name):
    with open(os.path.join(PORT.windows, name), "rb") as a, \
            open(os.path.join(REF.windows, name), "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("name", ["W0", "W1"])
@pytest.mark.parametrize("knob_values", [None, {
    "sched.feedback.tslice_min_us": 100,
    "sched.feedback.tslice_max_us": 700, "sched.feedback.window": 3}],
    ids=["defaults", "serving-band"])
def test_fidelity_report_bytes_equal(name, knob_values):
    reps = [P.fidelity.fidelity_report(
        P.window.CounterWindow.load(getattr(P, name)), seed=1,
        knob_values=knob_values) for P in (REF, PORT)]
    assert (PORT.trace.dumps_canonical(reps[1])
            == REF.trace.dumps_canonical(reps[0]))
    assert PORT.fidelity.render_report(reps[1]) == \
        REF.fidelity.render_report(reps[0])


def _scripted(P, n=600):
    readings = [{"task-clock": 37_000 * i + (i * i) % 977,
                 "cache-references": 500 * i, "cache-misses": 90 * i,
                 "instructions": 4_000 * i} for i in range(n)]
    return P.sources.HwCounterSource(tier=P.FakeTier(readings),
                                     clock=P.clock.VirtualClock(5_000))


def test_record_serving_window_equal_under_a_scripted_tier():
    got = []
    for P in (REF, PORT):
        window, rep = P.fidelity.record_serving_window(
            seed=4, ticks=60, hw_source=_scripted(P), sample_every=2)
        got.append((window.lines(), rep,
                    P.trace.dumps_canonical(P.fidelity.fidelity_report(
                        window, seed=4, horizon_ns=100 * MS))))
    assert got[1] == got[0]
    lines, rep, _ = got[1]
    assert rep["tier"] == "fake" and rep["samples"] == len(lines) - 1
    assert rep["completed"] > 0


def test_hw_source_over_sim_backend_steers_the_same():
    """``HwCounterSource(inner=SimBackend)`` with a scripted tier: the
    overlay, the policy armed by ``from_source`` and the recorded trace
    are the reference's."""
    got = []
    for P in (REF, PORT):
        be = P.tel.SimBackend(seed=2)
        src = P.sources.HwCounterSource(inner=be, tier=P.FakeTier(
            [{"task-clock": 60_000 * i, "cache-references": 40 * i,
              "cache-misses": 9 * i} for i in range(400)]))
        part = P.rt.Partition("hw", source=src, scheduler="credit")
        rec = P.trace.TraceRecorder()
        part.recorder = rec
        pol = P.feedback.FeedbackPolicy.from_source(part, src)
        be.register("a", P.tel.SimProfile.steady(
            step_time_ns=80_000, stall_frac=0.4, collective_wait_ns=500))
        be.register("b", P.tel.SimProfile.steady(
            step_time_ns=30_000, stall_frac=0.02, collective_wait_ns=3_000))
        for name, w in (("a", 512), ("b", 256)):
            part.add_job(P.rt.Job(name, params=P.rt.SchedParams(weight=w),
                                  max_steps=300))
        part.run(until_ns=40 * MS)
        pol.timer.stop()
        got.append([rec.lines, pol.dump(), part.dump(), src.describe()])
    assert _canon(got[1]) == _canon(got[0])


def test_from_source_identity_errors_equal():
    msgs = []
    for P in (REF, PORT):
        be = P.tel.SimBackend()
        src = P.sources.HwCounterSource(inner=be, tier=P.FakeTier(
            [{"task-clock": 0}]))
        part = P.rt.Partition("who", source=src, scheduler="credit")
        # The partition's source, the seam it wraps, and a source
        # wrapping the partition's source all pass.
        for ok in (src, be):
            P.feedback.FeedbackPolicy.from_source(part, ok).timer.stop()
        plain = P.rt.Partition("plain", source=be, scheduler="credit")
        P.feedback.FeedbackPolicy.from_source(plain, src).timer.stop()
        out = []
        for stranger in (P.tel.SimBackend(), P.sources.HwCounterSource(
                inner=P.tel.SimBackend(), probe=False)):
            with pytest.raises(ValueError) as e:
                P.feedback.FeedbackPolicy.from_source(part, stranger)
            out.append(str(e.value))
        pol = P.feedback.FeedbackPolicy.from_source(part, src, stale_after=7)
        pol.timer.stop()
        msgs.append([out, pol.stale_after])
    assert msgs[1] == msgs[0]


def test_cli_hw_json_equals_the_reference(tmp_path, capsys, monkeypatch):
    docs = []
    for P in (REF, PORT):
        out = str(tmp_path / f"{P.root}.json")
        assert P.cli.main(["hw", "fidelity", "--window", P.W1, "--json",
                           "--out", out]) == 0
        docs.append((capsys.readouterr().out, open(out).read()))
        monkeypatch.setenv(P.sources.DISABLE_ENV, "all")
        assert P.cli.main(["hw", "probe", "--json"]) == 1
        docs.append(capsys.readouterr().out)
        monkeypatch.delenv(P.sources.DISABLE_ENV)
    assert docs[2:] == docs[:2]


def test_hwtelem_exports_are_the_reference_s():
    assert PORT.hw.__all__ == REF.hw.__all__
    for name in ("DECLARED_EVENTS", "PERF_EVENT_MAP", "TIER_NAMES",
                 "DISABLE_ENV", "CACHE_LINE_BYTES", "CGROUP_PATHS"):
        assert getattr(PORT.sources, name) == getattr(REF.sources, name)
    assert [int(s) for s in PORT.sources.HW_SLOTS] == \
        [int(s) for s in REF.sources.HW_SLOTS]
    assert PORT.window.HW_SCHEMA_VERSION == REF.window.HW_SCHEMA_VERSION
    assert PORT.window.DEFAULT_CAPACITY == REF.window.DEFAULT_CAPACITY


def test_gateway_chaos_arrival_model_is_the_reference_s():
    from pbs_tpu.gateway import chaos as ref_chaos
    from pbs_tpu_torch.gateway import chaos as port_chaos
    from pbs_tpu_torch.gateway import quota_for

    assert quota_for is port_chaos.quota_for
    tenants = ref_chaos.build_workload("mixed", seed=3, n_tenants=6)
    ptenants = port_chaos.build_workload("mixed", seed=3, n_tenants=6)
    streams = [ref_chaos.catalog_arrivals(tenants, 3, tag=7),
               port_chaos.catalog_arrivals(ptenants, 3, tag=7)]
    for t, pt in zip(tenants, ptenants):
        q, pq = (ref_chaos.quota_for(t.name, t.slo, t.params.weight),
                 port_chaos.quota_for(pt.name, pt.slo, pt.params.weight))
        assert (pq.rate, pq.burst, pq.weight, pq.slo, pq.max_queued) == \
            (q.rate, q.burst, q.weight, q.slo, q.max_queued)
        models = (ref_chaos.ArrivalModel(), port_chaos.ArrivalModel())
        for tick in range(50):
            assert (models[1].draw(pt, tick, streams[1][pt.name])
                    == models[0].draw(t, tick, streams[0][t.name]))
    # The harnesses themselves draw from the same streams: the port's
    # reports are the reference's, digests included.
    kw = dict(workload="mixed", seed=3, n_tenants=3, ticks=60)
    for name in ("run_gateway_chaos", "run_federation_chaos"):
        got = getattr(port_chaos, name)(**kw)
        want = getattr(ref_chaos, name)(**kw)
        assert got["ok"] and want["ok"]
        assert got["trace_digest"] == want["trace_digest"]
        assert got.get("report_digest") == want.get("report_digest")
