"""``pbs_tpu_torch.autopilot`` against ``pbs_tpu``'s: twins of
``tests/test_autopilot.py`` and phase 3a's own code on the host.

- Every case of ``tests/test_autopilot.py`` is written as a function of a
  package namespace ``P`` and runs on both packages: shadow capture, the
  record->replay roundtrip, the what-if under the pathological band, the
  window classes, the pure shadow search, the canary's burn, promote,
  member-lost, no-evidence and deferral paths, the CLI demo, the config's
  reachable zeros, the ATC cap, the single knob channel and the
  histogram's conservative reader.
- Across packages: a ``ShadowWindow`` saved by one loads in the other
  with an equal digest; ``shadow_search`` on one window gives equal
  proposals; ``run_autopilot_demo`` reports are equal under
  ``json.dumps(sort_keys=True)`` for two seeds and both values of
  ``pathological``.
- Phase 3a's code at toy width (2 layers, d 64, the reference's init
  carried over by ``params_from_numpy``): (a) the loop over engine
  members gives equal reports, adoptions and tokens with each package's
  gateway and engine; (b) ``chip_smoke.autopilot_demo_loop`` with a host
  partition as the observer passes every check, keyed as the canary
  member the seeded demo picks (``chip_smoke.AP_CANARY_MEMBER``); (c) the
  chaos gate's checks.
"""

from __future__ import annotations

import importlib
import json
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax", reason="parity tests need the JAX reference")
import torch  # noqa: E402

import chip_smoke  # noqa: E402

MS = 1_000_000

torch.set_num_threads(2)


def _ns(root: str) -> types.SimpleNamespace:
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    return types.SimpleNamespace(
        root=root, ap=mod("autopilot"), adm=mod("gateway.admission"),
        backends=mod("gateway.backends"), chaos=mod("gateway.chaos"),
        gateway=mod("gateway.gateway"), gwpkg=mod("gateway"),
        fed=mod("gateway.federation"), clock=mod("utils.clock"),
        channel=mod("knobs.channel"), profile=mod("knobs.profile"),
        knobs=mod("knobs"), spans=mod("obs.spans"), cli=mod("cli.pbst"),
        faults=mod("faults.injector"))


REF, PORT = _ns("pbs_tpu"), _ns("pbs_tpu_torch")


@pytest.fixture(params=[REF, PORT], ids=["ref", "port"])
def P(request):
    yield request.param
    request.param.faults.uninstall()
    request.param.knobs.reset_local()


def _dumps(x) -> str:
    return json.dumps(x, sort_keys=True)


def _quotas(P):
    return {
        "inter0": P.adm.TenantQuota(rate=600.0, burst=60.0, weight=256,
                                    slo="interactive", max_queued=64),
        "batch0": P.adm.TenantQuota(rate=300.0, burst=120.0, weight=256,
                                    slo="batch", max_queued=128),
    }


def _drive_live_gateway(P, seed=0, ticks=120, tick_ns=1 * MS):
    """A live single-member gateway shaped exactly like
    ``replay_window``'s reconstruction, with a shadow recorder."""
    clock = P.clock.VirtualClock()
    backends = [P.backends.SimServeBackend(
        f"sb{i}", n_slots=2, service_ns_per_cost=3 * MS,
        seed=seed * 1009 + i) for i in range(2)]
    quotas = _quotas(P)
    gw = P.gateway.Gateway(backends, clock=clock,
                           max_queued=64 * len(quotas), name="live")
    for tenant, q in sorted(quotas.items()):
        gw.register_tenant(tenant, q, now_ns=0)
    rec = P.ap.ShadowRecorder(capacity=4096)
    gw.attach_shadow(rec)
    rng = np.random.default_rng([seed, 23])
    for _ in range(ticks):
        for tenant, q in sorted(quotas.items()):
            u = float(rng.random())
            if q.slo == "interactive":
                fire, cost = u < 0.4, 1 + int(rng.integers(0, 3))
            else:
                fire, cost = u < 0.15, 4 + int(rng.integers(0, 9))
            if fire:
                gw.submit(tenant, None, cost=cost)
        gw.tick()
        clock.advance(tick_ns)
    for _ in range(ticks * 8):
        if not gw.busy():
            break
        gw.tick()
        clock.advance(tick_ns)
    return gw, rec


# -- recorder ----------------------------------------------------------------


def test_recorder_captures_arrivals_and_contracts(P):
    gw, rec = _drive_live_gateway(P)
    assert rec.recorded > 0 and rec.dropped == 0
    win = rec.window(t0_ns=0)
    assert len(win.arrivals) == rec.recorded
    assert set(win.tenants) == {"inter0", "batch0"}
    assert win.tenants["inter0"]["slo"] == "interactive"
    assert rec.recorded >= gw.admitted


def test_recorder_ring_is_bounded(P):
    rec = P.ap.ShadowRecorder(capacity=8)
    for i in range(20):
        rec.on_submit(i * 100, "t", "batch", 1)
    assert rec.recorded == 20 and rec.dropped == 12
    win = rec.window()
    assert len(win.arrivals) == 8
    assert [t for t, *_ in win.arrivals] == \
        [i * 100 - win.t0_ns for i in range(12, 20)]
    with pytest.raises(ValueError, match="capacity"):
        P.ap.ShadowRecorder(capacity=0)


def test_window_save_load_digest_roundtrip(P, tmp_path):
    _, rec = _drive_live_gateway(P, ticks=40)
    win = rec.window(t0_ns=0)
    p = str(tmp_path / "win.jsonl")
    win.save(p)
    back = P.ap.ShadowWindow.load(p)
    assert back.digest() == win.digest()
    assert back.arrivals == win.arrivals
    assert back.tenants == win.tenants


# -- replay ------------------------------------------------------------------


def test_record_replay_roundtrip_reproduces_counts_byte_stably(P):
    gw, rec = _drive_live_gateway(P, seed=0)
    win = rec.window(t0_ns=0)
    rep = P.ap.replay_window(win, seed=0)
    assert rep["drained"] is True
    assert rep["admitted"] == gw.admitted
    assert rep["completed"] == gw.completed
    assert rep["shed"] == sum(gw.admission.sheds.values())
    assert _dumps(rep) == _dumps(P.ap.replay_window(win, seed=0))
    rep3 = P.ap.replay_window(win, seed=7)
    assert _dumps(rep3) != _dumps(rep)
    assert rep3["admitted"] == rep["admitted"]


def test_replay_what_if_under_pathological_knobs_degrades(P):
    _, rec = _drive_live_gateway(P, seed=0)
    win = rec.window(t0_ns=0)
    base = P.ap.replay_window(win, seed=0)
    bad = P.ap.replay_window(
        win, seed=0,
        knob_values=P.profile.params_to_knobs("feedback",
                                              P.ap.PATHOLOGICAL_PARAMS),
        switch_cost_ns=100_000)
    assert bad["tenants"]["inter0"]["e2e_p99_ns"] > \
        base["tenants"]["inter0"]["e2e_p99_ns"]


# -- classification + search -------------------------------------------------


def test_classify_window_first_order_mapping(P):
    def win(arrivals):
        return P.ap.ShadowWindow(t0_ns=0, t1_ns=1000 * MS,
                                 arrivals=tuple(arrivals), tenants={})

    assert P.ap.classify_window(win([])) == "mixed"
    steady = [(i * MS, "t", "interactive", 1) for i in range(50)]
    assert P.ap.classify_window(win(steady)) == "stable"
    bursty = [(int((i // 10) * 40 * MS + (i % 10)), "t", "interactive", 1)
              for i in range(50)]
    assert P.ap.classify_window(win(bursty)) == "serving"
    batch = [(i * MS, "t", "batch", 8) for i in range(50)]
    assert P.ap.classify_window(win(batch)) == "contended"
    half = [(i * MS, "t", "interactive" if i % 2 else "batch", 1)
            for i in range(50)]
    assert P.ap.classify_window(win(half)) == "mixed"


def test_shadow_search_is_a_pure_function_of_the_window(P):
    _, rec = _drive_live_gateway(P, seed=0, ticks=60)
    win = rec.window(t0_ns=0)
    a = P.ap.shadow_search(win, quick=True)
    assert _dumps(a) == _dumps(P.ap.shadow_search(win, quick=True))
    assert a["base_seed"] == P.ap.window_seed(win)
    assert a["live"] == P.ap.reference_params("feedback")
    assert a["margin_x1e6"] == \
        a["candidate_score_x1e6"] - a["live_score_x1e6"]


# -- the canary guard --------------------------------------------------------


def _tiny_federation(P, seed=0, tick_ns=1 * MS, n_members=3):
    clock = P.clock.VirtualClock()
    members = [P.chaos._federation_member(f"gw{i}", i, clock, tick_ns, seed,
                                          n_backends=2, n_tenants=2)
               for i in range(n_members)]
    fed = P.fed.FederatedGateway(members, clock=clock,
                                 renew_period_ns=4 * tick_ns,
                                 lease_ttl_ns=6 * tick_ns)
    for name, q in sorted(_quotas(P).items()):
        fed.register_tenant(name, q)
    return fed, clock


def _pump(P, fed, clock, rng, ticks, tick_ns=1 * MS, canary=None):
    quotas = _quotas(P)
    for _ in range(ticks):
        for tenant, q in sorted(quotas.items()):
            u = float(rng.random())
            cost = (1 + int(rng.integers(0, 3)) if q.slo == "interactive"
                    else 4 + int(rng.integers(0, 9)))
            if u < (0.5 if q.slo == "interactive" else 0.15):
                fed.submit(tenant, None, cost=cost)
        fed.tick()
        if canary is not None:
            decision = canary.poll(fed.clock.now_ns())
            if decision is not None:
                return decision
        clock.advance(tick_ns)
    return None


def _armed_canary(P, fed, tmp_path, **kw):
    path = str(tmp_path / f"{P.root}-knobs.led")
    writer = P.channel.KnobChannel.create(path)
    fed.attach_knobs(P.channel.KnobChannel.attach(path), per_member=True)
    for gw in fed.members.values():
        gw.profile_switch_cost_ns = 100_000
    return P.ap.CanaryRollout(fed, writer, **kw)


def test_canary_burn_guard_rolls_back_pathological(P, tmp_path):
    fed, clock = _tiny_federation(P)
    canary = _armed_canary(P, fed, tmp_path, guard_window_ns=60 * MS,
                           min_guard_samples=3)
    rng = np.random.default_rng([5, 7])
    _pump(P, fed, clock, rng, 30)
    ev = canary.start(dict(P.ap.PATHOLOGICAL_PARAMS), clock.now_ns())
    assert len(ev["members"]) == 1
    cm = ev["members"][0]
    others = [n for n in fed.members if n != cm]
    fed.tick()
    assert fed.members[cm].applied_knobs[
        "sched.feedback.tslice_max_us"] == 10
    for name in others:
        assert fed.members[name].applied_knobs.get(
            "sched.feedback.tslice_max_us") != 10
    assert fed.members[cm].backends[0].service_scale > 10
    decision = _pump(P, fed, clock, rng, 120, canary=canary)
    assert decision is not None and decision["event"] == "rollback"
    assert decision["reason"] == "burn"
    assert max(decision["burns"].values()) > canary.burn_limit
    fed.tick()
    ref_max = canary.reference["sched.feedback.tslice_max_us"]
    assert fed.members[cm].applied_knobs[
        "sched.feedback.tslice_max_us"] == ref_max
    assert abs(fed.members[cm].backends[0].service_scale
               - (1.0 + 100_000 / (ref_max * 1000.0))) < 1e-9


def test_canary_promotes_healthy_candidate_everywhere(P, tmp_path):
    fed, clock = _tiny_federation(P)
    canary = _armed_canary(P, fed, tmp_path, guard_window_ns=60 * MS,
                           min_guard_samples=3)
    rng = np.random.default_rng([5, 7])
    _pump(P, fed, clock, rng, 30)
    canary.start({"min_us": 100, "max_us": 2000, "window": 5},
                 clock.now_ns())
    decision = _pump(P, fed, clock, rng, 120, canary=canary)
    assert decision is not None and decision["event"] == "promote", decision
    fed.tick()
    for name, gw in fed.members.items():
        assert gw.applied_knobs["sched.feedback.tslice_max_us"] == 2000, \
            name


def test_canary_member_lost_mid_guard_rolls_back(P, tmp_path):
    fed, clock = _tiny_federation(P)
    canary = _armed_canary(P, fed, tmp_path, guard_window_ns=300 * MS)
    rng = np.random.default_rng([5, 7])
    _pump(P, fed, clock, rng, 10)
    ev = canary.start(dict(P.ap.PATHOLOGICAL_PARAMS), clock.now_ns())
    fed.kill(ev["members"][0])
    decision = canary.poll(clock.now_ns())
    assert decision is not None
    assert decision["event"] == "rollback"
    assert decision["reason"] == "member-lost"


def test_no_evidence_never_promotes(P, tmp_path):
    fed, clock = _tiny_federation(P)
    canary = _armed_canary(P, fed, tmp_path, guard_window_ns=20 * MS)
    canary.start(dict(P.ap.PATHOLOGICAL_PARAMS), clock.now_ns())
    decision = None
    for _ in range(40):
        fed.tick()
        decision = canary.poll(clock.now_ns())
        if decision is not None:
            break
        clock.advance(1 * MS)
    assert decision is not None
    assert decision["event"] == "rollback"
    assert decision["reason"] == "no-evidence"


def test_canary_emits_span_events(P, tmp_path):
    """AP_CANARY and AP_ROLLBACK land in the federation's span ring with
    the reference's arguments (members; reason code, worst burn x1000)."""
    fed, clock = _tiny_federation(P)
    seen = []

    class Spans:
        def emit_event(self, now_ns, ev, *args):
            seen.append((now_ns, int(ev), args))

        def flush(self):
            pass

    fed.spans = Spans()
    canary = _armed_canary(P, fed, tmp_path, guard_window_ns=20 * MS)
    canary.start(dict(P.ap.PATHOLOGICAL_PARAMS), clock.now_ns())
    ev = importlib.import_module(f"{P.root}.obs.trace").Ev
    for _ in range(40):
        fed.tick()
        if canary.poll(clock.now_ns()) is not None:
            break
        clock.advance(1 * MS)
    assert [s[1] for s in seen] == [int(ev.AP_CANARY), int(ev.AP_ROLLBACK)]
    assert seen[0][2] == (1, 20 * MS)
    assert seen[1][2] == (P.ap.canary.ROLLBACK_NO_EVIDENCE, 0)


# -- CLI ---------------------------------------------------------------------


def test_cli_autopilot_demo_smoke(P, tmp_path, capsys):
    main = P.cli.main
    out_path = str(tmp_path / "ap.json")
    assert main(["autopilot", "run", "--demo", "--pathological",
                 "--out", out_path]) == 0
    out = capsys.readouterr().out
    assert "rollback" in out and "INJECTED" in out
    assert main(["autopilot", "status", "--state", out_path]) == 0
    assert "decisions=propose,canary,rollback" in capsys.readouterr().out
    assert main(["autopilot", "history", "--state", out_path]) == 0
    assert "3 decision event(s)" in capsys.readouterr().out
    assert main(["autopilot", "run"]) == 2
    assert main(["autopilot", "status"]) == 2


def test_cli_autopilot_demo_deterministic(P):
    a = P.ap.run_autopilot_demo(seed=0, ticks=260, pathological=True)
    b = P.ap.run_autopilot_demo(seed=0, ticks=260, pathological=True)
    assert _dumps(a) == _dumps(b)
    assert a["history"][-1]["event"] == "rollback"


def test_cli_autopilot_outputs_equal_across_packages(tmp_path, capsys):
    """The same arguments print the same text and JSON in both
    packages' command lines."""
    outs = {}
    for Q in (REF, PORT):
        path = str(tmp_path / f"{Q.root}.json")
        got = []
        for argv in (["autopilot", "run", "--demo", "--json", "--out", path],
                     ["autopilot", "status", "--state", path],
                     ["autopilot", "history", "--state", path, "--json"]):
            assert Q.cli.main(argv) == 0
            got.append(capsys.readouterr().out)
        got.append(open(path).read())
        outs[Q.root] = got
    assert outs[PORT.root] == outs[REF.root]


# -- review-driven regressions ----------------------------------------------


def test_promote_updates_the_rollback_reference(P, tmp_path):
    fed, clock = _tiny_federation(P)
    canary = _armed_canary(P, fed, tmp_path, guard_window_ns=60 * MS,
                           min_guard_samples=3)
    rng = np.random.default_rng([5, 7])
    _pump(P, fed, clock, rng, 30)
    canary.start({"min_us": 100, "max_us": 2000, "window": 5},
                 clock.now_ns())
    decision = _pump(P, fed, clock, rng, 120, canary=canary)
    assert decision["event"] == "promote"
    assert canary.reference["sched.feedback.tslice_max_us"] == 2000


def test_autopilot_config_zero_values_are_respected(P):
    cfg = P.ap.AutopilotConfig(switch_cost_ns=0, burn_limit=0.0)
    assert cfg.switch_cost_ns == 0
    assert cfg.burn_limit == 0.0
    assert P.ap.AutopilotConfig().switch_cost_ns == \
        P.knobs.default("autopilot.switch_cost_ns")


def test_atc_band_cap_drives_the_profile_model(P):
    clock = P.clock.VirtualClock()
    be = P.backends.SimServeBackend("b0", seed=1)
    gw = P.gateway.Gateway([be], clock=clock, name="gw0")
    gw.profile_switch_cost_ns = 100_000
    push = {"sched.atc.tslice_min_us": 10, "sched.atc.tslice_max_us": 10}
    adopted = gw.apply_member_knobs(dict(push), dict(push))
    assert adopted == sorted(push)
    assert abs(be.service_scale - 11.0) < 1e-9


def test_second_attach_knobs_is_refused(P, tmp_path):
    fed, _ = _tiny_federation(P)
    P.channel.KnobChannel.create(str(tmp_path / "a.led"))
    fed.attach_knobs(P.channel.KnobChannel.attach(str(tmp_path / "a.led")))
    P.channel.KnobChannel.create(str(tmp_path / "b.led"))
    with pytest.raises(ValueError, match="already has a knob channel"):
        fed.attach_knobs(
            P.channel.KnobChannel.attach(str(tmp_path / "b.led")))


def test_chaos_rejects_knob_plan_plus_autopilot(P):
    with pytest.raises(ValueError, match="mutually exclusive"):
        P.gwpkg.run_federation_chaos(ticks=10, autopilot=True,
                                     knob_plan=[{"tick": 1, "set": {}}])


def test_hist_over_target_is_bucket_conservative(P):
    h = P.spans.LatencyHistograms(num_slots=4)
    target = 50 * MS
    h.record("t", "interactive", "e2e", 40 * MS)
    h.record("t", "interactive", "e2e", 60 * MS)
    h.record("t", "interactive", "e2e", 200 * MS)
    over, total = h.over_target("t", "interactive", "e2e", target)
    assert total == 3
    assert over == 1
    assert P.spans.hist_bucket(60 * MS) == P.spans.hist_bucket(target)


def test_canary_deferred_when_no_member_can_host_it(P, tmp_path):
    fed, clock = _tiny_federation(P, n_members=2)
    canary = _armed_canary(P, fed, tmp_path)
    fed.drain("gw0")
    fed._partitioned["gw1"] = clock.now_ns() + 10_000 * MS
    gen_before = canary.channel.generation
    assert canary.start(dict(P.ap.PATHOLOGICAL_PARAMS), clock.now_ns()) \
        is None
    assert canary.state == "idle"
    assert canary.channel.generation == gen_before


# -- across packages ---------------------------------------------------------


@pytest.mark.parametrize("writer,reader", [(REF, PORT), (PORT, REF)],
                         ids=["ref-to-port", "port-to-ref"])
def test_window_saved_by_one_package_loads_in_the_other(writer, reader,
                                                        tmp_path):
    _, rec = _drive_live_gateway(writer, seed=3, ticks=50)
    win = rec.window(t0_ns=0)
    path = str(tmp_path / "win.jsonl")
    win.save(path)
    back = reader.ap.ShadowWindow.load(path)
    assert back.digest() == win.digest()
    assert back.lines() == win.lines()
    other = str(tmp_path / "again.jsonl")
    back.save(other)
    assert open(other, "rb").read() == open(path, "rb").read()


def test_recorders_capture_equal_windows():
    wins = [_drive_live_gateway(Q, seed=1, ticks=80)[1].window(t0_ns=0)
            for Q in (REF, PORT)]
    assert wins[0].lines() == wins[1].lines()
    assert wins[0].digest() == wins[1].digest()


@pytest.mark.parametrize("seed", [0, 2])
def test_shadow_search_equal_across_packages(seed, tmp_path):
    _, rec = _drive_live_gateway(REF, seed=seed, ticks=60)
    path = str(tmp_path / "win.jsonl")
    rec.window(t0_ns=0).save(path)
    got = [Q.ap.shadow_search(Q.ap.ShadowWindow.load(path), quick=True)
           for Q in (REF, PORT)]
    assert _dumps(got[1]) == _dumps(got[0])
    reps = [Q.ap.replay_window(Q.ap.ShadowWindow.load(path), seed=seed)
            for Q in (REF, PORT)]
    assert _dumps(reps[1]) == _dumps(reps[0])


@pytest.mark.parametrize("pathological", [False, True],
                         ids=["healthy", "pathological"])
@pytest.mark.parametrize("seed", [0, 1])
def test_run_autopilot_demo_equal_across_packages(seed, pathological):
    got = [Q.ap.run_autopilot_demo(seed=seed, pathological=pathological)
           for Q in (REF, PORT)]
    assert _dumps(got[1]) == _dumps(got[0])


def test_classify_and_reference_params_equal_across_packages():
    assert PORT.ap.reference_params("feedback") == \
        REF.ap.reference_params("feedback")
    assert PORT.ap.reference_params("atc") == REF.ap.reference_params("atc")
    assert PORT.ap.PATHOLOGICAL_PARAMS == REF.ap.PATHOLOGICAL_PARAMS
    assert PORT.ap.__all__ == REF.ap.__all__


# -- phase 3a on the host ----------------------------------------------------


TOY = dict(vocab=chip_smoke.FLAGSHIP["vocab"], d_model=64, n_layers=2,
           n_heads=4, n_kv_heads=2, d_ff=128, max_seq=1024)


def _loop_modules(Q):
    return types.SimpleNamespace(
        autopilot=Q.ap, gateway=Q.gwpkg, channel=Q.channel,
        profile=Q.profile, clock=Q.clock)


@pytest.fixture(scope="module")
def engine_loops(tmp_path_factory):
    """Phase 3a (a)'s loop at toy width through each package: the
    reference's gateway over its JAX engine, the port's over its own,
    on the same fp32 weights (the reference's init)."""
    import jax.numpy as jnp

    from pbs_tpu import models as ref_models
    from pbs_tpu_torch import models as port_models

    jcfg = ref_models.TransformerConfig(**TOY, dtype=jnp.float32)
    tcfg = port_models.TransformerConfig(**TOY, dtype=torch.float32)
    jparams = ref_models.init_params(jcfg, jax.random.PRNGKey(
        chip_smoke.JOURNAL_SEED))
    tparams = port_models.params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu")
    kw = dict(n_slots=chip_smoke.ENGINE_SLOTS,
              prompt_bucket=chip_smoke.ENGINE_BUCKET,
              max_len=chip_smoke.ENGINE_MAX_LEN,
              prefix_cache_size=chip_smoke.ENGINE_PREFIX)
    engines = {
        REF.root: lambda: ref_models.ContinuousBatcher(jcfg, jparams, **kw),
        PORT.root: lambda: port_models.ContinuousBatcher(
            tcfg, tparams, device="cpu", **kw),
    }
    reqs, arrivals = chip_smoke.autopilot_script()
    out = {}
    for Q in (REF, PORT):
        tmp = str(tmp_path_factory.mktemp(f"ap-{Q.root}"))
        out[Q.root] = chip_smoke.autopilot_engine_loop(
            _loop_modules(Q), engines[Q.root], reqs, arrivals, tmp)
        out[Q.root]["search_ms"] = chip_smoke.autopilot_search_check(
            _loop_modules(Q), out[Q.root], tmp)
    return out


def test_engine_loop_runs_every_check(engine_loops):
    """Every check of 3a (a) passed inside the run (each raises
    ``chip_smoke.Failed``); the canary ran and was decided."""
    a = engine_loops[PORT.root]
    events = a["report"]["status"]["decisions"]
    assert events[:2] == ["propose", "canary"] and len(events) == 3
    assert a["canary"] == [chip_smoke.AP_CANARY_MEMBER]
    assert a["guard_ticks"] > 0
    st = a["report"]["stats"]
    assert st["admitted"] == st["completed"] == len(a["tokens"])


def test_engine_loop_equal_across_packages(engine_loops):
    """The loop over engine members: equal reports (decisions, member
    adoptions, applied knobs), windows and tokens in both packages."""
    ref, port = engine_loops[REF.root], engine_loops[PORT.root]
    assert _dumps(port["report"]) == _dumps(ref["report"])
    assert port["window"].digest() == ref["window"].digest()
    assert port["final"] == ref["final"]
    assert {i: list(map(int, t)) for i, t in port["tokens"].items()} == \
        {i: list(map(int, t)) for i, t in ref["tokens"].items()}


def test_engine_members_do_not_feel_the_band(engine_loops):
    """The finding 3a (a) records: the profile model re-rates an engine
    member only on paper. Its backend notes the service scale of the
    band it adopted (here the reference band again, after the
    rollback), while the engine serves each request at its own pace:
    the tokens and the timeline are the same in both packages whatever
    scale was noted."""
    from pbs_tpu_torch import knobs

    a = engine_loops[PORT.root]
    cap_us = a["final"]["gw0"]["sched.feedback.tslice_max_us"]
    want = 1.0 + knobs.default("autopilot.switch_cost_ns") / (cap_us * 1e3)
    assert a["scales"] == {f"gw{i}": [want]
                           for i in range(chip_smoke.FED_MEMBERS)}
    assert a["decision"]["event"] == "rollback"


class _HostPartition:
    """3a (b)'s observer on the host: a credit partition over
    ``CudaBackend(device="cpu")`` with a scoring and a matmul tenant of
    plain torch ops."""

    def __init__(self):
        from pbs_tpu_torch.runtime import Job, Partition, SchedParams
        from pbs_tpu_torch.sched import FeedbackPolicy
        from pbs_tpu_torch.telemetry import CudaBackend

        g = torch.Generator().manual_seed(0)
        a = torch.randn(32, 32, generator=g)
        self.part = Partition("ap-host", source=CudaBackend(device="cpu"),
                              scheduler="credit")
        self.fb = FeedbackPolicy(self.part)
        self.jobs = {
            "score": Job("score", step_fn=lambda s: (a @ a).sum(),
                         params=SchedParams(
                             weight=chip_smoke.AP_CARD_WEIGHTS["score"])),
            "mm": Job("mm", step_fn=lambda s: a @ a, params=SchedParams(
                weight=chip_smoke.AP_CARD_WEIGHTS["mm"])),
        }
        for job in self.jobs.values():
            self.part.add_job(job)

    def observer(self):
        return chip_smoke.CardKnobObserver(
            self.part, self.fb, self.jobs, chip_smoke.AP_CANARY_MEMBER,
            chip_smoke.AP_CARD_QUANTA)


def test_demo_canary_member_is_the_pinned_one():
    """3a (b) keys its card partition as the member the seeded demo picks
    for its canary: both packages pick chip_smoke.AP_CANARY_MEMBER."""
    for Q in (REF, PORT):
        for pathological in (False, True):
            rep = Q.ap.run_autopilot_demo(seed=chip_smoke.AP_DEMO_SEED,
                                          ticks=chip_smoke.AP_DEMO_TICKS,
                                          pathological=pathological)
            canary = [e for e in rep["history"] if e["event"] == "canary"]
            assert [e["members"] for e in canary] == \
                [[chip_smoke.AP_CANARY_MEMBER]], (Q.root, pathological)


@pytest.mark.parametrize("pathological", [True, False],
                         ids=["pathological", "healthy"])
def test_card_observer_loop_runs_every_check(pathological, tmp_path):
    """3a (b) on the host: the demo loop with a partition beside it gives
    ``run_autopilot_demo``'s report byte for byte, and the partition
    adopts what the canary member adopts at the same generations (the
    pathological band at the canary's, the reference at the
    rollback's)."""
    host = _HostPartition()
    obs = host.observer()
    report, member_adoptions, pushes = chip_smoke.autopilot_demo_loop(
        chip_smoke.AP_DEMO_SEED, chip_smoke.AP_DEMO_TICKS, pathological,
        str(tmp_path), obs)
    chip_smoke.autopilot_card_checks("b", report, member_adoptions, pushes,
                                     obs, pathological)
    rows = chip_smoke.segment_lines("b", obs, 100_000, "host CPU, no card")
    bands = [r["band"] for r in rows]
    if pathological:
        assert bands == [[100, 1100], [10, 10], [100, 1100]]
        assert [e for e, _ in pushes] == ["canary", "rollback"]
    else:
        assert [e for e, _ in pushes] == ["canary", "promote"]
        assert len(bands) == 2 and bands[0] == [100, 1100]
    assert sum(r["quanta"] for r in rows) > 0
    assert all(j.error is None and j.steps_retired() > 0
               for j in host.jobs.values())


def test_card_observer_leaves_the_report_unchanged(tmp_path):
    """The partition is an observer of the channel: the report with it
    is the report without it."""
    a = chip_smoke.autopilot_demo_loop(0, 120, True, str(tmp_path))[0]
    host = _HostPartition()
    b = chip_smoke.autopilot_demo_loop(0, 120, True, str(tmp_path),
                                       host.observer())[0]
    assert _dumps(a) == _dumps(b)


def test_card_checks_catch_a_wrong_generation(tmp_path):
    """The adoption check is not vacuous: an observer that adopted at
    another generation fails it."""
    host = _HostPartition()
    obs = host.observer()
    report, member_adoptions, pushes = chip_smoke.autopilot_demo_loop(
        0, chip_smoke.AP_DEMO_TICKS, True, str(tmp_path), obs)
    obs.adoptions[1]["generation"] += 1
    with pytest.raises(chip_smoke.Failed):
        chip_smoke.autopilot_card_checks("b", report, member_adoptions,
                                         pushes, obs, True)
