"""``pbs_tpu_torch.scenarios`` against ``pbs_tpu``'s: twins of
``tests/test_scenarios.py``.

Every case runs on both packages: genome purity, mutation and crossover,
validation, the catalog registration, the arrival model's borrowable
oversize cost, fault and kill plans, the scorer and the invariant gate,
the demo hunt (its digest, worker-count parity, admission, the archive
bound), the corpus roundtrip, promotion, the shipped corpus at its golden
digests, the CLI and the knobs that steer a hunt. Across packages:
``Genome.from_seed(s).digest()`` and ``mutate``/``crossover`` for several
seeds, the stress report of a genome, the demo hunt's archive digest on
one and two workers (the digest phase 3a (d) checks,
``chip_smoke.AP_HUNT_DIGEST``), and the port's copy of the corpus byte
for byte. Phase 3a (d)'s own code runs on the host. The full-size soak
stays behind ``slow``, as the reference's does.
"""

from __future__ import annotations

import copy
import importlib
import json
import os
import types

import pytest

import chip_smoke


def _ns(root: str) -> types.SimpleNamespace:
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    return types.SimpleNamespace(
        root=root, sc=mod("scenarios"), genome=mod("scenarios.genome"),
        score=mod("scenarios.score"), hunt=mod("scenarios.hunt"),
        corpus=mod("scenarios.corpus"), workload=mod("sim.workload"),
        adm=mod("gateway.admission"), chaos=mod("gateway.chaos"),
        knobs=mod("knobs"), channel=mod("knobs.channel"),
        cli=mod("cli.pbst"), faults=mod("faults.injector"))


REF, PORT = _ns("pbs_tpu"), _ns("pbs_tpu_torch")
ROOTS = {REF.root: REF, PORT.root: PORT}


@pytest.fixture(params=[REF, PORT], ids=["ref", "port"])
def P(request):
    yield request.param
    request.param.faults.uninstall()
    request.param.knobs.reset_local()


def _dumps(x) -> str:
    return json.dumps(x, sort_keys=True)


# -- genome determinism ------------------------------------------------------


def test_genome_from_seed_is_pure(P):
    a, b = P.sc.Genome.from_seed(7), P.sc.Genome.from_seed(7)
    assert a.canonical() == b.canonical()
    assert a.digest() == b.digest()
    assert P.sc.Genome.from_seed(8).digest() != a.digest()


def test_mutate_crossover_are_pure_and_move(P):
    g = P.sc.Genome.from_seed(0)
    m1, m2 = g.mutate(3), g.mutate(3)
    assert m1.canonical() == m2.canonical()
    assert m1.digest() != g.digest()
    assert g.mutate(4).digest() != m1.digest()
    other = P.sc.Genome.from_seed(1)
    assert g.crossover(other, 5).canonical() == \
        g.crossover(other, 5).canonical()


def test_genome_roundtrips_and_validates(P):
    g = P.sc.Genome.from_seed(2)
    assert P.sc.Genome.from_dict(g.as_dict()).canonical() == g.canonical()
    d = g.as_dict()
    d["genes"] = dict(d["genes"])
    d["genes"]["n_tenants"] = 99
    with pytest.raises(ValueError, match="outside"):
        P.sc.Genome.from_dict(d)
    d["genes"].pop("n_tenants")
    with pytest.raises(ValueError, match="missing"):
        P.sc.Genome.from_dict(d)
    with pytest.raises(ValueError, match="version"):
        P.sc.Genome.from_dict({"version": 99, "genes": {}})


def test_genome_workload_is_catalog_compatible(P):
    g = P.sc.Genome.from_seed(0)
    a = g.build_tenants(seed=11, n_tenants=4, horizon_ns=10**8)
    b = g.build_tenants(seed=11, n_tenants=4, horizon_ns=10**8)
    assert [t.name for t in a] == [t.name for t in b]
    assert all(t.slo in ("interactive", "batch") for t in a)
    name = g.register()
    try:
        via = P.workload.build_workload(name, seed=11, n_tenants=4,
                                        horizon_ns=10**8)
        assert [t.name for t in via] == [t.name for t in a]
    finally:
        P.workload.unregister_workload(name)
    with pytest.raises(KeyError):
        P.workload.build_workload(name)


def test_make_mix_rejects_unknown_kind_and_covers_kinds(P):
    with pytest.raises(KeyError, match="unknown tenant kind"):
        P.workload.make_mix(["nonesuch"], seed=0, horizon_ns=10**8)
    specs = P.workload.make_mix(list(P.workload.TENANT_KINDS), seed=0,
                                horizon_ns=10**8)
    assert len(specs) == len(P.workload.TENANT_KINDS)
    assert specs[-1].arrival is not None


def test_register_workload_refuses_catalog_shadow(P):
    with pytest.raises(KeyError, match="catalog"):
        P.workload.register_workload("mixed", lambda s, n, h: [])


def test_mutate_moves_even_from_bound_pinned_genome(P):
    d = P.sc.Genome.from_seed(0).as_dict()
    d["genes"] = {gene.name: gene.hi for gene in P.genome.GENES}
    pinned = P.sc.Genome.from_dict(d)
    for s in range(200):
        m = pinned.mutate(s)
        assert m.digest() != pinned.digest(), s
        assert m.canonical() == pinned.mutate(s).canonical()


def test_oversize_cost_is_borrowable_not_over_burst(P):
    burst = P.chaos.quota_for("b", P.adm.BATCH, 1).burst
    g = P.sc.Genome.from_seed(0)
    tenants = g.build_tenants(seed=3, n_tenants=4, horizon_ns=10**8)
    for n_gw in (1, 3):
        model = g.arrival_model(tenants, ticks=50, seed=3, n_gateways=n_gw)
        assert model.oversize_cost <= burst, n_gw
        if n_gw > 1:
            assert model.oversize_cost > burst / n_gw


def test_fault_plan_omits_zero_probability_seams(P):
    d = P.sc.Genome.from_seed(0).as_dict()
    d["genes"] = dict(d["genes"])
    d["genes"].update({"death_p": 0.0, "partition_p": 0.0,
                       "lease_expire_p": 0.0, "admit_shed_p": 0.01,
                       "misroute_p": 0.0})
    quiet = P.sc.Genome.from_dict(d)
    assert [s.point for s in quiet.fault_plan(0).specs] == ["gateway.admit"]


def test_process_kill_plan_realizes_crash_genes_tick_positioned(P):
    d = P.sc.Genome.from_seed(0).as_dict()
    d["genes"] = dict(d["genes"])
    d["genes"].update({"crash_p": 0.006, "crash_positions": 2})
    armed = P.sc.Genome.from_dict(d)
    a = armed.process_kill_plan(300, seed=4)
    assert a == armed.process_kill_plan(300, seed=4)
    assert all(set(e) == {"tick"} for e in a)
    assert [e["tick"] for e in a] == sorted(e["tick"] for e in a)
    assert {100, 200} <= {e["tick"] for e in a}
    assert len(a) <= 2 + 2
    d["genes"].update({"crash_p": 0.0, "crash_positions": 0})
    assert P.sc.Genome.from_dict(d).process_kill_plan(300, seed=4) is None


# -- scoring + gate ----------------------------------------------------------


@pytest.fixture(scope="module")
def demo_evals():
    out = {}
    for Q in (REF, PORT):
        g = Q.sc.Genome.from_seed(0)
        out[Q.root] = (g, Q.score.evaluate(g, Q.sc.HuntConfig.demo().stress))
    return out


def test_evaluate_is_deterministic_and_shaped(P, demo_evals):
    g, res = demo_evals[P.root]
    again = P.score.evaluate(g, P.sc.HuntConfig.demo().stress)
    assert _dumps(res) == _dumps(again)
    assert set(res["axes"]) == set(P.sc.AXES)
    assert all(0.0 <= res["axes"][a] <= 1.0 for a in P.sc.AXES)
    assert res["golden"]["trace_digest"]
    assert res["golden"]["report_digest"]
    assert res["ok"]


def test_gate_passes_and_detects_digest_drift(P, demo_evals):
    g, res = demo_evals[P.root]
    stress = P.sc.HuntConfig.demo().stress
    ok = P.score.run_gate(g, stress, expect=res["golden"])
    assert ok["ok"], ok["problems"]
    drifted = dict(res["golden"], report_digest="0" * 64)
    bad = P.score.run_gate(g, stress, expect=drifted)
    assert not bad["ok"]
    assert any("report_digest drift" in p for p in bad["problems"])


def test_hunt_rejects_gate_failures(P, monkeypatch):
    def failing_gate(genome, cfg, expect=None):
        return {"ok": False, "problems": ["forced gate failure"],
                "trace_digest": "x", "report_digest": "x",
                "admitted": 0, "completed": 0}

    monkeypatch.setattr(P.hunt, "run_gate", failing_gate)
    r = P.hunt.hunt(P.sc.HuntConfig.demo(), workers=1)
    assert r["archive"] == {}
    assert r["rejected"]
    assert all("forced gate failure" in p
               for e in r["rejected"] for p in e["problems"])


# -- the hunt ----------------------------------------------------------------


@pytest.fixture(scope="module")
def demo_hunts():
    return {Q.root: Q.hunt.hunt(Q.sc.HuntConfig.demo(), workers=1)
            for Q in (REF, PORT)}


def test_demo_hunt_digest_is_stable(P, demo_hunts):
    demo = demo_hunts[P.root]
    again = P.hunt.hunt(P.sc.HuntConfig.demo(), workers=1)
    assert again["archive_digest"] == demo["archive_digest"]
    assert demo["archive"], "demo hunt found nothing"
    for e in demo["archive"].values():
        assert e["golden"]["trace_digest"]


def test_hunt_worker_count_parity(P, demo_hunts):
    multi = P.hunt.hunt(P.sc.HuntConfig.demo(), workers=2)
    assert multi["archive_digest"] == demo_hunts[P.root]["archive_digest"]


def test_archive_admission_is_monotone(P, demo_hunts):
    arch = demo_hunts[P.root]["archive"]
    rebuilt: dict[str, dict] = {}
    for e in sorted(arch.values(), key=lambda e: e["score"]):
        sig = e["signature"]
        if sig not in rebuilt or e["score"] > rebuilt[sig]["score"]:
            rebuilt[sig] = e
    assert {s: e["score"] for s, e in rebuilt.items()} == \
        {s: e["score"] for s, e in arch.items()}


def test_archive_bound_evicts_weakest(P):
    cfg = P.sc.HuntConfig(seed=0, population=4, generations=2,
                          archive_max=2, stress=P.sc.StressConfig.demo())
    r = P.hunt.hunt(cfg, workers=1)
    assert len(r["archive"]) <= 2
    assert sum(e["evicted"] for e in r["log"]) > 0


# -- corpus ------------------------------------------------------------------


def test_corpus_save_load_digest_roundtrip(P, tmp_path, demo_hunts):
    demo = demo_hunts[P.root]
    sig = max(demo["archive"], key=lambda s: demo["archive"][s]["score"])
    entry = P.corpus.make_entry(
        "burn", demo["archive"][sig],
        P.sc.StressConfig.from_dict(demo["config"]["stress"]))
    path = P.corpus.save_entry(entry, str(tmp_path))
    loaded = P.corpus.load_entry(path)
    assert loaded == entry
    assert P.corpus.corpus_digest([loaded]) == \
        P.corpus.corpus_digest([entry])
    bad = copy.deepcopy(entry)
    bad["golden"]["trace_digest"] = ""
    p2 = tmp_path / "bad.json"
    p2.write_text(json.dumps(bad))
    with pytest.raises(ValueError, match="golden"):
        P.corpus.load_entry(str(p2))


def test_promote_frontier_writes_distinct_gated_entries(P, tmp_path,
                                                        demo_hunts):
    outcomes = P.corpus.promote_frontier(
        demo_hunts[P.root], corpus_dir=str(tmp_path), axes=("burn", "shed"))
    promoted = [o for o in outcomes if o["promoted"]]
    assert promoted, outcomes
    names = [o["name"] for o in promoted]
    assert len(set(names)) == len(names)
    rep = P.corpus.replay_corpus(str(tmp_path), check=True)
    assert rep["ok"], [v["problems"] for v in rep["verdicts"]]
    with pytest.raises(KeyError, match="unknown stress axis"):
        P.corpus.promote_frontier(demo_hunts[P.root],
                                  corpus_dir=str(tmp_path), axes=("nope",))


def test_shipped_corpus_replays_at_golden_digests(P):
    paths = P.corpus.corpus_paths()
    assert len(paths) >= 3
    entries = [P.corpus.load_entry(p) for p in paths]
    assert {"burn", "fairness", "slack"} <= {e["axis"] for e in entries}
    rep = P.corpus.replay_corpus(check=True)
    assert rep["ok"], [v for v in rep["verdicts"] if not v["ok"]]


# -- CLI smokes --------------------------------------------------------------


def test_cli_hunt_demo_and_promote_and_replay(P, tmp_path, capsys):
    main = P.cli.main
    out = str(tmp_path / "hunt.json")
    assert main(["scenarios", "hunt", "--demo", "--out", out]) == 0
    capsys.readouterr()
    cdir = str(tmp_path / "corpus")
    assert main(["scenarios", "promote", "--archive", out,
                 "--corpus", cdir, "--axes", "burn"]) == 0
    capsys.readouterr()
    assert main(["scenarios", "replay", "--check", "--corpus", cdir]) == 0
    assert "ok (1 scenario(s)" in capsys.readouterr().out


def test_cli_hunt_demo_json_byte_stable(P, capsys):
    assert P.cli.main(["scenarios", "hunt", "--demo", "--json"]) == 0
    a = capsys.readouterr().out
    assert P.cli.main(["scenarios", "hunt", "--demo", "--json"]) == 0
    assert a == capsys.readouterr().out


def test_cli_replay_shipped_corpus_check(P, capsys):
    assert P.cli.main(["scenarios", "replay", "--check"]) == 0
    assert "digests checked" in capsys.readouterr().out


def test_cli_usage_errors(P, tmp_path, capsys):
    main = P.cli.main
    assert main(["scenarios", "promote"]) == 2
    assert "needs --archive" in capsys.readouterr().err
    assert main(["scenarios", "promote", "--archive",
                 str(tmp_path / "nope.json")]) == 2
    capsys.readouterr()
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    assert main(["scenarios", "replay", "--corpus", empty]) == 2
    assert "empty" in capsys.readouterr().err
    assert main(["scenarios", "whatif", "--corpus", empty]) == 2


def test_cli_replay_fails_on_digest_drift(P, tmp_path, capsys):
    src = P.corpus.corpus_paths()[0]
    entry = P.corpus.load_entry(src)
    entry["golden"]["report_digest"] = "0" * 64
    cdir = tmp_path / "drifted"
    cdir.mkdir()
    (cdir / os.path.basename(src)).write_text(
        json.dumps(entry, sort_keys=True))
    assert P.cli.main(["scenarios", "replay", "--check",
                       "--corpus", str(cdir)]) == 1
    assert "FAILED" in capsys.readouterr().out


def test_whatif_bridges_corpus_to_autopilot_shadow(P):
    entry = P.corpus.load_entry(P.corpus.corpus_paths()[0])
    w = P.corpus.whatif_window(entry)
    assert w.arrivals and w.tenants
    assert w.digest() == P.corpus.whatif_window(entry).digest()
    verdict = P.corpus.whatif_entry(entry)
    assert verdict["workload_class"] in (
        "stable", "contended", "phases", "serving", "mixed")
    assert verdict["proposal"]["window_digest"] == w.digest()
    assert _dumps(verdict) == _dumps(P.corpus.whatif_entry(entry))


def test_cli_whatif_smoke(P, capsys):
    assert P.cli.main(["scenarios", "whatif"]) == 0
    out = capsys.readouterr().out
    assert "margin=" in out and "candidate=" in out


# -- knobs steer the loop ----------------------------------------------------


def test_hunt_config_reads_scenario_knobs(P):
    try:
        P.knobs.set_local({"scenarios.hunt.population": 3,
                           "scenarios.hunt.generations": 1})
        cfg = P.sc.HuntConfig.from_knobs(seed=5)
        assert cfg.population == 3
        assert cfg.generations == 1
    finally:
        P.knobs.reset_local()


def test_worker_parity_survives_knob_overlay(P, demo_hunts):
    try:
        P.knobs.set_local({"scenarios.score.w_burn": 0.0,
                           "scenarios.score.w_shed": 2.0})
        a = P.hunt.hunt(P.sc.HuntConfig.demo(), workers=1)
        b = P.hunt.hunt(P.sc.HuntConfig.demo(), workers=2)
    finally:
        P.knobs.reset_local()
    assert a["archive_digest"] == b["archive_digest"]
    assert a["archive_digest"] != demo_hunts[P.root]["archive_digest"]


def test_cli_hunt_knobs_channel_adoption(P, tmp_path, capsys):
    main = P.cli.main
    assert main(["scenarios", "hunt", "--demo", "--knobs",
                 str(tmp_path / "nope.led")]) == 2
    assert "--knobs" in capsys.readouterr().err
    path = str(tmp_path / "knobs.led")
    P.channel.KnobChannel.create(path).push({"scenarios.score.w_burn": 0.0})
    try:
        assert main(["scenarios", "hunt", "--demo", "--json",
                     "--knobs", path]) == 0
        doc = json.loads(capsys.readouterr().out)
        assert doc["archive"]
        w = {a: float(P.knobs.get(f"scenarios.score.w_{a}"))
             for a in P.sc.AXES}
        assert w["burn"] == 0.0
        for e in doc["archive"].values():
            assert abs(e["score"] - sum(w[a] * e["axes"][a]
                                        for a in P.sc.AXES)) < 1e-6
    finally:
        P.knobs.reset_local()


# -- across packages ---------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 7, 42, 1234])
def test_genome_digests_equal_across_packages(seed):
    g = [Q.sc.Genome.from_seed(seed) for Q in (REF, PORT)]
    assert g[1].canonical() == g[0].canonical()
    assert g[1].digest() == g[0].digest()
    for s in (3, seed + 11):
        assert g[1].mutate(s).digest() == g[0].mutate(s).digest()
        assert g[1].mutate(s, rate=0.9).canonical() == \
            g[0].mutate(s, rate=0.9).canonical()
    others = [Q.sc.Genome.from_seed(seed + 1) for Q in (REF, PORT)]
    assert g[1].crossover(others[1], 5).digest() == \
        g[0].crossover(others[0], 5).digest()
    assert [Q.genome.derive_seed("eval", seed, 3) for Q in (REF, PORT)] \
        == [REF.genome.derive_seed("eval", seed, 3)] * 2


def test_genome_plans_and_tenants_equal_across_packages():
    for seed in (0, 5):
        g = [Q.sc.Genome.from_seed(seed) for Q in (REF, PORT)]
        assert g[1].fault_plan(seed).as_dict() == \
            g[0].fault_plan(seed).as_dict()
        assert g[1].crash_plan(240) == g[0].crash_plan(240)
        assert g[1].process_kill_plan(300, seed) == \
            g[0].process_kill_plan(300, seed)
        tenants = [x.build_tenants(seed, 4, 10**8) for x in g]
        assert [(t.name, t.slo, t.params.weight) for t in tenants[1]] == \
            [(t.name, t.slo, t.params.weight) for t in tenants[0]]


def test_stress_reports_equal_across_packages(demo_evals):
    assert _dumps(demo_evals[PORT.root][1]) == \
        _dumps(demo_evals[REF.root][1])


def test_demo_hunt_equal_across_packages_and_workers(demo_hunts):
    """The demo hunt's archive digest is the reference's on one and two
    spawn workers: the digest phase 3a (d) holds the card host to."""
    want = demo_hunts[REF.root]
    assert demo_hunts[PORT.root]["archive_digest"] == want["archive_digest"]
    assert _dumps(demo_hunts[PORT.root]) == _dumps(want)
    assert want["archive_digest"] == chip_smoke.AP_HUNT_DIGEST
    two = PORT.hunt.hunt(PORT.sc.HuntConfig.demo(), workers=2)
    assert two["archive_digest"] == chip_smoke.AP_HUNT_DIGEST


def test_port_corpus_is_the_reference_s_byte_for_byte():
    ref, port = REF.corpus.corpus_paths(), PORT.corpus.corpus_paths()
    assert [os.path.basename(p) for p in port] == \
        [os.path.basename(p) for p in ref]
    for a, b in zip(ref, port):
        assert open(a, "rb").read() == open(b, "rb").read()
    assert PORT.corpus.CORPUS_DIR != REF.corpus.CORPUS_DIR
    assert PORT.corpus.CORPUS_DIR.endswith(
        os.path.join("pbs_tpu_torch", "scenarios", "corpus"))


def test_corpus_replays_equal_across_packages():
    got = [Q.corpus.replay_corpus(check=True) for Q in (REF, PORT)]
    for g in got:
        g.pop("corpus_dir")
    assert _dumps(got[1]) == _dumps(got[0])
    assert got[1]["ok"]


def test_promote_defaults_into_the_port_s_corpus(tmp_path, monkeypatch,
                                                 demo_hunts):
    """``pbst-torch scenarios promote`` writes into the port's corpus
    directory unless told otherwise, never the reference's."""
    written = []
    monkeypatch.setattr(PORT.corpus, "save_entry",
                        lambda doc, d=None: written.append(d) or str(
                            tmp_path / f"{doc['name']}.json"))
    arch = str(tmp_path / "hunt.json")
    with open(arch, "w") as f:
        json.dump(demo_hunts[PORT.root], f)
    assert PORT.cli.main(["scenarios", "promote", "--archive", arch,
                          "--axes", "burn"]) == 0
    assert written == [None]
    assert PORT.corpus.CORPUS_DIR != REF.corpus.CORPUS_DIR


def test_scenario_phase_checks_on_the_host():
    """Phase 3a (d)'s own code: the demo hunt on one and two workers at
    the pinned digest, the corpus replayed, the what-ifs, and a spawn
    worker that loads the scenario plane without torch."""
    out = chip_smoke.scenario_checks()
    assert set(out["hunt_s"]) == {1, 2}
    assert len(out["whatif"]) >= 3
    assert len(out["spawn_import_s"]) == 2


# -- the full-size soak ------------------------------------------------------


@pytest.mark.slow
@pytest.mark.parametrize("root", [REF.root, PORT.root])
def test_full_hunt_soak_deterministic_and_promotable(root, tmp_path):
    P = ROOTS[root]
    cfg = P.sc.HuntConfig(seed=1, population=10, generations=5,
                          stress=P.sc.StressConfig(base_seed=1))
    a = P.hunt.hunt(cfg, workers=1)
    b = P.hunt.hunt(cfg, workers=2)
    assert a["archive_digest"] == b["archive_digest"]
    outcomes = P.corpus.promote_frontier(a, corpus_dir=str(tmp_path))
    assert any(o["promoted"] for o in outcomes)
    assert P.corpus.replay_corpus(str(tmp_path), check=True)["ok"]
