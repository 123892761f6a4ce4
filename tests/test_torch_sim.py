"""The port's scheduler simulator against ``pbs_tpu.sim``, byte for byte.

Two kinds of twin. Every case of ``tests/test_sim_trace.py``,
``test_sim_engine.py``, ``test_sim_harness.py``, ``test_sweep.py`` and
``test_probe_equivalence.py`` is written as a function of a package
namespace: it runs once on the reference and once on the port, makes
the reference test's own assertions on each, and the two runs'
observables (reports, digests, counters, CLI output) must be equal.
Then direct cross-package checks: for every catalog workload and every
policy the port's ``SimEngine`` report (``dumps_canonical`` bytes) and
trace digest equal the reference's, in recording and in sweep mode
(where the reference may ride its native tier, so ``sweep.META_KEYS``
is left out, and it is held at ``native=False`` as well); trace files
are byte-identical and replay in either package to the same counter
totals; an explicit request for the native core runs on it, or fails
naming why it cannot. No tolerance: the port copies the arithmetic.
"""

from __future__ import annotations

import importlib
import json
import os
import types

import pytest

pytest.importorskip("jax", reason="parity tests need the JAX reference")

MS = 1_000_000


def _ns(root: str) -> types.SimpleNamespace:
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    return types.SimpleNamespace(
        root=root, sim=mod("sim"), engine=mod("sim.engine"),
        trace=mod("sim.trace"), workload=mod("sim.workload"),
        sweep=mod("sim.sweep"), harness=mod("sim.harness"),
        rt=mod("runtime"), tel=mod("telemetry"),
        feedback=mod("sched.feedback"), clock=mod("utils.clock"),
        stats=mod("utils.stats"), cli=mod("cli.pbst"))


REF = _ns("pbs_tpu")
PORT = _ns("pbs_tpu_torch")


def _canon(obj) -> str:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"),
                      default=str)


def _twin(case, tmp_path, capsys=None):
    """Run a case on both packages, each in its own scratch directory;
    the observables must be equal."""
    out = {}
    for tag, P in (("ref", REF), ("port", PORT)):
        d = tmp_path / tag
        d.mkdir()
        got = case(P, d, capsys) if capsys is not None else case(P, d)
        # The program's own name is the one word the two CLIs differ by.
        out[tag] = _canon(got).replace(str(d), "<tmp>").replace(
            "pbst-torch", "pbst")
    assert out["port"] == out["ref"]


def _counters(job) -> list[list[int]]:
    return [c.counters.tolist() for c in job.contexts]


# -- twins of tests/test_sim_trace.py -------------------------------------


def _recorded_run(P, d, workload="mixed", policy="credit", seed=1):
    path = str(d / "run.jsonl")
    eng = P.sim.SimEngine(workload=workload, policy=policy, seed=seed,
                          n_tenants=3, horizon_ns=100 * MS, trace_path=path)
    report = eng.run()
    return eng, report, path


def t_jsonl_round_trip(P, d):
    eng, report, path = _recorded_run(P, d)
    recs = P.sim.load_trace(path)
    assert recs == eng.recorder.records()
    lines = [json.dumps(r, sort_keys=True, separators=(",", ":"))
             for r in recs]
    assert P.sim.digest_of(lines) == report["trace_digest"]
    meta = P.sim.trace_meta(recs)
    assert meta["scheduler"] == "credit"
    assert {j["name"] for j in meta["jobs"]} == set(report["tenants"])
    return [report, meta]


def t_golden_digest_stability(P, d):
    a, b = d / "a", d / "b"
    a.mkdir(), b.mkdir()
    _, r1, p1 = _recorded_run(P, a, seed=4)
    _, r2, p2 = _recorded_run(P, b, seed=4)
    assert r1["trace_digest"] == r2["trace_digest"]
    with open(p1) as f1, open(p2) as f2:
        t1 = f1.read()
        assert t1 == f2.read()
    return [r1["trace_digest"], t1]


def t_replay_reproduces_counters(P, d):
    eng, _, path = _recorded_run(P, d)
    orig = {j.name: j.contexts[0].counters.copy() for j in eng.jobs}
    part = P.sim.replay_partition(P.sim.load_trace(path))
    part.run()
    Counter = P.tel.Counter
    for name, counters in orig.items():
        replayed = part.job(name).contexts[0].counters
        for c in Counter:
            if c is Counter.RUNQ_WAIT_NS:
                continue
            assert int(replayed[c]) == int(counters[c]), (name, c.name)
    return {j.name: _counters(j) for j in part.jobs}


def t_replay_what_if_other_policy(P, d):
    _, _, path = _recorded_run(P, d)
    recs = P.sim.load_trace(path)
    want = P.sim.recorded_steps(recs)
    part = P.sim.replay_partition(recs, scheduler="credit2")
    part.run()
    for name, steps in want.items():
        assert part.job(name).steps_retired() == steps
    return [want, {j.name: _counters(j) for j in part.jobs},
            part.clock.now_ns()]


def t_replay_preserves_executor_topology(P, d):
    path = str(d / "t.jsonl")
    eng = P.sim.SimEngine(workload="mixed", policy="credit", seed=2,
                          n_tenants=3, n_executors=2, horizon_ns=50 * MS,
                          trace_path=path)
    rep = eng.run()
    part = P.sim.replay_partition(P.sim.load_trace(path))
    assert len(part.executors) == 2
    return rep


def t_streaming_recorder_keeps_digest_without_lines(P, d):
    path = str(d / "s.jsonl")
    rec_a = P.sim.TraceRecorder(path, keep_lines=False)
    rec_b = P.sim.TraceRecorder()
    for rec in (rec_a, rec_b):
        rec.emit({"kind": "quantum", "t": 0, "end": 5, "ex": 0, "job": "j",
                  "ctx": 0, "q_ns": 5, "n": 1, "c": {"steps_retired": 1}})
    rec_a.close()
    assert rec_a.lines == [] and rec_a.records_emitted == 1
    assert rec_a.digest() == rec_b.digest() == P.sim.digest_of(rec_b.lines)
    assert P.sim.load_trace(path) == rec_b.records()
    with pytest.raises(RuntimeError):
        rec_a.records()
    return rec_a.digest()


def t_replay_exhaustion_raises(P, d):
    rec = P.sim.TraceRecorder()
    rec.emit({"kind": "quantum", "t": 0, "end": 1000, "ex": 0, "job": "j",
              "ctx": 0, "q_ns": 1000, "n": 1,
              "c": {"steps_retired": 1, "device_time_ns": 1000}})
    be = P.sim.ReplayBackend(rec.records())
    ctx = types.SimpleNamespace(job=types.SimpleNamespace(name="j"))
    first = be.execute(ctx, 1).tolist()
    with pytest.raises(P.sim.ReplayError) as e:
        be.execute(ctx, 1)
    return [first, str(e.value), be.clock.now_ns()]


def t_recorder_hooks_on_plain_partition(P, d):
    be = P.tel.SimBackend(seed=3)
    part = P.rt.Partition("t", source=be, scheduler="credit")
    P.feedback.FeedbackPolicy(part)
    rec = P.sim.TraceRecorder()
    part.recorder = rec
    be.register("w", P.tel.SimProfile.steady(step_time_ns=100_000,
                                             stall_frac=0.5,
                                             collective_wait_ns=1_000))
    job = P.rt.Job("w", params=P.rt.SchedParams(tslice_us=300),
                   max_steps=500)
    job.contexts[0].avg_step_ns = 100_000.0
    part.add_job(job)
    part.run(until_ns=50 * MS)
    kinds = {r["kind"] for r in rec.records()}
    assert "quantum" in kinds and "tick" in kinds
    q = [r for r in rec.records() if r["kind"] == "quantum"]
    assert all(r["job"] == "w" and r["end"] >= r["t"] for r in q)
    ticks = [r for r in rec.records() if r["kind"] == "tick"]
    assert all(isinstance(t["tslice_us"], int) for t in ticks)
    return [rec.lines, rec.digest()]


# -- twins of tests/test_sim_engine.py ------------------------------------


def e_sim_smoke_every_policy(P, d):
    out = {}
    for policy in P.sim.policy_names():
        r = P.sim.SimEngine(workload="mixed", policy=policy, seed=0,
                            n_tenants=4, horizon_ns=100 * MS,
                            record=False).run()
        assert r["quanta"] > 0, policy
        assert sum(t["steps"] for t in r["tenants"].values()) > 0, policy
        assert r["busy_ns"] == r["elapsed_ns"], policy
        assert r["elapsed_ns"] >= 100 * MS, policy
        out[policy] = {k: v for k, v in r.items()
                       if k not in REF.sweep.META_KEYS}
    return out


def e_digest_deterministic_across_runs(P, d):
    mk = lambda seed: P.sim.SimEngine(  # noqa: E731
        workload="contended", policy="feedback", seed=seed,
        horizon_ns=100 * MS).run()["trace_digest"]
    assert mk(7) == mk(7)
    assert mk(7) != mk(8)
    return [mk(7), mk(8)]


def e_wait_metrics_and_switch_counts(P, d):
    r = P.sim.SimEngine(workload="contended", policy="credit", seed=1,
                        n_tenants=3, horizon_ns=100 * MS).run()
    assert r["switches"] > 0
    assert r["quanta"] >= r["switches"]
    assert r["wait_p99_us"] >= r["wait_p50_us"] > 0
    for t in r["tenants"].values():
        assert t["runq_wait_ns"] > 0
        assert t["dispatches"] > 0
        assert t["quantum_timeline_us"]
    return r


def e_record_false_skips_observability_but_not_metrics(P, d):
    fast = P.sim.SimEngine(workload="contended", policy="feedback", seed=1,
                           n_tenants=3, horizon_ns=100 * MS, record=False)
    r = fast.run()
    assert "trace_digest" not in r
    assert not fast.partition.trace_enabled
    assert fast.partition.drain_traces().shape[0] == 0
    for t in r["tenants"].values():
        assert t["quantum_timeline_us"] == []
        assert t["runq_wait_ns"] > 0
    slow = P.sim.SimEngine(workload="contended", policy="feedback", seed=1,
                           n_tenants=3, horizon_ns=100 * MS,
                           record=True).run()
    slow.pop("trace_digest"), slow.pop("trace_records")
    for rep in (r, slow):
        for t in rep["tenants"].values():
            t.pop("quantum_timeline_us")
    assert r == slow
    return r


def e_serving_arrivals_sleep_and_wake(P, d):
    r = P.sim.SimEngine(workload="serving", policy="credit", seed=5,
                        n_tenants=4, horizon_ns=500 * MS,
                        record=False).run()
    trainer = r["tenants"]["hbm0"]
    serves = [t for n, t in r["tenants"].items() if n.startswith("serve")]
    assert trainer["steps"] > 0
    assert any(s["steps"] > 0 for s in serves)
    assert all(s["device_ns"] < r["elapsed_ns"] for s in serves)
    return {k: v for k, v in r.items() if k not in REF.sweep.META_KEYS}


def e_multi_executor_conservation_bound(P, d):
    r = P.sim.SimEngine(workload="mixed", policy="credit", seed=2,
                        n_tenants=4, n_executors=2, horizon_ns=100 * MS,
                        record=False).run()
    assert 0 < r["busy_ns"] <= 2 * r["elapsed_ns"]
    assert 0 < r["utilization"] <= 1.0
    return r


def e_unknown_names_rejected(P, d):
    msgs = []
    for kw in ({"workload": "mixed", "policy": "nope"},
               {"workload": "nope", "policy": "credit"}):
        with pytest.raises(KeyError) as e:
            P.sim.SimEngine(**kw)
        msgs.append(str(e.value))
    return msgs


def e_jain_index_properties(P, d):
    assert P.sim.jain_index([1, 1, 1, 1]) == 1.0
    assert abs(P.sim.jain_index([1, 0, 0, 0]) - 0.25) < 1e-9
    assert P.sim.jain_index([]) == 1.0
    return [P.sim.jain_index(x) for x in ([3, 5, 7], [0, 9], [2**40, 1])]


# -- twins of tests/test_sim_harness.py -----------------------------------


def h_compare_smoke_and_format(P, d):
    cmp = P.sim.compare("mixed", policies=("credit", "feedback"), seed=0,
                        n_tenants=3, horizon_ns=50 * MS)
    assert set(cmp["policies"]) == {"credit", "feedback"}
    txt = P.sim.format_report(cmp)
    assert "credit" in txt and "feedback" in txt
    for r in cmp["policies"].values():
        assert r["trace_digest"]
        assert 0 < r["jain_fairness"] <= 1.0
    return [cmp, txt]


def h_contended_feedback_beats_credit_p99(P, d):
    fb = P.sim.run_policy("contended", "feedback", seed=7, n_tenants=4,
                          horizon_ns=500 * MS)
    cr = P.sim.run_policy("contended", "credit", seed=7, n_tenants=4,
                          horizon_ns=500 * MS)
    for t in fb["tenants"].values():
        assert t["tslice_us"] == P.feedback.TSLICE_MIN_US
    assert fb["wait_p99_us"] < cr["wait_p99_us"]
    assert fb["wait_p50_us"] < cr["wait_p50_us"]
    return [fb, cr]


def h_stable_hbm_workload_grows_to_cap(P, d):
    r = P.sim.run_policy("stable", "feedback", seed=3, n_tenants=4,
                         horizon_ns=500 * MS)
    for t in r["tenants"].values():
        assert t["tslice_us"] == P.feedback.TSLICE_MAX_US
    cr = P.sim.run_policy("stable", "credit", seed=3, n_tenants=4,
                          horizon_ns=500 * MS)
    assert r["switches"] < cr["switches"]
    return [r, cr]


def h_cli_sim_single_policy(P, d, capsys):
    main = P.cli.main
    argv = ["sim", "--workload", "contended", "--policy", "feedback",
            "--seed", "7", "--seconds", "0.1"]
    assert main(argv) == 0
    out1 = capsys.readouterr().out
    assert "trace_digest=" in out1
    assert main(argv) == 0
    out2 = capsys.readouterr().out
    assert out1 == out2
    assert main(["sim", "--workload", "nope"]) == 2
    capsys.readouterr()
    assert main(["sim", "--policy", "nope"]) == 2
    capsys.readouterr()
    return out1


def h_cli_sim_compare_json(P, d, capsys):
    prefix = str(d / "cmp")
    assert P.cli.main(["sim", "--workload", "mixed", "--policy", "all",
                       "--seconds", "0.05", "--tenants", "2",
                       "--trace", prefix, "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert set(doc["policies"]) == set(P.sim.DEFAULT_POLICIES)
    files = {}
    for p in P.sim.DEFAULT_POLICIES:
        path = d / f"cmp.{p}.jsonl"
        assert path.exists(), p
        files[p] = path.read_text()
    doc.pop("native")  # the native stamp: the port never has the core
    return [doc, files]


# -- twins of tests/test_sweep.py -----------------------------------------


def s_cell_seed_stable_and_independent(P, d):
    SweepCell, cell_seed = P.sweep.SweepCell, P.sweep.cell_seed
    a = SweepCell.make("mixed", "feedback", rep=0)
    assert cell_seed(a) == cell_seed(SweepCell.make("mixed", "feedback"))
    assert cell_seed(a) != cell_seed(SweepCell.make("mixed", "feedback",
                                                    rep=1))
    assert cell_seed(a) != cell_seed(SweepCell.make("stable", "feedback"))
    assert cell_seed(a) != cell_seed(a, base_seed=1)
    assert cell_seed(a) == cell_seed(SweepCell.make("mixed", "credit"))
    assert cell_seed(a) == cell_seed(
        SweepCell.make("mixed", "feedback", params={"window": 3}))
    return [cell_seed(a), cell_seed(a, base_seed=1), a.canonical(),
            P.sweep.seed_from_digest("ab" * 32, salt=5)]


def s_grid_order_is_deterministic_and_complete(P, d):
    cells = P.sweep.build_grid(["stable", "mixed"], ["credit", "feedback"],
                               n_reps=2, horizon_ns=50 * MS)
    assert len(cells) == 8
    assert cells == P.sweep.build_grid(["stable", "mixed"],
                                       ["credit", "feedback"], n_reps=2,
                                       horizon_ns=50 * MS)
    assert [c.workload for c in cells[:4]] == ["stable"] * 4
    assert [c.rep for c in cells[:4]] == [0, 1, 0, 1]
    return [c.canonical() for c in cells]


def _strip_meta(reports):
    return [{k: v for k, v in r.items() if k not in REF.sweep.META_KEYS}
            for r in reports]


def s_run_cell_report_is_byte_stable(P, d):
    cell = P.sweep.SweepCell.make("contended", "feedback",
                                  horizon_ns=60 * MS)
    r1, r2 = P.sweep.run_cell(cell, 3), P.sweep.run_cell(cell, 3)
    assert json.dumps(r1, sort_keys=True) == json.dumps(r2, sort_keys=True)
    assert r1["quanta"] > 0 and r1["elapsed_ns"] >= 60 * MS
    assert 0 < r1["jain_fairness"] <= 1.0
    return _strip_meta([r1])


def s_param_overrides_reach_the_policy(P, d):
    base = P.sweep.SweepCell.make("contended", "feedback",
                                  horizon_ns=80 * MS)
    narrow = P.sweep.SweepCell.make("contended", "feedback",
                                    horizon_ns=80 * MS,
                                    params={"min_us": 100, "max_us": 100})
    rb, rn = P.sweep.run_cell(base), P.sweep.run_cell(narrow)
    assert rn["quanta"] != rb["quanta"]
    return _strip_meta([rb, rn])


def s_sweep_inline_determinism_and_digest(P, d):
    cells = P.sweep.build_grid(["contended"], ["credit", "feedback"],
                               n_reps=2, horizon_ns=40 * MS)
    r1 = P.sweep.sweep(cells, base_seed=7)
    r2 = P.sweep.sweep(cells, base_seed=7)
    assert r1 == r2
    assert P.sweep.sweep_digest(r1) == P.sweep.sweep_digest(r2)
    assert P.sweep.sweep(cells, base_seed=8) != r1
    assert P.sweep.simulated_per_wall(r1, wall_ns=10**9) > 0
    return [P.sweep.sweep_digest(r1), _strip_meta(r1)]


def s_sweep_worker_parity(P, d):
    cells = P.sweep.build_grid(["contended", "stable"], ["feedback"],
                               n_reps=2, horizon_ns=40 * MS)
    inline = P.sweep.sweep(cells, base_seed=7, workers=1)
    fanned = P.sweep.sweep(cells, base_seed=7, workers=2)
    assert json.dumps(inline, sort_keys=True) == \
        json.dumps(fanned, sort_keys=True)
    assert P.sweep.sweep_digest(inline) == P.sweep.sweep_digest(fanned)
    return P.sweep.sweep_digest(inline)


# -- twins of tests/test_probe_equivalence.py ------------------------------


def _probe_run(P, workload, policy, probe_cls=None, seed=11):
    return P.sim.SimEngine(workload=workload, policy=policy, seed=seed,
                           n_tenants=4, horizon_ns=100 * MS,
                           probe_cls=probe_cls).run()


def p_equivalence_holds_for_atc_and_sweep_mode(P, d):
    Lst = P.engine.ListSchedulerProbe
    a = _probe_run(P, "mixed", "atc")
    assert a == _probe_run(P, "mixed", "atc", probe_cls=Lst)
    fast_np = P.sim.SimEngine(workload="mixed", policy="feedback", seed=5,
                              horizon_ns=100 * MS, record=False).run()
    fast_ls = P.sim.SimEngine(workload="mixed", policy="feedback", seed=5,
                              horizon_ns=100 * MS, record=False,
                              probe_cls=Lst).run()
    assert fast_np == fast_ls
    return [a, _strip_meta([fast_np])]


TWIN_CASES = [
    t_jsonl_round_trip, t_golden_digest_stability,
    t_replay_reproduces_counters, t_replay_what_if_other_policy,
    t_replay_preserves_executor_topology,
    t_streaming_recorder_keeps_digest_without_lines,
    t_replay_exhaustion_raises, t_recorder_hooks_on_plain_partition,
    e_sim_smoke_every_policy, e_digest_deterministic_across_runs,
    e_wait_metrics_and_switch_counts,
    e_record_false_skips_observability_but_not_metrics,
    e_serving_arrivals_sleep_and_wake, e_multi_executor_conservation_bound,
    e_unknown_names_rejected, e_jain_index_properties,
    h_compare_smoke_and_format, h_contended_feedback_beats_credit_p99,
    h_stable_hbm_workload_grows_to_cap,
    s_cell_seed_stable_and_independent,
    s_grid_order_is_deterministic_and_complete,
    s_run_cell_report_is_byte_stable, s_param_overrides_reach_the_policy,
    s_sweep_inline_determinism_and_digest, s_sweep_worker_parity,
    p_equivalence_holds_for_atc_and_sweep_mode,
]
CLI_CASES = [h_cli_sim_single_policy, h_cli_sim_compare_json]


@pytest.mark.parametrize("case", TWIN_CASES, ids=lambda c: c.__name__)
def test_sim_case_twin(case, tmp_path):
    _twin(case, tmp_path)


@pytest.mark.parametrize("case", CLI_CASES, ids=lambda c: c.__name__)
def test_sim_cli_case_twin(case, tmp_path, capsys):
    _twin(case, tmp_path, capsys)


@pytest.mark.parametrize("workload", REF.workload.workload_names())
@pytest.mark.parametrize("policy", ["credit", "feedback"])
def test_numpy_probe_matches_list_probe_twin(workload, policy):
    got = {}
    for P in (REF, PORT):
        numpy_rep = _probe_run(P, workload, policy)
        list_rep = _probe_run(P, workload, policy,
                              probe_cls=P.engine.ListSchedulerProbe)
        assert json.dumps(numpy_rep, sort_keys=True) == \
            json.dumps(list_rep, sort_keys=True)
        got[P.root] = _canon(numpy_rep)
    assert got["pbs_tpu_torch"] == got["pbs_tpu"]


@pytest.mark.slow
def test_full_sweep_all_policies_all_workloads_twin():
    for wl in REF.workload.workload_names():
        cmps = [P.sim.compare(wl, seed=7, n_tenants=6) for P in (REF, PORT)]
        for name, r in cmps[1]["policies"].items():
            assert r["quanta"] > 0, (wl, name)
            assert 0 < r["jain_fairness"] <= 1.0, (wl, name)
        assert _canon(cmps[1]) == _canon(cmps[0])


@pytest.mark.slow
def test_full_catalog_sweep_worker_parity_twin():
    digests = []
    for P in (REF, PORT):
        cells = P.sweep.build_grid(P.workload.workload_names(),
                                   ["credit", "feedback", "atc"],
                                   n_reps=3, horizon_ns=200 * MS)
        inline = P.sweep.sweep(cells, base_seed=1, workers=1)
        fanned = P.sweep.sweep(cells, base_seed=1, workers=4)
        assert P.sweep.sweep_digest(inline) == P.sweep.sweep_digest(fanned)
        digests.append(P.sweep.sweep_digest(inline))
    assert digests[1] == digests[0]


# -- the catalog, report for report ----------------------------------------


@pytest.mark.parametrize("workload", REF.workload.workload_names())
@pytest.mark.parametrize("policy", REF.engine.policy_names())
def test_engine_report_and_digest_equal_the_reference(workload, policy):
    """Recording mode: the whole report, digest included, in
    ``dumps_canonical`` bytes. Sweep mode: the report against the
    reference's auto tier (which may be native) without ``META_KEYS``,
    and whole against its ``native=False`` run."""
    kw = dict(workload=workload, policy=policy, seed=3, n_tenants=4,
              horizon_ns=60 * MS)
    want = REF.sim.SimEngine(**kw).run()
    got = PORT.sim.SimEngine(**kw).run()
    assert got["trace_digest"] == want["trace_digest"]
    assert (PORT.trace.dumps_canonical(got)
            == REF.trace.dumps_canonical(want))
    fast = PORT.sim.SimEngine(record=False, **kw)
    got = fast.run()
    ref_fast = REF.sim.SimEngine(record=False, **kw)
    auto = ref_fast.run()
    # Both packages route the same cells to their native cores.
    assert ((fast.native_tier_used is None)
            == (ref_fast.native_tier_used is None))
    witness = REF.sim.SimEngine(record=False, native=False, **kw).run()
    assert _canon(_strip_meta([got])) == _canon(_strip_meta([auto]))
    assert PORT.trace.dumps_canonical(got) == \
        REF.trace.dumps_canonical(witness)


def test_run_cell_and_sweep_digest_equal_the_reference():
    cells = [PORT.sweep.SweepCell.make(wl, pol, rep=r, horizon_ns=40 * MS)
             for wl in ("serving", "phases") for pol in ("feedback", "atc")
             for r in range(2)]
    ref_cells = [REF.sweep.SweepCell.make(c.workload, c.policy, rep=c.rep,
                                          horizon_ns=c.horizon_ns)
                 for c in cells]
    got = PORT.sweep.sweep(cells, base_seed=5)
    want = REF.sweep.sweep(ref_cells, base_seed=5)
    assert PORT.sweep.sweep_digest(got) == REF.sweep.sweep_digest(want)
    assert _strip_meta(got) == _strip_meta(want)
    assert ({r["native_tier"] for r in got}
            == {r["native_tier"] for r in want})
    assert ({r["native_available"] for r in got}
            == {r["native_available"] for r in want})
    assert PORT.sweep.META_KEYS == REF.sweep.META_KEYS


def test_trace_files_are_byte_identical_and_replay_across_packages(
        tmp_path):
    paths = {}
    for P in (REF, PORT):
        paths[P.root] = str(tmp_path / f"{P.root}.jsonl")
        P.sim.SimEngine(workload="serving", policy="feedback", seed=9,
                        n_tenants=4, horizon_ns=150 * MS,
                        trace_path=paths[P.root]).run()
    with open(paths["pbs_tpu"], "rb") as a, \
            open(paths["pbs_tpu_torch"], "rb") as b:
        assert a.read() == b.read()
    totals = {}
    for writer in (REF, PORT):
        for reader in (REF, PORT):
            part = reader.sim.replay_partition(
                reader.sim.load_trace(paths[writer.root]))
            part.run()
            totals[writer.root, reader.root] = {
                j.name: _counters(j) for j in part.jobs}
    first = next(iter(totals.values()))
    assert all(t == first for t in totals.values())


def test_native_core_requests_fail_naming_item_9(capsys, monkeypatch):
    """An explicit request for the native sim core runs on it where the
    library builds, and fails naming the cached reason where it cannot:
    the engine, ``compare``, ``sim --native`` and the stamp, as the
    reference's do."""
    from pbs_tpu_torch.sim import native_core

    assert os.path.exists(native_core.__file__)
    for native in (True, "fastcall", "ctypes"):
        eng = PORT.sim.SimEngine(workload="mixed", policy="credit",
                                 horizon_ns=10 * MS, record=False,
                                 native=native)
        eng.run()
        assert eng.native_tier_used == (
            "fastcall" if native is True else native)
    monkeypatch.setattr(native_core, "available_tier",
                        lambda want=None: None)
    for native in (True, "fastcall", "ctypes"):
        with pytest.raises(RuntimeError, match="native sim core"):
            PORT.sim.SimEngine(workload="mixed", policy="credit",
                               horizon_ns=10 * MS, record=False,
                               native=native).run()
    with pytest.raises(RuntimeError, match="native sim core"):
        PORT.sim.compare("mixed", policies=("credit",),
                         horizon_ns=10 * MS, native=True)
    assert PORT.cli.main(["sim", "--native", "--seconds", "0.01"]) == 2
    assert "native sim core is unavailable" in capsys.readouterr().err
    stamp = PORT.sweep.native_stamp()
    assert stamp["native_available"] is False
    assert stamp["native_tier"] is None
    assert stamp["native_error"]
    assert set(stamp) >= set(REF.sweep.META_KEYS)


def test_sim_package_exports_are_the_reference_s():
    assert PORT.sim.__all__ == REF.sim.__all__
    assert PORT.sim.policy_names() == REF.sim.policy_names()
    assert PORT.sim.DEFAULT_POLICIES == REF.sim.DEFAULT_POLICIES
    assert PORT.harness.NATIVE_POLICIES == REF.harness.NATIVE_POLICIES
    assert PORT.workload.TENANT_KINDS == REF.workload.TENANT_KINDS
    assert PORT.trace.SCHEMA_VERSION == REF.trace.SCHEMA_VERSION


@pytest.mark.parametrize("q", [0.0, 0.01, 0.5, 0.99, 1.0])
def test_nearest_rank_sorted_matches_the_reference(q):
    import numpy as np

    rng = np.random.default_rng(int(q * 100))
    for n in (0, 1, 2, 7, 100):
        v = np.sort(rng.integers(0, 10_000, size=n))
        for seq in (v, v.tolist()):
            assert (PORT.stats.nearest_rank_sorted(seq, q)
                    == REF.stats.nearest_rank_sorted(seq, q))


def test_registered_workload_runs_in_both_packages():
    """A workload registered by name (the card phase builds one from its
    measured step times) runs the same in both packages."""
    reports = []
    for P in (REF, PORT):
        def build(seed, n, horizon_ns, P=P):
            return [P.workload.TenantSpec(
                name=f"t{i}", params=P.rt.SchedParams(weight=256 * (i + 1)),
                profile=P.tel.SimProfile.steady(
                    step_time_ns=200_000 + 50_000 * i,
                    stall_frac=0.1 * i, collective_wait_ns=0))
                for i in range(n)]

        name = P.workload.register_workload("card-test", build)
        try:
            with pytest.raises(KeyError, match="catalog"):
                P.workload.register_workload("mixed", build)
            assert name not in P.workload.workload_names()
            reports.append(P.sim.SimEngine(
                workload=name, policy="feedback", seed=2, n_tenants=3,
                horizon_ns=80 * MS).run())
        finally:
            P.workload.unregister_workload("card-test")
        with pytest.raises(KeyError):
            P.workload.build_workload("card-test")
    assert _canon(reports[1]) == _canon(reports[0])


@pytest.mark.parametrize("workload", ["serving", "mixed", "phases"])
def test_arrival_flips_fire_no_lifecycle_hooks(workload):
    """The simulator's arrival flips park and wake tenants with
    ``notify=False``, as the reference's do: a hook registered on
    ``job-sleep``/``job-wake`` sees none of them, in either package."""
    out = []
    for P in (REF, PORT):
        eng = P.sim.SimEngine(workload=workload, policy="credit", seed=0,
                              horizon_ns=200 * MS, native=False)
        calls = []
        for event in ("job-sleep", "job-wake"):
            eng.partition.hooks.on(
                event, lambda ev, env, calls=calls: calls.append(
                    (ev, sorted(env.items()))))
        eng.run()
        out.append((eng.partition.hooks.fired, calls))
    assert out[0] == (0, [])
    assert out[1] == out[0]
