"""The port's tune search against ``pbs_tpu.sched.tune``.

Every case of ``tests/test_tune.py`` is written as a function of a
package namespace and runs on both packages with equal observables.
Then direct cross-package checks: the five copied tuned profiles pass
the port's ``check_profile`` to their recorded digests (recorded on the
reference's native tier, verified on the port's Python, ctypes and
fastcall tiers: the tier is provenance only); ``successive_halving`` over ``QUICK_SPACE`` gives
the reference's frontier for every catalog workload; written profiles
are byte-identical; and ``pbst-torch tune --check --quick --json``
prints the reference's document apart from the ``native`` stamp.
"""

from __future__ import annotations

import importlib
import json
import types

import pytest

pytest.importorskip("jax", reason="parity tests need the JAX reference")


def _ns(root: str) -> types.SimpleNamespace:
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    return types.SimpleNamespace(
        root=root, tune=mod("sched.tune"), feedback=mod("sched.feedback"),
        rt=mod("runtime"), tel=mod("telemetry"), cli=mod("cli.pbst"))


REF = _ns("pbs_tpu")
PORT = _ns("pbs_tpu_torch")


def _canon(obj) -> str:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"),
                      default=str)


def _twin(case, tmp_path, capsys=None):
    out = {}
    for tag, P in (("ref", REF), ("port", PORT)):
        d = tmp_path / tag
        d.mkdir()
        got = case(P, d, capsys) if capsys is not None else case(P, d)
        # The program's own name is the one word the two CLIs differ by.
        out[tag] = _canon(got).replace(str(d), "<tmp>").replace(
            "pbst-torch", "pbst")
    assert out["port"] == out["ref"]


def _quick_frontier(P, workload="contended"):
    return P.tune.successive_halving(
        workload, "feedback", configs=P.tune.QUICK_SPACE["feedback"],
        rungs=P.tune.QUICK_RUNGS)


# -- twins of tests/test_tune.py --------------------------------------------


def c_score_orders_sanely(P, d):
    base = {"jain_fairness": 0.9, "wait_p99_us": 1000.0,
            "switches_per_s": 3000.0}
    sc = P.tune.score_cell
    assert sc({**base, "jain_fairness": 0.95}) > sc(base)
    assert sc({**base, "wait_p99_us": 4000.0}) < sc(base)
    assert sc({**base, "switches_per_s": 30000.0}) < sc(base)
    return [sc(base), P.tune.score_reports([base, base]),
            P.tune.score_reports([])]


def c_search_space_leads_with_reference_constants(P, d):
    first = P.tune.SEARCH_SPACE["feedback"][0]
    assert first == {"min_us": 100, "max_us": 1_100, "window": 5,
                     "grow_step_us": 100,
                     "qdelay_threshold_ns": 2_000_000, "gw_hot_after": 3}
    return [P.tune.SEARCH_SPACE, P.tune.QUICK_SPACE,
            [list(r.__dict__.values()) for r in P.tune.RUNGS],
            [list(r.__dict__.values()) for r in P.tune.QUICK_RUNGS],
            P.tune.ETA, P.tune.CHECK_HORIZON_NS, P.tune.CHECK_REPS,
            P.tune.CHECK_TENANTS, P.tune.P99_WEIGHT_PER_MS,
            P.tune.SWITCH_WEIGHT_PER_S]


def c_quick_halving_is_deterministic(P, d):
    a = _quick_frontier(P)
    b = _quick_frontier(P)
    assert a == b
    assert a["winner"]["params"] in P.tune.QUICK_SPACE["feedback"]
    assert len(a["rungs"]) == len(P.tune.QUICK_RUNGS)
    return a


def c_profile_roundtrip_reproduces_tuned_score(P, d):
    frontier = _quick_frontier(P)
    path = P.tune.write_profile("contended", frontier, tuned_dir=str(d))
    prof = P.tune.load_profile("contended", str(d))
    assert prof["params"] == frontier["winner"]["params"]
    verdict = P.tune.check_profile("contended", str(d))
    assert verdict["ok"], verdict
    assert verdict["got_score_x1e6"] == prof["check"]["score_x1e6"]
    with open(path) as f:
        assert json.load(f) == prof
    prof["check"].pop("tier")  # provenance: the reference may be native
    verdict.pop("recorded_tier"), verdict.pop("verified_tier")
    return [prof, verdict]


def c_profile_loads_into_policy(P, d):
    frontier = _quick_frontier(P)
    P.tune.write_profile("contended", frontier, tuned_dir=str(d))
    part = P.rt.Partition("t", source=P.tel.SimBackend(), scheduler="credit")
    pol = P.tune.policy_from_profile(part, "contended", str(d))
    params = frontier["winner"]["params"]
    assert isinstance(pol, P.feedback.FeedbackPolicy)
    assert (pol.min_us, pol.max_us) == (params["min_us"], params["max_us"])
    assert pol.window_len == params["window"]
    assert pol.grow_step_us == params["grow_step_us"]
    assert pol.qdelay_threshold_ns == params["qdelay_threshold_ns"]
    assert pol.gw_hot_after == params["gw_hot_after"]
    return params


def c_from_profile_rejects_unknown_params(P, d):
    part = P.rt.Partition("t", source=P.tel.SimBackend(), scheduler="credit")
    with pytest.raises(KeyError) as e:
        P.feedback.FeedbackPolicy.from_profile(part,
                                               {"params": {"nonesuch": 1}})
    return str(e.value)


def c_checked_in_profiles_cover_catalog(P, d):
    assert P.tune.tuned_workloads() == sorted(P.tune.TUNED_WORKLOADS)
    out = []
    for wl in P.tune.TUNED_WORKLOADS:
        prof = P.tune.load_profile(wl)
        assert prof["policy"] in P.tune.SEARCH_SPACE
        assert set(prof["params"]) == \
            set(P.feedback.FeedbackPolicy.TUNABLE_PARAMS) \
            - {"stall_threshold", "shrink_sub_us"}
        assert prof["check"]["digest"]
        out.append(prof)
    return out


def c_check_profile_worker_parity(P, d):
    inline = P.tune.check_profile("contended", workers=1)
    fanned = P.tune.check_profile("contended", workers=2)
    assert inline == fanned
    assert inline["ok"]
    inline.pop("verified_tier")
    return inline


def c_cli_tune_check_quick_smoke(P, d, capsys):
    main = P.cli.main
    assert main(["tune", "--check", "--quick", "--json"]) == 0
    out1 = capsys.readouterr().out
    assert main(["tune", "--check", "--quick", "--json"]) == 0
    out2 = capsys.readouterr().out
    assert out1 == out2
    doc = json.loads(out1)
    assert doc["ok"] is True
    assert {p["workload"] for p in doc["profiles"]} == \
        set(P.tune.TUNED_WORKLOADS)
    doc.pop("native")
    for v in doc["profiles"]:
        v.pop("verified_tier")
    return doc


def c_cli_tune_check_fails_on_drift(P, d, capsys):
    frontier = _quick_frontier(P)
    path = P.tune.write_profile("contended", frontier, tuned_dir=str(d))
    prof = json.loads(open(path).read())
    prof["params"]["window"] = 2
    with open(path, "w") as f:
        json.dump(prof, f)
    rc = P.cli.main(["tune", "--check", "--workload", "contended",
                     "--tuned-dir", str(d)])
    assert rc == 1
    out = capsys.readouterr().out
    assert "DIGEST MISMATCH" in out
    return out.split(" [recorded on")[0].splitlines()[0]


def c_cli_tune_usage_errors(P, d, capsys):
    main = P.cli.main
    errs = []
    for argv, words in (
            (["tune", "--workload", "nope"], "unknown workload"),
            (["tune", "--policy", "nope"], "no search space"),
            (["tune", "--check", "--write"], "mutually exclusive"),
            (["tune", "--workload", "contended", "--quick", "--write"],
             "refusing")):
        assert main(argv) == 2
        err = capsys.readouterr().err
        assert words in err
        errs.append(err.split(":", 1)[1])
    return errs


def c_cli_tune_quick_write_allowed_to_explicit_dir(P, d, capsys):
    assert P.cli.main(["tune", "--workload", "contended", "--quick",
                       "--write", "--tuned-dir", str(d)]) == 0
    assert (d / "contended.json").exists()
    capsys.readouterr()
    prof = json.loads((d / "contended.json").read_text())
    prof["check"].pop("tier")
    return prof


def c_cli_tune_quick_search_table(P, d, capsys):
    assert P.cli.main(["tune", "--workload", "contended", "--quick"]) == 0
    out = capsys.readouterr().out
    assert "contended" in out and "score" in out
    return out


TWIN_CASES = [
    c_score_orders_sanely, c_search_space_leads_with_reference_constants,
    c_quick_halving_is_deterministic,
    c_profile_roundtrip_reproduces_tuned_score,
    c_profile_loads_into_policy, c_from_profile_rejects_unknown_params,
    c_checked_in_profiles_cover_catalog, c_check_profile_worker_parity,
]
CLI_CASES = [
    c_cli_tune_check_quick_smoke, c_cli_tune_check_fails_on_drift,
    c_cli_tune_usage_errors, c_cli_tune_quick_write_allowed_to_explicit_dir,
    c_cli_tune_quick_search_table,
]


@pytest.mark.parametrize("case", TWIN_CASES, ids=lambda c: c.__name__)
def test_tune_case_twin(case, tmp_path):
    _twin(case, tmp_path)


@pytest.mark.parametrize("case", CLI_CASES, ids=lambda c: c.__name__)
def test_tune_cli_case_twin(case, tmp_path, capsys):
    _twin(case, tmp_path, capsys)


@pytest.mark.slow
def test_full_space_halving_deterministic_across_workers_twin():
    frontiers = []
    for P in (REF, PORT):
        a = P.tune.successive_halving("contended", "feedback", workers=1)
        b = P.tune.successive_halving("contended", "feedback", workers=4)
        assert a == b
        frontiers.append(a)
    assert _canon(frontiers[1]) == _canon(frontiers[0])


# -- across packages ---------------------------------------------------------


def _require_sim_tier(tier: str) -> None:
    """Skip, naming the cached reason, where the toolchain cannot give
    the port's native sim core this binding tier."""
    from pbs_tpu_torch.runtime import native as port_native
    from pbs_tpu_torch.sim import native_core

    if native_core.available_tier(tier) is None:
        pytest.skip(f"native sim tier {tier} unavailable: "
                    f"{port_native.last_failure()}")


@pytest.mark.parametrize("tier", [False, "ctypes", "fastcall"])
@pytest.mark.parametrize("workload", list(REF.tune.TUNED_WORKLOADS))
def test_copied_profile_passes_the_port_s_check(workload, tier):
    """Each copied profile's check digest replays on the port's Python
    witness tier and on both of its native binding tiers."""
    if tier:
        _require_sim_tier(tier)
    with open(PORT.tune.profile_path(workload), "rb") as a, \
            open(REF.tune.profile_path(workload), "rb") as b:
        assert a.read() == b.read()
    got = PORT.tune.check_profile(workload, native=tier)
    assert got["ok"], got
    assert got["got_digest"] == PORT.tune.load_profile(
        workload)["check"]["digest"]
    assert got["verified_tier"] == (tier or "python")
    want = REF.tune.check_profile(workload)
    for v in (got, want):
        v.pop("verified_tier")
    assert got == want


@pytest.mark.parametrize("policy", sorted(REF.tune.QUICK_SPACE))
@pytest.mark.parametrize("workload", list(REF.tune.TUNED_WORKLOADS))
def test_quick_frontier_equals_the_reference(workload, policy):
    frontiers = [P.tune.successive_halving(
        workload, policy, configs=P.tune.QUICK_SPACE[policy],
        rungs=P.tune.QUICK_RUNGS) for P in (REF, PORT)]
    assert _canon(frontiers[1]) == _canon(frontiers[0])


def test_written_profiles_are_byte_identical(tmp_path):
    """Both packages write the same profile from one frontier, bytes
    apart from the check block's tier provenance."""
    texts = []
    for P in (REF, PORT):
        d = tmp_path / P.root
        path = P.tune.write_profile("serving", _quick_frontier(P, "serving"),
                                    tuned_dir=str(d))
        prof = json.loads(open(path).read())
        texts.append(open(path).read().replace(
            f'"tier": "{prof["check"]["tier"]}"', '"tier": "<tier>"'))
    assert texts[1] == texts[0]


def test_evaluate_params_equals_the_reference():
    sets = [REF.tune.QUICK_SPACE["feedback"][0],
            json.loads(open(REF.tune.profile_path("serving")).read())[
                "params"], {"min_us": 100, "max_us": 100}]
    got = [P.tune.evaluate_params("serving", "feedback", sets)
           for P in (REF, PORT)]
    assert got[1] == got[0]


def test_cli_tune_check_quick_json_equals_the_reference(capsys):
    docs = []
    for P in (REF, PORT):
        assert P.cli.main(["tune", "--check", "--quick", "--json"]) == 0
        docs.append(json.loads(capsys.readouterr().out))
    stamp = docs[1].pop("native")
    docs[0].pop("native")
    from pbs_tpu_torch.runtime import native as port_native

    assert stamp["native_available"] is port_native.available()
    assert stamp["native_tier"] == (port_native.tier()
                                    if port_native.available() else None)
    for v in (*docs[0]["profiles"], *docs[1]["profiles"]):
        assert v.pop("verified_tier") in ("python", "fastcall", "ctypes")
    assert docs[1] == docs[0]
