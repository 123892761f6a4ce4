"""The perf gate's spaced re-measure and the drift probe it is sized
from (``pbs_tpu_torch.perf.report.main_check``,
``pbs_tpu_torch.perf.drift``). Port-only: the reference re-measures a
flagged bench once, at once.

The re-measure is driven through fake matrix runs and a fake clock, so
no case times the host.
"""

from __future__ import annotations

import json
import types

import pytest

from pbs_tpu_torch.perf import drift, report


def _baseline(tmp_path, ns: dict) -> str:
    path = tmp_path / "baseline.json"
    path.write_text(json.dumps({
        "version": 1, "benches": {},
        "quick_benches": {n: {"ns_per_op": v} for n, v in ns.items()}}))
    return str(path)


@pytest.fixture
def remeasure(monkeypatch):
    """Fake matrix runs: each call takes the next ns/op per bench from
    ``readings``; the gaps between calls are recorded, not slept."""
    state = types.SimpleNamespace(calls=[], sleeps=[], readings={})

    def run_benches(names, quick=False, native=False):
        state.calls.append((list(names), quick, native))
        return {"quick": quick, "native": native, "benches": {
            n: {"ns_per_op": state.readings[n].pop(0)} for n in names}}

    monkeypatch.setattr(report, "run_benches", run_benches)
    monkeypatch.setattr(report, "time", types.SimpleNamespace(
        sleep=state.sleeps.append))
    return state


def test_a_slow_stretch_recovers_on_a_spaced_run(tmp_path, capsys,
                                                 remeasure):
    """Over threshold at the first reading and the next two, fine at the
    fourth: the gate passes, after three gaps of RECHECK_GAP_S."""
    path = _baseline(tmp_path, {"span.emit": 1000.0, "trace.emit": 800.0})
    remeasure.readings = {"span.emit": [2300.0, 2250.0, 2200.0, 1050.0]}
    results = {"quick": True, "benches": {
        "span.emit": {"ns_per_op": 2400.0},
        "trace.emit": {"ns_per_op": 900.0}}}
    assert report.main_check(results, path, 2.0) == 0
    assert [c[0] for c in remeasure.calls] == [["span.emit"]] * 4
    assert remeasure.calls[0][1:] == (True, False)
    assert remeasure.sleeps == [report.RECHECK_GAP_S] * 3
    err = capsys.readouterr().err
    assert "span.emit over threshold once but fine on re-measure" in err
    assert "PERF REGRESSION" not in err


def test_a_cliff_fails_at_its_best_of_every_spaced_run(tmp_path, capsys,
                                                       remeasure):
    """A bench over threshold in every run fails after RECHECK_ROUNDS
    runs, reported at its best reading; a bench that recovers at once
    leaves the later runs."""
    path = _baseline(tmp_path, {"span.emit": 1000.0, "hist.record": 1500.0})
    n = report.RECHECK_ROUNDS
    remeasure.readings = {
        "span.emit": [5000.0 - 100 * i for i in range(n)],
        "hist.record": [1600.0]}
    results = {"quick": True, "benches": {
        "span.emit": {"ns_per_op": 5200.0},
        "hist.record": {"ns_per_op": 3100.0}}}
    assert report.main_check(results, path, 2.0) == 1
    assert [c[0] for c in remeasure.calls] == (
        [["span.emit", "hist.record"]] + [["span.emit"]] * (n - 1))
    assert remeasure.sleeps == [report.RECHECK_GAP_S] * (n - 1)
    err = capsys.readouterr().err
    best = 5000.0 - 100 * (n - 1)
    assert (f"PERF REGRESSION span.emit (reproduced on re-measure): "
            f"{best:.1f} ns/op vs baseline 1000.0") in err
    assert "hist.record over threshold once but fine on re-measure" in err


def test_the_spaced_runs_outlast_the_card_hosts_slow_stretches():
    """Eleven runs three seconds apart span thirty seconds: longer than
    the longest slow stretch ``drift`` measured on the H100 card host
    (19.5 s in 120 s)."""
    span = (report.RECHECK_ROUNDS - 1) * report.RECHECK_GAP_S
    assert span >= 30.0


def test_drift_summary():
    samples = [(0.0, 1000.0), (0.5, 2100.0), (1.0, 2200.0), (2.5, 2050.0),
               (3.0, 1100.0), (3.5, 2500.0)]
    assert drift.summarize(samples, 2.0) == {
        "n": 6, "min": 1000.0, "median": 2075.0, "max": 2500.0,
        "max_over_min": 2.5, "slow_share": 0.667, "longest_slow_s": 2.0}
    assert drift.summarize([(0.0, 5.0)], 2.0)["longest_slow_s"] == 0.0


def test_drift_cli_prints_one_summary(capsys):
    assert drift.main(["--seconds", "0", "--bench", "trace.emit"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["seconds"] == 0 and doc["slow"] == 2.0
    assert list(doc["benches"]) == ["trace.emit"]
    s = doc["benches"]["trace.emit"]
    assert s["n"] == 1 and s["min"] > 0 and s["max_over_min"] == 1.0


def test_drift_gate_trial_records_then_checks(capsys):
    """One trial of the gate from this checkout: a recorded quick
    matrix, then the gate's CLI against it (its verdict depends on the
    host, so only the report's shape is held)."""
    assert drift.main(["--gate", "1", "--bench", "trace.emit"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["benches"] == ["trace.emit"] and doc["native"] is False
    (trial,) = doc["trials"]
    assert sorted(trial) == ["failed", "flagged", "rc", "wall"]
    assert trial["rc"] in (0, 1) and trial["wall"] > 0
    assert set(trial["failed"]) <= set(trial["flagged"]) <= {"trace.emit"}
    assert doc["failed"] == (trial["rc"] != 0)
