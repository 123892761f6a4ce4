"""``pbs_tpu_torch.perf`` against ``pbs_tpu.perf``.

The 21 cases of ``tests/test_perf_harness.py`` as functions of a
package, run on both with the reference test's own assertions; their
observables (bench names, report keys and stamps, gate verdicts, the
baseline documents' maps) must be equal. No case times the host against
a stored baseline: the reference's two quick-check smokes gate a fresh
measurement against numbers taken on another host, which fails on a
slower one. Their twins record a quick matrix, write it to ``tmp_path``
as a baseline, and run the gate's CLI tail over those recorded numbers.
The full-matrix case stays ``slow``, as in the reference, and does the
same at full op counts.

Each package's ``baseline.json`` is its own: the port's holds numbers
recorded on the card host's CPU with their stamp, never the
reference's (``test_port_baseline_is_its_own``).
"""

from __future__ import annotations

import importlib
import json
import os
import types

import pytest

pytest.importorskip("jax", reason="parity tests need the JAX reference")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ns(root: str) -> types.SimpleNamespace:
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    return types.SimpleNamespace(
        root=root, perf=mod("perf"), report=mod("perf.report"),
        bench=mod("perf.bench"), main=mod("cli.pbst").main,
        native=mod("runtime.native"))


REF = _ns("pbs_tpu")
PORT = _ns("pbs_tpu_torch")

def _require_native(P):
    if not P.native.available():
        pytest.skip(f"native runtime unavailable: "
                    f"{P.native.unavailable_reason()}")


def _shape(doc: dict) -> dict:
    """A report without its measurements: keys, stamps, bench names."""
    return {"keys": sorted(doc), "stamp": {k: doc[k] for k in sorted(doc)
                                          if k != "benches"},
            "benches": {n: sorted(r) for n, r in doc["benches"].items()}}


def c_bench_registry_names(P, tmp, capsys):
    assert {"trace.emit", "trace.emit_many", "trace.consume",
            "span.emit", "hist.record", "hist.record_many",
            "ledger.snapshot_many", "fairqueue.cycle",
            "journal.append", "gateway.pump", "sim.smoke",
            "sim.sustained", "sweep.cell", "hwtelem.sample",
            "rpc.roundtrip"} == set(P.perf.bench_names())
    assert set(P.perf.bench_names(native=True)) == set(P.perf.NATIVE_BENCHES)
    assert set(P.perf.NATIVE_BENCHES) <= set(P.perf.bench_names())
    return [P.perf.bench_names(), P.perf.bench_names(native=True),
            {n: v[1:] for n, v in P.perf.BENCHES.items()},
            P.bench.CHECK_THRESHOLDS]


def c_run_bench_shape_and_sanity(P, tmp, capsys):
    r = P.perf.run_bench("trace.emit_many", quick=True, rounds=1)
    d = r.as_dict()
    assert set(d) == {"ops", "rounds", "ns_per_op", "ops_per_s",
                      "alloc_blocks_per_op", "alloc_peak_kib"}
    assert d["ops"] > 0 and d["ns_per_op"] > 0
    assert d["ns_per_op"] < 1000
    return [sorted(d), d["ops"], d["rounds"]]


def c_unknown_bench_is_keyerror(P, tmp, capsys):
    with pytest.raises(KeyError) as a:
        P.perf.run_bench("nonesuch")
    with pytest.raises(KeyError) as b:
        P.perf.run_benches(["trace.emit", "nonesuch"])
    return [str(a.value), str(b.value)]


def c_compare_flags_only_large_regressions(P, tmp, capsys):
    results = {"benches": {"a": {"ns_per_op": 100.0},
                           "b": {"ns_per_op": 100.0},
                           "c": {"ns_per_op": 100.0}}}
    baseline = {"benches": {"a": {"ns_per_op": 60.0},
                            "b": {"ns_per_op": 10.0},
                            "x": {"ns_per_op": 1.0}}}
    regs = P.perf.compare_to_baseline(results, baseline, threshold=2.0)
    assert [r["bench"] for r in regs] == ["b"]
    assert regs[0]["ratio"] == 10.0
    return regs


def c_checked_in_baseline_is_loadable_and_complete(P, tmp, capsys):
    base = P.perf.load_baseline()
    assert set(base["benches"]) == set(P.perf.bench_names())
    assert set(base["quick_benches"]) == set(P.perf.bench_names())
    assert set(base["native_benches"]) == set(P.perf.NATIVE_BENCHES)
    assert set(base["native_quick_benches"]) == set(P.perf.NATIVE_BENCHES)
    for mode in ("benches", "quick_benches", "native_benches",
                 "native_quick_benches"):
        for name, rec in base[mode].items():
            assert rec["ns_per_op"] > 0, (mode, name)
    return {mode: sorted(base[mode]) for mode in (
        "benches", "quick_benches", "native_benches",
        "native_quick_benches")}


def c_quick_results_compare_against_quick_baseline(P, tmp, capsys):
    results = {"quick": True, "benches": {"a": {"ns_per_op": 100.0}}}
    baseline = {"benches": {"a": {"ns_per_op": 10.0}},
                "quick_benches": {"a": {"ns_per_op": 90.0}}}
    assert P.perf.compare_to_baseline(results, baseline, threshold=2.0) == []
    results["quick"] = False
    regs = P.perf.compare_to_baseline(results, baseline, threshold=2.0)
    assert [r["bench"] for r in regs] == ["a"]
    return regs


def c_native_results_only_compare_against_native_maps(P, tmp, capsys):
    results = {"native": True, "benches": {"a": {"ns_per_op": 100.0}}}
    baseline = {"benches": {"a": {"ns_per_op": 1000.0}},
                "native_benches": {"a": {"ns_per_op": 10.0}}}
    regs = P.perf.compare_to_baseline(results, baseline, threshold=2.0)
    assert [r["bench"] for r in regs] == ["a"]
    assert P.perf.compare_to_baseline(
        results, {"benches": {"a": {"ns_per_op": 10.0}}}, 2.0) == []
    return regs


def c_wall_clock_benches_get_wider_armor(P, tmp, capsys):
    baseline = {"benches": {"rpc.roundtrip": {"ns_per_op": 100.0}}}
    ok = {"benches": {"rpc.roundtrip": {"ns_per_op": 300.0}}}
    bad = {"benches": {"rpc.roundtrip": {"ns_per_op": 500.0}}}
    assert P.perf.compare_to_baseline(ok, baseline, threshold=2.0) == []
    regs = P.perf.compare_to_baseline(bad, baseline, threshold=2.0)
    assert [r["bench"] for r in regs] == ["rpc.roundtrip"]
    assert regs[0]["threshold"] == 4.0
    return regs


def _record_and_gate(P, tmp, capsys, extra: list[str], native: bool):
    """Record a matrix through the CLI, write it to ``tmp`` as the
    baseline, and run the gate's tail over the recorded numbers."""
    assert P.main(["perf", *extra, "--json"]) == 0
    d = json.loads(capsys.readouterr().out)
    path = str(tmp / "recorded.json")
    quick = d["quick"]
    P.perf.save_baseline({**d, "quick": False} if quick else d, path,
                         quick_results=d if quick else None)
    assert P.report.main_check(d, path, 2.0) == 0
    assert P.perf.compare_to_baseline(
        d, P.perf.load_baseline(path)) == []
    assert d["native"] is native
    return d


def c_cli_perf_quick_check_smoke(P, tmp, capsys):
    """The tier-1 gate, over numbers recorded here."""
    d = _record_and_gate(P, tmp, capsys, ["--quick"], native=False)
    assert d["version"] == 1 and d["quick"] is True
    assert set(d["benches"]) == set(P.perf.bench_names())
    return _shape(d)


def c_cli_perf_check_fails_on_regression(P, tmp, capsys):
    fake = tmp / "baseline.json"
    fake.write_text(json.dumps({
        "version": 1,
        "benches": {"trace.emit_many": {"ns_per_op": 0.001}}}))
    rc = P.main(["perf", "--bench", "trace.emit_many", "--quick",
                 "--baseline", str(fake), "--check", "--json"])
    assert rc == 1
    cap = capsys.readouterr()
    assert "PERF REGRESSION" in cap.err
    return _shape(json.loads(cap.out))


def c_cli_perf_rejects_quick_baseline_update(P, tmp, capsys):
    out = tmp / "b.json"
    rc = P.main(["perf", "--quick", "--update-baseline",
                 "--baseline", str(out)])
    assert rc == 2 and not out.exists()
    return capsys.readouterr().err.split(":", 1)[1]


def c_cli_perf_unknown_bench_usage_error(P, tmp, capsys):
    assert P.main(["perf", "--bench", "nonesuch", "--quick"]) == 2
    err = capsys.readouterr().err
    assert "unknown bench" in err
    return err.split(":", 1)[1]


def c_cli_perf_update_baseline_roundtrip(P, tmp, capsys):
    out = tmp / "b.json"
    assert P.main(["perf", "--bench", "trace.consume",
                   "--baseline", str(out), "--update-baseline"]) == 0
    assert P.main(["perf", "--bench", "trace.consume",
                   "--baseline", str(out), "--check"]) == 0
    doc = json.loads(out.read_text())
    assert set(doc["benches"]) == {"trace.consume"}
    assert set(doc["quick_benches"]) == {"trace.consume"}
    return [sorted(doc), sorted(doc["benches"]["trace.consume"])]


def c_partial_baseline_update_merges_not_replaces(P, tmp, capsys):
    out = str(tmp / "b.json")
    P.perf.save_baseline({"benches": {"a": {"ns_per_op": 1.0}}}, out,
                         quick_results={"benches": {"a": {"ns_per_op": 2.0}}})
    P.perf.save_baseline({"benches": {"b": {"ns_per_op": 3.0}}}, out,
                         quick_results={"benches": {"b": {"ns_per_op": 4.0}}})
    doc = json.loads(open(out).read())
    assert doc["benches"] == {"a": {"ns_per_op": 1.0},
                              "b": {"ns_per_op": 3.0}}
    assert doc["quick_benches"] == {"a": {"ns_per_op": 2.0},
                                    "b": {"ns_per_op": 4.0}}
    return [doc["benches"], doc["quick_benches"], doc["version"]]


def c_full_matrix_check_against_baseline(P, tmp, capsys):
    """The full bench matrix, gated against its own recorded numbers."""
    results = P.perf.run_benches()
    path = str(tmp / "full.json")
    P.perf.save_baseline(results, path)
    regs = P.perf.compare_to_baseline(results, P.perf.load_baseline(path))
    assert regs == [], regs
    return _shape(results)


def c_baseline_checked_into_package(P, tmp, capsys):
    assert os.path.exists(P.report.baseline_path())
    return os.path.relpath(P.report.baseline_path(), REPO).split(
        os.sep, 1)[1]


def c_report_carries_native_stamp(P, tmp, capsys):
    assert P.main(["perf", "--bench", "trace.emit_many", "--quick",
                   "--json"]) == 0
    d = json.loads(capsys.readouterr().out)
    assert d["native"] is False and d["native_mode"] == "python"
    assert isinstance(d["native_available"], bool)
    if d["native_available"]:
        assert d["native_tier"] in ("fastcall", "ctypes")
    else:
        assert d["native_error"]
    return _shape(d)


def c_cli_perf_native_quick_check_smoke(P, tmp, capsys):
    """The native twin of the tier-1 gate, over numbers recorded here."""
    _require_native(P)
    d = _record_and_gate(P, tmp, capsys, ["--quick", "--native"],
                         native=True)
    assert d["native_mode"] == "native"
    assert set(d["benches"]) == set(P.perf.NATIVE_BENCHES)
    return _shape(d)


def c_native_bench_without_native_path_is_usage_error(P, tmp, capsys):
    _require_native(P)
    assert P.main(["perf", "--native", "--bench", "rpc.roundtrip",
                   "--quick"]) == 2
    err = capsys.readouterr().err
    assert "rpc.roundtrip" in err and "unknown bench" in err
    return err.split(":", 1)[1]


def c_cli_perf_native_unavailable_is_explicit(P, tmp, capsys):
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(P.native, "available", lambda: False)
        mp.setattr(P.native, "unavailable_reason",
                   lambda: "make exited 2: g++: not found")
        assert P.main(["perf", "--native", "--bench", "trace.emit",
                       "--quick"]) == 2
    finally:
        mp.undo()
    err = capsys.readouterr().err
    assert "g++: not found" in err
    return err.split(":", 1)[1]


def c_update_baseline_native_writes_native_maps(P, tmp, capsys):
    _require_native(P)
    out = tmp / "b.json"
    assert P.main(["perf", "--bench", "trace.consume", "--baseline",
                   str(out), "--update-baseline"]) == 0
    assert P.main(["perf", "--native", "--bench", "trace.consume",
                   "--baseline", str(out), "--update-baseline"]) == 0
    doc = json.loads(out.read_text())
    assert set(doc["benches"]) == {"trace.consume"}
    assert set(doc["native_benches"]) == {"trace.consume"}
    assert set(doc["native_quick_benches"]) == {"trace.consume"}
    assert P.main(["perf", "--native", "--bench", "trace.consume",
                   "--baseline", str(out), "--check"]) == 0
    return sorted(k for k in doc if k.endswith("benches"))


CASES = [
    c_bench_registry_names, c_run_bench_shape_and_sanity,
    c_unknown_bench_is_keyerror, c_compare_flags_only_large_regressions,
    c_checked_in_baseline_is_loadable_and_complete,
    c_quick_results_compare_against_quick_baseline,
    c_native_results_only_compare_against_native_maps,
    c_wall_clock_benches_get_wider_armor, c_cli_perf_quick_check_smoke,
    c_cli_perf_check_fails_on_regression,
    c_cli_perf_rejects_quick_baseline_update,
    c_cli_perf_unknown_bench_usage_error,
    c_cli_perf_update_baseline_roundtrip,
    c_partial_baseline_update_merges_not_replaces,
    pytest.param(c_full_matrix_check_against_baseline,
                 marks=pytest.mark.slow),
    c_baseline_checked_into_package, c_report_carries_native_stamp,
    c_cli_perf_native_quick_check_smoke,
    c_native_bench_without_native_path_is_usage_error,
    c_cli_perf_native_unavailable_is_explicit,
    c_update_baseline_native_writes_native_maps,
]


def _case_id(c) -> str:
    fn = c.values[0] if hasattr(c, "values") else c
    return fn.__name__


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_perf_case_twin(case, tmp_path, capsys):
    got = []
    for tag, P in (("ref", REF), ("port", PORT)):
        d = tmp_path / tag
        d.mkdir()
        got.append(case(P, d, capsys))
    assert got[1] == got[0]


def test_case_list_covers_the_reference_file():
    """One case here for each of the reference file's 21 tests."""
    import ast

    tree = ast.parse(open(os.path.join(REPO, "tests",
                                       "test_perf_harness.py")).read())
    ref_tests = sorted(n.name[5:] for n in tree.body
                       if isinstance(n, ast.FunctionDef)
                       and n.name.startswith("test_"))
    assert len(ref_tests) == len(CASES) == 21
    assert sorted(_case_id(c)[2:] for c in CASES) == ref_tests


def test_port_baseline_is_its_own():
    """The port's baseline was recorded on the card host: it carries the
    card's name and power limit, the CPU, torch's version and the native
    tier, and shares no number with the reference's file."""
    port = PORT.perf.load_baseline()
    ref = REF.perf.load_baseline()
    host = port["host"]
    assert {"python", "machine", "cpu", "card", "torch",
            "native_tier"} <= set(host)
    assert "H100" in host["card"] and host["card"].endswith("W")
    assert host["native_tier"] in ("fastcall", "ctypes")
    for mode in ("benches", "quick_benches", "native_benches",
                 "native_quick_benches"):
        for name, rec in port[mode].items():
            assert rec["ns_per_op"] != ref[mode][name]["ns_per_op"], (
                mode, name)


def test_save_baseline_stamps_the_host(tmp_path):
    """``save_baseline`` writes :func:`host_stamp` as the file's host;
    the stamp reads torch's version without importing it."""
    import sys

    path = str(tmp_path / "b.json")
    PORT.perf.save_baseline({"benches": {"a": {"ns_per_op": 1.0}}}, path)
    host = json.load(open(path))["host"]
    assert host == PORT.perf.host_stamp()
    assert host["torch"] and host["cpu"]
    code = ("import sys; from pbs_tpu_torch.perf import host_stamp; "
            "host_stamp(); print('torch' in sys.modules)")
    import subprocess

    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.stdout.strip() == "False", out.stderr[-2000:]


def test_baseline_ships_as_package_data():
    text = open(os.path.join(REPO, "pyproject.toml")).read()
    line = next(ln for ln in text.splitlines()
                if ln.startswith("pbs_tpu_torch = ["))
    block = text[text.index(line):text.index("]", text.index(line))]
    assert '"perf/baseline.json"' in block
