"""``pbs_tpu_torch.obs.selftest`` against ``pbs_tpu.obs.selftest``.

The five cases of ``tests/test_selftest.py`` as functions of a package,
run on both with the reference test's own assertions. Their observables
are the canary names, the thresholds and the verdicts, never the times:
both packages' canaries pass, and for each canary the reference's
variants are among the port's. The port's extra rows are its other
tiers (``ctypes`` beside the fastcall module, ``python`` beside the
native trace ring and doorbell), pinned by
``test_port_canaries_run_on_every_tier``.
"""

from __future__ import annotations

import importlib
import types

import pytest

pytest.importorskip("jax", reason="parity tests need the JAX reference")


def _ns(root: str) -> types.SimpleNamespace:
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    return types.SimpleNamespace(root=root, st=mod("obs.selftest"),
                                 cli=mod("cli.pbst"),
                                 native=mod("runtime.native"))


REF = _ns("pbs_tpu")
PORT = _ns("pbs_tpu_torch")


def _shape(results) -> dict:
    out: dict = {}
    for r in results:
        out.setdefault(r.name, set()).add(r.variant)
    return out


def c_canaries_pass_in_ci(P):
    results = P.st.run_selftest(n=500)
    names = {(r.name, r.variant) for r in results}
    assert ("ledger_resume_suspend", "python") in names
    assert ("ledger_snapshot", "python") in names
    assert any(r.name == "trace_emit" for r in results)
    for r in results:
        assert r.ok, r.row()
    assert P.st.selftest_ok(results)
    return _shape(results)


def c_native_variant_covered_when_runtime_present(P):
    results = P.st.run_selftest(n=200)
    if P.native.load() is not None:
        assert any(r.variant == "native" and r.name == "ledger_snapshot"
                   for r in results)
    return _shape(results)


def c_canary_detects_regression(P):
    results = P.st.run_selftest(thresholds={"ledger_snapshot": 0.0001},
                                n=100)
    snap = [r for r in results if r.name == "ledger_snapshot"]
    assert snap and not all(r.ok for r in snap)
    assert not P.st.selftest_ok(results)
    return sorted({(r.name, r.ok) for r in results})


def c_cli_surface(P):
    assert P.cli.main(["selftest", "-n", "100"]) == 0


def c_result_row_format(P):
    r = P.st.CanaryResult("x", "python", 10, 5.0,
                          P.st.DEFAULT_THRESHOLDS_NS["trace_emit"])
    assert "ok" in r.row()
    return r.row()


CASES = [c_canaries_pass_in_ci, c_native_variant_covered_when_runtime_present,
         c_canary_detects_regression, c_cli_surface, c_result_row_format]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__)
def test_selftest_case_twin(case, capsys):
    ref, port = case(REF), case(PORT)
    capsys.readouterr()
    if isinstance(ref, dict):
        assert set(port) == set(ref)
        for name, variants in ref.items():
            assert variants <= port[name], (name, variants, port[name])
    else:
        assert port == ref


def test_thresholds_are_the_reference_s():
    assert PORT.st.DEFAULT_THRESHOLDS_NS == REF.st.DEFAULT_THRESHOLDS_NS


def test_port_canaries_run_on_every_tier():
    """Each canary has a row per tier the host reaches: python always;
    native and, beside the fastcall module, ctypes when the runtime
    builds (the doorbell has no fastcall tier)."""
    tiers = [v for v, _ in PORT.st.tiers()]
    shape = _shape(PORT.st.run_selftest(n=50))
    for name in ("ledger_resume_suspend", "ledger_snapshot", "trace_emit"):
        assert shape[name] == set(tiers)
    assert shape["doorbell_send_take"] == set(tiers) - {"ctypes"}
    if PORT.native.available():
        assert "native" in tiers
