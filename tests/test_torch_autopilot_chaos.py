"""The closed loop under the chaos gate, ``run_federation_chaos(autopilot=)``,
in ``pbs_tpu_torch`` against ``pbs_tpu``: twins of
``tests/test_autopilot_chaos.py``.

Each case runs on both packages and holds the reference test's golden
digests (``GOLDEN_AP_TRACE_DIGEST``/``GOLDEN_AP_REPORT_DIGEST``); the
whole report of an armed run is equal across packages for two seeds; the
plain federation run keeps its pre-autopilot goldens; and phase 3a (c)'s
own checks (``chip_smoke.autopilot_chaos_checks``) pass on the host. The
catalog soak stays behind ``slow``, as the reference's does.
"""

from __future__ import annotations

import importlib
import json
import types

import pytest

import chip_smoke

#: The reference test's goldens (tests/test_autopilot_chaos.py), for
#: (mixed, seed=0, 3 gateways, 4 tenants, 240 ticks) under
#: FaultPlan.autopilot(0) with autopilot=True.
GOLDEN_AP_TRACE_DIGEST = (
    "5b3e7d637df0babef9590c9d450de41384c04e8f908298f874452b3a74b223c7")
GOLDEN_AP_REPORT_DIGEST = (
    "bff117e15037e45b2aebaf7cf19448fd1fa84ff8f3c15cbab49898c2db1552fe")
#: tests/test_federation_chaos.py's goldens for the same run unarmed.
GOLDEN_TRACE_DIGEST = (
    "71a188673b85cf80a67a721b247443d22e3776a09ad491fc6a5356553218d6de")
GOLDEN_REPORT_DIGEST = (
    "1ba265a705067e8d8761aaa8d57c23b30e38c25839b29c9f1debf380b5667242")

PLAIN_KW = dict(workload="mixed", seed=0, n_gateways=3, n_tenants=4,
                ticks=240)
SMOKE_KW = dict(PLAIN_KW, autopilot=True)


def _ns(root: str) -> types.SimpleNamespace:
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    gw = mod("gateway")
    return types.SimpleNamespace(
        root=root, run=gw.run_federation_chaos, plan=mod("faults.plan"),
        faults=mod("faults.injector"), ap=mod("autopilot"),
        profile=mod("knobs.profile"), workload=mod("sim.workload"))


REF, PORT = _ns("pbs_tpu"), _ns("pbs_tpu_torch")


@pytest.fixture(params=[REF, PORT], ids=["ref", "port"])
def P(request):
    yield request.param
    request.param.faults.uninstall()


def test_autopilot_chaos_pathological_candidate_rolls_back_golden(P):
    r = P.run(**SMOKE_KW)
    assert r["problems"] == []
    assert r["ok"] is True
    assert r["faults_fired"].get("autopilot.candidate:pathological") == 1
    history = r["autopilot"]["history"]
    assert [e["event"] for e in history] == ["propose", "canary", "rollback"]
    propose, canary, rollback = history
    assert propose["injected"] is True
    assert propose["margin_x1e6"] > 0
    assert rollback["reason"] == "burn"
    assert max(rollback["burns"].values()) > 2.0
    assert rollback["t_ns"] - canary["t_ns"] <= \
        (SMOKE_KW["ticks"] // 3 + 2) * 1_000_000
    ref = r["autopilot"]["status"]["reference"]
    for name, adopted in r["autopilot"]["members"].items():
        for k, v in ref.items():
            assert adopted.get(k) == v, (name, k)
    st = r["stats"]
    assert st["admitted"] == st["completed"] > 0
    assert r["trace_digest"] == GOLDEN_AP_TRACE_DIGEST
    assert r["report_digest"] == GOLDEN_AP_REPORT_DIGEST


def test_autopilot_chaos_rollback_is_deterministic(P):
    a = P.run(**SMOKE_KW)
    b = P.run(**SMOKE_KW)
    assert a["trace_digest"] == b["trace_digest"]
    assert a["report_digest"] == b["report_digest"]
    assert a["autopilot"]["history"] == b["autopilot"]["history"]
    assert a["autopilot"]["knob_adoptions"] == \
        b["autopilot"]["knob_adoptions"]
    c = P.run(**{**SMOKE_KW, "seed": 1})
    assert c["trace_digest"] != a["trace_digest"]
    assert c["ok"] is True


def test_autopilot_disarmed_is_byte_identical_to_plain_federation(P):
    r = P.run(**PLAIN_KW)
    assert "autopilot" not in r
    assert r["trace_digest"] == GOLDEN_TRACE_DIGEST
    assert r["report_digest"] == GOLDEN_REPORT_DIGEST
    for off in (None, False):
        assert P.run(**PLAIN_KW, autopilot=off)["report_digest"] == \
            GOLDEN_REPORT_DIGEST


def test_pathological_params_are_registry_legal(P):
    knobs = P.profile.params_to_knobs("feedback", P.ap.PATHOLOGICAL_PARAMS)
    assert knobs["sched.feedback.tslice_max_us"] == 10


def test_autopilot_plan_validates(P):
    plan = P.plan.FaultPlan.autopilot(0)
    points = {s.point for s in plan.specs}
    assert "autopilot.candidate" in points
    assert "gateway.death" in points


def test_autopilot_config_overrides_reach_the_loop(P):
    """``autopilot`` as a dict overrides the loop's config; the
    harness's cadence fills only what it leaves out."""
    r = P.run(**{**SMOKE_KW, "autopilot": {"max_rounds": 1,
                                           "burn_limit": 2.0}})
    assert r["ok"] is True
    assert r["report_digest"] == GOLDEN_AP_REPORT_DIGEST


@pytest.mark.parametrize("seed", [0, 1])
def test_autopilot_chaos_reports_equal_across_packages(seed):
    got = [Q.run(**{**SMOKE_KW, "seed": seed}) for Q in (REF, PORT)]
    assert json.dumps(got[1], sort_keys=True) == \
        json.dumps(got[0], sort_keys=True)


def test_chaos_phase_checks_on_the_host():
    """Phase 3a (c)'s own code: every check passes (each raises
    ``chip_smoke.Failed``), and its goldens are the reference tests'."""
    out = chip_smoke.autopilot_chaos_checks()
    assert out["report"]["report_digest"] == GOLDEN_AP_REPORT_DIGEST
    assert chip_smoke.GOLDEN_AP_TRACE_DIGEST == GOLDEN_AP_TRACE_DIGEST
    assert chip_smoke.GOLDEN_FED_TRACE_DIGEST == GOLDEN_TRACE_DIGEST
    assert chip_smoke.GOLDEN_FED_REPORT_DIGEST == GOLDEN_REPORT_DIGEST
    assert chip_smoke.AP_CHAOS_KW == PLAIN_KW


@pytest.mark.slow
@pytest.mark.parametrize("root", [REF.root, PORT.root])
def test_autopilot_chaos_catalog_soak(root):
    P = REF if root == REF.root else PORT
    try:
        for workload in P.workload.workload_names():
            for seed in (0, 1):
                kw = dict(workload=workload, seed=seed, n_gateways=3,
                          n_tenants=4, ticks=240, autopilot=True)
                a = P.run(**kw)
                assert a["ok"] is True, (workload, seed, a["problems"])
                events = [e["event"] for e in a["autopilot"]["history"]]
                assert "rollback" in events, (workload, seed, events)
                b = P.run(**kw)
                assert b["trace_digest"] == a["trace_digest"]
                assert b["report_digest"] == a["report_digest"]
    finally:
        P.faults.uninstall()
