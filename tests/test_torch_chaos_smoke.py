"""``pbs_tpu_torch.faults.chaos`` (controller + agents under a seeded
FaultPlan) against ``pbs_tpu``'s: twins of ``tests/test_chaos_smoke.py``.

The port's ``run_chaos`` reproduces the reference's golden digest for
its smoke scenario, and every scenario's whole report equals the
reference's but for the wall-clock facts (retry counts, dedup hits and
replica ages ride the host scheduler in both). The full-catalog soak and
the CLI selfcheck are ``slow``, as the reference marks them.
"""

from __future__ import annotations

import hashlib
import json

import pytest

from pbs_tpu.faults import run_chaos as ref_run_chaos
from pbs_tpu.faults import injector as ref_faults
from pbs_tpu_torch.cli.pbst import main
from pbs_tpu_torch.faults import FaultPlan, run_chaos, tenant_spec_dict
from pbs_tpu_torch.faults import injector as faults
from pbs_tpu_torch.sim.workload import build_workload, workload_names

#: tests/test_chaos_smoke.py's golden: (stable, seed=0, 2 agents, 2
#: tenants, 2 rounds) under FaultPlan.chaos(0).
GOLDEN_SMOKE_DIGEST = (
    "d809f6d4bd0db30cea84f3b85eca3145f99c657f8f587e20915c34581528bbb1")

SMOKE_KW = dict(workload="stable", seed=0, n_agents=2, n_tenants=2,
                rounds=2)


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    yield
    faults.uninstall()
    ref_faults.uninstall()


def test_golden_is_the_reference_tests():
    import test_chaos_smoke

    assert GOLDEN_SMOKE_DIGEST == test_chaos_smoke.GOLDEN_SMOKE_DIGEST


def test_chaos_smoke_invariants_and_golden_digest():
    r = run_chaos(**SMOKE_KW)
    assert r["problems"] == []
    assert r["ok"] is True
    assert sum(r["faults_fired"].values()) > 0
    assert r["round_errors"] == 0
    assert r["ops"]["audited"] is True
    assert r["trace_digest"] == GOLDEN_SMOKE_DIGEST


#: Report keys that depend on the host's timing in either package.
_WALL_CLOCK = ("client_retries", "idem_hits")


@pytest.mark.parametrize("kw", [
    SMOKE_KW,
    dict(workload="mixed", seed=1, n_agents=3, n_tenants=3, rounds=2),
    dict(workload="stable", seed=0, n_agents=2, n_tenants=2, rounds=2,
         plan=None, replicate=False),
], ids=["smoke", "mixed-seed1", "no-replication"])
def test_report_equal_to_the_reference(kw):
    port = run_chaos(**kw)
    ref = ref_run_chaos(**kw)
    for r in (port, ref):
        for k in _WALL_CLOCK:
            r.pop(k)
    assert port == ref


def test_none_plan_digests_the_empty_trace():
    from pbs_tpu.faults import FaultPlan as RefPlan

    port = run_chaos(**SMOKE_KW, plan=FaultPlan(seed=0))
    ref = ref_run_chaos(**SMOKE_KW, plan=RefPlan(seed=0))
    assert port["ok"] and port["faults_fired"] == {}
    assert port["trace_digest"] == ref["trace_digest"] == \
        hashlib.sha256().hexdigest()


def test_tenant_spec_dict_matches_the_reference():
    from pbs_tpu.faults import tenant_spec_dict as ref_spec
    from pbs_tpu.sim.workload import build_workload as ref_build

    for name in workload_names():
        port = [tenant_spec_dict(t) for t in
                build_workload(name, seed=3, n_tenants=4)]
        ref = [ref_spec(t) for t in ref_build(name, seed=3, n_tenants=4)]
        assert port == ref, name


def test_chaos_cli_json_smoke(capsys):
    rc = main(["chaos", "--workload", "stable", "--seed", "0",
               "--agents", "2", "--tenants", "2", "--rounds", "2",
               "--json"])
    assert rc == 0
    report = json.loads(capsys.readouterr().out)
    assert report["ok"] is True
    assert report["trace_digest"] == GOLDEN_SMOKE_DIGEST


def test_chaos_cli_rejects_bad_plan_file(tmp_path):
    bad = tmp_path / "plan.json"
    bad.write_text(json.dumps(
        {"seed": 0, "specs": [{"point": "nope", "fault": "reset"}]}))
    assert main(["chaos", "--plan", str(bad)]) == 2


def test_chaos_cli_plan_file_and_rpc_plan(tmp_path, capsys):
    path = tmp_path / "plan.json"
    path.write_text(json.dumps(FaultPlan.chaos(0).as_dict()))
    assert main(["chaos", "--plan", str(path), "--workload", "stable",
                 "--agents", "2", "--tenants", "2", "--rounds", "2"]) == 0
    assert f"trace_digest={GOLDEN_SMOKE_DIGEST}" in capsys.readouterr().out
    assert main(["chaos", "--plan", "rpc", "--workload", "stable",
                 "--agents", "2", "--tenants", "2", "--rounds", "1",
                 "--no-replication"]) == 0


def test_chaos_trace_file_digest_matches_report(tmp_path):
    path = tmp_path / "trace.jsonl"
    r = run_chaos(**SMOKE_KW, trace_path=str(path))
    h = hashlib.sha256()
    for line in sorted(path.read_text().splitlines()):
        h.update(line.encode())
        h.update(b"\n")
    assert h.hexdigest() == r["trace_digest"]


@pytest.mark.slow
def test_chaos_soak_full_catalog_all_invariants():
    for name in workload_names():
        a = run_chaos(workload=name, seed=0, rounds=4)
        assert a["ok"] is True, (name, a["problems"])
        b = run_chaos(workload=name, seed=0, rounds=4)
        assert b["trace_digest"] == a["trace_digest"], name


@pytest.mark.slow
def test_chaos_cli_selfcheck_default_plan():
    assert main(["chaos", "--seed", "0", "--selfcheck"]) == 0
