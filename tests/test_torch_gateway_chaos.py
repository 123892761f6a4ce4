"""``pbs_tpu_torch.gateway.chaos.run_gateway_chaos`` against the
reference's: twins of ``tests/test_gateway_chaos.py``.

The same fixed-seed scenario (mixed, seed 0, 3 backends, 4 tenants, 160
ticks under ``FaultPlan.gateway(0)``) runs through both packages: the
port must reproduce the reference test's golden fault-trace digest as
it stands and the whole report (books, spans, SLO view), and hold the
same invariants (nothing admitted lost under injected sheds, stalls,
misroutes and a mid-run backend kill). The CLI twin is ``pbst-torch
chaos --plan gateway``. The reference's ``pbst gateway demo`` cases have
no twin: the port's CLI has no ``gateway`` command (ROADMAP item 10).
"""

from __future__ import annotations

import json

import pytest

from pbs_tpu.cli.pbst import main as ref_main
from pbs_tpu.faults import FaultPlan as RefPlan
from pbs_tpu.faults import injector as ref_faults
from pbs_tpu.gateway import run_gateway_chaos as ref_run
from pbs_tpu_torch.cli.pbst import main as port_main
from pbs_tpu_torch.faults import FaultPlan as PortPlan
from pbs_tpu_torch.faults import injector as port_faults
from pbs_tpu_torch.gateway import run_gateway_chaos as port_run
from pbs_tpu_torch.sim.workload import workload_names

#: The reference test's golden digest (tests/test_gateway_chaos.py),
#: for (mixed, seed=0, 3 backends, 4 tenants, 160 ticks) under
#: FaultPlan.gateway(0).
GOLDEN_GATEWAY_DIGEST = (
    "4ef79af3bcb1dcf7b03cad1cd27a91b61f6560f6ea6db0085e504bb08eff5737")

SMOKE_KW = dict(workload="mixed", seed=0, n_backends=3, n_tenants=4,
                ticks=160)


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    yield
    port_faults.uninstall()
    ref_faults.uninstall()


def _same(a: dict, b: dict) -> None:
    """Two reports of the same scenario: equal as JSON (the plan's
    dict included)."""
    assert json.dumps(a, sort_keys=True, default=str) == \
        json.dumps(b, sort_keys=True, default=str)


def test_gateway_chaos_smoke_invariants_and_golden_digest():
    r = port_run(**SMOKE_KW)
    assert r["problems"] == []
    assert r["ok"] is True
    assert sum(r["faults_fired"].values()) > 0
    assert r["killed_backend"] is not None
    st = r["stats"]
    assert st["admitted"] == st["completed"] > 0
    assert st["requeued"] > 0
    assert st["shed"].get("injected-shed", 0) > 0
    assert r["trace_digest"] == GOLDEN_GATEWAY_DIGEST
    _same(r, ref_run(**SMOKE_KW))


def test_gateway_chaos_shed_rate_deterministic():
    a = port_run(**SMOKE_KW)
    b = port_run(**SMOKE_KW)
    assert a["trace_digest"] == b["trace_digest"]
    assert a["stats"]["shed"] == b["stats"]["shed"]
    assert a["stats"]["requeued"] == b["stats"]["requeued"]
    c = port_run(**{**SMOKE_KW, "seed": 1})
    assert c["trace_digest"] != a["trace_digest"]
    _same(c, ref_run(**{**SMOKE_KW, "seed": 1}))


def test_gateway_chaos_cli_json(capsys):
    argv = ["chaos", "--plan", "gateway", "--workload", "mixed",
            "--seed", "0", "--agents", "3", "--tenants", "4",
            "--rounds", "2", "--json"]
    assert port_main(argv) == 0
    port_doc = json.loads(capsys.readouterr().out)
    assert ref_main(argv) == 0
    assert port_doc == json.loads(capsys.readouterr().out)


def test_gateway_chaos_respects_plan_files(tmp_path):
    spec = {
        "seed": 3,
        "specs": [
            {"point": "gateway.admit", "fault": "shed", "p": 0.5,
             "key": "hbm*", "args": {"retry_after_ns": 1000000}},
        ],
    }
    kw = dict(workload="stable", seed=3, n_backends=2, n_tenants=2,
              ticks=120, kill_backend=False)
    r = port_run(plan=PortPlan.from_dict(spec), **kw)
    assert r["ok"] is True
    assert r["faults_fired"].get("gateway.admit:shed", 0) > 0
    assert set(r["stats"]["shed"]) >= {"injected-shed"}
    _same(r, ref_run(plan=RefPlan.from_dict(spec), **kw))


@pytest.mark.parametrize("seed", [2, 5])
def test_gateway_chaos_obs_export_matches(seed, tmp_path):
    """The span artifacts a run exports are the reference's files."""
    kw = dict(workload="phases", seed=seed, ticks=80)
    port_run(obs_dir=str(tmp_path / "port"), **kw)
    ref_run(obs_dir=str(tmp_path / "ref"), **kw)
    names = sorted(p.name for p in (tmp_path / "ref").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "ref" / name).read_bytes(), name


@pytest.mark.slow
def test_gateway_chaos_soak_full_catalog():
    for name in workload_names():
        a = port_run(workload=name, seed=0, ticks=600)
        assert a["ok"] is True, (name, a["problems"])
        b = ref_run(workload=name, seed=0, ticks=600)
        assert b["trace_digest"] == a["trace_digest"], name


@pytest.mark.slow
def test_gateway_chaos_cli_selfcheck():
    assert port_main(["chaos", "--plan", "gateway", "--seed", "0",
                      "--selfcheck"]) == 0
