"""Crash recovery in ``pbs_tpu_torch.gateway``: twins of
``tests/test_crash_chaos.py``, and phase 3j of ``chip_smoke.py`` on the
host.

- ``run_federation_chaos`` under the stock crash plan (a torn mid-frame
  journal commit and a tick-boundary kill-9, each recovered from
  journal bytes alone) reproduces the reference test's two golden
  digests as they stand and the reference's whole report; the
  mid-frame, mint-bound, exclusive-mode and CLI cases as the
  reference's.
- Phase 3j (a)'s own code, ``chip_smoke.crash_and_recover``, with the
  port's engine at toy width on the CPU (fp32): a seeded
  ``ProcessKill``, recovery from the journal file alone, every admitted
  request done exactly once, each request's tokens equal to the
  uninterrupted run's; the reference's ``replay`` and
  ``recover_gateway`` of the port's journal file give the port's
  ``state_digest`` and ``RecoveryInfo``. Then (b), the federation with a
  canary push, a death, a drain, a rejoin and a crash, and (c), the
  chaos goldens, as the card runs them.
"""

from __future__ import annotations

import dataclasses
import json
import shutil

import pytest

pytest.importorskip("jax", reason="parity tests need the JAX reference")

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from pbs_tpu.cli.pbst import main as ref_main  # noqa: E402
from pbs_tpu.faults import injector as ref_faults  # noqa: E402
from pbs_tpu.gateway import journal as ref_journal  # noqa: E402
from pbs_tpu.gateway import recovery as ref_recovery  # noqa: E402
from pbs_tpu.gateway import run_federation_chaos as ref_run  # noqa: E402
from pbs_tpu.gateway import SimServeBackend as RefSim  # noqa: E402
from pbs_tpu_torch.cli.pbst import main  # noqa: E402
from pbs_tpu_torch.faults import injector as faults  # noqa: E402
from pbs_tpu_torch.gateway import (  # noqa: E402
    run_federation_chaos,
    stock_crash_plan,
)
from pbs_tpu_torch.gateway import recovery as port_recovery  # noqa: E402

torch.set_num_threads(2)

#: The reference test's golden digests (tests/test_crash_chaos.py) for
#: (mixed, seed=0, 3 gateways, 4 tenants, 240 ticks) under
#: FaultPlan.federation(0) + stock_crash_plan(240).
GOLDEN_CRASH_TRACE_DIGEST = (
    "538bba5c03c74c32f2eb43cf46374365f2b445fafc4b704044f4619979e50902")
GOLDEN_CRASH_REPORT_DIGEST = (
    "b65386f357c404918ba70d0db47bf864a060d9d0ac32817f3a6d36d36e6a5782")

SMOKE_KW = dict(workload="mixed", seed=0, n_gateways=3, n_tenants=4,
                ticks=240)


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    yield
    faults.uninstall()
    ref_faults.uninstall()


def _both(**kw) -> dict:
    """The port's report, after asserting it equals the reference's."""
    got = run_federation_chaos(**kw)
    faults.uninstall()
    want = ref_run(**kw)
    ref_faults.uninstall()
    assert json.dumps(got, sort_keys=True, default=str) == \
        json.dumps(want, sort_keys=True, default=str)
    return got


# -- tests/test_crash_chaos.py ------------------------------------------


def test_crash_chaos_smoke_invariants_and_golden_digests():
    r = _both(**SMOKE_KW, crash_plan=stock_crash_plan(240))
    assert r["problems"] == []
    assert r["ok"] is True
    c = r["crash"]
    kinds = [e["kind"] for e in c["events"]]
    assert "journal.crash" in kinds and "process" in kinds
    assert c["recoveries"] == 2
    assert c["final_generation"] == 2
    torn = [e["torn_bytes"] for e in c["events"]
            if e["kind"] == "journal.crash"]
    assert all(t > 0 for t in torn)
    assert sum(e["recovered"] for e in c["events"]) > 0
    assert sum(e["requeued_inflight"] for e in c["events"]) > 0
    st = r["stats"]
    assert st["admitted"] == st["completed"] > 0
    assert r["spans"]["recover_events"] > 0
    assert r["spans"]["complete"] == r["spans"]["chains"] > 0
    assert r["trace_digest"] == GOLDEN_CRASH_TRACE_DIGEST
    assert r["report_digest"] == GOLDEN_CRASH_REPORT_DIGEST


def test_crash_chaos_deterministic():
    a = run_federation_chaos(**SMOKE_KW, crash_plan=stock_crash_plan(240))
    b = run_federation_chaos(**SMOKE_KW, crash_plan=stock_crash_plan(240))
    assert a["trace_digest"] == b["trace_digest"]
    assert a["report_digest"] == b["report_digest"]
    assert a["crash"]["events"] == b["crash"]["events"]
    assert a["lease_audit"] == b["lease_audit"]
    c = _both(**{**SMOKE_KW, "seed": 1}, crash_plan=stock_crash_plan(240))
    assert c["trace_digest"] != a["trace_digest"]


def test_crash_mid_frame_unacked_suffix_reconciled():
    r = _both(**SMOKE_KW, crash_plan=[{"record": 300, "cut": 17}])
    assert r["ok"] is True, r["problems"]
    assert r["crash"]["unacked"] >= 1
    st = r["stats"]
    assert st["admitted"] == st["completed"] > 0


def test_crash_chaos_mint_bound_and_audit_identities():
    r = run_federation_chaos(**SMOKE_KW, crash_plan=stock_crash_plan(240))
    assert r["ok"] is True
    for tenant, a in r["lease_audit"].items():
        assert a["granted"] <= a["minted"] + a["deposited"] + 1e-6, tenant
        accounted = (a["leased_spent"] + a["held"] + a["deposited"]
                     + a["destroyed"])
        assert accounted <= a["granted"] + 1e-6, tenant


def test_crash_plan_requires_journal_exclusive_modes():
    """As the reference's: a crash plan refuses the knob plan and the
    closed tuning loop (the journal covers gateway state, not the knob
    control plane), ``knob_plan`` with ``autopilot=`` is refused before
    that (both own the federation's one knob channel), and an entry
    naming no position is refused. Each error is the reference's
    ``ValueError``, word for word, raised in the same order."""
    knob = [{"tick": 5, "set": {"gateway.admission.rate_scale": 0.5}}]
    cases = [
        (dict(crash_plan=[{"tick": 10}], knob_plan=knob),
         "crash_plan is mutually exclusive with knob_plan"),
        (dict(crash_plan=[{"tick": 10}], autopilot=True),
         "crash_plan is mutually exclusive with knob_plan/autopilot"),
        (dict(crash_plan=[{"tick": 10}], autopilot={}),
         "crash_plan is mutually exclusive with knob_plan/autopilot"),
        (dict(crash_plan=[{"tick": 10}], knob_plan=knob, autopilot=True),
         "knob_plan and autopilot are mutually exclusive"),
        (dict(crash_plan=[{"banana": 1}]), "names none of"),
    ]
    for kw, match in cases:
        msgs = []
        for run in (ref_run, run_federation_chaos):
            with pytest.raises(ValueError, match=match) as ei:
                run(**SMOKE_KW, **kw)
            msgs.append(str(ei.value))
        assert msgs[0] == msgs[1], kw


def test_crash_chaos_cli():
    assert main(["chaos", "--plan", "crash", "--rounds", "2"]) == 0


def test_crash_chaos_cli_json(capsys):
    assert main(["chaos", "--plan", "crash", "--rounds", "2",
                 "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["ok"] is True
    assert doc["crash"]["recoveries"] >= 1
    assert ref_main(["chaos", "--plan", "crash", "--rounds", "2",
                     "--json"]) == 0
    assert json.loads(capsys.readouterr().out) == doc


@pytest.mark.slow
def test_crash_position_soak_every_boundary_class():
    for k in range(0, 1320, 131):
        r = _both(workload="mixed", seed=0, ticks=240,
                  crash_plan=[{"record": k, "cut": 1 + k % 61}])
        assert r["ok"] is True, (k, r["problems"])
        st = r["stats"]
        assert st["admitted"] == st["completed"]


@pytest.mark.slow
def test_crash_chaos_soak_full_catalog():
    from pbs_tpu_torch.sim.workload import workload_names

    for name in workload_names():
        a = _both(workload=name, seed=0, ticks=400,
                  crash_plan=stock_crash_plan(400))
        assert a["ok"] is True, (name, a["problems"])


@pytest.mark.slow
def test_crash_probabilistic_gene_style_kills():
    kw = dict(workload="mixed", seed=3, ticks=300,
              crash_plan=[{"p": 0.02, "times": 3}])
    a = _both(**kw)
    assert a["ok"] is True, a["problems"]
    b = run_federation_chaos(**kw)
    assert b["report_digest"] == a["report_digest"]


# -- phase 3j on the host -------------------------------------------------


def _toy():
    """The port's engine at toy width, fp32 on the CPU, with 3j's slots,
    bucket and slabs (the script's prompts reach 127 tokens)."""
    from pbs_tpu_torch.models import (ContinuousBatcher, TransformerConfig,
                                      init_params)

    cfg = TransformerConfig(vocab=chip_smoke.FLAGSHIP["vocab"], d_model=64,
                            n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128,
                            max_seq=1024, dtype=torch.float32)

    def make_params():
        gen = torch.Generator().manual_seed(chip_smoke.JOURNAL_SEED)
        return init_params(cfg, gen, device="cpu")

    def make_engine(params):
        return ContinuousBatcher(
            cfg, params, n_slots=chip_smoke.ENGINE_SLOTS,
            prompt_bucket=chip_smoke.ENGINE_BUCKET,
            max_len=chip_smoke.ENGINE_MAX_LEN,
            prefix_cache_size=chip_smoke.ENGINE_PREFIX, device="cpu")

    return make_params, make_engine


@pytest.fixture(scope="module")
def crashed(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("journal"))
    make_params, make_engine = _toy()
    reqs, arrivals = chip_smoke.journal_script()
    out = chip_smoke.crash_and_recover(make_params, make_engine, reqs,
                                       arrivals, tmp,
                                       chip_smoke.JOURNAL_KILL_WINDOW)
    chip_smoke.crash_lines(out, "host CPU, no card")
    out["tmp"] = tmp
    return out


def test_crash_and_recover_runs_every_check(crashed):
    """Every check of 3j (a) passed inside the run (each raises
    ``chip_smoke.Failed``); the kill caught work in every state."""
    info = crashed["info"]
    assert crashed["kill_tick"] in range(
        chip_smoke.JOURNAL_KILL_WINDOW[0],
        chip_smoke.JOURNAL_KILL_WINDOW[1] + 1)
    assert crashed["done_at_kill"] and crashed["queued_at_kill"]
    assert info.requeued_inflight and crashed["post"]
    assert info.generation == 1 and info.torn_bytes == 0
    jr = crashed["journal"]
    assert jr["commits"] == jr["frames"] > 0
    assert jr["fsyncs"] == 0  # journal.fsync_every defaults to 0
    assert len(jr["commit_ns"]) == jr["commits"] - 1  # recovery's own
    assert crashed["times"]["first_token_s"] is not None


def test_recovered_tokens_equal_the_uninterrupted_run(crashed):
    """fp32 on the host: a request re-prefilled after the crash, in
    another batch, yields exactly the uninterrupted run's tokens."""
    assert crashed["differ"] == {}
    assert crashed["tokens"] == crashed["ref_tokens"]
    assert len(crashed["tokens"]) == len(chip_smoke.journal_script()[0])


def test_reference_replays_the_port_s_journal(crashed, tmp_path):
    """The reference's reader, replay and ``recover_gateway`` on the
    port's file as the kill left it: the port's digest and
    RecoveryInfo; and on the file after recovery, the same fold."""
    view = ref_journal.read_journal(crashed["at_kill"])
    st = ref_recovery.replay(view.records, 0)
    ref_recovery.apply_recover_transform(st)
    assert ref_recovery.state_digest(st) == crashed["digest"] == \
        crashed["info"].state_digest
    copy = str(tmp_path / "copy.jrnl")
    shutil.copy(crashed["at_kill"], copy)
    _, ref_info = ref_recovery.recover_gateway(copy, [RefSim("engine")])
    assert dataclasses.asdict(ref_info) == dataclasses.asdict(
        crashed["info"])
    final = [P.replay(P.read_journal(crashed["path"]).records, 0)
             for P in (ref_recovery, port_recovery)]
    assert ref_recovery.state_digest(final[0]) == \
        port_recovery.state_digest(final[1])


def test_federation_phase_runs_every_check(tmp_path):
    """3j (b) at toy width: the canary push adopted by exactly its
    member, the busiest member's requests handed off, the crash
    recovered by ``recover_federation``, every lease identity held."""
    make_params, make_engine = _toy()
    params = make_params()
    reqs, _ = chip_smoke.journal_script()
    out = chip_smoke.federation_run(lambda: make_engine(params), reqs,
                                    str(tmp_path))
    chip_smoke.federation_lines(out, "host CPU, no card")
    assert [a["member"] for a in out["adoptions"]
            if a["knobs"].get("sched.feedback.tslice_max_us")
            == chip_smoke.FED_CANARY_MAX_US] == [out["canary"]]
    assert out["kill"]["casualties"]
    assert out["completions"] == len(reqs)
    assert out["info"].generation == 1


def test_chaos_goldens_phase():
    out = chip_smoke.chaos_goldens()
    assert out["gateway"][0]["trace_digest"] == \
        chip_smoke.GOLDEN_GATEWAY_DIGEST
    assert out["crash"][0]["report_digest"] == GOLDEN_CRASH_REPORT_DIGEST
    assert chip_smoke.GOLDEN_CRASH_TRACE_DIGEST == GOLDEN_CRASH_TRACE_DIGEST
