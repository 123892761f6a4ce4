"""``pbs_tpu_torch.gateway.federation`` and ``run_federation_chaos``
against ``pbs_tpu``'s: twins of ``tests/test_federation.py`` and
``tests/test_federation_chaos.py``.

- The federation cases (the ring's bounded disruption, DRR deficit
  carry, lease expiry and recovery, the spray bound, borrowing past the
  slice cap, honest retry hints, reslicing, death and drain handoff,
  stale health views, the controller as lease authority) are written as
  functions of a package namespace and run on both packages; their
  observables must be equal. The controller is the reference's
  ``dist.controller.Controller``, duck-typed into either package's
  federation; ``tests/test_torch_dist.py`` runs the same cases with
  the port's own ``Controller``.
- The chaos cases run the port's harness: the reference tests' golden
  digests as they stand (plain and knob hot-reload), then the whole
  report against the reference's for every scenario.
- Canary-scoped knob pushes through ``attach_knobs(per_member=True)``:
  exactly the canary member adopts, and ``apply_member_knobs`` re-rates
  only its backends, in both packages alike.
"""

from __future__ import annotations

import importlib
import json
import types

import pytest

from pbs_tpu.cli.pbst import main as ref_main
from pbs_tpu.dist.controller import AgentHandle, Controller
from pbs_tpu_torch.cli.pbst import main as port_main

MS = 1_000_000
SEC = 1_000_000_000


def _ns(root: str) -> types.SimpleNamespace:
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    gw = mod("gateway")
    return types.SimpleNamespace(
        root=root, gw=gw, fed=mod("gateway.federation"),
        faults=mod("faults.injector"), plan=mod("faults.plan"),
        clock=mod("utils.clock"), channel=mod("knobs.channel"),
        knobs=mod("knobs"))


REF, PORT = _ns("pbs_tpu"), _ns("pbs_tpu_torch")


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    yield
    for P in (REF, PORT):
        P.faults.uninstall()
        P.knobs.reset_local()


def _twin(case, *args):
    """Run a case on both packages; the observables must be equal."""
    got = {}
    for P in (REF, PORT):
        try:
            got[P.root] = json.dumps(case(P, *args), sort_keys=True,
                                     default=str)
        finally:
            P.faults.uninstall()
    assert got[PORT.root] == got[REF.root]


def _member(P, name, clock, n_backends=2, service_ns=1 * MS, n_slots=2):
    backends = [P.gw.SimServeBackend(f"{name}b{j}", n_slots=n_slots,
                                     service_ns_per_cost=service_ns, seed=j)
                for j in range(n_backends)]
    return P.gw.Gateway(backends, clock=clock, max_queued=512, name=name)


def _pump(fed, clock, ticks, tick_ns=1 * MS) -> list:
    done = []
    for _ in range(ticks):
        done.extend(fed.tick())
        clock.advance(tick_ns)
    return done


# -- tests/test_federation.py -------------------------------------------


def f_ring_remove_moves_only_the_removed_nodes_tenants(P):
    ring = P.gw.HashRing(vnodes=64)
    for i in range(5):
        ring.add(f"g{i}")
    tenants = [f"tenant-{i}" for i in range(1000)]
    before = {t: ring.lookup(t) for t in tenants}
    ring.remove("g2")
    after = {t: ring.lookup(t) for t in tenants}
    moved = [t for t in tenants if before[t] != after[t]]
    assert moved and all(before[t] == "g2" for t in moved)
    assert all(after[t] != "g2" for t in tenants)
    assert len(moved) / len(tenants) < 0.45
    return [before, after]


def f_ring_readd_restores_placement_and_add_only_steals(P):
    ring = P.gw.HashRing(vnodes=64)
    for i in range(5):
        ring.add(f"g{i}")
    tenants = [f"tenant-{i}" for i in range(1000)]
    before = {t: ring.lookup(t) for t in tenants}
    ring.remove("g2")
    ring.add("g2")
    assert {t: ring.lookup(t) for t in tenants} == before
    ring.add("g9")
    after = {t: ring.lookup(t) for t in tenants}
    moved = [t for t in tenants if after[t] != before[t]]
    assert moved and all(after[t] == "g9" for t in moved)
    assert len(moved) / len(tenants) < 0.45
    return [moved, ring.nodes()]


def f_ring_spreads_load_across_nodes(P):
    ring = P.gw.HashRing(vnodes=64)
    for i in range(4):
        ring.add(f"g{i}")
    counts: dict[str, int] = {}
    for i in range(2000):
        counts[ring.lookup(f"t{i}")] = counts.get(ring.lookup(f"t{i}"), 0) + 1
    assert set(counts) == {"g0", "g1", "g2", "g3"}
    assert min(counts.values()) > 2000 * 0.05
    return counts


def _req(P, rid, tenant, cost):
    return P.gw.Request(rid=rid, tenant=tenant, slo=P.gw.BATCH, cost=cost,
                        payload=None, submit_ns=0)


def f_drr_take_restore_carries_deficit_and_order(P):
    q = P.gw.DeficitRoundRobin(quantum=4)
    q.set_weight("a", 256)
    for i in range(2):
        q.push(_req(P, f"a{i}", "a", 10))
    assert q.pop().rid == "a0"
    reqs, deficit = q.take_tenant(P.gw.BATCH, "a")
    assert [r.rid for r in reqs] == ["a1"]
    assert deficit == pytest.approx(2.0)
    assert q.depth() == 0
    q2 = P.gw.DeficitRoundRobin(quantum=4)
    q2.set_weight("a", 256)
    q2.restore_tenant(P.gw.BATCH, "a", reqs, deficit)
    assert q2.depth() == 1
    assert q2._deficit[P.gw.BATCH]["a"] == pytest.approx(2.0)
    assert q2.pop().rid == "a1"
    return deficit


def f_drr_restore_merges_with_max_never_sum(P):
    q = P.gw.DeficitRoundRobin(quantum=4)
    q.push(_req(P, "x0", "x", 4))
    q._deficit[P.gw.BATCH]["x"] = 3.0
    q.restore_tenant(P.gw.BATCH, "x", [_req(P, "x1", "x", 4)], deficit=2.0)
    assert q._deficit[P.gw.BATCH]["x"] == pytest.approx(3.0)
    assert q.pop().rid == "x1"
    return q._deficit[P.gw.BATCH]["x"]


def f_lease_expiry_degrades_to_conservative_and_recovers(P):
    clock = P.clock.VirtualClock()
    members = [_member(P, "gw0", clock), _member(P, "gw1", clock)]
    quota = P.gw.TenantQuota(rate=1000.0, burst=20.0, slo=P.gw.INTERACTIVE,
                             max_queued=256)
    P.faults.install(P.plan.FaultPlan(seed=0, specs=(
        P.plan.FaultSpec("lease.expire", "expire", p=1.0, key="*:t"),)))
    fed = P.gw.FederatedGateway(members, clock=clock,
                                renew_period_ns=4 * MS, lease_ttl_ns=6 * MS)
    fed.register_tenant("t", quota)
    home = fed.ring.lookup("t")
    bucket = fed.members[home].admission._buckets["t"]
    assert isinstance(bucket, P.gw.LeasedBucket)
    assert bucket.level == 0.0
    assert not bucket.leased(clock.now_ns())
    admitted = sheds = 0
    for _ in range(200):
        r = fed.submit("t", None, cost=1)
        if r.admitted:
            admitted += 1
        else:
            sheds += 1
            assert r.retry_after_ns > 0
        _pump(fed, clock, 1)
    assert admitted > 0 and sheds > 0
    audit = fed.lease_audit()["t"]
    assert audit["leased_spent"] == 0.0
    assert audit["conservative_spent"] == pytest.approx(float(admitted))
    assert audit["conservative_spent"] <= 0.25 * 1000 * 0.2 + 5 + 1e-6
    degraded = dict(audit)
    P.faults.uninstall()
    _pump(fed, clock, 8)
    audit = fed.lease_audit()["t"]
    degraded_spent = audit["conservative_spent"]
    admitted = int(degraded_spent)
    recovered = 0
    for _ in range(100):
        r = fed.submit("t", None, cost=1)
        if r.admitted:
            recovered += 1
        _pump(fed, clock, 1)
    assert recovered > 0
    audit = fed.lease_audit()["t"]
    assert bucket.leased(clock.now_ns())
    assert audit["conservative_spent"] == pytest.approx(degraded_spent)
    assert audit["leased_spent"] > 0
    assert (audit["leased_spent"] + audit["conservative_spent"]
            == pytest.approx(float(admitted + recovered)))
    assert audit["granted"] <= audit["minted"] + audit["deposited"] + 1e-6
    return [degraded, audit, sheds, recovered, fed.stats()]


def f_spraying_gateways_cannot_exceed_global_rate(P):
    clock = P.clock.VirtualClock()
    members = [_member(P, f"gw{i}", clock, n_backends=2, n_slots=8)
               for i in range(3)]
    quota = P.gw.TenantQuota(rate=2000.0, burst=30.0, slo=P.gw.INTERACTIVE,
                             max_queued=512)
    fed = P.gw.FederatedGateway(members, clock=clock,
                                renew_period_ns=2 * MS, lease_ttl_ns=3 * MS)
    fed.register_tenant("sprayer", quota)
    cost_admitted = 0
    ticks = 500
    for _ in range(ticks):
        for _ in range(8):
            if fed.submit("sprayer", None, cost=1).admitted:
                cost_admitted += 1
        _pump(fed, clock, 1)
    elapsed_s = ticks * 1 * MS / SEC
    assert cost_admitted <= quota.rate * elapsed_s + quota.burst + 1e-6
    assert cost_admitted > 0.8 * quota.rate * elapsed_s
    audit = fed.lease_audit()["sprayer"]
    assert audit["conservative_spent"] == 0.0
    return [cost_admitted, audit]


def f_oversized_but_legal_request_is_not_starved(P):
    clock = P.clock.VirtualClock()
    members = [_member(P, f"gw{i}", clock, n_slots=4) for i in range(4)]
    quota = P.gw.TenantQuota(rate=1000.0, burst=120.0, slo=P.gw.BATCH,
                             max_queued=256)
    fed = P.gw.FederatedGateway(members, clock=clock,
                                renew_period_ns=2 * MS, lease_ttl_ns=3 * MS)
    fed.register_tenant("big", quota)
    admitted = small = 0
    for tick in range(400):
        if fed.submit("big", None, cost=40).admitted:
            admitted += 1
        if tick % 4 == 0 and fed.submit("big", None, cost=1).admitted:
            small += 1
        _pump(fed, clock, 1)
    assert admitted > 0 and small > 0
    audit = fed.lease_audit()["big"]
    assert audit["granted"] <= audit["minted"] + audit["deposited"] + 1e-6
    assert audit["leased_spent"] == pytest.approx(40.0 * admitted + small)
    return [admitted, small, audit]


def f_degraded_midsize_request_gets_honest_retry_hint(P):
    quota = P.gw.TenantQuota(rate=1000.0, burst=50.0, slo=P.gw.BATCH)
    b = P.gw.LeasedBucket("t", "gw0", quota, capacity=12.5,
                          conservative_rate=125.0, conservative_burst=6.25,
                          renew_period_ns=4 * MS, now_ns=0)
    assert not b.take(10, 1 * MS)
    out = [b.retry_after_ns(10, 1 * MS)]
    assert out[0] == 4 * MS
    assert b.pending_need == 0.0
    assert not b.take(20, 1 * MS)
    assert b.pending_need == pytest.approx(20.0)
    out.append(b.retry_after_ns(1, 1 * MS))
    assert out[1] == pytest.approx(8 * MS, rel=0.01)
    b.credit(10.0, 2 * MS, 6 * MS)
    assert b.take(10, 2 * MS)
    assert b.pending_need == pytest.approx(20.0)
    b.credit(20.0, 3 * MS, 6 * MS)
    assert b.take(20, 3 * MS)
    assert b.pending_need == 0.0
    return out + [b.level, b.leased_spent, b.conservative_spent]


def f_members_with_local_tenants_are_rejected(P):
    clock = P.clock.VirtualClock()
    pre = _member(P, "gw0", clock)
    pre.register_tenant("t", P.gw.TenantQuota(rate=100.0, burst=10.0))
    msgs = []
    with pytest.raises(ValueError, match="locally registered") as e:
        P.gw.FederatedGateway([pre], clock=clock)
    msgs.append(str(e.value))
    fed = P.gw.FederatedGateway([_member(P, "gw1", clock)], clock=clock)
    pre2 = _member(P, "gw2", clock)
    pre2.register_tenant("t", P.gw.TenantQuota(rate=100.0, burst=10.0))
    with pytest.raises(ValueError, match="locally registered") as e:
        fed.add(pre2)
    msgs.append(str(e.value))
    return msgs


def f_broker_revokes_leases_of_retired_members(P):
    clock = P.clock.VirtualClock()
    members = [_member(P, "gw0", clock), _member(P, "gw1", clock)]
    fed = P.gw.FederatedGateway(members, clock=clock)
    fed.register_tenant("t", P.gw.TenantQuota(rate=100.0, burst=10.0,
                                              slo=P.gw.BATCH))
    before = sorted(fed.broker.leases)
    assert {g for _, g in fed.broker.leases} == {"gw0", "gw1"}
    fed.kill("gw1")
    assert {g for _, g in fed.broker.leases} == {"gw0"}
    return [before, sorted(fed.broker.leases), fed.lease_audit()]


def f_reslice_rebounds_conservative_floor_after_add(P):
    clock = P.clock.VirtualClock()
    g0 = _member(P, "gw0", clock)
    quota = P.gw.TenantQuota(rate=1000.0, burst=40.0, slo=P.gw.BATCH)
    fed = P.gw.FederatedGateway([g0], clock=clock)
    fed.register_tenant("t", quota)
    assert fed.members["gw0"].admission._buckets["t"]._cons_rate \
        == pytest.approx(500.0)
    for name in ("gw1", "gw2", "gw3"):
        fed.add(_member(P, name, clock))
    rates = [fed.members[n].admission._buckets["t"]._cons_rate
             for n in sorted(fed.members)]
    assert rates == pytest.approx([125.0] * 4)
    assert sum(rates) == pytest.approx(quota.rate / 2)
    caps = [fed.members[n].admission._buckets["t"].capacity
            for n in sorted(fed.members)]
    assert sum(caps) == pytest.approx(quota.burst)
    return [rates, caps]


def f_gateway_death_hands_off_queued_and_inflight(P):
    clock = P.clock.VirtualClock()
    members = [_member(P, "gw0", clock, n_backends=1, service_ns=5 * MS),
               _member(P, "gw1", clock, n_backends=1, service_ns=5 * MS)]
    fed = P.gw.FederatedGateway(members, clock=clock)
    q = P.gw.TenantQuota(rate=1e6, burst=1e6, slo=P.gw.BATCH, max_queued=256)
    fed.register_tenant("t0", q)
    fed.register_tenant("t1", q)
    rids = []
    for i in range(24):
        r = fed.submit(f"t{i % 2}", None, cost=2)
        assert r.admitted
        rids.append(r.rid)
    done = _pump(fed, clock, 3)
    victim = max(fed.members.values(),
                 key=lambda g: g.queue.depth() + len(g.inflight)).name
    assert fed.members[victim].queue.depth() > 0
    assert len(fed.members[victim].inflight) > 0
    fed.kill(victim)
    assert fed.handoffs > 0
    done += _pump(fed, clock, 600)
    assert sorted(r for r, _ in done) == sorted(rids)
    assert fed.admitted == fed.completed == 24
    assert not fed.busy()
    survivor = next(iter(fed.members.values()))
    assert survivor.adopted > 0
    assert victim in [g.name for g in fed._retired]
    return [victim, [r for r, _ in done], fed.stats(), fed.events]


def f_gateway_drain_hands_off_queued_with_deposit(P):
    clock = P.clock.VirtualClock()
    members = [_member(P, "gw0", clock, n_backends=1, service_ns=5 * MS),
               _member(P, "gw1", clock, n_backends=1, service_ns=5 * MS)]
    fed = P.gw.FederatedGateway(members, clock=clock)
    q = P.gw.TenantQuota(rate=500.0, burst=40.0, slo=P.gw.BATCH,
                         max_queued=256)
    fed.register_tenant("t0", q)
    rids = []
    for i in range(6):
        r = fed.submit("t0", None, cost=2)
        if r.admitted:
            rids.append(r.rid)
    assert rids
    home = fed.ring.lookup("t0")
    fed.drain(home)
    assert home not in fed.ring.nodes()
    assert fed.lease_audit()["t0"]["deposited"] > 0
    done = _pump(fed, clock, 800)
    assert sorted(r for r, _ in done) == sorted(rids)
    assert fed.admitted == fed.completed == len(rids)
    assert home not in fed.members
    assert fed.submit("t0", None, cost=1).admitted
    return [home, [r for r, _ in done], fed.lease_audit(), fed.events]


def f_stale_breaker_view_does_not_veto_but_ranks_last(P):
    clock = P.clock.VirtualClock()
    ctl = Controller(clock=clock, health_ttl_ns=5 * SEC)
    h = AgentHandle("b0", client=None, probe=None)
    h.breaker = "open"
    h.observed_ns = clock.now_ns()
    ctl.agents["b0"] = h
    b0 = P.gw.SimServeBackend("b0", n_slots=1, service_ns_per_cost=20 * SEC)
    b1 = P.gw.SimServeBackend("b1", n_slots=1, service_ns_per_cost=20 * SEC)
    gw = P.gw.Gateway([b0, b1], clock=clock, controller=ctl,
                      quotas={"t": P.gw.TenantQuota(rate=1e6, burst=1e6)})
    for _ in range(2):
        gw.submit("t", None)
    gw.tick()
    assert b0.depth() == 0 and b1.depth() == 1
    assert gw.queue.depth() == 1
    clock.advance(6 * SEC)
    assert ctl.backend_health()["b0"]["stale"] is True
    gw.tick()
    assert b0.depth() == 1
    assert gw.queue.depth() == 0
    return gw.stats()


def f_stale_alive_view_is_not_trusted_for_ranking(P):
    clock = P.clock.VirtualClock()
    ctl = Controller(clock=clock, health_ttl_ns=1 * SEC)
    h = AgentHandle("b0", client=None, probe=None)
    h.observed_ns = clock.now_ns()
    ctl.agents["b0"] = h
    clock.advance(2 * SEC)
    b0 = P.gw.SimServeBackend("b0", n_slots=4, service_ns_per_cost=1 * MS)
    b1 = P.gw.SimServeBackend("b1", n_slots=4, service_ns_per_cost=1 * MS)
    gw = P.gw.Gateway([b0, b1], clock=clock, controller=ctl,
                      quotas={"t": P.gw.TenantQuota(rate=1e6, burst=1e6)})
    gw.submit("t", None)
    gw.tick()
    assert b1.depth() == 1 and b0.depth() == 0
    return [b0.depth(), b1.depth()]


def f_controller_routes_admission_leases(P):
    clock = P.clock.VirtualClock()
    members = [_member(P, "gw0", clock), _member(P, "gw1", clock)]
    ctl = Controller(clock=clock)
    calls = {"lease": 0, "deposit": 0}
    real_lease, real_deposit = ctl.admission_lease, ctl.admission_deposit

    def lease(*a, **kw):
        calls["lease"] += 1
        return real_lease(*a, **kw)

    def deposit(*a, **kw):
        calls["deposit"] += 1
        return real_deposit(*a, **kw)

    ctl.admission_lease, ctl.admission_deposit = lease, deposit
    fed = P.gw.FederatedGateway(members, controller=ctl, clock=clock)
    assert ctl.admission_broker is fed.broker
    quota = P.gw.TenantQuota(rate=100.0, burst=10.0, slo=P.gw.BATCH)
    fed.register_tenant("t", quota)
    assert calls["lease"] > 0
    assert any(k[0] == "t" for k in fed.broker.leases)
    home = fed.ring.lookup("t")
    fed.submit("t", None, cost=1)
    fed.drain(home)
    assert calls["deposit"] > 0
    return [calls, fed.lease_audit()]


FED_CASES = [
    f_ring_remove_moves_only_the_removed_nodes_tenants,
    f_ring_readd_restores_placement_and_add_only_steals,
    f_ring_spreads_load_across_nodes,
    f_drr_take_restore_carries_deficit_and_order,
    f_drr_restore_merges_with_max_never_sum,
    f_lease_expiry_degrades_to_conservative_and_recovers,
    f_spraying_gateways_cannot_exceed_global_rate,
    f_oversized_but_legal_request_is_not_starved,
    f_degraded_midsize_request_gets_honest_retry_hint,
    f_members_with_local_tenants_are_rejected,
    f_broker_revokes_leases_of_retired_members,
    f_reslice_rebounds_conservative_floor_after_add,
    f_gateway_death_hands_off_queued_and_inflight,
    f_gateway_drain_hands_off_queued_with_deposit,
    f_stale_breaker_view_does_not_veto_but_ranks_last,
    f_stale_alive_view_is_not_trusted_for_ranking,
    f_controller_routes_admission_leases,
]


@pytest.mark.parametrize("case", FED_CASES, ids=lambda c: c.__name__)
def test_federation_case_twin(case):
    _twin(case)


def test_federation_constants_match():
    for name in ("DEFAULT_RENEW_PERIOD_NS", "DEFAULT_LEASE_TTL_NS",
                 "NO_GATEWAY_RETRY_NS", "PARTITION_HEAL_NS",
                 "JOURNAL_CKPT_PERIOD_NS"):
        assert getattr(PORT.fed, name) == getattr(REF.fed, name)
    for key in ("", "t", "tenant-7", "gw0#13", "ünïcode"):
        assert PORT.fed._hash64(key) == REF.fed._hash64(key)


# -- tests/test_federation_chaos.py -------------------------------------

#: The reference tests' golden digests (tests/test_federation_chaos.py)
#: for (mixed, seed=0, 3 gateways, 4 tenants, 240 ticks) under
#: FaultPlan.federation(0), plain and with KNOB_PLAN.
GOLDEN_TRACE_DIGEST = (
    "71a188673b85cf80a67a721b247443d22e3776a09ad491fc6a5356553218d6de")
GOLDEN_REPORT_DIGEST = (
    "1ba265a705067e8d8761aaa8d57c23b30e38c25839b29c9f1debf380b5667242")
GOLDEN_KNOB_TRACE_DIGEST = (
    "6008549776c588ab5793c48e1943e6b4f8bf855177e613b3056a0413c3a3f479")
GOLDEN_KNOB_REPORT_DIGEST = (
    "70a4e8e2e16ac7308e0b54cc2f3fcc6b1fa5df543a808140eed8836e69f9fd5d")

SMOKE_KW = dict(workload="mixed", seed=0, n_gateways=3, n_tenants=4,
                ticks=240)

KNOB_PLAN = [
    {"tick": 80, "set": {"sched.feedback.tslice_min_us": 200,
                         "sched.feedback.tslice_max_us": 2000}},
    {"tick": 120, "set": {"gateway.admission.rate_scale": 0.5}},
    {"tick": 160, "set": {"gateway.admission.rate_scale": 1e9},
     "expect": "rejected"},
    {"tick": 164, "set": {"sched.feedback.window": "banana"},
     "expect": "rejected"},
    {"tick": 200, "set": {"gateway.admission.rate_scale": 2.0}},
]


def _run(P, **kw):
    try:
        return P.gw.run_federation_chaos(**kw)
    finally:
        P.faults.uninstall()


def _reports_equal(kw, plan_of=None) -> dict:
    """The port's report for ``kw`` (with a plan built per package by
    ``plan_of``), after asserting it equals the reference's as JSON."""
    out = []
    for P in (REF, PORT):
        extra = {} if plan_of is None else {"plan": plan_of(P)}
        out.append(_run(P, **kw, **extra))
    a, b = (json.dumps(r, sort_keys=True, default=str) for r in out)
    assert a == b
    return out[1]


def test_federation_chaos_smoke_invariants_and_golden_digests():
    r = _reports_equal(SMOKE_KW)
    assert r["problems"] == []
    assert r["ok"] is True
    assert sum(r["faults_fired"].values()) > 0
    events = [e["event"] for e in r["events"]]
    assert {"kill", "drain", "remove", "add", "partition"} <= set(events)
    st = r["stats"]
    assert st["admitted"] == st["completed"] > 0
    assert st["handoffs"] > 0
    assert st["lease_refusals"] > 0
    assert r["trace_digest"] == GOLDEN_TRACE_DIGEST
    assert r["report_digest"] == GOLDEN_REPORT_DIGEST


def test_federation_chaos_deterministic_books():
    a = _run(PORT, **SMOKE_KW)
    b = _run(PORT, **SMOKE_KW)
    assert a["trace_digest"] == b["trace_digest"]
    assert a["report_digest"] == b["report_digest"]
    assert a["stats"]["shed"] == b["stats"]["shed"]
    assert a["stats"]["handoffs"] == b["stats"]["handoffs"]
    assert a["events"] == b["events"]
    assert a["lease_audit"] == b["lease_audit"]
    c = _reports_equal({**SMOKE_KW, "seed": 1})
    assert c["trace_digest"] != a["trace_digest"]


def test_federation_chaos_knob_hot_reload_invariants_and_goldens():
    r = _reports_equal(dict(SMOKE_KW, knob_plan=KNOB_PLAN))
    assert r["problems"] == []
    assert r["ok"] is True
    applied = [e for e in r["knob_events"] if e["applied"]]
    rejected = [e for e in r["knob_events"] if not e["applied"]]
    assert [e["tick"] for e in applied] == [80, 120, 200]
    assert [e["tick"] for e in rejected] == [160, 164]
    assert all(e["errors"] for e in rejected)
    assert r["applied_knobs"]["gateway.admission.rate_scale"] == 2.0
    assert r["applied_knobs"]["sched.feedback.tslice_max_us"] == 2000.0
    assert len([e for e in r["events"] if e["event"] == "knobs"]) == 3
    st = r["stats"]
    assert st["admitted"] == st["completed"] > 0
    assert r["trace_digest"] == GOLDEN_KNOB_TRACE_DIGEST
    assert r["report_digest"] == GOLDEN_KNOB_REPORT_DIGEST


def test_federation_chaos_throttle_actually_bites():
    plain = _run(PORT, **SMOKE_KW)
    throttled = _reports_equal(dict(
        SMOKE_KW, knob_plan=[{"tick": 80, "set": {
            "gateway.admission.rate_scale": 0.5}}]))
    minted = lambda r: sum(a["minted"]  # noqa: E731
                           for a in r["lease_audit"].values())
    assert throttled["ok"] and plain["ok"]
    assert minted(throttled) < minted(plain)


def test_federation_chaos_no_rate_inflation_books():
    r = _run(PORT, **SMOKE_KW)
    for tenant, a in r["lease_audit"].items():
        assert a["granted"] <= a["minted"] + a["deposited"] + 1e-6, tenant
        accounted = (a["leased_spent"] + a["held"] + a["deposited"]
                     + a["destroyed"])
        assert accounted <= a["granted"] + 1e-6, tenant


def test_federation_chaos_cli_json(capsys):
    argv = ["chaos", "--plan", "federation", "--workload", "mixed",
            "--seed", "0", "--gateways", "3", "--tenants", "4",
            "--rounds", "2", "--json"]
    assert port_main(argv) == 0
    port_doc = json.loads(capsys.readouterr().out)
    assert ref_main(argv) == 0
    assert port_doc == json.loads(capsys.readouterr().out)


def test_federation_chaos_cli_text(capsys):
    assert port_main(["chaos", "--plan", "federation", "--rounds", "2"]) == 0
    out = capsys.readouterr().out
    assert "federation chaos" in out and "report_digest=" in out
    assert out.rstrip().endswith("ok")
    assert ref_main(["chaos", "--plan", "federation", "--rounds", "2"]) == 0
    assert capsys.readouterr().out == out


def test_federation_respects_plan_files():
    spec = {
        "seed": 5,
        "specs": [
            {"point": "gateway.death", "fault": "kill", "p": 0.02,
             "after": 20, "times": 1},
            {"point": "lease.expire", "fault": "expire", "p": 0.3},
        ],
    }
    r = _reports_equal(dict(workload="stable", seed=5, n_gateways=3,
                            n_tenants=2, ticks=200, drain_rejoin=False),
                       plan_of=lambda P: P.plan.FaultPlan.from_dict(spec))
    assert r["ok"] is True, r["problems"]
    assert r["faults_fired"].get("gateway.death:kill", 0) >= 1
    assert r["faults_fired"].get("lease.expire:expire", 0) > 0


def test_federation_quorum_guard_never_fences_last_gateway():
    spec = {"seed": 9, "specs": [
        {"point": "gateway.death", "fault": "kill", "p": 0.2}]}
    r = _reports_equal(dict(workload="stable", seed=9, n_gateways=3,
                            n_tenants=2, ticks=200, drain_rejoin=False),
                       plan_of=lambda P: P.plan.FaultPlan.from_dict(spec))
    assert r["ok"] is True, r["problems"]
    kills = [e for e in r["events"] if e["event"] == "kill"]
    assert len(kills) == 2
    st = r["stats"]
    assert st["admitted"] == st["completed"] > 0


def test_federation_chaos_span_chains_cover_every_admit():
    r = _run(PORT, **SMOKE_KW)
    assert r["ok"] is True, r["problems"]
    assert r["spans"]["chains"] == r["stats"]["admitted"] > 0
    assert r["spans"]["complete"] == r["stats"]["admitted"]
    assert r["spans"]["handoff_events"] > 0


@pytest.mark.parametrize("specs,drain", [
    ([{"point": "gateway.death", "fault": "kill", "p": 0.2}], False),
    ([{"point": "gateway.partition", "fault": "partition", "p": 0.05,
       "args": {"duration_ns": 25_000_000}}], False),
    ([{"point": "lease.expire", "fault": "expire", "p": 0.5}], False),
    ([], True),
])
def test_span_continuity_under_each_disruption(specs, drain):
    spec = {"seed": 11, "specs": specs}
    r = _reports_equal(dict(workload="mixed", seed=11, n_gateways=3,
                            n_tenants=4, ticks=240, drain_rejoin=drain),
                       plan_of=lambda P: P.plan.FaultPlan.from_dict(spec))
    assert r["ok"] is True, r["problems"]
    assert r["spans"]["chains"] == r["stats"]["admitted"] > 0
    assert r["spans"]["complete"] == r["stats"]["admitted"]


def test_federation_obs_export_feeds_slo_report(tmp_path, capsys):
    """The port's span artifacts are the reference's files, and the
    reference's ``pbst slo report`` reads them."""
    obs = {}
    for P in (REF, PORT):
        obs[P.root] = tmp_path / P.root
        r = _run(P, **SMOKE_KW, obs_dir=str(obs[P.root]))
        assert r["ok"] is True
    names = sorted(p.name for p in obs[REF.root].iterdir())
    assert names == sorted(p.name for p in obs[PORT.root].iterdir())
    for name in names:
        assert (obs[PORT.root] / name).read_bytes() == \
            (obs[REF.root] / name).read_bytes(), name
    assert ref_main(["slo", "report", str(obs[PORT.root])]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["spans"]["chains"] == r["stats"]["admitted"]
    assert doc["run"]["harness"] == "federation"
    assert sum(t["requests"] for t in doc["tenants"].values()) == \
        r["stats"]["admitted"]


def test_unported_harness_modes_raise_naming_the_item():
    """``autopilot=`` is ported: the port refuses it beside a knob plan
    or a crash plan with the reference's ``ValueError``s, word for
    word and in the same order, before any run starts.
    ``process_mode=True`` refuses, as the reference does, every control
    plane that lives in the harness process — before any member is
    spawned (``tests/test_torch_procfed.py`` runs the mode itself)."""
    knob = [{"tick": 5, "set": {}}]
    for kw, match in (
            (dict(autopilot=True, knob_plan=knob),
             "knob_plan and autopilot are mutually exclusive"),
            (dict(autopilot={}, knob_plan=knob),
             "knob_plan and autopilot are mutually exclusive"),
            (dict(autopilot=True, crash_plan=[{"tick": 10}]),
             "crash_plan is mutually exclusive with knob_plan/autopilot"),
            (dict(autopilot=True, knob_plan=knob,
                  crash_plan=[{"tick": 10}]),
             "knob_plan and autopilot are mutually exclusive")):
        msgs = []
        for P in (REF, PORT):
            with pytest.raises(ValueError, match=match) as ei:
                P.gw.run_federation_chaos(**SMOKE_KW, **kw)
            msgs.append(str(ei.value))
        assert msgs[0] == msgs[1], kw
    for kw in (dict(autopilot=True), dict(crash_plan=[{"record": 3}]),
               dict(knob_plan=[{"tick": 5, "set": {}}])):
        for P in (REF, PORT):
            with pytest.raises(ValueError, match="process_mode"):
                P.gw.run_federation_chaos(**SMOKE_KW, process_mode=True,
                                          **kw)
    assert port_main(["chaos", "--plan", "gateway", "--processes"]) == 2


# -- canary-scoped knobs through the federation -------------------------


def f_canary_push_is_adopted_by_exactly_its_member(P, tmp):
    """Three members with per-member watchers and the serving profile
    model armed: a push scoped to gw1 is adopted by gw1 alone (its
    backends re-rated), a late joiner starts from the applicable view,
    and a global rollback restores gw1 to its peers' state."""
    clock = P.clock.VirtualClock()
    members = [_member(P, f"gw{i}", clock) for i in range(3)]
    for m in members:
        m.profile_switch_cost_ns = 50_000
    fed = P.gw.FederatedGateway(members, clock=clock)
    fed.register_tenant("t", P.gw.TenantQuota(rate=1e4, burst=100.0))
    path = str(tmp / f"{P.root}.led")
    w = P.channel.KnobChannel.create(path)
    fed.attach_knobs(P.channel.KnobChannel.attach(path), per_member=True)
    baseline = {n: dict(m.applied_knobs) for n, m in fed.members.items()}
    w.push({"sched.feedback.tslice_min_us": 100,
            "sched.feedback.tslice_max_us": 500}, scope=["gw1"])
    for _ in range(3):
        fed.submit("t", None, cost=1)
        _pump(fed, clock, 1)
    scales = {n: [b.service_scale for b in m.backends]
              for n, m in sorted(fed.members.items())}
    assert scales["gw1"] == [1.0 + 50_000 / 500_000] * 2
    assert scales["gw0"] == scales["gw2"] != scales["gw1"]
    adopted = [a["member"] for a in fed.knob_adoptions
               if "sched.feedback.tslice_max_us" in a["knobs"]
               and a["knobs"]["sched.feedback.tslice_max_us"] == 500]
    assert adopted == ["gw1"]
    fed.add(_member(P, "gw3", clock))
    assert fed.members["gw3"].applied_knobs.get(
        "sched.feedback.tslice_max_us") != 500
    ref_max = P.knobs.default("sched.feedback.tslice_max_us")
    w.push({"sched.feedback.tslice_min_us": 100,
            "sched.feedback.tslice_max_us": ref_max})  # rollback
    _pump(fed, clock, 1)
    for name in sorted(fed.members):
        assert fed.members[name].applied_knobs[
            "sched.feedback.tslice_max_us"] == ref_max
    return [baseline, scales, fed.knob_adoptions,
            {n: m.applied_knobs for n, m in sorted(fed.members.items())},
            {n: [b.service_scale for b in m.backends]
             for n, m in sorted(fed.members.items())}, fed.events]


def test_canary_push_is_adopted_by_exactly_its_member(tmp_path):
    _twin(f_canary_push_is_adopted_by_exactly_its_member, tmp_path)


def test_apply_member_knobs_matches_the_reference():
    """``Gateway.apply_member_knobs`` on its own: the adoptable set is
    the profile map's, and the re-rate uses the tighter band cap of the
    families a push steered."""
    pushes = [({"sched.feedback.tslice_max_us": 900,
                "gateway.admission.rate_scale": 0.5}, {}),
              ({"sched.atc.tslice_max_us": 3000},
               {"sched.feedback.tslice_max_us": 700}),
              ({"gateway.admission.rate_scale": 2.0}, {})]
    out = {}
    for P in (REF, PORT):
        clock = P.clock.VirtualClock()
        gw = _member(P, "gw0", clock)
        gw.profile_switch_cost_ns = 80_000
        log = []
        for changed, extra in pushes:
            values = {**changed, **extra}
            log.append([gw.apply_member_knobs(changed, values),
                        [b.service_scale for b in gw.backends]])
        out[P.root] = [log, gw.applied_knobs]
    assert out[PORT.root] == out[REF.root]


@pytest.mark.slow
def test_federation_chaos_soak_full_catalog():
    from pbs_tpu_torch.sim.workload import workload_names

    for name in workload_names():
        r = _reports_equal(dict(workload=name, seed=0, ticks=600))
        assert r["ok"] is True, (name, r["problems"])


@pytest.mark.slow
def test_federation_chaos_seed_sweep():
    for seed in range(8):
        r = _reports_equal(dict(workload="mixed", seed=seed, ticks=400))
        assert r["ok"] is True, (seed, r["problems"])


@pytest.mark.slow
def test_federation_chaos_cli_selfcheck():
    assert port_main(["chaos", "--plan", "federation", "--seed", "0",
                      "--selfcheck"]) == 0
