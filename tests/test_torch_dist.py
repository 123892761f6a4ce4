"""``pbs_tpu_torch.dist`` (RPC, agents, controller) against ``pbs_tpu``'s.

- Twins of ``tests/test_dist.py``: every case is written against a
  package namespace and runs on both packages (``P``), real TCP sockets,
  several agents, one process.
- Cross-package: the frames are byte-compatible (``send_msg`` writes the
  same bytes, each ``recv_msg`` reads the other's), a port client talks
  to a reference server and the reverse, a port ``Controller`` drives
  reference ``Agent``s and the reverse with the job map, steps and
  counters a same-package cluster gives.
- Twins of the ``Controller`` cases of ``tests/test_federation.py``
  (stale health views, the lease authority), ``tests/test_gateway.py``
  (``backend_health`` feeding routing) and ``tests/test_spans.py`` (the
  gateway publishing service p99s): the port's ``Controller`` behind the
  port's gateway, observables equal to the reference's pair.
"""

from __future__ import annotations

import importlib
import socket
import types

import pytest

SEC = 1_000_000_000
MS = 1_000_000


def _ns(root: str) -> types.SimpleNamespace:
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    return types.SimpleNamespace(
        root=root, dist=mod("dist"), rpc=mod("dist.rpc"),
        agent=mod("dist.agent"), controller=mod("dist.controller"),
        xsm=mod("runtime.xsm"), job=mod("runtime.job"),
        clock=mod("utils.clock"), gw=mod("gateway"),
        fed=mod("gateway.federation"), admission=mod("gateway.admission"),
        backends=mod("gateway.backends"), gateway=mod("gateway.gateway"),
        spans=mod("obs.spans"))


REF, PORT = _ns("pbs_tpu"), _ns("pbs_tpu_torch")


@pytest.fixture(params=["pbs_tpu", "pbs_tpu_torch"])
def P(request):
    return REF if request.param == "pbs_tpu" else PORT


@pytest.fixture()
def cluster(P):
    agents = [P.dist.Agent(f"host{i}").start() for i in range(3)]
    ctl = P.dist.Controller()
    for a in agents:
        ctl.add_agent(a.name, a.address)
    yield ctl, agents
    ctl.close()
    for a in agents:
        a.stop()


def _agent_of(agents, name):
    return next(a for a in agents if a.name == name)


# -- twins of tests/test_dist.py --------------------------------------------


def test_rpc_roundtrip_and_errors(P):
    srv = P.dist.RpcServer().start()
    srv.register("add", lambda a, b: a + b)
    srv.register("boom", lambda: 1 / 0)
    try:
        cli = P.dist.RpcClient(srv.address)
        assert cli.call("ping") == "pong"
        assert cli.call("add", a=2, b=3) == 5
        with pytest.raises(P.dist.RpcError) as ei:
            cli.call("boom")
        assert ei.value.remote_type == "ZeroDivisionError"
        with pytest.raises(P.dist.RpcError):
            cli.call("nope")
        cli.close()
    finally:
        srv.stop()


def test_multicall_batches_with_per_entry_status(P):
    srv = P.dist.RpcServer().start()
    srv.register("add", lambda a, b: a + b)
    try:
        cli = P.dist.RpcClient(srv.address)
        res = cli.multicall([
            ("add", {"a": 1, "b": 2}),
            ("missing", {}),
            ("add", {"a": 10, "b": 20}),
        ])
        assert res[0] == {"ok": True, "result": 3}
        assert res[1]["ok"] is False
        assert res[2] == {"ok": True, "result": 30}
        cli.close()
    finally:
        srv.stop()


def test_agent_job_lifecycle_and_telemetry(P):
    a = P.dist.Agent("solo").start()
    try:
        cli = P.dist.RpcClient(a.address)
        cli.call("create_job", job="train", workload="sim",
                 spec={"step_time_ns": 1_000_000, "max_steps": 50})
        assert cli.call("run", max_rounds=200) > 0
        tel = cli.call("telemetry", job="train")
        steps = sum(c["counters"]["steps_retired"] for c in tel["contexts"])
        assert steps == 50
        jobs = cli.call("list_jobs")
        assert jobs[0]["finished"] is True
        out = cli.call("sched_setparams", job="train", weight=512, cap=50)
        assert (out["weight"], out["cap"]) == (512, 50)
        assert cli.call("remove_job", job="train") is True
        cli.close()
    finally:
        a.stop()


def test_controller_places_gang_on_distinct_hosts(cluster):
    ctl, _ = cluster
    rec = ctl.create_job("ring", spec={"step_time_ns": 500_000},
                         n_members=3, gang=True)
    assert len({m.agent for m in rec.members}) == 3
    ctl.run_rounds(3, max_rounds=50)
    steps = ctl.job_steps("ring")
    assert all(v > 0 for v in steps.values())
    assert max(steps.values()) <= 3 * min(steps.values()) + 64


def test_controller_load_balances_singletons(cluster):
    ctl, _ = cluster
    for i in range(6):
        ctl.create_job(f"j{i}", spec={"step_time_ns": 100_000})
    per_host: dict[str, int] = {}
    for rec in ctl.jobs.values():
        per_host[rec.members[0].agent] = per_host.get(
            rec.members[0].agent, 0) + 1
    assert max(per_host.values()) - min(per_host.values()) <= 1


def test_heartbeat_detects_death_and_recover_replaces(cluster):
    ctl, agents = cluster
    ctl.create_job("work", spec={"step_time_ns": 1_000_000}, n_members=2,
                   gang=True)
    victim_agent = ctl.jobs["work"].members[0].agent
    _agent_of(agents, victim_agent).stop()
    for _ in range(ctl.dead_after_missed):
        alive = ctl.heartbeat()
    assert alive[victim_agent] is False
    assert ctl.recover() == ["work.0"]
    new_home = ctl.jobs["work"].members[0].agent
    assert new_home != victim_agent
    assert new_home != ctl.jobs["work"].members[1].agent
    ctl.run_rounds(2, max_rounds=20)
    assert all(v > 0 for v in ctl.job_steps("work").values())


def test_strict_round_raises_when_agent_dies_mid_round(P, cluster):
    ctl, agents = cluster
    ctl.create_job("j", spec={"step_time_ns": 1_000_000})
    agents[2].stop()
    with pytest.raises(P.dist.ClusterRoundError) as ei:
        ctl.run_round(max_rounds=10)
    assert "host2" in ei.value.errors
    quanta = ctl.run_round(max_rounds=10, strict=False)
    assert "host2" not in quanta or ctl.last_round_errors


def test_create_job_rolls_back_orphans_on_partial_failure(cluster):
    ctl, agents = cluster
    agents[2].stop()
    with pytest.raises(Exception):
        ctl.create_job("g", spec={"step_time_ns": 1_000_000},
                       n_members=3, gang=True)
    assert "g" not in ctl.jobs
    for a in agents[:2]:
        assert a.partition.jobs == []
    ctl.heartbeat()
    ctl.heartbeat()
    rec = ctl.create_job("g", spec={"step_time_ns": 1_000_000},
                         n_members=2, gang=True)
    assert len(rec.members) == 2


def test_resurrected_agent_is_fenced_before_readmission(cluster):
    ctl, agents = cluster
    rec = ctl.create_job("solo", spec={"step_time_ns": 1_000_000})
    home = rec.members[0].agent
    ctl.agents[home].alive = False
    assert ctl.recover() == ["solo"]
    assert rec.members[0].agent != home
    alive = ctl.heartbeat()
    assert alive[home] is True
    assert _agent_of(agents, home).partition.jobs == []


def test_sched_setparams_fans_out_via_multicall(cluster):
    ctl, agents = cluster
    ctl.create_job("fleet", spec={"step_time_ns": 1_000_000}, n_members=3)
    ctl.sched_setparams("fleet", weight=1024, tslice_us=250)
    for m in ctl.jobs["fleet"].members:
        p = _agent_of(agents, m.agent).partition.job(m.job).params
        assert (p.weight, p.tslice_us) == (1024, 250)


def test_live_migration_preserves_state_and_telemetry(cluster):
    ctl, agents = cluster
    rec = ctl.create_job("mig", spec={"step_time_ns": 1_000_000,
                                      "max_steps": 2_000})
    src_name = rec.members[0].agent
    ctl.run_round(max_rounds=30)
    steps_before = sum(ctl.job_steps("mig").values())
    assert steps_before > 0
    src_agent = _agent_of(agents, src_name)
    dev_before = int(src_agent.partition.job("mig").contexts[0].counters[1])
    moved = ctl.migrate_job("mig")
    dst_name = rec.members[0].agent
    assert moved == {"mig": dst_name} and dst_name != src_name
    assert src_agent.partition.jobs == []
    j = _agent_of(agents, dst_name).partition.job("mig")
    assert j.steps_retired() == steps_before
    assert int(j.contexts[0].counters[1]) == dev_before
    ctl.run_round(max_rounds=30)
    assert sum(ctl.job_steps("mig").values()) > steps_before


def test_migration_to_named_target_and_sched_params(cluster):
    ctl, agents = cluster
    ctl.create_job("pin", spec={"step_time_ns": 1_000_000,
                                "sched": {"weight": 777}})
    src = ctl.jobs["pin"].members[0].agent
    target = next(a.name for a in agents if a.name != src)
    ctl.migrate_job("pin", to=target)
    assert ctl.jobs["pin"].members[0].agent == target
    assert _agent_of(agents, target).partition.job("pin").params.weight \
        == 777


def test_migration_abort_leaves_source_running(P, cluster):
    ctl, agents = cluster
    ctl.create_job("frag", spec={"step_time_ns": 1_000_000})
    rec = ctl.jobs["frag"]
    src = rec.members[0].agent
    for a in agents:
        if a.name != src:
            a.partition.create_job("frag", max_steps=1)
    with pytest.raises(P.dist.RpcError):
        ctl.migrate_job("frag")
    assert rec.members[0].agent == src
    states = [c.state for c in
              _agent_of(agents, src).partition.job("frag").contexts]
    assert P.job.ContextState.RUNNABLE in states


def test_restore_rejects_label_laundering_and_rolls_back(P, cluster):
    ctl, agents = cluster
    h = ctl.agents["host0"]
    try:
        P.xsm.set_policy(P.xsm.LabelPolicy()
                         .allow("alice", "job.create", "user")
                         .allow("alice", "job.restore", "user"))
        with pytest.raises(P.dist.RpcError, match="XsmDenied"):
            h.client.call("restore_job", job="laundered", subject="alice",
                          spec={"max_steps": 5},
                          saved={"label": "secret"})
        assert h.client.call("list_jobs") == []
        with pytest.raises(P.dist.RpcError):
            h.client.call("restore_job", job="broken", subject="alice",
                          spec={"max_steps": 5},
                          saved={"contention": [1, 2, 3]})
        assert h.client.call("list_jobs") == []
    finally:
        P.xsm.set_policy(P.xsm.DummyPolicy())


# -- the wire: byte-compatible frames, clients and servers across packages --


@pytest.mark.parametrize("obj", [
    {"op": "ping", "args": {}, "idem": "a.b.c.0"},
    {"ok": True, "result": {"x": [1, 2.5, None, "é"], "y": True}},
    [1, "two", {"three": 3}],
    "plain",
])
def test_frames_are_byte_compatible(obj):
    """``send_msg`` writes the same bytes in both packages, and each
    ``recv_msg`` reads the other's frame."""
    frames = {}
    for P in (REF, PORT):
        a, b = socket.socketpair()
        try:
            P.rpc.send_msg(a, obj)
            a.shutdown(socket.SHUT_WR)
            frames[P.root] = b.recv(1 << 20)
        finally:
            a.close()
            b.close()
    assert frames["pbs_tpu"] == frames["pbs_tpu_torch"]
    for writer, reader in ((REF, PORT), (PORT, REF)):
        a, b = socket.socketpair()
        try:
            writer.rpc.send_msg(a, obj)
            assert reader.rpc.recv_msg(b) == obj
        finally:
            a.close()
            b.close()
    assert REF.rpc.MAX_MSG_BYTES == PORT.rpc.MAX_MSG_BYTES


@pytest.mark.parametrize("client_pkg,server_pkg",
                         [("pbs_tpu_torch", "pbs_tpu"),
                          ("pbs_tpu", "pbs_tpu_torch")])
def test_client_and_server_talk_across_packages(client_pkg, server_pkg):
    """A port client against a reference server and the reverse: calls,
    in-band errors, multicall entry statuses, the auth handshake and the
    privileged-subject refusal, idempotent retries across a lost reply."""
    C = PORT if client_pkg == "pbs_tpu_torch" else REF
    S = PORT if server_pkg == "pbs_tpu_torch" else REF
    srv = S.dist.RpcServer(auth_token="tok").start()
    n = {"bump": 0}

    def bump():
        n["bump"] += 1
        return n["bump"]

    srv.register("bump", bump)
    srv.register("whoami", lambda subject="remote": subject)
    try:
        cli = C.dist.RpcClient(srv.address, auth_token="tok")
        assert cli.call("ping") == "pong"
        assert cli.call("bump") == 1
        assert cli.call("whoami", subject="system") == "system"
        res = cli.multicall([("bump", {}), ("nope", {}), ("ping", {})])
        assert [r["ok"] for r in res] == [True, False, True]
        with pytest.raises(C.dist.RpcError) as ei:
            cli.call("nope")
        assert ei.value.remote_type == "LookupError"
        cli.close()
        anon = C.dist.RpcClient(srv.address)
        with pytest.raises(C.dist.RpcError, match="PermissionError"):
            anon.call("whoami", subject="system")
        anon.close()
        with pytest.raises(C.dist.RpcError):
            C.dist.RpcClient(srv.address, auth_token="wrong").call("ping")
        # a reply lost on the wire: the retry rides the same token and
        # the other package's server replays instead of re-executing
        C.faults = importlib.import_module(f"{C.root}.faults")
        C.faults.install(C.faults.FaultPlan(seed=0, specs=(
            C.faults.FaultSpec("rpc.client", "drop_reply", p=1.0,
                               times=1),)))
        try:
            retry = C.dist.RpcClient(srv.address, auth_token="tok",
                                     backoff_base_s=0.001,
                                     backoff_cap_s=0.002)
            assert retry.call("bump") == 3
            assert retry.retries == 1
            retry.close()
        finally:
            C.faults.uninstall()
        assert srv.op_executions["bump"] == 3 and srv.idem_hits == 1
    finally:
        srv.stop()


def _drive_mixed(C, A, tmp_names):
    """A controller of package C over three agents of package A: a gang
    of two, two singletons (finite), a migration, a failover; returns
    the job map, steps and each member's counters."""
    agents = [A.dist.Agent(f"{tmp_names}{i}").start() for i in range(3)]
    ctl = C.dist.Controller()
    try:
        for a in agents:
            ctl.add_agent(a.name, a.address)
        ctl.create_job("ring", spec={"step_time_ns": 500_000,
                                     "max_steps": 40},
                       n_members=2, gang=True)
        ctl.create_job("s0", spec={"step_time_ns": 1_000_000,
                                   "max_steps": 30})
        ctl.create_job("s1", spec={"step_time_ns": 250_000,
                                   "max_steps": 60,
                                   "sched": {"weight": 512}})
        ctl.run_round(max_rounds=5)
        ctl.migrate_job("s0")
        home = ctl.jobs["s1"].members[0].agent
        _agent_of(agents, home).stop()
        for _ in range(ctl.dead_after_missed):
            ctl.heartbeat()
        moved = ctl.recover()
        for _ in range(40):
            ctl.run_round(max_rounds=50)
        jobs = {n: (r.workload, r.spec, r.gang,
                    [(m.agent, m.job) for m in r.members])
                for n, r in sorted(ctl.jobs.items())}
        steps = {n: ctl.job_steps(n) for n in sorted(ctl.jobs)}
        counters = {}
        for n, r in sorted(ctl.jobs.items()):
            for m in r.members:
                tel = ctl.agents[m.agent].client.call("telemetry", job=m.job)
                counters[m.job] = [
                    {k: v for k, v in c["counters"].items()
                     if k in ("steps_retired", "device_time_ns",
                              "device_flops", "hbm_bytes", "tokens")}
                    for c in tel["contexts"]]
        return dict(jobs=jobs, steps=steps, counters=counters,
                    moved=moved, home=home)
    finally:
        ctl.close()
        for a in agents:
            a.stop()


def test_controller_drives_the_other_packages_agents():
    """A port Controller driving reference Agents, and a reference
    Controller driving port Agents, end with the job map, steps and
    counters that a same-package cluster gives."""
    got = {(c.root, a.root): _drive_mixed(c, a, "m")
           for c in (REF, PORT) for a in (REF, PORT)}
    want = got[("pbs_tpu", "pbs_tpu")]
    for key, out in got.items():
        assert out == want, key
    assert want["steps"]["s1"] == {"s1": 60}
    assert "s1" in want["moved"]


# -- the Controller behind the gateway (federation, gateway, spans) ---------


def _stale_breaker(P):
    clock = P.clock.VirtualClock()
    ctl = P.dist.Controller(clock=clock, health_ttl_ns=5 * SEC)
    h = P.controller.AgentHandle("b0", client=None, probe=None)
    h.breaker = "open"
    h.observed_ns = clock.now_ns()
    ctl.agents["b0"] = h
    b0 = P.backends.SimServeBackend("b0", n_slots=1,
                                    service_ns_per_cost=20 * SEC)
    b1 = P.backends.SimServeBackend("b1", n_slots=1,
                                    service_ns_per_cost=20 * SEC)
    gw = P.gateway.Gateway(
        [b0, b1], clock=clock, controller=ctl,
        quotas={"t": P.admission.TenantQuota(rate=1e6, burst=1e6)})
    for _ in range(2):
        gw.submit("t", None)
    gw.tick()
    fresh = (b0.depth(), b1.depth(), gw.queue.depth())
    clock.advance(6 * SEC)
    stale = ctl.backend_health()["b0"]["stale"]
    gw.tick()
    return fresh, stale, (b0.depth(), gw.queue.depth())


def test_stale_breaker_view_does_not_veto_but_ranks_last():
    got = _stale_breaker(PORT)
    assert got == ((0, 1, 1), True, (1, 0))
    assert got == _stale_breaker(REF)


def _stale_alive(P):
    clock = P.clock.VirtualClock()
    ctl = P.dist.Controller(clock=clock, health_ttl_ns=1 * SEC)
    h = P.controller.AgentHandle("b0", client=None, probe=None)
    h.observed_ns = clock.now_ns()
    ctl.agents["b0"] = h
    clock.advance(2 * SEC)
    b0 = P.backends.SimServeBackend("b0", n_slots=4,
                                    service_ns_per_cost=1 * MS)
    b1 = P.backends.SimServeBackend("b1", n_slots=4,
                                    service_ns_per_cost=1 * MS)
    gw = P.gateway.Gateway(
        [b0, b1], clock=clock, controller=ctl,
        quotas={"t": P.admission.TenantQuota(rate=1e6, burst=1e6)})
    gw.submit("t", None)
    gw.tick()
    return b0.depth(), b1.depth()


def test_stale_alive_view_is_not_trusted_for_ranking():
    assert _stale_alive(PORT) == (0, 1) == _stale_alive(REF)


def _lease_authority(P):
    clock = P.clock.VirtualClock()
    members = [P.gateway.Gateway(
        [P.backends.SimServeBackend(f"{n}b{j}", n_slots=2,
                                    service_ns_per_cost=2 * MS, seed=j)
         for j in range(2)], clock=clock, name=n) for n in ("gw0", "gw1")]
    ctl = P.dist.Controller(clock=clock)
    calls = {"lease": 0, "deposit": 0}
    real_lease, real_deposit = ctl.admission_lease, ctl.admission_deposit

    def lease(*a, **kw):
        calls["lease"] += 1
        return real_lease(*a, **kw)

    def deposit(*a, **kw):
        calls["deposit"] += 1
        return real_deposit(*a, **kw)

    ctl.admission_lease, ctl.admission_deposit = lease, deposit
    fed = P.fed.FederatedGateway(members, controller=ctl, clock=clock)
    attached = ctl.admission_broker is fed.broker
    quota = P.admission.TenantQuota(rate=100.0, burst=10.0,
                                    slo=P.admission.BATCH)
    fed.register_tenant("t", quota)
    leased = calls["lease"]
    has_lease = any(k[0] == "t" for k in fed.broker.leases)
    home = fed.ring.lookup("t")
    fed.submit("t", None, cost=1)
    fed.drain(home)
    return (attached, leased, has_lease, calls["deposit"],
            fed.lease_audit())


def test_controller_routes_admission_leases():
    got = _lease_authority(PORT)
    attached, leased, has_lease, deposits, _ = got
    assert attached and leased > 0 and has_lease and deposits > 0
    assert got == _lease_authority(REF)


def test_controller_without_broker_raises(P):
    ctl = P.dist.Controller()
    with pytest.raises(RuntimeError):
        ctl.admission_lease("t", "gw0", 1.0, 0, 1000)
    with pytest.raises(RuntimeError):
        ctl.admission_deposit("t", "gw0", 1.0, 0)


def _health_routing(P):
    clock = P.clock.VirtualClock()
    ctl = P.dist.Controller(clock=clock)
    h = P.controller.AgentHandle("b0", client=None, probe=None)
    h.info = {"n_jobs": 3}
    h.breaker = "open"
    h.observed_ns = clock.now_ns()
    ctl.agents["b0"] = h
    dead = P.controller.AgentHandle("b1", client=None, probe=None)
    dead.alive = False
    dead.observed_ns = clock.now_ns()
    ctl.agents["b1"] = dead
    health = ctl.backend_health()
    bs = [P.backends.SimServeBackend(f"b{i}", n_slots=2,
                                     service_ns_per_cost=1 * MS)
          for i in range(3)]
    gw = P.gateway.Gateway(
        bs, clock=clock, controller=ctl,
        quotas={"t": P.admission.TenantQuota(rate=1e6, burst=1e6)})
    for _ in range(2):
        gw.submit("t", None)
    gw.tick()
    return health, [b.depth() for b in bs]


def test_controller_backend_health_feeds_routing():
    health, depths = _health_routing(PORT)
    assert health == {
        "b0": {"alive": True, "breaker": "open", "load": 3,
               "observed_ns": 0, "stale": False, "service_p99_ns": 0},
        "b1": {"alive": False, "breaker": "closed", "load": 0,
               "observed_ns": 0, "stale": False, "service_p99_ns": 0},
    }
    assert depths == [0, 0, 2]
    assert (health, depths) == _health_routing(REF)


def _service_p99(P):
    clock = P.clock.VirtualClock()
    ctl = P.dist.Controller(clock=clock)
    h = P.controller.AgentHandle("b0", client=None, probe=None)
    h.observed_ns = clock.now_ns()
    ctl.agents["b0"] = h
    be = P.backends.SimServeBackend("b0", n_slots=2,
                                    service_ns_per_cost=1 * MS)
    gw = P.gateway.Gateway(
        [be], clock=clock, controller=ctl,
        quotas={"t": P.admission.TenantQuota(rate=1e6, burst=1e6)},
        feedback_period_ns=5 * MS)
    for _ in range(4):
        gw.submit("t", None)
    for _ in range(40):
        clock.advance(1 * MS)
        gw.tick()
    return (ctl.backend_health()["b0"]["service_p99_ns"],
            gw.hist.quantile("be:b0", "*", "service", 0.99))


def test_gateway_publishes_backend_service_p99_to_controller():
    got = _service_p99(PORT)
    assert got[0] > 0 and got[0] == got[1]
    assert got == _service_p99(REF)


def test_note_backend_service_ignores_unknown_names(P):
    ctl = P.dist.Controller()
    ctl.note_backend_service("nobody", 5)
    assert ctl.backend_health() == {}
