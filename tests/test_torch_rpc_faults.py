"""``pbs_tpu_torch.dist.rpc`` and the controller's breaker under injected
faults, against ``pbs_tpu``'s: twins of ``tests/test_rpc_faults.py``.

Every case runs on both packages (``P``): bounded retries with
deterministic backoff under a per-op deadline, idempotency tokens making
a retried mutation exactly-once server-side, a timeout mid-frame killing
the socket, a wedged server thread reported in the system console, and
the circuit breaker quarantining an agent that keeps faulting ops
without declaring it dead. ``test_backoff_schedule_equal_across_packages``
holds the jitter itself equal.
"""

from __future__ import annotations

import importlib
import socket
import time
import types

import pytest


def _ns(root: str) -> types.SimpleNamespace:
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    return types.SimpleNamespace(
        root=root, dist=mod("dist"), rpc=mod("dist.rpc"),
        injector=mod("faults.injector"), plan=mod("faults.plan"),
        console=mod("obs.console"))


REF, PORT = _ns("pbs_tpu"), _ns("pbs_tpu_torch")


@pytest.fixture(params=["pbs_tpu", "pbs_tpu_torch"])
def P(request):
    return REF if request.param == "pbs_tpu" else PORT


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    yield
    for Q in (REF, PORT):
        Q.injector.uninstall()


@pytest.fixture()
def server(P):
    srv = P.rpc.RpcServer()
    calls = {"n": 0}

    def bump(by: int = 1) -> int:
        calls["n"] += by
        return calls["n"]

    def sleepy(delay_s: float) -> str:
        time.sleep(delay_s)
        return "slept"

    srv.register("bump", bump)
    srv.register("sleepy", sleepy)
    srv.register("echo", lambda x: x)
    srv.start()
    yield srv
    srv.stop()


def _client(P, srv, **kw):
    kw.setdefault("backoff_base_s", 0.001)
    kw.setdefault("backoff_cap_s", 0.002)
    return P.rpc.RpcClient(srv.address, fault_key="t", **kw)


def _plan(P, fault: str, times: int = 1, **args) -> None:
    P.injector.install(P.plan.FaultPlan(seed=0, specs=(
        P.plan.FaultSpec("rpc.client", fault, p=1.0, times=times,
                  args=args),)))


# -- satellite: timeout mid-frame must close the socket ---------------------


def test_timeout_mid_frame_closes_socket_no_desync(P, server):
    cli = _client(P, server, max_retries=0)
    assert cli.call("echo", x=1) == 1  # connection warmed up
    with pytest.raises((socket.timeout, OSError)):
        # The reply arrives ~0.5 s after the deadline: without the
        # close, it would sit in the stream and desync every later
        # call on the reused socket (reply N answering call N+1).
        cli.call("sleepy", delay_s=0.6, _timeout=0.1)
    assert cli._sock is None  # the socket died with the call
    time.sleep(0.7)  # let the orphaned reply land on the DEAD socket
    assert cli.call("echo", x="after") == "after"  # fresh connection
    cli.close()


# -- satellite: stop() must report a thread it failed to join ---------------


def test_server_stop_reports_unjoined_thread(P):
    import threading

    obs_console = P.console

    srv = P.rpc.RpcServer()
    srv.start()
    addr = srv.address
    cursor = obs_console.read_system()["next"]
    srv.stop()  # healthy stop: joins, nothing logged
    lines = obs_console.read_system(cursor)["lines"]
    assert not any("failed to join" in l["line"] for l in lines)
    # Wedge the serve thread (a handler stuck in a never-returning op)
    # and stop again: the leak must land in the system console ring.
    ev = threading.Event()
    wedged = threading.Thread(target=ev.wait, daemon=True)
    wedged.start()
    srv._thread = wedged
    srv.join_timeout_s = 0.05
    srv.stop()
    ev.set()
    lines = obs_console.read_system(cursor)["lines"]
    assert any("failed to join" in l["line"]
               and f"{addr[0]}:{addr[1]}" in l["line"] for l in lines)


# -- retries + idempotency --------------------------------------------------


@pytest.mark.parametrize("fault", ["drop_reply", "drop_request", "reset"])
def test_retry_absorbs_transport_fault_exactly_once(P, server, fault):
    _plan(P, fault)
    cli = _client(P, server)
    assert cli.call("bump") == 1
    assert cli.retries == 1
    # the op ran ONCE even when the executed attempt's reply was lost
    assert server.op_executions["bump"] == 1
    assert server.idem_hits == (1 if fault == "drop_reply" else 0)
    cli.close()


def test_duplicate_frame_deduplicated_server_side(P, server):
    _plan(P, "duplicate")
    cli = _client(P, server)
    assert cli.call("bump") == 1
    assert cli.call("bump") == 2  # stream still in sync after the dup
    assert server.op_executions["bump"] == 2
    assert server.idem_hits == 1
    cli.close()


def test_garbled_frame_recovers(P, server):
    _plan(P, "garble")
    cli = _client(P, server)
    assert cli.call("bump") == 1
    assert server.op_executions["bump"] == 1
    cli.close()


def test_injected_delay_stretches_call(P, server):
    _plan(P, "delay", delay_s=0.05)
    cli = _client(P, server)
    t0 = time.monotonic()
    assert cli.call("echo", x=1) == 1
    assert time.monotonic() - t0 >= 0.05
    assert cli.retries == 0
    cli.close()


def test_retries_bounded_then_raise(P, server):
    _plan(P, "drop_reply", times=10)  # more drops than budget
    cli = _client(P, server, max_retries=2)
    with pytest.raises((socket.timeout, OSError)):
        cli.call("bump")
    assert cli.retries == 2
    assert server.op_executions["bump"] == 1  # executed once, never again
    cli.close()


def test_deadline_bounds_whole_retry_loop(P, server):
    # Root cause of the long-standing failure here: the old plan
    # seeded exactly 100 drops against max_retries=100, betting that
    # 100 backoffs (base 1 ms, cap 2 ms, jitter 0.5-1.0x) would
    # outlast the 0.2 s deadline. They sum to ~0.1-0.15 s, so on any
    # non-loaded host the loop DRAINED the fault budget before the
    # deadline and attempt 101 succeeded — DID NOT RAISE. The test was
    # racing wall-clock sleep totals against its own deadline, not
    # testing the deadline. Now the fault budget and retry budget are
    # both effectively infinite, so the ONLY thing that can end the
    # call is the deadline itself — which is the property under test.
    _plan(P, "drop_request", times=10 ** 6)
    cli = _client(P, server, max_retries=10 ** 6)
    t0 = time.monotonic()
    with pytest.raises((socket.timeout, OSError)):
        cli.call("bump", _deadline=0.2)
    elapsed = time.monotonic() - t0
    # The backoff clamp in _call_raw wakes the loop AT the deadline:
    # generous slack for a loaded CI box, but never a runaway loop.
    assert 0.2 <= elapsed < 2.0
    cli.close()


def test_concurrent_same_token_executes_once(P, server):
    # The race the in-flight marker closes: a retry overtakes its own
    # still-running first attempt (per-attempt timeout fired mid-op).
    # The duplicate must park and replay, never re-execute.
    import threading

    state = {"n": 0}

    def slowbump() -> int:
        time.sleep(0.2)
        state["n"] += 1
        return state["n"]

    server.register("slowbump", slowbump)
    req = {"op": "slowbump", "args": {}, "idem": "race.tok.1"}
    out = []
    ts = [threading.Thread(target=lambda c=_client(P, server): out.append(
        c._roundtrip(req))) for _ in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert out == [{"ok": True, "result": 1}] * 2  # both saw ONE execution
    assert state["n"] == 1
    assert server.idem_hits == 1


def test_lockfree_probes_do_not_churn_idem_cache(P, server):
    cli = _client(P, server)
    cli.call("bump")
    assert len(server._idem_cache) == 1
    for _ in range(20):
        cli.call("ping")  # read-only probes must not occupy LRU slots
    assert len(server._idem_cache) == 1
    cli.close()


def test_token_prefixes_unguessable_and_restart_unique(P, server):
    # A guessable or restart-colliding prefix lets a stale/foreign
    # token hit the cache: prefixes carry 8 random bytes.
    a, b = _client(P, server), _client(P, server)
    assert a._idem_prefix != b._idem_prefix
    assert len(a._idem_prefix.rsplit(".", 1)[-1]) == 16  # urandom(8).hex()
    a.close(), b.close()


def test_backoff_deterministic_and_capped(P, server):
    cli = _client(P, server, backoff_base_s=0.004, backoff_cap_s=0.01)
    seq = [cli._backoff("op", a) for a in range(1, 6)]
    assert seq == [cli._backoff("op", a) for a in range(1, 6)]  # no RNG
    assert all(0.002 <= b <= 0.01 for b in seq)  # jitter in [0.5,1.0)x
    cli.close()


# -- acceptance: 10 % drop/reset plan over a real controller round ----------


def test_round_survives_ten_percent_drop_reset_plan(P):
    # rpc_chaos(drop=0.04, drop_reply=0.03, reset=0.03): the ISSUE's
    # 10 % drop/reset mix. strict=True means any agent error raises
    # ClusterRoundError — retries must absorb every injected fault.
    P.injector.install(P.plan.FaultPlan.rpc_chaos(seed=0))
    agents = [P.dist.Agent(f"x{i}").start() for i in range(3)]
    ctl = P.dist.Controller(dead_after_missed=1 << 30)
    issued = 0
    try:
        for a in agents:
            ctl.add_agent(a.name, a.address)
        for i in range(3):
            ctl.create_job(f"j{i}", "sim", {"step_time_ns": 200_000})
            issued += 1
        for _ in range(4):
            ctl.run_round(max_rounds=5, strict=True)  # no ClusterRoundError
        executed = sum(a.server.op_executions.get("create_job", 0)
                       for a in agents)
        assert executed == issued  # no mutating op ran twice
        assert sum(a.server.idem_hits for a in agents) + sum(
            h.client.retries for h in ctl.agents.values()) > 0, \
            "plan injected nothing — the test proved nothing"
    finally:
        P.injector.uninstall()
        ctl.close()
        for a in agents:
            a.stop()


# -- circuit breaker --------------------------------------------------------


def test_repeated_op_faults_quarantine_then_half_open_probe_recovers(P):
    agents = [P.dist.Agent(f"b{i}").start() for i in range(2)]
    ctl = P.dist.Controller(dead_after_missed=1 << 30, breaker_threshold=2,
                     breaker_cooldown=1)
    try:
        for a in agents:
            ctl.add_agent(a.name, a.address)
        ctl.create_job("j", "sim", {"step_time_ns": 200_000})
        # Every `run` op on b0 crashes in-band: transport stays healthy.
        P.injector.install(P.plan.FaultPlan(seed=0, specs=(
            P.plan.FaultSpec("agent.op", "crash", p=1.0, key="b0:run"),)))
        h = ctl.agents["b0"]
        for _ in range(2):
            ctl.run_round(max_rounds=2, strict=False)
            assert isinstance(ctl.last_round_errors.get("b0"), P.rpc.RpcError)
        assert h.breaker == "open"
        assert h.alive  # quarantined, NOT dead — no job re-placement
        # Quarantined hosts sit rounds out and never take placements.
        ctl.run_round(max_rounds=2, strict=False)
        assert "b0" not in ctl.last_round_errors
        assert all(t.name != "b0" for t in ctl.place(4))
        P.injector.uninstall()
        ctl.heartbeat()  # healthy ping ticks the cooldown -> half-open
        assert h.breaker == "half_open"
        ctl.run_round(max_rounds=2, strict=False)  # probe round passes
        assert h.breaker == "closed"
        assert h.consecutive_faults == 0
    finally:
        P.injector.uninstall()
        ctl.close()
        for a in agents:
            a.stop()


def test_breaker_trips_on_non_run_op_faults(P):
    # The quarantine must feed off EVERY op path, not just run_round:
    # a host whose create_job keeps faulting stops taking placements.
    agents = [P.dist.Agent(f"e{i}").start() for i in range(2)]
    ctl = P.dist.Controller(dead_after_missed=1 << 30, breaker_threshold=2)
    try:
        for a in agents:
            ctl.add_agent(a.name, a.address)
        P.injector.install(P.plan.FaultPlan(seed=0, specs=(
            P.plan.FaultSpec("agent.op", "crash", p=1.0, key="e0:create_job"),)))
        made, failed = 0, 0
        for i in range(8):
            try:
                ctl.create_job(f"j{i}", "sim", {"step_time_ns": 200_000})
                made += 1
            except P.rpc.RpcError:
                failed += 1
        h = ctl.agents["e0"]
        assert h.breaker == "open"
        assert h.alive  # faulting ops are not death
        assert failed >= ctl.breaker_threshold
        # once quarantined, placement routes around it: creates succeed
        assert made >= 1
        assert all(m.agent == "e1" for n in ctl.jobs.values()
                   for m in n.members)
    finally:
        P.injector.uninstall()
        ctl.close()
        for a in agents:
            a.stop()


def test_half_open_probe_failure_reopens_breaker(P):
    agents = [P.dist.Agent(f"c{i}").start() for i in range(2)]
    ctl = P.dist.Controller(dead_after_missed=1 << 30, breaker_threshold=1,
                     breaker_cooldown=1)
    try:
        for a in agents:
            ctl.add_agent(a.name, a.address)
        ctl.create_job("j", "sim", {"step_time_ns": 200_000})
        P.injector.install(P.plan.FaultPlan(seed=0, specs=(
            P.plan.FaultSpec("agent.op", "crash", p=1.0, key="c0:run"),)))
        h = ctl.agents["c0"]
        ctl.run_round(max_rounds=2, strict=False)
        assert h.breaker == "open"
        ctl.heartbeat()
        assert h.breaker == "half_open"
        ctl.run_round(max_rounds=2, strict=False)  # probe fails again
        assert h.breaker == "open"
    finally:
        P.injector.uninstall()
        ctl.close()
        for a in agents:
            a.stop()


def test_backoff_schedule_equal_across_packages():
    """The jitter is a hash of (fault_key, op, attempt): both packages
    sleep the same schedule, and their knob-declared envelopes agree."""
    a = PORT.rpc.RpcClient(("127.0.0.1", 1), fault_key="k")
    b = REF.rpc.RpcClient(("127.0.0.1", 1), fault_key="k")
    assert [a._backoff(op, n) for op in ("run", "ping") for n in range(1, 9)] \
        == [b._backoff(op, n) for op in ("run", "ping") for n in range(1, 9)]
    for name in ("RPC_MAX_RETRIES", "RPC_BACKOFF_BASE_S",
                 "RPC_BACKOFF_CAP_S", "RPC_TIMEOUT_S"):
        assert getattr(PORT.rpc, name) == getattr(REF.rpc, name)
