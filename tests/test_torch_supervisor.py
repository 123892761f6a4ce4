"""``pbs_tpu_torch.gateway.supervisor`` against ``pbs_tpu``'s: twins of
``tests/test_supervisor.py``.

Every lifecycle case (spawn, heartbeat hygiene, suspect/recover, death
with exponential backoff, restart-budget exhaustion) is written as a
function of a package namespace and runs on both packages under an
injected ``VirtualClock``, with zero processes involved; the two runs'
observables (return values, states, counters, transition logs, error
messages) must be equal. ``ProcessHandle`` is held to the reference's
contract on a real child process.
"""

from __future__ import annotations

import importlib
import json
import time
import types

import pytest

MS = 1_000_000
HB = 10 * MS
BACKOFF = 20 * MS


def _ns(root: str) -> types.SimpleNamespace:
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    return types.SimpleNamespace(sup=mod("gateway.supervisor"),
                                 clock=mod("utils.clock"))


REF, PORT = _ns("pbs_tpu"), _ns("pbs_tpu_torch")


def _sup(S, clock, *, miss_budget=3, max_restarts=2):
    return S.sup.MemberSupervisor(
        "gw0", heartbeat_ns=HB, miss_budget=miss_budget,
        restart_backoff_ns=BACKOFF, max_restarts=max_restarts,
        now_ns=clock.now_ns())


def _view(s) -> dict:
    return {"state": s.state, "pid": s.pid, "misses": s.misses,
            "restarts": s.restarts, "restart_due_ns": s.restart_due_ns,
            "transitions": [list(t) for t in s.transitions]}


def s_spawn_to_live_and_heartbeat_cadence(S):
    clock = S.clock.VirtualClock()
    s = _sup(S, clock)
    out = [s.state, s.beat_due(clock.now_ns())]
    assert s.state == "spawning" and not out[1]
    s.spawned(1234, clock.now_ns())
    assert s.state == "live" and s.pid == 1234
    assert not s.beat_due(clock.now_ns())
    clock.advance(HB)
    assert s.beat_due(clock.now_ns())
    s.beat_ok(clock.now_ns())
    assert not s.beat_due(clock.now_ns())
    return out + [_view(s)]


def s_miss_budget_live_suspect_dead(S):
    clock = S.clock.VirtualClock()
    s = _sup(S, clock, miss_budget=3)
    s.spawned(1, clock.now_ns())
    got = []
    for _ in range(3):
        clock.advance(HB)
        got.append(s.beat_missed(clock.now_ns()))
        if len(got) == 1:
            assert s.state == "suspect" and s.misses == 1
    assert got == ["wait", "wait", "dead"]
    return [got, _view(s)]


def s_heartbeat_resume_clears_suspect_and_misses(S):
    clock = S.clock.VirtualClock()
    s = _sup(S, clock, miss_budget=2)
    s.spawned(1, clock.now_ns())
    clock.advance(HB)
    s.beat_missed(clock.now_ns())
    assert s.state == "suspect"
    clock.advance(HB)
    s.beat_ok(clock.now_ns())
    assert s.state == "live" and s.misses == 0
    clock.advance(HB)
    assert s.beat_missed(clock.now_ns()) == "wait"
    return _view(s)


def s_death_schedules_exponential_backoff(S):
    clock = S.clock.VirtualClock()
    s = _sup(S, clock, max_restarts=3)
    s.spawned(1, clock.now_ns())
    assert s.died(clock.now_ns()) == "backoff"
    assert s.state == "restarting" and s.pid is None
    assert s.restart_due_ns == clock.now_ns() + BACKOFF
    assert not s.restart_due(clock.now_ns())
    clock.advance(BACKOFF)
    assert s.restart_due(clock.now_ns())
    s.spawned(2, clock.now_ns())
    assert s.state == "live" and s.restarts == 1
    assert s.died(clock.now_ns()) == "backoff"
    assert s.restart_due_ns == clock.now_ns() + 2 * BACKOFF
    return _view(s)


def s_restart_budget_exhaustion_is_drain(S):
    clock = S.clock.VirtualClock()
    s = _sup(S, clock, max_restarts=1)
    s.spawned(1, clock.now_ns())
    assert s.died(clock.now_ns()) == "backoff"
    clock.advance(BACKOFF)
    s.spawned(2, clock.now_ns())
    assert s.died(clock.now_ns()) == "drain"
    assert s.state == "failed"
    clock.advance(100 * BACKOFF)
    assert not s.restart_due(clock.now_ns())
    assert not s.beat_due(clock.now_ns())
    return _view(s)


def s_max_restarts_zero_drains_on_first_death(S):
    clock = S.clock.VirtualClock()
    s = _sup(S, clock, max_restarts=0)
    s.spawned(1, clock.now_ns())
    assert s.died(clock.now_ns()) == "drain"
    assert s.state == "failed" and s.restarts == 0
    return _view(s)


def s_transitions_record_the_whole_lifecycle(S):
    clock = S.clock.VirtualClock()
    s = _sup(S, clock, miss_budget=1, max_restarts=1)
    s.spawned(7, clock.now_ns())
    clock.advance(HB)
    assert s.beat_missed(clock.now_ns()) == "dead"
    s.died(clock.now_ns())
    clock.advance(BACKOFF)
    s.spawned(8, clock.now_ns())
    s.died(clock.now_ns())
    assert [(a, b) for _ts, a, b, _r in s.transitions] == [
        ("spawning", "live"), ("live", "suspect"),
        ("suspect", "restarting"), ("restarting", "live"),
        ("live", "failed")]
    return _view(s)


def s_guards(S):
    clock = S.clock.VirtualClock()
    msgs = []
    with pytest.raises(ValueError) as e:
        _sup(S, clock, miss_budget=0)
    msgs.append(str(e.value))
    s = _sup(S, clock)
    s.spawned(1, clock.now_ns())
    with pytest.raises(ValueError) as e:
        s.spawned(2, clock.now_ns())  # spawned() only from down states
    msgs.append(str(e.value))
    return msgs


CASES = [
    s_spawn_to_live_and_heartbeat_cadence,
    s_miss_budget_live_suspect_dead,
    s_heartbeat_resume_clears_suspect_and_misses,
    s_death_schedules_exponential_backoff,
    s_restart_budget_exhaustion_is_drain,
    s_max_restarts_zero_drains_on_first_death,
    s_transitions_record_the_whole_lifecycle,
    s_guards,
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__)
def test_supervisor_case_twin(case):
    got = {tag: json.dumps(case(S), sort_keys=True)
           for tag, S in (("ref", REF), ("port", PORT))}
    assert got["port"] == got["ref"]


def test_supervisor_constants_match():
    assert PORT.sup.STATES == REF.sup.STATES
    assert PORT.sup.REAL_CLOCK_SEAM == REF.sup.REAL_CLOCK_SEAM


def test_process_handle_kill9_and_reap_idempotent():
    h = PORT.sup.ProcessHandle(target=time.sleep, args=(3600,))
    h.start()
    assert h.alive() and h.pid is not None
    h.kill9()
    assert not h.alive()
    assert h.reap() == -9
    assert h.reap() == -9
    assert h.pid is None
    h.kill9()  # idempotent on a dead handle
