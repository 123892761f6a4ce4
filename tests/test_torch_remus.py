"""Remus replication on the port under injected transport faults, against
``pbs_tpu``'s: twins of ``tests/test_remus_faults.py``, run on both
packages (``P``), plus a replicated job failed over across packages.

The commit handshake: ``epochs_committed`` advances only on a real ack
from the backup; retries plus the idempotency token mean a lost reply
still commits exactly one epoch.
"""

from __future__ import annotations

import importlib
import time
import types

import pytest


def _ns(root: str) -> types.SimpleNamespace:
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    return types.SimpleNamespace(
        root=root, dist=mod("dist"), injector=mod("faults.injector"),
        plan=mod("faults.plan"))


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
def pair(P):
    src = P.dist.Agent("rsrc")
    dst = P.dist.Agent("rdst").start()
    src.op_create_job("prot", spec={"step_time_ns": 200_000,
                                    "sched": {"weight": 320}})
    sess = P.dist.RemusSession(src, "prot", dst.address, period_s=3600.0)
    yield src, dst, sess
    sess.client.close()
    dst.stop()
    src.server.stop()


def _remus_plan(P, fault: str, times: int | None = 1) -> None:
    P.injector.install(P.plan.FaultPlan(seed=0, specs=(
        P.plan.FaultSpec("rpc.client", fault, p=1.0, times=times,
                         key="rsrc.remus.prot:push_replica"),)))


@pytest.mark.parametrize("fault", ["drop_reply", "drop_request",
                                   "duplicate", "reset"])
def test_fault_matrix_epoch_advances_exactly_once_per_real_ack(P, pair,
                                                              fault):
    src, dst, sess = pair
    _remus_plan(P, fault)
    assert sess.tick_once() is True
    assert sess.client.retries + dst.server.idem_hits > 0
    assert sess.epochs_committed == 1
    assert sess.failures == 0
    assert dst.server.op_executions["push_replica"] == 1
    assert dst.replicas["prot"]["epoch"] == 0
    assert sess.tick_once() is True
    assert sess.epochs_committed == 2
    assert dst.server.op_executions["push_replica"] == 2
    assert dst.replicas["prot"]["epoch"] == 1


def test_exhausted_retries_do_not_count_an_epoch(P, pair):
    src, dst, sess = pair
    _remus_plan(P, "drop_reply", times=None)
    assert sess.tick_once() is False
    assert sess.epochs_committed == 0
    assert sess.failures == 1
    assert dst.server.op_executions["push_replica"] == 1
    assert dst.replicas["prot"]["epoch"] == 0
    P.injector.uninstall()
    assert sess.tick_once() is True
    assert sess.epochs_committed == 1
    assert dst.server.op_executions["push_replica"] == 2


def test_delayed_duplicate_cannot_roll_replica_back(pair):
    src, dst, sess = pair
    assert sess.tick_once() and sess.tick_once() and sess.tick_once()
    assert dst.replicas["prot"]["epoch"] == 2
    ack = sess.client.call("push_replica", job="prot", epoch=0,
                           saved=src.snapshot_record("prot"),
                           source="rsrc", subject="controller")
    assert ack == {"job": "prot", "epoch": 2, "stale": True}
    assert dst.replicas["prot"]["epoch"] == 2


def test_session_status_and_stop(P, pair):
    src, dst, sess = pair
    assert sess.tick_once()
    st = sess.status()
    assert st == {"job": "prot", "peer": list(dst.address),
                  "period_s": 3600.0, "epochs_committed": 1,
                  "failures": 0, "skipped": 0, "last_error": None,
                  "running": False}
    sess.start()
    assert sess.status()["running"] is True
    sess.stop()
    assert sess.status()["running"] is False


def test_tick_skips_when_the_dispatch_lock_is_held(P, pair):
    """A long op holding the dispatch lock costs the epoch (skipped),
    never a wedged pump."""
    import threading

    src, dst, sess = pair
    held, release = threading.Event(), threading.Event()

    def hold():
        with src.dispatch_lock:
            held.set()
            release.wait(5)

    t = threading.Thread(target=hold)
    t.start()
    held.wait(5)
    t0 = time.monotonic()
    assert sess.tick_once() is False
    assert 0.9 <= time.monotonic() - t0 < 3.0
    release.set()
    t.join()
    assert sess.skipped == 1 and sess.epochs_committed == 0


@pytest.mark.parametrize("src_pkg,dst_pkg",
                         [("pbs_tpu_torch", "pbs_tpu"),
                          ("pbs_tpu", "pbs_tpu_torch")])
def test_replication_and_failover_across_packages(src_pkg, dst_pkg):
    """One package's agent replicates to the other's; the source host
    dies; the backup restores the job from its replica with the steps
    and counters of the last acked epoch."""
    S = PORT if src_pkg == "pbs_tpu_torch" else REF
    D = PORT if dst_pkg == "pbs_tpu_torch" else REF
    src = S.dist.Agent("xsrc").start()
    dst = D.dist.Agent("xdst").start()
    try:
        src.op_create_job("x", spec={"step_time_ns": 1_000_000,
                                     "max_steps": 500,
                                     "sched": {"weight": 640}})
        src.partition.run(max_rounds=20)
        st = src.op_replicate_start("x", *dst.address, period_s=3600.0)
        assert st["epochs_committed"] == 1
        src.partition.run(max_rounds=20)
        assert src.remus["x"].tick_once()
        acked = src.snapshot_record("x")
        src.stop()
        r = dst.op_get_replica("x")
        assert r["epoch"] == 1 and r["source"] == "xsrc"
        out = dst.op_restore_job("x", saved=r["saved"])
        j = dst.partition.job("x")
        assert out["steps"] == sum(c["counters"][0]
                                   for c in r["saved"]["contexts"])
        assert [c.counters.tolist() for c in j.contexts] == \
            [c["counters"] for c in acked["contexts"]]
        assert j.params.weight == 640
        dst.partition.run(max_rounds=20)
        assert j.steps_retired() > out["steps"]
    finally:
        dst.stop()
