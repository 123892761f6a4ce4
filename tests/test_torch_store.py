"""``pbs_tpu_torch.store`` and the controller's persistence against
``pbs_tpu``'s.

- The store's cases (``tests/test_ckpt_store_events.py``'s store half,
  the store cases of ``tests/test_grants_xsm.py`` and
  ``tests/test_advice_fixes.py``, ``tests/test_cli.py``'s ``store``) run
  on both packages (``P``).
- A file persisted by one package loads in the other, and the two write
  the same bytes for the same ops.
- Twins of ``tests/test_controller_persist.py``: ``save_state`` /
  ``load_state`` over each package's ``Store``, a restart while a host
  is down (a real agent process killed with SIGKILL), the transactional
  save, the Remus CLI surface. The reference runs its agents in
  subprocesses; here they run in process but for the one that is
  killed.
"""

from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys
import time
import types

import pytest

from test_torch_procfed import time_limit

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ns(root: str) -> types.SimpleNamespace:
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    return types.SimpleNamespace(
        root=root, store=mod("store"), dist=mod("dist"),
        xsm=mod("runtime.xsm"), cli=mod("cli.pbst"))


REF, PORT = _ns("pbs_tpu"), _ns("pbs_tpu_torch")


@pytest.fixture(params=["pbs_tpu", "pbs_tpu_torch"])
def P(request):
    return REF if request.param == "pbs_tpu" else PORT


@pytest.fixture(autouse=True)
def _reset_policy():
    yield
    for Q in (REF, PORT):
        Q.xsm.set_policy(Q.xsm.DummyPolicy())


# -- the store ----------------------------------------------------------------


def test_store_tree_ops(P):
    s = P.store.Store()
    s.write("/jobs/train/weight", 512)
    s.write("/jobs/train/cap", 0)
    s.write("/jobs/serve/weight", 256)
    assert s.read("/jobs/train/weight") == 512
    assert s.ls("/jobs") == ["serve", "train"]
    assert s.ls("/jobs/train") == ["cap", "weight"]
    assert s.rm("/jobs/train") == 2
    assert not s.exists("/jobs/train/weight")
    assert s.ls("/jobs") == ["serve"]
    assert s.version("/jobs/train/weight") == 2


def test_store_watch_fires_on_subtree(P):
    s = P.store.Store()
    hits = []
    s.watch("/jobs", lambda p, v: hits.append((p, v)))
    s.write("/jobs/a/x", 1)
    s.write("/other", 2)
    assert hits == [("/jobs/a/x", 1)]


def test_store_transaction_conflict(P):
    s = P.store.Store()
    s.write("/k", 1)
    t1 = s.transaction()
    assert t1.read("/k") == 1
    t1.write("/k", 2)
    s.write("/k", 99)
    with pytest.raises(P.store.TransactionError):
        t1.commit()
    assert s.read("/k") == 99
    t2 = s.transaction()
    t2.write("/k", t2.read("/k") + 1)
    t2.commit()
    assert s.read("/k") == 100


def test_store_persistence(P, tmp_path):
    p = str(tmp_path / "store.json")
    s1 = P.store.Store(persist_path=p)
    s1.write("/a/b", [1, 2, 3])
    s2 = P.store.Store(persist_path=p)
    assert s2.read("/a/b") == [1, 2, 3]


def test_store_rejects_relative_paths(P):
    with pytest.raises(ValueError):
        P.store.Store().write("relative", 1)


def test_transaction_watch_fires_once_per_key_after_commit(P):
    s = P.store.Store()
    hits = []
    s.watch("/", lambda p, v: hits.append((p, v)))
    t = s.transaction()
    t.write("/a", 1)
    t.write("/b", 2)
    t.commit()
    assert sorted(hits) == [("/a", 1), ("/b", 2)]


def test_store_write_enforces_policy(P):
    P.xsm.set_policy(P.xsm.LabelPolicy().allow("app", "store.write",
                                               "/jobs/*"))
    s = P.store.Store()
    s.write("/jobs/a/weight", 256, subject="app")
    with pytest.raises(P.xsm.XsmDenied):
        s.write("/secrets/key", "x", subject="app")
    s.write("/secrets/key", "x")
    assert s.read("/jobs/a/weight") == 256


def test_store_rm_and_transactions_cannot_bypass_policy(P):
    P.xsm.set_policy(P.xsm.LabelPolicy().allow("app", "store.write",
                                               "/jobs/*"))
    s = P.store.Store()
    s.write("/secrets/key", "x")
    with pytest.raises(P.xsm.XsmDenied):
        s.rm("/secrets", subject="app")
    t = s.transaction(subject="app")
    t.write("/jobs/a", 1)
    t.write("/secrets/key", "y")
    with pytest.raises(P.xsm.XsmDenied):
        t.commit()
    assert not s.exists("/jobs/a")
    assert s.read("/secrets/key") == "x"


def test_store_read_ls_watch_checked(P):
    s = P.store.Store()
    s.write("/jobs/a", 1)
    P.xsm.set_policy(P.xsm.LabelPolicy().allow("app", "store.write",
                                               "/jobs/*"))
    with pytest.raises(P.xsm.XsmDenied):
        s.read("/jobs/a", subject="app")
    with pytest.raises(P.xsm.XsmDenied):
        s.ls("/jobs", subject="app")
    with pytest.raises(P.xsm.XsmDenied):
        s.watch("/jobs", lambda p, v: None, subject="app")
    with pytest.raises(P.xsm.XsmDenied):
        s.exists("/jobs/a", subject="app")
    with pytest.raises(P.xsm.XsmDenied):
        s.version("/jobs/a", subject="app")
    P.xsm.set_policy(P.xsm.LabelPolicy()
                     .allow("app", "store.write", "/jobs/*")
                     .allow("app", "store.read", "/jobs*"))
    assert s.read("/jobs/a", subject="app") == 1
    assert s.ls("/jobs", subject="app") == ["a"]
    assert s.read("/jobs/a") == 1


def test_store_cli(P, tmp_path, capsys):
    db = str(tmp_path / "store.json")
    main = P.cli.main
    assert main(["store", "write", "/jobs/a/weight", "512", "--db", db]) == 0
    assert main(["store", "read", "/jobs/a/weight", "--db", db]) == 0
    assert capsys.readouterr().out.strip() == "512"
    assert main(["store", "ls", "/jobs", "--db", db]) == 0
    assert capsys.readouterr().out.strip() == "a"
    assert main(["store", "read", "/nope", "--db", db]) == 1
    assert main(["store", "write", "/jobs/b", "--db", db]) == 2
    assert main(["store", "rm", "/jobs", "--db", db]) == 0
    assert capsys.readouterr().out.strip() == "1"


def _ops(s):
    s.write("/cluster/agents/a0", {"host": "127.0.0.1", "port": 7001})
    s.write("/cluster/jobs/j", {"workload": "sim", "members": [
        {"agent": "a0", "job": "j"}], "spec": {"max_steps": 5}})
    t = s.transaction()
    t.rm("/cluster/agents")
    t.write("/cluster/agents/a1", {"host": "127.0.0.1", "port": 7002})
    t.write("/é", [1.5, None, True])
    t.commit()
    s.write("/k", 1)
    s.rm("/k")


def test_persisted_file_loads_across_packages(tmp_path):
    """The same ops write the same bytes in both packages; a file
    persisted by either loads in the other with every value and
    version."""
    paths = {}
    for P in (REF, PORT):
        paths[P.root] = str(tmp_path / f"{P.root}.json")
        _ops(P.store.Store(persist_path=paths[P.root]))
    with open(paths["pbs_tpu"], "rb") as a, \
            open(paths["pbs_tpu_torch"], "rb") as b:
        assert a.read() == b.read()
    for writer, reader in (("pbs_tpu", PORT), ("pbs_tpu_torch", REF)):
        s = reader.store.Store(persist_path=paths[writer])
        assert s.ls("/cluster/agents") == ["a1"]
        assert s.read("/cluster/jobs/j")["spec"] == {"max_steps": 5}
        assert s.read("/é") == [1.5, None, True]
        assert s.version("/k") == 2 and not s.exists("/k")
        assert s.version("/cluster/agents/a0") == 2
        with open(paths[writer]) as f:
            raw = json.load(f)
        assert set(raw) == {"data", "version"}


# -- controller persistence (twins of tests/test_controller_persist.py) ------


@pytest.fixture()
def hosts(P):
    agents = [P.dist.Agent(f"cp{i}", n_executors=1).start()
              for i in range(3)]
    ctl = P.dist.Controller()
    for a in agents:
        ctl.add_agent(a.name, a.address)
    yield ctl, agents
    ctl.close()
    for a in agents:
        a.stop()


def test_save_load_round_trip(P, hosts):
    ctl, _ = hosts
    ctl.create_job("persist", spec={"step_time_ns": 1_000_000},
                   n_members=2)
    peers = ctl.enable_replication("persist", period_s=0.5)
    store = P.store.Store()
    ctl.save_state(store)
    ctl2 = P.dist.Controller.load_state(store)
    try:
        assert set(ctl2.agents) == set(ctl.agents)
        rec = ctl2.jobs["persist"]
        assert [m.job for m in rec.members] == ["persist.0", "persist.1"]
        assert rec.replica_peers == peers
        ctl2.run_round(max_rounds=20)
        assert sum(ctl2.job_steps("persist").values()) > 0
    finally:
        ctl2.close()


def test_save_state_loads_in_the_other_package(tmp_path):
    """A cluster map persisted by one package's controller into its
    store file is loaded by the other package's controller (and store)
    with the same job records."""
    maps = {}
    for saver, loader in ((REF, PORT), (PORT, REF)):
        agents = [saver.dist.Agent(f"x{i}").start() for i in range(3)]
        ctl = saver.dist.Controller()
        try:
            for a in agents:
                ctl.add_agent(a.name, a.address)
            ctl.create_job("g", spec={"step_time_ns": 1_000_000},
                           n_members=2)
            ctl.create_job("s", spec={"step_time_ns": 500_000})
            ctl.enable_replication("g", period_s=3600.0)
            path = str(tmp_path / f"{saver.root}.store")
            ctl.save_state(saver.store.Store(persist_path=path))
            ctl2 = loader.dist.Controller.load_state(
                loader.store.Store(persist_path=path))
            try:
                got = {n: (r.workload, r.spec, r.gang,
                           [(m.agent, m.job) for m in r.members],
                           r.replica_peers, r.replica_period_s)
                       for n, r in ctl2.jobs.items()}
                want = {n: (r.workload, r.spec, r.gang,
                            [(m.agent, m.job) for m in r.members],
                            r.replica_peers, r.replica_period_s)
                        for n, r in ctl.jobs.items()}
                assert got == want
                assert all(h.alive for h in ctl2.agents.values())
                ctl2.run_round(max_rounds=5)
                maps[saver.root] = got
            finally:
                ctl2.close()
        finally:
            ctl.close()
            for a in agents:
                a.stop()
    assert maps["pbs_tpu"] == maps["pbs_tpu_torch"]


AGENT_MAIN = """
import sys, time
from pbs_tpu_torch.dist import Agent
a = Agent(sys.argv[1], n_executors=1).start()
print(f"ADDR {a.address[0]} {a.address[1]}", flush=True)
while True:
    time.sleep(1)
"""


class HostProc:
    """A port agent in a process of its own, so it can die by SIGKILL."""

    def __init__(self, name: str):
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        self.name = name
        self.proc = subprocess.Popen(
            [sys.executable, "-c", AGENT_MAIN, name],
            stdout=subprocess.PIPE, text=True, env=env)
        line = self.proc.stdout.readline().strip()
        assert line.startswith("ADDR "), f"agent boot failed: {line!r}"
        _, host, port = line.split()
        self.address = (host, int(port))

    def kill9(self) -> None:
        self.proc.kill()
        self.proc.wait(timeout=10)

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=10)
        self.proc.stdout.close()


@time_limit(120)
def test_restart_with_dead_host_recovers():
    """The controller restarts while a host is down (a real agent
    process, SIGKILLed): load marks it dead and recover() fails the
    member over from its replica."""
    victim = HostProc("cpv")
    agents = [PORT.dist.Agent(f"cp{i}", n_executors=1).start()
              for i in range(2)]
    ctl = PORT.dist.Controller()
    ctl2 = None
    try:
        ctl.add_agent(victim.name, victim.address)
        for a in agents:
            ctl.add_agent(a.name, a.address)
        ctl.create_job("surv", spec={"step_time_ns": 1_000_000})
        assert ctl.jobs["surv"].members[0].agent == "cpv"
        ctl.enable_replication("surv", period_s=0.05)
        for _ in range(2):
            ctl.run_round(max_rounds=20)
            time.sleep(0.08)
        store = PORT.store.Store()
        ctl.save_state(store)
        victim.kill9()
        ctl.close()
        ctl2 = PORT.dist.Controller.load_state(store)
        assert "cpv" in ctl2.agents
        for _ in range(ctl2.dead_after_missed + 1):
            alive = ctl2.heartbeat()
        assert alive["cpv"] is False
        assert ctl2.recover() == ["surv"]
        ctl2.run_round(max_rounds=20)
        assert sum(ctl2.job_steps("surv").values()) > 0
    finally:
        if ctl2 is not None:
            ctl2.close()
        for a in agents:
            a.stop()
        victim.stop()


def test_save_is_transactional(P, hosts):
    ctl, _ = hosts
    ctl.create_job("txj", spec={"step_time_ns": 1_000_000})
    store = P.store.Store()
    snapshots = []
    store.watch("/cluster", lambda p, v: snapshots.append(
        sorted(store.ls("/cluster/jobs"))))
    ctl.save_state(store)
    assert snapshots and all(s == ["txj"] for s in snapshots)


def test_load_state_preserves_controller_subject(P, hosts):
    ctl, _ = hosts
    store = P.store.Store()
    ctl.save_state(store)
    ctl2 = P.dist.Controller.load_state(store, subject="ops")
    try:
        assert ctl2.subject == "ops"
    finally:
        ctl2.close()


def test_load_state_dead_hosts_cost_one_timeout(P, hosts):
    ctl, _ = hosts
    store = P.store.Store()
    ctl.save_state(store)
    tx = store.transaction()
    for i in range(4):
        tx.write(f"/cluster/agents/ghost{i}",
                 {"host": "127.0.0.1", "port": 1})
    tx.commit()
    t0 = time.monotonic()
    ctl2 = P.dist.Controller.load_state(store)
    dt = time.monotonic() - t0
    try:
        assert all(not ctl2.agents[f"ghost{i}"].alive for i in range(4))
        assert dt < 10.0, dt
    finally:
        ctl2.close()


def test_slash_names_rejected_at_source(hosts):
    ctl, _ = hosts
    with pytest.raises(ValueError, match="no '/'"):
        ctl.create_job("team/run1", spec={"step_time_ns": 1_000_000})
    with pytest.raises(ValueError, match="no '/'"):
        ctl.add_agent("rack/host", ("127.0.0.1", 1))
    with pytest.raises(ValueError, match="non-empty"):
        ctl.create_job("", spec={})


def test_replicate_cli_bad_peer_is_usage_error(P, hosts):
    ctl, _ = hosts
    ctl.create_job("bp", spec={"step_time_ns": 1_000_000})
    src = ctl.agents[ctl.jobs["bp"].members[0].agent]
    addr = f"{src.address[0]}:{src.address[1]}"
    assert P.cli.main(["replicate", "start", "bp", "--connect", addr,
                       "--peer", "backuphost"]) == 1


def test_replicate_cli_surface(P, hosts, capsys):
    ctl, _ = hosts
    ctl.create_job("clij", spec={"step_time_ns": 1_000_000})
    home = ctl.jobs["clij"].members[0].agent
    src = ctl.agents[home]
    backup = next(h for h in ctl.agents.values() if h.name != home)
    src_addr = f"{src.address[0]}:{src.address[1]}"
    peer_addr = f"{backup.address[0]}:{backup.address[1]}"
    main = P.cli.main
    assert main(["replicate", "start", "clij", "--connect", src_addr,
                 "--peer", peer_addr, "--period", "5.0"]) == 0
    st = json.loads(capsys.readouterr().out)
    assert st["job"] == "clij" and st["epochs_committed"] == 1
    assert main(["replicate", "status", "clij",
                 "--connect", src_addr]) == 0
    assert json.loads(capsys.readouterr().out)[0]["job"] == "clij"
    assert main(["replicas", "--connect", peer_addr]) == 0
    assert "clij" in capsys.readouterr().out
    assert main(["replicate", "stop", "clij", "--connect", src_addr]) == 0
    assert json.loads(capsys.readouterr().out) == {"stopped": True}
    assert main(["replicate", "start", "clij",
                 "--connect", src_addr]) == 1
