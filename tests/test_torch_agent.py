"""The agent's op surface on the port, against ``pbs_tpu``'s: twins of the
agent cases of ``tests/test_paging.py`` (136-180: a paged tenant over
the control plane, a Remus snapshot leaving it paged),
``tests/test_microstep.py`` (218-240: ``micro_progress`` in save
records), ``tests/test_image_console_hooks.py`` (the Remus quiesce and
hooks, an image booted over the wire, the console relay),
``tests/test_grants_xsm.py`` (the agent ops under an enforcing policy),
``tests/test_advice_fixes.py`` (the wire subject trust model, a
malformed multicall entry) and ``tests/test_cli.py:105`` (the xl-style
CLI against live agents), plus the ``notify=False`` repair of
``Partition.sleep_job``/``wake_job``.

Device-free cases run on both packages (``P``). Cases with device
state run the reference on ``TpuBackend`` with a jax state and the port
on ``CudaBackend(device="cpu")`` with a torch state, and compare what
both report. The port's ``Agent(device=)`` binds the device its
``"image"`` workload boots on; ``device="cpu"`` here.
"""

from __future__ import annotations

import importlib
import json
import os
import types

import pytest

import torch

torch.set_num_threads(2)

MS = 1_000_000
TINY = dict(vocab=64, d_model=32, n_layers=1, n_heads=2, n_kv_heads=2,
            d_ff=64, max_seq=64, dtype="float32")


def _ns(root: str) -> types.SimpleNamespace:
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    return types.SimpleNamespace(
        root=root, dist=mod("dist"), rpc=mod("dist.rpc"), rt=mod("runtime"),
        paging=mod("runtime.paging"), xsm=mod("runtime.xsm"),
        tel=mod("telemetry"), source=mod("telemetry.source"),
        cli=mod("cli.pbst"), image=mod("runtime.image"))


REF, PORT = _ns("pbs_tpu"), _ns("pbs_tpu_torch")


@pytest.fixture(params=["pbs_tpu", "pbs_tpu_torch"])
def P(request):
    return REF if request.param == "pbs_tpu" else PORT


@pytest.fixture(autouse=True)
def _reset_policy():
    yield
    for Q in (REF, PORT):
        Q.xsm.set_policy(Q.xsm.DummyPolicy())


def _device_partition(P, name="p"):
    if P is PORT:
        return P.rt.Partition(name, source=P.tel.CudaBackend(device="cpu"))
    return P.rt.Partition(name, source=P.source.TpuBackend())


def _train_job(P, name):
    """A job with device state: a weight tensor nudged each step."""
    if P is PORT:
        state = {"w": torch.ones(256, 64)}

        def step(s):
            return {"w": s["w"] * 0.5}
    else:
        import jax.numpy as jnp

        state = {"w": jnp.ones((256, 64))}

        def step(s):
            return {"w": s["w"] * 0.5}

    return P.rt.Job(name, step_fn=step, state=state, max_steps=100)


# -- paged tenants over the control plane (test_paging.py:136-180) -----------


def _paged_state_visible(P):
    part = _device_partition(P)
    a = P.dist.Agent("ph", partition=part, n_executors=1).start()
    try:
        job = part.add_job(_train_job(P, "pj"))
        cli = P.dist.RpcClient(a.address)
        cli.call("pause_job", job="pj", subject="remote")
        freed = P.paging.page_out_job(part, job)
        paged = cli.call("list_jobs")[0]["state"]
        cli.call("unpause_job", job="pj", subject="remote")
        after = cli.call("list_jobs")[0]["state"]
        cli.close()
        return freed, paged, after, job.paged is None
    finally:
        a.stop()


def test_paged_state_visible_on_control_plane():
    got = _paged_state_visible(PORT)
    assert got == (256 * 64 * 4, "paged", "running", True)
    assert got == _paged_state_visible(REF)


def _remus_leaves_paged(P):
    part = _device_partition(P)
    a = P.dist.Agent("rh", partition=part, n_executors=1)
    try:
        job = part.add_job(_train_job(P, "rj"))
        part.sleep_job(job)
        P.paging.page_out_job(part, job)
        saved = a.snapshot_record("rj")
        return saved["job"], job.paged is not None, a._job_state(job)
    finally:
        a.stop()


def test_remus_snapshot_leaves_paged_job_paged():
    got = _remus_leaves_paged(PORT)
    assert got == ("rj", True, "paged")
    assert got == _remus_leaves_paged(REF)


# -- micro_progress in save records (test_microstep.py:218-240) --------------


def test_micro_progress_travels_in_save_records(P):
    a1 = P.dist.Agent("m1").start()
    a2 = P.dist.Agent("m2").start()
    c1, c2 = P.dist.RpcClient(a1.address), P.dist.RpcClient(a2.address)
    try:
        c1.call("create_job", job="mj",
                spec={"step_time_ns": 1 * MS, "micro_per_step": 4,
                      "max_steps": 10, "sched": {"tslice_us": 250}})
        c1.call("run", max_rounds=5)
        src_ctx = a1.partition.job("mj").contexts[0]
        assert src_ctx.micro_progress != 0
        saved = c1.call("save_job", job="mj")
        assert saved["contexts"][0]["micro_progress"] == \
            src_ctx.micro_progress
        c2.call("restore_job", job="mj", saved=saved)
        dst_ctx = a2.partition.job("mj").contexts[0]
        assert dst_ctx.micro_progress == src_ctx.micro_progress
    finally:
        c1.close()
        c2.close()
        a1.stop()
        a2.stop()


def test_save_records_equal_across_packages():
    """One sim job through the same ops on each package's agent: the
    save record (counters, cursor, sched, provenance) is the same dict,
    and each package's agent restores the other's record."""
    recs = {}
    agents = {P.root: P.dist.Agent(f"s{P.root}") for P in (REF, PORT)}
    try:
        for P in (REF, PORT):
            a = agents[P.root]
            a.op_create_job("sj", spec={"step_time_ns": 1 * MS,
                                        "micro_per_step": 2,
                                        "max_steps": 7,
                                        "sched": {"weight": 384}})
            a.partition.run(max_rounds=200)
            recs[P.root] = a.op_save_job("sj")
        ref, port = recs["pbs_tpu"], recs["pbs_tpu_torch"]
        assert port == ref
        assert sum(c["counters"][0] for c in port["contexts"]) == 7
        for P, rec in ((REF, port), (PORT, ref)):
            a = agents[P.root]
            out = a.op_restore_job("sj2", saved=rec)
            assert out == {"job": "sj2", "steps": 7}
            assert a.op_save_job("sj2")["contexts"] == rec["contexts"]
    finally:
        for a in agents.values():
            a.stop()


# -- hooks, images, consoles (test_image_console_hooks.py) ------------------


def test_remus_quiesce_does_not_fire_lifecycle_hooks(P):
    events = []
    a = P.dist.Agent("qhost", n_executors=1)
    try:
        a.partition.hooks.on("job-sleep", lambda ev, env: events.append(ev))
        a.partition.hooks.on("job-wake", lambda ev, env: events.append(ev))
        a.op_create_job("q", spec={"step_time_ns": 1_000_000,
                                   "max_steps": 100})
        for _ in range(5):
            a.snapshot_record("q")
        assert events == []
        a.op_pause_job("q")
        assert events == ["job-sleep"]
    finally:
        a.stop()


def _hook_script_counts(P, tmp_path):
    """A hook *script* (a shell command) registered for job-sleep and
    job-wake: its runs per pause/unpause, per Remus epoch
    (``snapshot_record``), per migration save (``op_save_job``)."""
    log = tmp_path / f"{P.root}.hooks"
    a = P.dist.Agent("hk", n_executors=1)
    counts = {}

    def runs():
        return log.read_text().splitlines() if log.exists() else []

    try:
        for ev in ("job-sleep", "job-wake"):
            a.partition.hooks.on(ev, f'echo "{ev} $PBST_JOB" >> {log}')
        a.op_create_job("h", spec={"step_time_ns": 1_000_000,
                                   "max_steps": 100})
        a.op_pause_job("h")
        a.op_unpause_job("h")
        counts["pause+unpause"] = runs()
        for _ in range(3):
            a.snapshot_record("h")
        counts["after 3 epochs"] = runs()
        a.op_save_job("h")
        counts["after a save"] = runs()
        a.op_unpause_job("h")
        counts["after the abort's unpause"] = runs()
        return counts
    finally:
        a.stop()


def test_notify_false_quiesce_runs_no_hook_script(tmp_path):
    """The ``notify=`` repair: a hook script for job-sleep runs once per
    ``pause_job`` and zero times per ``snapshot_record`` or migration
    save, in both packages alike."""
    got = _hook_script_counts(PORT, tmp_path)
    assert got == {
        "pause+unpause": ["job-sleep h", "job-wake h"],
        "after 3 epochs": ["job-sleep h", "job-wake h"],
        "after a save": ["job-sleep h", "job-wake h"],
        "after the abort's unpause": ["job-sleep h", "job-wake h",
                                      "job-wake h"],
    }
    assert got == _hook_script_counts(REF, tmp_path)


def test_partition_sleep_wake_notify_signature():
    import inspect

    for meth in ("sleep_job", "wake_job"):
        port = inspect.signature(getattr(PORT.rt.Partition, meth))
        ref = inspect.signature(getattr(REF.rt.Partition, meth))
        assert list(port.parameters) == list(ref.parameters)
        assert port.parameters["notify"].default is True


def _image_over_wire(P, tmp_path):
    path = str(tmp_path / f"{P.root}-img")
    P.image.save_image(path, "transformer", TINY,
                       train={"batch": 2, "seq": 32, "max_steps": 1})
    kw = {"device": "cpu"} if P is PORT else {}
    a = P.dist.Agent("imghost", partition=_device_partition(P),
                     n_executors=1, **kw).start()
    try:
        cli = P.dist.RpcClient(a.address)
        r = cli.call("create_job", job="booted", workload="image",
                     spec={"path": path, "sched": {"weight": 777}})
        cli.call("run", max_rounds=5)
        rows = cli.call("list_jobs")
        saved = cli.call("save_job", job="booted")
        cli.close()
        return (r, rows[0]["steps"], rows[0]["weight"], saved["workload"],
                saved["spec"] == {"path": path, "sched": {"weight": 777}})
    finally:
        a.stop()


def test_image_workload_over_control_plane(tmp_path):
    got = _image_over_wire(PORT, tmp_path)
    assert got == ({"job": "booted", "n_contexts": 1}, 1, 777, "image",
                   True)
    assert got == _image_over_wire(REF, tmp_path)


def test_agent_image_workload_needs_a_device_or_a_card(tmp_path):
    """The port's ``Agent`` binds its device into the image factory:
    the default (the card) raises on a host without one, never falling
    back to the CPU; the other workloads need no device."""
    path = str(tmp_path / "img")
    PORT.image.save_image(path, "transformer", TINY,
                          train={"batch": 2, "seq": 32, "max_steps": 1})
    a = PORT.dist.Agent("nodev")
    try:
        assert a.device is None
        if not torch.cuda.is_available():
            with pytest.raises(Exception):
                a.op_create_job("img", workload="image",
                                spec={"path": path})
            assert a.partition.jobs == []
        a.op_create_job("s", spec={"step_time_ns": 1_000_000,
                                   "max_steps": 2})
        assert a.op_list_jobs()[0]["job"] == "s"
    finally:
        a.stop()
    b = PORT.dist.Agent("cpudev", device="cpu",
                        partition=_device_partition(PORT))
    try:
        b.op_create_job("img", workload="image", spec={"path": path})
        leaf = b.partition.job("img").state[0]["embed"]
        assert leaf.device.type == "cpu"
    finally:
        b.stop()


def test_console_streamed_over_control_plane(P):
    a = P.dist.Agent("chost", n_executors=1).start()
    try:
        cli = P.dist.RpcClient(a.address)
        cli.call("create_job", job="talky",
                 spec={"step_time_ns": 1_000_000, "max_steps": 3})
        cli.call("run", max_rounds=5)
        r = cli.call("console", job="talky", subject="remote")
        lines = [ln["line"] for ln in r["lines"]]
        assert any("admitted" in ln for ln in lines)
        r2 = cli.call("console", job="talky", since=r["next"])
        assert r2["lines"] == []
        cli.close()
    finally:
        a.stop()


def test_console_lines_equal_across_packages():
    got = {}
    for P in (REF, PORT):
        a = P.dist.Agent("eq", n_executors=1)
        try:
            a.op_create_job("c", spec={"step_time_ns": 1_000_000,
                                       "max_steps": 3})
            a.op_pause_job("c")
            a.op_unpause_job("c")
            a.partition.run(max_rounds=10)
            got[P.root] = [ln["line"] for ln in
                           a.op_console("c")["lines"]]
        finally:
            a.stop()
    assert got["pbs_tpu"] == got["pbs_tpu_torch"]


# -- the agent under an enforcing policy (test_grants_xsm.py) ----------------


def test_agent_ops_enforce_policy(P):
    P.xsm.set_policy(P.xsm.LabelPolicy()
                     .allow("ctl", "job.create", "user")
                     .allow("ctl", "job.sched_cntl", "user"))
    agent = P.dist.Agent("a1").start()
    try:
        cli = P.dist.RpcClient(agent.address)
        cli.call("create_job", job="j1", subject="ctl",
                 spec={"max_steps": 5})
        cli.call("sched_setparams", job="j1", weight=512, subject="ctl")
        with pytest.raises(P.rpc.RpcError, match="XsmDenied"):
            cli.call("remove_job", job="j1", subject="ctl")
        with pytest.raises(P.rpc.RpcError, match="XsmDenied"):
            cli.call("create_job", job="evil", subject="intruder",
                     spec={"max_steps": 5})
        cli.close()
    finally:
        agent.stop()


def test_pause_unpause_gated_and_factory_label_rechecked(P):
    def sneaky_workload(partition, job_name, spec):
        partition.source.register(
            job_name, P.tel.SimProfile.steady(step_time_ns=1_000_000))
        return partition.add_job(P.rt.Job(job_name, label="classified",
                                          max_steps=5))

    P.xsm.set_policy(P.xsm.LabelPolicy()
                     .allow("ctl", "job.create", "user")
                     .allow("ctl", "job.pause", "user"))
    agent = P.dist.Agent("a2", workloads={"sneaky": sneaky_workload}).start()
    try:
        cli = P.dist.RpcClient(agent.address)
        with pytest.raises(P.rpc.RpcError, match="XsmDenied"):
            cli.call("create_job", job="s1", workload="sneaky",
                     subject="ctl", spec={"label": "user"})
        assert cli.call("list_jobs") == []
        cli.call("create_job", job="ok", subject="ctl",
                 spec={"max_steps": 5})
        cli.call("pause_job", job="ok", subject="ctl")
        with pytest.raises(P.rpc.RpcError, match="XsmDenied"):
            cli.call("unpause_job", job="ok", subject="ctl")
        with pytest.raises(P.rpc.RpcError, match="XsmDenied"):
            cli.call("pause_job", job="ok", subject="intruder")
        cli.close()
    finally:
        agent.stop()


def test_controller_presents_subject_under_enforcing_policy(P):
    P.xsm.set_policy(P.xsm.LabelPolicy().allow("controller", "job.*"))
    agent = P.dist.Agent("a3").start()
    ctl = P.dist.Controller()
    ctl.add_agent("a3", agent.address)
    try:
        ctl.create_job("cj", spec={"max_steps": 5})
        ctl.sched_setparams("cj", weight=512)
        ctl.remove_job("cj")
        assert ctl.jobs == {}
    finally:
        ctl.close()
        agent.stop()


def test_replica_ops_filtered_by_policy(P):
    """Replica inventory and session status leak only what the subject
    could replicate; a denied drop leaves the replica in place."""
    backup = P.dist.Agent("bk")
    try:
        backup.op_push_replica("u", 0, {"label": "user"}, source="s")
        backup.op_push_replica("t", 0, {"label": "tenantA"}, source="s")
        P.xsm.set_policy(P.xsm.LabelPolicy()
                         .allow("ops", "job.replicate", "user"))
        assert [r["job"] for r in
                backup.op_list_replicas(subject="ops")] == ["u"]
        with pytest.raises(P.xsm.XsmDenied):
            backup.op_drop_replica("t", subject="ops")
        assert "t" in backup.replicas
        with pytest.raises(P.xsm.XsmDenied):
            backup.op_push_replica("t", 5, {"label": "user"}, subject="ops")
        assert backup.replicas["t"]["epoch"] == 0
        stale = backup.op_push_replica("u", -1, {"label": "user"},
                                       subject="ops")
        assert stale == {"job": "u", "epoch": 0, "stale": True}
    finally:
        backup.stop()


# -- the wire trust model (test_advice_fixes.py) -----------------------------


def test_wire_system_subject_rejected_without_auth(P):
    P.xsm.set_policy(P.xsm.LabelPolicy())
    agent = P.dist.Agent("sec0").start()
    cli = P.dist.RpcClient(agent.address)
    try:
        with pytest.raises(P.rpc.RpcError, match="authenticated"):
            cli.call("create_job", job="j", spec={"max_steps": 2},
                     subject="system")
        with pytest.raises(P.rpc.RpcError, match="XsmDenied"):
            cli.call("create_job", job="j", spec={"max_steps": 2},
                     subject="mallory")
    finally:
        cli.close()
        agent.stop()


def test_wire_system_subject_allowed_with_token(P):
    P.xsm.set_policy(P.xsm.LabelPolicy())
    agent = P.dist.Agent("sec1", auth_token="s3cret").start()
    good = P.dist.RpcClient(agent.address, auth_token="s3cret")
    bad = P.dist.RpcClient(agent.address, auth_token="wrong")
    try:
        r = good.call("create_job", job="j", spec={"max_steps": 2},
                      subject="system")
        assert r["job"] == "j"
        with pytest.raises(P.rpc.RpcError, match="auth"):
            bad.call("list_jobs")
    finally:
        good.close()
        bad.close()
        agent.stop()


def test_auth_refused_when_no_token_configured(P):
    agent = P.dist.Agent("sec2").start()
    cli = P.dist.RpcClient(agent.address, auth_token="anything")
    try:
        with pytest.raises(P.rpc.RpcError, match="auth"):
            cli.call("ping")
    finally:
        cli.close()
        agent.stop()


def test_multicall_malformed_entry_keeps_per_entry_status(P):
    import socket

    agent = P.dist.Agent("mc0").start()
    try:
        s = socket.create_connection(agent.address, timeout=5)
        P.rpc.send_msg(s, {"op": "multicall", "calls": [
            {"op": "ping"}, {"op": "ping", "args": [1]}]})
        resp = P.rpc.recv_msg(s)
        s.close()
        assert resp["ok"]
        first, second = resp["result"]
        assert first["ok"] and first["result"] == "pong"
        assert not second["ok"]
    finally:
        agent.stop()


def test_info_answers_while_run_holds_the_dispatch_lock(P):
    """``info`` is registered lock-free: it answers while another
    connection holds the dispatch lock (a long ``run``)."""
    agent = P.dist.Agent("lf").start()
    try:
        cli = P.dist.RpcClient(agent.address, timeout_s=2.0)
        with agent.dispatch_lock:
            assert cli.call("info")["agent"] == "lf"
            assert cli.call("ping") == "pong"
        cli.close()
    finally:
        agent.stop()


# -- the xl-style CLI against live agents (test_cli.py:105) -----------------


def test_cli_live_agent_lifecycle(P, capsys):
    main = P.cli.main
    a1 = P.dist.Agent("cli1", n_executors=1).start()
    a2 = P.dist.Agent("cli2", n_executors=1).start()
    addr1 = f"{a1.address[0]}:{a1.address[1]}"
    addr2 = f"{a2.address[0]}:{a2.address[1]}"
    try:
        assert main(["create", "j", "--connect", addr1,
                     "--spec", '{"step_time_ns": 1000000}',
                     "-w", "512"]) == 0
        assert json.loads(capsys.readouterr().out) == {"job": "j",
                                                       "n_contexts": 1}
        assert main(["run", "--connect", addr1, "--rounds", "20"]) == 0
        assert json.loads(capsys.readouterr().out)["quanta"] > 0
        assert main(["list", "--connect", addr1]) == 0
        out = capsys.readouterr().out
        assert "j " in out and "running" in out and "512" in out
        assert main(["pause", "j", "--connect", addr1]) == 0
        assert main(["list", "--connect", addr1]) == 0
        assert "paused" in capsys.readouterr().out
        assert main(["pause", "j", "--connect", addr1, "--unpause"]) == 0
        assert main(["console", "j", "--connect", addr1]) == 0
        assert "admitted" in capsys.readouterr().out
        assert main(["migrate", "j", "--connect", addr1,
                     "--to", addr2]) == 0
        assert json.loads(capsys.readouterr().out)["job"] == "j"
        assert main(["list", "--connect", addr1]) == 0
        assert "j " not in capsys.readouterr().out
        assert main(["list", "--connect", addr2]) == 0
        assert "j " in capsys.readouterr().out
        assert main(["destroy", "j", "--connect", addr2]) == 0
        assert main(["list", "--connect", addr2]) == 0
        assert "j " not in capsys.readouterr().out
    finally:
        a1.stop()
        a2.stop()


def test_cli_list_output_equal_across_packages(capsys):
    outs = {}
    for P in (REF, PORT):
        a = P.dist.Agent("lst", n_executors=1).start()
        addr = f"{a.address[0]}:{a.address[1]}"
        try:
            for j, w in (("a", 256), ("b", 512)):
                assert P.cli.main(["create", j, "--connect", addr,
                                   "--spec", '{"step_time_ns": 1000000}',
                                   "-w", str(w), "--max-steps", "3"]) == 0
            assert P.cli.main(["pause", "b", "--connect", addr]) == 0
            capsys.readouterr()
            assert P.cli.main(["list", "--connect", addr]) == 0
            outs[P.root] = capsys.readouterr().out.replace(
                f"{a.address[1]}", "PORT")
        finally:
            a.stop()
    assert outs["pbs_tpu"] == outs["pbs_tpu_torch"]
    assert os.linesep.join(outs["pbs_tpu"].splitlines()[2:]).count(
        "paused") == 1
