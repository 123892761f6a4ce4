"""The partition's control plane on the port against ``pbs_tpu``'s:
security labels (xsm), lifecycle hooks, trace rings, the file-backed
ledger and its monitor sidecar, the watchdogs and crash dumps, the
boot-parameter registry and the lock profiler.

Each case runs as a function of a package namespace on both packages:
it makes the reference test's own assertions (``tests/test_grants_xsm.py``'s
xsm cases, ``test_image_console_hooks.py``'s hook and console cases,
``test_faults.py``'s watchdog and crash-dump cases,
``test_params_lockprof.py``'s params and lockprof cases), and what the
two runs observe must be equal: decisions, hook environments, dumps,
trace records word for word, ledger and sidecar bytes. No tolerance.
The cases whose subject is not ported (agents, the store, the
controller, Remus, the CLI, images over the control plane) stay out.
"""

from __future__ import annotations

import importlib
import json
import os
import threading
import time
import types

import numpy as np
import pytest

pytest.importorskip("jax", reason="parity tests need the JAX reference")

import torch  # noqa: E402

# The suite runs in parallel worker processes: uncapped, torch's intra-op
# pool takes every core in each of them and oversubscribes the host.
torch.set_num_threads(2)

MS = 1_000_000


def _ns(root: str) -> types.SimpleNamespace:
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    rt, tel = mod("runtime"), mod("telemetry")
    return types.SimpleNamespace(
        root=root, rt=rt, tel=tel, xsm=mod("runtime.xsm"),
        hooks=mod("runtime.hooks"), watchdog=mod("runtime.watchdog"),
        params=mod("utils.params"), lockprof=mod("obs.lockprof"),
        trace=mod("obs.trace"), clock=mod("utils.clock"),
        sched=mod("sched"), Job=rt.Job, Partition=rt.Partition,
        SchedParams=rt.SchedParams, ContextState=rt.ContextState,
        Virq=rt.Virq, SimBackend=tel.SimBackend, SimProfile=tel.SimProfile,
        Counter=tel.Counter, Ledger=tel.Ledger)


REF = _ns("pbs_tpu")
PORT = _ns("pbs_tpu_torch")


@pytest.fixture(autouse=True)
def _clean_globals():
    for P in (REF, PORT):
        P.params.reset_all()
        P.lockprof.reset()
        P.xsm.set_policy(P.xsm.DummyPolicy())
    yield
    for P in (REF, PORT):
        P.params.reset_all()
        P.lockprof.reset()
        P.xsm.set_policy(P.xsm.DummyPolicy())


def _twin(case, tmp_path):
    """Run a case on both packages, each in its own scratch directory;
    the observables must be equal."""
    out = {}
    for tag, P in (("ref", REF), ("port", PORT)):
        d = tmp_path / tag
        d.mkdir()
        got = json.dumps(case(P, d), sort_keys=True, default=str)
        out[tag] = got.replace(str(d), "<tmp>").replace(P.root + ".",
                                                        "<pkg>.")
    assert out["port"] == out["ref"]


def _raises(exc, fn, match=None) -> str:
    with pytest.raises(exc, match=match) as e:
        fn()
    return f"{type(e.value).__name__}: {e.value}"


def _console(job) -> list[str]:
    return [ln["line"] for ln in job.console.read()["lines"]]


def _steady(P, be, name, step_ns=1 * MS):
    be.register(name, P.SimProfile.steady(step_time_ns=step_ns))


# -- xsm (tests/test_grants_xsm.py) -------------------------------------


def x_label_policy_rules_first_match_wins(P, d):
    pol = (P.xsm.LabelPolicy()
           .deny("tenant-*", "job.destroy", "prod")
           .allow("tenant-*", "job.*")
           .allow("ops", "*"))
    got = [pol.check("tenant-a", "job.create", "dev"),
           pol.check("tenant-a", "job.destroy", "prod"),
           pol.check("ops", "store.write", "/x"),
           pol.check("nobody", "job.create", "dev"),
           pol.check("system", "anything", None)]
    assert got == [True, False, True, False, True]
    assert ("nobody", "job.create", "dev") in pol.denials
    return [got, pol.denials, P.xsm.DummyPolicy().check("x", "y", None)]


def x_partition_admission_enforces_policy(P, d):
    P.xsm.set_policy(P.xsm.LabelPolicy().allow("scheduler", "job.create",
                                               "user"))
    be = P.SimBackend()
    part = P.Partition("p", source=be, scheduler="credit")
    for n in ("ok", "secret", "secret2"):
        _steady(P, be, n)
    part.add_job(P.Job("ok"), subject="scheduler")
    denied = _raises(P.xsm.XsmDenied, lambda: part.add_job(
        P.Job("secret", label="classified"), subject="scheduler"))
    part.add_job(P.Job("secret2", label="classified"))
    removal = _raises(P.xsm.XsmDenied, lambda: part.remove_job(
        part.job("secret2"), subject="scheduler"))
    assert isinstance(P.xsm.XsmDenied("a", "b", None), PermissionError)
    return [denied, removal, [j.name for j in part.jobs],
            P.xsm.get_policy().denials]


def x_denied_admission_leaves_no_claim_and_no_slot(P, d):
    """A label the policy denies ``job.create`` makes ``add_job`` raise
    before any claim: no HBM account, no compile-cache claim, no ledger
    slot taken."""
    from importlib import import_module

    mem = import_module(f"{P.root}.runtime.memory")
    gate = import_module(f"{P.root}.runtime.compile_gate")
    P.xsm.set_policy(P.xsm.LabelPolicy(default_allow=True)
                     .deny("tenant", "job.create", "blocked"))
    mm = mem.MemoryManager(1 << 30)
    adm = gate.CompileAdmission(gate.CompileBudget(max_programs=4),
                                meter=object())
    be = P.SimBackend()
    part = P.Partition("p", source=be, memory=mm, compile_admission=adm,
                       ledger_slots=4)
    _steady(P, be, "x")
    free_before = list(part._free_slots)
    msg = _raises(P.xsm.XsmDenied, lambda: part.add_job(
        P.Job("x", label="blocked", mem_bytes=1 << 20), subject="tenant"))
    assert mm.dump()["accounts"] == {}
    assert adm.programs == {}
    assert part._free_slots == free_before and part.jobs == []
    ok = part.add_job(P.Job("x", label="open", mem_bytes=1 << 20),
                      subject="tenant")
    assert mm.dump()["accounts"]["x"]["used"] == 1 << 20
    return [msg, mm.dump(), adm.programs, ok.contexts[0].ledger_slot]


XSM_CASES = [x_label_policy_rules_first_match_wins,
             x_partition_admission_enforces_policy,
             x_denied_admission_leaves_no_claim_and_no_slot]


@pytest.mark.parametrize("case", XSM_CASES, ids=lambda c: c.__name__)
def test_xsm_case_twin(case, tmp_path):
    _twin(case, tmp_path)


# -- hooks and consoles (tests/test_image_console_hooks.py) --------------


def _boom(msg):
    def hook(ev, env):
        raise RuntimeError(msg)
    return hook


def h_hooks_fire_with_env(P, d):
    seen = []
    be = P.SimBackend()
    _steady(P, be, "j")
    part = P.Partition("p", source=be)
    for ev in ("job-add", "job-sleep", "job-wake", "job-remove"):
        part.hooks.on(ev, lambda ev, env: seen.append((ev, env)))
    job = part.add_job(P.Job("j", max_steps=10, label="ml"))
    part.sleep_job(job)
    part.sleep_job(job)  # no change, no event
    part.wake_job(job)
    part.wake_job(job)  # awake already: no change, no event
    part.remove_job(job)
    assert [ev for ev, _ in seen] == ["job-add", "job-sleep", "job-wake",
                                      "job-remove"]
    assert all(env["PBST_JOB"] == "j" and env["PBST_PARTITION"] == "p"
               for _, env in seen)
    return [seen, part.hooks.dump(), _console(job)]


def h_required_add_hook_failure_aborts_admission(P, d):
    be = P.SimBackend()
    _steady(P, be, "j")
    part = P.Partition("p", source=be)
    part.hooks.on("job-add", _boom("no dataset mount"), required=True)
    msg = _raises(P.hooks.HookError, lambda: part.add_job(
        P.Job("j", max_steps=10)), match="no dataset mount")
    assert part.jobs == []
    part.hooks._hooks["job-add"].clear()
    job = part.add_job(P.Job("j", max_steps=10))
    return [msg, part.hooks.dump(), _console(job), part.dump()]


def h_required_hook_unwinds_claims_and_slots(P, d):
    """The whole admission unwinds: the HBM account and the compile
    claim are given back, the ledger slots go back on the freelist,
    and the meta sidecar attributes no slot to the vetoed job."""
    from importlib import import_module

    mem = import_module(f"{P.root}.runtime.memory")
    gate = import_module(f"{P.root}.runtime.compile_gate")
    mm = mem.MemoryManager(1 << 30)
    adm = gate.CompileAdmission(gate.CompileBudget(max_programs=4),
                                meter=object())
    be = P.SimBackend()
    _steady(P, be, "veto")
    ledger_path = str(d / "led")
    part = P.Partition("p", source=be, memory=mm, compile_admission=adm,
                       ledger_path=ledger_path, ledger_slots=8)
    part.hooks.on("job-add", _boom("denied"), required=True)
    free_before = list(part._free_slots)
    msg = _raises(P.hooks.HookError, lambda: part.add_job(
        P.Job("veto", max_steps=10, n_contexts=2, mem_bytes=4096)))
    assert part.jobs == [] and sorted(part._free_slots) == sorted(
        free_before)
    assert mm.dump()["accounts"] == {} and adm.programs == {}
    with open(ledger_path + ".meta.json") as f:
        meta = json.load(f)
    assert meta["slots"] == {}
    return [msg, meta, mm.dump(), part.scheduler.dump_settings()]


def h_optional_hook_failure_contained_and_logged(P, d):
    be = P.SimBackend()
    _steady(P, be, "j")
    part = P.Partition("p", source=be)
    part.hooks.on("job-add", _boom("tracker down"))
    job = part.add_job(P.Job("j", max_steps=10))
    assert part.hooks.failures == 1
    assert any("tracker down" in ln for ln in _console(job))
    return [part.hooks.dump(), _console(job)]


def _crashing_backend(P, **kw):
    if P is PORT:
        return P.tel.CudaBackend(device="cpu", **kw)
    return P.tel.source.TpuBackend(**kw)


def h_shell_hook_runs_with_env(P, d):
    out = d / "hookout"
    reg = P.hooks.HookRegistry()
    reg.on("job-fail", f'echo "$PBST_JOB:$PBST_LABEL:$PBST_ERROR" > {out}')
    reg.on("job-fail", "exit 3")  # optional: contained, counted
    part = P.Partition("p", source=_crashing_backend(P))
    part.hooks = reg

    def bad(state):
        raise ValueError("boom")

    job = part.add_job(P.Job("crashy", step_fn=bad, state=0, max_steps=5,
                             label="lab"))
    part.run(max_rounds=3)
    text = out.read_text()
    assert "crashy:lab:ValueError: boom" in text
    return [text, reg.dump(), _console(job)[-2:]]


def h_fail_hook_fires_on_containment(P, d):
    failures = []
    part = P.Partition("p", source=_crashing_backend(P))
    part.hooks.on("job-fail",
                  lambda ev, env: failures.append(env["PBST_ERROR"]))

    def bad(state):
        raise RuntimeError("cosmic ray")

    part.add_job(P.Job("unlucky", step_fn=bad, state=0, max_steps=5))
    part.run(max_rounds=3)
    assert failures and "cosmic ray" in failures[0]
    return failures


def h_hook_events_are_the_references(P, d):
    reg = P.hooks.HookRegistry()
    msg = _raises(ValueError, lambda: reg.on("job-explode", print))
    return [P.hooks.EVENTS, msg, reg.dump()]


def h_console_ring_and_cursors(P, d):
    from importlib import import_module

    Console = import_module(f"{P.root}.obs.console").Console
    c = Console(capacity=4)
    for i in range(6):
        c.write(f"line{i}")
    r = c.read(since=0)
    assert r["dropped"] == 2
    assert [ln["line"] for ln in r["lines"]] == [
        "line2", "line3", "line4", "line5"]
    assert c.read(since=r["next"])["lines"] == []
    return [r["dropped"], r["next"], [ln["line"] for ln in r["lines"]]]


def h_job_lifecycle_lands_in_console(P, d):
    be = P.SimBackend()
    _steady(P, be, "j")
    part = P.Partition("p", source=be)
    job = part.add_job(P.Job("j", max_steps=2))
    job.log("hello from the guest")
    part.run(max_rounds=5)
    lines = _console(job)
    assert any("admitted to p" in ln for ln in lines)
    assert "hello from the guest" in lines
    return lines


def h_fault_containment_writes_console(P, d):
    part = P.Partition("p", source=_crashing_backend(P))

    def bad(state):
        raise RuntimeError("device on fire")

    job = part.add_job(P.Job("burny", step_fn=bad, state=0, max_steps=5))
    part.run(max_rounds=3)
    assert any("FAULT contained" in ln and "device on fire" in ln
               for ln in _console(job))
    return _console(job)


def h_create_job_admits_through_the_same_path(P, d):
    be = P.SimBackend()
    _steady(P, be, "made")
    part = P.Partition("p", source=be)
    seen = []
    part.hooks.on("job-add", lambda ev, env: seen.append(env))
    job = part.create_job("made", params=P.SchedParams(weight=512),
                          max_steps=3, label="batch")
    part.run()
    assert job in part.jobs and job.steps_retired() == 3
    return [seen, part.dump(), job.params.tslice_us]


HOOK_CASES = [
    h_hooks_fire_with_env,
    h_required_add_hook_failure_aborts_admission,
    h_required_hook_unwinds_claims_and_slots,
    h_optional_hook_failure_contained_and_logged,
    h_shell_hook_runs_with_env,
    h_fail_hook_fires_on_containment,
    h_hook_events_are_the_references,
    h_console_ring_and_cursors,
    h_job_lifecycle_lands_in_console,
    h_fault_containment_writes_console,
    h_create_job_admits_through_the_same_path,
]


@pytest.mark.parametrize("case", HOOK_CASES, ids=lambda c: c.__name__)
def test_hook_case_twin(case, tmp_path):
    _twin(case, tmp_path)


# -- trace rings, the file-backed ledger and its sidecar -----------------


def _faulty_backend(P, victim: str, after: int, seed: int = 0):
    class FaultyBackend(P.SimBackend):
        def execute(self, ctx, n_steps):
            if (ctx.job.name == victim
                    and self._steps_done[ctx.job.name] >= after):
                raise RuntimeError(f"injected fault in {ctx.name}")
            return super().execute(ctx, n_steps)

    return FaultyBackend(seed=seed)


def _traced_run(P, d, batching: bool):
    """Two lanes under credit + FeedbackPolicy: jittered tenants, a
    TOKENS overflow sample that fires and is rearmed, a fault contained
    mid-run, sleep/wake churn; file-backed ledger and rings."""
    be = _faulty_backend(P, "victim", after=40, seed=9)
    part = P.Partition("p", source=be, scheduler="credit", n_executors=2,
                       ledger_path=str(d / "led"), trace_dir=str(d / "tr"))
    if batching:
        part.enable_trace_batching(capacity=16, flush_ns=2 * MS)
    fb = P.sched.FeedbackPolicy(part)
    Profile = P.SimProfile
    specs = [("serve", Profile.steady(step_time_ns=80_000, stall_frac=0.1,
                                      tokens=32, jitter=0.2), 256),
             ("train", Profile.steady(step_time_ns=300_000, stall_frac=0.5,
                                      collective_wait_ns=3_000,
                                      jitter=0.1), 512),
             ("victim", Profile.steady(step_time_ns=150_000), 256)]
    jobs = []
    for name, prof, w in specs:
        be.register(name, prof)
        jobs.append(part.add_job(P.Job(name, params=P.SchedParams(weight=w))))
    sid = part.sampler.arm(jobs[0].contexts[0], P.Counter.TOKENS, 2_000)
    frames = []
    for i in range(1, 41):
        if part.sampler.pending():
            part.sampler.drain()
            part.sampler.rearm(sid)
        if i == 10:
            part.sleep_job(jobs[1])
        elif i == 14:
            part.wake_job(jobs[1])
        part.run(until_ns=i * 3 * MS)
        frames.append(part.drain_traces().tolist())
    part.flush_traces()
    return part, fb, jobs, frames


def _trace_obs(P, d, batching):
    part, fb, jobs, frames = _traced_run(P, d, batching)
    ev = P.trace.Ev
    flat = [r for f in frames for r in f]
    kinds = {int(r[1]) for r in flat}
    assert {int(ev.SCHED_PICK), int(ev.SCHED_DESCHED),
            int(ev.TELEM_OVERFLOW), int(ev.JOB_FAILED)} <= kinds
    failed = [r for r in flat if int(r[1]) == int(ev.JOB_FAILED)]
    assert [r[2] for r in failed] == [jobs[2].contexts[0].ledger_slot]
    files = {n: open(d / "tr" / n, "rb").read().hex()
             for n in sorted(os.listdir(d / "tr"))}
    with open(d / "led.meta.json") as f:
        meta = json.load(f)
    return dict(frames=frames, rings=files, meta=meta,
                ledger=open(d / "led", "rb").read().hex(),
                dump=part.dump(), fb=fb.dump(),
                formatted=P.trace.format_records(
                    np.array(flat[:64], dtype=np.uint64)))


def test_trace_records_equal_word_for_word(tmp_path):
    """The same seeded sim run leaves the same records in both
    packages' rings (SCHED_PICK/SCHED_DESCHED on each lane, the
    sampler's TELEM_OVERFLOW, JOB_FAILED naming the faulting slot),
    the same ring files, ledger bytes and meta sidecar."""
    out = {}
    for tag, P in (("ref", REF), ("port", PORT)):
        d = tmp_path / tag
        d.mkdir()
        got = _trace_obs(P, d, batching=False)
        got["meta"]["trace_dir"] = got["meta"]["trace_dir"].replace(
            str(d), "<tmp>")
        out[tag] = got
    for key in out["ref"]:
        assert out["port"][key] == out["ref"][key], key


def test_batched_traces_hold_the_same_records(tmp_path):
    """With trace batching the records reach the rings at flush
    granularity; the stream is the same in both packages, and the same
    records as unbatched once time-sorted."""
    out = {}
    for tag, P in (("ref", REF), ("port", PORT)):
        d = tmp_path / tag
        d.mkdir()
        out[tag] = _traced_run(P, d, batching=True)[3]
    assert out["port"] == out["ref"]
    d = tmp_path / "plain"
    d.mkdir()
    plain = _traced_run(PORT, d, batching=False)[3]
    key = lambda r: tuple(r)  # noqa: E731
    assert sorted(sum(out["port"], []), key=key) == sorted(
        sum(plain, []), key=key)


def test_trace_switch_and_peek(tmp_path):
    for P in (REF, PORT):
        be = P.SimBackend()
        _steady(P, be, "j", 100_000)
        part = P.Partition("p", source=be)
        part.add_job(P.Job("j", max_steps=20))
        part.trace_enabled = False
        part.run()
        assert len(part.drain_traces()) == 0
        part.trace_enabled = True
        part.add_job(P.Job("k", max_steps=5))
        be.register("k", P.SimProfile.steady(step_time_ns=100_000))
        part.run()
        peeked = part.peek_traces()
        assert len(peeked) == 10
        assert part.drain_traces().tolist() == peeked.tolist()
        assert len(part.drain_traces()) == 0


def test_monitor_reads_the_ledger_file_like_the_contexts(tmp_path):
    """A second, read-only attach of ``ledger_path=`` (a monitor in
    another process) reads the words the contexts' counters hold, and
    the sidecar names each slot's job."""
    d = tmp_path / "p"
    d.mkdir()
    part, fb, jobs, _ = _traced_run(PORT, d, batching=False)
    mon = PORT.Ledger.file_backed(str(d / "led"), readonly=True)
    meta = json.load(open(d / "led.meta.json"))
    assert meta["scheduler"] == "credit" and meta["n_rings"] == 2
    for job in jobs:
        for c in job.contexts:
            assert mon.snapshot(c.ledger_slot).tolist() == \
                c.counters.tolist()
            assert meta["slots"][str(c.ledger_slot)]["job"] == job.name


# -- watchdogs and crash dumps (tests/test_faults.py) ---------------------


def _two_tenant_partition(P, be):
    part = P.Partition("p", source=be, scheduler="credit")
    _steady(P, be, "victim")
    _steady(P, be, "bystander")
    victim = part.add_job(P.Job("victim", params=P.SchedParams(weight=256)))
    bystander = part.add_job(P.Job("bystander",
                                   params=P.SchedParams(weight=256),
                                   max_steps=200))
    return part, victim, bystander


def _dump_doc(path) -> dict:
    doc = json.loads(open(path).read())
    if "exception" in doc:
        doc["exception"].pop("traceback")
    return doc


def w_fault_contained_to_one_job(P, d):
    be = _faulty_backend(P, "victim", 10)
    part, victim, bystander = _two_tenant_partition(P, be)
    failed_virqs = []
    part.events.bind_virq(P.Virq.JOB_FAILED,
                          lambda p: failed_virqs.append(p))
    part.run(until_ns=1_000 * MS)
    assert victim.error is not None and "injected fault" in victim.error
    assert all(c.state is P.ContextState.FAILED for c in victim.contexts)
    assert victim.steps_retired() >= 10
    assert bystander.steps_retired() == 200 and bystander.error is None
    assert failed_virqs
    return [victim.error, part.dump(), failed_virqs]


def w_crash_dump_written_on_contained_fault(P, d):
    be = _faulty_backend(P, "victim", 5)
    part, victim, _ = _two_tenant_partition(P, be)
    P.watchdog.install_crash_handler(part, str(d))
    part.run(until_ns=1_000 * MS)
    dumps = sorted(d.glob("crash-*.json"))
    assert len(dumps) == 1
    doc = _dump_doc(dumps[0])
    assert doc["failed_job"] == "victim"
    assert doc["exception"]["type"] == "RuntimeError"
    assert any(j["job"] == "victim" and j["error"] for j in doc["jobs"])
    assert any("SCHED_PICK" in ln for ln in doc["trace_tail"])
    assert any("SCHED_DESCHED" in ln for ln in doc["trace_tail"])
    assert doc["partition"]["scheduler"]["name"] == "credit"
    return doc


def w_two_crash_dumps_both_capture_trace_tail(P, d):
    be = _faulty_backend(P, "victim", 5)
    part, victim, _ = _two_tenant_partition(P, be)
    part.run(until_ns=50 * MS)
    p1 = P.watchdog.write_crash_dump(str(d), part, reason="first")
    p2 = P.watchdog.write_crash_dump(str(d), part, reason="second")
    d1, d2 = _dump_doc(p1), _dump_doc(p2)
    assert d1["trace_tail"] and d2["trace_tail"]
    assert len(part.drain_traces()) == len(d1["trace_tail"])
    return [d1, d2]


def w_failed_job_trace_names_faulting_context(P, d):
    be = _faulty_backend(P, "victim", 5)
    part, victim, _ = _two_tenant_partition(P, be)
    part.run(until_ns=50 * MS)
    recs = part.drain_traces()
    failed = [r for r in recs if int(r[1]) == P.trace.Ev.JOB_FAILED]
    assert len(failed) == 1
    assert int(failed[0][2]) == victim.contexts[0].ledger_slot
    return recs.tolist()


def w_manual_crash_dump_snapshot(P, d):
    be = P.SimBackend()
    part = P.Partition("p", source=be, scheduler="credit")
    _steady(P, be, "j")
    part.add_job(P.Job("j", max_steps=20))
    part.run(until_ns=100 * MS)
    doc = _dump_doc(P.watchdog.write_crash_dump(
        str(d), part, reason="operator snapshot"))
    assert doc["reason"] == "operator snapshot"
    assert doc["jobs"][0]["contexts"][0]["counters"]["steps_retired"] == 20
    return doc


def w_watchdog_flags_logical_stall(P, d):
    be = P.SimBackend()
    part = P.Partition("p", source=be, scheduler="credit")
    _steady(P, be, "j")
    part.add_job(P.Job("j"))
    stalled, virqs = [], []
    part.events.bind_virq(P.Virq.WATCHDOG, virqs.append)
    wd = P.watchdog.Watchdog(part, period_ns=10 * MS, threshold=2,
                             on_stall=lambda p: stalled.append(p.name))
    for _ in range(5):
        be.clock.advance(10 * MS)
        part.timers.fire_due(be.clock.now_ns())
    assert wd.stalls and stalled == ["p"]
    wd.cancel()
    wd2 = P.watchdog.Watchdog(part, period_ns=10 * MS, threshold=2)
    part.run(until_ns=be.clock.now_ns() + 200 * MS)
    assert wd2.stalls == [] and len(wd.stalls) == 1
    return [wd.stalls, stalled, part.dump()]


def w_watchdog_quiet_with_more_executors_than_contexts(P, d):
    be = P.SimBackend()
    part = P.Partition("p", source=be, scheduler="credit", n_executors=2)
    _steady(P, be, "j")
    part.add_job(P.Job("j", max_steps=100))
    wd = P.watchdog.Watchdog(part, period_ns=10 * MS, threshold=2)
    part.run(until_ns=500 * MS)
    assert wd.stalls == []
    return part.dump()


def w_watchdog_raises_without_stall_policy(P, d):
    be = P.SimBackend()
    part = P.Partition("p", source=be, scheduler="credit")
    _steady(P, be, "j")
    part.add_job(P.Job("j"))
    P.watchdog.Watchdog(part, period_ns=10 * MS, threshold=2)

    def wedge():
        for _ in range(5):
            be.clock.advance(10 * MS)
            part.timers.fire_due(be.clock.now_ns())

    return _raises(P.watchdog.WatchdogStallError, wedge)


WATCHDOG_CASES = [
    w_fault_contained_to_one_job,
    w_crash_dump_written_on_contained_fault,
    w_two_crash_dumps_both_capture_trace_tail,
    w_failed_job_trace_names_faulting_context,
    w_manual_crash_dump_snapshot,
    w_watchdog_flags_logical_stall,
    w_watchdog_quiet_with_more_executors_than_contexts,
    w_watchdog_raises_without_stall_policy,
]


@pytest.mark.parametrize("case", WATCHDOG_CASES, ids=lambda c: c.__name__)
def test_watchdog_case_twin(case, tmp_path):
    _twin(case, tmp_path)


def _wall_partition():
    return PORT.Partition("p", source=PORT.tel.CudaBackend(
        device="cpu", clock=PORT.clock.MonotonicClock()), scheduler="credit")


def test_wall_watchdog_barks_on_hung_step():
    part = _wall_partition()
    part.add_job(PORT.Job("hung", step_fn=lambda s: (time.sleep(0.5), s)[1],
                          state=0, max_steps=1))
    barks = []
    wd = PORT.watchdog.WallWatchdog(part, timeout_s=0.1, poll_s=0.02,
                                    on_bark=lambda p, idle: barks.append(idle))
    with wd:
        part.run(max_rounds=2)
    wd.stop()
    assert wd.barks == 1 and barks and barks[0] >= 0.1


def test_wall_watchdog_context_reuse_restarts_thread():
    part = _wall_partition()
    part.add_job(PORT.Job("hang2", step_fn=lambda s: (time.sleep(0.4), s)[1],
                          state=0, max_steps=2))
    wd = PORT.watchdog.WallWatchdog(part, timeout_s=0.1, poll_s=0.02)
    with wd:
        pass
    with wd:
        part.run(max_rounds=1)
    assert wd.barks >= 1


def test_wall_watchdog_quiet_on_healthy_run():
    part = _wall_partition()
    part.add_job(PORT.Job("ok", step_fn=lambda s: s + 1, state=0,
                          max_steps=50))
    wd = PORT.watchdog.WallWatchdog(part, timeout_s=5.0, poll_s=0.02)
    with wd:
        part.run(max_rounds=100)
    wd.stop()
    assert wd.barks == 0
    assert part.jobs[0].state == 50 and part.progress_epoch > 0


# -- boot params and the lock profiler (tests/test_params_lockprof.py) ---


def p_param_kinds_and_defaults(P, d):
    b = P.params.boolean_param("t_bool", True)
    i = P.params.integer_param("t_int", 42)
    s = P.params.string_param("t_str", "credit")
    assert (b.value, i.value, s.value) == (True, 42, "credit")
    return [repr(b), repr(i), repr(s)]


def p_parse_cmdline_forms(P, d):
    P.params.boolean_param("t_flag", False)
    P.params.integer_param("t_num", 0)
    unknown = P.params.parse_cmdline("t_flag t_num=0x10 bogus=1")
    assert P.params.get("t_flag").value is True
    assert P.params.get("t_num").value == 16
    assert unknown == ["bogus=1"]
    P.params.parse_cmdline("no-t_flag")
    assert P.params.get("t_flag").value is False
    return unknown


def p_parse_cmdline_rejects_bad_values_without_raising(P, d):
    P.params.integer_param("t_strict", 5)
    rejected = P.params.parse_cmdline("t_strict=abc t_strict")
    assert sorted(rejected) == ["t_strict", "t_strict=abc"]
    assert P.params.get("t_strict").value == 5
    return rejected


def p_parse_cmdline_bare_forms_only_for_booleans(P, d):
    P.params.string_param("t_name", "credit")
    rejected = P.params.parse_cmdline("t_name no-t_name")
    assert sorted(rejected) == ["no-t_name", "t_name"]
    assert P.params.get("t_name").value == "credit"
    return rejected


def p_reregistration_preserves_set_value(P, d):
    p = P.params.integer_param("t_keep", 1)
    p.set("7")
    again = P.params.integer_param("t_keep", 1)
    assert again is p and again.value == 7
    return repr(again)


def p_sched_param_picks_partition_scheduler(P, d):
    assert P.params.get("sched").value == "credit"
    P.params.parse_cmdline("sched=credit2")
    part = P.Partition("p", source=P.SimBackend())
    assert type(part.scheduler).__name__ == "Credit2Scheduler"
    part2 = P.Partition("p2", source=P.SimBackend(), scheduler="credit")
    assert type(part2.scheduler).__name__ == "CreditScheduler"
    P.params.parse_cmdline("sched=arinc653")
    part3 = P.Partition("p3", source=P.SimBackend())
    return [part.scheduler.dump_settings(), part3.scheduler.name]


def p_tslice_param_feeds_schedparams_default(P, d):
    assert P.SchedParams().tslice_us == 100
    P.params.parse_cmdline("sched_credit_tslice_us=250")
    assert P.SchedParams().tslice_us == 250
    assert P.SchedParams(tslice_us=90).tslice_us == 90
    be = P.SimBackend()
    _steady(P, be, "j", 50_000)
    part = P.Partition("p", source=be)
    job = part.create_job("j", max_steps=40)
    part.run()
    return [job.params.tslice_us, part.dump()]


def p_tbuf_size_sizes_unsized_rings(P, d):
    assert P.params.get("tbuf_size").value == 4096
    P.params.parse_cmdline("tbuf_size=64")
    ring = P.trace.TraceBuffer(native=False)
    be = P.SimBackend()
    _steady(P, be, "j", 10_000)
    part = P.Partition("p", source=be)
    part.add_job(P.Job("j", max_steps=100))
    part.run()
    lost = [t.lost for t in part.traces]
    return [ring.capacity, part.traces[0].capacity, lost,
            part.drain_traces().tolist()]


def p_lockprof_disabled_counts_nothing(P, d):
    lk = P.lockprof.ProfiledLock("t_quiet")
    with lk:
        pass
    assert lk.stats.acquires == 0
    return lk.stats.as_dict()


def p_lockprof_recursive_reentry_counts_one_hold(P, d):
    P.params.get("lock_profile").set("on")
    lk = P.lockprof.ProfiledLock("t_rec", recursive=True)
    with lk:
        t_outer = lk._t_acq
        with lk:
            assert lk._t_acq == t_outer
        assert lk.stats.hold_ns == 0
    assert lk.stats.acquires == 2 and lk.stats.hold_ns > 0
    assert lk._t_acq is None
    return [lk.stats.acquires, lk.stats.contended]


def p_lockprof_toggle_midstream_no_stale_hold(P, d):
    lk = P.lockprof.ProfiledLock("t_toggle")
    P.params.get("lock_profile").set("on")
    with lk:
        pass
    hold0 = lk.stats.hold_ns
    P.params.get("lock_profile").set("off")
    lk.acquire()
    P.params.get("lock_profile").set("on")
    lk.release()
    assert lk.stats.hold_ns == hold0
    return lk.stats.acquires


def p_lockprof_dump_sorted_and_reset(P, d):
    P.params.get("lock_profile").set("on")
    a = P.lockprof.ProfiledLock("t_a")
    with a:
        pass
    assert "t_a" in [r["name"] for r in P.lockprof.dump()]
    P.lockprof.reset()
    assert all(r["acquires"] == 0 for r in P.lockprof.dump())
    return sorted(r["name"] for r in P.lockprof.dump()
                  if r["name"].startswith("t_"))


def p_fault_injector_and_xsm_locks_are_profiled(P, d):
    from importlib import import_module

    P.params.get("lock_profile").set("on")
    injector = import_module(f"{P.root}.faults.injector")
    plan = import_module(f"{P.root}.faults").FaultPlan(seed=3)
    injector.install(plan)
    injector.uninstall()
    P.xsm.set_policy(P.xsm.DummyPolicy())
    rows = {r["name"]: r for r in P.lockprof.dump()}
    assert rows["fault_install"]["acquires"] >= 2
    assert rows["xsm_policy"]["acquires"] >= 1
    return [rows[n]["acquires"] for n in ("fault_install", "xsm_policy")]


PARAM_CASES = [
    p_param_kinds_and_defaults,
    p_parse_cmdline_forms,
    p_parse_cmdline_rejects_bad_values_without_raising,
    p_parse_cmdline_bare_forms_only_for_booleans,
    p_reregistration_preserves_set_value,
    p_sched_param_picks_partition_scheduler,
    p_tslice_param_feeds_schedparams_default,
    p_tbuf_size_sizes_unsized_rings,
    p_lockprof_disabled_counts_nothing,
    p_lockprof_recursive_reentry_counts_one_hold,
    p_lockprof_toggle_midstream_no_stale_hold,
    p_lockprof_dump_sorted_and_reset,
    p_fault_injector_and_xsm_locks_are_profiled,
]


@pytest.mark.parametrize("case", PARAM_CASES, ids=lambda c: c.__name__)
def test_param_case_twin(case, tmp_path):
    _twin(case, tmp_path)


def test_env_override_and_bad_env_value(monkeypatch, capsys):
    monkeypatch.setenv("PBST_T_ENVD", "123")
    assert PORT.params.integer_param("t_envd", 5).value == 123
    monkeypatch.setenv("PBST_T_ENVBAD", "4k")
    assert PORT.params.integer_param("t_envbad", 7).value == 7
    assert "PBST_T_ENVBAD" in capsys.readouterr().err


def test_lockprof_counts_acquires_and_contention():
    PORT.params.get("lock_profile").set("on")
    lk = PORT.lockprof.ProfiledLock("t_lock")
    with lk:
        pass
    assert lk.stats.acquires == 1 and lk.stats.contended == 0

    def _holder():
        with lk:
            time.sleep(0.02)

    t = threading.Thread(target=_holder)
    t.start()
    time.sleep(0.005)
    with lk:
        pass
    t.join()
    assert lk.stats.acquires == 3
    assert lk.stats.contended >= 1
    assert 0 < lk.stats.max_wait_ns <= lk.stats.wait_ns
    assert lk.stats.hold_ns > 0
    assert lk.acquire(blocking=False) and not lk.acquire(blocking=False)
    lk.release()
