"""``pbs_tpu_torch.obs.{mon,oprofile}`` against ``pbs_tpu.obs``'s.

Every case of ``tests/test_mon_oprofile.py`` is written as a function
of a package: it runs on both, makes the reference test's own
assertions on each, and the two runs' observables (history windows,
monitor rows, flat profiles, sample lists, lost counts) must be equal.
Both packages' ``SimBackend`` runs are word for word the same, so the
profiles match exactly. Two more cases attach each package's monitor
and profiler to the other package's partition files.
"""

from __future__ import annotations

import dataclasses
import importlib
import types

import numpy as np
import pytest

pytest.importorskip("jax", reason="parity tests need the JAX reference")


def _ns(root: str) -> types.SimpleNamespace:
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    rt, tel = mod("runtime"), mod("telemetry")
    return types.SimpleNamespace(
        root=root, mon=mod("obs.mon"), oprofile=mod("obs.oprofile"),
        trace=mod("obs.trace"), cli=mod("cli.pbst"), Job=rt.Job,
        Partition=rt.Partition, SchedParams=rt.SchedParams,
        SimBackend=tel.SimBackend, SimProfile=tel.SimProfile,
        Counter=tel.Counter, MS=mod("utils.clock").MS)


REF = _ns("pbs_tpu")
PORT = _ns("pbs_tpu_torch")
SEC = 1_000_000_000


@pytest.fixture(autouse=True)
def _release_profiler():
    yield
    for P in (REF, PORT):
        P.oprofile._owner = None  # test hygiene


def _rec(P, ts, ev, *args):
    a = list(args) + [0] * (6 - len(args))
    return np.array([ts, int(ev)] + a, dtype="<u8")


def _windows(h) -> dict:
    return {slot: [dataclasses.asdict(w) for w in h._hist[slot]]
            + [dataclasses.asdict(h._cur[slot]) if slot in h._cur else None]
            for slot in h.slots()}


def _samples(sess) -> dict:
    return {job: [dataclasses.astuple(s) for s in ss]
            for job, ss in sess.samples.items()}


# -- SchedHistory -----------------------------------------------------------


def c_history_folds_sched_events_into_windows(P, tmp):
    MS, Ev = P.MS, P.trace.Ev
    h = P.mon.SchedHistory(window_ns=SEC, n_windows=4)
    recs = np.stack([
        _rec(P, 100, Ev.SCHED_PICK, 7, 500 * MS),
        _rec(P, 200 * MS, Ev.SCHED_DESCHED, 7, 300 * MS),
        _rec(P, 300 * MS, Ev.SCHED_WAKE, 9, 1),
        _rec(P, int(1.5 * SEC), Ev.SCHED_DESCHED, 7, 100 * MS),
    ])
    h.ingest(recs)
    agg_all = h.summary(7)
    assert agg_all.gotten_ns == 400 * MS
    assert agg_all.allocated_ns == 500 * MS
    assert agg_all.execs == 2
    assert h.summary(9).wakes == 1
    assert h.summary(7, windows=0).gotten_ns == 100 * MS
    assert h.cpu_pct(7, windows=1) == pytest.approx(
        100.0 * (300 * MS) / SEC)
    return [_windows(h), h.cpu_pct(7, windows=1), h.records_seen]


def c_history_window_eviction_bounds_memory(P, tmp):
    MS, Ev = P.MS, P.trace.Ev
    h = P.mon.SchedHistory(window_ns=SEC, n_windows=2)
    for i in range(10):
        h.ingest(np.stack([_rec(P, i * SEC + 1, Ev.SCHED_DESCHED, 3, MS)]))
    assert len(h._hist[3]) == 2
    assert h.summary(3).execs == 3
    return _windows(h)


def c_trace_ring_file_attach_roundtrip(P, tmp):
    Ev = P.trace.Ev
    path = str(tmp / "t.ring")
    prod = P.trace.TraceBuffer.file_backed(path, capacity=64)
    cons = P.trace.TraceBuffer.file_backed(path, attach=True)
    assert cons.capacity == 64
    prod.emit(111, Ev.SCHED_PICK, 1, 2)
    prod.emit(222, Ev.SCHED_DESCHED, 1, 3)
    recs = cons.consume()
    assert len(recs) == 2
    assert int(recs[0][0]) == 111 and int(recs[1][1]) == Ev.SCHED_DESCHED
    assert len(cons.consume()) == 0
    return [recs.tolist(), open(path, "rb").read()]


# -- Monitor end-to-end -----------------------------------------------------


def c_monitor_attaches_and_ranks_by_weight(P, tmp):
    MS = P.MS
    ledger = str(tmp / "led.bin")
    tdir = str(tmp / "traces")
    be = P.SimBackend()
    part = P.Partition("mp", source=be, scheduler="credit",
                       ledger_path=ledger, trace_dir=tdir)
    be.register("heavy", P.SimProfile.steady(step_time_ns=1 * MS))
    be.register("light", P.SimProfile.steady(step_time_ns=1 * MS))
    part.add_job(P.Job("heavy", params=P.SchedParams(weight=512)))
    part.add_job(P.Job("light", params=P.SchedParams(weight=256)))
    part.run(until_ns=2 * SEC)

    monitor = P.mon.Monitor(ledger + ".meta.json", window_ns=SEC)
    n = monitor.poll()
    assert n > 0
    rows = {r["job"]: r for r in monitor.rows(windows=10)}
    assert set(rows) == {"heavy", "light"}
    ratio = rows["heavy"]["gotten_ms"] / rows["light"]["gotten_ms"]
    assert 1.5 < ratio < 2.7
    assert rows["heavy"]["execs"] > 0
    return [n, monitor.rows(windows=10)]


def c_cli_mon_renders_rows(P, tmp, capsys):
    MS = P.MS
    ledger = str(tmp / "led.bin")
    tdir = str(tmp / "traces")
    be = P.SimBackend()
    part = P.Partition("clip", source=be, scheduler="credit",
                       ledger_path=ledger, trace_dir=tdir)
    be.register("j", P.SimProfile.steady(step_time_ns=1 * MS))
    part.add_job(P.Job("j", max_steps=50))
    part.run(until_ns=SEC)
    assert P.cli.main(["mon", ledger + ".meta.json", "--iterations", "1",
                       "--windows", "10"]) == 0
    out = capsys.readouterr().out
    assert "pbst mon" in out and " j " in out
    return out


def c_monitor_requires_trace_dir(P, tmp):
    MS = P.MS
    ledger = str(tmp / "led.bin")
    be = P.SimBackend()
    part = P.Partition("np", source=be, ledger_path=ledger)
    be.register("j", P.SimProfile.steady(step_time_ns=1 * MS))
    part.add_job(P.Job("j", max_steps=5))
    part.run(until_ns=SEC)
    with pytest.raises(ValueError, match="trace_dir") as info:
        P.mon.Monitor(ledger + ".meta.json")
    return str(info.value)


# -- ProfileSession ---------------------------------------------------------


def _profiled_partition(P):
    MS = P.MS
    be = P.SimBackend()
    part = P.Partition("pp", source=be, scheduler="credit")
    be.register("busy", P.SimProfile.steady(step_time_ns=1 * MS,
                                            stall_frac=0.4,
                                            collective_wait_ns=10_000))
    be.register("idle", P.SimProfile.steady(step_time_ns=1 * MS))
    part.add_job(P.Job("busy", params=P.SchedParams(weight=256)))
    part.add_job(P.Job("idle", params=P.SchedParams(weight=256),
                       max_steps=1))
    return part, be


def c_profile_session_samples_and_reports(P, tmp):
    part, be = _profiled_partition(P)
    sess = P.oprofile.ProfileSession(part, period_ns=10 * P.MS)
    with sess:
        assert sess.state is P.oprofile.SessionState.RUNNING
        part.run(until_ns=1 * SEC)
    assert sess.state is P.oprofile.SessionState.CLOSED
    rep = sess.report()
    assert rep["busy"]["samples"] > 10
    assert rep["busy"]["stall_pct"] == pytest.approx(40.0, abs=2.0)
    assert rep["busy"]["device_ms"] > 0
    assert rep.get("idle", {"samples": 0})["samples"] <= 2
    return [rep, _samples(sess)]


def c_profile_session_baseline_excludes_presession_history(P, tmp):
    part, be = _profiled_partition(P)
    part.run(until_ns=1 * SEC)
    pre_dev = int(part.jobs[0].contexts[0].counters[1])
    assert pre_dev > 0
    sess = P.oprofile.ProfileSession(part, period_ns=10 * P.MS)
    sess.start()
    part.run(until_ns=be.clock.now_ns() + 200 * P.MS)
    sess.close()
    rep = sess.report()
    assert rep["busy"]["device_ms"] < 250
    return rep


def c_collective_wait_survives_idle_ticks(P, tmp):
    C = P.Counter
    part, be = _profiled_partition(P)
    ctx = part.jobs[0].contexts[0]
    sess = P.oprofile.ProfileSession(part, period_ns=10 * P.MS)
    sess.start()
    for _ in range(3):
        ctx.counters[C.COLLECTIVE_WAIT_NS] += 5_000_000
        be.clock.advance(10 * P.MS)
        part.timers.fire_due(be.clock.now_ns())
    sess.close()
    total_cw = sum(s.coll_wait_dns for s in sess.samples["busy"])
    assert total_cw == 15_000_000
    return _samples(sess)


def c_profiler_reservation_mutual_exclusion(P, tmp):
    part, _ = _profiled_partition(P)
    sess = P.oprofile.ProfileSession(part, period_ns=10 * P.MS)
    with pytest.raises(P.oprofile.ProfilerBusy) as info:
        P.oprofile.ProfileSession(part, period_ns=10 * P.MS)
    sess.close()
    P.oprofile.ProfileSession(part, period_ns=10 * P.MS).close()
    assert P.oprofile.current_owner() is None
    return str(info.value).split(":")[0]


def c_sample_buffer_bounded_with_lost_counter(P, tmp):
    part, be = _profiled_partition(P)
    sess = P.oprofile.ProfileSession(part, period_ns=1 * P.MS,
                                     max_samples_per_job=10)
    sess.start()
    part.run(until_ns=1 * SEC)
    sess.close()
    assert len(sess.samples["busy"]) == 10
    assert sess.lost["busy"] > 0
    assert sess.report()["busy"]["lost"] > 0
    return [sess.lost, sess.report()]


def c_passive_domain_profiling(P, tmp):
    MS = P.MS
    ledger = str(tmp / "foreign.bin")
    be = P.SimBackend()
    foreign = P.Partition("foreign", source=be, ledger_path=ledger)
    be.register("victim", P.SimProfile.steady(step_time_ns=1 * MS,
                                              stall_frac=0.25))
    foreign.add_job(P.Job("victim"))
    foreign.run(until_ns=500 * MS)

    host_be = P.SimBackend()
    host = P.Partition("host", source=host_be, scheduler="credit")
    host_be.register("own", P.SimProfile.steady(step_time_ns=1 * MS))
    host.add_job(P.Job("own", params=P.SchedParams()))
    sess = P.oprofile.ProfileSession(host, period_ns=10 * MS)
    sess.add_passive("foreign", ledger)
    assert sess.state is P.oprofile.SessionState.READY
    sess.start()
    foreign.run(until_ns=1 * SEC)
    host.run(until_ns=host_be.clock.now_ns() + 300 * MS)
    sess.close()
    rep = sess.report()
    key = "foreign/victim"
    assert key in rep and rep[key]["samples"] >= 1
    assert rep[key]["stall_pct"] == pytest.approx(25.0, abs=3.0)
    return rep


def c_passive_only_monitor_session(P, tmp):
    MS = P.MS
    ledger = str(tmp / "foreign.bin")
    be = P.SimBackend()
    foreign = P.Partition("foreign", source=be, ledger_path=ledger)
    be.register("victim", P.SimProfile.steady(step_time_ns=1 * MS,
                                              stall_frac=0.25))
    foreign.add_job(P.Job("victim"))
    foreign.run(until_ns=200 * MS)

    sess = P.oprofile.ProfileSession(None)
    sess.add_passive("f", ledger)
    with pytest.raises(RuntimeError):
        sess.start()
    sess.sample_once(1)
    foreign.run(until_ns=600 * MS)
    sess.sample_once(2)
    sess.close()
    rep = sess.report()
    assert rep["f/victim"]["samples"] >= 1
    assert rep["f/victim"]["device_ms"] > 0
    assert rep["f/victim"]["stall_pct"] == pytest.approx(25.0, abs=3.0)
    return [rep, _samples(sess)]


def c_passive_reset_never_records_negative_deltas(P, tmp):
    MS = P.MS
    ledger = str(tmp / "foreign.bin")
    be = P.SimBackend()
    foreign = P.Partition("foreign", source=be, ledger_path=ledger)
    be.register("victim", P.SimProfile.steady(step_time_ns=1 * MS))
    foreign.add_job(P.Job("victim"))
    foreign.run(until_ns=400 * MS)

    sess = P.oprofile.ProfileSession(None)
    sess.add_passive("f", ledger)
    sess.sample_once(1)

    be2 = P.SimBackend()
    reborn = P.Partition("foreign", source=be2, ledger_path=ledger)
    be2.register("victim", P.SimProfile.steady(step_time_ns=1 * MS))
    reborn.add_job(P.Job("victim"))
    reborn.run(until_ns=100 * MS)

    sess.sample_once(2)
    reborn.run(until_ns=250 * MS)
    sess.sample_once(3)
    sess.close()
    rep = sess.report()
    row = rep.get("f/victim")
    assert row is not None, rep
    assert row["device_ms"] > 0
    for s in sess.samples["f/victim"]:
        assert s.device_dns >= 0 and s.stall_dns >= 0
    return [rep, _samples(sess)]


def c_passive_meta_refresh_sees_late_jobs(P, tmp):
    MS = P.MS
    ledger = str(tmp / "foreign.bin")
    be = P.SimBackend()
    foreign = P.Partition("foreign", source=be, ledger_path=ledger)
    be.register("early", P.SimProfile.steady(step_time_ns=1 * MS))
    be.register("late", P.SimProfile.steady(step_time_ns=1 * MS))
    foreign.add_job(P.Job("early"))
    foreign.run(until_ns=100 * MS)

    sess = P.oprofile.ProfileSession(None)
    sess.add_passive("f", ledger)
    sess.sample_once(1)
    foreign.add_job(P.Job("late"))
    foreign.run(until_ns=400 * MS)
    sess.sample_once(2)
    sess.close()
    rep = sess.report()
    assert "f/early" in rep
    assert "f/late" in rep, rep
    return [rep, _samples(sess)]


CASES = [
    c_history_folds_sched_events_into_windows,
    c_history_window_eviction_bounds_memory,
    c_trace_ring_file_attach_roundtrip,
    c_monitor_attaches_and_ranks_by_weight,
    c_cli_mon_renders_rows,
    c_monitor_requires_trace_dir,
    c_profile_session_samples_and_reports,
    c_profile_session_baseline_excludes_presession_history,
    c_collective_wait_survives_idle_ticks,
    c_profiler_reservation_mutual_exclusion,
    c_sample_buffer_bounded_with_lost_counter,
    c_passive_domain_profiling,
    c_passive_only_monitor_session,
    c_passive_reset_never_records_negative_deltas,
    c_passive_meta_refresh_sees_late_jobs,
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__)
def test_mon_oprofile_case_twin(case, tmp_path, capsys):
    got = []
    for tag, P in (("ref", REF), ("port", PORT)):
        d = tmp_path / tag
        d.mkdir()
        kw = {"capsys": capsys} if "capsys" in case.__code__.co_varnames \
            else {}
        got.append(repr(case(P, d, **kw)))
    assert got[1] == got[0]


def test_case_list_covers_the_reference_file():
    """One case here for each test of the reference's file."""
    import ast
    from pathlib import Path

    tree = ast.parse((Path(__file__).parent / "test_mon_oprofile.py")
                     .read_text())
    ref_tests = [n.name for n in tree.body
                 if isinstance(n, ast.FunctionDef)
                 and n.name.startswith("test_")]
    assert sorted(c.__name__[2:] for c in CASES) == sorted(
        n[5:] for n in ref_tests)


def _producer(P, tmp, job_names=("a", "b")):
    ledger = str(tmp / "led.bin")
    be = P.SimBackend()
    part = P.Partition("x", source=be, scheduler="credit",
                       ledger_path=ledger, trace_dir=str(tmp / "traces"))
    for name in job_names:
        be.register(name, P.SimProfile.steady(step_time_ns=P.MS,
                                              stall_frac=0.3))
        part.add_job(P.Job(name))
    return part, ledger


@pytest.mark.parametrize("producer,observer",
                         [(REF, PORT), (PORT, REF)],
                         ids=["ref-partition", "port-partition"])
def test_observers_attach_across_packages(producer, observer, tmp_path):
    """Each package's monitor and passive profiler read the other's
    partition files: the rows and the flat profile equal those of the
    producer's own observers."""
    part, ledger = _producer(producer, tmp_path)
    part.run(until_ns=300 * producer.MS)
    mine = producer.oprofile.ProfileSession(None)
    theirs = observer.oprofile.ProfileSession(None)
    for sess in (mine, theirs):
        sess.add_passive("p", ledger)
        sess.sample_once(1)
    part.run(until_ns=700 * producer.MS)
    for sess in (mine, theirs):
        sess.sample_once(2)
        sess.close()
    assert set(mine.report()) == {"p/a", "p/b"}
    assert theirs.report() == mine.report()
    assert _samples(theirs) == _samples(mine)
    # The rings are drained destructively: the first monitor consumes.
    first = observer.mon.Monitor(ledger + ".meta.json", window_ns=SEC)
    second = producer.mon.Monitor(ledger + ".meta.json", window_ns=SEC)
    assert first.poll() > 0 and second.poll() == 0
    assert {r["job"] for r in first.rows(windows=10)} == {"a", "b"}
