"""The port's credit2, SEDF and ARINC 653 schedulers and its ATC policy
against ``pbs_tpu``'s, word for word.

Two kinds of twin. Every case of ``tests/test_credit2.py``,
``tests/test_sedf.py`` and ``tests/test_sched_variants.py`` is ported as
a function of a package namespace: it runs once on the reference and
once on the port, makes the reference test's own assertions on each,
and the two runs' observables (``Partition.dump()``, each context's
counters, the values the case inspects) must be equal. Then seeded
``SimBackend`` scenarios, one per scheduler, run through both packages
under a ``VirtualClock`` cut into chunks with run-state churn between
them: after every chunk each job's ``tslice_us``, every context's
counters, ledger words and run state, the scheduler's per-executor dump
and the trace records must be equal; at the end so must ``dump()``,
``dump_settings()``, ``dump_executor()`` and the policy's dump. No
tolerance: the port copies the scheduling arithmetic.
"""

from __future__ import annotations

import importlib
import json
import types

import pytest

pytest.importorskip("jax", reason="parity tests need the JAX reference")

import torch  # noqa: E402

# The suite runs in parallel worker processes: uncapped, torch's intra-op
# pool takes every core in each of them and oversubscribes the host.
torch.set_num_threads(2)

MS = 1_000_000
US = 1_000


def _ns(root: str) -> types.SimpleNamespace:
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    rt, tel, sched = mod("runtime"), mod("telemetry"), mod("sched")
    return types.SimpleNamespace(
        root=root, rt=rt, tel=tel, sched=sched,
        Job=rt.Job, Partition=rt.Partition, SchedParams=rt.SchedParams,
        ContextState=rt.ContextState, SimBackend=tel.SimBackend,
        SimProfile=tel.SimProfile, SimPhase=tel.SimPhase,
        Counter=tel.Counter, credit=mod("sched.credit"),
        credit2=mod("sched.credit2"), sedf=mod("sched.sedf"),
        arinc653=mod("sched.arinc653"), atc=mod("sched.atc"),
        trace=mod("obs.trace"))


REF = _ns("pbs_tpu")
PORT = _ns("pbs_tpu_torch")


def dev_time(P, job) -> int:
    return sum(int(c.counters[P.Counter.DEVICE_TIME_NS]) for c in job.contexts)


def observe(part, jobs) -> dict:
    """What the two packages must agree on after a case."""
    return {
        "now": part.clock.now_ns(),
        "dump": part.dump(),
        "counters": {j.name: [c.counters.tolist() for c in j.contexts]
                     for j in jobs},
        "ledger": {j.name: [part.ledger.snapshot(c.ledger_slot).tolist()
                            for c in j.contexts if c.ledger_slot >= 0]
                   for j in jobs},
        "state": {j.name: [c.state.value for c in j.contexts] for j in jobs},
        "tslice": {j.name: j.params.tslice_us for j in jobs},
    }


def setup(P, scheduler, jobs, step_time_us=100, n_executors=1,
          **sched_params):
    """The reference tests' ``setup``: ``jobs`` is [(name, params,
    max_steps)]; each job's step-time estimate starts at the profile's."""
    be = P.SimBackend()
    part = P.Partition("t", source=be, scheduler=scheduler,
                       n_executors=n_executors, sched_params=sched_params)
    out = {}
    for name, params, max_steps in jobs:
        be.register(name, P.SimProfile.steady(
            step_time_ns=step_time_us * 1000))
        job = P.Job(name, params=params, max_steps=max_steps)
        for c in job.contexts:
            c.avg_step_ns = step_time_us * 1000.0
        part.add_job(job)
        out[name] = job
    return part, be, out


def _twin(case):
    """Run a ported case on both packages; their observables must be
    equal."""
    want = case(REF)
    got = case(PORT)
    assert json.dumps(got, sort_keys=True, default=str) == json.dumps(
        want, sort_keys=True, default=str)


# -- tests/test_credit2.py ----------------------------------------------


def c2_three_way_weight_fairness_under_load(P):
    part, be, jobs = setup(
        P, "credit2",
        [("w1", P.SchedParams(weight=128), 1_000_000),
         ("w2", P.SchedParams(weight=256), 1_000_000),
         ("w4", P.SchedParams(weight=512), 1_000_000)])
    part.run(until_ns=4_000_000_000)
    t1, t2, t4 = (dev_time(P, jobs[n]) for n in ("w1", "w2", "w4"))
    assert 1.5 < t2 / t1 < 2.6, (t1, t2, t4)
    assert 1.5 < t4 / t2 < 2.6, (t1, t2, t4)
    st = part.scheduler.dump_settings()
    assert sum(rq["resets"] for rq in st["runqueues"]) > 0
    return observe(part, jobs.values())


def c2_runqueue_locality_distinguishes_from_credit_steal(P):
    spec = [(f"j{i}", P.SchedParams(), 5_000) for i in range(2)]
    part2, _, jobs2 = setup(P, "credit2", spec, n_executors=4,
                            executors_per_runq=2)
    part2.run(until_ns=400_000_000)
    assert part2.scheduler.dump_settings()["migrations"] == 0
    assert all(ex.dispatch_count > 0 for ex in part2.executors)
    part1, _, jobs1 = setup(P, "credit", spec, n_executors=4)
    part1.run(until_ns=400_000_000)
    steals = sum(part1.scheduler._cc(j.contexts[0]).steals
                 for j in jobs1.values())
    assert steals > 0
    return [observe(part2, jobs2.values()), observe(part1, jobs1.values()),
            steals]


def c2_load_balancing_migrates_only_on_imbalance(P):
    be = P.SimBackend()
    part = P.Partition("t", source=be, scheduler="credit2", n_executors=4,
                       sched_params={"executors_per_runq": 2})
    jobs = []
    for i in range(3):
        name = f"piled{i}"
        be.register(name, P.SimProfile.steady(step_time_ns=100_000))
        j = P.Job(name, max_steps=100_000)
        j.contexts[0].avg_step_ns = 100_000.0
        j.contexts[0].executor_hint = 0
        part.add_job(j)
        j.contexts[0].executor_hint = None
        jobs.append(j)
    part.run(until_ns=500_000_000)
    assert part.scheduler.dump_settings()["migrations"] > 0
    by_rq = {0: 0, 1: 0}
    for ex in part.executors:
        by_rq[part.scheduler._ex_to_rq[ex.index]] += ex.dispatch_count
    assert by_rq[0] > 0 and by_rq[1] > 0, by_rq
    return observe(part, jobs)


def _wake_latency_scenario(P, scheduler: str):
    be = P.SimBackend()
    part = P.Partition("t", source=be, scheduler=scheduler)
    be.register("churn", P.SimProfile.steady(step_time_ns=100_000))
    be.register("sleeper", P.SimProfile.steady(step_time_ns=100_000))
    churn = P.Job("churn", max_steps=100_000)
    churn.contexts[0].avg_step_ns = 100_000.0
    part.add_job(churn)
    part.run(until_ns=50_000_000)
    sleeper = P.Job("sleeper", max_steps=100_000,
                    params=P.SchedParams(boost_on_wake=False))
    sleeper.contexts[0].avg_step_ns = 100_000.0
    part.add_job(sleeper)
    part.sleep_job(sleeper)
    part.run(max_rounds=1)
    if scheduler == "credit2":
        part.scheduler._cc(churn.contexts[0]).credit = 1_000.0
    else:
        cc = part.scheduler._cc(churn.contexts[0])
        cc.credit = 300.0
        cc.pri = P.credit.PRI_UNDER
    part.wake_job(sleeper)
    part.run(max_rounds=1)
    waker_runs = int(sleeper.contexts[0].counters[P.Counter.SCHED_COUNT])
    return waker_runs, getattr(part.scheduler, "tickles", None), observe(
        part, [churn, sleeper])


def c2_wake_preemption_distinguishes_from_credit1(P):
    runs2, tickles2, obs2 = _wake_latency_scenario(P, "credit2")
    assert runs2 >= 1
    assert tickles2 >= 1
    runs1, _, obs1 = _wake_latency_scenario(P, "credit")
    assert runs1 == 0
    return [runs2, tickles2, obs2, runs1, obs1]


def c2_reset_carryover_preserves_relative_spacing(P):
    part, be, jobs = setup(
        P, "credit2",
        [("rich", P.SchedParams(weight=512), 1_000_000),
         ("poor", P.SchedParams(weight=128), 1_000_000)])
    sched = part.scheduler
    part.run(until_ns=2_000_000_000)
    st = sched.dump_settings()
    assert sum(rq["resets"] for rq in st["runqueues"]) > 0
    credit = {name: sched._cc(jobs[name].contexts[0]).credit
              for name in ("rich", "poor")}
    assert credit["rich"] >= credit["poor"] - P.credit2.CREDIT_INIT * 0.5
    return [credit, observe(part, jobs.values())]


def c2_reset_covers_sleeping_contexts(P):
    part, be, jobs = setup(
        P, "credit2",
        [("runner", P.SchedParams(), 1_000_000),
         ("napper", P.SchedParams(), 1_000_000)])
    sched = part.scheduler
    part.run(max_rounds=2)
    part.sleep_job(jobs["napper"])
    napper_cc = sched._cc(jobs["napper"].contexts[0])
    napper_cc.credit = 100.0
    before = sched.dump_settings()["runqueues"][0]["resets"]
    part.run(until_ns=part.clock.now_ns() + 2_000_000_000)
    after = sched.dump_settings()["runqueues"][0]["resets"]
    assert after > before
    assert napper_cc.credit >= P.credit2.CREDIT_INIT
    return [napper_cc.credit, observe(part, jobs.values())]


def c2_pinned_context_never_balanced_away(P):
    be = P.SimBackend()
    part = P.Partition("t", source=be, scheduler="credit2", n_executors=4,
                       sched_params={"executors_per_runq": 2})
    jobs = []
    for i in range(3):
        name = f"pin{i}"
        be.register(name, P.SimProfile.steady(step_time_ns=100_000))
        j = P.Job(name, max_steps=100_000)
        j.contexts[0].avg_step_ns = 100_000.0
        j.contexts[0].executor_hint = 0
        part.add_job(j)
        jobs.append(j)
    part.run(until_ns=300_000_000)
    assert part.scheduler.dump_settings()["migrations"] == 0
    assert part.executors[2].dispatch_count == 0
    assert part.executors[3].dispatch_count == 0
    return observe(part, jobs)


def c2_weight_change_updates_runqueue_max_weight(P):
    part, be, jobs = setup(P, "credit2",
                           [("a", P.SchedParams(weight=256), 100_000)])
    part.scheduler.adjust_job(jobs["a"], weight=1024)
    assert part.scheduler.dump_settings()["runqueues"][0]["max_weight"] \
        == 1024
    part.scheduler.adjust_job(jobs["a"], weight=64)
    st = part.scheduler.dump_settings()
    assert st["runqueues"][0]["max_weight"] == 64
    return st


CREDIT2_CASES = [
    c2_three_way_weight_fairness_under_load,
    c2_runqueue_locality_distinguishes_from_credit_steal,
    c2_load_balancing_migrates_only_on_imbalance,
    c2_wake_preemption_distinguishes_from_credit1,
    c2_reset_carryover_preserves_relative_spacing,
    c2_reset_covers_sleeping_contexts,
    c2_pinned_context_never_balanced_away,
    c2_weight_change_updates_runqueue_max_weight,
]


@pytest.mark.parametrize("case", CREDIT2_CASES, ids=lambda c: c.__name__)
def test_credit2_case_twin(case):
    _twin(case)


# -- tests/test_sedf.py -------------------------------------------------


def sedf_setup(P, jobs, step_time_us=100, scheduler="sedf"):
    return setup(P, scheduler,
                 [(name, P.SchedParams(), n) for name, n in jobs],
                 step_time_us=step_time_us)


def sc(job):
    return job.contexts[0].sched_priv


def sedf_weight_driven_slices(P):
    part, be, jobs = sedf_setup(P, [("heavy", 100_000), ("light", 100_000)])
    part.scheduler.set_weight(jobs["heavy"], 512)
    part.scheduler.set_weight(jobs["light"], 256)
    assert abs(sc(jobs["heavy"]).slice_us
               - 2 * sc(jobs["light"]).slice_us) <= 2
    assert sc(jobs["heavy"]).period_us == P.sedf.WEIGHT_PERIOD_US
    part.run(until_ns=2_000_000_000)
    ratio = dev_time(P, jobs["heavy"]) / dev_time(P, jobs["light"])
    assert 1.5 < ratio < 2.7, ratio
    return observe(part, jobs.values())


def sedf_weight_respects_explicit_carveout(P):
    part, be, jobs = sedf_setup(P, [("rsv", 10), ("w", 10)])
    part.scheduler.set_reservation(jobs["rsv"], period_us=20_000,
                                   slice_us=10_000)
    part.scheduler.set_weight(jobs["w"], 128)
    W = P.sedf.WEIGHT_PERIOD_US
    assert abs(sc(jobs["w"]).slice_us - (W - 5_000 - W // 2)) <= 1
    return observe(part, jobs.values())


def sedf_extraweight_distribution(P):
    part, be, jobs = sedf_setup(P, [("big", 100_000), ("small", 100_000)])
    part.scheduler.set_weight(jobs["big"], 4, extratime_only=True)
    part.scheduler.set_weight(jobs["small"], 1, extratime_only=True)
    part.run(until_ns=1_000_000_000)
    ratio = dev_time(P, jobs["big"]) / dev_time(P, jobs["small"])
    assert 2.5 < ratio < 6.0, ratio
    return observe(part, jobs.values())


def sedf_short_unblock_penalty_queue(P):
    part, be, jobs = sedf_setup(P, [("rt", 100_000), ("hog", 100_000)])
    part.scheduler.set_reservation(jobs["rt"], period_us=20_000,
                                   slice_us=5_000, extratime=True)
    part.timers.arm(2 * MS, lambda now: part.sleep_job(jobs["rt"]))
    part.timers.arm(3 * MS, lambda now: part.wake_job(jobs["rt"]))
    part.run(until_ns=200_000_000)
    s = sc(jobs["rt"])
    assert s.short_block_tot >= 1
    assert s.pen_extra_blocks >= 1
    assert s.pen_extra_slices >= 1
    assert s.extra_time_tot_ns > 0
    return observe(part, jobs.values())


def sedf_no_penalty_slack_without_extratime(P):
    part, be, jobs = sedf_setup(P, [("rt", 100_000), ("hog", 100_000)])
    part.scheduler.set_reservation(jobs["rt"], period_us=20_000,
                                   slice_us=5_000)
    part.timers.arm(2 * MS, lambda now: part.sleep_job(jobs["rt"]))
    part.timers.arm(3 * MS, lambda now: part.wake_job(jobs["rt"]))
    part.run(until_ns=200_000_000)
    s = sc(jobs["rt"])
    assert s.pen_extra_slices == 0
    assert s.extra_time_tot_ns == 0
    return observe(part, jobs.values())


def sedf_reservation_set_while_blocked_honored_at_wake(P):
    part, be, jobs = sedf_setup(P, [("rt", 100_000), ("hog", 100_000)])
    part.timers.arm(1 * MS, lambda now: part.sleep_job(jobs["rt"]))
    part.timers.arm(2 * MS, lambda now: part.scheduler.set_reservation(
        jobs["rt"], period_us=20_000, slice_us=5_000))
    part.timers.arm(3 * MS, lambda now: part.wake_job(jobs["rt"]))
    part.run(until_ns=500_000_000)
    assert sc(jobs["rt"]).short_block_tot == 0
    assert dev_time(P, jobs["rt"]) / part.clock.now_ns() > 0.15
    return observe(part, jobs.values())


def sedf_long_unblock_restarts_period(P):
    part, be, jobs = sedf_setup(P, [("rt", 100_000), ("hog", 100_000)])
    part.scheduler.set_reservation(jobs["rt"], period_us=10_000,
                                   slice_us=2_000)
    part.timers.arm(5 * MS, lambda now: part.sleep_job(jobs["rt"]))
    wake_at = 50 * MS
    seen = {}

    def wake(now):
        part.wake_job(jobs["rt"])
        s = sc(jobs["rt"])
        assert s.long_block_tot >= 1
        assert s.deadline_ns >= wake_at + s.period_us * US
        seen["deadline_ns"] = s.deadline_ns

    part.timers.arm(wake_at, wake)
    part.run(until_ns=200_000_000)
    assert sc(jobs["rt"]).long_block_tot >= 1
    return [seen, observe(part, jobs.values())]


def sedf_latency_scaling_on_long_unblock(P):
    part, be, jobs = sedf_setup(P, [("io", 100_000), ("hog", 100_000)])
    part.scheduler.set_reservation(jobs["io"], period_us=80_000,
                                   slice_us=8_000, latency_us=5_000)
    part.timers.arm(2 * MS, lambda now: part.sleep_job(jobs["io"]))
    seen = {}

    def wake(now):
        part.wake_job(jobs["io"])
        s = sc(jobs["io"])
        seen["period_us"] = s.period_us
        seen["slice_us"] = s.slice_us

    part.timers.arm(400 * MS, wake)
    part.run(until_ns=2_000_000_000)
    assert seen["period_us"] == 5_000
    assert seen["slice_us"] == 8_000 * 5_000 // 80_000
    s = sc(jobs["io"])
    assert s.period_us == 80_000
    assert s.slice_us == 8_000
    return [seen, observe(part, jobs.values())]


def sedf_deadline_miss_repair_and_accounting(P):
    part, be, jobs = sedf_setup(P, [("tight", 200)], step_time_us=5_000)
    part.scheduler.set_reservation(jobs["tight"], period_us=1_000,
                                   slice_us=500)
    part.run(until_ns=10_000_000_000)
    s = sc(jobs["tight"])
    assert s.deadline_misses > 0
    assert jobs["tight"].steps_retired() == 200
    assert s.deadline_ns >= 0
    return observe(part, jobs.values())


def sedf_distinguishable_from_credit(P):
    fracs, obs = {}, {}
    for policy in ("credit", "sedf"):
        part, be, jobs = sedf_setup(P, [("a", 100_000), ("hog", 100_000)],
                                    scheduler=policy)
        if policy == "sedf":
            part.scheduler.set_reservation(jobs["a"], period_us=20_000,
                                           slice_us=2_000)
        part.run(until_ns=1_000_000_000)
        fracs[policy] = dev_time(P, jobs["a"]) / part.clock.now_ns()
        obs[policy] = observe(part, jobs.values())
    assert 0.35 < fracs["credit"] < 0.65, fracs
    assert 0.05 < fracs["sedf"] < 0.20, fracs
    assert fracs["credit"] / fracs["sedf"] > 2.0
    return [fracs, obs]


def _raises(exc, fn, match=None) -> str:
    with pytest.raises(exc, match=match) as e:
        fn()
    return f"{type(e.value).__name__}: {e.value}"


def sedf_reservation_param_bounds(P):
    part, be, jobs = sedf_setup(P, [("j", 10)])
    s = part.scheduler
    return [
        _raises(ValueError, lambda: s.set_reservation(
            jobs["j"], period_us=1_000, slice_us=2_000)),
        _raises(ValueError, lambda: s.set_reservation(
            jobs["j"], period_us=20_000_000, slice_us=1_000)),
        _raises(ValueError, lambda: s.set_weight(jobs["j"], 0)),
    ]


def sedf_zero_slice_without_extratime_rejected(P):
    part, be, jobs = sedf_setup(P, [("j", 10)])
    msg = _raises(ValueError, lambda: part.scheduler.set_reservation(
        jobs["j"], period_us=20_000, slice_us=0), match="extratime")
    part.scheduler.set_reservation(jobs["j"], period_us=20_000,
                                   slice_us=0, extratime=True)
    part.run(until_ns=1_000_000_000)
    assert jobs["j"].steps_retired() == 10
    return [msg, observe(part, jobs.values())]


def sedf_removed_job_frees_weighted_capacity(P):
    part, be, jobs = sedf_setup(P, [("big", 100_000), ("small", 100_000)])
    part.scheduler.set_weight(jobs["big"], 512)
    part.scheduler.set_weight(jobs["small"], 256)
    before = sc(jobs["small"]).slice_us
    part.remove_job(jobs["big"])
    after = sc(jobs["small"]).slice_us
    assert after > 2 * before, (before, after)
    return [before, after, observe(part, [jobs["small"]])]


def sedf_reweigh_leaves_blocked_contexts_unstamped(P):
    part, be, jobs = sedf_setup(P, [("w1", 100_000), ("w2", 100_000)])
    part.scheduler.set_weight(jobs["w1"], 256)
    part.scheduler.set_weight(jobs["w2"], 256)
    part.timers.arm(5 * MS, lambda now: part.sleep_job(jobs["w1"]))
    part.timers.arm(200 * MS, lambda now: part.scheduler.set_weight(
        jobs["w2"], 512))
    part.timers.arm(400 * MS, lambda now: part.wake_job(jobs["w1"]))
    part.run(until_ns=1_000_000_000)
    s = sc(jobs["w1"])
    assert s.short_block_tot == 0
    assert s.long_block_tot >= 1
    return observe(part, jobs.values())


def sedf_newcomer_does_not_monopolize_slack(P):
    part, be, jobs = sedf_setup(P, [("old", 100_000)])
    part.run(until_ns=1_000_000_000)
    be.register("new", P.SimProfile.steady(step_time_ns=100_000))
    newjob = P.Job("new", params=P.SchedParams(), max_steps=100_000)
    newjob.contexts[0].avg_step_ns = 100_000.0
    part.add_job(newjob)
    t0_old, t0_new = dev_time(P, jobs["old"]), dev_time(P, newjob)
    part.run(until_ns=2_000_000_000)
    d_old = dev_time(P, jobs["old"]) - t0_old
    d_new = dev_time(P, newjob) - t0_new
    assert d_old > 0
    assert 0.3 < d_new / max(d_old, 1) < 3.0
    return observe(part, [jobs["old"], newjob])


def sedf_dump_exposes_sedf_state(P):
    part, be, jobs = sedf_setup(P, [("a", 50), ("b", 50)])
    part.scheduler.set_reservation(jobs["a"], period_us=20_000,
                                   slice_us=5_000)
    part.run(until_ns=50_000_000)
    d = part.scheduler.dump_executor(part.executors[0])
    json.dumps(d)
    rows = {r["ctx"]: r for r in d["contexts"]}
    assert any(r["slice_us"] == 5_000 for r in rows.values())
    assert all("deadline_misses" in r and "blocks" in r
               for r in rows.values())
    return d


SEDF_CASES = [
    sedf_weight_driven_slices,
    sedf_weight_respects_explicit_carveout,
    sedf_extraweight_distribution,
    sedf_short_unblock_penalty_queue,
    sedf_no_penalty_slack_without_extratime,
    sedf_reservation_set_while_blocked_honored_at_wake,
    sedf_long_unblock_restarts_period,
    sedf_latency_scaling_on_long_unblock,
    sedf_deadline_miss_repair_and_accounting,
    sedf_distinguishable_from_credit,
    sedf_reservation_param_bounds,
    sedf_zero_slice_without_extratime_rejected,
    sedf_removed_job_frees_weighted_capacity,
    sedf_reweigh_leaves_blocked_contexts_unstamped,
    sedf_newcomer_does_not_monopolize_slack,
    sedf_dump_exposes_sedf_state,
]


@pytest.mark.parametrize("case", SEDF_CASES, ids=lambda c: c.__name__)
def test_sedf_case_twin(case):
    _twin(case)


# -- tests/test_sched_variants.py ---------------------------------------


def var_registry_has_all_policies(P):
    names = P.sched.scheduler_names()
    assert set(names) >= {"credit", "credit2", "sedf", "arinc653"}
    return sorted(names)


def var_credit2_weight_proportional(P):
    part, be, jobs = setup(
        P, "credit2",
        [("heavy", P.SchedParams(weight=512), 100_000),
         ("light", P.SchedParams(weight=256), 100_000)])
    part.run(until_ns=2_000_000_000)
    ratio = dev_time(P, jobs["heavy"]) / dev_time(P, jobs["light"])
    assert 1.5 < ratio < 2.7, ratio
    return observe(part, jobs.values())


def var_credit2_completion(P):
    part, be, jobs = setup(P, "credit2", [("a", P.SchedParams(), 300),
                                          ("b", P.SchedParams(), 300)])
    part.run()
    assert jobs["a"].steps_retired() == 300
    assert jobs["b"].steps_retired() == 300
    return observe(part, jobs.values())


def var_sedf_reservation_honored(P):
    part, be, jobs = setup(
        P, "sedf",
        [("rt", P.SchedParams(), 100_000),
         ("be_job", P.SchedParams(), 100_000)])
    part.scheduler.set_reservation(jobs["rt"], period_us=20_000,
                                   slice_us=5_000)
    part.run(until_ns=2_000_000_000)
    assert 0.15 < dev_time(P, jobs["rt"]) / part.clock.now_ns() < 0.40
    assert dev_time(P, jobs["be_job"]) > 0
    return observe(part, jobs.values())


def var_sedf_rejects_bad_reservation(P):
    part, be, jobs = setup(P, "sedf", [("rt", P.SchedParams(), 10)])
    return _raises(ValueError, lambda: part.scheduler.set_reservation(
        jobs["rt"], period_us=1000, slice_us=2000))


def var_arinc653_frame_isolation(P):
    part, be, jobs = setup(
        P, "arinc653",
        [("p1", P.SchedParams(tslice_us=100), 100_000),
         ("p2", P.SchedParams(tslice_us=100), 100_000)])
    part.scheduler.set_schedule([("p1", 3_000), ("p2", 1_000),
                                 (None, 1_000)])
    part.run(until_ns=1_000_000_000)
    t1, t2 = dev_time(P, jobs["p1"]), dev_time(P, jobs["p2"])
    assert 2.2 < t1 / t2 < 3.8
    assert (t1 + t2) / part.clock.now_ns() < 0.9
    return observe(part, jobs.values())


def var_arinc653_rejects_empty_schedule(P):
    part, be, jobs = setup(P, "arinc653", [("p1", P.SchedParams(), 10)])
    return _raises(ValueError, lambda: part.scheduler.set_schedule([]))


def var_arinc653_rejects_unknown_job(P):
    part, be, jobs = setup(P, "arinc653", [("p1", P.SchedParams(), 10)])
    return _raises(ValueError, lambda: part.scheduler.set_schedule(
        [("ghost", 1_000)]), match="unknown job")


def var_arinc653_default_schedule_covers_admitted_jobs(P):
    part, be, jobs = setup(
        P, "arinc653",
        [("p1", P.SchedParams(), 2_000), ("p2", P.SchedParams(), 2_000)])
    slots = [s["job"] for s in part.scheduler.dump_settings()["slots"]]
    assert slots == ["p1", "p2"]
    part.run(until_ns=200_000_000)
    assert dev_time(P, jobs["p1"]) > 0 and dev_time(P, jobs["p2"]) > 0
    return observe(part, jobs.values())


def var_arinc653_schedule_applies_at_frame_boundary(P):
    part, be, jobs = setup(
        P, "arinc653",
        [("p1", P.SchedParams(tslice_us=100), 100_000),
         ("p2", P.SchedParams(tslice_us=100), 100_000)])
    part.scheduler.set_schedule([("p1", 2_000), ("p2", 2_000)])
    part.run(until_ns=1_000_000)
    part.scheduler.set_schedule([("p2", 3_000), (None, 1_000)])
    assert part.scheduler.pending is not None
    mid = part.scheduler.dump_settings()
    assert [s["job"] for s in mid["slots"]] == ["p1", "p2"]
    part.run(until_ns=20_000_000)
    d = part.scheduler.dump_settings()
    assert [s["job"] for s in d["slots"]] == ["p2", "<idle>"]
    assert part.scheduler.pending is None
    return [mid, observe(part, jobs.values())]


def var_arinc653_overrun_debited_from_own_windows(P):
    be = P.SimBackend()
    part = P.Partition("t", source=be, scheduler="arinc653")
    be.register("fat", P.SimProfile.steady(step_time_ns=5_000_000))
    be.register("fit", P.SimProfile.steady(step_time_ns=100_000))
    fat = P.Job("fat", params=P.SchedParams(tslice_us=100),
                max_steps=100_000)
    fat.contexts[0].avg_step_ns = 5_000_000.0
    fit = P.Job("fit", params=P.SchedParams(tslice_us=100),
                max_steps=100_000)
    fit.contexts[0].avg_step_ns = 100_000.0
    part.add_job(fat)
    part.add_job(fit)
    part.scheduler.set_schedule([("fat", 1_000), ("fit", 1_000)])
    part.run(until_ns=1_000_000_000)
    ratio = dev_time(P, fat) / max(dev_time(P, fit), 1)
    assert 0.6 < ratio < 1.7, ratio
    assert part.scheduler.dump_settings()["overrun_ns"]["fat"] >= 0
    return observe(part, [fat, fit])


def var_arinc653_debt_not_forgiven_without_dispatch(P):
    part, be, jobs = setup(P, "arinc653",
                           [("p1", P.SchedParams(), 100_000)])
    part.scheduler.set_schedule([("p1", 1_000)])
    sched = part.scheduler
    sched.overrun_ns["p1"] = 500_000
    jobs["p1"].contexts[0].state = P.ContextState.BLOCKED
    d = sched.do_schedule(part.executors[0], part.clock.now_ns())
    assert d.ctx is None
    assert sched.overrun_ns["p1"] == 500_000
    return sched.dump_settings()


def var_arinc653_window_repays_debt_once(P):
    part, be, jobs = setup(P, "arinc653",
                           [("p1", P.SchedParams(), 100_000)])
    part.scheduler.set_schedule([("p1", 1_000)])
    sched = part.scheduler
    sched.overrun_ns["p1"] = 5_000_000
    now = part.clock.now_ns()
    for _ in range(4):
        assert sched.do_schedule(part.executors[0], now).ctx is None
    assert sched.overrun_ns["p1"] == 4_000_000
    return sched.dump_settings()


def var_arinc653_repaid_window_stays_idle(P):
    part, be, jobs = setup(P, "arinc653",
                           [("p1", P.SchedParams(), 100_000)])
    part.scheduler.set_schedule([("p1", 1_000)])
    sched = part.scheduler
    sched.overrun_ns["p1"] = 1_500_000
    ex, now = part.executors[0], part.clock.now_ns()
    d = sched.do_schedule(ex, now)
    assert d.ctx is None and sched.overrun_ns["p1"] == 500_000
    d = sched.do_schedule(ex, now)
    assert d.ctx is None
    assert sched.overrun_ns["p1"] == 500_000
    return sched.dump_settings()


def var_arinc653_constructor_schedule_accepted(P):
    be = P.SimBackend()
    part = P.Partition("t", source=be, scheduler="arinc653",
                       sched_params={"schedule": [("later", 1_000)]})
    be.register("later", P.SimProfile.steady(step_time_ns=100_000))
    job = P.Job("later", params=P.SchedParams(), max_steps=100)
    job.contexts[0].avg_step_ns = 100_000.0
    part.add_job(job)
    part.run(until_ns=100_000_000)
    assert job.steps_retired() == 100
    return observe(part, [job])


def var_arinc653_removed_job_slots_idle(P):
    part, be, jobs = setup(
        P, "arinc653",
        [("p1", P.SchedParams(), 50), ("p2", P.SchedParams(), 100_000)])
    part.scheduler.set_schedule([("p1", 1_000), ("p2", 1_000)])
    part.run(until_ns=50_000_000)
    part.remove_job(jobs["p1"])
    part.run(until_ns=100_000_000)
    d = part.scheduler.dump_settings()
    assert [s["job"] for s in d["slots"]] == ["<idle>", "p2"]
    return observe(part, [jobs["p2"]])


def var_atc_policy_applies_global_min(P):
    be = P.SimBackend()
    part = P.Partition("t", source=be, scheduler="credit")
    fb = P.sched.AtcFeedbackPolicy(part)
    be.register("noisy", P.SimProfile.steady(step_time_ns=100_000,
                                             collective_wait_ns=500_000))
    be.register("quiet", P.SimProfile.steady(step_time_ns=100_000,
                                             collective_wait_ns=100))
    noisy = part.add_job(P.Job("noisy", max_steps=100_000))
    quiet = part.add_job(P.Job("quiet", max_steps=100_000))
    part.run(until_ns=500_000_000)
    assert noisy.params.tslice_us == quiet.params.tslice_us
    assert P.atc.ATC_MIN_US <= noisy.params.tslice_us <= P.atc.ATC_MAX_US
    d = {e["job"]: e for e in fb.dump()}
    assert d["noisy"]["bucket"] is not None
    assert d["noisy"]["bucket"] > d["quiet"]["bucket"]
    return [fb.dump(), observe(part, [noisy, quiet])]


VARIANT_CASES = [
    var_registry_has_all_policies,
    var_credit2_weight_proportional,
    var_credit2_completion,
    var_sedf_reservation_honored,
    var_sedf_rejects_bad_reservation,
    var_arinc653_frame_isolation,
    var_arinc653_rejects_empty_schedule,
    var_arinc653_rejects_unknown_job,
    var_arinc653_default_schedule_covers_admitted_jobs,
    var_arinc653_schedule_applies_at_frame_boundary,
    var_arinc653_overrun_debited_from_own_windows,
    var_arinc653_debt_not_forgiven_without_dispatch,
    var_arinc653_window_repays_debt_once,
    var_arinc653_repaid_window_stays_idle,
    var_arinc653_constructor_schedule_accepted,
    var_arinc653_removed_job_slots_idle,
    var_atc_policy_applies_global_min,
]


@pytest.mark.parametrize("case", VARIANT_CASES, ids=lambda c: c.__name__)
def test_sched_variant_case_twin(case):
    _twin(case)


# -- seeded trace scenarios ---------------------------------------------


def _credit2_scenario(P):
    """Four lanes in two runqueues under FeedbackPolicy: jittered and
    phased tenants, three piled onto runqueue 0 by a wake-time hint (so
    balancing moves work), a pinned one, a gang, and run-state churn."""
    Phase, Profile = P.SimPhase, P.SimProfile
    jobs = [
        (P.Job("heavy", params=P.SchedParams(weight=512)),
         Profile.steady(step_time_ns=200_000, stall_frac=0.5,
                        collective_wait_ns=2000, jitter=0.2)),
        (P.Job("light", params=P.SchedParams(weight=128)),
         Profile([Phase(steps=400, step_time_ns=80_000, stall_frac=0.05,
                        jitter=0.1, tokens=16),
                  Phase(steps=-1, step_time_ns=300_000, stall_frac=0.4,
                        collective_wait_ns=1000, jitter=0.2)])),
        (P.Job("pinned", params=P.SchedParams(weight=256)),
         Profile.steady(step_time_ns=150_000, stall_frac=0.2, jitter=0.1)),
        (P.Job("micro", params=P.SchedParams(weight=256), micro_per_step=4,
               max_steps=700),
         Profile.steady(step_time_ns=400_000, stall_frac=0.3)),
        (P.Job("gang", params=P.SchedParams(weight=256), n_contexts=2,
               gang=True),
         Profile.steady(step_time_ns=120_000, stall_frac=0.1, tokens=8,
                        jitter=0.05)),
    ]
    return dict(scheduler="credit2", n_executors=4,
                sched_params={"executors_per_runq": 2}, jobs=jobs,
                policy="feedback", horizon=1_200 * MS, chunk=6 * MS)


def _credit2_churn(P, part, jobs, i):
    if i == 1:
        part.scheduler.adjust_job(jobs[0], weight=1024)
    if i % 25 == 5:
        part.sleep_job(jobs[1])
    elif i % 25 == 9:
        part.wake_job(jobs[1])
    if i == 60:
        part.scheduler.adjust_job(jobs[0], weight=384)
    if i % 40 == 20:
        jobs[4].report_contention(4_000 * (i % 3 + 1), events=3)


def _credit2_admit(P, part, job, i):
    if job.name == "pinned":
        for c in job.contexts:
            c.executor_hint = 0
    if job.name in ("heavy", "light", "micro"):
        # piled onto runqueue 0 at admission, then free to migrate
        job.contexts[0].executor_hint = 0
        part.add_job(job)
        job.contexts[0].executor_hint = None
        return
    part.add_job(job)


def _sedf_scenario(P):
    """A reserved tenant with a latency hint and extra time, two
    weight-driven tenants, a pure best-effort tenant, and short and
    long blocks through sleep/wake between chunks."""
    Profile = P.SimProfile
    jobs = [
        (P.Job("rt", params=P.SchedParams(tslice_us=500)),
         Profile.steady(step_time_ns=100_000, stall_frac=0.2, jitter=0.1)),
        (P.Job("w_heavy"),
         Profile.steady(step_time_ns=150_000, stall_frac=0.4,
                        collective_wait_ns=1500, jitter=0.2)),
        (P.Job("w_light"),
         Profile.steady(step_time_ns=90_000, stall_frac=0.05, jitter=0.1)),
        (P.Job("besteffort", max_steps=4_000),
         Profile.steady(step_time_ns=250_000, stall_frac=0.3, jitter=0.3)),
    ]
    return dict(scheduler="sedf", n_executors=1, sched_params={},
                jobs=jobs, policy="feedback", horizon=1_500 * MS,
                chunk=5 * MS)


def _sedf_churn(P, part, jobs, i):
    s = part.scheduler
    if i == 1:
        s.set_reservation(jobs[0], period_us=20_000, slice_us=6_000,
                          latency_us=4_000, extratime=True)
        s.set_weight(jobs[1], 512)
        s.set_weight(jobs[2], 128)
        s.set_weight(jobs[3], 3, extratime_only=True)
    # short blocks: sleep and wake inside one period
    if i % 30 == 10:
        part.sleep_job(jobs[0])
    elif i % 30 == 11:
        part.wake_job(jobs[0])
    # a long block: asleep across several periods
    if i == 120:
        part.sleep_job(jobs[0])
    elif i == 150:
        part.wake_job(jobs[0])
    if i == 200:
        part.sleep_job(jobs[2])
    elif i == 240:
        s.set_weight(jobs[1], 256)
    elif i == 260:
        part.wake_job(jobs[2])


def _arinc_scenario(P):
    """An explicit frame with an idle window, a tenant whose steps
    overrun its window (debt), a table change applied at a frame
    boundary, and a tenant removed mid-run."""
    Profile = P.SimProfile
    jobs = [
        (P.Job("fat", params=P.SchedParams(tslice_us=100)),
         Profile.steady(step_time_ns=3_000_000, stall_frac=0.3, jitter=0.2)),
        (P.Job("fit", params=P.SchedParams(tslice_us=300)),
         Profile.steady(step_time_ns=100_000, stall_frac=0.1, jitter=0.1)),
        (P.Job("late", params=P.SchedParams(tslice_us=200), max_steps=900),
         Profile.steady(step_time_ns=200_000, stall_frac=0.2)),
    ]
    return dict(scheduler="arinc653", n_executors=1, sched_params={},
                jobs=jobs, policy=None, horizon=900 * MS, chunk=7 * MS)


def _arinc_churn(P, part, jobs, i):
    s = part.scheduler
    if i == 1:
        s.set_schedule([("fat", 2_000), ("fit", 3_000), ("late", 1_000),
                        (None, 1_500)])
    if i == 50:
        s.set_schedule([("fit", 2_500), ("fat", 1_000), (None, 500),
                        ("late", 2_000)])
    if i % 20 == 7:
        part.sleep_job(jobs[1])
    elif i % 20 == 9:
        part.wake_job(jobs[1])
    if i == 90:
        part.remove_job(jobs[2])


def _atc_scenario(P):
    """The atc law on credit: contention from collective waits and
    out-of-band reports, phases that move the buckets."""
    Phase, Profile = P.SimPhase, P.SimProfile
    jobs = [
        (P.Job("noisy", params=P.SchedParams(weight=256)),
         Profile([Phase(steps=2_000, step_time_ns=100_000,
                        collective_wait_ns=400_000, jitter=0.2),
                  Phase(steps=-1, step_time_ns=100_000,
                        collective_wait_ns=2_000, jitter=0.1)])),
        (P.Job("quiet", params=P.SchedParams(weight=512)),
         Profile.steady(step_time_ns=120_000, collective_wait_ns=100,
                        stall_frac=0.2, jitter=0.1)),
        (P.Job("bursty", params=P.SchedParams(weight=256)),
         Profile.steady(step_time_ns=80_000, collective_wait_ns=20_000,
                        jitter=0.3)),
    ]
    return dict(scheduler="credit", n_executors=2, sched_params={},
                jobs=jobs, policy="atc", horizon=1_000 * MS, chunk=5 * MS)


def _atc_churn(P, part, jobs, i):
    if i % 15 == 3:
        jobs[2].report_contention(50_000 * (i % 4 + 1), events=2)
    if i == 100:
        part.sleep_job(jobs[1])
    elif i == 120:
        part.wake_job(jobs[1])


SCENARIOS = {
    "credit2": (_credit2_scenario, _credit2_churn, _credit2_admit),
    "sedf": (_sedf_scenario, _sedf_churn, None),
    "arinc653": (_arinc_scenario, _arinc_churn, None),
    "atc": (_atc_scenario, _atc_churn, None),
}


def _trace(P, scenario):
    build, churn, admit = SCENARIOS[scenario]
    spec = build(P)
    be = P.SimBackend(seed=23)
    part = P.Partition("p", source=be, scheduler=spec["scheduler"],
                       n_executors=spec["n_executors"],
                       sched_params=spec["sched_params"])
    policy = {"feedback": P.sched.FeedbackPolicy,
              "atc": P.sched.AtcFeedbackPolicy,
              None: None}[spec["policy"]]
    fb = policy(part) if policy is not None else None
    jobs = []
    for job, profile in spec["jobs"]:
        be.register(job.name, profile)
        if admit is not None:
            admit(P, part, job, 0)
        else:
            part.add_job(job)
        jobs.append(job)
    frames = []
    t, i = 0, 0
    while t < spec["horizon"]:
        t += spec["chunk"]
        i += 1
        churn(P, part, jobs, i)
        part.run(until_ns=t)
        live = [j for j in jobs if j in part.jobs]
        frames.append((
            t,
            [j.params.tslice_us for j in jobs],
            [c.counters.tolist() for j in jobs for c in j.contexts],
            [part.ledger.snapshot(c.ledger_slot).tolist()
             for j in live for c in j.contexts],
            [c.state.value for j in jobs for c in j.contexts],
            [part.scheduler.dump_executor(ex) for ex in part.executors],
            part.drain_traces().tolist(),
        ))
    end = (part.dump(), part.scheduler.dump_settings(),
           [part.scheduler.dump_executor(ex) for ex in part.executors],
           fb.dump() if fb is not None else None)
    return frames, json.loads(json.dumps(end, default=str))


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_seeded_scheduler_trace_is_identical(scenario):
    ref_frames, ref_end = _trace(REF, scenario)
    port_frames, port_end = _trace(PORT, scenario)
    assert len(port_frames) == len(ref_frames)
    for want, got in zip(ref_frames, port_frames):
        assert got == want, f"{scenario} diverged at t={want[0]} ns"
    assert port_end == ref_end


def test_scenarios_exercise_what_they_name():
    """The seeded scenarios reach the mechanisms each scheduler is
    ported for (on the port alone)."""
    _, end = _trace(PORT, "credit2")
    st = end[1]
    assert st["migrations"] > 0 and st["tickles"] > 0
    assert sum(rq["resets"] for rq in st["runqueues"]) > 0
    _, end = _trace(PORT, "sedf")
    rows = {r["ctx"]: r for r in end[2][0]["contexts"]}
    rt = rows["rt/0"]
    assert rt["blocks"]["short"] > 0 and rt["blocks"]["long"] > 0
    assert rt["blocks"]["pen_slices"] > 0
    assert rows["besteffort/0"]["extra_time_ms"] > 0
    _, end = _trace(PORT, "arinc653")
    st = end[1]
    assert st["frames"] > 0 and st["pending"] is None
    assert [s["job"] for s in st["slots"]] == ["fit", "fat", "<idle>",
                                                "<idle>"]
    assert any(s["idle"] > 0 for s in st["slots"])
    _, end = _trace(PORT, "atc")
    buckets = {d["job"]: d["bucket"] for d in end[3]}
    assert all(b is not None for b in buckets.values())
    assert len({d["tslice_us"] for d in end[3]}) == 1


def test_port_traces_name_picks_and_deschedules():
    """Every dispatched quantum leaves a SCHED_PICK and a SCHED_DESCHED
    in its lane's ring, in the reference's words."""
    frames, _ = _trace(PORT, "arinc653")
    ev = PORT.trace.Ev
    recs = [r for f in frames for r in f[6]]
    picks = sum(1 for r in recs if r[1] == int(ev.SCHED_PICK))
    descheds = sum(1 for r in recs if r[1] == int(ev.SCHED_DESCHED))
    assert picks == descheds > 0
