"""Compile admission, overflow sampling and the counter fault seam on
the port: twins of ``tests/test_compile_gate.py``,
``tests/test_sampler.py`` and ``tests/test_feedback_stale.py``, and a
trace-parity case against ``pbs_tpu`` under one fault plan.

The compile twins run on ``CudaBackend(device="cpu")``; a tenant's
first step "compiles" by reporting a backend-compile event to the
port's ``CompileMeter`` (what ``ops.cuda_build`` does for each ``nvcc``
run), of the time it really spent — a sleep inside the step, so the
split of compile time out of the runtime charge is observable.
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from pbs_tpu_torch.faults import FaultPlan, FaultSpec
from pbs_tpu_torch.faults import injector as faults
from pbs_tpu_torch.runtime import (
    CompileAdmission,
    CompileBudget,
    CompileBudgetExceeded,
    Job,
    Partition,
    SchedParams,
)
from pbs_tpu_torch.runtime.events import Virq
from pbs_tpu_torch.sched.feedback import FeedbackPolicy
from pbs_tpu_torch.telemetry import Counter, CudaBackend, SimBackend, SimProfile
from pbs_tpu_torch.telemetry.compile import BACKEND_COMPILE_EVENT, CompileMeter
from pbs_tpu_torch.telemetry.source import apply_counter_faults

# The suite runs in parallel worker processes: uncapped, torch's intra-op
# pool takes every core in each of them and oversubscribes the host.
torch.set_num_threads(2)

#: Wall time a tenant's first step spends "compiling".
COMPILE_S = 0.05


def _distinct_program_job(name: str, scale: float, size: int = 64) -> Job:
    """A tenant whose first step builds its one program: it spends
    COMPILE_S and reports that time as one backend compile."""
    meter = CompileMeter.install()
    built = []

    def step(x):
        if not built:
            t0 = time.monotonic()
            time.sleep(COMPILE_S)
            meter._on_event(BACKEND_COMPILE_EVENT, time.monotonic() - t0)
            built.append(True)
        return torch.tanh(x * scale) + 1.0 / (size + scale)

    return Job(name, step_fn=step, state=torch.ones(size, size), max_steps=2)


def _backend() -> CudaBackend:
    return CudaBackend(device="cpu")


# -- compile attribution and admission (tests/test_compile_gate.py) ----------


def test_compile_attribution_per_job():
    part = Partition("p", source=_backend())
    jobs = [part.add_job(_distinct_program_job(f"prog{i}", 1.0 + i,
                                               size=64 + 8 * i))
            for i in range(3)]
    part.run(max_rounds=20)
    for job in jobs:
        ctx = job.contexts[0]
        assert int(ctx.counters[Counter.COMPILES]) >= 1, job.name
        assert int(ctx.counters[Counter.COMPILE_TIME_NS]) > 0, job.name
    total = sum(int(j.contexts[0].counters[Counter.COMPILES]) for j in jobs)
    assert total >= 3


def test_compile_time_excluded_from_runtime_charge():
    part = Partition("p", source=_backend())
    job = part.add_job(_distinct_program_job("firstcomp", 3.14, size=96))
    part.run(max_rounds=1)  # the compiling quantum
    ctx = job.contexts[0]
    dev = int(ctx.counters[Counter.DEVICE_TIME_NS])
    comp = int(ctx.counters[Counter.COMPILE_TIME_NS])
    assert comp >= COMPILE_S * 1e9
    assert dev < comp, (dev, comp)
    assert ctx.avg_step_ns < comp


def test_cached_program_does_not_recharge():
    part = Partition("p", source=_backend())
    job = part.add_job(_distinct_program_job("once", 7.7))
    part.run(max_rounds=1)
    after_first = int(job.contexts[0].counters[Counter.COMPILE_TIME_NS])
    part.run(max_rounds=10)
    assert int(job.contexts[0].counters[Counter.COMPILE_TIME_NS]) == (
        after_first)
    assert int(job.contexts[0].counters[Counter.STEPS_RETIRED]) == 2


def test_admission_gates_on_program_count():
    gate = CompileAdmission(CompileBudget(max_programs=2))
    part = Partition("p", source=_backend(), compile_admission=gate)
    part.add_job(_distinct_program_job("a", 1.1))
    part.add_job(_distinct_program_job("b", 2.2))
    with pytest.raises(CompileBudgetExceeded, match="thrash"):
        part.add_job(_distinct_program_job("c", 3.3))
    assert gate.rejections == 1
    # rejection left nothing behind: removing one admits the next
    part.remove_job(part.job("a"))
    part.add_job(_distinct_program_job("c", 3.3))
    assert sorted(gate.programs) == ["b", "c"]


def test_admission_respects_declared_program_count():
    gate = CompileAdmission(CompileBudget(max_programs=4))
    part = Partition("p", source=_backend(), compile_admission=gate)
    part.add_job(Job("multi", step_fn=lambda s: s, state=0, n_programs=3,
                     max_steps=1))
    with pytest.raises(CompileBudgetExceeded):
        part.add_job(Job("big", step_fn=lambda s: s, state=0, n_programs=2,
                         max_steps=1))
    part.add_job(Job("fits", step_fn=lambda s: s, state=0, n_programs=1,
                     max_steps=1))


def test_admission_gates_on_time_budget_with_observed_mean():
    meter = CompileMeter.install()
    gate = CompileAdmission(CompileBudget(budget_ns=1), meter=meter)
    part = Partition("p", source=_backend(), compile_admission=gate)
    gate.charge("ghost", 0)  # no-op: unknown job ignored
    first = _distinct_program_job("first", 9.9)
    first.est_compile_ns = 0  # declared-free: admitted despite budget
    part.add_job(first)
    part.run(max_rounds=5)  # first job compiles; MEASURED spend charged
    assert gate.spent_ns.get("first", 0) > 0
    assert meter.mean_compile_ns > 0
    with pytest.raises(CompileBudgetExceeded, match="budget"):
        part.add_job(_distinct_program_job("second", 10.1))


def test_budget_holds_reservations_before_any_compile():
    gate = CompileAdmission(CompileBudget(budget_ns=10_000))
    part = Partition("p", source=_backend(), compile_admission=gate)
    part.add_job(Job("a", step_fn=lambda s: s, state=0,
                     est_compile_ns=8_000, max_steps=1))
    with pytest.raises(CompileBudgetExceeded):
        part.add_job(Job("b", step_fn=lambda s: s, state=0,
                         est_compile_ns=8_000, max_steps=1))
    assert gate.committed_ns() == 8_000
    part.remove_job(part.job("a"))  # release frees the reservation
    assert gate.committed_ns() == 0
    part.add_job(Job("b", step_fn=lambda s: s, state=0,
                     est_compile_ns=8_000, max_steps=1))


def test_declared_estimate_overrides_mean():
    gate = CompileAdmission(CompileBudget(budget_ns=1_000_000))
    part = Partition("p", source=_backend(), compile_admission=gate)
    with pytest.raises(CompileBudgetExceeded):
        part.add_job(Job("honest", step_fn=lambda s: s, state=0,
                         est_compile_ns=2_000_000, max_steps=1))
    part.add_job(Job("cheap", step_fn=lambda s: s, state=0,
                     est_compile_ns=10_000, max_steps=1))


def test_dump_surface():
    gate = CompileAdmission(CompileBudget(max_programs=8, budget_ns=10**12))
    part = Partition("p", source=_backend(), compile_admission=gate)
    part.add_job(_distinct_program_job("d", 5.5))
    d = gate.dump()
    assert d["programs_held"] == {"d": 1}
    assert d["max_programs"] == 8 and d["rejections"] == 0


def test_failed_admission_releases_the_claim():
    """A job refused after its compile claim (no ledger slot left) gives
    the claim back, so the name stays admissible."""
    gate = CompileAdmission(CompileBudget(max_programs=4))
    part = Partition("p", source=_backend(), compile_admission=gate,
                     ledger_slots=1)
    part.add_job(Job("a", step_fn=lambda s: s, state=0, max_steps=1))
    with pytest.raises(RuntimeError, match="ledger slots"):
        part.add_job(Job("b", step_fn=lambda s: s, state=0, max_steps=1))
    assert sorted(gate.programs) == ["a"]


# -- overflow sampling (tests/test_sampler.py) -------------------------------


def _partition(tokens_per_step=10):
    be = SimBackend()
    be.register("train", SimProfile.steady(
        step_time_ns=100_000, tokens=tokens_per_step))
    part = Partition("p", source=be)
    job = part.add_job(Job("train"))
    return part, job


def test_threshold_fires_exactly_once_then_rearm_fires_next():
    part, job = _partition(tokens_per_step=10)
    ctx = job.contexts[0]
    virq_deliveries = []
    part.events.bind_virq(Virq.TELEMETRY, virq_deliveries.append)

    sid = part.sampler.arm(ctx, Counter.TOKENS, period=100)
    part.run(max_rounds=100)
    part.events.deliver_pending()

    events = part.sampler.drain()
    assert len(events) == 1, "suspended sample must not re-fire"
    ev = events[0]
    assert ev.counter is Counter.TOKENS
    assert ev.value >= 100 and ev.threshold == 100
    assert ev.seq == 1
    assert virq_deliveries == [int(Virq.TELEMETRY)]
    assert int(ctx.counters[Counter.TOKENS]) >= 1000  # ran way past

    part.sampler.rearm(sid)
    current = int(ctx.counters[Counter.TOKENS])
    part.run(max_rounds=50)
    part.events.deliver_pending()
    events = part.sampler.drain()
    assert len(events) == 1
    assert events[0].seq == 2
    assert events[0].threshold == current + 100


def test_fires_on_crossing_quantum_not_before():
    part, job = _partition(tokens_per_step=10)
    ctx = job.contexts[0]
    part.sampler.arm(ctx, Counter.TOKENS, period=10_000_000)  # far away
    part.run(max_rounds=20)
    assert part.sampler.pending() == 0
    assert part.sampler.dump()[0]["armed"] is True


def test_disarm_and_multiple_samples_independent():
    part, job = _partition(tokens_per_step=10)
    ctx = job.contexts[0]
    s_tok = part.sampler.arm(ctx, Counter.TOKENS, period=50)
    s_steps = part.sampler.arm(ctx, Counter.STEPS_RETIRED, period=5)
    part.sampler.disarm(s_tok)
    part.run(max_rounds=50)
    events = part.sampler.drain()
    assert {e.sample_id for e in events} == {s_steps}
    assert events[0].counter is Counter.STEPS_RETIRED


def test_explicit_threshold_and_validation():
    part, job = _partition()
    ctx = job.contexts[0]
    sid = part.sampler.arm(ctx, Counter.STEPS_RETIRED, period=0,
                           threshold=3)
    part.run(max_rounds=30)
    evs = part.sampler.drain()
    assert len(evs) == 1 and evs[0].threshold == 3
    with pytest.raises(ValueError):
        part.sampler.arm(ctx, Counter.TOKENS, period=0)
    with pytest.raises(ValueError):
        part.sampler.rearm(sid, period=-1)
    with pytest.raises(KeyError):
        part.sampler.rearm(99999)


def test_remove_job_disarms_its_samples():
    part, job = _partition()
    part.sampler.arm(job.contexts[0], Counter.TOKENS, period=10)
    part.remove_job(job)
    assert part.sampler.dump() == []


def test_failed_job_disarms_its_samples():
    """A job whose quantum raises (here the SimBackend's, which knows no
    profile for it) is contained by ``fail_job``, which drops its
    overflow samples, in the port as in the reference."""
    pytest.importorskip("jax", reason="parity tests need the JAX reference")
    import pbs_tpu.runtime as ref_rt
    import pbs_tpu.telemetry as ref_tel

    import pbs_tpu_torch.runtime as port_rt
    import pbs_tpu_torch.telemetry as port_tel

    def bad(state):
        raise RuntimeError("step fault")

    def drive(rt, tel):
        part = rt.Partition("p", source=tel.SimBackend())
        job = part.add_job(rt.Job("bad", step_fn=bad, max_steps=4))
        part.sampler.arm(job.contexts[0], tel.Counter.TOKENS, 128)
        part.run(max_rounds=4)
        return job.error, part.sampler.dump()

    want = drive(ref_rt, ref_tel)
    got = drive(port_rt, port_tel)
    assert want[0] is not None and want[1] == []
    assert got == want


# -- the counter fault seam and stale telemetry (test_feedback_stale.py) -----


@pytest.fixture
def _no_leaked_plan():
    yield
    faults.uninstall()


def _stall_plan(job: str = "w") -> None:
    faults.install(FaultPlan(seed=0, specs=(
        FaultSpec("telemetry.counters", "stall", p=1.0, key=job),)))


def _setup(stall_frac=0.5, tslice_us=200, **fb_kw):
    be = SimBackend()
    part = Partition("t", source=be, scheduler="credit")
    fb = FeedbackPolicy(part, **fb_kw)
    be.register("w", SimProfile.steady(
        step_time_ns=100_000, stall_frac=stall_frac,
        collective_wait_ns=1_000))
    job = Job("w", params=SchedParams(tslice_us=tslice_us),
              max_steps=100_000)
    job.contexts[0].avg_step_ns = 100_000
    part.add_job(job)
    return part, fb, job


def test_stall_freezes_rate_channels_never_progress(_no_leaked_plan):
    _stall_plan()
    d = np.zeros(len(Counter), dtype=np.uint64)
    d[Counter.STEPS_RETIRED] = 3
    d[Counter.DEVICE_TIME_NS] = 1_000_000
    d[Counter.HBM_STALL_NS] = 500_000
    out = apply_counter_faults("w", d)
    assert out[Counter.DEVICE_TIME_NS] == 0
    assert out[Counter.HBM_STALL_NS] == 0
    assert out[Counter.STEPS_RETIRED] == 3


def test_spike_multiplies_rate_inputs_only(_no_leaked_plan):
    faults.install(FaultPlan(seed=0, specs=(
        FaultSpec("telemetry.counters", "spike", p=1.0, key="w",
                  args={"factor": 50.0}),)))
    d = np.zeros(len(Counter), dtype=np.uint64)
    d[Counter.STEPS_RETIRED] = 2
    d[Counter.HBM_STALL_NS] = 1_000
    out = apply_counter_faults("w", d)
    assert out[Counter.HBM_STALL_NS] == 50_000
    assert out[Counter.STEPS_RETIRED] == 2


def test_stale_telemetry_falls_back_to_default_band(_no_leaked_plan):
    part, fb, job = _setup(stale_after=3, fallback_us=500)
    part.run(until_ns=100_000_000)
    adapted = job.params.tslice_us
    assert adapted > 200
    _stall_plan()
    part.run(until_ns=200_000_000)
    st = fb.state_of(job)
    assert st.fallbacks == 1
    assert st.stale_ticks >= 3
    assert job.params.tslice_us == 500
    assert job.params.tslice_us != adapted


def test_steering_resumes_when_counters_come_back(_no_leaked_plan):
    part, fb, job = _setup(stale_after=3, fallback_us=500)
    _stall_plan()
    part.run(until_ns=100_000_000)
    assert job.params.tslice_us == 500
    assert fb.state_of(job).fallbacks == 1
    faults.uninstall()
    part.run(until_ns=250_000_000)
    st = fb.state_of(job)
    assert st.stale_ticks == 0
    assert job.params.tslice_us > 500
    assert st.grows > 0


def test_fallback_defaults_to_boot_param_band_value():
    part, fb, _ = _setup()
    assert fb.fallback_us == SchedParams().tslice_us


def test_idle_job_is_not_stale():
    part, fb, job = _setup(stale_after=1)
    part.run(until_ns=20_000_000)
    part.sleep_job(job)
    before = job.params.tslice_us
    part.run(until_ns=120_000_000)
    st = fb.state_of(job)
    assert st.fallbacks == 0
    assert st.stale_ticks == 0
    assert job.params.tslice_us == before


def test_cuda_backend_quanta_pass_through_the_seam(_no_leaked_plan):
    """A stalled readout on the card backend freezes device time while
    the retired steps still land — what the stale fallback detects."""
    _stall_plan("w")
    part = Partition("p", source=_backend())
    job = part.add_job(Job("w", step_fn=lambda s: s + 1, state=0,
                           max_steps=3))
    part.run(max_rounds=10)
    ctx = job.contexts[0]
    assert job.state == 3 and int(ctx.counters[Counter.STEPS_RETIRED]) == 3
    assert int(ctx.counters[Counter.DEVICE_TIME_NS]) == 0


# -- one fault plan, both packages --------------------------------------------


def test_fault_plan_trace_matches_reference():
    """The same FaultPlan (a stall and a spike on telemetry.counters)
    and seed drive SimBackend quanta in both packages: identical
    per-quantum counters, slices and fault-trace digest."""
    pytest.importorskip("jax", reason="parity tests need the JAX reference")
    import pbs_tpu.faults as ref_faults
    import pbs_tpu.runtime as ref_rt
    import pbs_tpu.sched as ref_sched
    import pbs_tpu.telemetry as ref_tel

    import pbs_tpu_torch.faults as port_faults
    import pbs_tpu_torch.runtime as port_rt
    import pbs_tpu_torch.sched as port_sched
    import pbs_tpu_torch.telemetry as port_tel

    def drive(fl, rt, sched, tel):
        plan = fl.FaultPlan(seed=5, specs=(
            fl.FaultSpec("telemetry.counters", "stall", p=0.15),
            fl.FaultSpec("telemetry.counters", "spike", p=0.1,
                         args={"factor": 7.0}),
        ))
        be = tel.SimBackend(seed=3)
        part = rt.Partition("p", source=be, scheduler="credit")
        fb = sched.FeedbackPolicy(part, stale_after=2)
        for job, prof in (
                (rt.Job("mem", params=rt.SchedParams(weight=512)),
                 tel.SimProfile.steady(step_time_ns=200_000, stall_frac=0.5,
                                       collective_wait_ns=2000,
                                       jitter=0.1)),
                (rt.Job("micro", micro_per_step=3, max_steps=400),
                 tel.SimProfile.steady(step_time_ns=300_000, stall_frac=0.05,
                                       collective_wait_ns=500))):
            be.register(job.name, prof)
            part.add_job(job)
        inj = fl.install(plan)
        try:
            frames = []
            for _ in range(300):
                part.run(max_rounds=1)
                frames.append((
                    [c.counters.tolist() for j in part.jobs
                     for c in j.contexts],
                    [j.params.tslice_us for j in part.jobs]))
        finally:
            fl.uninstall()
        return frames, fb.dump(), inj.trace_digest(), inj.records

    want = drive(ref_faults, ref_rt, ref_sched, ref_tel)
    got = drive(port_faults, port_rt, port_sched, port_tel)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert {r["fault"] for r in got[3]} == {"stall", "spike"}
    assert {r["key"] for r in got[3]} == {"mem", "micro"}
