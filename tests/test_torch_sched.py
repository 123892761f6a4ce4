"""The port's scheduling core against ``pbs_tpu``'s, word for word.

The same seeded ``SimBackend`` profiles run through ``pbs_tpu``'s
``Partition`` + credit scheduler + ``FeedbackPolicy`` and through the
port's copies, under a ``VirtualClock``. The run is cut into fixed
virtual-time chunks; after every chunk each job's ``tslice_us``, every
context's counters, ledger words and run state, and the run queues
(order, priority, credit) must be identical, and at the
end so must ``Partition.dump()`` and ``FeedbackPolicy.dump()``. No
tolerance: the port copies the scheduling arithmetic, it does not
approximate it.
"""

from __future__ import annotations

import numpy as np
import pytest

pytest.importorskip("jax", reason="parity tests need the JAX reference")

import pbs_tpu.knobs  # noqa: E402
import pbs_tpu.runtime as ref_rt  # noqa: E402
import pbs_tpu.sched as ref_sched  # noqa: E402
import pbs_tpu.telemetry as ref_tel  # noqa: E402
import torch  # noqa: E402
import pbs_tpu_torch.runtime as port_rt  # noqa: E402
import pbs_tpu_torch.sched as port_sched  # noqa: E402
import pbs_tpu_torch.telemetry as port_tel  # noqa: E402
from pbs_tpu_torch import knobs as port_knobs  # noqa: E402

# The suite runs in parallel worker processes: uncapped, torch's intra-op
# pool takes every core in each of them and oversubscribes the host.
torch.set_num_threads(2)

REF = (ref_rt, ref_sched, ref_tel)
PORT = (port_rt, port_sched, port_tel)
MS = 1_000_000


def _memory_vs_compute(rt, tel):
    """The verify recipe: a memory-bound tenant against a compute-bound
    one — the first's slice grows to the cap, the second's stays at the
    floor."""
    ph = tel.SimProfile.steady
    return [
        (rt.Job("train", params=rt.SchedParams(weight=512)),
         ph(step_time_ns=200_000, stall_frac=0.5, collective_wait_ns=2000)),
        (rt.Job("serve", params=rt.SchedParams(weight=256)),
         ph(step_time_ns=50_000, stall_frac=0.02, collective_wait_ns=500)),
    ]


def _mixed(rt, tel):
    """Phases, jitter, a cap, micro-steps and a gang over two lanes."""
    Phase, Profile = tel.SimPhase, tel.SimProfile
    return [
        (rt.Job("phased", params=rt.SchedParams(weight=512)),
         Profile([Phase(steps=300, step_time_ns=300_000, stall_frac=0.4,
                        collective_wait_ns=1000, jitter=0.2),
                  Phase(steps=-1, step_time_ns=80_000, stall_frac=0.05,
                        jitter=0.1, tokens=16)])),
        (rt.Job("capped", params=rt.SchedParams(weight=1024, cap=5)),
         Profile.steady(step_time_ns=100_000, stall_frac=0.3,
                        collective_wait_ns=3000, jitter=0.3)),
        (rt.Job("micro", params=rt.SchedParams(weight=256), micro_per_step=4,
                max_steps=900),
         Profile.steady(step_time_ns=400_000, stall_frac=0.2)),
        (rt.Job("gang", params=rt.SchedParams(weight=128,
                                              boost_on_wake=False),
                n_contexts=2, gang=True),
         Profile.steady(step_time_ns=150_000, stall_frac=0.15, tokens=8,
                        jitter=0.05)),
    ]


SCENARIOS = {
    "memory_vs_compute": (_memory_vs_compute, 1, 2_000 * MS, 5 * MS),
    "mixed": (_mixed, 2, 1_500 * MS, 7 * MS),
}


def _trace(pkg, scenario):
    rt, sched, tel = pkg
    build, n_ex, horizon, chunk = SCENARIOS[scenario]
    be = tel.SimBackend(seed=11)
    part = rt.Partition("p", source=be, scheduler="credit",
                        n_executors=n_ex)
    fb = sched.FeedbackPolicy(part)
    jobs = []
    for job, profile in build(rt, tel):
        be.register(job.name, profile)
        jobs.append(part.add_job(job))
    frames = []
    t = 0
    i = 0
    while t < horizon:
        t += chunk
        i += 1
        if scenario == "mixed":
            # run-state churn and out-of-band contention reports
            if i == 40:
                part.sleep_job(jobs[1])
            elif i == 80:
                part.wake_job(jobs[1])
            if i % 30 == 10:  # a short nap: wakes with credit, BOOSTed
                part.sleep_job(jobs[0])
            elif i % 30 == 12:
                part.wake_job(jobs[0])
            if i % 25 == 0:
                jobs[3].report_contention(5_000 * (i % 4 + 1), events=2)
        part.run(until_ns=t)
        frames.append((
            t,
            [j.params.tslice_us for j in jobs],
            [c.counters.tolist() for j in jobs for c in j.contexts],
            [part.ledger.snapshot(c.ledger_slot).tolist()
             for j in jobs for c in j.contexts],
            [c.state.value for j in jobs for c in j.contexts],
            # run queues with each entry's priority and credit
            [part.scheduler.dump_executor(ex) for ex in part.executors],
        ))
    return frames, part.dump(), fb.dump()


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_sim_scheduling_trace_is_identical(scenario):
    ref_frames, ref_dump, ref_fb = _trace(REF, scenario)
    port_frames, port_dump, port_fb = _trace(PORT, scenario)
    assert len(port_frames) == len(ref_frames)
    for want, got in zip(ref_frames, port_frames):
        assert got == want, f"diverged at t={want[0]} ns"
    assert port_dump == ref_dump
    assert port_fb == ref_fb


def test_memory_bound_grows_compute_bound_stays():
    """The research claim on the port alone: the memory-bound tenant's
    slice grows to the band cap, the compute-bound one's stays at the
    floor, and device time splits by weight."""
    frames, dump, fb = _trace(PORT, "memory_vs_compute")
    by_job = {d["job"]: d for d in fb}
    assert by_job["train"]["tslice_us"] == 1100
    assert by_job["serve"]["tslice_us"] == 100
    counters = frames[-1][2]
    dev_train, dev_serve = counters[0][1], counters[1][1]
    assert 1.6 < dev_train / dev_serve < 2.4  # weights 512 : 256


def test_knob_table_matches_the_registry():
    """The port's typed registry declares every knob of the reference's
    (name, kind, unit, range, default, doc, native symbol) but the two
    roofline peaks of the accelerator the reference models."""
    ref = {k.name: k for k in pbs_tpu.knobs.all_knobs()}
    port = {k.name: k for k in port_knobs.all_knobs()}
    assert set(ref) - set(port) == set(port_knobs.registry.UNDECLARED)
    assert set(port) <= set(ref)
    for name, knob in port.items():
        assert knob.as_dict() == ref[name].as_dict(), name
        assert port_knobs.default(name) == pbs_tpu.knobs.default(name)
    assert port_rt.SchedParams().tslice_us == ref_rt.SchedParams().tslice_us
    with pytest.raises(port_knobs.KnobError, match="unknown knob"):
        port_knobs.default("telemetry.source.peak_flops")


def test_ledger_layout_matches_reference():
    assert port_tel.SLOT_WORDS == ref_tel.SLOT_WORDS
    assert port_tel.SLOT_BYTES == ref_tel.SLOT_BYTES
    assert [c.name for c in port_tel.Counter] == [
        c.name for c in ref_tel.Counter]
    led_p = port_tel.Ledger(4)
    led_r = ref_tel.Ledger(4, native=False)
    d = np.arange(port_tel.NUM_COUNTERS, dtype=np.uint64)
    for led in (led_p, led_r):
        led.reset(2)
        led.resume(2, 0)
        led.suspend(2, d)
        led.add(2, 3, 7)
    assert bytes(led_p.raw()) == bytes(led_r.raw())
    np.testing.assert_array_equal(led_p.snapshot_many([2, 0]),
                                  led_r.snapshot_many([2, 0]))
    with pytest.raises(IndexError):
        led_p.snapshot_many([-1])


def test_fault_is_contained_to_its_job():
    """A step that raises fails only its own job (every context FAILED,
    error recorded, JOB_FAILED signalled); the co-tenant runs on."""
    be = port_tel.CudaBackend(device="cpu")
    part = port_rt.Partition("p", source=be)
    failed = []
    part.events.bind_virq(port_rt.Virq.JOB_FAILED, failed.append)

    def crash(state):
        raise RuntimeError("synthetic device fault")

    doomed = part.add_job(port_rt.Job("doomed", step_fn=crash, max_steps=5))
    ok = part.add_job(port_rt.Job("ok", step_fn=lambda s: s + 1, state=0,
                                  max_steps=5))
    part.run(max_rounds=50)
    assert doomed.error == "RuntimeError: synthetic device fault"
    assert [c.state for c in doomed.contexts] == [
        port_rt.ContextState.FAILED]
    assert ok.state == 5 and ok.steps_retired() == 5
    assert failed == [int(port_rt.Virq.JOB_FAILED)]
    assert not part.pending_work()
