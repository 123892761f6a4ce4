"""Gang scheduling in the port against the reference: twins of
``tests/test_gang.py``.

``GangMonitor`` and ``anti_stack_pick`` are copies; every case runs on
both packages' simulated partitions (``SimBackend``, no device) with the
same seedless profiles, and the placements, the skew counters, the
contention reports and the adapted quanta must be equal.
"""

from __future__ import annotations

import pytest

pytest.importorskip("jax", reason="parity tests need the JAX reference")

import pbs_tpu.parallel.gang as ref_gang  # noqa: E402
import pbs_tpu.runtime as ref_rt  # noqa: E402
import pbs_tpu.sched as ref_sched  # noqa: E402
import pbs_tpu.telemetry as ref_tel  # noqa: E402
import pbs_tpu_torch.parallel.gang as port_gang  # noqa: E402
import pbs_tpu_torch.runtime as port_rt  # noqa: E402
import pbs_tpu_torch.sched as port_sched  # noqa: E402
import pbs_tpu_torch.telemetry as port_tel  # noqa: E402

PACKAGES = {
    "ref": (ref_rt, ref_sched, ref_tel, ref_gang),
    "port": (port_rt, port_sched, port_tel, port_gang),
}


def _partition(pkg, n_executors=2):
    rt, _, tel, _ = PACKAGES[pkg]
    be = tel.SimBackend()
    part = rt.Partition("g", source=be, scheduler="credit",
                        n_executors=n_executors)
    return be, part


def _members_spread(pkg):
    rt, _, tel, _ = PACKAGES[pkg]
    be, part = _partition(pkg)
    be.register("ring", tel.SimProfile.steady(step_time_ns=100_000))
    ring = rt.Job("ring", n_contexts=2, gang=True, max_steps=1000)
    part.add_job(ring)
    sched = part.scheduler
    return [sched._cc(c).executor for c in ring.contexts]


def test_gang_members_spread_across_executors():
    got = _members_spread("port")
    assert got == _members_spread("ref")
    assert got[0] != got[1], "gang members stacked on one executor"


def _steal(pkg):
    rt, _, tel, _ = PACKAGES[pkg]
    be, part = _partition(pkg)
    be.register("ring", tel.SimProfile.steady(step_time_ns=100_000))
    ring = rt.Job("ring", n_contexts=2, gang=True, max_steps=100)
    part.add_job(ring)
    stolen = part.scheduler._steal(0, better_than=-3)
    return None if stolen is None else (stolen.job.name, stolen.job.gang)


def test_gang_not_stolen():
    got = _steal("port")
    assert got == _steal("ref")
    if got is not None:
        assert not got[1]


def _skewed(pkg, feedback: bool, until_ns: int, steps: int, **ring_kw):
    rt, sched, tel, gang = PACKAGES[pkg]
    be, part = _partition(pkg)
    fb = sched.FeedbackPolicy(part) if feedback else None
    gang.GangMonitor(part)
    be.register("ring", tel.SimProfile.steady(step_time_ns=100_000,
                                              **ring_kw))
    be.register("noise", tel.SimProfile.steady(step_time_ns=100_000))
    params = {"params": rt.SchedParams(tslice_us=900)} if feedback else {}
    ring = rt.Job("ring", n_contexts=2, gang=True, max_steps=steps, **params)
    ring.contexts[0].executor_hint = 0
    ring.contexts[1].executor_hint = 1
    part.add_job(ring)
    noise = rt.Job("noise", max_steps=steps)
    noise.contexts[0].executor_hint = 0  # compete with member 0 only
    part.add_job(noise)
    part.run(until_ns=until_ns)
    skew = [int(c.counters[tel.Counter.GANG_SKEW_NS]) for c in ring.contexts]
    return {"skew": skew, "events": ring.contention_events,
            "tslice_us": ring.params.tslice_us,
            "steps": [int(c.counters[tel.Counter.STEPS_RETIRED])
                      for c in ring.contexts]}, ring, fb


def test_gang_skew_feeds_contention():
    """A competitor on one member's executor creates progress skew; the
    GangMonitor reports it through the contention channel — the same
    skew, reports and progress in both packages."""
    got, ring, _ = _skewed("port", False, 200_000_000, 200_000)
    want, _, _ = _skewed("ref", False, 200_000_000, 200_000)
    assert got == want
    assert got["skew"][0] > 0, "no gang skew observed"
    ring.report_contention(1, 1)
    assert ring.contention_events >= 1


def test_gang_skew_drives_quantum_shrink():
    """Skewed gang + feedback policy => the quantum shrinks, to the same
    slice in both packages."""
    got, _, fb = _skewed("port", True, 400_000_000, 500_000,
                         stall_frac=0.01)
    want, _, fb_ref = _skewed("ref", True, 400_000_000, 500_000,
                              stall_frac=0.01)
    assert got == want
    assert got["tslice_us"] < 900, "quantum did not shrink"
    assert fb.dump() == fb_ref.dump()
