"""``Job.foreign`` and the foreign cost harvest against ``pbs_tpu``'s.

The five cases of ``tests/test_foreign_tenant.py`` — a tenant that
follows no protocol still gets measured phases, a harvested cost, no
sniffed metrics, and a quantum the feedback policy adapts — run on the
reference's ``TpuBackend`` over ``jax.jit`` callables and on the port's
``CudaBackend(device="cpu")`` over the same computations written in
PyTorch, from the same numpy inputs. Each side makes the reference
test's assertions; the adaptation soak stays ``slow``, as there. The
chained product carries its 1/N scale in its right operand, on both
sides, as phase 3f's ``fmm`` does: a separate division after each
product is an elementwise pass that the port's host profile bills as
memory time (16% of the step at N = 256 here), where XLA fuses it into
the product, and the compute-bound tenant would read as memory-bound.

The harvest's departure from the reference (one counted invocation in
place of lowering and compiling the jit wrapper) is pinned here: the
chained product's FLOPs are exactly 12·N³ per step in the port and
within 1% of XLA's count in the reference; bytes are not compared
(XLA's depend on its fusion), only held to at least the arguments' and
the output's bytes; the invocation's wall time is a front-end compile
event in the tenant's COMPILE_* slots, never its device time; and a
callable whose invocation runs no aten op, or raises, leaves
``job.compiled`` None (the reference's "not a jit stage").
"""

from __future__ import annotations

import time

import numpy as np
import pytest

jax = pytest.importorskip("jax", reason="parity tests need the JAX reference")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from pbs_tpu.runtime.job import Job as RefJob  # noqa: E402
from pbs_tpu.runtime.job import SchedParams as RefParams  # noqa: E402
from pbs_tpu.runtime.partition import Partition as RefPartition  # noqa: E402
from pbs_tpu.sched.feedback import FeedbackPolicy as RefFeedback  # noqa: E402
from pbs_tpu.telemetry.counters import Counter  # noqa: E402
from pbs_tpu.telemetry.source import TpuBackend  # noqa: E402
from pbs_tpu_torch.runtime import Job, Partition, SchedParams  # noqa: E402
from pbs_tpu_torch.sched import FeedbackPolicy  # noqa: E402
from pbs_tpu_torch.telemetry import CudaBackend  # noqa: E402
from pbs_tpu_torch.telemetry.counters import Counter as PCounter  # noqa: E402
from pbs_tpu_torch.telemetry.source import CountedCost  # noqa: E402

# The suite runs in parallel worker processes: uncapped, torch's intra-op
# pool takes every core in each of them and oversubscribes the host.
torch.set_num_threads(2)

N = 256


@jax.jit
def _mm_kernel(a, b):
    for _ in range(6):
        a = a @ b
    return a


@jax.jit
def _ew_kernel(a, scale):
    for _ in range(40):
        a = jnp.tanh(a) * scale + 0.1
    return a


def _mm_torch(a, b):
    for _ in range(6):
        a = a @ b
    return a


def _ew_torch(a, scale):
    for _ in range(40):
        a = torch.tanh(a) * scale + 0.1
    return a


def _np_x():
    return np.ones((N, N), np.float32)


def _np_w():
    """The product's right operand, its 1/N scale folded in."""
    return np.full((N, N), 1.0 / N, np.float32)


class Side:
    """One package's half of a case: its backend, partition, feedback
    policy and the foreign callables over its own array type."""

    def __init__(self, ref: bool):
        self.ref = ref
        if ref:
            self.Job, self.Params, self.Counter = RefJob, RefParams, Counter
            self.Partition, self.Feedback = RefPartition, RefFeedback
            self.mm, self.ew = _mm_kernel, _ew_kernel
            self.x = lambda: jnp.asarray(_np_x())
            self.w = lambda: jnp.asarray(_np_w())
        else:
            self.Job, self.Params, self.Counter = Job, SchedParams, PCounter
            self.Partition, self.Feedback = Partition, FeedbackPolicy
            self.mm, self.ew = _mm_torch, _ew_torch
            self.x = lambda: torch.from_numpy(_np_x())
            self.w = lambda: torch.from_numpy(_np_w())

    def backend(self, **kw):
        return TpuBackend(**kw) if self.ref else CudaBackend(device="cpu",
                                                             **kw)


SIDES = [Side(True), Side(False)]
IDS = ["ref", "port"]


@pytest.mark.parametrize("S", SIDES, ids=IDS)
def test_foreign_job_gets_measured_phases(S):
    be = S.backend(profile_every=0)
    part = S.Partition("p", source=be)
    mm = part.add_job(S.Job.foreign("mm", S.mm, S.x(), S.w(),
                                    profile_every=1, max_steps=6))
    ew = part.add_job(S.Job.foreign("ew", S.ew, S.x(), 0.5,
                                    profile_every=1, max_steps=6))
    part.run()
    assert mm.steps_retired() == 6 and ew.steps_retired() == 6
    m_mm, m_ew = be.measured("mm"), be.measured("ew")
    assert m_mm is not None and m_mm.n_ops > 0, (
        be.profiler and be.profiler.last_error)
    assert m_ew is not None and m_ew.n_ops > 0
    assert m_ew.stall_frac > m_mm.stall_frac + 0.2, (
        m_mm.top_ops, m_ew.top_ops)
    assert int(ew.contexts[0].counters[S.Counter.HBM_STALL_NS]) > 0


def _harvested_flops(S) -> tuple:
    be = S.backend(profile_every=0)
    part = S.Partition("p", source=be)
    job = part.add_job(S.Job.foreign("f", S.mm, S.x(), S.w(), max_steps=3))
    part.run()
    assert job.compiled is not None, "executable not harvested"
    assert int(job.contexts[0].counters[S.Counter.DEVICE_FLOPS]) > 0
    per_step = int(job.contexts[0].counters[S.Counter.DEVICE_FLOPS]) // 3
    assert per_step > 2 * N**3
    return job, per_step


def test_foreign_job_cost_analysis_harvested():
    """Both packages harvest the chained product's cost with no help
    from the tenant: 12·N³ exactly in the port, XLA's count within 1%
    of it in the reference."""
    _, ref_flops = _harvested_flops(SIDES[0])
    job, port_flops = _harvested_flops(SIDES[1])
    assert port_flops == 12 * N**3
    assert port_flops == pytest.approx(ref_flops, rel=0.01)
    assert isinstance(job.compiled, CountedCost)
    # 6 products, each reading two N² fp32 operands and writing one: at
    # least the arguments' and the output's bytes.
    assert job.compiled.nbytes >= 3 * N * N * 4
    assert job.compiled.nbytes == 6 * 3 * N * N * 4


@pytest.mark.parametrize("S", SIDES, ids=IDS)
def test_foreign_tuple_return_not_sniffed_as_metrics(S):
    if S.ref:
        @jax.jit
        def fn(a):
            return a * 2, {"tokens": jnp.sum(a)}
    else:
        def fn(a):
            return a * 2, {"tokens": torch.sum(a)}

    be = S.backend(profile_every=0)
    part = S.Partition("p", source=be)
    job = part.add_job(S.Job.foreign("t", fn, S.x(), max_steps=2))
    part.run()
    assert job.steps_retired() == 2
    assert int(job.contexts[0].counters[S.Counter.TOKENS]) == 0


@pytest.mark.parametrize("S", SIDES, ids=IDS)
def test_foreign_job_without_jit_stage_still_runs(S):
    """The reference: a callable that is not a jit stage. The port: a
    callable whose counted invocation launches no aten op (numpy on the
    host). Both run, measured by the profiler alone, ``compiled`` None."""
    if S.ref:
        def plain(a):
            return jnp.tanh(a).block_until_ready()
        arg = S.x()
    else:
        def plain(a):
            return np.tanh(a)
        arg = _np_x()
    be = S.backend(profile_every=0)
    part = S.Partition("p", source=be)
    job = part.add_job(S.Job.foreign("plain", plain, arg,
                                     profile_every=1, max_steps=2))
    part.run()
    assert job.steps_retired() == 2
    assert job.compiled is None


@pytest.mark.slow  # ~10 s adaptation soak, slow as in the reference
@pytest.mark.parametrize("S", SIDES, ids=IDS)
def test_feedback_adapts_foreign_quantum(S):
    be = S.backend(profile_every=0)
    part = S.Partition("p", source=be)
    fb = S.Feedback(part, tick_ns=1)
    mm = part.add_job(S.Job.foreign(
        "mm", S.mm, S.x(), S.w(), profile_every=1,
        params=S.Params(tslice_us=500)))
    ew = part.add_job(S.Job.foreign(
        "ew", S.ew, S.x(), 0.5, profile_every=1,
        params=S.Params(tslice_us=500)))
    for _ in range(14):
        part.run(max_rounds=2)
    assert ew.stall_rate > mm.stall_rate, (ew.stall_rate, mm.stall_rate)
    assert ew.stall_rate >= 100.0
    assert ew.params.tslice_us > 500, "stalled tenant's quantum must grow"
    assert mm.params.tslice_us < 500, "MXU tenant's quantum must shrink"
    assert fb.state_of(ew).ticks > 0


# -- the port's own contract -------------------------------------------------


def test_foreign_job_keeps_the_reference_spec():
    """``Job.foreign`` keeps the reference's fields: the adopted spec,
    the per-job profiling override (at least 1), fixed arguments."""
    x = torch.ones(2, 2)
    job = Job.foreign("f", _mm_torch, x, x, max_steps=1, profile_every=0)
    assert job._foreign_spec == (_mm_torch, (x, x), {})
    assert job.profile_every == 1
    assert job.compiled is None and job.state is None
    out = job.step_fn(None)
    assert isinstance(out, tuple) and out[1] == {}
    assert torch.equal(out[0], _mm_torch(x, x))
    assert Job.foreign("g", _ew_torch, x, scale=0.5).profile_every == 8


def test_counted_invocation_is_a_compile_event_not_device_time():
    """The harvest runs the callable once, in the job's attribution
    scope: its wall time lands in COMPILE_TIME_NS as a front-end event
    (no COMPILES), the first step's device time is its own, and the
    outputs are thrown away."""
    calls = []

    def slow(a):
        calls.append(1)
        time.sleep(0.05)
        return a + 1

    be = CudaBackend(device="cpu", profile_every=0)
    part = Partition("p", source=be)
    job = part.add_job(Job.foreign("slow", slow, torch.ones(4),
                                   max_steps=1))
    part.run()
    ctr = job.contexts[0].counters
    assert len(calls) == 2  # the counted invocation, then the one step
    assert int(ctr[PCounter.COMPILES]) == 0
    assert int(ctr[PCounter.COMPILE_TIME_NS]) >= 50_000_000
    assert int(ctr[PCounter.DEVICE_TIME_NS]) >= 50_000_000
    assert job.compiled.n_ops == 1 and job.compiled.flops == 0
    assert be.compile_meter.take("slow") == (0, 0)


def test_raising_invocation_leaves_compiled_none():
    """A callable whose counted invocation raises harvests nothing; the
    step that raises is the partition's to contain."""
    def broken(a):
        raise RuntimeError("tenant bug")

    be = CudaBackend(device="cpu", profile_every=0)
    part = Partition("p", source=be)
    job = part.add_job(Job.foreign("b", broken, torch.ones(2),
                                   max_steps=1))
    with pytest.raises(RuntimeError, match="tenant bug"):
        be.execute(job.contexts[0], 1)
    assert job.compiled is None
    assert be._costs["b"] == (0, 0)
    assert be.harvest_errors == {"b": "RuntimeError: tenant bug"}


def test_views_and_allocations_move_no_bytes():
    """The byte counter skips views and bare allocations and counts an
    in-place op's operand twice (read and written)."""
    from pbs_tpu_torch.telemetry.source import count_invocation

    a = torch.ones(8, 8)

    def views(x):
        x.t()
        x.reshape(-1).view(8, 8)
        torch.empty(1000)
        return x

    assert count_invocation(views, (a,), {}) is not None
    assert count_invocation(views, (a,), {}).nbytes == 0
    inplace = count_invocation(lambda x: x.add_(1), (a.clone(),), {})
    assert inplace.nbytes == 2 * 64 * 4
