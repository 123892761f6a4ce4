"""HBM paging on the port, against ``pbs_tpu``: twins of
``tests/test_paging.py`` (its control-plane and Remus cases are in
``tests/test_torch_agent.py``, with the agent).

Each script runs once through the JAX package and once through the
port, the port's tenants on ``CudaBackend(device="cpu")`` with a torch
step where the reference jits one; the records (accounts after each
operation, errors, ``paged_bytes``, console lines, bitwise round trips)
and the perfc deltas of the memory and paging counters must be equal.
Steps retired are compared as "moved or not": both backends size a
quantum from the host's wall clock.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import pytest

jax = pytest.importorskip("jax", reason="parity tests need the JAX reference")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import pbs_tpu.runtime as ref_rt  # noqa: E402
import pbs_tpu.runtime.paging as ref_paging  # noqa: E402
import pbs_tpu_torch.runtime as port_rt  # noqa: E402
import pbs_tpu_torch.runtime.paging as port_paging  # noqa: E402
from pbs_tpu import telemetry as ref_tel  # noqa: E402
from pbs_tpu.obs.perfc import perfc as ref_perfc  # noqa: E402
from pbs_tpu.telemetry.source import TpuBackend  # noqa: E402
from pbs_tpu_torch import telemetry as port_tel  # noqa: E402
from pbs_tpu_torch.obs.perfc import perfc as port_perfc  # noqa: E402

# The suite runs in parallel worker processes: uncapped, torch's intra-op
# pool takes every core in each of them and oversubscribes the host.
torch.set_num_threads(2)

MB = 1 << 20
COUNTER_PREFIXES = ("mem_", "paging_")


def _jax_train_job(name, n=128, max_steps=50):
    @jax.jit
    def step(x):
        return jnp.tanh(x) + 0.01

    x0 = jnp.zeros((n, n), jnp.float32)
    step(x0).block_until_ready()
    return ref_rt.Job(name, step_fn=step, state=x0, max_steps=max_steps)


def _torch_train_job(name, n=128, max_steps=50):
    def step(x):
        return torch.tanh(x) + 0.01

    return port_rt.Job(name, step_fn=step, state=torch.zeros(n, n),
                       max_steps=max_steps)


@dataclasses.dataclass(frozen=True)
class Side:
    rt: Any
    tel: Any
    paging: Any
    perfc: Any
    backend: Callable[[], Any]
    train_job: Callable[..., Any]
    to_numpy: Callable[[Any], np.ndarray]


REF = Side(ref_rt, ref_tel, ref_paging, ref_perfc, TpuBackend,
           _jax_train_job, lambda x: np.asarray(x).copy())
PORT = Side(port_rt, port_tel, port_paging, port_perfc,
            lambda: port_tel.CudaBackend(device="cpu"), _torch_train_job,
            lambda t: t.numpy().copy())


def outcome(fn: Callable, *args, **kw) -> tuple:
    try:
        return ("ok", fn(*args, **kw))
    except Exception as e:  # noqa: BLE001 — the record IS the outcome
        return (type(e).__name__, str(e), getattr(e, "reason", None))


def _counters(perfc) -> dict:
    return {k: v for k, v in perfc.dump().items()
            if k.startswith(COUNTER_PREFIXES)}


def both(script: Callable[[Side], list]) -> list:
    results = []
    for side in (REF, PORT):
        before = _counters(side.perfc)
        rec = script(side)
        after = _counters(side.perfc)
        delta = {k: v - before.get(k, 0) for k, v in after.items()
                 if v != before.get(k, 0)}
        results.append((rec, delta))
    assert results[1] == results[0]
    return results[1][0]


def _console(job) -> list[str]:
    return [ln["line"] for ln in job.console.read()["lines"]]


def test_page_out_in_round_trip_exact():
    def script(s):
        part = s.rt.Partition("p", source=s.backend())
        job = part.add_job(s.train_job("t"))
        part.run(max_rounds=3)
        before = s.to_numpy(job.state)
        steps_before = job.steps_retired()
        part.sleep_job(job)
        freed = s.rt.page_out_job(part, job)
        assert job.paged is not None
        # state is host-resident markers now; counters untouched
        rec = [freed, job.paged_bytes, job.paged_acct_bytes,
               job.steps_retired() == steps_before]
        part.wake_job(job)  # transparent fault-back
        assert job.paged is None
        rec.append(np.array_equal(s.to_numpy(job.state), before))
        part.run(max_rounds=3)
        rec.append(job.steps_retired() > steps_before)  # trains on
        rec.append(_console(job))
        return rec

    rec = both(script)
    assert rec[0] == 128 * 128 * 4 and all(rec[3:6])
    assert rec[-1][1:] == [f"paged out: {rec[0]} bytes to host",
                           f"paged in: {rec[0]} bytes to device"]


def test_runnable_job_refuses_page_out():
    def script(s):
        part = s.rt.Partition("p", source=s.backend())
        job = part.add_job(s.train_job("r"))
        rec = [outcome(s.rt.page_out_job, part, job)]
        assert rec[0][0] == "PagingError" and "sleep it" in rec[0][1]
        return rec

    both(script)


def test_paging_releases_and_reclaims_accounting():
    def script(s):
        mem = s.rt.MemoryManager(capacity_bytes=2 * MB)
        part = s.rt.Partition("p", source=s.backend(), memory=mem)
        job = part.add_job(s.train_job("acct", n=256))  # 256KB claim
        used0 = mem.account("acct").used_bytes
        assert used0 >= 256 * 256 * 4
        part.sleep_job(job)
        freed = s.rt.page_out_job(part, job)
        assert mem.account("acct").used_bytes == used0 - freed
        rec = [used0, freed, mem.dump()]
        part.wake_job(job)
        assert mem.account("acct").used_bytes == used0
        return rec + [mem.dump()]

    both(script)


def test_admission_pressure_pages_out_sleeping_neighbor():
    """A new tenant fits because a parked one gets paged, automatically,
    through the balloon path."""
    def script(s):
        mem = s.rt.MemoryManager(capacity_bytes=300 * 1024)
        part = s.rt.Partition("p", source=s.backend(), memory=mem)
        a = part.add_job(s.train_job("a", n=256))  # 256KB of 300KB
        s.rt.register_paging_reclaim(part, a)
        part.sleep_job(a)  # parked
        b = part.add_job(s.train_job("b", n=256))  # would not fit...
        assert a.paged is not None  # ...so the sleeper got paged out
        rec = [mem.dump(), a.paged_bytes]
        part.run(max_rounds=3)
        rec.append(b.steps_retired() > 0)
        # waking A now must fail loudly — B holds the card
        rec.append(outcome(part.wake_job, a))
        assert rec[-1][0] == "OutOfDeviceMemory"
        assert a.paged is not None  # still safe, still asleep
        rec.append(mem.dump())
        part.remove_job(b)
        part.wake_job(a)  # now it fits again
        assert a.paged is None
        part.run(max_rounds=3)
        assert a.error is None
        return rec + [mem.dump(), _console(a), _console(b)]

    rec = both(script)
    assert rec[2] is True
    assert "paged out under pressure: 262144 bytes to host" in rec[-2]


def test_balloon_skips_runnable_jobs():
    def script(s):
        mem = s.rt.MemoryManager(capacity_bytes=300 * 1024)
        part = s.rt.Partition("p", source=s.backend(), memory=mem)
        a = part.add_job(s.train_job("a", n=256))
        s.rt.register_paging_reclaim(part, a)  # registered but RUNNABLE
        rec = [outcome(part.add_job, s.train_job("b", n=256)), mem.dump()]
        assert rec[0][0] == "OutOfDeviceMemory"
        assert a.paged is None  # never paged out from under a runnable job
        return rec

    both(script)


def test_reclaim_hook_survives_a_miss():
    """One balloon pass while the tenant is runnable must NOT unregister
    its paging hook: "nothing right now" is transient."""
    def script(s):
        mem = s.rt.MemoryManager(capacity_bytes=300 * 1024)
        part = s.rt.Partition("p", source=s.backend(), memory=mem)
        a = part.add_job(s.train_job("a", n=256))
        s.rt.register_paging_reclaim(part, a)
        # miss #1: a is runnable, the claim fails, hook returns 0
        rec = [outcome(part.add_job, s.train_job("b", n=256))]
        part.sleep_job(a)  # the SAME hook must fire for the next claim
        c = part.add_job(s.train_job("c", n=256))
        assert a.paged is not None
        part.run(max_rounds=2)
        return rec + [c.steps_retired() > 0, mem.dump()]

    both(script)


def test_sim_jobs_page_as_noop():
    """A SimBackend job has no device tensors: paging frees 0 and wake
    stays cheap — the API is uniform across backends."""
    def script(s):
        be = s.tel.SimBackend()
        be.register("s", s.tel.SimProfile.steady(step_time_ns=1_000_000))
        part = s.rt.Partition("p", source=be)
        job = part.add_job(s.rt.Job("s", max_steps=100))
        part.sleep_job(job)
        rec = [s.rt.page_out_job(part, job), job.paged]
        part.wake_job(job)
        part.run(max_rounds=3)
        return rec + [job.steps_retired()]

    rec = both(script)
    assert rec[:2] == [0, None] and rec[2] > 0


def test_paging_a_paged_job_frees_nothing():
    def script(s):
        part = s.rt.Partition("p", source=s.backend())
        job = part.add_job(s.train_job("t", n=64))
        part.sleep_job(job)
        return [s.rt.page_out_job(part, job), s.rt.page_out_job(part, job),
                s.rt.page_in_job(part, job), s.rt.page_in_job(part, job)]

    assert both(script) == [64 * 64 * 4, 0, 64 * 64 * 4, 0]


def test_failed_restore_leaves_the_job_paged(monkeypatch):
    """A page-in whose copy fails keeps the job asleep and paged and
    gives its claim back, in both packages."""
    def broken(state, paged):
        raise RuntimeError("copy failed")

    monkeypatch.setattr(ref_paging, "_restore_state", broken)
    monkeypatch.setattr(port_paging, "_restore_state", broken)

    def script(s):
        mem = s.rt.MemoryManager(capacity_bytes=1 * MB)
        part = s.rt.Partition("p", source=s.backend(), memory=mem)
        job = part.add_job(s.train_job("t", n=64))
        part.sleep_job(job)
        s.rt.page_out_job(part, job)
        rec = [outcome(part.wake_job, job), job.paged is not None,
               [c.state.value for c in job.contexts], mem.dump()]
        return rec

    rec = both(script)
    assert rec[0][:2] == ("RuntimeError", "copy failed")
    assert rec[1] and rec[2] == ["blocked"]


def test_state_tree_pages_tensors_and_keeps_scalars():
    """The port's state trees: every tensor leaf of a nested dict, list
    and tuple is paged (bf16 and int leaves too, bit for bit), Python
    scalars stay, and the structure and key order come back as they
    were."""
    gen = torch.Generator().manual_seed(3)
    state = {"z": [torch.randn(5, 7, generator=gen).bfloat16(),
                   (torch.arange(6, dtype=torch.int32), 4)],
             "a": torch.randn(3, generator=gen), "step": 9}
    want = {k: v for k, v in state.items()}
    part = port_rt.Partition("p", source=port_tel.CudaBackend(device="cpu"))
    job = part.add_job(port_rt.Job("t", step_fn=lambda s: s, state=state,
                                   max_steps=1))
    part.sleep_job(job)
    freed = port_rt.page_out_job(part, job)
    assert freed == 5 * 7 * 2 + 6 * 4 + 3 * 4
    assert isinstance(job.state["a"], port_paging._PagedLeaf)
    assert job.state["step"] == 9 and job.state["z"][1][1] == 4
    part.wake_job(job)
    got = job.state
    assert list(got) == ["z", "a", "step"]
    assert isinstance(got["z"][1], tuple)
    assert torch.equal(got["z"][0], want["z"][0])
    assert got["z"][0].dtype == torch.bfloat16
    assert torch.equal(got["z"][1][0], want["z"][1][0])
    assert torch.equal(got["a"], want["a"])


def test_restore_onto_a_device_that_is_gone():
    """A leaf recorded on a card this process cannot see comes back on
    the default device (the host here), the reference's fallback."""
    host = torch.arange(4.0)
    placeholder = {"w": port_paging._PagedLeaf(0)}
    got = port_paging._restore_state(
        placeholder, [(host, torch.device("cuda", 7))])
    assert got["w"].device.type == (
        "cuda" if torch.cuda.is_available() else "cpu")
    assert torch.equal(got["w"].cpu(), host)


def test_page_out_drops_the_last_reference():
    """Paging frees the device memory only if nothing else holds the
    tensors: once the state is paged, no reference to its old leaves is
    left — not even one the garbage collector would have to find."""
    import gc
    import weakref

    state = {"w": torch.randn(64, 64), "n": [torch.arange(9), 3]}
    refs = [weakref.ref(state["w"]), weakref.ref(state["n"][0])]
    part = port_rt.Partition("p", source=port_tel.CudaBackend(device="cpu"))
    job = part.add_job(port_rt.Job("t", step_fn=lambda s: s, state=state,
                                   max_steps=1))
    del state
    part.sleep_job(job)
    gc.disable()
    try:
        assert port_rt.page_out_job(part, job) == 64 * 64 * 4 + 9 * 8
        assert [r() for r in refs] == [None, None]
    finally:
        gc.enable()
