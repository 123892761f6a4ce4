"""HBM accounting and shared weights on the port, against ``pbs_tpu``.

Twins of ``tests/test_memory.py`` and ``tests/test_sharing.py``: each
script runs once through the JAX package and once through the port
(``CudaBackend(device="cpu")`` where the reference uses ``TpuBackend``,
tensors where it uses jax arrays, inputs from a numpy seed), records
``MemoryManager.dump()`` after each operation, every raised error (type,
message, ``reason``) and the results, and the two records must be equal,
as must the two packages' perfc deltas of the memory, paging and
sharing counters.
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
import pbs_tpu_torch.runtime as port_rt  # noqa: E402
from pbs_tpu import models as ref_models  # noqa: E402
from pbs_tpu import telemetry as ref_tel  # noqa: E402
from pbs_tpu.obs.perfc import perfc as ref_perfc  # noqa: E402
from pbs_tpu.telemetry.source import TpuBackend  # noqa: E402
from pbs_tpu_torch import models as port_models  # noqa: E402
from pbs_tpu_torch import telemetry as port_tel  # noqa: E402
from pbs_tpu_torch.obs.perfc import perfc as port_perfc  # noqa: E402

# The suite runs in parallel worker processes: uncapped, torch's intra-op
# pool takes every core in each of them and oversubscribes the host.
torch.set_num_threads(2)

GB = 1 << 30
MB = 1 << 20
MS = 1_000_000
TINY = dict(vocab=64, d_model=32, n_layers=2, n_heads=2, n_kv_heads=2,
            d_ff=64, max_seq=128)
#: The counters this slice's modules bump.
COUNTER_PREFIXES = ("mem_", "paging_", "weights_")


@dataclasses.dataclass(frozen=True)
class Side:
    rt: Any
    tel: Any
    models: Any
    perfc: Any
    backend: Callable[[], Any]
    array: Callable[[np.ndarray], Any]
    to_numpy: Callable[[Any], np.ndarray]


REF = Side(ref_rt, ref_tel, ref_models, ref_perfc, TpuBackend,
           jnp.asarray, np.asarray)
PORT = Side(port_rt, port_tel, port_models, port_perfc,
            lambda: port_tel.CudaBackend(device="cpu"), torch.from_numpy,
            lambda t: t.numpy())


def outcome(fn: Callable, *args, **kw) -> tuple:
    """("ok", result) or (error type, message, reason)."""
    try:
        return ("ok", fn(*args, **kw))
    except Exception as e:  # noqa: BLE001 — the record IS the outcome
        return (type(e).__name__, str(e), getattr(e, "reason", None))


def _counters(perfc) -> dict:
    return {k: v for k, v in perfc.dump().items()
            if k.startswith(COUNTER_PREFIXES)}


def both(script: Callable[[Side], list]) -> list:
    """Run ``script`` through both packages; their records and counter
    deltas must be equal. Returns the port's record."""
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


# -- twins of tests/test_memory.py -----------------------------------------


def test_claim_release_and_caps():
    def script(s):
        mm = s.rt.MemoryManager(4 * GB)
        mm.open_account("a", max_bytes=1 * GB)
        mm.open_account("b")
        rec = [outcome(mm.claim, "a", 512 * MB),
               outcome(mm.claim, "a", 600 * MB),  # over the cap
               outcome(mm.claim, "b", 3 * GB),
               outcome(mm.claim, "b", 1 * GB),  # over capacity
               mm.dump(),
               outcome(mm.release, "b", 3 * GB),
               outcome(mm.claim, "b", 1 * GB),
               mm.account("a").used_bytes, mm.dump()]
        assert rec[1][0] == "OutOfDeviceMemory" and rec[1][2] == "cap"
        assert rec[3][2] == "capacity" and "free" in rec[3][1]
        assert rec[-1]["free"] == 4 * GB - 512 * MB - 1 * GB
        return rec

    both(script)


def test_reserve_counts_against_capacity():
    def script(s):
        mm = s.rt.MemoryManager(4 * GB, reserve_bytes=1 * GB)
        mm.open_account("a")
        rec = [outcome(mm.claim, "a", 3 * GB + 1),
               outcome(mm.claim, "a", 3 * GB), mm.dump()]
        assert rec[0][0] == "OutOfDeviceMemory" and rec[1][0] == "ok"
        return rec

    both(script)


def test_balloon_reclaims_biggest_consumer_first():
    def script(s):
        mm = s.rt.MemoryManager(4 * GB)
        mm.open_account("fat")
        mm.open_account("thin")
        mm.claim("fat", 3 * GB)
        mm.claim("thin", 512 * MB)
        released = []
        mm.register_reclaim("fat",
                            lambda need: released.append(need) or 2 * GB)
        mm.register_reclaim("thin", lambda need: 0)
        freed = mm.balloon(2 * GB)
        assert freed == 2 * GB and released
        assert mm.account("fat").used_bytes == 1 * GB
        return [freed, released, mm.dump(), mm.free_bytes()]

    both(script)


def test_claim_or_balloon_retries_once():
    def script(s):
        mm = s.rt.MemoryManager(2 * GB)
        mm.open_account("old")
        mm.open_account("new")
        mm.claim("old", 2 * GB)
        mm.register_reclaim("old", lambda need: 1 * GB)
        mm.claim_or_balloon("new", 1 * GB)
        assert mm.account("new").used_bytes == 1 * GB
        return [mm.dump()]

    both(script)


def test_uncooperative_balloon_terminates():
    def script(s):
        mm = s.rt.MemoryManager(1 * GB)
        mm.open_account("stubborn")
        mm.claim("stubborn", 1 * GB)
        mm.register_reclaim("stubborn", lambda need: 0)
        freed = mm.balloon(1 * GB)  # no infinite loop
        assert freed == 0
        return [freed, mm.dump()]

    both(script)


def test_nbytes_of_tree():
    """The reference's numpy tree, and the same tree as tensors."""
    state = {"w": np.zeros((128, 128), np.float32),
             "b": np.zeros(128, np.float32), "step": 3}
    want = 128 * 128 * 4 + 128 * 4
    assert ref_rt.nbytes_of(state) == port_rt.nbytes_of(state) == want
    as_tensors = {"w": torch.zeros(128, 128), "b": torch.zeros(128),
                  "step": 3}
    assert port_rt.nbytes_of(as_tensors) == want
    assert ref_rt.nbytes_of(None) == port_rt.nbytes_of(None) == 0


def test_partition_admission_claims_and_releases():
    def script(s):
        be = s.tel.SimBackend()
        mm = s.rt.MemoryManager(1 * GB)
        part = s.rt.Partition("p", source=be, scheduler="credit", memory=mm)
        be.register("big", s.tel.SimProfile.steady(step_time_ns=1 * MS))
        be.register("huge", s.tel.SimProfile.steady(step_time_ns=1 * MS))
        big = part.add_job(s.rt.Job("big", mem_bytes=800 * MB))
        rec = [mm.dump(),
               outcome(part.add_job, s.rt.Job("huge", mem_bytes=500 * MB)),
               mm.dump(), [j.name for j in part.jobs]]
        # denied admission leaves no account/scheduler debris
        assert rec[1][0] == "OutOfDeviceMemory"
        assert "huge" not in rec[2]["accounts"] and rec[3] == ["big"]
        part.remove_job(big)
        rec.append(mm.free_bytes())
        part.add_job(s.rt.Job("huge", mem_bytes=500 * MB))  # now it fits
        rec.append(mm.dump())
        rec.append([ln["line"] for ln in big.console.read()["lines"]])
        return rec

    rec = both(script)
    assert rec[4] == 1 * GB
    assert rec[-1] == ["admitted to p (1 ctx, scheduler credit)",
                       "destroyed"]


def test_admission_estimates_from_state_and_balloons():
    def script(s):
        be = s.tel.SimBackend()
        mm = s.rt.MemoryManager(8 * MB)
        part = s.rt.Partition("p", source=be, scheduler="credit", memory=mm)
        be.register("cached", s.tel.SimProfile.steady(step_time_ns=1 * MS))
        be.register("incoming",
                    s.tel.SimProfile.steady(step_time_ns=1 * MS))
        part.add_job(s.rt.Job("cached", mem_bytes=6 * MB))
        mm.register_reclaim("cached", lambda need: 4 * MB)
        state = s.array(np.zeros(4 * MB, np.uint8))
        part.add_job(s.rt.Job("incoming", state=state))  # estimated 4 MB
        assert mm.account("incoming").used_bytes == 4 * MB
        assert mm.account("cached").used_bytes == 2 * MB  # ballooned down
        return [mm.dump()]

    both(script)


def test_cap_denial_does_not_balloon_others():
    def script(s):
        evictions = []
        mm = s.rt.MemoryManager(8 * GB)
        mm.open_account("capped", max_bytes=1 * GB)
        mm.open_account("other")
        mm.claim("other", 2 * GB)
        mm.register_reclaim("other",
                            lambda need: evictions.append(need) or GB)
        rec = [outcome(mm.claim_or_balloon, "capped", 2 * GB), evictions,
               mm.dump()]
        assert rec[0][2] == "cap" and evictions == []
        assert mm.account("other").used_bytes == 2 * GB
        return rec

    both(script)


def test_admission_failure_after_claim_unwinds_account():
    def script(s):
        be = s.tel.SimBackend()
        mm = s.rt.MemoryManager(1 * GB)
        part = s.rt.Partition("p", source=be, scheduler="credit", memory=mm,
                              ledger_slots=1)
        be.register("a", s.tel.SimProfile.steady(step_time_ns=1 * MS))
        be.register("b", s.tel.SimProfile.steady(step_time_ns=1 * MS))
        part.add_job(s.rt.Job("a", mem_bytes=MB))
        rec = [outcome(part.add_job, s.rt.Job("b", mem_bytes=MB)),
               mm.dump()]
        # claim unwound: account closed, capacity restored, retryable
        assert rec[0][0] == "RuntimeError" and "slots exhausted" in rec[0][1]
        assert "b" not in rec[1]["accounts"]
        assert mm.free_bytes() == 1 * GB - MB
        part.remove_job(part.job("a"))
        part.add_job(s.rt.Job("b", mem_bytes=MB))
        rec.append(mm.dump())
        return rec

    both(script)


def test_device_memory_stats_on_the_host():
    """No card, no numbers: ``{}`` as the reference gives on the CPU, and
    ``for_device`` falls back to its 16 GiB default there only."""
    assert port_rt.device_memory_stats("cpu") == {}
    mm = port_rt.MemoryManager.for_device("cpu")
    assert (mm.capacity, mm.reserve) == (16 << 30, 0)
    ref = ref_rt.MemoryManager.for_device(jax.devices("cpu")[0])
    assert ref.dump() == mm.dump()
    if not torch.cuda.is_available():  # the card by default: raises here
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_rt.MemoryManager.for_device()


# -- twins of tests/test_sharing.py ----------------------------------------


def test_refcount_lifecycle_and_accounting():
    def script(s):
        mem = s.rt.MemoryManager(capacity_bytes=10 << 20)
        reg = s.rt.WeightsRegistry(memory=mem)
        params = {"w": s.array(np.ones((256, 256), np.float32))}
        sw = reg.publish("m1", params)
        rec = [sw.nbytes, mem.dump()]
        p1 = reg.acquire("m1")
        p2 = reg.acquire("m1")
        assert p1 is p2 is params  # literally the same tensors
        rec += [reg.refs("m1"), reg.saved_bytes(), reg.dump(),
                reg.release("m1"), reg.release("m1"),
                outcome(reg.acquire, "m1"),  # unpublished at zero refs
                outcome(mem.account, "shared:m1"),  # account closed
                mem.dump()]
        assert rec[3] == sw.nbytes  # 2 sharers, 1 copy
        assert rec[7][0] == rec[8][0] == "KeyError"
        return rec

    both(script)


def test_duplicate_publish_rejected():
    def script(s):
        reg = s.rt.WeightsRegistry()
        reg.publish("m", {"w": s.array(np.zeros(4, np.float32))})
        rec = [outcome(reg.publish, "m",
                       {"w": s.array(np.zeros(4, np.float32))})]
        assert rec[0][0] == "ValueError" and "already published" in rec[0][1]
        return rec

    both(script)


def test_density_three_tenants_one_copy():
    """The mem-sharing headline: three same-model serving tenants fit
    where two private copies would not. The reference's weights, carried
    to the port as numpy."""
    jcfg = ref_models.TransformerConfig(**TINY, dtype=jnp.float32)
    jparams = ref_models.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = port_models.TransformerConfig(**TINY, dtype=torch.float32)
    tparams = port_models.params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu")

    def script(s):
        port = s is PORT
        cfg, params = (tcfg, tparams) if port else (jcfg, jparams)
        pbytes = s.rt.nbytes_of(params)
        # room for ~1.5 copies of the weights plus small private states
        mem = s.rt.MemoryManager(capacity_bytes=int(pbytes * 1.5))
        reg = s.rt.WeightsRegistry(memory=mem)
        reg.publish("flagship", params)
        part = s.rt.Partition("p", source=s.backend(), memory=mem)
        engines = []
        extra = {"device": "cpu"} if port else {}
        for i in range(3):
            shared = reg.acquire("flagship")
            eng = s.models.ContinuousBatcher(cfg, shared, n_slots=1,
                                             prompt_bucket=8, max_len=32,
                                             **extra)
            kv_bytes = s.rt.nbytes_of(eng.cache)

            def serve(st, _eng=eng):
                if not _eng.has_work():
                    _eng.submit([3, 1], max_new_tokens=2)
                _eng.step()
                return st + 1

            # the tenant's claim is its PRIVATE state (KV cache), not
            # the shared weights
            part.add_job(s.rt.Job(f"svc{i}", step_fn=serve, state=0,
                                  mem_bytes=kv_bytes, max_steps=6))
            engines.append(eng)
        part.run(max_rounds=30)
        rec = [pbytes, [e.tokens_emitted for e in engines], reg.refs(
            "flagship"), reg.saved_bytes(), mem.dump()]
        assert all(n > 0 for n in rec[1])
        assert rec[2] == 3 and rec[3] == 2 * pbytes
        # control: three PRIVATE copies genuinely would not fit
        opened = []
        for i in range(2):
            mem.open_account(f"private{i}")
            opened.append(outcome(mem.claim, f"private{i}", pbytes))
        assert opened[-1][0] == "OutOfDeviceMemory"
        return rec + [opened, mem.dump()]

    both(script)


def test_release_underflow_raises():
    def script(s):
        reg = s.rt.WeightsRegistry()
        reg.publish("m", {"w": s.array(np.zeros(4, np.float32))})
        reg.acquire("m")
        rec = [reg.release("m")]  # legit: unpublished at zero
        reg.publish("m2", {"w": s.array(np.zeros(4, np.float32))})
        rec.append(outcome(reg.release, "m2"))  # published, never acquired
        reg.unpublish("m2")  # the publisher-side teardown path
        rec.append(outcome(reg.acquire, "m2"))
        assert rec[1][0] == "ValueError" and "no outstanding" in rec[1][1]
        assert rec[2][0] == "KeyError"
        return rec

    both(script)


def test_unpublish_refuses_while_shared():
    def script(s):
        reg = s.rt.WeightsRegistry()
        reg.publish("m", {"w": s.array(np.zeros(4, np.float32))})
        reg.acquire("m")
        rec = [outcome(reg.unpublish, "m")]
        assert rec[0][0] == "ValueError" and "live" in rec[0][1]
        return rec

    both(script)


def test_paging_skips_shared_leaves():
    """A tenant whose STATE references a shared set must not evict it:
    page-in would rebuild a private copy and break the dedup."""
    def script(s):
        reg = s.rt.WeightsRegistry()
        shared = {"w": s.array(np.ones((64, 64), np.float32))}
        reg.publish("m", shared)
        acquired = reg.acquire("m")
        private = s.array(np.zeros((32, 32), np.float32))
        part = s.rt.Partition("p", source=s.backend())
        job = part.add_job(s.rt.Job(
            "t", step_fn=lambda st: st,
            state={"shared": acquired, "mine": private}, max_steps=100))
        part.sleep_job(job)
        freed = s.rt.page_out_job(part, job)
        assert freed == 32 * 32 * 4  # only the private leaf left
        # the guarantee is LEAF identity: the shared tensor is never
        # evicted or copied
        assert job.state["shared"]["w"] is acquired["w"]
        part.wake_job(job)
        assert job.state["shared"]["w"] is acquired["w"]
        mine = s.to_numpy(job.state["mine"])
        reg.release("m")
        return [freed, mine.tolist(),
                [ln["line"] for ln in job.console.read()["lines"]]]

    both(script)


def test_paging_account_roundtrip_does_not_inflate():
    """Admitted at a declared mem_bytes SMALLER than the device state:
    page-out/wake cycles restore the account to exactly its pre-paging
    balance."""
    def script(s):
        mem = s.rt.MemoryManager(capacity_bytes=1 << 20)
        part = s.rt.Partition("p", source=s.backend(), memory=mem)
        state = s.array(np.zeros((128, 128), np.float32))  # 64KB
        job = part.add_job(s.rt.Job("t", step_fn=lambda st: st, state=state,
                                    mem_bytes=16 * 1024, max_steps=100))
        rec = [mem.dump()]
        for _ in range(3):  # repeated cycles must be idempotent
            part.sleep_job(job)
            s.rt.page_out_job(part, job)
            assert mem.account("t").used_bytes == 0
            rec.append((job.paged_bytes, job.paged_acct_bytes, mem.dump()))
            part.wake_job(job)
            assert mem.account("t").used_bytes == 16 * 1024
            rec.append(mem.dump())
        return rec

    both(script)


def test_balloon_reasks_chunked_reclaimer():
    def script(s):
        mem = s.rt.MemoryManager(capacity_bytes=1 << 20)
        mem.open_account("cachey")
        mem.claim("cachey", 900 * 1024)
        calls = []

        def chunky(need):
            calls.append(need)
            return 100 * 1024  # 100KB per ask

        mem.register_reclaim("cachey", chunky)
        mem.open_account("newbie")
        mem.claim_or_balloon("newbie", 300 * 1024)  # needs ~3 chunks
        assert len(calls) >= 2
        assert mem.account("newbie").used_bytes == 300 * 1024
        return [calls, mem.dump()]

    both(script)


def test_publish_fails_cleanly_when_over_capacity():
    def script(s):
        mem = s.rt.MemoryManager(capacity_bytes=1024)
        reg = s.rt.WeightsRegistry(memory=mem)
        rec = [outcome(reg.publish, "big",
                       {"w": s.array(np.zeros((256, 256), np.float32))}),
               mem.dump()]
        assert rec[0][0] == "OutOfDeviceMemory"
        # unwound: the account is gone, the name retryable
        reg2 = s.rt.WeightsRegistry(
            memory=s.rt.MemoryManager(capacity_bytes=1 << 20))
        sw = reg2.publish("big", {"w": s.array(np.zeros((16, 16),
                                                         np.float32))})
        return rec + [sw.nbytes, reg2.dump(), reg2.memory.dump()]

    both(script)


def test_console_lines_of_a_contained_fault():
    """The partition's console lines (admitted, FAULT contained,
    destroyed) word for word, under a step that raises."""
    def script(s):
        part = s.rt.Partition("p", source=s.backend())

        def bad(state):
            raise RuntimeError("device on fire")

        job = part.add_job(s.rt.Job("burny", step_fn=bad, state=0,
                                    max_steps=5))
        job.log("hello from the guest")
        part.run(max_rounds=3)
        part.remove_job(job)
        return [ln["line"] for ln in job.console.read()["lines"]]

    lines = both(script)
    assert lines == ["admitted to p (1 ctx, scheduler credit)",
                     "hello from the guest",
                     "FAULT contained: RuntimeError: device on fire",
                     "destroyed"]
