"""The port's continuous-batching engine against ``pbs_tpu``'s.

Twins of ``tests/test_serving.py``: each script runs through the port's
``ContinuousBatcher`` and through the reference engine on the same
weights (the JAX package's ``init_params`` tree, fp32, carried across by
``params_from_numpy``), and every ``Completion`` field must be equal.
A fake clock drives both engines, so ``stats()`` is equal key for key.
Greedy completions are also held against the port's lockstep
``make_generate``. ``_slot_forward`` logits agree within rtol = atol =
1e-4 (two frameworks' fp32 reductions), including at the slab's edge
where both clamp.

Beyond the twins: a prefix-cache entry survives its slot's reuse (the
slabs are updated in place), construction leaves a fresh engine's
state, and the port's engine runs behind the reference's
``gateway.backends.BatcherBackend`` exactly as the JAX engine does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax", reason="parity tests need the JAX reference")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from pbs_tpu import models as ref  # noqa: E402
from pbs_tpu.gateway.backends import BatcherBackend  # noqa: E402
from pbs_tpu.gateway.fairqueue import Request  # noqa: E402
from pbs_tpu.models import serving as ref_serving  # noqa: E402
from pbs_tpu_torch import models as port  # noqa: E402
from pbs_tpu_torch.models import serving as port_serving  # noqa: E402

# The suite runs in parallel worker processes: uncapped, torch's intra-op
# pool takes every core in each of them and oversubscribes the host.
torch.set_num_threads(2)

TINY = dict(vocab=64, d_model=32, n_layers=2, n_heads=2, n_kv_heads=2,
            d_ff=64, max_seq=128)
RTOL = ATOL = 1e-4


class FakeClock:
    """Seconds that advance a fixed step on every read."""

    def __init__(self, step: float = 0.125):
        self.t = 0.0
        self.step = step

    def __call__(self) -> float:
        self.t += self.step
        return self.t


@pytest.fixture(scope="module")
def model():
    jcfg = ref.TransformerConfig(**TINY, dtype=jnp.float32)
    tcfg = port.TransformerConfig(**TINY, dtype=torch.float32)
    jparams = ref.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, tcfg, jparams, port.params_from_numpy(tree, "cpu")


def _engines(model, **kw):
    """(reference engine, port engine) on the same weights and options,
    each with its own fake clock."""
    jcfg, tcfg, jparams, tparams = model
    return (ref.ContinuousBatcher(jcfg, jparams, clock=FakeClock(), **kw),
            port.ContinuousBatcher(tcfg, tparams, clock=FakeClock(),
                                   device="cpu", **kw))


def _drain(eng, max_ticks=500):
    out = []
    for _ in range(max_ticks):
        out += eng.step()
        if not eng.has_work():
            break
    assert not eng.has_work(), "engine did not drain"
    return {c.request_id: dataclasses.asdict(c) for c in out}


def _same(engines, script):
    """Run ``script(engine)`` (which returns a dict of completions) on
    both engines; every Completion field and every stats() key must be
    equal. Returns the port's completions."""
    want, got = (script(e) for e in engines)
    assert got == want
    assert engines[1].stats() == engines[0].stats()
    return got


def _gold(model, prompt, n_new):
    """The port's lockstep greedy generate on one prompt."""
    _, tcfg, _, tparams = model
    gen = port.make_generate(tcfg, n_new)
    out = gen(tparams, torch.tensor([prompt], dtype=torch.int32))
    return out[0].tolist()


def test_single_request_matches_lockstep_generate(model):
    prompt = [5, 9, 2, 31, 7]

    def script(eng):
        eng.submit(prompt, max_new_tokens=8)
        return _drain(eng)

    done = _same(_engines(model, n_slots=3, prompt_bucket=16), script)
    assert done[0]["tokens"] == _gold(model, prompt, 8)
    assert done[0]["prompt_len"] == 5


def test_concurrent_requests_isolated(model):
    prompts = [[3, 1, 4], [15, 9, 2, 6], [53, 5]]

    def script(eng):
        for p in prompts:
            eng.submit(p, max_new_tokens=6)
        return _drain(eng)

    done = _same(_engines(model, n_slots=3, prompt_bucket=16), script)
    for rid, p in enumerate(prompts):
        assert done[rid]["tokens"] == _gold(model, p, 6), rid


def test_staggered_admission_still_exact(model):
    def script(eng):
        eng.submit([7, 7, 7, 7], max_new_tokens=12)
        early = [c for _ in range(5) for c in eng.step()]
        assert early == []
        eng.submit([2, 30], max_new_tokens=4)
        return _drain(eng)

    done = _same(_engines(model, n_slots=2, prompt_bucket=16), script)
    assert done[0]["tokens"] == _gold(model, [7, 7, 7, 7], 12)
    assert done[1]["tokens"] == _gold(model, [2, 30], 4)


def test_late_request_overlaps_earlier_one(model):
    def script(eng):
        eng.submit([1, 2, 3], max_new_tokens=30)
        for _ in range(3):
            eng.step()
        eng.submit([4, 5], max_new_tokens=3)
        return _drain(eng)

    done = _same(_engines(model, n_slots=2, prompt_bucket=16), script)
    assert done[1]["steps_waited"] == 0  # admitted without queueing
    assert len(done[0]["tokens"]) == 30 and len(done[1]["tokens"]) == 3


def test_queueing_when_slots_full(model):
    def script(eng):
        eng.submit([9], max_new_tokens=4)
        eng.submit([8], max_new_tokens=4)
        return _drain(eng)

    done = _same(_engines(model, n_slots=1, prompt_bucket=16), script)
    assert done[1]["steps_waited"] > 0  # had to wait for the slot
    assert done[0]["tokens"] == _gold(model, [9], 4)
    assert done[1]["tokens"] == _gold(model, [8], 4)


def test_eos_retires_early(model):
    prompt = [5, 9, 2]
    gold = _gold(model, prompt, 10)
    eos = gold[3]  # force an early stop at a token we know arrives

    def script(eng):
        eng.submit(prompt, max_new_tokens=10)
        return _drain(eng)

    done = _same(_engines(model, n_slots=2, prompt_bucket=16, eos_id=eos),
                 script)
    assert done[0]["tokens"] == gold[:gold.index(eos) + 1]


def test_submit_validation(model):
    for eng in _engines(model, n_slots=1, prompt_bucket=8, max_len=32):
        with pytest.raises(ValueError, match="not in"):
            eng.submit(list(range(9)), max_new_tokens=2)  # over bucket
        with pytest.raises(ValueError, match="exceeds max_len"):
            eng.submit([1, 2], max_new_tokens=31)
        with pytest.raises(ValueError, match=">= 1"):
            eng.submit([1, 2], max_new_tokens=0)  # prefill would emit 1
        assert not eng.queue and eng.stats()["queued"] == 0


def test_slo_stats_populate(model):
    # the gateway seam: every submit reports (rid, plen, max_new)
    hooked = ([], [])
    engines = _engines(model, n_slots=2, prompt_bucket=16)
    for eng, h in zip(engines, hooked):
        eng.submit_hook = lambda rid, plen, mn, h=h: h.append((rid, plen, mn))

    def script(eng):
        for i in range(3):
            eng.submit([1 + i], max_new_tokens=3)
        return _drain(eng)

    done = _same(engines, script)
    st = engines[1].stats()
    assert st["completed"] == 3
    assert 0 < st["ttft_p50_s"] <= st["latency_p99_s"]
    for c in done.values():
        assert 0 < c["ttft_s"] <= c["latency_s"]
    assert hooked[1] == hooked[0] == [(rid, 1, 3) for rid in sorted(done)]
    eng = engines[1]
    assert eng._ttfts.maxlen == eng._latencies.maxlen == 1024


@pytest.mark.parametrize("values,q", [
    ([], 0.99), ([7.0], 0.50), ([2.0, 1.0], 0.50),
    (list(range(1, 101)), 0.50), (list(range(1, 101)), 0.99),
    ([0.3, 0.1, 0.2, 0.9], 0.25)])
def test_pct_is_nearest_rank(values, q):
    from pbs_tpu.utils import stats as ref_stats
    from pbs_tpu_torch.utils import stats as port_stats

    got = port.ContinuousBatcher._pct(values, q)
    assert got == ref.ContinuousBatcher._pct(values, q)
    assert type(got) is type(ref.ContinuousBatcher._pct(values, q))
    assert port_stats.nearest_rank(values, q) == \
        ref_stats.nearest_rank(values, q)


def test_job_shaped_serve_step(model):
    def feed(step):
        return [([3, 1], 3)] if step == 0 else []

    metrics = []
    for eng in _engines(model, n_slots=2, prompt_bucket=16):
        serve = (ref if isinstance(eng, ref.ContinuousBatcher)
                 else port).make_continuous_serve_step(eng, next_requests=feed)
        state = {"step": 0, "completed": 0}
        total = 0
        for _ in range(8):
            state, m = serve(state)
            total += int(m["tokens"])
        metrics.append((state, total, eng.stats()))
    assert metrics[1] == metrics[0]
    state, total, st = metrics[1]
    assert state["completed"] == 1 and st["tokens_emitted"] == 3
    assert total == 3  # the TOKENS metric is exact goodput


def _run_one(eng, prompt, max_new):
    rid = eng.submit(prompt, max_new_tokens=max_new)
    out = []
    while not out:
        out = [c for c in eng.step() if c.request_id == rid]
    return dataclasses.asdict(out[0])


def test_prefix_cache_token_exact_and_skips_prefill(model):
    def script(eng):
        t1 = _run_one(eng, [5, 7, 11], 4)
        assert eng.prefill_count == 1 and eng.prefix_hits == 0
        t2 = _run_one(eng, [5, 7, 11], 4)
        assert t2["tokens"] == t1["tokens"]
        assert eng.prefill_count == 1 and eng.prefix_hits == 1
        return {0: t1, 1: t2}

    _same(_engines(model, n_slots=2, prompt_bucket=8, max_len=32,
                   prefix_cache_size=4), script)


def test_prefix_cache_entry_survives_slot_reuse(model):
    """One slot: prompt A, then a different prompt B through the same
    slot, then A again from the prefix cache. The cached window must be
    a copy: a view of the slab would hold B's K/V by then."""
    a, b = [5, 7, 11, 2], [40, 41, 42, 43, 44, 45]

    def script(eng):
        first = _run_one(eng, a, 6)
        other = _run_one(eng, b, 6)
        again = _run_one(eng, a, 6)
        assert eng.prefix_hits == 1 and eng.prefill_count == 2
        return {0: first, 1: other, 2: again}

    done = _same(_engines(model, n_slots=1, prompt_bucket=8, max_len=32,
                          prefix_cache_size=4), script)
    assert done[2]["tokens"] == done[0]["tokens"] == _gold(model, a, 6)


def test_prefix_cache_lru_eviction(model):
    def script(eng):
        for prompt in ([1, 2], [3, 4], [1, 2]):  # [3, 4] evicts [1, 2]
            _run_one(eng, prompt, 2)
        assert eng.prefix_hits == 0 and eng.prefill_count == 3
        last = _run_one(eng, [1, 2], 2)  # now a hit
        assert eng.prefix_hits == 1 and eng.prefill_count == 3
        return {0: last}

    _same(_engines(model, n_slots=1, prompt_bucket=8, max_len=32,
                   prefix_cache_size=1), script)


def test_prefix_cache_off_by_default(model):
    def script(eng):
        out = {i: _run_one(eng, [1, 2], 2) for i in range(2)}
        assert eng.prefix_hits == 0 and eng.prefill_count == 2
        return out

    _same(_engines(model, n_slots=1, prompt_bucket=8, max_len=32), script)


def test_request_filling_the_slab_is_exact(model):
    """plen + max_new == max_len: the last decode writes the slab's last
    position."""
    prompt = [3, 14, 15, 9, 26, 5, 35, 8]

    def script(eng):
        eng.submit(prompt, max_new_tokens=24)
        eng.submit([2, 7], max_new_tokens=30)
        return _drain(eng)

    done = _same(_engines(model, n_slots=2, prompt_bucket=8, max_len=32),
                 script)
    assert done[0]["tokens"] == _gold(model, prompt, 24)
    assert done[1]["tokens"] == _gold(model, [2, 7], 30)


@pytest.mark.parametrize("row_pos", [[0, 5], [29, 30], [31, 2]])
def test_slot_forward_logits_match(model, row_pos):
    """Per-row cursors, S = 3, against a cache with history in it; the
    last two cases sit at the slab's end, where the write start clamps
    to T - S and the rope/mask positions to T - 1."""
    jcfg, tcfg, jparams, tparams = model
    rng = np.random.default_rng(sum(row_pos))
    T, S = 32, 3
    k0 = rng.standard_normal((2, 2, T, 2, 16)).astype(np.float32)
    v0 = rng.standard_normal((2, 2, T, 2, 16)).astype(np.float32)
    toks = rng.integers(0, 64, (2, S)).astype(np.int32)
    pos = np.asarray(row_pos, np.int32)
    want, wcache, wextra = ref_serving._slot_forward(
        jcfg, jparams, jnp.asarray(toks),
        {"k": jnp.asarray(k0), "v": jnp.asarray(v0),
         "pos": jnp.asarray(pos)}, jnp.asarray(pos))
    cache = {"k": torch.from_numpy(k0.copy()),
             "v": torch.from_numpy(v0.copy()),
             "pos": torch.from_numpy(pos.copy())}
    got, gcache, gextra = port_serving._slot_forward(
        tcfg, tparams, torch.from_numpy(toks), cache, torch.from_numpy(pos))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(gcache[name].numpy(),
                                   np.asarray(wcache[name]), rtol=RTOL,
                                   atol=ATOL)
    assert gcache["k"] is cache["k"]  # written in place
    assert float(gextra) == float(wextra) == 0.0


def test_mlp_fn_seam_and_its_extra(model):
    """A toy FFN through the ``mlp_fn`` seam, with a data-dependent
    auxiliary scalar: same tokens and the same mlp_extra_mean."""

    def ref_mlp(lp, h):
        y = jax.nn.relu(h @ lp["w1"]) @ lp["w2"]
        return y, jnp.mean(h * h)

    def port_mlp(lp, h):
        y = torch.relu(h @ lp["w1"]) @ lp["w2"]
        return y, torch.mean(h * h)

    jcfg, tcfg, jparams, tparams = model
    runs = []
    for eng in (ref.ContinuousBatcher(jcfg, jparams, n_slots=2,
                                      prompt_bucket=8, mlp_fn=ref_mlp),
                port.ContinuousBatcher(tcfg, tparams, n_slots=2,
                                       prompt_bucket=8, mlp_fn=port_mlp,
                                       device="cpu")):
        for p in ([1, 2, 3], [4, 5]):
            eng.submit(p, max_new_tokens=5)
        done = _drain(eng)
        runs.append(({r: c["tokens"] for r, c in done.items()},
                     eng.stats()["mlp_extra_mean"]))
    assert runs[1][0] == runs[0][0]
    assert runs[1][1] > 0
    np.testing.assert_allclose(runs[1][1], runs[0][1], rtol=1e-4)


@pytest.mark.parametrize("spec", [False, True])
def test_construction_leaves_a_fresh_engine(model, spec):
    """The warm-up runs each device function once and leaves no trace:
    cursors and slabs zero, every counter 0, the queue empty."""
    _, tcfg, _, tparams = model
    kw = dict(n_slots=3, prompt_bucket=8, max_len=32, prefix_cache_size=2,
              device="cpu")
    eng = (port.SpeculativeBatcher(tcfg, tparams, tcfg, tparams, k=2, **kw)
           if spec else port.ContinuousBatcher(tcfg, tparams, **kw))
    caches = [eng.cache] + ([eng.dcache] if spec else [])
    for cache in caches:
        assert all(int(t.abs().sum()) == 0 for t in cache.values())
        assert cache["pos"].dtype == torch.int32
    assert (eng.prefill_count, eng.prefix_hits, eng.prefix_misses,
            eng.tokens_emitted, eng.steps, eng.requests_completed) == \
        (0, 0, 0, 0, 0, 0)
    assert not eng.queue and not eng.active.any() and not eng._prefix_cache
    st = eng.stats()
    assert st["window"] == 0 and st["mlp_extra_mean"] == 0.0
    if spec:
        assert (eng.spec_proposed, eng.spec_accepted) == (0, 0)


def test_sampling_is_seeded_and_survives_the_warm_up(model):
    """temperature > 0: the stream is a function of ``seed`` alone (the
    warm-up's draws are undone), and differs across seeds."""
    _, tcfg, _, tparams = model

    def run(seed):
        eng = port.ContinuousBatcher(tcfg, tparams, n_slots=2,
                                     prompt_bucket=8, temperature=1.0,
                                     seed=seed, device="cpu")
        for p in ([1, 2, 3], [4, 5]):
            eng.submit(p, max_new_tokens=12)
        return {r: c["tokens"] for r, c in _drain(eng).items()}

    assert run(3) == run(3)
    assert run(3) != run(4)


def test_device_and_mesh_are_explicit(model):
    _, tcfg, _, tparams = model
    with pytest.raises(ValueError, match="items 7-8"):
        port.ContinuousBatcher(tcfg, tparams, mesh=object(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            port.ContinuousBatcher(tcfg, tparams)  # the card by default
    meta = {"layers": {}, "embed": torch.empty(4, 4, device="meta")}
    with pytest.raises(ValueError, match="meta"):
        port.ContinuousBatcher(tcfg, meta, device="cpu")


# -- behind the reference gateway's BatcherBackend ---------------------------


def _gateway_script(eng) -> dict:
    """Three gateway requests and one submission around the gateway,
    through ``BatcherBackend``: depth, polls, drain and bypass count."""
    be = BatcherBackend("b0", eng)
    reqs = [Request(rid=f"r{i}", tenant="t", slo="interactive", cost=1,
                    payload={"prompt": p, "max_new": n}, submit_ns=0)
            for i, (p, n) in enumerate((([1, 2, 3], 4), ([5, 6], 3),
                                        ([7], 5)))]
    for r in reqs[:2]:
        be.dispatch_request(r, now_ns=0)
    eng.submit([9, 9], 2)  # a bypass
    trace = [("depth", be.depth(), be.bypass_submits)]
    polls = []
    for tick in range(40):
        if tick == 2:
            be.dispatch_request(reqs[2], now_ns=tick)
        polls += [(r.rid, m) for r, m in be.poll(now_ns=tick)]
        trace.append(("depth", be.depth()))
    be.dispatch_request(reqs[0], now_ns=99)
    be.dispatch_request(reqs[1], now_ns=99)
    trace.append(("drained", [r.rid for r in be.drain()], be.depth()))
    return {"trace": trace, "polls": polls, "bypass": be.bypass_submits,
            "stats": eng.stats()}


def test_port_engine_behind_reference_batcher_backend(model):
    engines = _engines(model, n_slots=1, prompt_bucket=8, max_len=32)
    want, got = (_gateway_script(e) for e in engines)
    assert got == want
    assert got["bypass"] == 1
    assert sorted(rid for rid, _ in got["polls"]) == ["r0", "r1", "r2"]
    assert all(m["tokens"] in (3, 4, 5) for _, m in got["polls"])
