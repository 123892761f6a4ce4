"""The port's speculative decoding and speculative serving against
``pbs_tpu``'s.

Twins of ``tests/test_spec_serving.py`` (the speculative engine is
token-identical to the plain engine, in fewer ticks) and of
``tests/test_speculative.py`` (lockstep and per-row generators are
token-exact against the target's own greedy decode). Weights are the
JAX package's ``init_params`` trees (fp32) carried across by
``params_from_numpy``; the drafts are the reference tests' own (a
noisy copy of the target's head, or a smaller model). Every greedy
output is also held against the reference's, and every counter
(rounds, proposed, accepted, reverified, engine ticks, acceptance)
must be equal. The MoE cases run an MoE target and draft through the
``mlp_fn``/``draft_mlp_fn`` seams and a ``target_fwd`` closure. The mesh
cases wait for their ROADMAP item.
"""

from __future__ import annotations

import math

import numpy as np
import pytest

jax = pytest.importorskip("jax", reason="parity tests need the JAX reference")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from pbs_tpu import models as ref  # noqa: E402
from pbs_tpu.models import speculative as ref_spec  # noqa: E402
from pbs_tpu_torch import models as port  # noqa: E402
from pbs_tpu_torch.models import speculative as port_spec  # noqa: E402

# The suite runs in parallel worker processes: uncapped, torch's intra-op
# pool takes every core in each of them and oversubscribes the host.
torch.set_num_threads(2)


def _cfgs(**fields):
    return (ref.TransformerConfig(**fields, dtype=jnp.float32),
            port.TransformerConfig(**fields, dtype=torch.float32))


def _cross(jparams):
    return port.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


def _noisy_head(jparams, scale):
    """The reference tests' draft: the target with seeded Gaussian noise
    (``PRNGKey(7)``) on its head."""
    noise = jax.random.normal(jax.random.PRNGKey(7), jparams["head"].shape,
                              jparams["head"].dtype)
    return dict(jparams, head=jparams["head"] + scale * noise)


# -- speculative serving (tests/test_spec_serving.py) ------------------------

SERVE = dict(vocab=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
             d_ff=128, max_seq=128)
PROMPTS = [[1, 2, 3], [9, 8, 7, 6], [4, 4], [11, 12, 13]]


@pytest.fixture(scope="module")
def serve_models():
    jcfg, tcfg = _cfgs(**SERVE)
    jparams = ref.init_params(jcfg, jax.random.PRNGKey(0))
    jdraft = _noisy_head(jparams, 0.01)
    return jcfg, tcfg, jparams, jdraft, _cross(jparams), _cross(jdraft)


def drain(eng, max_ticks=300):
    got = {}
    for _ in range(max_ticks):
        for c in eng.step():
            got[c.request_id] = c.tokens
        if not eng.has_work():
            break
    assert not eng.has_work(), "engine did not drain"
    return got


class FakeClock:
    """Seconds that advance a fixed step on every read."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        self.t += 0.125
        return self.t


def _plain(m, **kw):
    jcfg, tcfg, jp, _, tp, _ = m
    return (ref.ContinuousBatcher(jcfg, jp, clock=FakeClock(), **kw),
            port.ContinuousBatcher(tcfg, tp, clock=FakeClock(),
                                   device="cpu", **kw))


def _spec(m, self_draft=False, **kw):
    """(reference, port) speculative engines, each on its own fake
    clock, so their stats() are equal key for key."""
    jcfg, tcfg, jp, jd, tp, td = m
    return (ref.SpeculativeBatcher(jcfg, jp, jcfg, jp if self_draft else jd,
                                   clock=FakeClock(), **kw),
            port.SpeculativeBatcher(tcfg, tp, tcfg, tp if self_draft else td,
                                    clock=FakeClock(), device="cpu", **kw))


def test_spec_serving_token_exact_and_fewer_ticks(serve_models):
    kw = dict(n_slots=2, prompt_bucket=8, max_len=64)
    plain = _plain(serve_models, **kw)[1]
    specs = _spec(serve_models, k=3, **kw)
    outs = []
    for eng in (plain,) + specs:
        for p in PROMPTS:
            eng.submit(p, max_new_tokens=10)
        outs.append(drain(eng))
    assert outs[2] == outs[1] == outs[0]  # request by request
    st = specs[1].stats()
    assert st == specs[0].stats()  # ticks, proposals, acceptance
    assert st["steps"] < plain.stats()["steps"]
    assert st["spec_acceptance"] > 0.5
    assert 0 <= st["spec_accepted"] <= st["spec_proposed"]


def test_spec_serving_with_prefix_cache_token_exact(serve_models):
    runs = []
    for eng in _spec(serve_models, k=3, n_slots=2, prompt_bucket=8,
                     max_len=64, prefix_cache_size=4):
        toks = []
        for _ in range(2):
            rid = eng.submit([1, 2, 3], max_new_tokens=8)
            out = []
            while not out:
                out = [c for c in eng.step() if c.request_id == rid]
            toks.append(out[0].tokens)
        assert toks[1] == toks[0]
        assert eng.prefill_count == 1 and eng.prefix_hits == 1
        runs.append(toks)
    assert runs[1] == runs[0]


def test_spec_serving_eos_truncation_matches_plain(serve_models):
    kw = dict(n_slots=2, prompt_bucket=8, max_len=64)
    probe = _plain(serve_models, **kw)[1]
    for p in PROMPTS:
        probe.submit(p, max_new_tokens=10)
    eos = next(t[2] for t in drain(probe).values() if len(t) > 2)
    outs = []
    for eng in (_plain(serve_models, eos_id=eos, **kw)[1],
                *_spec(serve_models, k=3, eos_id=eos, **kw)):
        for p in PROMPTS:
            eng.submit(p, max_new_tokens=10)
        outs.append(drain(eng))
    assert outs[2] == outs[1] == outs[0]


def test_spec_serving_truncates_at_the_slab_end(serve_models):
    """plen + max_new + k + 1 == max_len, and budgets that end
    mid-window: the verify writes reach the slab's last positions."""
    kw = dict(n_slots=2, prompt_bucket=8, max_len=24)
    reqs = [([5, 6, 7, 8, 9, 10, 11, 12], 12), ([3, 4], 18), ([1], 9)]
    outs = []
    for eng in (_plain(serve_models, **kw)[1],
                *_spec(serve_models, k=3, **kw)):
        for p, n in reqs:
            eng.submit(p, max_new_tokens=n)
        outs.append(drain(eng))
    assert outs[2] == outs[1] == outs[0]
    assert [len(outs[2][i]) for i in range(3)] == [12, 18, 9]


def test_spec_serving_self_draft_max_speedup(serve_models):
    for spec in _spec(serve_models, self_draft=True, k=3, n_slots=1,
                      prompt_bucket=8, max_len=64):
        spec.submit([1, 2, 3], max_new_tokens=9)
        drain(spec)
        st = spec.stats()
        assert st["spec_acceptance"] == 1.0
        # 1 admit tick samples token 1; 8 more tokens / (k+1)=4 -> 2
        # ticks; +1 final retire-check tick.
        assert st["steps"] <= 4


def test_spec_serving_guards(serve_models):
    _, tcfg, _, _, tp, td = serve_models
    with pytest.raises(ValueError, match="greedy-only"):
        port.SpeculativeBatcher(tcfg, tp, tcfg, td, temperature=0.7,
                                prompt_bucket=8, max_len=64, device="cpu")
    with pytest.raises(ValueError, match="k must be"):
        port.SpeculativeBatcher(tcfg, tp, tcfg, td, k=0, prompt_bucket=8,
                                max_len=64, device="cpu")
    other = port.TransformerConfig(**{**SERVE, "vocab": 64},
                                   dtype=torch.float32)
    with pytest.raises(ValueError, match="vocab"):
        port.SpeculativeBatcher(tcfg, tp, other, td, prompt_bucket=8,
                                max_len=64, device="cpu")
    spec = port.SpeculativeBatcher(tcfg, tp, tcfg, td, k=3, prompt_bucket=8,
                                   max_len=32, device="cpu")
    with pytest.raises(ValueError, match="overshoot"):
        spec.submit([1, 2, 3], max_new_tokens=29)  # 3+29+4 > 32
    meta = {"embed": torch.empty(4, 4, device="meta")}
    with pytest.raises(ValueError, match="draft_params"):
        port.SpeculativeBatcher(tcfg, tp, tcfg, meta, prompt_bucket=8,
                                max_len=64, device="cpu")


def test_spec_serving_int8_target(serve_models):
    """A big int8 target + an fp draft: exact vs the plain engine on the
    SAME quantized target, and vs the reference's plain engine on it."""
    jcfg, tcfg, jp, _, tp, td = serve_models
    jq = ref.quantize_weights(jp)
    tq = port.quantize_weights(tp)
    kw = dict(n_slots=2, prompt_bucket=8, max_len=64)
    outs = []
    for eng in (ref.ContinuousBatcher(jcfg, jq, **kw),
                port.ContinuousBatcher(tcfg, tq, device="cpu", **kw),
                port.SpeculativeBatcher(tcfg, tq, tcfg, td, k=3,
                                        device="cpu", **kw)):
        for p in PROMPTS:
            eng.submit(p, max_new_tokens=8)
        outs.append(drain(eng))
    assert outs[2] == outs[1] == outs[0]


@pytest.mark.parametrize("seed", [11, 23])
def test_spec_serving_randomized_exactness(serve_models, seed):
    """Seeded fuzz: random prompts, budgets, submission timing and an EOS
    drawn from the vocab — the port's spec engine, its plain engine and
    the reference's spec engine agree request for request."""
    rng = np.random.default_rng(seed)
    reqs = [(list(rng.integers(1, SERVE["vocab"], rng.integers(1, 8))),
             int(rng.integers(1, 12))) for _ in range(7)]
    eos = int(rng.integers(1, SERVE["vocab"]))
    kw = dict(n_slots=2, prompt_bucket=8, max_len=64, eos_id=eos)
    outs, stats = [], []
    for eng in (_plain(serve_models, **kw)[1],
                *_spec(serve_models, k=3, **kw)):
        got, pending, ticks = {}, list(reqs), 0
        while (pending or eng.has_work()) and ticks < 400:
            # staggered arrivals: a request lands every other tick
            if pending and ticks % 2 == 0:
                p, n = pending.pop(0)
                eng.submit(p, max_new_tokens=n)
            for c in eng.step():
                got[c.request_id] = c.tokens
            ticks += 1
        assert not pending and not eng.has_work()
        outs.append(got)
        stats.append(eng.stats())
    assert outs[2] == outs[1] == outs[0]
    assert stats[2] == stats[1]


# -- speculative generation (tests/test_speculative.py) ----------------------

TGT = dict(vocab=128, d_model=64, n_layers=3, n_heads=4, n_kv_heads=2,
           d_ff=128, max_seq=256)
DFT = dict(vocab=128, d_model=32, n_layers=1, n_heads=2, n_kv_heads=2,
           d_ff=64, max_seq=256)
MAX_NEW = 12
K = 3


@pytest.fixture(scope="module")
def gen_models():
    jcfg, tcfg = _cfgs(**TGT)
    jdcfg, tdcfg = _cfgs(**DFT)
    jp = ref.init_params(jcfg, jax.random.PRNGKey(0))
    jd = ref.init_params(jdcfg, jax.random.PRNGKey(1))
    return (jcfg, jdcfg, jp, jd), (tcfg, tdcfg, _cross(jp), _cross(jd))


def _prompt(key, batch):
    return np.array(jax.random.randint(jax.random.PRNGKey(key), (batch, 16),
                                       0, 128, jnp.int32))


def _ref_greedy(jcfg, jp, prompt):
    return np.asarray(jax.jit(ref.make_generate(jcfg, MAX_NEW))(
        jp, jnp.asarray(prompt), jax.random.PRNGKey(9)))


def _stats(stats):
    return {k: int(v) for k, v in stats.items()}


def test_speculative_token_exact(gen_models):
    (jcfg, jdcfg, jp, jd), (tcfg, tdcfg, tp, td) = gen_models
    prompt = _prompt(2, 2)
    want, wstats = jax.jit(ref_spec.make_speculative_generate(
        jcfg, jdcfg, MAX_NEW, k=K))(jp, jd, jnp.asarray(prompt))
    toks, stats = port_spec.make_speculative_generate(
        tcfg, tdcfg, MAX_NEW, k=K)(tp, td, torch.from_numpy(prompt))
    np.testing.assert_array_equal(toks.numpy(), np.asarray(want))
    np.testing.assert_array_equal(toks.numpy(),
                                  _ref_greedy(jcfg, jp, prompt))
    assert stats == _stats(wstats)
    assert stats["proposed"] == K * stats["rounds"]
    assert 0 <= stats["accepted"] <= stats["proposed"]


def test_speculative_self_draft_accepts_everything(gen_models):
    (jcfg, _, jp, _), (tcfg, _, tp, _) = gen_models
    prompt = _prompt(2, 2)
    toks, stats = port_spec.make_speculative_generate(
        tcfg, tcfg, MAX_NEW, k=K)(tp, tp, torch.from_numpy(prompt))
    np.testing.assert_array_equal(toks.numpy(), _ref_greedy(jcfg, jp, prompt))
    assert stats["accepted"] == stats["proposed"]
    rounds = stats["rounds"]
    assert 1 + (rounds - 1) * (K + 1) < MAX_NEW <= 1 + rounds * (K + 1)


def test_speculative_serve_job_telemetry(gen_models):
    """The spec-decode serving tenant under the port's scheduler: TOKENS
    and SPEC_PROPOSED land in the ledger."""
    from pbs_tpu_torch.runtime import Job, Partition, SchedParams
    from pbs_tpu_torch.telemetry import Counter, CudaBackend

    _, (tcfg, tdcfg, tp, td) = gen_models
    prompt = torch.from_numpy(_prompt(2, 2))
    serve_step = port_spec.make_speculative_serve_step(tcfg, tdcfg, MAX_NEW,
                                                       k=K)
    part = Partition("spec", source=CudaBackend(device="cpu"),
                     scheduler="credit")
    job = part.add_job(Job(
        "spec_serve", step_fn=lambda s: serve_step(s, prompt),
        state=(tp, td, 0), params=SchedParams(weight=256), max_steps=3))
    part.run()
    ctr = job.contexts[0].counters
    assert job.state[2] == 3
    assert int(ctr[Counter.TOKENS]) == 3 * prompt.shape[0] * MAX_NEW
    assert int(ctr[Counter.SPEC_PROPOSED]) > 0
    eff = int(ctr[Counter.TOKENS]) / int(ctr[Counter.SPEC_PROPOSED])
    assert 0 < eff <= (K + 1) / K + 1e-6


def test_per_row_token_exact_batch4(gen_models):
    (jcfg, jdcfg, jp, jd), (tcfg, tdcfg, tp, td) = gen_models
    prompt = _prompt(5, 4)
    want, wstats = jax.jit(ref_spec.make_per_row_speculative_generate(
        jcfg, jdcfg, MAX_NEW, k=K))(jp, jd, jnp.asarray(prompt))
    toks, stats = port_spec.make_per_row_speculative_generate(
        tcfg, tdcfg, MAX_NEW, k=K)(tp, td, torch.from_numpy(prompt))
    np.testing.assert_array_equal(toks.numpy(), np.asarray(want))
    np.testing.assert_array_equal(toks.numpy(),
                                  _ref_greedy(jcfg, jp, prompt))
    assert stats == _stats(wstats)
    assert stats["reverified"] == 0  # structurally none


def test_per_row_beats_lockstep_reverification(gen_models):
    """With a noisy copy of the target as the draft (the reference
    test's 0.02 scale), rows diverge in how far they verify: lockstep
    re-verifies, per-row does not and needs no more rounds."""
    (jcfg, _, jp, _), (tcfg, _, tp, _) = gen_models
    jd = _noisy_head(jp, 0.02)
    td = _cross(jd)
    prompt = torch.from_numpy(_prompt(5, 4))
    t_lock, s_lock = port_spec.make_speculative_generate(
        tcfg, tcfg, MAX_NEW, k=K)(tp, td, prompt)
    t_row, s_row = port_spec.make_per_row_speculative_generate(
        tcfg, tcfg, MAX_NEW, k=K)(tp, td, prompt)
    np.testing.assert_array_equal(t_lock.numpy(), t_row.numpy())
    _, w_lock = jax.jit(ref_spec.make_speculative_generate(
        jcfg, jcfg, MAX_NEW, k=K))(jp, jd, jnp.asarray(prompt.numpy()))
    assert s_lock == _stats(w_lock)
    assert s_lock["reverified"] > 0
    assert s_row["reverified"] == 0
    assert s_row["rounds"] <= s_lock["rounds"]


def test_per_row_self_draft_min_rounds(gen_models):
    (jcfg, _, jp, _), (tcfg, _, tp, _) = gen_models
    prompt = _prompt(2, 2)
    toks, stats = port_spec.make_per_row_speculative_generate(
        tcfg, tcfg, MAX_NEW, k=K)(tp, tp, torch.from_numpy(prompt))
    np.testing.assert_array_equal(toks.numpy(), _ref_greedy(jcfg, jp, prompt))
    assert stats["accepted"] == stats["proposed"]
    assert stats["rounds"] == math.ceil((MAX_NEW - 1) / (K + 1))


def test_greedy_accept_window_matches_reference():
    rng = np.random.default_rng(3)
    t = rng.integers(0, 4, (16, 3)).astype(np.int32)
    g = rng.integers(0, 4, (16, 4)).astype(np.int32)
    g[:8, :3] = t[:8]  # some rows accept everything
    want = ref_spec.greedy_accept_window(jnp.asarray(t), jnp.asarray(g))
    got = port_spec.greedy_accept_window(torch.from_numpy(t),
                                         torch.from_numpy(g))
    for w, x in zip(want, got):
        assert x.dtype == torch.int32
        np.testing.assert_array_equal(x.numpy(), np.asarray(w))


def test_speculative_rejects_bad_args(gen_models):
    _, (tcfg, tdcfg, _, _) = gen_models
    for make in (port_spec.make_speculative_generate,
                 port_spec.make_per_row_speculative_generate):
        with pytest.raises(ValueError, match="k must"):
            make(tcfg, tdcfg, 8, k=0)
        with pytest.raises(ValueError, match="max_new_tokens"):
            make(tcfg, tdcfg, 0)
        with pytest.raises(ValueError, match="vocab"):
            make(tcfg, port.TransformerConfig(**{**DFT, "vocab": 64},
                                              dtype=torch.float32), 8)


# -- MoE targets and drafts (tests/test_spec_serving.py's MoE cases) ---------

MOE = dict(vocab=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
           d_ff=96, max_seq=128, n_experts=4, top_k=2)


def _moe(seed, **over):
    """(reference cfg, port cfg, JAX params, port params) of an MoE
    model at MOE's widths."""
    from pbs_tpu.models import moe as ref_moe
    from pbs_tpu_torch.models import moe as port_moe

    jcfg = ref_moe.MoEConfig(**MOE, **over, dtype=jnp.float32)
    tcfg = port_moe.MoEConfig(**MOE, **over, dtype=torch.float32)
    jp = ref_moe.init_moe_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tcfg, jp, _cross(jp)


def test_moe_speculative_serving_token_exact(serve_models):
    """An MoE target (capacity 4.0, which drops nothing here) with the
    dense draft, and an MoE noisy-head draft beside it: each speculative
    engine is token-exact against the plain MoE engine, and the port's
    completions and stats() equal the reference's."""
    from pbs_tpu.models.moe import moe_slot_mlp as ref_mlp
    from pbs_tpu_torch.models.moe import moe_slot_mlp as port_mlp

    jcfg, tcfg, jp, tp = _moe(0, capacity_factor=4.0)
    jd_moe = _noisy_head(jp, 0.01)
    dense = (serve_models[0], serve_models[1], serve_models[2],
             serve_models[4])  # jcfg, tcfg, JAX and port params
    kw = dict(n_slots=2, prompt_bucket=8, max_len=64)
    plain = port.ContinuousBatcher(tcfg, tp, mlp_fn=port_mlp(tcfg),
                                   device="cpu", **kw)
    for p in PROMPTS:
        plain.submit(p, max_new_tokens=8)
    want = drain(plain)
    for djcfg, dtcfg, djp, dtp, moe_draft in (
            dense + (False,), (jcfg, tcfg, jd_moe, _cross(jd_moe), True)):
        extra = ({"draft_mlp_fn": ref_mlp(djcfg)} if moe_draft else {},
                 {"draft_mlp_fn": port_mlp(dtcfg)} if moe_draft else {})
        engines = (ref.SpeculativeBatcher(jcfg, jp, djcfg, djp, k=3,
                                          mlp_fn=ref_mlp(jcfg),
                                          clock=FakeClock(), **extra[0],
                                          **kw),
                   port.SpeculativeBatcher(tcfg, tp, dtcfg, dtp, k=3,
                                           mlp_fn=port_mlp(tcfg),
                                           clock=FakeClock(), device="cpu",
                                           **extra[1], **kw))
        got = []
        for eng in engines:
            for p in PROMPTS:
                eng.submit(p, max_new_tokens=8)
            got.append(drain(eng))
        assert got[1] == got[0] == want, moe_draft
        assert engines[1].stats() == engines[0].stats()
        assert engines[1].stats()["mlp_extra_mean"] == 0.0


def test_moe_drop_telemetry_surfaces(serve_models):
    """A capacity-starved MoE draft: the draft's drop telemetry rises
    (> 0.1) and equals the reference engine's; the dense target's own
    mlp_extra_mean stays 0.0."""
    from pbs_tpu.models.moe import moe_slot_mlp as ref_mlp
    from pbs_tpu_torch.models.moe import moe_slot_mlp as port_mlp

    jcfg, tcfg, jp, _, tp, _ = serve_models
    djcfg, dtcfg, djp, dtp = _moe(1, capacity_factor=0.3)
    kw = dict(k=3, n_slots=2, prompt_bucket=8, max_len=64)
    engines = (ref.SpeculativeBatcher(jcfg, jp, djcfg, djp,
                                      draft_mlp_fn=ref_mlp(djcfg),
                                      clock=FakeClock(), **kw),
               port.SpeculativeBatcher(tcfg, tp, dtcfg, dtp,
                                       draft_mlp_fn=port_mlp(dtcfg),
                                       clock=FakeClock(), device="cpu",
                                       **kw))
    got = []
    for eng in engines:
        for p in PROMPTS[:2]:
            eng.submit(p, max_new_tokens=8)
        got.append(drain(eng))
    assert got[1] == got[0]
    want, st = engines[0].stats(), engines[1].stats()
    assert st["draft_mlp_extra_mean"] > 0.1, st
    np.testing.assert_allclose(st["draft_mlp_extra_mean"],
                               want["draft_mlp_extra_mean"], rtol=0,
                               atol=1e-6)
    assert st["mlp_extra_mean"] == want["mlp_extra_mean"] == 0.0


def test_moe_lockstep_speculation_with_target_fwd():
    """make_speculative_generate with an MoE target through
    ``target_fwd`` (dropless: routing per token) and a dense draft:
    token-exact against the reference's and against the port's own
    make_moe_generate, with equal round statistics."""
    from pbs_tpu.models.moe import moe_forward_with_cache as ref_fwd
    from pbs_tpu_torch.models.moe import (make_moe_generate,
                                          moe_forward_with_cache)

    jcfg, tcfg, jp, tp = _moe(0, dropless=True)
    jdcfg, tdcfg = _cfgs(**DFT)
    jd = ref.init_params(jdcfg, jax.random.PRNGKey(1))
    prompt = _prompt(2, 2)
    want, wstats = jax.jit(ref_spec.make_speculative_generate(
        jcfg, jdcfg, MAX_NEW, k=K,
        target_fwd=lambda p, t, c: ref_fwd(jcfg, p, t, c)))(
        jp, jd, jnp.asarray(prompt))
    toks, stats = port_spec.make_speculative_generate(
        tcfg, tdcfg, MAX_NEW, k=K,
        target_fwd=lambda p, t, c: moe_forward_with_cache(tcfg, p, t, c))(
        tp, _cross(jd), torch.from_numpy(prompt))
    np.testing.assert_array_equal(toks.numpy(), np.asarray(want))
    greedy, _ = make_moe_generate(tcfg, MAX_NEW)(tp, torch.from_numpy(prompt))
    np.testing.assert_array_equal(toks.numpy(), greedy.numpy())
    assert stats == _stats(wstats)
