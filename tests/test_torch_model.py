"""The port's transformer forward and KV-cache serving against ``pbs_tpu``.

Weights are the JAX package's own ``init_params`` tree at
``_flagship_cfg(tiny=True)`` (fp32), carried across as numpy arrays by
``params_from_numpy``; token inputs are drawn with numpy from a seed.
Logits agree within rtol 1e-4 (two frameworks' fp32 reductions, through
two layers and a softmax), on the dense ("xla") path and on the flash
path ("pallas": Pallas interpret mode there, the kernel's plain version
here). Greedy generation is token-exact, on the shapes of
``tests/test_generate.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax", reason="parity tests need the JAX reference")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from __graft_entry__ import _flagship_cfg  # noqa: E402
from pbs_tpu import models as ref  # noqa: E402
from pbs_tpu_torch import models as port  # noqa: E402

# The suite runs in parallel worker processes: uncapped, torch's intra-op
# pool takes every core in each of them and oversubscribes the host.
torch.set_num_threads(2)

RTOL = 1e-4
ATOL = 1e-4


@pytest.fixture(scope="module")
def tiny():
    jcfg = _flagship_cfg(tiny=True)
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    tcfg = port.TransformerConfig(**fields, dtype=torch.float32)
    jparams = ref.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, tcfg, jparams, tree, port.params_from_numpy(tree, "cpu")


def _tokens(shape, seed, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def test_params_cross_unchanged(tiny):
    jcfg, tcfg, _, tree, tparams = tiny
    assert set(tparams) == set(tree) == {"embed", "layers", "final_norm",
                                         "head"}
    assert set(tparams["layers"]) == set(tree["layers"])
    for name, w in tree["layers"].items():
        t = tparams["layers"][name]
        assert t.shape[0] == jcfg.n_layers and t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), w)
    assert tcfg.num_params() == jcfg.num_params()
    cast = port.params_from_numpy(tree, "cpu", dtype=torch.bfloat16)
    assert cast["head"].dtype == torch.bfloat16
    # casting once at load is bit-equal to the per-call cast
    assert torch.equal(cast["head"], tparams["head"].to(torch.bfloat16))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_forward_logits_match(tiny, impl):
    jcfg, tcfg, jparams, _, tparams = tiny
    toks = _tokens((2, 16), 1, jcfg.vocab)
    want = np.asarray(ref.forward(dataclasses.replace(jcfg, attn_impl=impl),
                                  jparams, jnp.asarray(toks)))
    got = port.forward(dataclasses.replace(tcfg, attn_impl=impl), tparams,
                       torch.from_numpy(toks))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_unported_attention_impls_are_loud(tiny):
    _, tcfg, _, _, tparams = tiny
    toks = torch.zeros((1, 4), dtype=torch.int32)
    for impl in ("ring", "ulysses", "bogus"):
        with pytest.raises(ValueError):
            port.forward(dataclasses.replace(tcfg, attn_impl=impl), tparams,
                         toks)


def test_cached_forward_matches_reference(tiny):
    jcfg, tcfg, jparams, _, tparams = tiny
    toks = _tokens((2, 16), 2, jcfg.vocab)
    want, jcache = ref.forward_with_cache(
        jcfg, jparams, jnp.asarray(toks), ref.init_cache(jcfg, 2, max_len=32))
    got, cache = port.forward_with_cache(
        tcfg, tparams, torch.from_numpy(toks),
        port.init_cache(tcfg, 2, max_len=32, device="cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    assert cache["pos"] == int(jcache["pos"]) == 16
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]),
                               rtol=RTOL, atol=ATOL)


def test_incremental_decode_matches_prefill(tiny):
    _, tcfg, _, _, tparams = tiny
    toks = torch.from_numpy(_tokens((1, 8), 3, tcfg.vocab))
    whole, _ = port.forward_with_cache(
        tcfg, tparams, toks, port.init_cache(tcfg, 1, 8, device="cpu"))
    cache = port.init_cache(tcfg, 1, 8, device="cpu")
    steps = []
    for i in range(8):
        lg, cache = port.forward_with_cache(tcfg, tparams, toks[:, i:i + 1],
                                            cache)
        steps.append(lg[:, 0])
    np.testing.assert_allclose(whole.numpy(), torch.stack(steps, 1).numpy(),
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("B,P,new", [(2, 5, 6), (1, 4, 5)])
def test_greedy_generate_is_token_exact(tiny, B, P, new):
    jcfg, tcfg, jparams, _, tparams = tiny
    prompt = _tokens((B, P), 10 + P, jcfg.vocab)
    want = np.asarray(jax.jit(ref.make_generate(jcfg, max_new_tokens=new))(
        jparams, jnp.asarray(prompt), jax.random.PRNGKey(7)))
    gen = port.make_generate(tcfg, max_new_tokens=new)
    got = gen(tparams, torch.from_numpy(prompt))
    assert got.dtype == torch.int32 and got.shape == (B, new)
    np.testing.assert_array_equal(got.numpy(), want)
    # greedy ignores the generator
    again = gen(tparams, torch.from_numpy(prompt),
                torch.Generator().manual_seed(123))
    np.testing.assert_array_equal(again.numpy(), want)


def test_serve_step_counts(tiny):
    """The serving loop is a Job step: it bumps the served counter and
    reports B x max_new tokens, greedy or sampled."""
    _, tcfg, _, _, tparams = tiny
    prompts = torch.zeros((2, 3), dtype=torch.int32)
    for temperature in (0.0, 1.0):
        serve = port.make_serve_step(tcfg, max_new_tokens=4,
                                     temperature=temperature)
        state = (tparams, torch.Generator().manual_seed(0), 0)
        state, metrics = serve(state, prompts)
        state, metrics = serve(state, prompts)
        assert state[2] == 2 and metrics == {"tokens": 2 * 4}


def test_sampling_is_seeded():
    logits = torch.from_numpy(
        np.random.default_rng(0).standard_normal((3, 50)).astype(np.float32))
    from pbs_tpu_torch.models.generate import _sample

    a = _sample(logits, torch.Generator().manual_seed(5), 1.0)
    b = _sample(logits, torch.Generator().manual_seed(5), 1.0)
    assert a.dtype == torch.int32 and torch.equal(a, b)
    assert torch.equal(_sample(logits, None, 0.0),
                       logits.argmax(-1).to(torch.int32))
