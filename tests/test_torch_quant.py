"""The port's int8 weight-only serving against ``pbs_tpu``'s.

Twins of ``tests/test_quant.py`` (accuracy, memory, the serving paths
consuming quantized trees unchanged), plus parity: ``quantize_weights``
is bitwise equal to the reference's on the same fp32 tree,
``quantized_nbytes`` counts the same bytes, quantized logits agree
within rtol = atol = 1e-4 and greedy output is token-exact. The MoE,
mesh and checkpoint-CLI cases wait for their ROADMAP items.
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax", reason="parity tests need the JAX reference")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from pbs_tpu import models as ref  # noqa: E402
from pbs_tpu.models import quant as ref_quant  # noqa: E402
from pbs_tpu_torch import models as port  # noqa: E402
from pbs_tpu_torch.models import quant as port_quant  # noqa: E402
from pbs_tpu_torch.models.transformer import layer_params  # noqa: E402

# The suite runs in parallel worker processes: uncapped, torch's intra-op
# pool takes every core in each of them and oversubscribes the host.
torch.set_num_threads(2)

FIELDS = dict(vocab=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
              d_ff=128, max_seq=128)
RTOL = ATOL = 1e-4


@pytest.fixture(scope="module")
def trees():
    jcfg = ref.TransformerConfig(**FIELDS, dtype=jnp.float32)
    tcfg = port.TransformerConfig(**FIELDS, dtype=torch.float32)
    jp = ref.init_params(jcfg, jax.random.PRNGKey(0))
    tp = port.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp, ref.quantize_weights(jp), \
        port.quantize_weights(tp)


def _prompt(key, shape):
    return np.array(jax.random.randint(jax.random.PRNGKey(key), shape, 0,
                                       FIELDS["vocab"], jnp.int32))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def test_quantize_weights_is_bitwise_the_reference(trees):
    *_, jq, tq = trees
    want = dict(_leaves(jax.tree.map(np.asarray, jq)))
    got = dict(_leaves(tq))
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert tq["layers"]["wq"]["q"].dtype == torch.int8
    assert not isinstance(tq["layers"]["attn_norm"], dict)


def test_quantize_leaf_rounds_half_to_even():
    """Ties land on even integers, as ``jnp.round`` puts them: a column
    whose max is 127 has scale 1, so w is q before rounding."""
    w = np.array([[127.0, 2.5], [-3.5, 0.5], [-0.5, 1.5]], np.float32)
    got = port_quant._quantize_leaf(torch.from_numpy(w))
    want = ref_quant._quantize_leaf(jnp.asarray(w))
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    assert got["q"][:, 0].tolist() == [127, -4, 0]


def test_quantized_nbytes_matches_reference(trees):
    *_, jp, tp, jq, tq = trees
    assert port.quantized_nbytes(tq) == ref.quantized_nbytes(jq)
    assert port.quantized_nbytes(tp) == ref.quantized_nbytes(jp)
    from pbs_tpu_torch.runtime import nbytes_of

    assert nbytes_of({"a": None, "b": 3, "c": [torch.ones(4, 2)]}) == 32


def test_quant_roundtrip_error_small(trees):
    *_, tp, _, tq = trees
    w = tp["layers"]["wq"]
    wq = port_quant.wload(tq["layers"]["wq"], torch.float32)
    rel = float((w - wq).abs().max()) / float(w.abs().max())
    assert rel < 0.02, rel  # int8 per-channel: <2% of the channel max


def test_quant_memory_halves(trees):
    *_, tp, _, tq = trees
    assert port.quantized_nbytes(tq) < 0.3 * port.quantized_nbytes(tp)
    assert tq["layers"]["attn_norm"].dtype == torch.float32


def test_quantized_tree_crosses_and_slices(trees):
    """A quantized numpy tree carries across with q kept int8 (a
    ``dtype=`` cast touches floating leaves only), and ``layer_params``
    slices a ``{"q", "s"}`` leaf per layer."""
    *_, jq, tq = trees
    crossed = port.params_from_numpy(jax.tree.map(np.asarray, jq), "cpu",
                                     dtype=torch.bfloat16)
    assert crossed["layers"]["w1"]["q"].dtype == torch.int8
    assert crossed["layers"]["w1"]["s"].dtype == torch.bfloat16
    assert torch.equal(crossed["head"]["q"], tq["head"]["q"])
    lp = layer_params(tq, 1)
    assert torch.equal(lp["wq"]["q"], tq["layers"]["wq"]["q"][1])
    assert torch.equal(lp["wq"]["s"], tq["layers"]["wq"]["s"][1])
    assert torch.equal(lp["attn_norm"], tq["layers"]["attn_norm"][1])


def test_embed_rows_gathers_before_scaling(trees):
    *_, jq, tq = trees
    toks = _prompt(4, (2, 5))
    want = ref_quant.embed_rows(jq["embed"], jnp.asarray(toks), jnp.float32)
    got = port_quant.embed_rows(tq["embed"], torch.from_numpy(toks),
                                torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_quant_prefill_logits_close(trees):
    jcfg, tcfg, jp, tp, jq, tq = trees
    prompt = _prompt(1, (2, 32))
    lf, _ = port.prefill(tcfg, tp, torch.from_numpy(prompt),
                         port.init_cache(tcfg, 2, 64, device="cpu"))
    lq, _ = port.prefill(tcfg, tq, torch.from_numpy(prompt),
                         port.init_cache(tcfg, 2, 64, device="cpu"))
    err = float((lf - lq).abs().max()) / float(lf.std())
    assert err < 0.35, err
    want, _ = ref.prefill(jcfg, jq, jnp.asarray(prompt),
                          ref.init_cache(jcfg, 2, 64))
    np.testing.assert_allclose(lq.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_quant_generate_token_exact(trees):
    """Greedy decode from the quantized tree: the reference's tokens,
    and the first token the fp tree's (int8 noise may fork the tail)."""
    jcfg, tcfg, jp, tp, jq, tq = trees
    prompt = _prompt(2, (2, 16))
    gen = port.make_generate(tcfg, max_new_tokens=8)
    tf = gen(tp, torch.from_numpy(prompt)).numpy()
    tqt = gen(tq, torch.from_numpy(prompt)).numpy()
    assert tf.shape == tqt.shape == (2, 8)
    assert (tf[:, 0] == tqt[:, 0]).all()
    want = jax.jit(ref.make_generate(jcfg, max_new_tokens=8))(
        jq, jnp.asarray(prompt), jax.random.PRNGKey(3))
    np.testing.assert_array_equal(tqt, np.asarray(want))


def test_quant_continuous_batcher(trees):
    """The slot engine serves from a quantized tree unchanged, token for
    token with the reference engine."""
    jcfg, tcfg, _, _, jq, tq = trees
    outs = []
    for eng in (ref.ContinuousBatcher(jcfg, jq, n_slots=2, prompt_bucket=8,
                                      max_len=32),
                port.ContinuousBatcher(tcfg, tq, n_slots=2, prompt_bucket=8,
                                       max_len=32, device="cpu")):
        rids = [eng.submit(p, max_new_tokens=n)
                for p, n in (([1, 2, 3], 4), ([7, 7], 6))]
        done = []
        for _ in range(20):
            done += eng.step()
            if not eng.has_work():
                break
        assert sorted(c.request_id for c in done) == rids
        outs.append({c.request_id: c.tokens for c in done})
    assert outs[1] == outs[0]
    assert [len(outs[1][r]) for r in (0, 1)] == [4, 6]
