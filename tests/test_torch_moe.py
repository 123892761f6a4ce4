"""The port's MoE family against ``pbs_tpu.models.moe``.

Weights are the JAX package's own ``init_moe_params`` tree (fp32) at
``tests/test_moe.py``'s TINY widths, carried across as numpy arrays by
``params_from_numpy``; tokens and activations are drawn with numpy from
a seed. Tolerances:

- routing: ``dispatch`` exactly equal (it is 0/1 by construction, and a
  tie goes to the lower expert index in both packages); ``combine``,
  ``aux`` and ``drop_frac`` within atol 1e-6 (fp32 sums in two orders);
- forward logits and the routed FFN within rtol = atol = 1e-4 (two
  frameworks' fp32 reductions through two layers, the bound of
  ``tests/test_torch_serving.py``);
- loss and gradients within rtol 2e-4, atol 2e-5, and parameters and
  both Adam moments after two steps within rtol 2e-4, atol 2e-6 (the
  ``GRAD_TOL`` and ``STEP_TOL`` of ``tests/test_torch_train.py``);
- greedy generation token-exact, drop fractions within atol 1e-6.

The "pallas" forward runs the JAX side's Pallas kernel in interpret mode
and the port's plain flash version, once.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import pytest

jax = pytest.importorskip("jax", reason="parity tests need the JAX reference")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from pbs_tpu.models import moe as ref  # noqa: E402
from pbs_tpu_torch import models as port_models  # noqa: E402
from pbs_tpu_torch.models import moe as port  # noqa: E402
from pbs_tpu_torch.models.transformer import tree_leaves, value_and_grad  # noqa: E402
from pbs_tpu_torch.utils import tree as port_tree  # noqa: E402

# The suite runs in parallel worker processes: uncapped, torch's intra-op
# pool takes every core in each of them and oversubscribes the host.
torch.set_num_threads(2)

#: tests/test_moe.py's TINY, without the dtype.
TINY = dict(vocab=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=96, max_seq=64, n_experts=4, top_k=2, capacity_factor=2.0)
ROUTE_ATOL = 1e-6
FWD_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
STEP_TOL = dict(rtol=2e-4, atol=2e-6)


def _cfgs(**over):
    fields = {**TINY, **over}
    return (ref.MoEConfig(**fields, dtype=jnp.float32),
            port.MoEConfig(**fields, dtype=torch.float32))


def _tree(jtree):
    return jax.tree.map(np.asarray, jtree)


def _cross(jtree):
    return port_models.params_from_numpy(_tree(jtree), "cpu")


def _tokens(shape, seed, vocab=TINY["vocab"]):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = _cfgs()
    jparams = ref.init_moe_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jparams, _cross(jparams)


def _assert_trees_close(got: dict, want, **tol):
    """``got`` a port tree, ``want`` a JAX/numpy tree of the same keys."""
    want = _tree(want)
    assert set(got) == set(want)
    for key, g in got.items():
        if isinstance(g, dict):
            _assert_trees_close(g, want[key], **tol)
        else:
            np.testing.assert_allclose(g.detach().float().numpy(), want[key],
                                       err_msg=key, **tol)


def _layer0(params):
    """Layer 0's slice of either package's tree."""
    return {k: v[0] for k, v in params["layers"].items()}


# -- configuration and initialization --------------------------------------


@pytest.mark.parametrize("over", [
    {}, {"capacity_factor": 1.25}, {"capacity_factor": 0.3, "top_k": 1},
    {"dropless": True}, {"dropless": True, "dropless_group_max": 32},
    # bench_serving.py's MoE rows: the flagship's widths, E=4, d_ff/4
    {"vocab": 32_768, "d_model": 2048, "n_layers": 12, "n_heads": 16,
     "n_kv_heads": 8, "d_ff": 1408, "max_seq": 1024, "dropless": True},
], ids=["tiny", "cf1.25", "starved", "dropless", "guarded", "flagship"])
def test_capacity_and_num_params_match_reference(over):
    jcfg, tcfg = _cfgs(**over)
    assert tcfg.num_params() == jcfg.num_params()
    for n in (1, 7, 16, 33, 128, 2046, 4096):
        try:
            want = jcfg.capacity(n)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                tcfg.capacity(n)
            assert str(got.value) == str(e)
            continue
        assert tcfg.capacity(n) == want, n


def test_flagship_moe_is_the_dense_flagships_size():
    """The MoE serving rows' configuration (E=4 experts of d_ff/4) holds
    the dense flagship's parameters plus the routers: 700.6M."""
    widths = dict(vocab=32_768, d_model=2048, n_layers=12, n_heads=16,
                  n_kv_heads=8, max_seq=1024)
    _, tcfg = _cfgs(**widths, d_ff=5632 // 4)
    dense = port_models.TransformerConfig(**widths, d_ff=5632)
    assert tcfg.num_params() == dense.num_params() + 12 * 2048 * 4
    assert tcfg.num_params() == 700_598_272


def test_init_moe_params_matches_reference_layout_and_scales(model):
    """Same keys, shapes and dtypes as the reference's tree; fan_in is
    shape[-2] (d for the (L, E, d, f) experts, vocab for the embedding,
    which is then scaled by sqrt(d)); the JAX tree crosses through
    params_from_numpy intact."""
    jcfg, tcfg, jparams, crossed = model
    mine = port.init_moe_params(tcfg, torch.Generator().manual_seed(0),
                                device="cpu")
    want = _tree(jparams)
    for tree in (mine, crossed):
        assert set(tree) == set(want)
        assert set(tree["layers"]) == set(want["layers"])
        for t, w in zip(port_tree.tree_leaves(tree),
                        jax.tree_util.tree_leaves(jparams)):
            assert tuple(t.shape) == w.shape and t.dtype == torch.float32
    assert sum(t.numel() for t in tree_leaves(mine)) == tcfg.num_params()
    for t, w in zip(port_tree.tree_leaves(crossed),
                    jax.tree_util.tree_leaves(want)):
        assert np.array_equal(t.numpy(), w)
    d, f = TINY["d_model"], TINY["d_ff"]
    layers = mine["layers"]
    for name, fan_in in (("router", d), ("we1", d), ("we3", d), ("we2", f)):
        std = float(layers[name].std()) * np.sqrt(fan_in)
        assert abs(std - 1.0) < 0.1, (name, std)
    # the embedding: fan_in = shape[-2] = vocab, times sqrt(d_model)
    want_std = np.sqrt(d / TINY["vocab"])
    assert abs(float(mine["embed"].std()) / want_std - 1.0) < 0.1
    assert abs(float(want["embed"].std()) / want_std - 1.0) < 0.1
    assert float(layers["attn_norm"].min()) == 1.0


# -- routing ----------------------------------------------------------------


def _probs(case):
    """(probs (..., T, E) fp32 numpy, k, capacity) of a routing case."""
    rng = np.random.default_rng(1)
    if case == "random":
        z = rng.normal(size=(32, 4))
        return np.exp(z) / np.exp(z).sum(-1, keepdims=True), 2, 8
    if case == "concentrated":  # tests/test_moe.py:64-89: all pick (0, 1)
        p = np.tile([[0.90, 0.08, 0.01, 0.01]], (16, 1))
        return p, 2, _cfgs(capacity_factor=1.25)[0].capacity(16)
    if case == "concentrated_dropless":
        return np.tile([[0.90, 0.08, 0.01, 0.01]], (16, 1)), 2, 16
    if case == "starved":
        return np.tile([[0.97, 0.01, 0.01, 0.01]], (8, 1)), 1, 1
    if case == "uniform":  # a zero router: every expert tied
        return np.full((16, 4), 0.25), 2, 16
    if case == "pair_ties":  # ties between two of the experts only
        p = np.tile([[0.1, 0.4, 0.1, 0.4]], (12, 1))
        return p, 2, 5
    z = rng.normal(size=(3, 8, 4))  # "grouped": the reference vmaps
    return np.exp(z) / np.exp(z).sum(-1, keepdims=True), 2, 5


@pytest.mark.parametrize("case", [
    "random", "concentrated", "concentrated_dropless", "starved", "uniform",
    "pair_ties", "grouped"])
def test_top_k_dispatch_matches_reference(case):
    probs, k, cap = _probs(case)
    probs = probs.astype(np.float32)
    fn = jax.jit(jax.vmap(lambda p: ref.top_k_dispatch(p, k, cap))
                 if probs.ndim == 3 else lambda p: ref.top_k_dispatch(p, k, cap))
    want = [np.asarray(a) for a in fn(jnp.asarray(probs))]
    got = [a.numpy() for a in port.top_k_dispatch(torch.from_numpy(probs),
                                                  k, cap)]
    assert got[0].shape == want[0].shape
    assert np.array_equal(got[0], want[0])  # dispatch, exactly
    for g, w in zip(got[1:], want[1:]):  # combine, aux, drop
        np.testing.assert_allclose(g, w, rtol=0, atol=ROUTE_ATOL)
    if case == "concentrated":
        assert float(got[3]) > 0.2  # the capacity router really drops
    if case in ("concentrated_dropless", "uniform"):
        assert float(got[3]) == 0.0
        assert np.all(got[0].sum(axis=(-2, -1)) == k)
    if case == "uniform":  # ties go to the lowest indices, 0 and 1
        assert got[0][:, 2:].sum() == 0


def test_top_k_dispatch_gradients_skip_the_one_hot():
    """Gradients reach probs through combine and aux only: dispatch and
    drop_frac carry none."""
    probs = torch.softmax(torch.randn(16, 4, generator=torch.Generator()
                                      .manual_seed(2)), -1).requires_grad_()
    dispatch, combine, aux, drop = port.top_k_dispatch(probs, 2, 8)
    assert not dispatch.requires_grad and not drop.requires_grad
    assert combine.requires_grad and aux.requires_grad
    (g,) = torch.autograd.grad(combine.sum() + aux, probs)
    assert float(g.abs().max()) > 0


@pytest.mark.parametrize("over,T", [
    ({}, 64), ({"router_group_size": 16}, 64), ({"router_group_size": 7}, 64),
    ({"router_group_size": 0}, 30), ({"dropless": True}, 2048),
    ({"dropless": True, "router_group_size": 512}, 1500),
    ({"dropless": True, "router_group_size": 512}, 1536),
])
def test_routing_groups_match_reference(over, T):
    jcfg, tcfg = _cfgs(**over)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert port.routing_groups(tcfg, T) == ref.routing_groups(jcfg, T)


def test_routing_groups_warn_on_degenerate_tiling_and_guard():
    jcfg, tcfg = _cfgs(dropless=True, router_group_size=512)
    with pytest.warns(UserWarning, match="no divisor near") as want:
        w = ref.routing_groups(jcfg, 1031)  # prime > 512
    with pytest.warns(UserWarning, match="no divisor near") as got:
        assert port.routing_groups(tcfg, 1031) == w == (1, 1031, 1)
    assert str(got[0].message) == str(want[0].message)
    jcfg, tcfg = _cfgs(dropless=True, dropless_group_max=32)
    with pytest.raises(ValueError, match="router_group_size") as e:
        tcfg.capacity(64)
    with pytest.raises(ValueError) as r:
        jcfg.capacity(64)
    assert str(e.value) == str(r.value)


# -- the routed FFN and the forward -----------------------------------------


@pytest.mark.parametrize("over", [{}, {"dropless": True},
                                  {"capacity_factor": 0.5}])
def test_moe_mlp_matches_reference(model, over):
    jcfg, tcfg = _cfgs(**over)
    _, _, jparams, tparams = model
    x = np.random.default_rng(4).normal(size=(2, 8, TINY["d_model"])).astype(
        np.float32)
    want = jax.jit(lambda x, lp: ref.moe_mlp(jcfg, x, lp, lambda a: a))(
        jnp.asarray(x), _layer0(jparams))
    got = port.moe_mlp(tcfg, torch.from_numpy(x), _layer0(tparams))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               **FWD_TOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(float(g), float(w), rtol=0,
                                   atol=ROUTE_ATOL)
    if over.get("capacity_factor") == 0.5:
        assert float(got[2]) > 0


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_moe_forward_matches_reference(model, impl):
    jcfg, tcfg, jparams, tparams = model
    jcfg = dataclasses.replace(jcfg, attn_impl=impl)
    tcfg = dataclasses.replace(tcfg, attn_impl=impl)
    toks = _tokens((2, 16), 0)
    want = jax.jit(lambda p, t: ref.moe_forward(jcfg, p, t))(
        jparams, jnp.asarray(toks))
    got = port.moe_forward(tcfg, tparams, torch.from_numpy(toks))
    assert tuple(got[0].shape) == (2, 16, TINY["vocab"])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               **FWD_TOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(float(g), float(w), rtol=0,
                                   atol=ROUTE_ATOL)


def test_moe_layer_body_seams(model):
    """``mlp=`` and ``attn=`` replace the routed FFN and the attention;
    passing the defaults through them changes nothing."""
    _, tcfg, _, tparams = model
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(1, 8, TINY["d_model"])).astype(np.float32))
    cos, sin = port.rope_tables(tcfg, 8, device="cpu")
    lp = _layer0(tparams)
    base = port.moe_layer_body(tcfg, x, lp, cos, sin)
    seen = []

    def mlp(h, lp_):
        seen.append("mlp")
        return port.moe_mlp(tcfg, h, lp_)

    def attn(q, k, v):
        seen.append("attn")
        return port.causal_attention(q, k, v, tcfg)

    out = port.moe_layer_body(tcfg, x, lp, cos, sin, mlp=mlp, attn=attn)
    assert seen == ["attn", "mlp"]
    for a, b in zip(out, base):
        assert torch.equal(a, b)


# -- loss, gradients and the training step ----------------------------------


@pytest.mark.parametrize("variant", ["plain", "chunked", "full_seq"])
def test_moe_loss_and_grads_match_reference(model, variant):
    """The loss, its parts and every gradient leaf: the sliced loss, the
    chunked tail (loss_chunks=4, over all S tokens) and full_seq."""
    jcfg, tcfg, jparams, tparams = model
    over = {"loss_chunks": 4} if variant == "chunked" else {}
    jcfg = dataclasses.replace(jcfg, **over)
    tcfg = dataclasses.replace(tcfg, **over)
    full_seq = variant == "full_seq"
    toks = _tokens((2, 16), 3)
    (jl, jparts), jgrads = jax.jit(jax.value_and_grad(
        lambda p: ref.moe_loss(jcfg, p, jnp.asarray(toks),
                               full_seq=full_seq), has_aux=True))(jparams)
    (tl, tparts), tgrads = value_and_grad(
        lambda p: port.moe_loss(tcfg, p, torch.from_numpy(toks),
                                full_seq=full_seq), tparams)
    np.testing.assert_allclose(float(tl), float(jl), **GRAD_TOL)
    for g, w in zip(tparts, jparts):  # lm, aux, drop
        np.testing.assert_allclose(float(g.detach()), float(w), **GRAD_TOL)
    _assert_trees_close(tgrads, jgrads, **GRAD_TOL)


def _count_products(cfg, params, toks) -> int:
    from torch.utils._python_dispatch import TorchDispatchMode

    products = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default}

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in products:
                Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        value_and_grad(lambda p: port.moe_loss(cfg, p, toks), params)
    return Count.n


def test_remat_is_full_recompute_and_routes_as_the_first_pass(model):
    """remat recomputes the whole MoE layer whatever remat_policy says
    (the reference's plain jax.checkpoint): "dots" counts as many
    products as "full", more than no remat; and the recompute routes as
    the first pass did, so loss and gradients are those without remat."""
    _, tcfg, _, tparams = model
    toks = torch.from_numpy(_tokens((2, 16), 6))
    (base, _), base_g = value_and_grad(
        lambda p: port.moe_loss(tcfg, p, toks), tparams)
    counts = {"none": _count_products(tcfg, tparams, toks)}
    for policy in ("full", "dots"):
        cfg = dataclasses.replace(tcfg, remat=True, remat_policy=policy)
        (loss, _), grads = value_and_grad(
            lambda p: port.moe_loss(cfg, p, toks), tparams)
        assert float(loss) == float(base)
        for a, b in zip(tree_leaves(grads), tree_leaves(base_g)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                       atol=1e-9)
        counts[policy] = _count_products(cfg, tparams, toks)
    assert counts["dots"] == counts["full"] > counts["none"]


def _adam_state(opt_state):
    (adam,) = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    return adam


def test_moe_train_steps_match_reference():
    """Params, both Adam moments and the metrics after two steps of
    make_moe_train_step, end to end, at tests/test_microstep.py's widths
    with TINY's experts (at TINY width a few gradient elements are ~1e-8,
    where the two frameworks' fp32 summation orders differ by percents
    and Adam's g / (|g| + eps) makes that a 1e-4 parameter difference,
    as tests/test_torch_train.py notes for the dense family)."""
    jcfg, tcfg = _cfgs(vocab=64, d_model=32, n_layers=1, n_heads=2,
                       n_kv_heads=2, d_ff=64, max_seq=32)
    jparams = ref.init_moe_params(jcfg, jax.random.PRNGKey(0))
    toks = _tokens((4, 17), 7, vocab=64)
    init_opt, step = ref.make_moe_train_step(jcfg, learning_rate=1e-2)
    jstate = (jparams, init_opt(jparams), 0)
    for _ in range(2):
        jstate, jm = jax.jit(step)(jstate, jnp.asarray(toks))

    tinit, tstep = port.make_moe_train_step(tcfg, learning_rate=1e-2)
    params = _cross(jparams)
    state = (params, tinit(params), 0)
    for _ in range(2):
        state, m = tstep(state, torch.from_numpy(toks))
    assert state[2] == 2 and int(state[1]["count"]) == 2
    assert set(m) == set(jm) == {"loss", "aux_loss", "moe_drop_frac",
                                 "tokens"}
    assert m["tokens"] == int(jm["tokens"]) == 4 * 16
    for key in ("loss", "aux_loss", "moe_drop_frac"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                   **GRAD_TOL, err_msg=key)
    _assert_trees_close(state[0], jstate[0], **STEP_TOL)
    adam = _adam_state(jstate[1])
    _assert_trees_close(state[1]["mu"], adam.mu, **STEP_TOL)
    _assert_trees_close(state[1]["nu"], adam.nu, **STEP_TOL)


# -- lockstep generation ----------------------------------------------------


@pytest.mark.parametrize("over", [{"capacity_factor": 8.0},
                                  {"capacity_factor": 0.3},
                                  {"dropless": True}],
                         ids=["ample", "starved", "dropless"])
def test_moe_generate_token_exact_with_the_drop_fraction(model, over):
    jcfg, tcfg = _cfgs(**over)
    _, _, jparams, tparams = model
    prompt = _tokens((2, 8), 3)
    gen = jax.jit(ref.make_moe_generate(jcfg, 6))
    want, wdrop = gen(jparams, jnp.asarray(prompt), jax.random.PRNGKey(1))
    got, drop = port.make_moe_generate(tcfg, 6)(tparams,
                                                torch.from_numpy(prompt))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(float(drop), float(wdrop), rtol=0,
                               atol=ROUTE_ATOL)
    if over.get("capacity_factor") == 0.3:
        assert float(drop) > 0.0  # a starved router is visible


def test_moe_forward_with_cache_prefill_is_the_full_forward(model):
    """The cached prefill's logits are the uncached forward's (routing is
    per token when nothing drops), and the cache advances."""
    _, tcfg, _, tparams = model
    cfg = dataclasses.replace(tcfg, dropless=True)
    toks = torch.from_numpy(_tokens((2, 8), 9))
    cache = port_models.init_cache(cfg, 2, max_len=12, device="cpu")
    with torch.no_grad():
        cached, cache, drop = port.moe_forward_with_cache(cfg, tparams, toks,
                                                          cache)
        full, _, _ = port.moe_forward(cfg, tparams, toks)
    assert cache["pos"] == 8 and float(drop) == 0.0
    np.testing.assert_allclose(cached.numpy(), full.numpy(), rtol=1e-5,
                               atol=1e-5)
