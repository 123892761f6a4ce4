"""The port's sequence parallelism against the reference's: twins of
``tests/test_ring_training.py`` and ``tests/test_ulysses.py``.

The JAX side runs in this process on ``jax.devices()[:4]``; the port
side on four gloo CPU rank processes (``test_torch_parallel_ranks``) at
the same mesh shape, from the same numpy inputs and the reference's own
``init_params`` tree. The reference's 8-device meshes are cut to 4
ranks: dp2 x sp4 -> dp2 x sp2, dp2 x sp2 x tp2 -> dp1 x sp2 x tp2,
sp8 -> sp4, dp4 x sp2 -> dp2 x sp2. Ring and Ulysses attention are exact,
so every sequence-parallel schedule is held to one JAX run of the dp2 x
sp2 ring (its losses, its parameters after a step) and to the
reference's gradients of the same loss. Tolerances, all fp32: losses
rel 1e-5; attention outputs and gradients atol 2e-5, rtol 1e-4;
parameters after a step atol 2e-5 against the reference's optimizer
(``default_optimizer``, optax's AdamW) applied to the port's summed
gradients. (Against the reference's own step they would differ by up to
2 x lr where a gradient element sits at the fp32 noise floor: Adam's
first step divides by |g| + 1e-8, and the two packages' sums over
ranks round differently; the gradients themselves are held to the
reference's above.) Guards raise the reference's error type with its
message (the port's package name in place of the reference's).
"""

from __future__ import annotations

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax", reason="parity tests need the JAX reference")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as JP  # noqa: E402

from pbs_tpu.models import transformer as ref_tf  # noqa: E402
from pbs_tpu.parallel import (  # noqa: E402
    batch_sharding,
    make_mesh,
    make_sharded_train,
    ulysses_attention,
)
from pbs_tpu.parallel.ring_attention import ring_attention  # noqa: E402
from pbs_tpu_torch.models import transformer as port_tf  # noqa: E402
from test_torch_parallel_ranks import rank_pool  # noqa: E402

torch.set_num_threads(2)

TINY = dict(vocab=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=128, max_seq=64)
LR = 1e-2
LOSS_REL = 1e-5
ATTN_TOL = dict(atol=2e-5, rtol=1e-4)
PARAM_ATOL = 2e-5
RANKS = "test_torch_parallel_ranks"


def _jcfg(**over):
    return ref_tf.TransformerConfig(**{**TINY, **over}, dtype=jnp.float32)


def _mesh(axes):
    return make_mesh(axes, devices=jax.devices()[:4])


def _np(tree):
    return jax.tree.map(lambda x: np.array(x, copy=True), tree)


def _tokens():
    key = jax.random.PRNGKey(7)
    return np.asarray(jax.random.randint(key, (4, 64), 0, 128, jnp.int32))


@functools.lru_cache(maxsize=None)
def _params():
    return _np(ref_tf.init_params(_jcfg(), jax.random.PRNGKey(0)))


def assert_trees_close(got, want, **tol):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            assert_trees_close(got[k], want[k], **tol)
        return
    np.testing.assert_allclose(got, want, **tol)


def reference_step(grads, params, lr=LR):
    """The parameters after the reference's AdamW step from ``params``
    with ``grads``."""
    import optax

    p0 = jax.tree.map(jnp.asarray, params)
    tx = ref_tf.default_optimizer(lr)
    updates, _ = tx.update(jax.tree.map(jnp.asarray, grads), tx.init(p0),
                           p0)
    return _np(optax.apply_updates(p0, updates))


def assert_step(out, want_grads, params=None):
    """The port's summed gradients against the reference's, and its
    parameters after the first step against the reference's optimizer
    on those gradients from ``params`` (default: this module's)."""
    assert_trees_close(out["grads"], want_grads, **ATTN_TOL)
    params = _params() if params is None else params
    assert_trees_close(out["params1"], reference_step(out["grads"], params),
                       atol=PARAM_ATOL, rtol=0)


def assert_losses(metrics, want):
    got = [m["loss"] for m in metrics]
    np.testing.assert_allclose(got, want[:len(got)], rtol=LOSS_REL)


@pytest.fixture(scope="module")
def pool():
    p = rank_pool(4)
    yield p
    p.close()


@pytest.fixture(scope="module")
def jax_ring():
    """The reference's dp2 x sp2 ring: 3 steps' losses, and the
    gradients of the first step's loss."""
    mesh = _mesh({"dp": 2, "sp": 2})
    state, step = make_sharded_train(_jcfg(attn_impl="ring"), mesh,
                                     learning_rate=LR)
    toks = jax.device_put(_tokens(), batch_sharding(mesh))
    losses = []
    for _ in range(3):
        state, m = step(state, toks)
        losses.append(float(m["loss"]))
    full = jnp.asarray(_tokens())
    grads = _np(jax.jit(jax.grad(lambda p: ref_tf.next_token_loss(
        _jcfg(), p, full, full_seq=True)))(
            jax.tree.map(jnp.asarray, _params())))
    return {"losses": losses, "grads": grads}


def _port_train(pool, axes, steps, grads=True, **over):
    return pool.run(f"{RANKS}:rank_train", "dense", {**TINY, **over}, axes,
                    _tokens(), _params(), steps, LR, grads=grads)[0]


def _port_error(pool, what, axes, **kw):
    return pool.run(f"{RANKS}:rank_error", what, axes, **kw)[0]


def _jax_error(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return "ValueError", str(e.value)


def _ported(msg: tuple) -> tuple:
    return msg[0], msg[1].replace("pbs_tpu_torch.", "pbs_tpu.")


# -- tests/test_ring_training.py -------------------------------------------


def test_ring_training_matches_dense(pool, jax_ring):
    """3 optimizer steps: dp2 x sp2 ring == the reference's ring on the
    same mesh (losses), its gradients, and a step of its optimizer."""
    out = _port_train(pool, {"dp": 2, "sp": 2}, 3, attn_impl="ring")
    assert out["axis_names"] == ("dp", "sp")
    assert_losses(out["metrics"], jax_ring["losses"])
    assert_step(out, jax_ring["grads"])
    losses = [m["loss"] for m in out["metrics"]]
    assert losses[-1] < losses[0]  # actually training
    assert out["metrics"][0]["tokens"] == 4 * 63


def test_ring_flash_training_matches_dense(pool, jax_ring):
    """The flash block (normalized (o, lse) partials folded per rotation)
    reproduces the trajectory, gradients included: the lse cotangent of
    the flash backward."""
    out = _port_train(pool, {"dp": 2, "sp": 2}, 2, attn_impl="ring",
                      ring_block="flash")
    assert_losses(out["metrics"], jax_ring["losses"])
    assert_step(out, jax_ring["grads"])


def test_ring_bad_block_impl_rejected(pool):
    want = _jax_error(lambda: ring_attention(
        *(jnp.zeros((1, 64, h, 16)) for h in (4, 2, 2)), _mesh({"sp": 4}),
        block_impl="turbo"))
    got = _port_error(pool, "ring_attention", {"sp": 4}, q_shape=(1, 16, 4, 16),
                      kv_shape=(1, 16, 2, 16), opts={"block_impl": "turbo"})
    assert got == want and "block_impl" in got[1]


def test_ring_with_tp_axis(pool, jax_ring):
    """Ring composes with tensor parallelism: dp1 x sp2 x tp2 (the
    reference's dp2 x sp2 x tp2 cut to four ranks) takes the ring's
    step."""
    out = _port_train(pool, {"dp": 1, "sp": 2, "tp": 2}, 1, attn_impl="ring")
    assert_losses(out["metrics"], jax_ring["losses"])
    assert_step(out, jax_ring["grads"])


def test_ring_without_sp_axis_rejected(pool):
    want = _jax_error(lambda: make_sharded_train(_jcfg(attn_impl="ring"),
                                                 _mesh({"dp": 4})))
    got = _port_error(pool, "make_sharded_train", {"dp": 4},
                      cfg_kw={**TINY, "attn_impl": "ring"})
    assert got == want and "sp" in got[1]


def _zeros_qkv():
    q = torch.zeros((1, 8, 4, 16))
    return q, q[:, :, :2], q[:, :, :2]


def test_unknown_attn_impl_rejected():
    cfg = port_tf.TransformerConfig(**TINY, attn_impl="flash3",
                                    dtype=torch.float32)
    with pytest.raises(ValueError) as got:
        port_tf.causal_attention(*_zeros_qkv(), cfg)
    want = _jax_error(lambda: ref_tf.causal_attention(
        *(jnp.zeros((1, 8, h, 16)) for h in (4, 2, 2)),
        _jcfg(attn_impl="flash3")))
    assert ("ValueError", str(got.value)) == want


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_ring_without_mesh_rejected(impl):
    cfg = port_tf.TransformerConfig(**TINY, attn_impl=impl,
                                    dtype=torch.float32)
    with pytest.raises(ValueError) as got:
        port_tf.causal_attention(*_zeros_qkv(), cfg)
    want = _jax_error(lambda: ref_tf.causal_attention(
        *(jnp.zeros((1, 8, h, 16)) for h in (4, 2, 2)),
        _jcfg(attn_impl=impl)))
    assert _ported(("ValueError", str(got.value))) == want
    assert "mesh" in str(got.value)


# -- tests/test_ulysses.py ------------------------------------------------


def _qkv(H, Hkv, B=2, S=64, hd=32, seed=0):
    ks = jax.random.split(jax.random.PRNGKey(seed), 4)
    q = jax.random.normal(ks[0], (B, S, H, hd), jnp.float32)
    k = jax.random.normal(ks[1], (B, S, Hkv, hd), jnp.float32)
    v = jax.random.normal(ks[2], (B, S, Hkv, hd), jnp.float32)
    w = jax.random.normal(ks[3], q.shape, jnp.float32)
    return q, k, v, w


def _jax_attention(fn, mesh, q, k, v, w, **kw):
    """The reference's output and the gradients of sum(out * w) on
    sequence-sharded inputs."""
    s = NamedSharding(mesh, JP(None, "sp", None, None))
    qs, ks, vs = (jax.device_put(x, s) for x in (q, k, v))

    def loss(q, k, v):
        out = fn(q, k, v, mesh, **kw)
        return jnp.sum(out * w), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(qs, ks, vs)
    return [np.asarray(out)] + [np.asarray(g) for g in grads]


def _port_attention(pool, kind, axes, q, k, v, w, **kw):
    return pool.run(f"{RANKS}:rank_attention", kind, axes,
                    *(np.asarray(x) for x in (q, k, v, w)), **kw)[0]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("block_impl", ["dense", "flash"])
def test_ulysses_matches_dense(pool, causal, block_impl):
    """sp4 (the reference's sp8 cut to four ranks), H = Hkv = 8: output
    and gradients against the reference's Ulysses on the same mesh."""
    q, k, v, w = _qkv(H=8, Hkv=8)
    want = _jax_attention(ulysses_attention, _mesh({"sp": 4}), q, k, v, w,
                          causal=causal, block_impl=block_impl)
    got = _port_attention(pool, "ulysses", {"sp": 4}, q, k, v, w,
                          block_impl=block_impl, causal=causal)
    for name, g, r in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, r, **ATTN_TOL, err_msg=name)


@pytest.mark.parametrize("kind", ["ulysses", "ring"])
def test_ulysses_gqa_grad_matches_dense(pool, kind):
    """GQA (Hkv=4 on an sp2 axis, dp2 beside it) and the gradients
    through the two all-to-alls (and, for the ring, the rotations)."""
    q, k, v, w = _qkv(H=8, Hkv=4, seed=1)
    fn = ulysses_attention if kind == "ulysses" else ring_attention
    want = _jax_attention(fn, _mesh({"dp": 2, "sp": 2}), q, k, v, w)
    got = _port_attention(pool, kind, {"dp": 2, "sp": 2}, q, k, v, w,
                          block_impl="dense")
    for name, g, r in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, r, **ATTN_TOL, err_msg=name)


def test_ulysses_head_divisibility_rejected(pool):
    q, k, v, _ = _qkv(H=8, Hkv=2)  # Hkv=2 not divisible by sp=4
    mesh = _mesh({"sp": 4})
    s = NamedSharding(mesh, JP(None, "sp", None, None))
    want = _jax_error(lambda: ulysses_attention(
        *(jax.device_put(x, s) for x in (q, k, v)), mesh))
    got = _port_error(pool, "ulysses_attention", {"sp": 4},
                      q_shape=(2, 16, 8, 32), kv_shape=(2, 16, 2, 32))
    assert got == want and "divisible" in got[1]


def test_ulysses_tp_mesh_rejected(pool):
    """Both ulysses and tp shard heads: rejected, as the reference does."""
    q, k, v, _ = _qkv(H=8, Hkv=8)
    mesh = _mesh({"sp": 2, "tp": 2})
    s = NamedSharding(mesh, JP(None, "sp", None, None))
    want = _jax_error(lambda: ulysses_attention(
        *(jax.device_put(x, s) for x in (q, k, v)), mesh))
    got = _port_error(pool, "ulysses_attention", {"sp": 2, "tp": 2},
                      q_shape=(2, 32, 8, 32), kv_shape=(2, 32, 8, 32))
    assert got == want and "tensor parallelism" in got[1]


@pytest.mark.parametrize("block", ["dense", "flash"])
def test_ulysses_training_matches_dense(pool, jax_ring, block):
    """2 optimizer steps on dp2 x sp2 (the reference's dp4 x sp2 cut to
    four ranks): attn_impl='ulysses' takes the ring's trajectory."""
    out = _port_train(pool, {"dp": 2, "sp": 2}, 2, attn_impl="ulysses",
                      ring_block=block)
    assert_losses(out["metrics"], jax_ring["losses"])
    assert_step(out, jax_ring["grads"])


def test_ulysses_without_sp_rejected(pool):
    want = _jax_error(lambda: make_sharded_train(_jcfg(attn_impl="ulysses"),
                                                 _mesh({"dp": 4})))
    got = _port_error(pool, "make_sharded_train", {"dp": 4},
                      cfg_kw={**TINY, "attn_impl": "ulysses"})
    assert got == want and "sp" in got[1]
