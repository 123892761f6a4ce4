"""The port's GPipe pipeline against the reference: twins of
``tests/test_pipeline.py``.

The reference's tests hold its pipelined loss and train steps to its
single-device ones; here the port's pipelined schedules, on four gloo
CPU rank processes (``test_torch_parallel_ranks``), are held to the
reference's single-device loss, training trajectory and gradients, from
the reference's own init. Meshes of eight devices are cut to four
ranks: dp2 x pp4 -> dp2 x pp2; dp2 x pp2 x tp2 and dp4 x pp2 -> pp2 x
tp2 and dp2 x pp2 (every dense twin at the reference file's four
layers); dp2 x pp2 x sp2 -> pp2 x sp2; the four-axis
compositions pp2 x tp2 x sp2 and pp2 x ep2 x sp2 -> pp1 x tp2 x sp2 and
pp1 x ep2 x sp2 (the schedule with one stage, tp or ep and the ring
inside it); dp1 x pp1 x ep8 -> ep4 over six experts. Guards are
compared with the reference's at the same mesh shape on
``jax.devices()[:4]``. Tolerances (fp32) as in
``test_torch_parallel_seq``: losses rel 1e-5 (the aux statistic too),
gradients atol 2e-5 / rtol 1e-4, parameters after a step atol 2e-5
against the reference's optimizer on the port's gradients.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax", reason="parity tests need the JAX reference")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from pbs_tpu.models import moe as ref_moe  # noqa: E402
from pbs_tpu.models import transformer as ref_tf  # noqa: E402
from pbs_tpu.parallel import make_mesh  # noqa: E402
from pbs_tpu.parallel import pipeline as ref_pipe  # noqa: E402
from test_torch_parallel_ranks import rank_pool  # noqa: E402
from test_torch_parallel_seq import LOSS_REL, assert_step  # noqa: E402

torch.set_num_threads(2)

TINY = dict(vocab=128, d_model=64, n_layers=4, n_heads=4, n_kv_heads=2,
            d_ff=128, max_seq=64)
MOE = dict(TINY, d_ff=96, n_experts=4, top_k=2, dropless=True,
           router_group_size=31)
LR = 1e-2
RANKS = "test_torch_parallel_ranks"


def _np(tree):
    return jax.tree.map(lambda x: np.array(x, copy=True), tree)


def _jcfg(family, **over):
    if family == "moe":
        return ref_moe.MoEConfig(**{**MOE, **over}, dtype=jnp.float32)
    return ref_tf.TransformerConfig(**{**TINY, **over}, dtype=jnp.float32)


def _mesh(axes):
    return make_mesh(axes, devices=jax.devices()[:4])


def _toks(b=4, s=32, seed=0):
    return np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (b, s),
                                         0, TINY["vocab"]))


def _key(over: dict):
    return tuple(sorted(over.items()))


@functools.lru_cache(maxsize=None)
def _params(family, over):
    cfg = _jcfg(family, **dict(over))
    init = ref_moe.init_moe_params if family == "moe" else ref_tf.init_params
    return _np(init(cfg, jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _reference(family, over, b=4, seed=0, steps=3):
    """The reference's single-device run: per-step metrics and the
    gradients of the first step's loss — its ``train_step``'s
    ``value_and_grad`` and ``default_optimizer``, jitted apart."""
    import optax

    cfg = _jcfg(family, **dict(over))
    params = jax.tree.map(jnp.asarray, _params(family, over))
    toks = jnp.asarray(_toks(b, 32, seed))
    if family == "moe":
        def loss(p):
            total, (lm, aux, drop) = ref_moe.moe_loss(cfg, p, toks)
            return total, {"loss": lm, "aux_loss": aux,
                           "moe_drop_frac": drop}
    else:
        def loss(p):
            lm = ref_tf.next_token_loss(cfg, p, toks)
            return lm, {"loss": lm}
    vg = jax.jit(jax.value_and_grad(loss, has_aux=True))
    tx = ref_tf.default_optimizer(LR)

    @jax.jit
    def update(params, opt, grads):
        updates, opt = tx.update(grads, opt, params)
        return optax.apply_updates(params, updates), opt

    opt, metrics, first = tx.init(params), [], None
    for _ in range(steps):
        (_, m), grads = vg(params)
        first = _np(grads) if first is None else first
        metrics.append({k: float(v) for k, v in m.items()})
        params, opt = update(params, opt, grads)
    return metrics, first


def _port_train(pool, family, axes, over, b=4, seed=0, steps=3):
    cfg_kw = {**(MOE if family == "moe" else TINY), **over}
    return pool.run(f"{RANKS}:rank_train",
                    "pipe_moe" if family == "moe" else "pipe", cfg_kw,
                    axes, _toks(b, 32, seed), _params(family, _key(over)),
                    steps, LR, grads=True)[0]


def _check_train(out, family, over, b=4, seed=0, steps=3, aux=True):
    metrics, grads = _reference(family, _key(over), b, seed, steps)
    for key in ("loss", "aux_loss") if family == "moe" and aux else ("loss",):
        np.testing.assert_allclose([m[key] for m in out["metrics"]],
                                   [m[key] for m in metrics], rtol=LOSS_REL,
                                   err_msg=key)
    if family == "moe":
        assert all(abs(m["moe_drop_frac"]) < 1e-6 for m in out["metrics"])
    assert_step(out, grads, _params(family, _key(over)))


@pytest.fixture(scope="module")
def pool():
    p = rank_pool(4)
    yield p
    p.close()


def _port_error(pool, what, axes, family="dense", **kw):
    cfg_kw = {**(MOE if family == "moe" else TINY), **kw.pop("over", {})}
    return pool.run(f"{RANKS}:rank_error", what, axes, cfg_kw=cfg_kw,
                    family="pipe_moe" if family == "moe" else "dense",
                    **kw)[0]


def _jax_error(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return "ValueError", str(e.value)


def _ref_loss(over, b=4):
    return _reference("dense", _key(over), b, 0, 3)[0][0]["loss"]


# -- the dense pipeline ------------------------------------------------------


def test_pipelined_loss_matches_reference(pool):
    got = pool.run(f"{RANKS}:rank_loss", "pipe", TINY, {"dp": 2, "pp": 2},
                   _toks(4, 32), _params("dense", ()))
    assert got[0] == got[-1]  # every rank holds the global loss
    assert got[0] == pytest.approx(_ref_loss({}), rel=LOSS_REL)


def test_pipelined_train_matches_single_device(pool):
    out = _port_train(pool, "dense", {"dp": 2, "pp": 2}, {})
    _check_train(out, "dense", {})


def test_pipelined_tp_train_matches_single_device(pool):
    """pp2 x tp2: Megatron column/row sharding with explicit sums over
    tp INSIDE the GPipe stages; three steps and the first step's
    gradients (a missing exchange in the backward, e.g. an unsummed
    replicated-norm cotangent, shows in the gradients)."""
    out = _port_train(pool, "dense", {"dp": 1, "pp": 2, "tp": 2}, {})
    _check_train(out, "dense", {})


def test_pipelined_tp_guards(pool):
    # tp=4 does not divide n_kv_heads=2
    want = _jax_error(lambda: ref_pipe._pipe_blocks(
        _jcfg("dense"), _mesh({"dp": 1, "pp": 1, "tp": 4}), 2))
    got = _port_error(pool, "pipe_blocks", {"dp": 1, "pp": 1, "tp": 4},
                      n_micro=2)
    assert got == want and "must divide" in got[1]


@pytest.mark.parametrize("case", ["xla-under-sp", "ring-without-sp",
                                  "ulysses-with-tp"])
def test_pipelined_attn_mesh_guards(pool, case):
    """sp-sharded sequences need a sequence-parallel impl (anything else
    is silently block-diagonal); ring/ulysses need the sp axis; ulysses
    keeps its head constraints inside the pipe."""
    axes, over, match = {
        "xla-under-sp": ({"dp": 1, "pp": 2, "sp": 2}, {}, "block-diagonal"),
        "ring-without-sp": ({"dp": 2, "pp": 2}, {"attn_impl": "ring"},
                            "'sp' axis"),
        "ulysses-with-tp": ({"pp": 1, "tp": 2, "sp": 2},
                            {"attn_impl": "ulysses"}, "tensor parallelism"),
    }[case]
    want = _jax_error(lambda: ref_pipe._pipe_blocks(
        _jcfg("dense", **over), _mesh(axes), 2))
    got = _port_error(pool, "pipe_blocks", axes, n_micro=2, over=over)
    assert got == want and match in got[1]


def test_pipelined_flash_train_matches_single_device(pool):
    """dp2 x pp2 with the flash kernel inside the GPipe stages (its plain
    version on the host), through the stage's recompute; three steps
    against the single-device run (flash and dense attention are the
    same function)."""
    out = _port_train(pool, "dense", {"dp": 2, "pp": 2},
                      {"attn_impl": "pallas"})
    _check_train_as(out, {})


def _check_train_as(out, ref_over, b=4):
    """``out`` against the reference's single-device dense run of
    ``ref_over`` (another attention impl of the same function)."""
    metrics, grads = _reference("dense", _key(ref_over), b, 0, 3)
    np.testing.assert_allclose([m["loss"] for m in out["metrics"]],
                               [m["loss"] for m in metrics][:len(
                                   out["metrics"])], rtol=LOSS_REL)
    assert_step(out, grads, _params("dense", _key(ref_over)))


@pytest.mark.parametrize("block", ["dense", "flash"])
def test_pipelined_ring_train_matches_single_device(pool, block):
    """pp2 x sp2: ring attention's per-rank body INSIDE the pipe
    (sequence sharded over sp, k/v rotating, rope positions offset per
    chunk); three steps against the single-device dense run."""
    out = _port_train(pool, "dense", {"dp": 1, "pp": 2, "sp": 2},
                      {"attn_impl": "ring", "ring_block": block})
    _check_train_as(out, {})


def test_pipelined_tp_sp_ring_train_matches_single_device(pool):
    """tp2 x sp2 inside the pipe's schedule (the reference's pp2 x tp2 x
    sp2 cut to one stage): tp sums and the ring's rotations in one
    stage body."""
    out = _port_train(pool, "dense", {"dp": 1, "pp": 1, "tp": 2, "sp": 2},
                      {"attn_impl": "ring"})
    _check_train_as(out, {})


def test_pipelined_ulysses_loss_matches_reference(pool):
    got = pool.run(f"{RANKS}:rank_loss", "pipe",
                   {**TINY, "attn_impl": "ulysses"},
                   {"dp": 1, "pp": 2, "sp": 2}, _toks(4, 32),
                   _params("dense", ()))
    assert got[0] == pytest.approx(_ref_loss({}), rel=LOSS_REL)


# -- the MoE pipeline --------------------------------------------------------


def test_pipelined_moe_pallas_loss_runs(pool):
    """MoE stages with the flash kernel: a pp2 x ep2 step runs, finite,
    and its loss is the single-device MoE loss."""
    out = pool.run(f"{RANKS}:rank_train", "pipe_moe",
                   {**MOE, "attn_impl": "pallas"}, {"pp": 2, "ep": 2},
                   _toks(4, 32, 3), _params("moe", ()), 1, LR)[0]
    assert np.isfinite(out["metrics"][0]["loss"])
    metrics, _ = _reference("moe", (), 4, 3, 3)
    assert out["metrics"][0]["loss"] == pytest.approx(metrics[0]["loss"],
                                                      rel=LOSS_REL)


@pytest.mark.parametrize("axes", [{"dp": 1, "pp": 2, "ep": 2},
                                  {"dp": 2, "pp": 2}])
def test_pipelined_moe_train_matches_single_device(pool, axes):
    """pp2 x ep2 (and dp2 x pp2): the MoE family through the schedule,
    expert-sharded stages and a sum over ep. Dropless routing with one
    row per routing group makes the groups identical between the
    microbatched and single-program paths, so three steps track the
    single-device run: the loss, the bubble-free aux statistic (a leak
    of a bubble's aux into the gradient would show), exactly-zero drops
    and the gradients."""
    out = _port_train(pool, "moe", axes, {}, seed=3)
    _check_train(out, "moe", {}, seed=3)


def test_pipelined_moe_ring_train_matches_single_device(pool):
    """ep2 x sp2 in the MoE schedule (the reference's pp2 x ep2 x sp2
    cut to one stage): ring attention's per-rank body with experts
    ep-sharded and the sequence sp-sharded. Routing is per-token and
    dropless, so the LM loss tracks the single-device MoE run (the aux
    statistic groups tokens per chunk; its weight is zero, as in the
    reference test, and the statistic must be finite)."""
    over = {"router_group_size": 16, "aux_loss_weight": 0.0}
    out = pool.run(f"{RANKS}:rank_train", "pipe_moe",
                   {**MOE, **over, "attn_impl": "ring"},
                   {"dp": 1, "pp": 1, "ep": 2, "sp": 2}, _toks(4, 32, 3),
                   _params("moe", _key(over)), 3, LR, grads=True)[0]
    metrics, grads = _reference("moe", _key(over), 4, 3, 3)
    np.testing.assert_allclose([m["loss"] for m in out["metrics"]],
                               [m["loss"] for m in metrics], rtol=LOSS_REL)
    assert all(np.isfinite(m["aux_loss"]) for m in out["metrics"])
    assert all(abs(m["moe_drop_frac"]) < 1e-6 for m in out["metrics"])
    assert_step(out, grads, _params("moe", _key(over)))


def test_pipelined_moe_ulysses_loss_runs(pool):
    over = {"router_group_size": 16, "aux_loss_weight": 0.0}
    out = pool.run(f"{RANKS}:rank_train", "pipe_moe",
                   {**MOE, **over, "attn_impl": "ulysses"},
                   {"dp": 1, "pp": 1, "ep": 2, "sp": 2}, _toks(4, 32, 3),
                   _params("moe", _key(over)), 1, LR)[0]
    assert np.isfinite(out["metrics"][0]["loss"])
    assert abs(out["metrics"][0]["moe_drop_frac"]) < 1e-6
    metrics, _ = _reference("moe", _key(over), 4, 3, 3)
    assert out["metrics"][0]["loss"] == pytest.approx(metrics[0]["loss"],
                                                      rel=LOSS_REL)


def test_pipelined_moe_guards(pool):
    over = {"n_experts": 6}
    want = _jax_error(lambda: ref_pipe._moe_pipe_blocks(
        _jcfg("moe", **over), _mesh({"dp": 1, "pp": 1, "ep": 4}), 2))
    got = _port_error(pool, "moe_pipe_blocks", {"dp": 1, "pp": 1, "ep": 4},
                      family="moe", n_micro=2, over=over)
    assert got == want and "must divide n_experts" in got[1]


def test_bad_divisibility_raises(pool):
    mesh = {"dp": 2, "pp": 2}
    want = _jax_error(lambda: ref_pipe._pipe_blocks(
        _jcfg("dense", n_layers=3), _mesh(mesh), 2))
    got = _port_error(pool, "pipe_blocks", mesh, n_micro=2,
                      over={"n_layers": 3})
    assert got == want and "not divisible" in got[1]
    loss_fn = ref_pipe.make_pipelined_loss(_jcfg("dense"), _mesh(mesh), 3)
    want = _jax_error(lambda: loss_fn(
        jax.tree.map(jnp.asarray, _params("dense", ())),
        jnp.asarray(_toks(4, 16))))
    got = _port_error(pool, "pipelined_loss", mesh, n_micro=3,
                      params_np=_params("dense", ()), tokens=_toks(4, 16))
    assert got == want and "not divisible" in got[1]
