"""The port's loss, AdamW, training step and micro-steps against ``pbs_tpu``.

Weights are the JAX package's own ``init_params`` tree (fp32), carried
across as numpy arrays by ``params_from_numpy``; tokens are drawn with
numpy from a seed. Loss and gradients agree with
``jax.value_and_grad(next_token_loss)`` within rtol 2e-4, atol 2e-5 (two
frameworks' fp32 reductions through two layers and a softmax, the bound
of ``tests/test_model.py``'s chunked-loss parity); parameters and both
Adam moments after two steps within rtol 2e-4, atol 2e-6, the bound of
``tests/test_microstep.py``'s micro-step parity: end to end at that
test's widths, and on shared gradients at ``_flagship_cfg(tiny=True)``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax", reason="parity tests need the JAX reference")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from __graft_entry__ import _flagship_cfg  # noqa: E402
from pbs_tpu import models as ref  # noqa: E402
from pbs_tpu.models import transformer as ref_tf  # noqa: E402
from pbs_tpu_torch import models as port  # noqa: E402
from pbs_tpu_torch.models import transformer as port_tf  # noqa: E402

# The suite runs in parallel worker processes: uncapped, torch's intra-op
# pool takes every core in each of them and oversubscribes the host.
torch.set_num_threads(2)

GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
#: tests/test_microstep.py's TINY widths.
MICRO = dict(vocab=64, d_model=32, n_layers=1, n_heads=2, n_kv_heads=2,
             d_ff=64, max_seq=32)
STEP_TOL = dict(rtol=2e-4, atol=2e-6)


def _port_cfg(jcfg, **over):
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    return port.TransformerConfig(**{**fields, **over}, dtype=torch.float32)


def _tree(jparams):
    return jax.tree.map(np.asarray, jparams)


def _tokens(shape, seed, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


@pytest.fixture(scope="module")
def tiny():
    jcfg = _flagship_cfg(tiny=True)
    jparams = ref.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, _port_cfg(jcfg), jparams, _tree(jparams)


def _assert_trees_close(got: dict, want, **tol):
    """``got`` a port tree, ``want`` a JAX/numpy tree of the same keys."""
    want = _tree(want)
    assert set(got) == set(want)
    for key, g in got.items():
        if isinstance(g, dict):
            _assert_trees_close(g, want[key], **tol)
        else:
            np.testing.assert_allclose(g.float().numpy(), want[key],
                                       err_msg=key, **tol)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_loss_and_grads_match_reference(tiny, impl):
    """Every gradient leaf, on the dense path and through the flash
    backward (Pallas interpret mode there, the plain backward here)."""
    jcfg, tcfg, jparams, tree = tiny
    jcfg = dataclasses.replace(jcfg, attn_impl=impl)
    tcfg = dataclasses.replace(tcfg, attn_impl=impl)
    toks = _tokens((2, 33), 1, jcfg.vocab)
    want_loss, want_grads = jax.value_and_grad(
        lambda p: ref.next_token_loss(jcfg, p, jnp.asarray(toks)))(jparams)
    loss, grads = port_tf.loss_and_grads(
        tcfg, port.params_from_numpy(tree, "cpu"), torch.from_numpy(toks))
    np.testing.assert_allclose(float(loss), float(want_loss), **GRAD_TOL)
    _assert_trees_close(grads, want_grads, **GRAD_TOL)


@pytest.mark.parametrize("variant", ["chunked", "full_seq"])
def test_loss_variants_match_materialized(tiny, variant):
    """loss_chunks=4 (head scanned over checkpointed chunks) and
    full_seq are the materialized loss, value and gradients; the
    chunked loss also against the reference's chunked loss."""
    jcfg, tcfg, _, tree = tiny
    params = port.params_from_numpy(tree, "cpu")
    toks = torch.from_numpy(_tokens((2, 32), 3, jcfg.vocab))
    base_loss, base_grads = port_tf.loss_and_grads(tcfg, params, toks)
    if variant == "chunked":
        cfg = dataclasses.replace(tcfg, loss_chunks=4)
        loss, grads = port_tf.loss_and_grads(cfg, params, toks)
        want = ref.next_token_loss(dataclasses.replace(jcfg, loss_chunks=4),
                                   tiny[2], jnp.asarray(toks.numpy()))
        np.testing.assert_allclose(float(loss), float(want), **GRAD_TOL)
    else:
        loss, grads = port_tf.loss_and_grads(tcfg, params, toks,
                                             full_seq=True)
    np.testing.assert_allclose(float(loss), float(base_loss), rtol=1e-5,
                               atol=1e-6)
    for a, b in zip(port_tf.tree_leaves(grads),
                    port_tf.tree_leaves(base_grads)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD_TOL)


def test_chunked_loss_rejects_indivisible(tiny):
    _, tcfg, _, tree = tiny
    toks = torch.zeros((2, 16), dtype=torch.int32)
    with pytest.raises(ValueError, match="divisible"):
        port.next_token_loss(dataclasses.replace(tcfg, loss_chunks=5),
                             port.params_from_numpy(tree, "cpu"), toks)


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_matches_no_remat(tiny, policy):
    """Recompute changes where values live, not what they are."""
    _, tcfg, _, tree = tiny
    params = port.params_from_numpy(tree, "cpu")
    toks = torch.from_numpy(_tokens((2, 24), 4, tcfg.vocab))
    base_loss, base_grads = port_tf.loss_and_grads(tcfg, params, toks)
    cfg = dataclasses.replace(tcfg, remat=True, remat_policy=policy,
                              attn_impl="pallas")
    loss, grads = port_tf.loss_and_grads(cfg, params, toks)
    np.testing.assert_allclose(float(loss), float(base_loss), rtol=1e-6)
    for a, b in zip(port_tf.tree_leaves(grads),
                    port_tf.tree_leaves(base_grads)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD_TOL)


def test_dots_policy_saves_only_weight_products(tiny):
    """Under "dots" the backward recomputes the layer but not its weight
    products: fewer aten.mm calls than "full" recompute, more than none."""
    _, tcfg, _, tree = tiny
    params = port.params_from_numpy(tree, "cpu")
    toks = torch.from_numpy(_tokens((1, 16), 5, tcfg.vocab))
    from torch.utils._python_dispatch import TorchDispatchMode

    class CountMM(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten.mm.default:
                CountMM.n += 1
            return func(*args, **(kwargs or {}))

    counts = {}
    for name, over in (("none", {}), ("dots", dict(remat=True,
                                                   remat_policy="dots")),
                       ("full", dict(remat=True, remat_policy="full"))):
        CountMM.n = 0
        with CountMM():
            port_tf.loss_and_grads(dataclasses.replace(tcfg, **over),
                                   params, toks)
        counts[name] = CountMM.n
    # "full" recomputes 6 of a layer's 7 weight products; the w2
    # product only feeds the residual add, which saves nothing, so the
    # recompute stops before it. "dots" recomputes none of them.
    assert counts["dots"] == counts["none"]
    assert counts["full"] == counts["none"] + 6 * tcfg.n_layers


def test_unknown_remat_policy_raises(tiny):
    _, tcfg, _, tree = tiny
    cfg = dataclasses.replace(tcfg, remat=True, remat_policy="bogus")
    with pytest.raises(ValueError, match="unknown remat_policy 'bogus'"):
        port.next_token_loss(cfg, port.params_from_numpy(tree, "cpu"),
                             torch.zeros((1, 8), dtype=torch.int32))


def _adam_state(opt_state):
    (adam,) = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    return adam


def test_adamw_matches_optax_on_the_same_gradients(tiny):
    """The AdamW arithmetic at tiny width: two updates, each on the
    reference's gradients of another batch, fed to both optimizers;
    params and both moments after them."""
    jcfg, tcfg, jparams, tree = tiny
    tx = ref_tf.default_optimizer(1e-2)
    jopt, jp = tx.init(jparams), jparams
    opt = port_tf.default_optimizer(1e-2)
    params = port.params_from_numpy(tree, "cpu")
    state = opt.init(params)
    for seed in (6, 7):
        toks = jnp.asarray(_tokens((2, 32), seed, jcfg.vocab))
        grads = jax.grad(lambda p: ref.next_token_loss(jcfg, p, toks))(jp)
        updates, jopt = tx.update(grads, jopt, jp)
        jp = optax.apply_updates(jp, updates)
        state = opt.update(port.params_from_numpy(_tree(grads), "cpu"),
                           state, params)
    assert state["count"] == 2
    _assert_trees_close(params, jp, **STEP_TOL)
    adam = _adam_state(jopt)
    _assert_trees_close(state["mu"], adam.mu, **STEP_TOL)
    _assert_trees_close(state["nu"], adam.nu, **STEP_TOL)


def test_train_step_matches_reference():
    """Params and both Adam moments after two steps of make_train_step,
    end to end, at tests/test_microstep.py's widths. (At tiny width a
    few dozen of the 600k gradient elements are ~1e-8, where the two
    frameworks' fp32 summation orders differ by percents and Adam's
    g / (|g| + eps) turns that into 1e-4 parameter differences; the
    optimizer is held there on shared gradients, above.)"""
    jcfg = ref.TransformerConfig(**MICRO, dtype=jnp.float32)
    cfg = port.TransformerConfig(**MICRO, dtype=torch.float32)
    jparams = ref.init_params(jcfg, jax.random.PRNGKey(0))
    toks = _tokens((4, 32), 6, jcfg.vocab)
    init_opt, step = ref.make_train_step(jcfg, learning_rate=1e-2)
    jstate = (jparams, init_opt(jparams), 0)
    for _ in range(2):
        jstate, jm = jax.jit(step)(jstate, jnp.asarray(toks))

    tinit, tstep = port.make_train_step(cfg, learning_rate=1e-2)
    params = port.params_from_numpy(_tree(jparams), "cpu")
    state = (params, tinit(params), 0)
    for _ in range(2):
        state, m = tstep(state, torch.from_numpy(toks))
    assert state[2] == 2 and state[1]["count"] == 2
    assert m["tokens"] == 4 * 31 == int(jm["tokens"])
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               **GRAD_TOL)
    _assert_trees_close(state[0], jstate[0], **STEP_TOL)
    adam = _adam_state(jstate[1])
    _assert_trees_close(state[1]["mu"], adam.mu, **STEP_TOL)
    _assert_trees_close(state[1]["nu"], adam.nu, **STEP_TOL)


def test_bf16_adam_moments_storage_and_parity(tiny):
    """mu_dtype=bf16 stores both moments in bf16 between steps, and a
    short run tracks the fp32-moment trajectory (tests/test_model.py's
    claim on the port)."""
    _, tcfg, _, tree = tiny
    batch = torch.from_numpy(_tokens((4, 32), 7, tcfg.vocab))
    losses = {}
    for name, mu_dtype in (("fp32", None), ("bf16", torch.bfloat16)):
        init, step = port.make_train_step(tcfg, learning_rate=1e-2,
                                          mu_dtype=mu_dtype)
        params = port.params_from_numpy(tree, "cpu")
        state = (params, init(params), 0)
        for _ in range(12):
            state, m = step(state, batch)
        losses[name] = float(m["loss"])
        moments = (port_tf.tree_leaves(state[1]["mu"])
                   + port_tf.tree_leaves(state[1]["nu"]))
        want = torch.bfloat16 if mu_dtype else torch.float32
        assert all(x.dtype == want for x in moments)
        assert all(p.dtype == torch.float32
                   for p in port_tf.tree_leaves(state[0]))
    assert abs(losses["bf16"] - losses["fp32"]) < 0.05 * max(
        1.0, abs(losses["fp32"]))
    assert losses["bf16"] < np.log(tcfg.vocab)  # it learned


def test_flash_trains_like_dense_at_ragged_s():
    """attn_impl 'pallas' against 'xla' through two train steps at the
    ragged S - 1 = 126 (tests/test_attention.py's training claim)."""
    cfg = port.TransformerConfig(
        vocab=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
        d_ff=128, max_seq=128, dtype=torch.float32)
    jcfg = ref.TransformerConfig(
        vocab=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
        d_ff=128, max_seq=128, dtype=jnp.float32)
    tree = _tree(ref.init_params(jcfg, jax.random.PRNGKey(0)))
    toks = torch.from_numpy(_tokens((2, 127), 1, cfg.vocab))
    losses = {}
    for impl in ("xla", "pallas"):
        c = dataclasses.replace(cfg, attn_impl=impl)
        init, step = port.make_train_step(c, learning_rate=1e-3)
        params = port.params_from_numpy(tree, "cpu")
        state = (params, init(params), 0)
        for _ in range(2):
            state, m = step(state, toks)
        losses[impl] = float(m["loss"])
    assert abs(losses["pallas"] - losses["xla"]) < 1e-4 * max(
        1.0, abs(losses["xla"]))


def test_eval_step_is_the_loss_without_grad(tiny):
    _, tcfg, _, tree = tiny
    params = port.params_from_numpy(tree, "cpu")
    toks = torch.from_numpy(_tokens((2, 16), 8, tcfg.vocab))
    loss = port.make_eval_step(tcfg)(params, toks)
    assert not loss.requires_grad
    assert float(loss) == float(port.next_token_loss(tcfg, params, toks))


def test_bytes_per_token_step_matches_reference(tiny):
    jcfg, tcfg, _, _ = tiny
    flagship = _flagship_cfg()
    assert tcfg.bytes_per_token_step() == jcfg.bytes_per_token_step()
    assert (_port_cfg(flagship).bytes_per_token_step()
            == flagship.bytes_per_token_step())


# -- micro-steps (twins of tests/test_microstep.py) --------------------------


def test_micro_steps_match_full_batch_and_reference():
    """K micro-steps over b_1..b_K == one full step over concat(b), and
    == the reference's make_micro_train_step."""
    K = 4
    jcfg = ref.TransformerConfig(**MICRO, dtype=jnp.float32)
    cfg = port.TransformerConfig(**MICRO, dtype=torch.float32)
    tree = _tree(ref.init_params(jcfg, jax.random.PRNGKey(0)))
    full = _tokens((4 * K, 32), 3, 64)
    micros = np.split(full, K)

    init_opt, full_step = port.make_train_step(cfg, learning_rate=1e-2)
    params = port.params_from_numpy(tree, "cpu")
    full_state, _ = full_step((params, init_opt(params), 0),
                              torch.from_numpy(full))

    init_state, micro_step = port.make_micro_train_step(
        cfg, n_micro=K, learning_rate=1e-2,
        next_batch=lambda i: torch.from_numpy(micros[i]))
    st = init_state(port.params_from_numpy(tree, "cpu"))
    for i in range(K):
        assert st["micro"] == i and st["step"] == 0
        st, m = micro_step(st)
        assert m["tokens"] == 4 * 31 and torch.isfinite(m["loss"])
    assert st["step"] == 1 and st["micro"] == 0
    assert all(float(a.abs().max()) == 0.0
               for a in port_tf.tree_leaves(st["acc"]))
    for a, b in zip(port_tf.tree_leaves(full_state[0]),
                    port_tf.tree_leaves(st["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **STEP_TOL)

    jinit, jmicro = ref.make_micro_train_step(
        jcfg, n_micro=K, learning_rate=1e-2,
        next_batch=lambda i: jnp.asarray(micros[i]))
    jst = jinit(ref.init_params(jcfg, jax.random.PRNGKey(0)))
    for _ in range(K):
        jst, _ = jmicro(jst)
    _assert_trees_close(st["params"], jst["params"], **STEP_TOL)


def test_micro_job_runs_under_cuda_backend_on_the_host():
    """A micro-stepped job under CudaBackend dispatch retires whole
    steps, counts tokens per micro-batch, and is cut at chunk
    boundaries (YIELDS)."""
    from pbs_tpu_torch.runtime import Job, Partition, SchedParams
    from pbs_tpu_torch.telemetry import Counter, CudaBackend

    K = 3
    cfg = port.TransformerConfig(**MICRO, dtype=torch.float32)
    toks = torch.from_numpy(_tokens((2, 32), 1, 64))
    init_state, micro_step = port.make_micro_train_step(
        cfg, n_micro=K, learning_rate=1e-2, next_batch=lambda i: toks)
    params = port.init_params(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    part = Partition("p", source=CudaBackend(device="cpu"))
    job = part.add_job(Job(
        "train", micro_step_fn=micro_step, micro_per_step=K,
        state=init_state(params), max_steps=2,
        params=SchedParams(tslice_us=100)))
    part.run(max_rounds=50)
    ctx = job.contexts[0]
    assert job.error is None
    assert int(ctx.counters[Counter.STEPS_RETIRED]) == 2
    assert job.state["step"] == 2 and job.state["micro"] == 0
    assert int(ctx.counters[Counter.TOKENS]) == 2 * 31 * 2 * K
    assert int(ctx.counters[Counter.YIELDS]) > 0


def test_micro_without_micro_step_fn_rejected():
    from pbs_tpu_torch.runtime import Job, Partition
    from pbs_tpu_torch.telemetry import CudaBackend

    part = Partition("p", source=CudaBackend(device="cpu"))
    job = part.add_job(Job("bad", step_fn=lambda s: s, state=0,
                           micro_per_step=4, max_steps=2))
    part.run(max_rounds=5)
    assert job.error is not None and "micro_step_fn" in job.error


def test_make_micro_train_step_validates():
    cfg = port.TransformerConfig(**MICRO, dtype=torch.float32)
    with pytest.raises(ValueError, match="n_micro"):
        port.make_micro_train_step(cfg, 0, next_batch=lambda i: None)
    with pytest.raises(ValueError, match="next_batch"):
        port.make_micro_train_step(cfg, 2)
