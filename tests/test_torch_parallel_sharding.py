"""The port's sharding, expert parallelism and hybrid mesh against the
reference; the spec tables and the package surface.

Twins of ``tests/test_model.py::test_sharded_train_matches_single_device``,
``tests/test_moe.py::test_expert_parallel_matches_single_device``,
``tests/test_advice_fixes.py::test_reorder_hybrid_multi_axis`` and
``::test_hybrid_mesh_trains_end_to_end``. The port runs on four gloo CPU
rank processes (``test_torch_parallel_ranks``); the reference's 8-device
meshes are cut to four ranks (dp2 x tp4 -> dp2 x tp2, dp2 x ep4 -> dp2 x
ep2 and ep4, hybrid dp2 over tp2 x sp2 -> dp2 over sp2), and the
reference side is its single-device run of the same function from the
same init and tokens, which its own tests hold its sharded runs to.
Tolerances (fp32) as in ``test_torch_parallel_seq``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax", reason="parity tests need the JAX reference")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import pbs_tpu.parallel as ref_par  # noqa: E402
import pbs_tpu_torch.parallel as port_par  # noqa: E402
from pbs_tpu.models import moe as ref_moe  # noqa: E402
from pbs_tpu.models import transformer as ref_tf  # noqa: E402
from pbs_tpu.parallel import expert as ref_expert  # noqa: E402
from pbs_tpu.parallel import pipeline as ref_pipe  # noqa: E402
from pbs_tpu.parallel import sharding as ref_shard  # noqa: E402
from pbs_tpu_torch.parallel import expert as port_expert  # noqa: E402
from pbs_tpu_torch.parallel import pipeline as port_pipe  # noqa: E402
from pbs_tpu_torch.parallel import sharding as port_shard  # noqa: E402
from test_torch_parallel_ranks import rank_pool  # noqa: E402
from test_torch_parallel_seq import LOSS_REL, assert_step  # noqa: E402

torch.set_num_threads(2)

TINY = dict(vocab=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=128, max_seq=64)
TINY_MOE = dict(TINY, d_ff=96, n_experts=4, top_k=2, capacity_factor=2.0)
LR = 1e-2
RANKS = "test_torch_parallel_ranks"


def _np(tree):
    return jax.tree.map(lambda x: np.array(x, copy=True), tree)


def _jcfg(fields):
    fields = dict(fields)
    cls = ref_moe.MoEConfig if "n_experts" in fields else \
        ref_tf.TransformerConfig
    return cls(**fields, dtype=jnp.float32)


def _toks(b, s, seed=0, vocab=128):
    return np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (b, s),
                                         0, vocab))


@functools.lru_cache(maxsize=None)
def _params(fields):
    cfg = _jcfg(fields)
    init = ref_moe.init_moe_params if "n_experts" in dict(fields) else \
        ref_tf.init_params
    return _np(init(cfg, jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _reference(fields, toks_key, full_seq=False):
    """The reference's single-device loss terms and gradients at its
    init on the tokens ``toks_key`` names: ((b, s, seed, vocab))."""
    cfg = _jcfg(fields)
    toks = jnp.asarray(_toks(*toks_key))
    params = jax.tree.map(jnp.asarray, _params(fields))
    if isinstance(cfg, ref_moe.MoEConfig):
        def loss(p):
            total, (lm, aux, drop) = ref_moe.moe_loss(cfg, p, toks,
                                                      full_seq=full_seq)
            return total, {"loss": lm, "aux_loss": aux,
                           "moe_drop_frac": drop}
    else:
        def loss(p):
            lm = ref_tf.next_token_loss(cfg, p, toks, full_seq=full_seq)
            return lm, {"loss": lm}
    (_, m), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    return {k: float(v) for k, v in m.items()}, _np(grads)


def _key(d: dict):
    return tuple(sorted(d.items()))


@pytest.fixture(scope="module")
def pool():
    p = rank_pool(4)
    yield p
    p.close()


def _train(pool, family, fields, axes, toks, steps=1, grads=True, **kw):
    return pool.run(f"{RANKS}:rank_train", family, dict(fields), axes, toks,
                    _params(_key(fields)), steps, LR, grads=grads, **kw)[0]


# -- tests/test_model.py, tests/test_moe.py ---------------------------------


def test_sharded_train_matches_single_device(pool):
    """dp2 x tp2 (sequence parallelism over tp, vocab-parallel lookup and
    loss) == the single-device step: loss, gradients, a step."""
    out = _train(pool, "dense", TINY, {"dp": 2, "tp": 2}, _toks(4, 32))
    m, grads = _reference(_key(TINY), (4, 32, 0, 128))
    assert out["metrics"][0]["loss"] == pytest.approx(m["loss"],
                                                      rel=LOSS_REL)
    assert_step(out, grads, _params(_key(TINY)))


def test_sequence_parallel_pads_a_ragged_sequence(pool):
    """S=31 does not split over tp=2: the sequence is padded with masked
    positions, and the loss is still the reference's."""
    out = _train(pool, "dense", TINY, {"tp": 2, "dp": 2}, _toks(4, 31))
    m, grads = _reference(_key(TINY), (4, 31, 0, 128))
    assert out["metrics"][0]["loss"] == pytest.approx(m["loss"],
                                                      rel=LOSS_REL)
    assert_step(out, grads, _params(_key(TINY)))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_local_attention_on_an_sp_mesh_gathers_the_sequence(pool, impl):
    """A non-sequence-parallel impl on a dp2 x sp2 mesh attends over the
    whole sequence (q/k/v all-gathered over sp, as the reference's XLA
    gathers them), not block-diagonally: the reference's loss and
    gradients."""
    toks = _toks(4, 64, 7)
    out = _train(pool, "dense", dict(TINY, attn_impl=impl),
                 {"dp": 2, "sp": 2}, toks)
    m, grads = _reference(_key(TINY), (4, 64, 7, 128))
    assert out["metrics"][0]["loss"] == pytest.approx(m["loss"],
                                                      rel=LOSS_REL)
    assert_step(out, grads, _params(_key(TINY)))


def test_tp_must_divide_the_heads(pool):
    """Megatron's split keeps whole heads on a rank: tp=4 over 2 kv
    heads is refused (a departure: the reference's partitioner splits a
    head), with the pipeline's message."""
    got = pool.run(f"{RANKS}:rank_error", "make_sharded_train", {"tp": 4},
                   cfg_kw=TINY)[0]
    assert got == ("ValueError", "tp=4 must divide n_heads=4, "
                   "n_kv_heads=2, and d_ff=128")


@pytest.mark.parametrize("axes", [{"dp": 2, "ep": 2}, {"ep": 4}])
def test_expert_parallel_matches_single_device(pool, axes):
    """dp2 x ep2 (one routing group spans the dp ranks: gathered) and ep4
    (whole groups on the rank) == the single-device MoE step: loss, drop
    fraction, aux statistic, gradients, a step."""
    out = _train(pool, "moe", TINY_MOE, axes, _toks(4, 32))
    m, grads = _reference(_key(TINY_MOE), (4, 32, 0, 128))
    got = out["metrics"][0]
    assert got["loss"] == pytest.approx(m["loss"], rel=LOSS_REL)
    assert got["aux_loss"] == pytest.approx(m["aux_loss"], rel=LOSS_REL)
    assert got["moe_drop_frac"] == pytest.approx(m["moe_drop_frac"],
                                                 abs=1e-6)
    assert_step(out, grads, _params(_key(TINY_MOE)))


def test_expert_parallel_capacity_drops_match(pool):
    """Capacity routing that drops tokens (factor 0.5, groups of 31 over
    a dp2 x ep2 mesh): the same drops, loss and gradients."""
    fields = dict(TINY_MOE, capacity_factor=0.5, router_group_size=31)
    out = _train(pool, "moe", fields, {"dp": 2, "ep": 2}, _toks(4, 32))
    m, grads = _reference(_key(fields), (4, 32, 0, 128))
    got = out["metrics"][0]
    assert m["moe_drop_frac"] > 0.1
    assert got["moe_drop_frac"] == pytest.approx(m["moe_drop_frac"],
                                                 abs=1e-6)
    assert got["loss"] == pytest.approx(m["loss"], rel=LOSS_REL)
    assert_step(out, grads, _params(_key(fields)))


# -- tests/test_advice_fixes.py ----------------------------------------------


def test_reorder_hybrid_multi_axis():
    """ici={tp:4,sp:4} x dcn={dp:2,fsdp:2}: the port's reindexing is the
    reference's, and every inner block comes from one granule."""
    from pbs_tpu.parallel.multihost import _reorder_hybrid as ref_reorder
    from pbs_tpu_torch.parallel.multihost import _reorder_hybrid

    dcn_p, ici_p = (2, 2), (4, 4)
    ids = np.arange(64)
    arr = np.zeros((8, 8), dtype=int)
    for d1 in range(2):
        for d2 in range(2):
            g = d1 * 2 + d2
            block = ids[g * 16:(g + 1) * 16].reshape(4, 4)
            arr[d1 * 4:(d1 + 1) * 4, d2 * 4:(d2 + 1) * 4] = block
    out = _reorder_hybrid(arr, dcn_p, ici_p)
    np.testing.assert_array_equal(out, ref_reorder(arr, dcn_p, ici_p))
    assert out.shape == (2, 2, 4, 4)
    for d1 in range(2):
        for d2 in range(2):
            g = d1 * 2 + d2
            assert out[d1, d2].min() == g * 16
            assert out[d1, d2].max() == g * 16 + 15


def test_hybrid_mesh_trains_end_to_end(pool):
    """A dcn dp axis over an ici sp granule carries a real sharded ring
    step: axis order dcn-first, loss and gradients of the reference's
    dense loss (full sequence, last position masked)."""
    toks = _toks(4, 64, 7)
    out = _train(pool, "dense", dict(TINY, attn_impl="ring"),
                 ({"sp": 2}, {"dp": 2}), toks, mesh_kind="hybrid")
    assert out["axis_names"] == ("dp", "sp")
    m, grads = _reference(_key(TINY), (4, 64, 7, 128), full_seq=True)
    assert out["metrics"][0]["loss"] == pytest.approx(m["loss"],
                                                      rel=LOSS_REL)
    assert_step(out, grads, _params(_key(TINY)))


# -- the spec tables and the surface ------------------------------------------


@dataclasses.dataclass
class _FakeMesh:
    axis_names: tuple


def _specs(tree):
    if isinstance(tree, dict):
        return {k: _specs(v) for k, v in tree.items()}
    return tuple(tree)


@pytest.mark.parametrize("name", ["param_specs", "moe_param_specs",
                                  "moe_serving_param_specs",
                                  "pipeline_param_specs",
                                  "pipeline_param_specs_tp",
                                  "moe_pipeline_layer_specs",
                                  "moe_pipeline_layer_specs_ep"])
def test_spec_tables_are_the_reference(name):
    fns = {
        "param_specs": (ref_shard.param_specs, port_shard.param_specs, True),
        "moe_param_specs": (ref_expert.moe_param_specs,
                            port_expert.moe_param_specs, True),
        "moe_serving_param_specs": (ref_expert.moe_serving_param_specs,
                                    port_expert.moe_serving_param_specs,
                                    True),
        "pipeline_param_specs": (ref_pipe.pipeline_param_specs,
                                 port_pipe.pipeline_param_specs, True),
        "pipeline_param_specs_tp": (
            lambda c: ref_pipe.pipeline_param_specs(c, tp=True),
            lambda c: port_pipe.pipeline_param_specs(c, tp=True), True),
        "moe_pipeline_layer_specs": (ref_pipe.moe_pipeline_layer_specs,
                                     port_pipe.moe_pipeline_layer_specs,
                                     False),
        "moe_pipeline_layer_specs_ep": (
            lambda: ref_pipe.moe_pipeline_layer_specs(True),
            lambda: port_pipe.moe_pipeline_layer_specs(True), False),
    }
    ref_fn, port_fn, takes_cfg = fns[name]
    args = (None,) if takes_cfg else ()
    assert _specs(port_fn(*args)) == _specs(ref_fn(*args))


@pytest.mark.parametrize("axes", [("dp",), ("dp", "sp"), ("dp", "tp"),
                                  ("dp", "tp", "sp"), ("pp", "ep")])
def test_mesh_specs_drop_absent_axes(axes):
    """``_mesh_spec``, the batch and slot-cache shardings and the
    quantization-aware shardings: the reference's specs on every mesh
    shape (an axis the mesh lacks drops)."""
    ref_mesh = ref_par.make_mesh({a: 1 for a in axes},
                                 devices=jax.devices()[:1])
    full = ref_par.make_mesh({"dp": 1, "tp": 1, "sp": 1},
                             devices=jax.devices()[:1])
    mesh = _FakeMesh(axes)
    # The reference's raw specs (its NamedSharding refuses an absent
    # axis; the port drops it, by the _mesh_spec rule).
    batch = ref_par.batch_sharding(full).spec
    if "sp" not in axes:
        batch = ref_shard.P("dp", None)
    slot = ref_shard.slot_cache_kv_sharding(full).spec
    assert tuple(port_par.batch_sharding(mesh).spec) == tuple(
        ref_shard._mesh_spec(ref_mesh, batch))
    assert tuple(port_shard.slot_cache_kv_sharding(mesh).spec) == tuple(
        ref_shard._mesh_spec(ref_mesh, slot))
    for spec in jax.tree.leaves(
            ref_shard.param_specs(None),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)):
        port_spec = port_shard.P(*spec)
        assert tuple(port_shard._mesh_spec(mesh, port_spec)) == tuple(
            ref_shard._mesh_spec(ref_mesh, spec))
    q = {"q": np.zeros((2, 8, 4), np.int8),
         "s": np.zeros((2, 1, 4), np.float32)}
    params = {"embed": np.zeros((8, 4)), "layers": {"wq": q}}
    specs = {"embed": ref_shard.P("tp", None),
             "layers": {"wq": ref_shard.P(None, None, "tp")}}
    port_specs = {"embed": port_shard.P("tp", None),
                  "layers": {"wq": port_shard.P(None, None, "tp")}}
    got = port_shard.quant_aware_shardings(port_specs, params, mesh)
    want = ref_shard.quant_aware_shardings(specs, params, ref_mesh)
    assert jax.tree.map(lambda s: tuple(s.spec), want) == \
        {"embed": tuple(got["embed"].spec),
         "layers": {"wq": {k: tuple(v.spec)
                           for k, v in got["layers"]["wq"].items()}}}


def test_package_surface():
    assert port_par.__all__ == ref_par.__all__
    for name in port_par.__all__ + port_par.PORT_ONLY:
        assert hasattr(port_par, name), name
    from pbs_tpu_torch.sched.placement import anti_stack_pick

    assert port_par.anti_stack_pick is anti_stack_pick


def test_split_devices_is_list_arithmetic():
    from pbs_tpu.parallel.mesh import split_devices as ref_split

    devs = [torch.device("cuda", i) for i in range(8)]
    got = port_par.split_devices(4, devs)
    want = ref_split(4, list(range(8)))
    assert [[d.index for d in pool] for pool in got] == want
    with pytest.raises(ValueError) as e:
        port_par.split_devices(3, devs)
    with pytest.raises(ValueError) as r:
        ref_split(3, list(range(8)))
    assert str(e.value) == str(r.value)


def test_multihost_initialize_is_a_no_op_without_a_coordinator(monkeypatch):
    from pbs_tpu_torch.parallel import multihost

    for var in ("PBST_COORDINATOR", "MASTER_ADDR"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(multihost, "_initialized", False)
    assert multihost.initialize() is False


def test_entry_points_need_a_world_or_a_card():
    """Without an initialised world ``make_mesh`` raises; a mesh's
    device defaults to the card and raises without one."""
    from pbs_tpu_torch.parallel.mesh import rank_device

    with pytest.raises(RuntimeError, match="initialised"):
        port_par.make_mesh({"dp": 1})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            rank_device(None)
