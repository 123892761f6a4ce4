"""Tensor-parallel serving on rank processes against the reference's tp2
engine on a 2-CPU-device mesh.

Twins of ``tests/test_serving.py::test_tensor_parallel_serving_token_parity``,
``::test_moe_serving_on_tp_mesh_token_exact``,
``::test_prefix_cache_on_tp_mesh_token_exact``,
``tests/test_quant.py::test_quant_tp_mesh_token_exact``,
``::test_quant_moe_tp_mesh_token_exact`` and
``tests/test_spec_serving.py::test_spec_serving_on_tp_mesh_token_exact``.
The port runs on one module-scoped pool of two gloo CPU rank processes
(``test_torch_serve_ranks`` holds their bodies and imports no JAX): every
rank builds the engine from the same full tree, keeps its blocks and is
given the same requests. Both ranks' completions must be identical, and
rank 0's token-exact against the reference's tp2 engine on the same
weights (the reference's init carried across); one prefill's logits
agree within rtol = atol = 1e-4 (two frameworks' fp32 reductions, as in
``test_torch_serving``). ``ShardedServeBackend`` at tp2 and at dp2
behind a virtual-clock gateway gives the reference backend's stats key
for key and its gathered tree back byte for byte. Ranks that are given
different requests fail with the tick named, on every rank.
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax", reason="parity tests need the JAX reference")
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402

from pbs_tpu import models as ref  # noqa: E402
from pbs_tpu.models.moe import moe_slot_mlp as ref_moe_slot_mlp  # noqa: E402
from pbs_tpu.parallel import make_mesh as ref_make_mesh  # noqa: E402
from pbs_tpu_torch.parallel.launch import RankPool  # noqa: E402

RANKS = "test_torch_serve_ranks"
RTOL = ATOL = 1e-4

DENSE = dict(vocab=64, d_model=32, n_layers=2, n_heads=2, n_kv_heads=2,
             d_ff=64, max_seq=128)
WIDE = dict(vocab=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=128, max_seq=128)
MOE = dict(DENSE, n_experts=4, top_k=2, dropless=True,
           router_group_size=8)
MOE_INT8 = dict(WIDE, d_ff=64, max_seq=64, n_experts=4, top_k=2,
                dropless=True, router_group_size=8)


@pytest.fixture(scope="module")
def pool():
    from pathlib import Path

    p = RankPool(2, backend="gloo", device="cpu",
                 env={"PYTHONPATH": str(Path(__file__).resolve().parent)})
    yield p
    p.close()


@pytest.fixture(autouse=True)
def _no_world_left():
    yield
    assert not dist.is_initialized()


def _np(tree):
    return jax.tree.map(lambda x: np.array(x, copy=True), tree)


def _jcfg(fields):
    cls = ref.MoEConfig if "n_experts" in fields else ref.TransformerConfig
    return cls(**fields, dtype=jnp.float32)


def _tree(fields, quant=False, seed=0):
    cfg = _jcfg(fields)
    init = ref.init_moe_params if "n_experts" in fields else ref.init_params
    tree = init(cfg, jax.random.PRNGKey(seed))
    return ref.quantize_weights(tree) if quant else tree


def _ref_engine(fields, tree, engine_kw, draft=None):
    cfg = _jcfg(fields)
    kw = dict(engine_kw, mesh=ref_make_mesh({"tp": 2},
                                            devices=jax.devices()[:2]))
    if "n_experts" in fields:
        kw["mlp_fn"] = ref_moe_slot_mlp(cfg)
    if draft is not None:
        return ref.SpeculativeBatcher(cfg, tree, cfg, draft, **kw)
    return ref.ContinuousBatcher(cfg, tree, **kw)


def _ref_run(eng, phases, probe=None):
    out = {"phases": []}
    if probe is not None:
        padded = np.zeros(eng.bucket, np.int32)
        padded[:len(probe)] = probe
        out["logits"] = np.asarray(eng._prefill_fn(
            eng.params, eng.cache, 0, jnp.asarray(padded), len(probe),
            jax.random.PRNGKey(0))[1])
    for phase in phases:
        rids = [eng.submit(p, n) for p, n in phase]
        got = {}
        for _ in range(500):
            for c in eng.step():
                got[c.request_id] = c.tokens
            if not eng.has_work():
                break
        out["phases"].append([got[r] for r in rids])
    out["prefill_count"] = eng.prefill_count
    out["prefix_hits"] = eng.prefix_hits
    return out


#: (case, fields, int8, phases, engine kw, probe): the reference tests'
#: scripts. "prefix" submits one prompt twice, the second time after
#: the first completed: a prefix-cache hit.
CASES = [
    ("dense", DENSE, False, [[([3, 1, 4], 6), ([15, 9, 2, 6], 6)]],
     dict(n_slots=2, prompt_bucket=16), [3, 1, 4]),
    ("int8", WIDE, True, [[([1, 2, 3], 6), ([9, 8, 7, 6], 5)]],
     dict(n_slots=2, prompt_bucket=8, max_len=32), [1, 2, 3]),
    ("moe", MOE, False, [[([5, 9, 2, 31, 7], 8)]],
     dict(n_slots=2, prompt_bucket=16), [5, 9, 2, 31, 7]),
    ("moe_int8", MOE_INT8, True, [[([1, 2, 3], 5)]],
     dict(n_slots=2, prompt_bucket=8, max_len=32), [1, 2, 3]),
    ("prefix", DENSE, False, [[([3, 1, 4], 6)], [([3, 1, 4], 6)]],
     dict(n_slots=2, prompt_bucket=16, prefix_cache_size=4), None),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_tp2_engine_token_exact_against_the_reference(pool, case):
    name, fields, quant, phases, kw, probe = case
    tree = _tree(fields, quant)
    got = pool.run(f"{RANKS}:rank_engine", fields, _np(tree), phases, kw,
                   probe=probe)
    want = _ref_run(_ref_engine(fields, tree, kw), phases, probe)
    assert got[0]["phases"] == got[1]["phases"]
    assert got[0]["phases"] == want["phases"], name
    half = fields["n_kv_heads"] // 2
    assert [r["local_kv_heads"] for r in got] == [half, half]
    assert got[0]["prefill_count"] == want["prefill_count"]
    if probe is not None:
        np.testing.assert_allclose(got[0]["logits"], want["logits"],
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(got[0]["logits"], got[1]["logits"])
    if name == "prefix":
        assert got[0]["prefill_count"] == 1
        assert got[0]["stats"]["prefix_hits"] == 1 == want["prefix_hits"]
        assert got[0]["phases"][0] == got[0]["phases"][1]
    if name.startswith("moe"):
        assert got[0]["stats"]["mlp_extra_mean"] == 0.0  # dropless


def test_tp2_speculative_engine_token_exact(pool):
    """The target and the draft tree both take the tp placement."""
    cfg = _jcfg(WIDE)
    params = ref.init_params(cfg, jax.random.PRNGKey(0))
    noise = jax.random.normal(jax.random.PRNGKey(7), params["head"].shape)
    dparams = dict(params, head=params["head"] + 0.01 * noise)
    phases = [[([1, 2, 3], 8), ([9, 8, 7, 6], 8)]]
    kw = dict(k=3, n_slots=2, prompt_bucket=8, max_len=64)
    got = pool.run(f"{RANKS}:rank_engine", WIDE, _np(params), phases, kw,
                   draft_tree=_np(dparams))
    want = _ref_run(_ref_engine(WIDE, params, kw, draft=dparams), phases)
    assert got[0]["phases"] == got[1]["phases"] == want["phases"]


@pytest.mark.parametrize("tp,dp", [(2, 1), (1, 2)], ids=["tp2", "dp2"])
def test_sharded_backend_matches_the_reference(pool, tp, dp):
    """``ShardedServeBackend`` behind a virtual-clock gateway on both
    ranks: the reference backend's stats key for key (the mesh, the
    full tree's leaves and bytes, the SLO percentiles in virtual time),
    the same completions on both ranks, the input tree gathered back
    byte for byte."""
    from pbs_tpu.gateway import Gateway, TenantQuota
    from pbs_tpu.serve import ShardedServeBackend
    from pbs_tpu.utils.clock import MS, VirtualClock

    tree = _tree(WIDE)
    kw = dict(n_slots=2, prompt_bucket=8, max_len=32, seed=0)
    got = pool.run(f"{RANKS}:rank_backend", WIDE, _np(tree), tp, dp, 6, kw)
    be = ShardedServeBackend("s0", _jcfg(WIDE), tree, tp=tp, dp=dp,
                             clock="virtual", **kw)
    clock = VirtualClock()
    gw = Gateway([be], clock=clock,
                 quotas={"t": TenantQuota(rate=1000.0, burst=256.0,
                                          slo="interactive",
                                          max_queued=64)})
    for i in range(6):
        assert gw.submit("t", {"i": i}, cost=1 + i % 4).admitted
    done = []
    while gw.busy():
        done += gw.tick()
        clock.advance(MS)
    want = sorted((rid, info["tokens"], info["ttft_ns"], info["service_ns"])
                  for rid, info in done)
    for r in got:
        assert not r["busy"] and r["gathered_equal"]
        assert r["done"] == [tuple(d) for d in want]
        assert r["stats"] == be.stats()
        assert r["local_embed_rows"] == WIDE["vocab"] // tp
    assert got[0]["stats"]["mesh"] == {"dp": dp, "tp": tp}


@pytest.mark.parametrize("idle", [False, True], ids=["extra", "idle"])
def test_diverged_ranks_fail_naming_the_tick(pool, idle):
    """A rank given one request more, or a rank with nothing to do while
    the other steps, fails the tick's check on every rank, with the tick
    named, instead of leaving the other waiting in an exchange."""
    kw = dict(n_slots=2, prompt_bucket=8, max_len=32)
    got = pool.run(f"{RANKS}:rank_diverge", DENSE, _np(_tree(DENSE)), kw,
                   idle)
    where = "engine tick 0" if idle else "engine tick 1"
    for msg in got:
        assert f"tp ranks diverged at {where}" in msg, msg
