"""``pbs_tpu_torch.serve`` against ``pbs_tpu.serve``: twins of
``tests/test_serve.py``.

The rule table, its audit, positional specs, the unmatched-leaf error,
the shard/gather round trip, payload synthesis, the knobs and the
``serve`` command run through both packages and must agree (the command
with ``--device cpu``). The chaos harnesses run with each package's
serve backends on the reference's TINY model, the port's weights the
reference's ``init_params`` tree carried across by ``params_from_numpy``:
the trace and report digests and every key of ``report["serve"]`` must
equal the reference harness's run with the reference backend. The
disaggregated backend's span chain, the disarmed goldens and
``crash_plan`` refusing ``serve=`` are the reference's cases. Port-only:
a 1x1 serving mesh needs no ``torch.distributed`` world and leaves none
behind, a larger one is refused without a world, a handed-off window is
a copy, and the MoE rule table is clean against the MoE tree.
"""

from __future__ import annotations

import functools
import json
import re

import numpy as np
import pytest

jax = pytest.importorskip("jax", reason="parity tests need the JAX reference")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from pbs_tpu import models as ref_models  # noqa: E402
from pbs_tpu import serve as ref_serve  # noqa: E402
from pbs_tpu.gateway import run_federation_chaos as ref_fed  # noqa: E402
from pbs_tpu.gateway import run_gateway_chaos as ref_gw  # noqa: E402
from pbs_tpu.serve import partition as ref_part  # noqa: E402
from pbs_tpu_torch import models as port_models  # noqa: E402
from pbs_tpu_torch import serve as port_serve  # noqa: E402
from pbs_tpu_torch.gateway import Gateway, TenantQuota  # noqa: E402
from pbs_tpu_torch.gateway import (  # noqa: E402
    run_federation_chaos as port_fed,
)
from pbs_tpu_torch.gateway import run_gateway_chaos as port_gw  # noqa: E402
from pbs_tpu_torch.obs.spans import SpanAssembler, SpanRecorder  # noqa: E402
from pbs_tpu_torch.serve.partition import (  # noqa: E402
    PARTITION_RULES,
    TEMPLATE_PATHS,
    audit_rules,
    iter_leaf_paths,
    make_serve_mesh,
    make_shard_and_gather_fns,
    match_partition_rules,
    resolve_spec,
)
from pbs_tpu_torch.utils.clock import MS, VirtualClock  # noqa: E402

torch.set_num_threads(2)

TINY = dict(vocab=64, d_model=16, n_layers=1, n_heads=2, n_kv_heads=1,
            d_ff=32, max_seq=64)
CHAOS_KW = dict(workload="mixed", seed=3, n_backends=3, n_tenants=3,
                ticks=60)
FED_KW = dict(workload="mixed", seed=0, n_gateways=3, n_tenants=4,
              ticks=240)


@pytest.fixture(autouse=True)
def _no_world_left():
    """No case may leave a default process group in this process: a
    later case on the same worker asserts that ``make_mesh`` raises
    without one."""
    yield
    assert not dist.is_initialized()


@pytest.fixture(scope="module")
def rcfg():
    return ref_models.TransformerConfig(**TINY, dtype=jnp.float32)


@pytest.fixture(scope="module")
def cfg():
    return port_models.TransformerConfig(**TINY, dtype=torch.float32)


@functools.lru_cache(maxsize=None)
def _ref_tree(seed: int) -> dict:
    rcfg = ref_models.TransformerConfig(**TINY, dtype=jnp.float32)
    tree = ref_models.init_params(rcfg, jax.random.PRNGKey(seed))
    return jax.tree.map(lambda x: np.array(x, copy=True), tree)


def _params(seed: int = 0) -> dict:
    """The reference's ``init_params`` tree at ``seed``, on the host."""
    return port_models.params_from_numpy(_ref_tree(seed), "cpu")


@pytest.fixture(scope="module")
def params():
    return _params(0)


def _kw(seed):
    return dict(tp=1, dp=1, n_slots=2, prompt_bucket=8, max_len=32,
                seed=seed, clock="virtual")


def _disagg_kw(seed):
    return dict(_kw(seed), n_slots=4)


def port_factory(cls, kw_of, cfg):
    def factory(name, seed):
        return cls(name, cfg, _params(seed), device="cpu", **kw_of(seed))
    return factory


def ref_factory(cls, kw_of, rcfg):
    def factory(name, seed):
        return cls(name, rcfg, **kw_of(seed))
    return factory


# -- the rule table ----------------------------------------------------------


def test_rule_table_is_the_reference_s():
    assert PARTITION_RULES == ref_part.PARTITION_RULES
    assert TEMPLATE_PATHS == ref_part.TEMPLATE_PATHS


def test_every_leaf_matches_exactly_one_rule(params):
    for path, _leaf in iter_leaf_paths(params):
        hits = [pat for pat, _ in PARTITION_RULES
                if re.search(pat, path)]
        assert len(hits) == 1, f"{path}: matched {hits}"


def test_template_paths_pin_the_param_tree(params):
    actual = tuple(p for p, _ in iter_leaf_paths(params))
    assert sorted(actual) == sorted(TEMPLATE_PATHS)
    assert actual == tuple(p for p, _ in
                           ref_part.iter_leaf_paths(_ref_tree(0)))


def test_audit_is_clean():
    audit = audit_rules(PARTITION_RULES)
    assert audit == {"dead": [], "shadowed": [], "uncovered": []}
    bad = PARTITION_RULES + ((r"/nothing$", ()), (r"/wq$", ()))
    assert audit_rules(bad) == ref_part.audit_rules(bad)


def test_moe_rule_table_is_clean_against_the_moe_tree():
    """Port-only: the MoE tree's table covers every leaf of
    ``init_moe_params`` exactly once and places it as the engine's MoE
    serving table does."""
    from pbs_tpu_torch.models.moe import MoEConfig, init_moe_params
    from pbs_tpu_torch.serve.backend import MOE_PARTITION_RULES

    mcfg = MoEConfig(**TINY, dtype=torch.float32, n_experts=4, top_k=2)
    tree = init_moe_params(mcfg, torch.Generator().manual_seed(0),
                           device="cpu")
    paths = [p for p, _ in iter_leaf_paths(tree)]
    assert audit_rules(MOE_PARTITION_RULES, paths) == {
        "dead": [], "shadowed": [], "uncovered": []}
    for path in paths:
        assert sum(bool(re.search(pat, path))
                   for pat, _ in MOE_PARTITION_RULES) == 1, path


def test_every_rule_claims_a_leaf(params):
    paths = [p for p, _ in iter_leaf_paths(params)]
    for pat, _spec in PARTITION_RULES:
        assert any(re.search(pat, p) for p in paths), \
            f"rule {pat!r} claims no leaf of the flagship tree"


def test_unmatched_leaf_is_a_hard_error(params):
    bad = dict(params, mystery=torch.ones((4, 4)))
    with pytest.raises(ValueError, match="mystery") as e:
        match_partition_rules(PARTITION_RULES, bad)
    with pytest.raises(ValueError) as r:
        ref_part.match_partition_rules(
            ref_part.PARTITION_RULES,
            dict(_ref_tree(0), mystery=np.ones((4, 4), np.float32)))
    assert str(e.value) == str(r.value)


def test_scalar_leaves_are_unpartitioned():
    tree = {"embed": torch.ones((8, 4)), "step": torch.tensor(0.0)}
    specs = match_partition_rules(PARTITION_RULES, tree)
    assert specs["step"] == ()
    assert specs == ref_part.match_partition_rules(
        ref_part.PARTITION_RULES, {"embed": np.ones((8, 4)),
                                   "step": np.float32(0.0)})


def test_resolve_spec_positional_semantics():
    mesh = make_serve_mesh(tp=1, dp=1, device="cpu")
    rmesh = ref_part.make_serve_mesh(tp=1, dp=1)
    assert mesh.axis_names == rmesh.axis_names
    for raw in ((-1, None), (0,), ((0, 1), None), ()):
        assert tuple(resolve_spec(mesh, raw)) == \
            tuple(ref_part.resolve_spec(rmesh, raw))
    with pytest.raises(ValueError, match="out of range") as e:
        resolve_spec(mesh, (7,))
    with pytest.raises(ValueError) as r:
        ref_part.resolve_spec(rmesh, (7,))
    assert str(e.value) == str(r.value)


def test_serve_mesh_needs_no_world_and_a_larger_one_needs_the_world():
    """Port-only: 1x1 is this process alone (no process group made);
    tp=2 without a world is refused, shaped like the reference's
    refusal of a mesh larger than its devices."""
    mesh = make_serve_mesh(tp=1, dp=1, device="cpu")
    assert mesh.shape == {"dp": 1, "tp": 1}
    assert mesh.device == torch.device("cpu")
    assert not dist.is_initialized()
    with pytest.raises(ValueError,
                       match=r"serve mesh dp=1 x tp=2 needs 2 ranks, "
                             r"have 1"):
        make_serve_mesh(tp=2, dp=1, device="cpu")
    with pytest.raises(ValueError,
                       match=r"serve mesh dp=1 x tp=16 needs 16 devices"):
        ref_part.make_serve_mesh(tp=16, dp=1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_serve_mesh(tp=1, dp=1)  # the card by default


# -- shard / gather ----------------------------------------------------------


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_shard_gather_roundtrip_byte_identical(params, quant):
    tree = port_models.quantize_weights(params) if quant else params
    mesh = make_serve_mesh(tp=1, dp=1, device="cpu")
    shard, gather = make_shard_and_gather_fns(tree, mesh)
    back = gather(shard(tree))
    flat_a = [p for p in iter_leaf_paths(tree)]
    flat_b = [p for p in iter_leaf_paths(back)]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    from pbs_tpu_torch.models.transformer import tree_leaves

    for a, b in zip(tree_leaves(tree), tree_leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.numpy().tobytes() == b.numpy().tobytes()


def test_backend_gathers_the_tree_it_was_given(cfg, params):
    """``gather_params`` is the input tree byte for byte; ``stats``
    counts the full tree as the reference does."""
    be = port_serve.ShardedServeBackend("s0", cfg, params, device="cpu",
                                        **_kw(0))
    back = be.gather_params()
    for (pa, a), (pb, b) in zip(iter_leaf_paths(params),
                                iter_leaf_paths(back)):
        assert pa == pb and a.numpy().tobytes() == b.numpy().tobytes()
    st = be.stats()
    ref_st = ref_serve.ShardedServeBackend(
        "s0", ref_models.TransformerConfig(**TINY, dtype=jnp.float32),
        **_kw(0)).stats()
    for key in ("mesh", "param_leaves", "param_bytes"):
        assert st[key] == ref_st[key], key
    assert st["mesh"] == {"dp": 1, "tp": 1}


# -- the serve backends under the chaos harnesses ----------------------------

BACKENDS = {
    "sharded": (port_serve.ShardedServeBackend, ref_serve.ShardedServeBackend,
                _kw),
    "disagg": (port_serve.DisaggServeBackend, ref_serve.DisaggServeBackend,
               _disagg_kw),
}


@pytest.mark.parametrize("kind", list(BACKENDS))
def test_gateway_chaos_matches_the_reference(kind, cfg, rcfg):
    port_cls, ref_cls, kw_of = BACKENDS[kind]
    r = port_gw(serve=port_factory(port_cls, kw_of, cfg), **CHAOS_KW)
    want = ref_gw(serve=ref_factory(ref_cls, kw_of, rcfg), **CHAOS_KW)
    assert r["problems"] == [] and r["ok"] is True
    assert r["trace_digest"] == want["trace_digest"]
    assert r["serve"] == want["serve"]
    st = r["stats"]
    assert st["admitted"] == st["completed"] > 0
    sv = r["serve"]
    assert sv["completed"] > 0 and sv["bypass_submits"] == 0
    assert sv["synth_dispatches"] == sv["completed"]
    assert r["killed_backend"] == "b0"
    if kind == "disagg":
        assert sv["handoffs"] == sv["completed"]
        assert sv["decode_pool_prefills"] == 0


@pytest.mark.parametrize("kind", list(BACKENDS))
def test_federation_chaos_matches_the_reference(kind, cfg, rcfg):
    port_cls, ref_cls, kw_of = BACKENDS[kind]
    r = port_fed(serve=port_factory(port_cls, kw_of, cfg), **FED_KW)
    want = ref_fed(serve=ref_factory(ref_cls, kw_of, rcfg), **FED_KW)
    assert r["problems"] == [] and r["ok"] is True
    assert r["trace_digest"] == want["trace_digest"]
    assert r["report_digest"] == want["report_digest"]
    assert r["serve"] == want["serve"]
    assert r["serve"][0]["completed"] > 0
    if kind == "disagg":
        assert r["serve"][0]["decode_pool_prefills"] == 0


def test_sharded_backend_chaos_same_seed_same_digest(cfg):
    factory = port_factory(port_serve.ShardedServeBackend, _kw, cfg)
    a = port_gw(serve=factory, **CHAOS_KW)
    b = port_gw(serve=factory, **CHAOS_KW)
    assert a["trace_digest"] == b["trace_digest"]
    assert a["serve"] == b["serve"]
    assert a["stats"]["shed"] == b["stats"]["shed"]


# -- handoff span stitching --------------------------------------------------


def test_disagg_handoff_span_chain(cfg, params):
    """One stitched chain per request across the prefill->decode
    handoff validates gap-free under the assembler's state machine."""
    clock = VirtualClock()
    spans = SpanRecorder(capacity=4096)
    backend = port_serve.DisaggServeBackend(
        "d0", cfg, params, tp=1, dp=1, n_slots=2, prompt_bucket=8,
        max_len=32, seed=0, clock="virtual", device="cpu")
    gw = Gateway([backend], clock=clock, spans=spans,
                 quotas={"t": TenantQuota(rate=1000.0, burst=64.0,
                                          slo="interactive",
                                          max_queued=64)})
    rids = []
    for i in range(4):
        res = gw.submit("t", {"i": i}, cost=2)
        assert res.admitted
        rids.append(res.rid)
    for _ in range(400):
        if not gw.busy():
            break
        gw.tick()
        clock.advance(MS)
    assert not gw.busy()
    assert backend.stats()["handoffs"] == 4
    assert backend.stats()["decode_pool_prefills"] == 0
    recs = spans.drain()
    asm = SpanAssembler(recs, spans.rid_table(), spans.member_table(),
                        spans.tenant_table())
    assert asm.validate(rids) == []


def test_handed_off_windows_are_copies(cfg, params):
    """Port-only: a prefilled window waiting in the handoff queue keeps
    its KV when the next prompt is ingested into the same lane (the
    slab is updated in place)."""
    pool = port_serve.PrefillPool(cfg, params, n_lanes=1, bucket=8,
                                  max_len=32, device="cpu")
    logits, kwin, vwin = pool.prefill(params, np.array([3, 1, 4],
                                                       np.int32))
    kept = (logits.clone(), kwin.clone(), vwin.clone())
    pool.prefill(params, np.array([9, 9, 9, 9, 9], np.int32))
    for a, b in zip((logits, kwin, vwin), kept):
        assert torch.equal(a, b)
    assert not torch.equal(kwin, pool.cache["k"][:, 0:1, :8])


# -- disarmed goldens --------------------------------------------------------

#: The reference test's constants (tests/test_serve.py): serve=None must
#: keep them byte-identical in the port too.
GOLDEN_GATEWAY_DIGEST = (
    "4ef79af3bcb1dcf7b03cad1cd27a91b61f6560f6ea6db0085e504bb08eff5737")
GOLDEN_FED_TRACE_DIGEST = (
    "71a188673b85cf80a67a721b247443d22e3776a09ad491fc6a5356553218d6de")
GOLDEN_FED_REPORT_DIGEST = (
    "1ba265a705067e8d8761aaa8d57c23b30e38c25839b29c9f1debf380b5667242")


def test_disarmed_gateway_golden_byte_identical():
    r = port_gw(workload="mixed", seed=0, n_backends=3, n_tenants=4,
                ticks=160, serve=None)
    assert r["trace_digest"] == GOLDEN_GATEWAY_DIGEST
    assert "serve" not in r


def test_disarmed_federation_golden_byte_identical():
    r = port_fed(workload="mixed", seed=0, n_gateways=3, n_tenants=4,
                 ticks=240, serve=None)
    assert r["trace_digest"] == GOLDEN_FED_TRACE_DIGEST
    assert r["report_digest"] == GOLDEN_FED_REPORT_DIGEST
    assert "serve" not in r


def test_serve_crash_plan_mutually_exclusive(cfg, rcfg):
    with pytest.raises(ValueError, match="serve") as e:
        port_fed(serve=port_factory(port_serve.ShardedServeBackend, _kw,
                                    cfg), crash_plan=[{"tick": 5}])
    with pytest.raises(ValueError) as r:
        ref_fed(serve=ref_factory(ref_serve.ShardedServeBackend, _kw,
                                  rcfg), crash_plan=[{"tick": 5}])
    assert str(e.value) == str(r.value)


# -- synthesis, knobs, CLI ---------------------------------------------------


def test_synth_payload_deterministic_and_bounded():
    class R:
        rid = "gw0-17"
        cost = 9

    a = port_serve.synth_payload(R(), bucket=8, max_len=32, vocab=64)
    assert a == port_serve.synth_payload(R(), bucket=8, max_len=32,
                                         vocab=64)
    assert a == ref_serve.synth_payload(R(), bucket=8, max_len=32,
                                        vocab=64)
    prompt, max_new = a
    assert 1 <= len(prompt) <= 8
    assert all(1 <= t < 64 for t in prompt)
    assert 1 <= max_new <= 32 - 8 - 1
    assert len(prompt) + max_new <= 32


def test_serve_knobs_declared():
    from pbs_tpu.knobs import registry as ref_knobs
    from pbs_tpu_torch.knobs import registry as knobs

    for name in ("serve.backend.decode_slots",
                 "serve.disagg.pool_split_ratio",
                 "serve.disagg.prefill_chunk_tokens",
                 "serve.disagg.kv_handoff_batch"):
        assert knobs.default(name) == ref_knobs.default(name), name
    assert knobs.default("serve.backend.decode_slots") == 4


def _cli(main, argv, capsys) -> dict:
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out)


def test_cli_serve_stats_and_demo(capsys):
    from pbs_tpu.cli.pbst import main as ref_main
    from pbs_tpu_torch.cli.pbst import main

    out = _cli(main, ["serve", "stats"], capsys)
    assert out["audit"] == {"dead": [], "shadowed": [], "uncovered": []}
    assert len(out["rules"]) == len(PARTITION_RULES)
    assert out == _cli(ref_main, ["serve", "stats"], capsys)

    for extra, key in (([], "bypass_submits"),
                       (["--disagg"], "decode_pool_prefills")):
        argv = ["serve", "demo", "--requests", "4", *extra]
        out = _cli(main, argv + ["--device", "cpu"], capsys)
        want = _cli(ref_main, argv, capsys)
        assert out["completions"] == 4 == want["completions"]
        assert out["serve"][key] == 0
        assert sorted(out["serve"]) == sorted(want["serve"])
        assert sorted(out) == sorted(want)
        for k in ("completed", "tokens_emitted", "synth_dispatches",
                  "param_bytes", "mesh", "prefix_hits"):
            if k in want["serve"]:
                assert out["serve"][k] == want["serve"][k], k
