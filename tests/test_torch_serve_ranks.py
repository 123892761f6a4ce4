"""Rank-side bodies of the tensor-parallel serving twins
(``tests/test_torch_serve_tp.py``).

The ``rank_*`` functions run inside the rank processes of a
:class:`pbs_tpu_torch.parallel.launch.RankPool` (``pool.run(
"test_torch_serve_ranks:rank_engine", ...)``), so this module imports
torch and the port only — never JAX. Every rank builds the same engine
or backend from the same full tree (numpy, carried across by
``params_from_numpy``), keeps its blocks, is given the same requests in
the same order, and returns what it served; the twins check that the
ranks agree and hold rank 0 to the reference.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist


def _cfg(cfg_kw: dict):
    from pbs_tpu_torch.models import MoEConfig, TransformerConfig

    cls = MoEConfig if "n_experts" in cfg_kw else TransformerConfig
    return cls(**cfg_kw, dtype=torch.float32)


def _engine(cfg_kw: dict, tree, engine_kw: dict, draft_tree=None):
    """The engine on a tp mesh over the whole world, from the full
    tree; an MoE config serves through ``moe_slot_mlp``; a draft tree
    makes it the speculative engine."""
    from pbs_tpu_torch.models import params_from_numpy
    from pbs_tpu_torch.models.moe import moe_slot_mlp
    from pbs_tpu_torch.models.serving import (ContinuousBatcher,
                                              SpeculativeBatcher)
    from pbs_tpu_torch.serve.partition import make_serve_mesh

    cfg = _cfg(cfg_kw)
    mesh = make_serve_mesh(tp=dist.get_world_size(), dp=1, device="cpu")
    params = params_from_numpy(tree, "cpu")
    kw = dict(engine_kw, mesh=mesh)
    if "n_experts" in cfg_kw:
        kw["mlp_fn"] = moe_slot_mlp(cfg)
    if draft_tree is not None:
        return SpeculativeBatcher(cfg, params, cfg,
                                  params_from_numpy(draft_tree, "cpu"),
                                  **kw)
    return ContinuousBatcher(cfg, params, **kw)


def drain(eng, max_ticks: int = 500) -> dict:
    got = {}
    for _ in range(max_ticks):
        for c in eng.step():
            got[c.request_id] = c.tokens
        if not eng.has_work():
            break
    assert not eng.has_work(), "engine did not drain"
    return got


def rank_engine(cfg_kw: dict, tree, phases: list, engine_kw: dict,
                draft_tree=None, probe=None) -> dict:
    """Each phase's requests ((prompt, max_new) pairs) submitted, then
    the engine drained; returns the tokens by phase in submit order,
    the engine's counters, and, with ``probe`` (a prompt), the
    last-position logits of its prefill into slot 0 of the fresh
    engine (fp32 numpy)."""
    eng = _engine(cfg_kw, tree, engine_kw, draft_tree)
    out = {"rank": dist.get_rank(), "phases": []}
    if probe is not None:
        padded = np.zeros(eng.bucket, np.int32)
        padded[:len(probe)] = probe
        out["logits"] = eng._prefill(0, padded, len(probe))[1].numpy().copy()
        eng.cache["pos"][0] = 0
    for phase in phases:
        rids = [eng.submit(p, n) for p, n in phase]
        got = drain(eng)
        out["phases"].append([got[r] for r in rids])
    st = eng.stats()
    out["stats"] = {k: st[k] for k in ("completed", "tokens_emitted",
                                       "prefix_hits", "prefix_misses",
                                       "mlp_extra_mean")}
    out["prefill_count"] = eng.prefill_count
    out["local_kv_heads"] = int(eng.cache["k"].shape[3])
    return out


def rank_backend(cfg_kw: dict, tree, tp: int, dp: int, n_requests: int,
                 backend_kw: dict) -> dict:
    """``ShardedServeBackend(tp, dp)`` behind a virtual-clock gateway,
    fed ``n_requests`` prompt-less requests (the backend synthesizes
    them from the rid) and ticked until drained; returns the gateway's
    completions, the backend's stats and whether ``gather_params``
    gives back the input tree byte for byte."""
    from pbs_tpu_torch.gateway import Gateway, TenantQuota
    from pbs_tpu_torch.models import params_from_numpy
    from pbs_tpu_torch.serve import ShardedServeBackend
    from pbs_tpu_torch.utils.clock import MS, VirtualClock

    params = params_from_numpy(tree, "cpu")
    be = ShardedServeBackend("s0", _cfg(cfg_kw), params, tp=tp, dp=dp,
                             clock="virtual", device="cpu", **backend_kw)
    clock = VirtualClock()
    gw = Gateway([be], clock=clock,
                 quotas={"t": TenantQuota(rate=1000.0, burst=256.0,
                                          slo="interactive",
                                          max_queued=64)})
    for i in range(n_requests):
        assert gw.submit("t", {"i": i}, cost=1 + i % 4).admitted
    done = []
    for _ in range(500):
        if not gw.busy():
            break
        done += gw.tick()
        clock.advance(MS)
    back = be.gather_params()
    same = all(
        a.numpy().tobytes() == b.numpy().tobytes()
        for a, b in zip(_leaves(params), _leaves(back)))
    return {"rank": dist.get_rank(), "busy": gw.busy(),
            "done": sorted((rid, info["tokens"], info["ttft_ns"],
                            info["service_ns"]) for rid, info in done),
            "stats": be.stats(), "gathered_equal": same,
            "local_embed_rows": int(be.engine.params["embed"].shape[0])}


def _leaves(tree):
    from pbs_tpu_torch.models.transformer import tree_leaves

    return tree_leaves(tree)


def rank_diverge(cfg_kw: dict, tree, engine_kw: dict, idle: bool) -> str:
    """Ranks given different submissions: rank 1 submits one request
    more (``idle``: rank 1 submits nothing and polls a backend that has
    no work). Returns the error every rank raised at the tick that
    caught it."""
    from pbs_tpu_torch.gateway.fairqueue import Request
    from pbs_tpu_torch.serve import ShardedServeBackend

    me = dist.get_rank()
    if idle:
        from pbs_tpu_torch.models import params_from_numpy

        be = ShardedServeBackend("s0", _cfg(cfg_kw),
                                 params_from_numpy(tree, "cpu"),
                                 tp=dist.get_world_size(), clock="virtual",
                                 device="cpu", **engine_kw)
        if me == 0:
            be.dispatch_request(Request(rid="r0", tenant="t",
                                        slo="interactive", cost=2,
                                        payload={}, submit_ns=0), 0)
        try:
            be.poll(0)
        except RuntimeError as e:
            return str(e)
        return "no error"
    eng = _engine(cfg_kw, tree, engine_kw)
    eng.submit([1, 2, 3], 4)
    eng.step()
    if me == 1:
        eng.submit([4, 5], 4)
    try:
        eng.step()
    except RuntimeError as e:
        return str(e)
    return "no error"
