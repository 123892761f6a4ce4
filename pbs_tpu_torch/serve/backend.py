"""``ShardedServeBackend``: a real partitioned transformer behind the
gateway's duck-typed :class:`~pbs_tpu_torch.gateway.backends.Backend`
surface.

The port of ``pbs_tpu.serve.backend``. This backend owns the whole
serving bring-up — rule-table parameter partitioning
(serve/partition.py), mesh construction, the
:class:`~pbs_tpu_torch.models.serving.ContinuousBatcher` slot engine —
and exposes it as just another backend, journal- and SLO-visible like
the sims. Per-stage span coverage rides the ``exec_hook`` seam: one
EXEC record when the prompt enters the prefill pipeline (the inherited
``BatcherBackend`` wiring), one when the request wins a decode slot,
one at retirement — repeated EXECs while inflight are legal span
transitions (obs/spans._NEXT_STATE), so a request's timeline shows
where inside the backend its time went.

Two clock modes: ``clock="wall"`` (default) for real benchmarks;
``clock="virtual"`` slaves the engine's latency accounting to the
``now_ns`` the harness passes into ``dispatch_request``/``poll``, so
chaos runs are deterministic and same-seed-same-digest holds with a
real model in the loop.

Catalog requests (``{"tick": ...}`` payloads with a cost attribute)
are served too: a deterministic prompt is synthesized from the request
id and ``max_new`` tokens from its cost, so one decode token per
gateway tick keeps service time cost-proportional — the same shape the
sim backends present to the fairness machinery.

Where the port parts from the reference: ``device=`` (None means the
card) places the engine; ``params=None`` draws the tree from
``init_params`` under a ``torch.Generator`` seeded with ``seed`` (not
JAX's PRNG). Under ``tp > 1`` every rank process builds the backend
from the same full tree behind its own gateway, and those gateways must
hand it the same requests at the same ticks (virtual clocks): ``poll``
checks that every rank is at the same engine tick with the same
submissions, and raises naming the tick when one is not. A tree with an
MoE router is served too (the reference's table places the dense tree
only): it takes :data:`MOE_PARTITION_RULES` and the engine
``moe_slot_mlp(cfg)``.
"""

from __future__ import annotations

import zlib

from pbs_tpu_torch import knobs
from pbs_tpu_torch.gateway.backends import BatcherBackend
from pbs_tpu_torch.gateway.fairqueue import Request

#: Default decode-slot count (declared knob; the autopilot can canary
#: it like any scheduler knob).
DECODE_SLOTS = knobs.default("serve.backend.decode_slots")

#: The MoE serving tree's rule table (port-only): attention as in the
#: flagship table, the router replicated, the expert FFNs' d_ff
#: column/row-parallel over the innermost (tensor) axis — the layout of
#: ``parallel.expert.moe_serving_param_specs``, restated positionally.
MOE_PARTITION_RULES: tuple[tuple[str, tuple], ...] = (
    (r"^embed$", (-1, None)),
    (r"(^|/)(attn_norm|mlp_norm|final_norm)$", ()),
    (r"/w[qkv]$", (None, None, -1)),
    (r"/wo$", (None, -1, None)),
    (r"/router$", (None, None, None)),
    (r"/we[13]$", (None, None, None, -1)),
    (r"/we2$", (None, None, -1, None)),
    (r"^head$", (None, -1)),
)


def synth_payload(req: Request, bucket: int, max_len: int,
                  vocab: int) -> tuple[list, int]:
    """Deterministic (prompt, max_new) for a catalog request. Prompt
    tokens derive from crc32 of the rid (str hashing is salted per
    process — the injector's rule), max_new from the request cost so a
    cost-8 batch job holds its slot ~8 engine ticks, mirroring the
    sim's cost-proportional service times."""
    h = zlib.crc32(req.rid.encode())
    plen = 1 + h % max(1, min(int(bucket), 8))
    prompt = [1 + (h >> (i % 24)) % (vocab - 1) for i in range(plen)]
    budget = max(1, int(max_len) - int(bucket) - 1)
    max_new = max(1, min(int(req.cost), budget))
    return prompt, max_new


def _seeded_params(cfg, seed: int, device):
    """``params=None``: the full tree from ``init_params`` (or
    ``init_moe_params`` for an MoE config) under a ``torch.Generator``
    seeded with ``seed`` on ``device``; every rank draws the same."""
    import torch

    from pbs_tpu_torch.models import MoEConfig, init_moe_params, init_params

    gen = torch.Generator(device=device).manual_seed(int(seed))
    init = init_moe_params if isinstance(cfg, MoEConfig) else init_params
    return init(cfg, gen, device=device)


def _bring_up(cfg, params, tp: int, dp: int, seed: int, device):
    """The shared bring-up of both serve backends: the mesh, the full
    tree (drawn when None), its rule table checked against the engine's
    own placement, and the gather function. Returns (mesh, params,
    gather, engine keywords)."""
    from pbs_tpu_torch.models.moe import moe_slot_mlp
    from pbs_tpu_torch.models.serving import is_moe_tree, serving_shardings
    from pbs_tpu_torch.parallel.sharding import sharding_specs
    from pbs_tpu_torch.serve.partition import (
        PARTITION_RULES, make_serve_mesh, make_shard_and_gather_fns,
        rule_shardings,
    )

    mesh = make_serve_mesh(tp=tp, dp=dp, device=device)
    if params is None:
        params = _seeded_params(cfg, seed, mesh.device)
    moe = is_moe_tree(params)
    rules = MOE_PARTITION_RULES if moe else PARTITION_RULES
    # Rule-table placement first (hard error on an uncovered leaf),
    # then held to the engine's own placement, which cuts the blocks:
    # a tree the table cannot place never reaches an engine.
    by_rules = sharding_specs(rule_shardings(params, mesh, rules))
    by_engine = sharding_specs(serving_shardings(cfg, params, mesh))
    if _sharded_dims(by_rules) != _sharded_dims(by_engine):
        raise ValueError(
            f"the partition rules place the tree otherwise than the "
            f"engine does: rules {by_rules}, engine {by_engine}")
    _, gather = make_shard_and_gather_fns(params, mesh, rules)
    kw = {"mlp_fn": moe_slot_mlp(cfg)} if moe else {}
    return mesh, params, gather, kw


def _sharded_dims(specs):
    """A spec tree as {dim: axes} per leaf, replicated dims left out
    (``P()`` and ``P(None, None)`` place alike)."""
    if isinstance(specs, dict):
        return {k: _sharded_dims(v) for k, v in specs.items()}
    return {i: e for i, e in enumerate(specs) if e not in (None, ())}


def _tree_size(params) -> tuple[int, int]:
    """(leaves, bytes) of the full tree: the global counts whatever
    this rank holds."""
    from pbs_tpu_torch.models.transformer import tree_leaves

    leaves = tree_leaves(params)
    return len(leaves), int(sum(x.numel() * x.element_size()
                                for x in leaves))


def mesh_shape(mesh) -> dict:
    return {a: int(s) for a, s in mesh.shape.items()}


class ShardedServeBackend(BatcherBackend):
    """Rule-partitioned serving engine as a gateway backend.

    Construction: match ``params`` (the full tree) against the serve
    rule table on a ``(dp, tp)`` mesh (1x1 in one process: the same
    placement path, the exchanges skipped), check the table against the
    engine's own placement, then stand up the slot engine, which keeps
    this rank's blocks.
    """

    def __init__(self, name: str, cfg, params=None, *, tp: int = 1,
                 dp: int = 1, n_slots: int | None = None,
                 prompt_bucket: int = 16, max_len: int | None = None,
                 seed: int = 0, clock: str = "wall",
                 prefix_cache_size: int = 0, engine_cls=None,
                 device=None):
        from pbs_tpu_torch.models.serving import ContinuousBatcher

        if clock not in ("wall", "virtual"):
            raise ValueError(f"clock must be 'wall' or 'virtual', "
                             f"got {clock!r}")
        self.cfg = cfg
        self.mesh, params, self._gather_fn, kw = _bring_up(
            cfg, params, tp, dp, seed, device)
        self._param_leaves, self._param_bytes = _tree_size(params)
        self._virtual = clock == "virtual"
        self._now_ns = 0
        engine_cls = engine_cls or ContinuousBatcher
        engine = engine_cls(
            cfg, params,
            n_slots=int(n_slots if n_slots is not None else DECODE_SLOTS),
            prompt_bucket=prompt_bucket, max_len=max_len, seed=seed,
            mesh=self.mesh, prefix_cache_size=prefix_cache_size,
            clock=(lambda: self._now_ns * 1e-9) if self._virtual
            else None, **kw)
        super().__init__(name, engine)
        self.synth_dispatches = 0
        self.disagg_stages = ("prefill", "decode", "retire")

    # -- clock + payload seams -------------------------------------------

    def _observe(self, now_ns: int) -> None:
        if self._virtual and now_ns > self._now_ns:
            self._now_ns = int(now_ns)

    def dispatch_request(self, req: Request, now_ns: int) -> None:
        self._observe(now_ns)
        if "prompt" not in req.payload:
            prompt, max_new = synth_payload(
                req, self.engine.bucket, self.engine.max_len,
                self.cfg.vocab)
            req.payload = dict(req.payload,
                               prompt=prompt, max_new=max_new)
            self.synth_dispatches += 1
        super().dispatch_request(req, now_ns)

    def poll(self, now_ns: int):
        self._observe(now_ns)
        if not self.engine.has_work():
            # The engine steps (and checks its tick) only with work: a
            # rank with none still pairs with one that steps.
            self.engine.agree_tick()
        inflight_before = {
            rid for rid in self.engine.slot_req if rid is not None}
        out = super().poll(now_ns)
        if self.exec_hook is not None:
            # Decode-slot entry: requests newly holding a slot this
            # tick. (A request that is admitted and retired within one
            # tick shows only its retire EXEC — still a legal chain.)
            for erid in sorted(
                    rid for rid in self.engine.slot_req
                    if rid is not None and rid not in inflight_before):
                req = self._by_engine_rid.get(erid)
                if req is not None:
                    self.exec_hook(req, now_ns)
            for req, _info in out:  # retirement
                self.exec_hook(req, now_ns)
        return out

    # -- observability ----------------------------------------------------

    def gather_params(self) -> dict:
        """The full (host-readable) param tree from every rank's
        blocks — the checkpoint-save path, and the roundtrip identity
        surface tests/test_torch_serve.py pins byte-for-byte. Under
        ``tp > 1`` every rank calls it together."""
        return self._gather_fn(self.engine.params)

    def stats(self) -> dict:
        """Engine SLO stats + the placement facts a fleet dashboard
        needs to tell two serve backends apart (``param_*`` count the
        full tree, not this rank's blocks)."""
        return {
            **self.engine.stats(),
            "backend": self.name,
            "mesh": mesh_shape(self.mesh),
            "param_leaves": self._param_leaves,
            "param_bytes": self._param_bytes,
            "synth_dispatches": self.synth_dispatches,
            "bypass_submits": self.bypass_submits,
        }
