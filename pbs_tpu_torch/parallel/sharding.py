"""Sharding rules for the flagship transformer: dp + tp + sp.

The port of ``pbs_tpu.parallel.sharding``. The reference annotates
parameter and activation shardings and lets XLA insert the exchanges;
the port keeps its spec table and writes those exchanges out in
Megatron form (:mod:`pbs_tpu_torch.parallel.comm`), SPMD by rank: every
rank holds its block of each parameter and of the batch, and runs the
same step on them.

Layout (Megatron-style):

- embed (V, d)        -> P('tp', None)      vocab-sharded lookup
- wq/wk/wv (L, d, H)  -> P(None, None, 'tp') column-parallel
- wo (L, H, d)        -> P(None, 'tp', None) row-parallel
- w1/w3 (L, d, F)     -> P(None, None, 'tp') column-parallel
- w2 (L, F, d)        -> P(None, 'tp', None) row-parallel
- head (d, V)         -> P(None, 'tp')      vocab-sharded logits
- norms               -> replicated
- tokens (B, S)       -> P('dp', None), or P('dp', 'sp') with an sp axis
- residual (B, S, d)  -> P('dp', 'tp', None) between blocks: sequence
  parallelism over tp. The all-gather over tp before the
  column-parallel products is ``layer_body``'s ``gather`` seam, the
  reduce-scatter after wo and w2 its ``reduce``; the lookup ends in a
  reduce-scatter and the head starts with an all-gather, then takes a
  vocab-parallel log-softmax. With an sp axis the residual is
  P('dp', 'sp', None) instead: replicated over tp, ``reduce`` a sum over
  tp.

The loss is the global weighted mean: each rank sums nll x weight over
its positions and divides by the global weight (and by the tp ranks that
compute the same positions alike); targets are shifted on the full
token row, the last position of an sp chunk taking the next chunk's
first token. A gradient is summed over every mesh axis that does not
shard its parameter (:func:`reduce_grads`). AdamW clips nothing, so a
shard's update is the slice of the global update.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from pbs_tpu_torch.models.transformer import (
    TransformerConfig,
    _layer_fn,
    default_optimizer,
    init_params,
    rms_norm,
    rope_tables,
    tree_leaves,
    tree_map,
    unstack_layers,
)
from pbs_tpu_torch.parallel import comm
from pbs_tpu_torch.parallel.mesh import (
    Mesh,
    NamedSharding,
    PartitionSpec as P,
    shard_array,
)


def param_specs(cfg: TransformerConfig) -> dict:
    return {
        "embed": P("tp", None),
        "layers": {
            "attn_norm": P(None, None),
            "wq": P(None, None, "tp"),
            "wk": P(None, None, "tp"),
            "wv": P(None, None, "tp"),
            "wo": P(None, "tp", None),
            "mlp_norm": P(None, None),
            "w1": P(None, None, "tp"),
            "w3": P(None, None, "tp"),
            "w2": P(None, "tp", None),
        },
        "final_norm": P(None),
        "head": P(None, "tp"),
    }


def _mesh_spec(mesh: Mesh, spec: P) -> P:
    """Drop axis names the mesh doesn't have (e.g. 'tp' specs on a
    dp x sp mesh) so one canonical spec table serves every mesh shape."""
    def keep(entry):
        if isinstance(entry, tuple):
            kept = tuple(a for a in entry if a in mesh.axis_names)
            return kept or None
        return entry if entry in mesh.axis_names else None

    return P(*(keep(a) for a in spec))


def _spec_map(fn: Callable, specs: dict, tree: Any) -> Any:
    """``fn(spec, leaf)`` over a tree and its spec table."""
    if isinstance(tree, dict):
        return {k: _spec_map(fn, specs[k], v) for k, v in tree.items()}
    return fn(specs, tree)


def shard_tree(params: dict, mesh: Mesh, specs: dict) -> dict:
    """This rank's block of every leaf of the full tree ``params``
    under ``specs``, on the mesh's device."""
    return _spec_map(
        lambda spec, x: shard_array(x, mesh, _mesh_spec(mesh, spec)),
        specs, params)


def shard_params(params: dict, mesh: Mesh, cfg: TransformerConfig) -> dict:
    """The full tree (e.g. ``params_from_numpy`` of the reference's
    init) cut to this rank's shards."""
    return shard_tree(params, mesh, param_specs(cfg))


def place_tree(params: dict, shardings: dict) -> dict:
    """This rank's block of every leaf of the full tree ``params`` under
    its ``NamedSharding`` in ``shardings`` (a tree shaped like
    ``params``, as :func:`quant_aware_shardings` gives), on the mesh's
    device."""
    return _spec_map(lambda s, x: s.shard(x), shardings, params)


def sharding_specs(shardings: dict) -> dict:
    """The ``PartitionSpec`` tree of a ``NamedSharding`` tree (what
    :func:`gather_tree` takes)."""
    return _spec_map(lambda s, _: s.spec, shardings, shardings)


def _spec_axes(spec: P) -> set:
    out = set()
    for entry in spec:
        if isinstance(entry, tuple):
            out |= set(entry)
        elif entry is not None:
            out.add(entry)
    return out


@torch.no_grad()
def gather_tree(local: dict, mesh: Mesh, specs: dict) -> dict:
    """The full tree back from every rank's shards (a collective: every
    rank calls it and gets the whole tree)."""
    def gather(spec, t):
        spec = _mesh_spec(mesh, spec)
        for dim in range(len(spec) - 1, -1, -1):
            entry = spec[dim]
            axes = entry if isinstance(entry, tuple) else (entry,)
            for axis in reversed([a for a in axes if a is not None]):
                t = comm._all_gather(t, mesh.group(axis), dim)
        return t

    return _spec_map(gather, specs, local)


def gather_params(local: dict, mesh: Mesh, cfg: TransformerConfig) -> dict:
    """:func:`shard_params` undone: the full tree on every rank."""
    return gather_tree(local, mesh, param_specs(cfg))


@torch.no_grad()
def reduce_grads(grads: dict, mesh: Mesh, specs: dict) -> dict:
    """Sum each gradient over every mesh axis its spec does not shard
    (in place; one flattened exchange per axis). Data axes (dp, sp) are
    never in a parameter spec, so every gradient sums over them."""
    leaves = tree_leaves(grads)
    spec_leaves = []
    _spec_map(lambda spec, g: spec_leaves.append(_mesh_spec(mesh, spec)),
              specs, grads)
    for axis in mesh.axis_names:
        if mesh.size(axis) == 1:
            continue
        pick = [g for g, s in zip(leaves, spec_leaves)
                if axis not in _spec_axes(s)]
        by_dtype: dict = {}
        for g in pick:
            by_dtype.setdefault(g.dtype, []).append(g)
        for group in by_dtype.values():
            flat = torch.cat([g.reshape(-1) for g in group])
            comm.all_reduce_(flat, mesh.group(axis))
            for g, part in zip(group, flat.split([g.numel() for g in group])):
                g.copy_(part.view_as(g))
    return grads


def quant_aware_shardings(specs: dict, params: dict, mesh: Mesh):
    """Shardings for a param tree that may hold int8-quantized leaves.

    A quantized leaf is ``{"q": int8 (same shape as the fp weight),
    "s": fp32 scales (same RANK, size 1 on the reduced axis -2)}``
    (models/quant._quantize_leaf). ``q`` takes the fp spec verbatim;
    ``s`` takes the fp spec with any sharding on axis -2 dropped —
    sharding a size-1 dimension is invalid, and the per-output-channel
    scales live on the LAST axis, which keeps its sharding (so a
    column-parallel weight's scales shard with its outputs and the
    fused dequant stays local). Plain leaves map 1:1."""
    def walk(spec, p):
        if isinstance(p, dict) and set(p) == {"q", "s"}:
            r = p["q"].ndim
            se = list(spec) + [None] * (r - len(list(spec)))
            se[r - 2] = None
            return {
                "q": NamedSharding(mesh, _mesh_spec(mesh, spec)),
                "s": NamedSharding(mesh, _mesh_spec(mesh, P(*se))),
            }
        if isinstance(p, dict):
            return {k: walk(spec[k], p[k]) for k in p}
        return NamedSharding(mesh, _mesh_spec(mesh, spec))

    return {k: walk(specs[k], params[k]) for k in params}


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Token batches: batch over dp; sequence over sp when the mesh has
    a ring-attention axis (long-context inputs arrive pre-sharded).
    ``batch_sharding(mesh).shard(tokens)`` is this rank's block."""
    seq = "sp" if "sp" in mesh.axis_names else None
    return NamedSharding(mesh, _mesh_spec(mesh, P("dp", seq)))


def slot_cache_kv_sharding(mesh: Mesh) -> NamedSharding:
    """KV slot-cache slabs ``(layer, slot, pos, n_kv, head_dim)``:
    shard the kv-head axis over tp, everything else replicated — the
    serving twin of the Megatron attention layout above. The single
    home for this spec: mesh-axis names stay inside ``parallel/`` (the
    ``serve-raw-mesh-axis`` rule, docs/ANALYSIS.md)."""
    return NamedSharding(mesh, _mesh_spec(mesh, P(None, None, None, "tp",
                                                  None)))


class ServingSeams:
    """The tp exchanges of the serving forward (``models/serving.py``'s
    ``_slot_forward``), which the reference leaves to XLA: the
    vocab-sharded embed lookup (rows outside this rank's range are zero,
    then an all-reduce), an all-reduce after each row-parallel product
    (``wo``; ``w2`` or the MoE combine) and an all-gather of the
    vocab-sharded logits, so every rank samples from the same logits.
    The residual stays whole on every rank (a decode tick has one
    position a row). Without a mesh, or with a tp axis of one, every
    seam is the identity and exchanges nothing.

    :meth:`agree` is the serving engines' guard against ranks that drift
    apart: every rank must drive the same submissions at the same tick,
    or the next exchanges pair up wrongly and wait forever."""

    def __init__(self, mesh: Mesh | None = None):
        self.group = None if mesh is None else _axis_group(mesh, "tp")
        self.n = _size(self.group)
        self.device = None if mesh is None else mesh.device

    def embed(self, w, tokens: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        from pbs_tpu_torch.models.quant import embed_rows

        if self.n == 1:
            return embed_rows(w, tokens, dt)
        Vl = (w["q"] if isinstance(w, dict) else w).shape[0]
        local = tokens.long() - comm.group_index(self.group) * Vl
        inr = ((local >= 0) & (local < Vl))[..., None]
        rows = embed_rows(w, local.clamp(0, Vl - 1), dt) * inr.to(dt)
        return comm.all_reduce_(rows, self.group)

    def reduce(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.n == 1 else comm.all_reduce_(t, self.group)

    def logits(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.n == 1 else comm._all_gather(t, self.group,
                                                      t.dim() - 1)

    def agree(self, values: list[int], where: str) -> None:
        """Raise unless every tp rank holds the same ``values`` (small
        ints: the engine's tick and a digest of what it was given). One
        all-gather of a host tensor when the group is gloo's (nothing
        staged), of a device tensor over NCCL."""
        if self.n == 1:
            return
        dev = "cpu" if torch.distributed.get_backend(self.group) == "gloo" \
            else self.device
        mine = torch.tensor([values], dtype=torch.int64, device=dev)
        got = comm._all_gather(mine, self.group, 0)
        if not bool((got == mine).all()):
            raise RuntimeError(
                f"tp ranks diverged at {where}: each rank's {len(values)} "
                f"values, in rank order, {got.tolist()}; every rank must "
                f"submit the same requests in the same order at the same "
                f"tick")


def activation_constrainer(mesh: Mesh | None):
    """Returns the ``constrain`` fn threaded through the model, which
    pins the residual stream (B, S, d): P('dp', 'sp', None) on an sp
    mesh, P('dp', 'tp', None) on a tp one. Each rank already holds its
    block there — the reduce-scatter that makes it sits in the
    ``reduce`` seam just before (:func:`make_sharded_train`) — so the
    pin exchanges nothing and is the identity."""
    return lambda x: x


# -- the SPMD step ------------------------------------------------------------


def _axis_group(mesh: Mesh, axis: str):
    return mesh.group(axis) if axis in mesh.axis_names else None


def _size(group) -> int:
    return 1 if group is None else comm.group_size(group)


def sharded_targets(tokens: torch.Tensor, mesh: Mesh
                    ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """(targets, weights, global weight) for this rank's token block,
    shifted on the full row: the last position of an sp chunk predicts
    the next chunk's first token (one exchange over sp), the row's last
    position has weight 0. The global weight is B * (S - 1) of the full
    batch."""
    B, S = tokens.shape
    sp = _axis_group(mesh, "sp")
    n, me = _size(sp), mesh.index("sp")
    first = tokens[:, :1].contiguous()
    if n > 1:  # chunk r receives chunk r+1's first column
        first = comm._ppermute(first, sp, [(i, i - 1) for i in range(1, n)])
    targets = torch.cat([tokens[:, 1:], first], dim=1)
    weights = torch.ones((B, S), dtype=torch.float32, device=tokens.device)
    if me == n - 1:
        weights[:, -1] = 0.0
    total = B * mesh.size("dp") * (S * n - 1)
    return targets, weights, total


def sharded_rope(cfg: TransformerConfig, S_local: int, mesh: Mesh, device):
    """Rope tables for this rank's sequence chunk: global positions,
    local storage (the global tables sliced at the chunk's offset)."""
    n = mesh.size("sp")
    cos, sin = rope_tables(cfg, S_local * n, device=device)
    off = mesh.index("sp") * S_local
    return cos[off:off + S_local], sin[off:off + S_local]


def vocab_nll_sum(cfg: TransformerConfig, x: torch.Tensor,
                  head: torch.Tensor, targets: torch.Tensor,
                  weights: torch.Tensor, group,
                  chunk: int | None = None) -> torch.Tensor:
    """sum(nll x weights) over the positions of ``x`` (B, S, d) with a
    vocab-sharded ``head`` (d, V/n): the vocab-parallel log-softmax over
    ``group`` (a max, a sum of exponentials and the target's logit,
    each summed over the group). One member: the plain log-softmax.
    ``chunk`` (the reference's S / loss_chunks of the global sequence)
    walks the positions in checkpointed chunks of that length, so the
    logits never exist at once."""
    def nll(xc, tc, wc):
        logits = (xc @ head.to(cfg.dtype)).float()
        if _size(group) == 1:
            logp = torch.log_softmax(logits, dim=-1)
            ll = torch.gather(logp, -1, tc.long()[..., None])[..., 0]
            return -torch.sum(ll * wc)
        Vl = logits.shape[-1]
        m = logits.detach().amax(dim=-1)
        comm.all_reduce_(m, group, torch.distributed.ReduceOp.MAX)
        se = comm.psum(torch.exp(logits - m[..., None]).sum(dim=-1), group)
        local = tc.long() - comm.group_index(group) * Vl
        inr = (local >= 0) & (local < Vl)
        picked = torch.gather(logits, -1,
                              local.clamp(0, Vl - 1)[..., None])[..., 0]
        tgt = comm.psum(picked * inr, group)
        return torch.sum((m + torch.log(se) - tgt) * wc)

    if chunk is None:
        return nll(x, targets, weights)
    from torch.utils.checkpoint import checkpoint

    total = x.new_zeros((), dtype=torch.float32)
    for c in range(0, x.shape[1], chunk):
        sl = slice(c, c + chunk)
        total = total + checkpoint(nll, x[:, sl], targets[:, sl],
                                   weights[:, sl], use_reentrant=False,
                                   preserve_rng_state=False)
    return total


def loss_chunk(cfg: TransformerConfig, S: int) -> int | None:
    """The chunked loss tail's chunk length over a global sequence of
    S positions (None: no chunking), with the reference's guard."""
    if cfg.loss_chunks <= 1:
        return None
    if S % cfg.loss_chunks:
        raise ValueError(f"S={S} not divisible by "
                         f"loss_chunks={cfg.loss_chunks}")
    return S // cfg.loss_chunks


class _TpSeams:
    """The tp exchanges of the dense body. Sequence parallelism over tp
    (no sp axis): the residual is a sequence chunk; ``gather``
    all-gathers it before the column products, ``reduce``
    reduce-scatters the row products, the lookup ends in a
    reduce-scatter and the head starts with an all-gather. With an sp
    axis the residual is the rank's sp chunk, replicated over tp:
    ``reduce`` and the lookup sum over tp."""

    def __init__(self, mesh: Mesh):
        self.group = _axis_group(mesh, "tp")
        self.n = _size(self.group)
        self.seq = self.group is not None and "sp" not in mesh.axis_names
        if self.n == 1:
            self.gather = self.reduce = None
        elif self.seq:
            self.gather = lambda t: comm.all_gather(t, self.group, 1)
            self.reduce = lambda t: comm.reduce_scatter(t, self.group, 1)
        else:
            self.gather = None
            self.reduce = lambda t: comm.psum(t, self.group)

    def pad(self, S: int) -> int:
        """Positions appended so the sequence splits over tp."""
        return (-S) % self.n if self.seq else 0

    def embed(self, w: torch.Tensor, tokens: torch.Tensor,
              dt: torch.dtype) -> torch.Tensor:
        if self.n == 1:
            return w[tokens.long()].to(dt)
        Vl = w.shape[0]
        local = tokens.long() - comm.group_index(self.group) * Vl
        inr = ((local >= 0) & (local < Vl))[..., None]
        rows = w[local.clamp(0, Vl - 1)].to(dt) * inr.to(dt)
        if self.seq:
            return comm.reduce_scatter(rows, self.group, 1)
        return comm.psum(rows, self.group)

    def head_input(self, x: torch.Tensor) -> torch.Tensor:
        return comm.all_gather(x, self.group, 1) if self.seq and \
            self.n > 1 else x


def _gathered_attention(cfg: TransformerConfig, group):
    """Attention for a non-sequence-parallel impl on an sp mesh: the
    reference lets XLA gather the sequence; here q/k/v are all-gathered
    over sp, attended in full, and this rank's chunk is kept."""
    from pbs_tpu_torch.models.transformer import causal_attention

    def attn(q, k, v):
        full = [comm.all_gather(t, group, 1) for t in (q, k, v)]
        return comm.shard(causal_attention(*full, cfg), group, 1)

    return attn


def dense_local_loss(cfg: TransformerConfig, mesh: Mesh, params: dict,
                     tokens: torch.Tensor):
    """This rank's share of the global loss for its token block: (the
    loss term to differentiate, {"loss": its share of the global
    loss}). Summed over all ranks, the shares are the global loss."""
    seams = _TpSeams(mesh)
    sp = _axis_group(mesh, "sp")
    seq_par = cfg.attn_impl in ("ring", "ulysses")
    targets, weights, total = sharded_targets(tokens, mesh)
    pad = seams.pad(tokens.shape[1])
    if pad:
        tokens = torch.nn.functional.pad(tokens, (0, pad))
        targets = torch.nn.functional.pad(targets, (0, pad))
        weights = torch.nn.functional.pad(weights, (0, pad))
    chunk = loss_chunk(cfg, (tokens.shape[1] - pad) * _size(sp))

    x = seams.embed(params["embed"], tokens, cfg.dtype)
    cos, sin = sharded_rope(cfg, tokens.shape[1], mesh, x.device)
    attn = None
    if _size(sp) > 1 and not seq_par:
        attn = _gathered_attention(cfg, sp)
    body = _layer_fn(cfg, activation_constrainer(mesh),
                     mesh if seq_par else None, reduce=seams.reduce,
                     attn=attn, gather=seams.gather)
    for lp in unstack_layers(params):
        x = body(x, lp, cos, sin)
    x = seams.head_input(rms_norm(x, params["final_norm"], cfg.norm_eps))
    nll = vocab_nll_sum(cfg, x, params["head"], targets, weights,
                        seams.group, chunk)
    share = nll / (total * seams.n)
    return share, {"loss": share.detach()}


class ShardedTrainer:
    """One SPMD train step over a mesh: ``local_loss(params, tokens) ->
    (loss term, {metric: this rank's share})`` (plus, optionally, the
    anchor scalars of pipeline receives as a third item), gradients
    summed per :func:`reduce_grads`, metrics summed over the world,
    AdamW on the shards. ``step(state, tokens)`` is the reference's
    ``train_step``; ``loss_and_grads(params, tokens)`` the global
    metrics and the summed gradients (port-only, for parity checks)."""

    def __init__(self, mesh: Mesh, specs: dict, local_loss: Callable,
                 learning_rate: float, tokens_of: Callable):
        self.mesh = mesh
        self.specs = specs
        self.local_loss = local_loss
        self.tx = default_optimizer(learning_rate)
        self.tokens_of = tokens_of

    def loss_and_grads(self, params: dict, tokens: torch.Tensor):
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        out = self.local_loss(live, tokens)
        term, parts = out[0], out[1]
        anchors = list(out[2]) if len(out) > 2 else []
        leaves = tree_leaves(live)
        got = torch.autograd.grad(term, leaves + anchors, allow_unused=True)
        it = iter([torch.zeros_like(p) if g is None else g
                   for p, g in zip(leaves, got[:len(leaves)])])
        grads = reduce_grads(tree_map(lambda _: next(it), live), self.mesh,
                             self.specs)
        names = sorted(parts)
        vec = torch.stack([parts[k].float().reshape(()) for k in names])
        comm.all_reduce_(vec, torch.distributed.group.WORLD)
        return dict(zip(names, vec)), grads

    def init_opt_state(self, params: dict) -> dict:
        return self.tx.init(params)

    def step(self, state, tokens: torch.Tensor):
        params, opt_state, step = state
        metrics, grads = self.loss_and_grads(params, tokens)
        opt_state = self.tx.update(grads, opt_state, params)
        metrics["tokens"] = self.tokens_of(tokens)
        return (params, opt_state, step + 1), metrics


def _generator(key: Any, device: torch.device) -> torch.Generator:
    if isinstance(key, torch.Generator):
        return key
    return torch.Generator(device=device).manual_seed(
        0 if key is None else int(key))


def _global_tokens(mesh: Mesh) -> Callable:
    def count(tokens):
        B, S = tokens.shape
        return B * mesh.size("dp") * (S * mesh.size("sp") - 1)

    return count


def make_sharded_train(
    cfg: TransformerConfig,
    mesh: Mesh,
    learning_rate: float = 3e-4,
    key: Any = None,
    params: dict | None = None,
):
    """Build this rank's sharded (params, opt_state, step) and its
    train step, ``step(state, tokens) -> (state, metrics)`` on this
    rank's token block (``batch_sharding(mesh).shard(tokens)``), with
    the global loss in ``metrics["loss"]``.

    ``params`` is the full tree to shard (e.g. ``params_from_numpy`` of
    the reference's init); without it every rank draws the same tree
    from ``init_params`` seeded by ``key`` (an int or a generator on the
    mesh's device; None means 0). The step is a bound method of a
    :class:`ShardedTrainer` (``step.__self__``), whose
    ``loss_and_grads`` returns the global metrics and this rank's summed
    gradient shards."""
    # Sequence-parallel attention (ring / ulysses) needs an sp axis in
    # the mesh and a sequence length divisible by it.
    seq_par = cfg.attn_impl in ("ring", "ulysses")
    if seq_par and "sp" not in mesh.axis_names:
        raise ValueError(
            f"attn_impl={cfg.attn_impl!r} requires an 'sp' axis in the "
            f"mesh; got axes {mesh.axis_names}"
        )
    tp = mesh.size("tp")
    if tp > 1 and (cfg.n_heads % tp or cfg.n_kv_heads % tp or cfg.d_ff % tp):
        # Megatron's split keeps whole heads on a rank (the reference's
        # XLA partitioner also splits a head across devices).
        raise ValueError(
            f"tp={tp} must divide n_heads={cfg.n_heads}, "
            f"n_kv_heads={cfg.n_kv_heads}, and d_ff={cfg.d_ff}"
        )
    specs = param_specs(cfg)
    if params is None:
        params = init_params(cfg, _generator(key, mesh.device),
                             device=mesh.device)
    local = shard_tree(params, mesh, specs)
    del params
    trainer = ShardedTrainer(
        mesh, specs,
        lambda p, t: dense_local_loss(cfg, mesh, p, t),
        learning_rate, _global_tokens(mesh))
    state = (local, trainer.init_opt_state(local), 0)
    return state, trainer.step
