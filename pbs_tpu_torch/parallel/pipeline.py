"""Pipeline parallelism: GPipe-style microbatch pipeline over a ``pp`` axis.

The port of ``pbs_tpu.parallel.pipeline``. Where dp/tp/sp/ep are
layouts, pipelining is a *schedule*: activations move explicitly from
stage to stage.

Design:

- The layer-stacked params (L, ...) are sharded ``P('pp', ...)``: stage i
  holds layers [i*L/pp, (i+1)*L/pp) — the stacked layout *is* the
  pipeline layout.
- Each stage runs its layers on one microbatch at a time and hands the
  result to the next stage (:func:`pbs_tpu_torch.parallel.comm.send` /
  ``recv``); M microbatches drain in M + pp - 1 ticks (the GPipe
  bubble; bubble fraction = (pp-1)/(M+pp-1), amortized by raising M).
  The reference runs every stage on every tick under ``shard_map`` and
  never reads a bubble tick's output; the port skips a bubble tick's
  compute and its hand-off, so stage i just runs microbatches 0..M-1 in
  order. The MoE aux statistic, which the reference masks on bubble
  ticks, comes out the same.
- The batch stays sharded over ``dp``; microbatch m holds the global
  rows [m*mb, (m+1)*mb), split over dp as the reference's
  ``P(None, 'dp', ...)`` splits them (the rank's token block is
  all-gathered over dp and re-cut, a few integers). tp rides the stages
  Megatron-style through ``layer_body``'s ``reduce`` seam (a sum over
  tp), sp through its ``attn`` seam (the ring or Ulysses body over the
  sp group).
- Backward is autograd through the schedule: a hand-off's backward
  sends the cotangent to the previous stage, so stages backpropagate
  microbatches in reverse order. Each layer is recomputed in the
  backward (``torch.utils.checkpoint``, the reference's
  ``jax.checkpoint``), the GPipe memory contract. embed, head and the
  final norm replicate over pp; their gradients sum over it.

SPMD by rank: the losses and train steps take this rank's token block
(``pipeline_batch_sharding(mesh).shard(tokens)``) and its parameter
shards.
"""

from __future__ import annotations

import functools
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from pbs_tpu_torch.models.transformer import (
    TransformerConfig,
    init_params,
    layer_body,
    rms_norm,
    shift_targets_and_weights,
    unstack_layers,
)
from pbs_tpu_torch.parallel import comm
from pbs_tpu_torch.parallel.mesh import Mesh, NamedSharding, PartitionSpec as P
from pbs_tpu_torch.parallel.sharding import (
    ShardedTrainer,
    _axis_group,
    _generator,
    _mesh_spec,
    _size,
    loss_chunk,
    shard_tree,
    sharded_rope,
    vocab_nll_sum,
)


def pipeline_layer_specs(tp: bool = False) -> dict:
    """Specs for the layer-stacked subtree: stage-sharded on axis 0.

    With ``tp`` the in-stage weights additionally shard Megatron-style
    over the ``tp`` axis: qkv/gate/up column-parallel (output dim),
    wo/w2 row-parallel (input dim); norms replicate over tp (the full
    residual stream is needed for the d-dim reduction)."""
    t = "tp" if tp else None
    return {
        "attn_norm": P("pp", None),
        "wq": P("pp", None, t),
        "wk": P("pp", None, t),
        "wv": P("pp", None, t),
        "wo": P("pp", t, None),
        "mlp_norm": P("pp", None),
        "w1": P("pp", None, t),
        "w3": P("pp", None, t),
        "w2": P("pp", t, None),
    }


def _full_tree_specs(layer_specs: dict) -> dict:
    """Full-tree specs around any stage subtree: embed/head replicated,
    blocks per the given layer specs — ONE copy for the dense and MoE
    pipelines."""
    return {
        "embed": P(None, None),
        "layers": layer_specs,
        "final_norm": P(None),
        "head": P(None, None),
    }


def pipeline_param_specs(cfg: TransformerConfig, tp: bool = False) -> dict:
    return _full_tree_specs(pipeline_layer_specs(tp))


def shard_pipeline_params(params: dict, mesh: Mesh,
                          cfg: TransformerConfig) -> dict:
    tp = mesh.shape.get("tp", 1) > 1
    return shard_tree(params, mesh, pipeline_param_specs(cfg, tp))


def _validate_pipe_attn(cfg: TransformerConfig, tp: int, sp: int) -> None:
    """Shared attn-impl/mesh compatibility rules for the pipelined
    stage bodies: the pipeline composes with the framework's own
    kernels and the long-context impls."""
    if cfg.attn_impl not in ("xla", "pallas", "ring", "ulysses"):
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")
    if cfg.attn_impl in ("ring", "ulysses") and sp <= 1:
        raise ValueError(
            f"attn_impl={cfg.attn_impl!r} inside the pp schedule needs "
            "an 'sp' axis (>1) in the SAME mesh — the sequence-parallel "
            "bodies run in the pipe's own manual region"
        )
    if sp > 1 and cfg.attn_impl not in ("ring", "ulysses"):
        raise ValueError(
            f"an sp axis shards the sequence, but attn_impl="
            f"{cfg.attn_impl!r} attends only within the local chunk "
            "(silently block-diagonal); use 'ring' or 'ulysses'"
        )
    if cfg.attn_impl == "ulysses":
        if tp > 1:
            raise ValueError(
                "ulysses does not compose with tensor parallelism "
                "(both shard heads); use ring attention on tp meshes"
            )
        if cfg.n_heads % sp or cfg.n_kv_heads % sp:
            raise ValueError(
                f"ulysses needs n_heads ({cfg.n_heads}) and n_kv_heads "
                f"({cfg.n_kv_heads}) divisible by sp ({sp}); use ring "
                "attention for this shape"
            )


def _pipe_attn_seam(cfg: TransformerConfig, mesh: Mesh):
    """The per-rank attention body for the pipelined stages, or None
    for the impls :func:`layer_body` dispatches itself ('xla', 'pallas':
    neither needs mesh axes). ring/ulysses get their per-rank bodies
    over the pipe's sp group, as the reference hands them to
    ``layer_body``'s ``attn`` seam inside its manual region."""
    if cfg.attn_impl == "ring":
        from pbs_tpu_torch.parallel.ring_attention import (
            _ring_attention_local,
            _ring_attention_local_flash,
        )

        group = mesh.group("sp")
        if cfg.ring_block == "flash":
            return functools.partial(
                _ring_attention_local_flash, group=group, causal=True)
        sm = 1.0 / float(cfg.head_dim) ** 0.5
        return functools.partial(
            _ring_attention_local, group=group, causal=True, sm_scale=sm)
    if cfg.attn_impl == "ulysses":
        from pbs_tpu_torch.parallel.ulysses import _ulysses_local

        sm = 1.0 / float(cfg.head_dim) ** 0.5
        return functools.partial(
            _ulysses_local, group=mesh.group("sp"), causal=True,
            sm_scale=sm, block_impl=cfg.ring_block)
    return None


def _micro_rows(tokens: torch.Tensor, mesh: Mesh, n_micro: int):
    """This rank's rows of each microbatch, (M, mb/dp, S_local): the
    token block all-gathered over dp, microbatch m = global rows
    [m*mb, (m+1)*mb), split over dp. Raises the reference's guard when
    the global batch does not split into n_micro."""
    dp = _axis_group(mesh, "dp")
    full = comm._all_gather(tokens, dp, 0) if _size(dp) > 1 else tokens
    B = full.shape[0]
    if B % n_micro != 0:
        raise ValueError(f"batch {B} not divisible by M={n_micro}")
    mb = B // n_micro
    ndp = _size(dp)
    if mb % ndp:
        raise ValueError(f"microbatch {mb} not divisible by dp={ndp}")
    per = mb // ndp
    off = mesh.index("dp") * per
    return full.reshape(n_micro, mb, -1)[:, off:off + per]


class _Stage:
    """The GPipe schedule on this rank: microbatches 0..M-1 through its
    layers, received from the previous stage (or embedded on the first)
    and sent to the next (or kept on the last)."""

    def __init__(self, mesh: Mesh, n_micro: int):
        self.group = mesh.group("pp")
        self.idx = mesh.index("pp")
        self.n = mesh.size("pp")
        self.n_micro = n_micro
        self.first = self.idx == 0
        self.last = self.idx == self.n - 1

    def run(self, embed, stage, shape, dtype, device):
        """``embed(m)`` makes microbatch m's input on the first stage;
        ``stage(x, m)`` runs this rank's layers. Returns (the last
        stage's outputs or None, the send scalars, the receive anchor)."""
        anchor = torch.zeros((), device=device, requires_grad=True)
        outs, sends = [], []
        for m in range(self.n_micro):
            if self.first:
                x = embed(m)
            else:
                x = comm.recv(anchor, shape, dtype, self.group, self.idx - 1,
                              tag=m)
            y = stage(x, m)
            if self.last:
                outs.append(y)
            else:
                sends.append(comm.send(y, self.group, self.idx + 1, tag=m))
        return (outs if self.last else None), sends, anchor


def _pipe_blocks(cfg: TransformerConfig, mesh: Mesh, n_micro: int):
    """Validates the dense pipe for ``mesh`` and returns this rank's
    stage body ``stage(layers, x) -> y`` over its layer shard (with a
    tp axis the in-stage weights Megatron-sharded over tp; with an sp
    axis the sequence sharded and attention run via the ring or
    Ulysses per-rank bodies)."""
    pp = mesh.shape["pp"]
    tp = mesh.shape.get("tp", 1)
    sp = mesh.shape.get("sp", 1)
    if cfg.n_layers % pp != 0:
        raise ValueError(
            f"n_layers={cfg.n_layers} not divisible by pp={pp}"
        )
    if tp > 1:
        if cfg.n_heads % tp or cfg.n_kv_heads % tp or cfg.d_ff % tp:
            raise ValueError(
                f"tp={tp} must divide n_heads={cfg.n_heads}, "
                f"n_kv_heads={cfg.n_kv_heads}, and d_ff={cfg.d_ff}"
            )
    _validate_pipe_attn(cfg, tp, sp)
    attn_fn = _pipe_attn_seam(cfg, mesh)
    # With tp > 1 each rank holds a Megatron shard of the stage weights:
    # the row-parallel products are partial sums, summed over tp.
    reduce = None
    if tp > 1:
        group = mesh.group("tp")
        reduce = functools.partial(comm.psum, group=group)

    def body(x, lp, cos, sin):
        return layer_body(cfg, x, lp, cos, sin, reduce=reduce, attn=attn_fn)

    def stage(layers, x, cos, sin):
        for lp in unstack_layers({"layers": layers}):
            x = checkpoint(body, x, lp, cos, sin, use_reentrant=False,
                           preserve_rng_state=False)
        return x

    return stage


def _pipe_inputs(cfg: TransformerConfig, mesh: Mesh, tokens: torch.Tensor,
                 n_micro: int):
    """(microbatch token rows, targets, weights, the global weight,
    rope tables) for the pipelined losses: with an sp axis all S
    positions with the last masked (S-1 rarely divides the ring), else
    tokens[:, :-1] against tokens[:, 1:], as the reference."""
    rows = _micro_rows(tokens, mesh, n_micro)
    M, per, S_full = rows.shape
    flat = rows.reshape(M * per, S_full)
    sp = mesh.size("sp")
    if sp > 1:
        # The targets shift on the full row, then the row is cut to
        # this rank's sp chunk.
        if S_full % sp:
            raise ValueError(f"seq {S_full} not divisible by sp={sp}")
        targets, weights = shift_targets_and_weights(flat)
        n = S_full // sp
        cut = slice(mesh.index("sp") * n, (mesh.index("sp") + 1) * n)
        inp, targets, weights = flat[:, cut], targets[:, cut], weights[:, cut]
    else:
        inp, targets = flat[:, :-1], flat[:, 1:]
        weights = torch.ones(targets.shape, dtype=torch.float32,
                             device=targets.device)
    total = M * per * mesh.size("dp") * (S_full - 1)
    inp = inp.reshape(M, per, -1)
    cos, sin = sharded_rope(cfg, inp.shape[2], mesh, tokens.device)
    return inp, targets, weights, total, cos, sin


def _lm_share(cfg, mesh, params, ys, targets, weights, total):
    """The last stage's share of the global LM loss."""
    y = torch.cat(ys, dim=0)
    y = rms_norm(y, params["final_norm"], cfg.norm_eps)
    chunk = loss_chunk(cfg, y.shape[1] * mesh.size("sp")) \
        if mesh.size("sp") > 1 else None
    nll = vocab_nll_sum(cfg, y, params["head"], targets, weights, None,
                        chunk)
    return nll / (total * mesh.size("tp") * mesh.size("ep"))


class PipelinedLoss:
    """:func:`make_pipelined_loss`'s loss: ``loss(params, tokens)`` is
    the global causal-LM loss (every rank gets it); ``local(params,
    tokens)`` is this rank's share with the pipeline's send scalars and
    receive anchor, for the trainer."""

    def __init__(self, cfg: TransformerConfig, mesh: Mesh, n_micro: int):
        self.cfg, self.mesh, self.n_micro = cfg, mesh, n_micro
        self.stage = _pipe_blocks(cfg, mesh, n_micro)
        self.sched = _Stage(mesh, n_micro)

    def local(self, params: dict, tokens: torch.Tensor):
        cfg, mesh = self.cfg, self.mesh
        inp, targets, weights, total, cos, sin = _pipe_inputs(
            cfg, mesh, tokens, self.n_micro)
        M, per, S = inp.shape
        dev = tokens.device
        ys, sends, anchor = self.sched.run(
            lambda m: params["embed"][inp[m].long()].to(cfg.dtype),
            lambda x, m: self.stage(params["layers"], x, cos, sin),
            (per, S, cfg.d_model), cfg.dtype, dev)
        share = torch.zeros((), dtype=torch.float32, device=dev)
        if ys is not None:
            share = _lm_share(cfg, mesh, params, ys, targets, weights, total)
        term = share + sum(sends, torch.zeros((), device=dev))
        return term, {"loss": share.detach()}, [anchor]

    @torch.no_grad()
    def __call__(self, params: dict, tokens: torch.Tensor) -> torch.Tensor:
        share = self.local(params, tokens)[1]["loss"]
        return comm.all_reduce_(share.clone(), torch.distributed.group.WORLD)


def make_pipelined_loss(cfg: TransformerConfig, mesh: Mesh, n_micro: int):
    """Causal-LM loss with the block stack pipelined over ``pp``.

    Embedding on the first stage, head and loss on the last; only the
    layer stack is scheduled. With an ``sp`` axis the forward runs over
    all S tokens (S-1 rarely divides the ring size — the same full-seq
    trick as ``next_token_loss``) with the targetless last position
    masked out of the loss; mathematically identical for a causal
    model."""
    return PipelinedLoss(cfg, mesh, n_micro)


def _global_batch_tokens(mesh: Mesh):
    def count(tokens):  # the block is P('dp', None): full rows
        B, S = tokens.shape
        return B * mesh.size("dp") * (S - 1)

    return count


def make_pipelined_train(
    cfg: TransformerConfig,
    mesh: Mesh,
    n_micro: int = 4,
    learning_rate: float = 3e-4,
    key: Any = None,
    params: dict | None = None,
):
    """This rank's dp x pp (x tp x sp) train state and step.
    ``params``/``key`` as :func:`pbs_tpu_torch.parallel.make_sharded_train`."""
    loss = make_pipelined_loss(cfg, mesh, n_micro)
    specs = pipeline_param_specs(cfg, mesh.shape.get("tp", 1) > 1)
    if params is None:
        params = init_params(cfg, _generator(key, mesh.device),
                             device=mesh.device)
    local = shard_tree(params, mesh, specs)
    del params
    trainer = ShardedTrainer(mesh, specs, loss.local, learning_rate,
                             _global_batch_tokens(mesh))
    state = (local, trainer.init_opt_state(local), 0)
    return state, trainer.step


def pipeline_batch_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, _mesh_spec(mesh, P("dp", None)))


# -- MoE pipeline: pp x ep (+dp) --------------------------------------------


def moe_pipeline_layer_specs(ep: bool = False) -> dict:
    """MoE stage subtree: layers stage-sharded on axis 0; with ``ep``
    the expert tensors additionally shard over the ep axis. Attention
    weights and the router replicate over ep (full-E routing is
    recomputed per ep shard — cheap next to expert FLOPs — and the
    expert combine is the one sum over ep)."""
    e = "ep" if ep else None
    return {
        "attn_norm": P("pp", None),
        "wq": P("pp", None, None),
        "wk": P("pp", None, None),
        "wv": P("pp", None, None),
        "wo": P("pp", None, None),
        "mlp_norm": P("pp", None),
        "router": P("pp", None, None),
        "we1": P("pp", e, None, None),
        "we3": P("pp", e, None, None),
        "we2": P("pp", e, None, None),
    }


def _moe_pipe_blocks(cfg, mesh: Mesh, n_micro: int):
    """Validates the MoE pipe for ``mesh`` and returns this rank's stage
    body ``stage(layers, x) -> (y, aux, drop)``, aux and drop summed over
    its layers. Each stage runs full-E routing and its LOCAL expert
    shard, summing the partial combines over ep."""
    from pbs_tpu_torch.models.moe import (
        moe_layer_body,
        routed_expert_ffn,
        routing_groups,
        top_k_dispatch,
    )

    pp = mesh.shape["pp"]
    ep = mesh.shape.get("ep", 1)
    sp = mesh.shape.get("sp", 1)
    if cfg.n_layers % pp != 0:
        raise ValueError(
            f"n_layers={cfg.n_layers} not divisible by pp={pp}"
        )
    if cfg.n_experts % ep != 0:
        raise ValueError(
            f"ep={ep} must divide n_experts={cfg.n_experts}"
        )
    # Same composition rules as the dense pipe; with an sp axis the
    # router sees each rank's LOCAL token chunk — routing is per-token
    # so expert OUTPUTS are unaffected (exactly so in dropless mode),
    # only the grouping of the aux statistic changes (averaged over sp).
    _validate_pipe_attn(cfg, tp=1, sp=sp)
    el = cfg.n_experts // ep
    attn_fn = _pipe_attn_seam(cfg, mesh)
    ep_group = mesh.group("ep") if ep > 1 else None
    e0 = mesh.index("ep") * el

    def sharded_ffn(h, lp):
        # The ep-local routed FFN behind moe_layer_body's mlp seam:
        # full-E routing recomputed per shard (identical on every ep
        # rank), expert compute on the LOCAL slice, partial combines
        # summed over ep.
        B_, S_, _ = h.shape
        g, G, Cg = routing_groups(cfg, B_ * S_)
        xg = h.reshape(G, g, cfg.d_model)
        logits = xg.float() @ lp["router"].float()
        probs = torch.softmax(logits, dim=-1)
        dispatch, combine, aux, drop = top_k_dispatch(probs, cfg.top_k, Cg)
        if ep > 1:
            dispatch = dispatch[:, :, e0:e0 + el]
            combine = combine[:, :, e0:e0 + el]
        y = routed_expert_ffn(xg, dispatch, combine, lp, cfg.dtype)
        if ep > 1:
            y = comm.psum(y, ep_group)
        return y.reshape(B_, S_, cfg.d_model), aux.mean(), drop.mean()

    def block(x, lp, cos, sin):
        return moe_layer_body(cfg, x, lp, cos, sin, mlp=sharded_ffn,
                              attn=attn_fn)

    def stage(layers, x, cos, sin):
        aux = drop = torch.zeros((), dtype=torch.float32, device=x.device)
        for lp in unstack_layers({"layers": layers}):
            x, a, dr = checkpoint(block, x, lp, cos, sin,
                                  use_reentrant=False,
                                  preserve_rng_state=False)
            aux, drop = aux + a, drop + dr
        return x, aux, drop

    return stage


def make_pipelined_moe_train(
    cfg,
    mesh: Mesh,
    n_micro: int = 4,
    learning_rate: float = 3e-4,
    key: Any = None,
    params: dict | None = None,
):
    """This rank's dp x pp x ep MoE train state and step. Loss = token
    xent + aux_loss_weight * load-balance aux (summed over the stages'
    layers and the microbatches a stage runs — no bubble tick enters
    it — normalized per layer per microbatch and averaged over dp and
    sp, matching ``moe_loss`` semantics when routing groups align —
    dropless mode or group size dividing the per-microbatch token
    count). ``params``/``key`` as
    :func:`pbs_tpu_torch.parallel.make_sharded_train`."""
    from pbs_tpu_torch.models.moe import init_moe_params

    stage = _moe_pipe_blocks(cfg, mesh, n_micro)
    sched = _Stage(mesh, n_micro)
    rep = mesh.size("dp") * mesh.size("sp") * mesh.size("ep")
    norm = cfg.n_layers * n_micro * rep

    def local(params, tokens):
        inp, targets, weights, total, cos, sin = _pipe_inputs(
            cfg, mesh, tokens, n_micro)
        M, per, S = inp.shape
        dev = tokens.device
        acc = []

        def run(x, m):
            y, a, dr = stage(params["layers"], x, cos, sin)
            acc.append((a, dr))
            return y

        ys, sends, anchor = sched.run(
            lambda m: params["embed"][inp[m].long()].to(cfg.dtype), run,
            (per, S, cfg.d_model), cfg.dtype, dev)
        lm = torch.zeros((), dtype=torch.float32, device=dev)
        if ys is not None:
            lm = _lm_share(cfg, mesh, params, ys, targets, weights, total)
        aux = sum(a for a, _ in acc) / norm
        drop = sum(dr for _, dr in acc).detach() / norm
        term = (lm + cfg.aux_loss_weight * aux
                + sum(sends, torch.zeros((), device=dev)))
        parts = {"loss": lm.detach(), "aux_loss": aux.detach(),
                 "moe_drop_frac": drop}
        return term, parts, [anchor]

    specs = _full_tree_specs(
        moe_pipeline_layer_specs(mesh.shape.get("ep", 1) > 1))
    if params is None:
        params = init_moe_params(cfg, _generator(key, mesh.device),
                                 device=mesh.device)
    local_params = shard_tree(params, mesh, specs)
    del params
    trainer = ShardedTrainer(mesh, specs, local, learning_rate,
                             _global_batch_tokens(mesh))
    state = (local_params, trainer.init_opt_state(local_params), 0)
    return state, trainer.step
