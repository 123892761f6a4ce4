"""Expert parallelism: shard the MoE expert axis over an ``ep`` mesh axis.

The port of ``pbs_tpu.parallel.expert``. The reference annotates the
expert-stacked weights and the (E, C, d) dispatch buffers with
``P('ep', ...)`` while tokens stay batch-sharded over ``dp``, and XLA
lowers the dispatch/combine products into the exchange. Here the
exchange is written at the same seam (``routed_expert_ffn``'s
``constrain_ec``, :func:`expert_constrainer`): each rank routes over all
E experts, keeps the dispatched buffer's rows of its own experts, runs
its expert weights on them, and all-gathers the expert outputs over ep
before the combine. Attention and the router replicate over ep.

Routing groups are the reference's: formed over the global flattened
(B, S) batch with ``routing_groups`` of the global token count. A rank
whose token block is made of whole groups routes them itself; when a
group spans ranks (one group over a batch split by dp, or a group longer
than an sp chunk), the rank all-gathers the batch over its data axes
first, routes every group, and keeps its own rows.
"""

from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from pbs_tpu_torch.models.moe import (
    MoEConfig,
    init_moe_params,
    moe_layer_body,
    routed_expert_ffn,
    routing_groups,
    top_k_dispatch,
)
from pbs_tpu_torch.models.transformer import rms_norm, unstack_layers
from pbs_tpu_torch.parallel import comm
from pbs_tpu_torch.parallel.mesh import Mesh, NamedSharding, PartitionSpec as P
from pbs_tpu_torch.parallel.sharding import (
    ShardedTrainer,
    _axis_group,
    _generator,
    _gathered_attention,
    _global_tokens,
    _size,
    loss_chunk,
    shard_tree,
    sharded_rope,
    sharded_targets,
    vocab_nll_sum,
)


def moe_param_specs(cfg: MoEConfig) -> dict:
    """Experts over ``ep``; attention + router replicated (an MoE mesh is
    dp x ep; a tp axis can be added orthogonally later)."""
    return {
        "embed": P(None, None),
        "layers": {
            "attn_norm": P(None, None),
            "wq": P(None, None, None),
            "wk": P(None, None, None),
            "wv": P(None, None, None),
            "wo": P(None, None, None),
            "mlp_norm": P(None, None),
            "router": P(None, None, None),
            "we1": P(None, "ep", None, None),
            "we3": P(None, "ep", None, None),
            "we2": P(None, "ep", None, None),
        },
        "final_norm": P(None),
        "head": P(None, None),
    }


def moe_serving_param_specs(cfg: MoEConfig) -> dict:
    """MoE tree on a tp SERVING mesh: attention Megatron-sharded like
    the dense serving path, expert FFNs column/row-sharded over the
    SAME tp axis on their d_ff dimension (we1/we3 column, we2 row — the
    sum over tp follows the we2 product), router + norms replicated.
    Experts stay replicated over E here: a serving mesh is one device
    group and tp is its axis; ep-style expert placement is the training
    layout (moe_param_specs)."""
    return {
        "embed": P("tp", None),
        "layers": {
            "attn_norm": P(None, None),
            "wq": P(None, None, "tp"),
            "wk": P(None, None, "tp"),
            "wv": P(None, None, "tp"),
            "wo": P(None, "tp", None),
            "mlp_norm": P(None, None),
            "router": P(None, None, None),
            "we1": P(None, None, None, "tp"),
            "we3": P(None, None, None, "tp"),
            "we2": P(None, None, "tp", None),
        },
        "final_norm": P(None),
        "head": P(None, "tp"),
    }


def shard_moe_params(params: dict, mesh: Mesh, cfg: MoEConfig) -> dict:
    """The full MoE tree cut to this rank's shards."""
    return shard_tree(params, mesh, moe_param_specs(cfg))


def moe_batch_sharding(mesh: Mesh) -> NamedSharding:
    # One definition of "how token batches shard" for every family —
    # a dense/MoE divergence here would be a silent parity break.
    from pbs_tpu_torch.parallel.sharding import batch_sharding

    return batch_sharding(mesh)


class _ExpertExchange:
    """``constrain_ec`` over ep. ``routed_expert_ffn`` pins its three
    (E, C, d)-shaped buffers in a fixed order, and each needs its own
    exchange: the dispatched tokens (all E experts, alike on every rank)
    are cut to this rank's experts; the hidden products are local
    already; the expert outputs are all-gathered back to all E for the
    combine. The order is checked against the shapes."""

    def __init__(self, group):
        self.group = group
        self.n = comm.group_size(group)
        self._role = 0
        self._rows = None

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim != 3:
            return x
        role = self._role
        self._role = (role + 1) % 3
        if role == 0:
            if x.shape[0] % self.n:
                raise ValueError(
                    f"ep={self.n} must divide n_experts={x.shape[0]}")
            self._rows = x.shape[0]
            return comm.shard(x, self.group, 0)
        if x.shape[0] * self.n != self._rows:
            raise RuntimeError(
                f"expert buffer {tuple(x.shape)} out of routed_expert_ffn's "
                f"order (dispatched {self._rows} experts over ep={self.n})")
        if role == 1:
            return x
        return comm.all_gather(x, self.group, 0)


def expert_constrainer(mesh: Mesh | None):
    """Exchanges the (E, C, d) expert buffers over ep: the boundary
    where the reference's token all-to-all materializes (see
    :class:`_ExpertExchange`). The identity without an ep axis."""
    if mesh is None or "ep" not in mesh.axis_names or mesh.size("ep") == 1:
        return lambda x: x
    return _ExpertExchange(mesh.group("ep"))


def residual_constrainer(mesh: Mesh | None):
    """The residual's pin, P('dp', seq, None): this rank holds its block
    already, so the pin exchanges nothing and is the identity."""
    return lambda x: x


def _data_routed_ffn(cfg: MoEConfig, mesh: Mesh, constrain_ec):
    """The routed FFN behind ``moe_layer_body``'s ``mlp`` seam on a
    dp x ep (x sp) mesh: the reference's global routing groups (see the
    module docstring), ``constrain_ec`` over ep. Returns (y, this rank's
    share of the mean aux, of the mean drop)."""
    dp, sp = _axis_group(mesh, "dp"), _axis_group(mesh, "sp")
    ndp, nsp, nep = _size(dp), _size(sp), mesh.size("ep")

    def mlp(h, lp):
        B, S, d = h.shape
        g, G, Cg = routing_groups(cfg, B * ndp * S * nsp)
        whole = (S % g == 0) if nsp > 1 else ((B * S) % g == 0)
        if whole:
            hg, rep = h, nep
        else:
            hg = h
            if nsp > 1:
                hg = comm.all_gather(hg, sp, 1)
            if ndp > 1:
                hg = comm.all_gather(hg, dp, 0)
            rep = nep * ndp * nsp
        xg = hg.reshape(-1, g, d)
        logits = xg.float() @ lp["router"].float()
        probs = torch.softmax(logits, dim=-1)
        dispatch, combine, aux, drop = top_k_dispatch(probs, cfg.top_k, Cg)
        y = routed_expert_ffn(xg, dispatch, combine, lp, cfg.dtype,
                              constrain_ec).reshape(hg.shape)
        if not whole:
            if ndp > 1:
                y = comm.shard(y, dp, 0)
            if nsp > 1:
                y = comm.shard(y, sp, 1)
        return y, aux.sum() / (G * rep), drop.sum() / (G * rep)

    return mlp


def moe_local_loss(cfg: MoEConfig, mesh: Mesh, params: dict,
                   tokens: torch.Tensor):
    """This rank's share of the global MoE loss (lm + aux_loss_weight *
    aux) for its token block, and its shares of the metrics.

    The forward covers the positions the reference's ``moe_loss``
    routes: tokens[:, :-1], or all S with the last masked under the
    chunked tail and the sequence-parallel impls (its ``full_seq``).
    With an sp axis the sequence is sharded, so all S are forwarded
    whatever the impl; for "xla" or "pallas" attention there, the
    routing groups then hold each row's last token too."""
    sp = _axis_group(mesh, "sp")
    seq_par = cfg.attn_impl in ("ring", "ulysses")
    if seq_par or cfg.loss_chunks > 1 or _size(sp) > 1:
        targets, weights, total = sharded_targets(tokens, mesh)
    else:
        targets, tokens = tokens[:, 1:], tokens[:, :-1]
        weights = torch.ones(targets.shape, dtype=torch.float32,
                             device=targets.device)
        total = targets.numel() * mesh.size("dp")
    chunk = loss_chunk(cfg, tokens.shape[1] * _size(sp))
    constrain = residual_constrainer(mesh)
    constrain_ec = expert_constrainer(mesh)
    mlp = _data_routed_ffn(cfg, mesh, constrain_ec)
    attn = None
    if _size(sp) > 1 and not seq_par:
        attn = _gathered_attention(cfg, sp)
    body_mesh = mesh if seq_par else None

    x = params["embed"][tokens.long()].to(cfg.dtype)
    cos, sin = sharded_rope(cfg, tokens.shape[1], mesh, x.device)
    aux = drop = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in unstack_layers(params):
        args = (cfg, x, lp, cos, sin, constrain, constrain_ec, body_mesh,
                mlp, attn)
        if cfg.remat:
            x, a, dr = checkpoint(moe_layer_body, *args, use_reentrant=False,
                                  preserve_rng_state=False)
        else:
            x, a, dr = moe_layer_body(*args)
        aux, drop = aux + a, drop + dr
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    nll = vocab_nll_sum(cfg, x, params["head"], targets, weights, None, chunk)
    lm = nll / (total * mesh.size("ep"))
    aux, drop = aux / cfg.n_layers, drop / cfg.n_layers
    parts = {"loss": lm.detach(), "aux_loss": aux.detach(),
             "moe_drop_frac": drop.detach()}
    return lm + cfg.aux_loss_weight * aux, parts


def make_sharded_moe_train(
    cfg: MoEConfig,
    mesh: Mesh,
    learning_rate: float = 3e-4,
    key: Any = None,
    params: dict | None = None,
):
    """This rank's sharded MoE train state and step on a dp x ep mesh —
    or dp x ep x sp for long-context MoE (cfg.attn_impl "ring" or
    "ulysses": the sequence stays sharded through attention while the
    expert buffers exchange over ep). ``params``/``key`` as
    :func:`pbs_tpu_torch.parallel.make_sharded_train`; metrics
    ``{"loss", "aux_loss", "moe_drop_frac", "tokens"}``, global."""
    seq_par = cfg.attn_impl in ("ring", "ulysses")
    if seq_par and "sp" not in mesh.axis_names:
        raise ValueError(
            f"attn_impl={cfg.attn_impl!r} requires an 'sp' axis in the "
            f"mesh; got axes {mesh.axis_names}"
        )
    specs = moe_param_specs(cfg)
    if params is None:
        params = init_moe_params(cfg, _generator(key, mesh.device),
                                 device=mesh.device)
    local = shard_tree(params, mesh, specs)
    del params
    trainer = ShardedTrainer(
        mesh, specs, lambda p, t: moe_local_loss(cfg, mesh, p, t),
        learning_rate, _global_tokens(mesh))
    state = (local, trainer.init_opt_state(local), 0)
    return state, trainer.step
