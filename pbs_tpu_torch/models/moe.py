"""Mixture-of-Experts decoder: the second model family.

The port of ``pbs_tpu.models.moe``. The MoE decoder is a workload the
framework schedules: the flagship's attention with a routed SwiGLU FFN
in place of the dense one. The design is the reference's:

- **Static-shape token-choice routing** (Switch/Mesh-TF lineage): top-k
  gating with a fixed per-expert capacity; dispatch and combine are
  dense one-hot tensors consumed by products (``torch.einsum``), so the
  whole MoE layer is matrix products — no gather/scatter, no shape that
  depends on the routing.
- **Experts as a leading axis** ``(L, E, d, f)``: one layer body on a
  layer's slice, the expert products batched over E.
- **Router overflow as contention telemetry**: the fraction of dropped
  tokens is returned in the step metrics and, in serving, as the
  engine's ``mlp_extra_mean``.

Where PyTorch parts from JAX: ``jax.lax.top_k`` puts the lower index
first among equal values, and ``torch.topk`` promises no order on ties,
so the top k come from a stable descending sort. ``vmap`` over routing
groups is a leading batch axis. The reference's plain ``jax.checkpoint``
of the layer is full recompute (``torch.utils.checkpoint``) whatever
``remat_policy`` says, as there. The router product runs in fp32 and
stays off TF32 (PyTorch's default). The sharding seams are the
reference's: ``constrain`` pins the residual, ``constrain_ec`` the
(E, C, d) expert buffers (``parallel.expert.expert_constrainer``
exchanges them over ``ep``), ``mesh`` reaches the sequence-parallel
attention, and ``moe_layer_body``'s ``mlp=`` and ``attn=`` take the
expert- and sequence-parallel bodies of ``parallel/``.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from pbs_tpu_torch.models.quant import embed_rows, wload
from pbs_tpu_torch.models.transformer import (
    TransformerConfig,
    apply_rope,
    causal_attention,
    chunked_head_xent,
    default_optimizer,
    resolve_device,
    rms_norm,
    rope_tables,
    shift_targets_and_weights,
    token_xent,
    unstack_layers,
    value_and_grad,
)
from pbs_tpu_torch.obs import phases


def _identity(a: torch.Tensor) -> torch.Tensor:
    return a


@dataclasses.dataclass(frozen=True)
class MoEConfig(TransformerConfig):
    n_experts: int = 8
    top_k: int = 2
    # Per-expert slots = capacity_factor * top_k * group_tokens / n_experts.
    capacity_factor: float = 1.25
    aux_loss_weight: float = 1e-2
    # Tokens are routed within fixed-size groups (Mesh-TF style) so the
    # dense (g, E, C) dispatch tensors stay O(g) per group. Groups that
    # don't divide T fall back to one group.
    router_group_size: int = 4096
    # Provably dropless routing: capacity = group token count, the exact
    # worst case, so overflow is impossible for any routing pattern. The
    # mode engine/lockstep parity and speculative verification need; its
    # dispatch tensors are O(g²E) per group, so it is a serving mode, and
    # dropless_group_max guards against training with it.
    dropless: bool = False
    dropless_group_max: int = 1024

    def num_params(self) -> int:
        d, f, v = self.d_model, self.d_ff, self.vocab
        hd, E = self.head_dim, self.n_experts
        per_layer = (
            d * (self.n_heads * hd)
            + 2 * d * (self.n_kv_heads * hd)
            + (self.n_heads * hd) * d
            + d * E  # router
            + E * 3 * d * f  # we1, we3, we2
            + 2 * d  # norms
        )
        return v * d + self.n_layers * per_layer + d + d * v

    def capacity(self, n_tokens: int) -> int:
        if self.dropless:
            if n_tokens > self.dropless_group_max:
                raise ValueError(
                    f"dropless routing over a {n_tokens}-token group "
                    f"exceeds dropless_group_max="
                    f"{self.dropless_group_max} (dispatch memory is "
                    "O(g²·E)). Shrink router_group_size (grouping is "
                    "semantics-free in dropless mode — moe_mlp "
                    "auto-tiles this way), use capacity routing for "
                    "training/long-prefill scale, or raise the guard "
                    "knowingly"
                )
            return n_tokens
        per = self.capacity_factor * self.top_k * n_tokens / self.n_experts
        return max(1, int(np.ceil(per)))


def init_moe_params(cfg: MoEConfig, generator: torch.Generator,
                    device: Any = None) -> dict:
    """fp32 master params; layers stacked on axis 0, experts on axis 1.
    The reference's distributions (normal / sqrt(fan_in) with fan_in =
    shape[-2], so d for the (L, E, d, f) experts; the embedding scaled by
    sqrt(d_model); unit norms). Streams differ from ``jax.random``: for
    equal weights, use ``params_from_numpy``. ``generator`` must live on
    ``device``."""
    dev = resolve_device(device)
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    hd, nh, nkv, L = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads, cfg.n_layers

    def dense(shape):
        fan_in = shape[-2] if len(shape) > 1 else shape[-1]
        w = torch.randn(shape, generator=generator, device=dev,
                        dtype=torch.float32)
        return w.div_(math.sqrt(fan_in))

    layers = {
        "attn_norm": torch.ones((L, d), device=dev),
        "wq": dense((L, d, nh * hd)),
        "wk": dense((L, d, nkv * hd)),
        "wv": dense((L, d, nkv * hd)),
        "wo": dense((L, nh * hd, d)),
        "mlp_norm": torch.ones((L, d), device=dev),
        "router": dense((L, d, E)),
        "we1": dense((L, E, d, f)),  # gate
        "we3": dense((L, E, d, f)),  # up
        "we2": dense((L, E, f, d)),  # down
    }
    return {
        "embed": dense((cfg.vocab, d)).mul_(math.sqrt(d)),
        "layers": layers,
        "final_norm": torch.ones((d,), device=dev),
        "head": dense((d, cfg.vocab)),
    }


# -- routing ----------------------------------------------------------------


def top_k_dispatch(probs: torch.Tensor, k: int, capacity: int):
    """Static-shape top-k routing with capacity dropping, over any
    leading (group) axes.

    probs (..., T, E) fp32 -> dispatch/combine (..., T, E, C), plus
    (aux_loss, drop_frac) of shape (...). dispatch is the 0/1
    token->slot assignment; combine carries the renormalized gate
    weight. Tokens overflowing an expert's C slots are dropped for that
    choice (the residual connection carries them). Gradients flow
    through the top-k values (combine) and the mean probabilities (aux),
    never through the one-hot dispatch."""
    T, E = probs.shape[-2:]
    # A stable descending sort takes the lower index first among equal
    # probabilities, as jax.lax.top_k does.
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[..., :k], topi[..., :k]
    topv = topv / torch.clamp(topv.sum(dim=-1, keepdim=True), min=1e-9)

    lead = probs.shape[:-2]
    dispatch = probs.new_zeros((*lead, T, E, capacity))
    combine = probs.new_zeros((*lead, T, E, capacity))
    # slots used by earlier choices
    base = torch.zeros((*lead, E), dtype=torch.int32, device=probs.device)
    for i in range(k):  # k is tiny: unrolled
        onehot = F.one_hot(topi[..., i], E).to(probs.dtype)  # (..., T, E)
        # Slot index within each expert: running count of earlier tokens
        # making the same choice, offset by slots burned by choice < i.
        pos = (torch.cumsum(onehot, dim=-2) - onehot
               + base.unsqueeze(-2).to(probs.dtype))
        pos_t = torch.sum(pos * onehot, dim=-1)  # (..., T)
        keep = (pos_t < capacity).to(probs.dtype)
        slot = F.one_hot(torch.clamp(pos_t.to(torch.int64), 0, capacity - 1),
                         capacity).to(probs.dtype)
        d_i = (onehot.unsqueeze(-1) * slot.unsqueeze(-2)
               * keep[..., None, None])
        dispatch = dispatch + d_i
        combine = combine + topv[..., i][..., None, None] * d_i
        base = base + torch.sum(onehot * keep.unsqueeze(-1),
                                dim=-2).to(torch.int32)

    # Switch-style load-balance aux loss on the top-1 assignment:
    # E * mean_e(frac_tokens_e * mean_prob_e).
    top1 = F.one_hot(topi[..., 0], E).to(probs.dtype)
    frac = torch.mean(top1, dim=-2)
    mean_p = torch.mean(probs, dim=-2)
    aux = E * torch.sum(frac * mean_p, dim=-1)
    # The reference's 1 - kept / (T k), with the subtraction first: a
    # device that divides by the reciprocal makes 1 - kept / (T k) a few
    # ulps off 0 when nothing dropped; (T k - kept) is exactly 0 then.
    drop_frac = (T * k - torch.sum(dispatch, dim=(-3, -2, -1))) / (T * k)
    return dispatch, combine, aux, drop_frac


def routing_groups(cfg: MoEConfig, T: int) -> tuple[int, int, int]:
    """(group size g, group count G, capacity Cg) for T tokens — the
    one place the grouping/auto-tiling rules live."""
    g = cfg.router_group_size
    if cfg.dropless:
        # Grouping carries no routing semantics in dropless mode, so
        # pick the tiling here: the largest divisor of T within both the
        # configured group size and the memory guard.
        bound = min(g if g > 0 else T, cfg.dropless_group_max, T)
        g = next(d_ for d_ in range(bound, 0, -1) if T % d_ == 0)
        # Correct at any T, but a token count with no usable divisor
        # (prime T > bound) collapses to tiny groups: never silently.
        if g * 4 < bound:
            warnings.warn(
                f"dropless auto-tiling picked group size {g} for "
                f"T={T} tokens (bound {bound}): T has no divisor near "
                "the configured group size, so routing will run "
                f"{T // g} tiny groups — a large dispatch overhead. "
                "Pad the token count to a composite size (e.g. a "
                "multiple of router_group_size).",
                stacklevel=2,
            )
    elif g <= 0 or T % g != 0:
        g = T  # single group (tiny shapes / tests)
    return g, T // g, cfg.capacity(g)


def routed_expert_ffn(xg: torch.Tensor, dispatch: torch.Tensor,
                      combine: torch.Tensor, lp: dict, dt: torch.dtype,
                      constrain_ec: Callable = _identity) -> torch.Tensor:
    """Dense-dispatch expert SwiGLU on an expert slice: xg (G, g, d),
    dispatch/combine (G, g, Ne, Cg) with Ne the experts whose weights
    ``lp`` holds. The expert buffers are (Ne, G·Cg, d)."""
    G, g, Ne, Cg = dispatch.shape
    d = xg.shape[-1]
    with phases.span("moe.experts", count=Ne):
        ein = torch.einsum("gtec,gtd->egcd", dispatch.to(dt), xg)
        ein = constrain_ec(ein.reshape(Ne, G * Cg, d))
        gate = F.silu(torch.einsum("ecd,edf->ecf", ein,
                                   wload(lp["we1"], dt)))
        up = torch.einsum("ecd,edf->ecf", ein, wload(lp["we3"], dt))
        eout = torch.einsum("ecf,efd->ecd", constrain_ec(gate * up),
                            wload(lp["we2"], dt))
        eout = constrain_ec(eout).reshape(Ne, G, Cg, d)
    with phases.span("moe.combine", count=Ne):
        return torch.einsum("gtec,egcd->gtd", combine.to(dt), eout)


def moe_mlp(cfg: MoEConfig, x: torch.Tensor, lp: dict,
            constrain_ec: Callable = _identity):
    """Routed SwiGLU experts. x (B, S, d) -> (y, aux, drop_frac).

    Routing happens independently within fixed-size token groups, so the
    dense dispatch/combine tensors are (G, g, E, Cg) with Cg ∝ g/E —
    memory linear in T."""
    B, S, d = x.shape
    g, G, Cg = routing_groups(cfg, B * S)
    xg = x.reshape(G, g, d)

    with phases.span("moe.route", count=B * S):
        logits = xg.float() @ lp["router"].float()
        probs = torch.softmax(logits, dim=-1)  # (G, g, E)
        dispatch, combine, aux, drop = top_k_dispatch(probs, cfg.top_k, Cg)

    y = routed_expert_ffn(xg, dispatch, combine, lp, cfg.dtype, constrain_ec)
    return y.reshape(B, S, d), aux.mean(), drop.mean()


def moe_layer_body(cfg: MoEConfig, x: torch.Tensor, lp: dict,
                   cos: torch.Tensor, sin: torch.Tensor,
                   constrain: Callable = _identity,
                   constrain_ec: Callable = _identity, mesh=None,
                   mlp: Callable | None = None, attn: Callable | None = None):
    """One MoE block. ``mlp`` (default: the full-E :func:`moe_mlp` with
    ``constrain_ec``) is the routed-FFN seam, ``(h, lp) -> (y, aux,
    drop)``; ``attn`` the attention seam, ``(q, k, v) -> out`` (default:
    ``causal_attention`` under ``cfg.attn_impl`` and ``mesh``);
    ``constrain`` pins the residual after each sum."""
    B, S, _ = x.shape
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = cfg.dtype

    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q = (h @ lp["wq"].to(dt)).reshape(B, S, nh, hd)
    k = (h @ lp["wk"].to(dt)).reshape(B, S, nkv, hd)
    v = (h @ lp["wv"].to(dt)).reshape(B, S, nkv, hd)
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    if attn is None:
        a = causal_attention(q, k, v, cfg, mesh)
    else:
        a = attn(q, k, v)
    x = constrain(x + a.reshape(B, S, nh * hd) @ lp["wo"].to(dt))

    h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    if mlp is None:
        y, aux, drop = moe_mlp(cfg, h, lp, constrain_ec)
    else:
        y, aux, drop = mlp(h, lp)
    return constrain(x + y), aux, drop


def moe_forward_hidden(cfg: MoEConfig, params: dict, tokens: torch.Tensor,
                       constrain: Callable = _identity,
                       constrain_ec: Callable = _identity, mesh=None):
    """tokens (B, S) -> (final normed hidden (B, S, d), aux, drop)."""
    B, S = tokens.shape
    x = constrain(embed_rows(params["embed"], tokens, cfg.dtype))
    cos, sin = rope_tables(cfg, S, device=x.device)
    aux = drop = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in unstack_layers(params):
        if cfg.remat:
            # Full recompute, as the reference's plain jax.checkpoint:
            # remat_policy does not apply to the MoE layer.
            x, a, d = checkpoint(moe_layer_body, cfg, x, lp, cos, sin,
                                 constrain, constrain_ec, mesh,
                                 use_reentrant=False,
                                 preserve_rng_state=False)
        else:
            x, a, d = moe_layer_body(cfg, x, lp, cos, sin, constrain,
                                     constrain_ec, mesh)
        aux, drop = aux + a, drop + d
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, aux / cfg.n_layers, drop / cfg.n_layers


def moe_forward(cfg: MoEConfig, params: dict, tokens: torch.Tensor,
                constrain: Callable = _identity,
                constrain_ec: Callable = _identity, mesh=None):
    """tokens (B, S) -> (logits (B, S, V) fp32, aux_loss, drop_frac)."""
    x, aux, drop = moe_forward_hidden(cfg, params, tokens, constrain,
                                      constrain_ec, mesh)
    logits = (x @ params["head"].to(cfg.dtype)).float()
    return logits, aux, drop


# -- serving (KV-cached autoregressive decode) ------------------------------


def moe_forward_with_cache(cfg: MoEConfig, params: dict,
                           tokens: torch.Tensor, cache: dict):
    """The MoE twin of ``generate.forward_with_cache``: attention runs
    against the KV slabs (same cache layout), the FFN routes per
    position. Returns (logits (B, S, V) fp32, the cache, mean
    drop_frac) — the drop fraction stays observable in serving, where a
    capacity-starved router silently degrades quality."""
    from pbs_tpu_torch.models.generate import _forward_with_cache_impl

    logits, cache, drop_sum = _forward_with_cache_impl(
        cfg, params, tokens, cache, mlp_fn=moe_slot_mlp(cfg))
    return logits, cache, drop_sum / cfg.n_layers


def make_moe_generate(cfg: MoEConfig, max_new_tokens: int,
                      temperature: float = 0.0):
    """MoE twin of ``generate.make_generate`` (the same decode loop);
    ``generate(params, prompt, generator=None) -> ((B, max_new_tokens)
    int32 tokens, token-weighted mean drop_frac)``."""
    from pbs_tpu_torch.models.generate import make_generate_loop

    def fwd(params, tokens, cache):
        return moe_forward_with_cache(cfg, params, tokens, cache)

    loop = make_generate_loop(cfg, max_new_tokens, temperature, fwd)

    def generate(params: dict, prompt: torch.Tensor,
                 generator: torch.Generator | None = None):
        toks, drop0, dsum, P = loop(params, prompt, generator)
        # TOKEN-weighted: the prefill routed P tokens per forward, each
        # decode step 1, so a capacity-starved long-prompt prefill cannot
        # hide behind clean decode steps.
        total_tokens = P + max(0, max_new_tokens - 1)
        return toks, (drop0 * P + dsum) / total_tokens

    return generate


def moe_slot_mlp(cfg: MoEConfig, constrain_ec: Callable = _identity):
    """The MoE FFN block in the serving ``mlp_fn`` contract — ``(lp, h)
    -> (y, drop_frac)`` — shared by the lockstep cache path and the
    continuous-batching engines (``ContinuousBatcher(...,
    mlp_fn=moe_slot_mlp(cfg))``, where the drop fraction surfaces as
    ``stats()['mlp_extra_mean']``). For engine/lockstep routing parity
    use ``MoEConfig(dropless=True)``; under capacity routing a nonzero
    drop means co-resident lanes compete for expert slots."""
    def mlp(lp, h):
        y, _aux, drop = moe_mlp(cfg, h, lp, constrain_ec)
        return y, drop

    return mlp


# -- training ---------------------------------------------------------------


def moe_loss(cfg: MoEConfig, params: dict, tokens: torch.Tensor,
             constrain: Callable = _identity,
             constrain_ec: Callable = _identity, mesh=None,
             full_seq: bool = False):
    """``(lm + aux_loss_weight * aux, (lm, aux, drop))``. ``full_seq``
    forwards all S tokens and drops the last logit (the routing groups
    then hold S tokens per row); ``cfg.loss_chunks > 1`` uses the
    chunked loss tail shared with the dense family, so the (B, S, V)
    logits never exist at once."""
    if cfg.loss_chunks > 1:
        x, aux, drop = moe_forward_hidden(cfg, params, tokens, constrain,
                                          constrain_ec, mesh)
        targets, weights = shift_targets_and_weights(tokens)
        lm = chunked_head_xent(cfg, x, params["head"], targets, weights,
                               cfg.loss_chunks)
        return lm + cfg.aux_loss_weight * aux, (lm, aux, drop)
    if full_seq:
        logits, aux, drop = moe_forward(cfg, params, tokens, constrain,
                                        constrain_ec, mesh)
        lm = token_xent(logits[:, :-1], tokens[:, 1:])
    else:
        logits, aux, drop = moe_forward(cfg, params, tokens[:, :-1],
                                        constrain, constrain_ec, mesh)
        lm = token_xent(logits, tokens[:, 1:])
    return lm + cfg.aux_loss_weight * aux, (lm, aux, drop)


def make_moe_train_step(cfg: MoEConfig, learning_rate: float = 3e-4,
                        constrain: Callable = _identity,
                        constrain_ec: Callable = _identity, mesh=None,
                        full_seq: bool = False):
    """Returns (init_opt_state, train_step), AdamW as
    ``default_optimizer``. ``train_step(state, tokens) -> (state,
    metrics)`` with state (params, opt_state, step), the params and
    moments updated in place; metrics ``{"loss", "aux_loss",
    "moe_drop_frac", "tokens"}`` — the drop fraction is the in-graph
    contention hint the feedback policy can consume."""
    tx = default_optimizer(learning_rate)

    def init_opt_state(params):
        return tx.init(params)

    def train_step(state, tokens):
        params, opt_state, step = state
        (_, (lm, aux, drop)), grads = value_and_grad(
            lambda p: moe_loss(cfg, p, tokens, constrain, constrain_ec,
                               mesh, full_seq), params)
        opt_state = tx.update(grads, opt_state, params)
        ntok = tokens.shape[0] * (tokens.shape[1] - 1)
        metrics = {
            "loss": lm.detach(),
            "aux_loss": aux.detach(),
            "moe_drop_frac": drop.detach(),
            "tokens": ntok,
        }
        return (params, opt_state, step + 1), metrics

    return init_opt_state, train_step
