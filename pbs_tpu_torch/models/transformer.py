"""Flagship workload: a LLaMA-style decoder-only transformer.

The port of ``pbs_tpu.models.transformer``: forward, loss, AdamW and the
training step. Parameters are a plain dict with the reference's key
names and its L-stacked layer layout, so a tree initialised by the JAX
package crosses over unchanged through :func:`params_from_numpy`.
Compute runs in ``cfg.dtype`` with fp32 normalisation, fp32 logits and
fp32 master parameters, as there.

``attn_impl="xla"`` attends with dense PyTorch (the reference's
XLA-fused einsum path); ``"pallas"`` attends through the flash kernels
(``pbs_tpu_torch.ops.attention``), forward and backward. ``remat``
recomputes each layer in the backward (``torch.utils.checkpoint``);
``loss_chunks`` scans the head over sequence chunks so the (B, S,
vocab) logits never exist at once. The sequence-parallel impls ("ring",
"ulysses") and the sharding hooks (``constrain``, ``mesh``) belong to
``parallel/``, not ported yet (ROADMAP).

JAX's steps are pure; here the training step updates the fp32 master
parameters and the optimizer state in place, so a step costs no second
copy of either.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from pbs_tpu_torch.models.quant import embed_rows
from pbs_tpu_torch.ops.attention import flash_attention


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab: int = 32_000
    d_model: int = 512
    n_layers: int = 8
    n_heads: int = 8
    n_kv_heads: int = 4  # GQA: kv heads < query heads
    d_ff: int = 1_408  # ~2.67x d_model, SwiGLU-adjusted
    max_seq: int = 1_024
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16  # compute dtype
    # Recompute each layer in the backward: "full" saves nothing inside
    # it, "dots" saves the weight products' outputs (aten.mm).
    remat: bool = False
    remat_policy: str = "full"
    # "xla" (dense torch) or "pallas" (the flash kernels).
    attn_impl: str = "xla"
    ring_block: str = "dense"
    # Chunked cross-entropy over n sequence chunks; 0/1 = off.
    loss_chunks: int = 0

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def bytes_per_token_step(self) -> int:
        """Rough device-memory traffic per token per training step
        (params read fwd+bwd+update), for telemetry estimates."""
        return 6 * self.num_params() // max(1, self.max_seq)

    def num_params(self) -> int:
        d, f, v = self.d_model, self.d_ff, self.vocab
        hd = self.head_dim
        per_layer = (
            d * (self.n_heads * hd)  # wq
            + 2 * d * (self.n_kv_heads * hd)  # wk, wv
            + (self.n_heads * hd) * d  # wo
            + 3 * d * f  # w1, w3, w2
            + 2 * d  # norms
        )
        return v * d + self.n_layers * per_layer + d + d * v


# -- device resolution ------------------------------------------------------


def resolve_device(device: Any) -> torch.device:
    """``device`` as a torch.device; None means the card, and with no
    card that raises instead of quietly running on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' "
                "explicitly to run on the host")
        return torch.device("cuda")
    return torch.device(device)


# -- initialization ---------------------------------------------------------


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device: Any = None) -> dict:
    """fp32 master params, layer params stacked on axis 0; the same
    distributions as the reference (normal / sqrt(fan_in), embedding
    scaled by sqrt(d_model), unit norms). Streams differ from
    ``jax.random``: for equal weights, use :func:`params_from_numpy`.
    ``generator`` must live on ``device``."""
    dev = resolve_device(device)
    d, f = cfg.d_model, cfg.d_ff
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
        "w1": dense((L, d, f)),  # gate
        "w3": dense((L, d, f)),  # up
        "w2": dense((L, f, d)),  # down
    }
    params = {
        "embed": dense((cfg.vocab, d)).mul_(math.sqrt(d)),  # scaled emb
        "layers": layers,
        "final_norm": torch.ones((d,), device=dev),
        "head": dense((d, cfg.vocab)),
    }
    return params


def cast_params(tree: Any, dtype: torch.dtype) -> Any:
    """Cast every floating leaf once (the per-call ``wload`` cast,
    hoisted: the values are bit-equal, and eager decoding no longer
    copies the weights on every step)."""
    if isinstance(tree, dict):
        return {k: cast_params(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree


def params_from_numpy(tree: Any, device: Any = None,
                      dtype: torch.dtype | None = None) -> Any:
    """Carry a parameter tree of numpy arrays (e.g. the JAX package's
    ``init_params`` output through ``np.asarray``, or its
    ``quantize_weights`` output) onto ``device``, keeping its key names,
    layout and integer leaves (int8 ``q`` stays int8). ``dtype`` casts
    the floating leaves once at load."""
    dev = resolve_device(device)

    def leaf(x):
        t = torch.from_numpy(np.array(x)).to(dev)  # a writable copy
        return t if dtype is None or not t.is_floating_point() else t.to(dtype)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return leaf(node)

    return walk(tree)


# -- building blocks --------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    # Normalize in fp32 for stability, cast back to compute dtype.
    xf = x.float()
    scale = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * scale).to(x.dtype) * weight.to(x.dtype)


def rope_tables(cfg: TransformerConfig, seq: int,
                device: Any = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) tables (seq, head_dim / 2) fp32 on ``device`` (None
    means the card, and raises without one)."""
    dev = resolve_device(device)
    half = cfg.head_dim // 2
    freqs = cfg.rope_theta ** (
        -torch.arange(0, half, dtype=torch.float32, device=dev) / half)
    t = torch.arange(seq, dtype=torch.float32, device=dev)
    ang = torch.outer(t, freqs)  # (seq, half)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, hd). Rotate pairs (even, odd) halves."""
    x1, x2 = x.chunk(2, dim=-1)
    cos = cos[None, :, None, :].to(x.dtype)
    sin = sin[None, :, None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     cfg: TransformerConfig) -> torch.Tensor:
    """(B, S, H, hd) GQA attention with a causal mask. "xla" is dense
    torch; "pallas" is the flash kernels. Unknown or unported
    impls are rejected loudly — never a silent dense fallback."""
    if cfg.attn_impl == "pallas":
        return flash_attention(q, k, v, causal=True)
    if cfg.attn_impl in ("ring", "ulysses"):
        raise ValueError(
            f"attn_impl={cfg.attn_impl!r} needs a mesh with an 'sp' axis; "
            "the sequence-parallel impls are not ported yet (ROADMAP "
            "queue 1, parallel/)")
    if cfg.attn_impl != "xla":
        raise ValueError(
            f"unknown attn_impl {cfg.attn_impl!r}; "
            "expected 'xla', 'pallas', 'ring', or 'ulysses'"
        )
    B, S, H, hd = q.shape
    nkv = k.shape[2]
    group = H // nkv
    # (B, nkv, group, S, hd) queries against (B, nkv, S, hd) keys.
    qg = q.reshape(B, S, nkv, group, hd).permute(0, 2, 3, 1, 4)
    kt = k.permute(0, 2, 1, 3)  # (B, nkv, S, hd)
    vt = v.permute(0, 2, 1, 3)
    scores = torch.einsum("bngqh,bnkh->bngqk", qg, kt) / math.sqrt(hd)
    pos = torch.arange(S, device=q.device)
    keep = pos[None, :] <= pos[:, None]
    scores = scores.masked_fill(~keep, torch.finfo(scores.dtype).min)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bngqk,bnkh->bngqh", probs, vt)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd)


def layer_body(cfg: TransformerConfig, x: torch.Tensor, lp: dict,
               cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """One transformer block on one layer's params ``lp``."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    dt = cfg.dtype

    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q = (h @ lp["wq"].to(dt)).reshape(B, S, -1, hd)
    k = (h @ lp["wk"].to(dt)).reshape(B, S, -1, hd)
    v = (h @ lp["wv"].to(dt)).reshape(B, S, -1, hd)
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    a = causal_attention(q, k, v, cfg)
    x = x + a.reshape(B, S, -1) @ lp["wo"].to(dt)

    h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    gate = torch.nn.functional.silu(h @ lp["w1"].to(dt))
    up = h @ lp["w3"].to(dt)
    return x + (gate * up) @ lp["w2"].to(dt)


def layer_params(params: dict, i: int) -> dict:
    """Layer ``i``'s slice of the L-stacked layer params (views); an
    int8 ``{"q", "s"}`` leaf slices into ``{"q": q[i], "s": s[i]}``."""
    return {name: ({"q": w["q"][i], "s": w["s"][i]}
                   if isinstance(w, dict) else w[i])
            for name, w in params["layers"].items()}


# -- forward / loss ---------------------------------------------------------


def _save_weight_products(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """The "dots" remat policy, ``dots_with_no_batch_dims_saveable``'s
    counterpart: keep the outputs of the products with no batch
    dimension (the weight matmuls, ``aten.mm`` once torch folds the
    leading dims) and recompute everything else — norms, rope,
    attention, activations."""
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _layer_fn(cfg: TransformerConfig) -> Callable:
    """``layer_body`` bound to ``cfg``, under the configured remat."""
    body = functools.partial(layer_body, cfg)
    if not cfg.remat:
        return body
    if cfg.remat_policy == "dots":
        kwargs = {"context_fn": functools.partial(
            create_selective_checkpoint_contexts, _save_weight_products)}
    elif cfg.remat_policy == "full":
        kwargs = {}
    else:
        raise ValueError(
            f"unknown remat_policy {cfg.remat_policy!r}; "
            "expected 'full' or 'dots'"
        )

    def rematted(x, lp, cos, sin):
        return checkpoint(body, x, lp, cos, sin, use_reentrant=False,
                          preserve_rng_state=False, **kwargs)

    return rematted


def forward_hidden(cfg: TransformerConfig, params: dict,
                   tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, S) int -> final normed hidden (B, S, d_model). A
    Python loop over layers stands where the reference scans."""
    B, S = tokens.shape
    x = embed_rows(params["embed"], tokens, cfg.dtype)
    cos, sin = rope_tables(cfg, S, device=x.device)
    body = _layer_fn(cfg)
    for i in range(cfg.n_layers):
        x = body(x, layer_params(params, i), cos, sin)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def forward(cfg: TransformerConfig, params: dict,
            tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, S) int -> logits (B, S, vocab) fp32."""
    x = forward_hidden(cfg, params, tokens)
    return (x @ params["head"].to(cfg.dtype)).float()


def token_xent(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of int targets under fp32 logits."""
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    return -ll.mean()


def shift_targets_and_weights(tokens: torch.Tensor
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Causal-shift targets for a full-S forward: targets[b, s] =
    tokens[b, s+1], the (targetless) last position zero-padded and
    masked out by the returned fp32 weights."""
    B, S = tokens.shape
    pad = tokens.new_zeros((B, 1))
    targets = torch.cat([tokens[:, 1:], pad], dim=1)
    weights = torch.ones((B, S), dtype=torch.float32, device=tokens.device)
    weights[:, -1] = 0.0
    return targets, weights


def _chunk_nll(dtype: torch.dtype, xc: torch.Tensor, head: torch.Tensor,
               tc: torch.Tensor, wc: torch.Tensor) -> torch.Tensor:
    logits = (xc @ head.to(dtype)).float()
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, tc.long()[..., None])[..., 0]
    return torch.sum(ll * wc)


def chunked_head_xent(cfg: TransformerConfig, x: torch.Tensor,
                      head: torch.Tensor, targets: torch.Tensor,
                      weights: torch.Tensor, n_chunks: int) -> torch.Tensor:
    """Cross-entropy over the head without materializing (B, S, vocab):
    one checkpointed chunk of S/n positions at a time, so the backward
    recomputes each logits slab in turn. ``weights`` (B, S) selects the
    positions that count. The same fp32 reduction as the materialized
    path, so loss and gradients match it to rounding."""
    B, S, d = x.shape
    if S % n_chunks:
        raise ValueError(f"S={S} not divisible by loss_chunks={n_chunks}")
    C = S // n_chunks
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(n_chunks):
        sl = slice(c * C, (c + 1) * C)
        total = total - checkpoint(
            _chunk_nll, cfg.dtype, x[:, sl], head, targets[:, sl],
            weights[:, sl], use_reentrant=False, preserve_rng_state=False)
    return total / torch.sum(weights)


def next_token_loss(cfg: TransformerConfig, params: dict,
                    tokens: torch.Tensor,
                    full_seq: bool = False) -> torch.Tensor:
    """Causal LM loss: predict tokens[:, 1:] from tokens[:, :-1].

    ``full_seq=True`` runs forward over all S tokens and drops the last
    logit instead of slicing the input — identical for a causal model.
    ``cfg.loss_chunks > 1`` forwards all S tokens to hidden and scans
    the head with the last position masked out."""
    if cfg.loss_chunks > 1:
        x = forward_hidden(cfg, params, tokens)
        targets, weights = shift_targets_and_weights(tokens)
        return chunked_head_xent(cfg, x, params["head"], targets, weights,
                                 cfg.loss_chunks)
    if full_seq:
        logits = forward(cfg, params, tokens)
        return token_xent(logits[:, :-1], tokens[:, 1:])
    logits = forward(cfg, params, tokens[:, :-1])
    return token_xent(logits, tokens[:, 1:])


# -- parameter trees --------------------------------------------------------


def tree_leaves(tree: Any) -> list[torch.Tensor]:
    """The tensors of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of equally shaped nested dicts."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def loss_and_grads(cfg: TransformerConfig, params: dict,
                   tokens: torch.Tensor, full_seq: bool = False
                   ) -> tuple[torch.Tensor, dict]:
    """``jax.value_and_grad(next_token_loss)``: the detached loss and a
    gradient tree shaped like ``params`` (fp32, as the master leaves).
    ``params`` themselves are left without ``requires_grad``."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss = next_token_loss(cfg, live, tokens, full_seq)
    it = iter(torch.autograd.grad(loss, tree_leaves(live)))
    return loss.detach(), tree_map(lambda _: next(it), live)


# -- optimizer --------------------------------------------------------------


#: The framework-standard AdamW recipe (shared by all train steps).
ADAM_B1, ADAM_B2, ADAM_EPS, WEIGHT_DECAY = 0.9, 0.95, 1e-8, 0.1


@dataclasses.dataclass(frozen=True)
class AdamW:
    """``optax.adamw`` with the recipe above, functional over a
    parameter tree. The step is computed in fp32 from the moments
    before they are rounded for storage, as ``optax.scale_by_adam``
    does: m = b1 m + (1-b1) g, v = b2 v + (1-b2) g^2, u = m/(1-b1^t) /
    (sqrt(v/(1-b2^t)) + eps) + wd p, p -= lr u. ``mu_dtype`` stores both
    moments in that dtype between steps (the reference's ``_cast_nu``
    extends optax's first-moment ``mu_dtype`` to the second)."""

    learning_rate: float
    mu_dtype: torch.dtype | None = None

    def init(self, params: dict) -> dict:
        def zeros(p):
            return torch.zeros_like(p, dtype=self.mu_dtype or p.dtype)

        return {"count": 0, "mu": tree_map(zeros, params),
                "nu": tree_map(zeros, params)}

    @torch.no_grad()
    def update(self, grads: dict, state: dict, params: dict) -> dict:
        """Apply one step to ``params`` in place; returns the new state
        (its moment tensors updated in place too)."""
        count = state["count"] + 1
        bc1 = 1.0 - ADAM_B1 ** count
        bc2 = 1.0 - ADAM_B2 ** count
        for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(state["mu"]),
                              tree_leaves(state["nu"])):
            g = g.float()
            mu = (1 - ADAM_B1) * g + ADAM_B1 * m.float()
            nu = (1 - ADAM_B2) * (g * g) + ADAM_B2 * v.float()
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS)
            u = u + WEIGHT_DECAY * p
            p.add_(u * -self.learning_rate)
            m.copy_(mu)
            v.copy_(nu)
        return dict(state, count=count)


def default_optimizer(learning_rate: float,
                      mu_dtype: torch.dtype | None = None) -> AdamW:
    """The framework-standard AdamW: b1 0.9, b2 0.95, eps 1e-8, weight
    decay 0.1 on every leaf. ``mu_dtype`` (e.g. ``torch.bfloat16``) stores the first AND second
    moments in that dtype; the update math stays fp32 and the master
    params fp32."""
    return AdamW(learning_rate, mu_dtype=mu_dtype)


# -- training step ----------------------------------------------------------


def make_train_step(cfg: TransformerConfig, learning_rate: float = 3e-4,
                    full_seq: bool = False,
                    mu_dtype: torch.dtype | None = None):
    """Returns (init_opt_state, train_step), AdamW as
    :func:`default_optimizer`.

    ``train_step(state, tokens) -> (state, metrics)`` where state is
    (params, opt_state, step) and metrics ``{"loss", "tokens"}``, tokens
    = B * (S - 1) for the telemetry channel. The params and the moments
    are updated in place."""
    tx = default_optimizer(learning_rate, mu_dtype=mu_dtype)

    def init_opt_state(params):
        return tx.init(params)

    def train_step(state, tokens):
        params, opt_state, step = state
        loss, grads = loss_and_grads(cfg, params, tokens, full_seq)
        opt_state = tx.update(grads, opt_state, params)
        ntok = tokens.shape[0] * (tokens.shape[1] - 1)
        return (params, opt_state, step + 1), {"loss": loss, "tokens": ntok}

    return init_opt_state, train_step


def make_eval_step(cfg: TransformerConfig, full_seq: bool = False):
    @torch.no_grad()
    def eval_step(params, tokens):
        return next_token_loss(cfg, params, tokens, full_seq)

    return eval_step
