"""Flagship workload: a LLaMA-style decoder-only transformer (forward).

The port of ``pbs_tpu.models.transformer``'s forward path. Parameters
are a plain dict with the reference's key names and its L-stacked
layer layout, so a tree initialised by the JAX package crosses over
unchanged through :func:`params_from_numpy`. Compute runs in
``cfg.dtype`` with fp32 normalisation and fp32 logits, as there.

``attn_impl="xla"`` attends with dense PyTorch (the reference's
XLA-fused einsum path); ``"pallas"`` attends through the flash forward
kernel (``pbs_tpu_torch.ops.attention``). The sequence-parallel impls
("ring", "ulysses"), remat and the training step are not ported yet
(ROADMAP).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

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
    # Carried for config parity; the port runs no backward yet.
    remat: bool = False
    remat_policy: str = "full"
    # "xla" (dense torch) or "pallas" (the flash forward kernel).
    attn_impl: str = "xla"
    ring_block: str = "dense"
    loss_chunks: int = 0

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

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
    ``init_params`` output through ``np.asarray``) onto ``device``,
    keeping its key names and layout. ``dtype`` casts once at load."""
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
                device: Any = "cpu") -> tuple[torch.Tensor, torch.Tensor]:
    half = cfg.head_dim // 2
    freqs = cfg.rope_theta ** (
        -torch.arange(0, half, dtype=torch.float32, device=device) / half)
    t = torch.arange(seq, dtype=torch.float32, device=device)
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
    torch; "pallas" is the flash forward kernel. Unknown or unported
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
    """Layer ``i``'s slice of the L-stacked layer params (views)."""
    return {name: w[i] for name, w in params["layers"].items()}


# -- forward ----------------------------------------------------------------


def forward_hidden(cfg: TransformerConfig, params: dict,
                   tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, S) int -> final normed hidden (B, S, d_model). A
    Python loop over layers stands where the reference scans."""
    B, S = tokens.shape
    x = embed_rows(params["embed"], tokens, cfg.dtype)
    cos, sin = rope_tables(cfg, S, device=x.device)
    for i in range(cfg.n_layers):
        x = layer_body(cfg, x, layer_params(params, i), cos, sin)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def forward(cfg: TransformerConfig, params: dict,
            tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, S) int -> logits (B, S, vocab) fp32."""
    x = forward_hidden(cfg, params, tokens)
    return (x @ params["head"].to(cfg.dtype)).float()
