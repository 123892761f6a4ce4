"""The plain reference: Mistral and Mixtral from their published
equations, in plain PyTorch.

Written from the Hugging Face ``MistralForCausalLM`` and
``MixtralForCausalLM`` definitions: RMSNorm (x * rsqrt(mean(x^2) + eps)
times its weight), rotary embeddings on the rotate-half layout with
inverse frequencies theta^(-2i / head_dim), grouped-query causal
attention scaled by 1 / sqrt(head_dim), a SwiGLU feed-forward
down(silu(gate(h)) * up(h)), and for Mixtral a router whose softmax over
all experts is taken in fp32, cut to the top 2 and renormalised over
them, each token's output the weighted sum of its two experts, none
dropped. The loss is the mean cross-entropy of each next token; a step
averages the gradients of its micro-batches and applies AdamW with
decoupled weight decay.

Weights come in the layout the benchmark makes them in (a dict of
layer-stacked tensors, products stored as (in, out)). Whatever the
program works out from them (rotary tables, routing, casts) is worked
out again here. Products run in ``prec``: "fp32" (TF32 off: the caller
sets ``torch.backends.cuda.matmul.allow_tf32 = False``) or "fp8", the
control, where both operands of every product are rounded to float8
e4m3 with a per-tensor scale before an fp32 product (gradients pass the
rounding unchanged).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

FP8_MAX = 448.0


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to e4m3 at a per-tensor scale, back in fp32; the
    gradient passes through."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (q - x.detach())


def mm(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    a, b = a.float(), b.float()
    if prec == "fp8":
        a, b = _fp8(a), _fp8(b)
    elif prec != "fp32":
        raise ValueError(f"unknown precision {prec!r}")
    return a @ b


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def rotary(cfg: dict, positions: torch.Tensor):
    hd = cfg["head_dim"]
    inv = cfg["rope_theta"] ** (-torch.arange(0, hd, 2, dtype=torch.float64,
                                              device=positions.device) / hd)
    ang = positions.double()[:, None] * inv[None, :]
    emb = torch.cat([ang, ang], dim=-1)
    return emb.cos().float(), emb.sin().float()


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def attention(cfg: dict, lw: dict, h: torch.Tensor, cos, sin,
              prec: str) -> torch.Tensor:
    """h (B, S, d) normed -> the attention block's output (B, S, d)."""
    B, S, _ = h.shape
    H, Hkv, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                  cfg["head_dim"])
    q = mm(h, lw["wq"], prec).view(B, S, H, hd).transpose(1, 2)
    k = mm(h, lw["wk"], prec).view(B, S, Hkv, hd).transpose(1, 2)
    v = mm(h, lw["wv"], prec).view(B, S, Hkv, hd).transpose(1, 2)
    q = q * cos + rotate_half(q) * sin
    k = k * cos + rotate_half(k) * sin
    k = k.repeat_interleave(H // Hkv, dim=1)
    v = v.repeat_interleave(H // Hkv, dim=1)
    scores = mm(q, k.transpose(-1, -2), prec) / math.sqrt(hd)
    mask = torch.ones(S, S, dtype=torch.bool, device=h.device).triu(1)
    probs = torch.softmax(scores.masked_fill(mask, float("-inf")), dim=-1)
    out = mm(probs, v, prec).transpose(1, 2).reshape(B, S, H * hd)
    return mm(out, lw["wo"], prec)


def swiglu(h, w_gate, w_up, w_down, prec):
    return mm(F.silu(mm(h, w_gate, prec)) * mm(h, w_up, prec), w_down, prec)


def moe(cfg: dict, lw: dict, h: torch.Tensor, prec: str) -> torch.Tensor:
    """Mixtral's sparse block: every token to its top-k experts by the
    renormalised fp32 router softmax, none dropped."""
    B, S, d = h.shape
    x = h.reshape(B * S, d)
    probs = torch.softmax(mm(x, lw["router"], prec).float(), dim=-1)
    k = cfg["num_experts_per_tok"]
    topv, topi = torch.topk(probs, k, dim=-1)
    topv = topv / topv.sum(dim=-1, keepdim=True)
    out = torch.zeros_like(x)
    for e in range(cfg["num_local_experts"]):
        rows, slot = torch.nonzero(topi == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        y = swiglu(x[rows], lw["we1"][e], lw["we3"][e], lw["we2"][e], prec)
        out = out.index_add(0, rows, y * topv[rows, slot, None])
    return out.view(B, S, d)


def layer(cfg: dict, lw: dict, x: torch.Tensor, cos, sin,
          prec: str) -> torch.Tensor:
    eps = cfg["rms_norm_eps"]
    x = x + attention(cfg, lw, rms_norm(x, lw["attn_norm"], eps), cos, sin,
                      prec)
    h = rms_norm(x, lw["mlp_norm"], eps)
    if "num_local_experts" in cfg:
        return x + moe(cfg, lw, h, prec)
    return x + swiglu(h, lw["w1"], lw["w3"], lw["w2"], prec)


def layer_weights(weights: dict, i: int) -> dict:
    """Layer i's weights in fp32 (a layer at a time, so a bf16 tree of
    any size is widened one layer at once)."""
    return {k: v[i].float() for k, v in weights["layers"].items()}


def forward(cfg: dict, weights: dict, tokens: torch.Tensor,
            prec: str = "fp32", remat: bool = False) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, vocab) fp32. ``remat`` recomputes
    each layer in the backward (the same operations again, so the same
    numbers) to hold one layer's activations at a time."""
    B, S = tokens.shape
    x = weights["embed"][tokens.long()].float()
    cos, sin = rotary(cfg, torch.arange(S, device=tokens.device))
    for i in range(cfg["num_hidden_layers"]):
        if remat:
            x = checkpoint(_layer_i, cfg, weights, i, x, cos, sin, prec,
                           use_reentrant=False)
        else:
            x = _layer_i(cfg, weights, i, x, cos, sin, prec)
    x = rms_norm(x, weights["final_norm"], cfg["rms_norm_eps"])
    return mm(x, weights["head"], prec)


def _layer_i(cfg, weights, i, x, cos, sin, prec):
    return layer(cfg, layer_weights(weights, i), x, cos, sin, prec)


def next_token_loss(cfg: dict, weights: dict, tokens: torch.Tensor,
                    prec: str = "fp32", remat: bool = False) -> torch.Tensor:
    """Mean cross-entropy of tokens[:, 1:] given tokens[:, :-1]."""
    logits = forward(cfg, weights, tokens[:, :-1], prec, remat)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           tokens[:, 1:].reshape(-1).long())


def token_logprobs(cfg: dict, weights: dict, rows: torch.Tensor,
                   prec: str = "fp32") -> torch.Tensor:
    """(B, S) rows -> (B, S - 1) log-likelihood of each next token."""
    with torch.no_grad():
        logp = torch.log_softmax(forward(cfg, weights, rows, prec), dim=-1)
        return logp[:, :-1].gather(-1, rows[:, 1:, None].long())[..., 0]


def leaves(tree: dict, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += leaves(v, f"{prefix}{k}.")
        else:
            out.append((prefix + k, v))
    return out


def grads_of(cfg: dict, weights: dict, micro_batches: list,
             prec: str = "fp32") -> tuple[list[float], dict]:
    """(each micro-batch's loss, the mean of their gradients by leaf
    name)."""
    named = leaves(weights)
    acc = {n: torch.zeros_like(p) for n, p in named}
    losses = []
    for tokens in micro_batches:
        live = {n: p.detach().requires_grad_() for n, p in named}
        loss = next_token_loss(cfg, unflatten(live), tokens, prec, remat=True)
        gs = torch.autograd.grad(loss, list(live.values()))
        for n, g in zip(live, gs):
            acc[n] += g
        losses.append(float(loss.detach()))
        del live, gs, loss
    for g in acc.values():
        g /= len(micro_batches)
    return losses, acc


def unflatten(named: dict) -> dict:
    tree: dict = {}
    for name, t in named.items():
        node = tree
        *path, last = name.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = t
    return tree


class AdamW:
    """Adam with decoupled weight decay on every leaf, bias-corrected:
    m = b1 m + (1 - b1) g; v = b2 v + (1 - b2) g^2;
    p -= lr (m / (1 - b1^t) / (sqrt(v / (1 - b2^t)) + eps) + wd p)."""

    def __init__(self, lr, b1, b2, eps, weight_decay):
        self.lr, self.b1, self.b2 = lr, b1, b2
        self.eps, self.wd = eps, weight_decay
        self.t = 0
        self.m: dict = {}
        self.v: dict = {}

    @torch.no_grad()
    def step(self, named_params: dict, grads: dict) -> None:
        self.t += 1
        bc1 = 1 - self.b1 ** self.t
        bc2 = 1 - self.b2 ** self.t
        for n, p in named_params.items():
            g = grads[n]
            m = self.m.setdefault(n, torch.zeros_like(p))
            v = self.v.setdefault(n, torch.zeros_like(p))
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            u = (m / bc1) / ((v / bc2).sqrt() + self.eps) + self.wd * p
            p.sub_(self.lr * u)
