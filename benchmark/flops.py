"""Operation and byte counts, and the card's peaks.

Every count is worked out from the shapes a run used, never read from
the program. Model FLOPs follow the usual convention: a matrix product
of (m, k) by (k, n) is 2mkn operations; a trained token costs 6N plus
causal attention and a forward token 2N plus attention, where N counts
the weights of every product a token goes through (the embedding is a
lookup, not a product; the untied head is one). Recomputation in the
backward is not model work and is not counted.
"""

from __future__ import annotations

#: The one card the benchmark runs on, as ``torch.cuda.get_device_name``
#: names it.
CARD = "NVIDIA H100 80GB HBM3"
#: Its data sheet, dense: bf16 tensor-core peak and HBM3 bandwidth, at
#: the full 700 W power limit.
PEAK = {"flops": 989e12, "bytes_per_s": 3.35e12}


def attention_width(cfg: dict) -> int:
    return cfg["num_attention_heads"] * cfg["head_dim"]


def layer_product_params(cfg: dict, active: bool) -> int:
    """Weights of one layer's products: the four attention projections
    and the feed-forward; for an MoE layer the router and either every
    expert (``active=False``) or the experts one token uses."""
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    hq = attention_width(cfg)
    hkv = cfg["num_key_value_heads"] * cfg["head_dim"]
    attn = d * hq + 2 * d * hkv + hq * d
    if "num_local_experts" not in cfg:
        return attn + 3 * d * f
    e = cfg["num_experts_per_tok"] if active else cfg["num_local_experts"]
    return attn + d * cfg["num_local_experts"] + e * 3 * d * f


def product_params(cfg: dict, active: bool = True) -> int:
    """N: every layer's products and the head."""
    return (cfg["num_hidden_layers"] * layer_product_params(cfg, active)
            + cfg["hidden_size"] * cfg["vocab_size"])


def attention_flops_fwd(cfg: dict, context: int) -> int:
    """Forward attention work of one query token that sees ``context``
    positions: scores and the weighted sum, 2 x 2 x context x width a
    layer."""
    return 4 * cfg["num_hidden_layers"] * attention_width(cfg) * context


def causal_context_sum(seq: int) -> int:
    """Sum over a causal row of length ``seq`` of each position's
    context: 1 + 2 + ... + seq."""
    return seq * (seq + 1) // 2


def forward_flops(cfg: dict, batch: int, seq: int) -> int:
    """Model FLOPs of a forward over (batch, seq) causal rows."""
    return batch * (2 * product_params(cfg) * seq
                    + attention_flops_fwd(cfg, causal_context_sum(seq)))


def train_flops(cfg: dict, batch: int, seq: int) -> int:
    """Model FLOPs of a training forward and backward over (batch, seq)
    causal rows: three times the forward."""
    return 3 * forward_flops(cfg, batch, seq)


def prefill_flops(cfg: dict, prompt_len: int) -> int:
    """Useful work of one prompt's prefill (its padding not counted)."""
    return forward_flops(cfg, 1, prompt_len)


def decode_flops(cfg: dict, position: int) -> int:
    """Useful work of one decoded token at 0-based ``position`` (it sees
    position + 1 entries of the cache)."""
    return 2 * product_params(cfg) + attention_flops_fwd(cfg, position + 1)


# -- the flash kernels (ops/csrc/flash_fwd.cu, flash_bwd.cu) ---------------


def _pairs(batch: int, heads: int, seq: int, causal: bool) -> int:
    cols = causal_context_sum(seq) if causal else seq * seq
    return batch * heads * cols


def flash_fwd_flops(batch, seq, heads, head_dim, causal=True) -> int:
    """2.1: scores and the weighted sum over the (causal) pairs."""
    return 4 * head_dim * _pairs(batch, heads, seq, causal)


def flash_fwd_bytes(batch, seq, heads, kv_heads, head_dim,
                    elt: int = 2) -> int:
    """2.1: q, k, v read once, o written once (``elt`` bytes each), the
    fp32 log-sum-exp rows written once."""
    q = batch * seq * heads * head_dim
    kv = batch * seq * kv_heads * head_dim
    return elt * (2 * q + 2 * kv) + 4 * batch * heads * seq


def flash_bwd_flops(batch, seq, heads, head_dim, causal=True) -> int:
    """2.2 + 2.3: attention's backward, five products of 2 x head_dim
    operations a pair (2.5 times the forward): the scores recomputed
    once, dV, dP, dQ and dK. The kernels' split into a dq and a dkv
    launch recomputes the scores and dP a second time; that is the
    kernels' overhead, not the function's work, and is not counted."""
    return 10 * head_dim * _pairs(batch, heads, seq, causal)


def flash_bwd_bytes(batch, seq, heads, kv_heads, head_dim,
                    elt: int = 2) -> int:
    """2.2 + 2.3 together: q, k, v and do read once, the fp32 lse and
    row-delta rows read once, dq, dk, dv written once (``elt`` bytes)."""
    q = batch * seq * heads * head_dim
    kv = batch * seq * kv_heads * head_dim
    return elt * (2 * q + 2 * kv) + 8 * batch * heads * seq + elt * (q + 2 * kv)


def bound_seconds(flops: int, nbytes: int, peak: dict) -> float:
    """The least time the card could take: the larger of the two."""
    return max(flops / peak["flops"], nbytes / peak["bytes_per_s"])
