"""Autoregressive serving: KV-cache prefill/decode/generate.

The port of ``pbs_tpu.models.generate``. The latency-sensitive tenant
class the scheduler BOOSTs on wake is a batch-inference loop: KV-cached
autoregressive decoding over the flagship transformer's weights.

As in the reference: the cache is allocated up front (``P +
max_new_tokens`` positions), GQA K/V are cached at ``n_kv_heads``,
the cache is in the compute dtype, and attention over the cache is the
dense masked ``_cached_attention`` (no kernel on this path). PyTorch
idiom where JAX used its own: the cache position is a Python int, the
decode loop is a Python loop, the cache slabs are updated in place (no
copy of the whole cache per token), and sampling draws from a
``torch.Generator`` (greedy decoding is token-exact against the
reference; sampled tokens follow the same distribution, not the same
stream). An int8-quantized tree (``models.quant.quantize_weights``)
serves through the same forward, by ``wload`` and ``embed_rows``. The
cached forward and the decode loop take the FFN block as a parameter
(``mlp_fn``, the loop's ``fwd``), so the MoE serving path
(``models.moe.moe_forward_with_cache``, ``make_moe_generate``) shares
them with the dense one.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from pbs_tpu_torch.models.quant import embed_rows, wload
from pbs_tpu_torch.models.transformer import (
    TransformerConfig,
    apply_rope,
    resolve_device,
    rms_norm,
    rope_tables,
    unstack_layers,
)


def init_cache(cfg: TransformerConfig, batch: int,
               max_len: int | None = None, device=None) -> dict:
    """Zeroed KV slabs: (L, B, T, n_kv_heads, head_dim) + position."""
    dev = resolve_device(device)
    T = max_len if max_len is not None else cfg.max_seq
    shape = (cfg.n_layers, batch, T, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=dev),
        "pos": 0,  # tokens already cached
    }


def _cached_attention(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                      start_pos: int, cfg: TransformerConfig) -> torch.Tensor:
    """q (B,S,H,hd) against full cache slabs ck/cv (B,T,nkv,hd); rows
    r attend to absolute cols <= start_pos + r (causal over history)."""
    B, S, H, hd = q.shape
    T, nkv = ck.shape[1], ck.shape[2]
    group = H // nkv
    qg = q.reshape(B, S, nkv, group, hd).permute(0, 2, 3, 1, 4)
    kt = ck.permute(0, 2, 1, 3)  # (B, nkv, T, hd)
    vt = cv.permute(0, 2, 1, 3)
    scores = torch.einsum("bngqh,bnkh->bngqk", qg, kt) / math.sqrt(hd)
    rows = torch.arange(S, device=q.device)[:, None]
    cols = torch.arange(T, device=q.device)[None, :]
    mask = cols <= rows + start_pos  # unwritten tail is masked too
    scores = scores.masked_fill(~mask, torch.finfo(scores.dtype).min)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bngqk,bnkh->bngqh", probs, vt)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd)


def _forward_with_cache_impl(cfg: TransformerConfig, params: dict,
                             tokens: torch.Tensor, cache: dict,
                             mlp_fn=None) -> tuple[torch.Tensor, dict, Any]:
    """The cached-forward plumbing (embed, rope slice, KV update, cached
    attention, norms, head) over the FFN block, so the dense and MoE
    serving paths keep one copy. ``mlp_fn(lp, h) -> (y, extra)``
    replaces the dense SwiGLU when given; the per-layer ``extra``
    scalars (MoE drop fractions) are summed, and without ``mlp_fn`` the
    sum is the Python float 0.0. Returns (logits (B, S, vocab) fp32, the
    cache with the position advanced, the extra sum)."""
    B, S = tokens.shape
    T = cache["k"].shape[2]
    dt = cfg.dtype
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    start = cache["pos"]
    if start + S > T:
        raise ValueError(f"cache holds {T} positions; {start} used, "
                         f"{S} more requested")

    x = embed_rows(params["embed"], tokens, dt)
    cos_full, sin_full = rope_tables(cfg, T, device=x.device)
    cos, sin = cos_full[start:start + S], sin_full[start:start + S]
    extra = 0.0
    for i, lp in enumerate(unstack_layers(params)):
        ck, cv = cache["k"][i], cache["v"][i]
        h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        q = (h @ wload(lp["wq"], dt)).reshape(B, S, nh, hd)
        k = (h @ wload(lp["wk"], dt)).reshape(B, S, nkv, hd)
        v = (h @ wload(lp["wv"], dt)).reshape(B, S, nkv, hd)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        ck[:, start:start + S] = k
        cv[:, start:start + S] = v
        attn = _cached_attention(q, ck, cv, start, cfg)
        x = x + attn.reshape(B, S, nh * hd) @ wload(lp["wo"], dt)
        h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
        if mlp_fn is None:
            gate = torch.nn.functional.silu(h @ wload(lp["w1"], dt))
            up = h @ wload(lp["w3"], dt)
            y = (gate * up) @ wload(lp["w2"], dt)
        else:
            y, e = mlp_fn(lp, h)
            extra = extra + e
        x = x + y
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x @ wload(params["head"], dt)).float()
    return logits, {"k": cache["k"], "v": cache["v"], "pos": start + S}, extra


def forward_with_cache(cfg: TransformerConfig, params: dict,
                       tokens: torch.Tensor,
                       cache: dict) -> tuple[torch.Tensor, dict]:
    """Run ``tokens`` (B, S) through the model starting at the cache
    position: new K/V are written into the slabs (in place), attention
    sees the whole prefix. Returns (logits (B, S, vocab) fp32, cache
    with the position advanced)."""
    logits, cache, _ = _forward_with_cache_impl(cfg, params, tokens, cache)
    return logits, cache


def prefill(cfg: TransformerConfig, params: dict, prompt: torch.Tensor,
            cache: dict) -> tuple[torch.Tensor, dict]:
    """Ingest the prompt in one pass; returns (last-position logits
    (B, vocab), cache)."""
    logits, cache = forward_with_cache(cfg, params, prompt, cache)
    return logits[:, -1, :], cache


def _sample(logits: torch.Tensor, generator: torch.Generator | None,
            temperature: float) -> torch.Tensor:
    if temperature == 0.0:
        return logits.argmax(dim=-1).to(torch.int32)
    probs = torch.softmax(logits / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


def make_generate_loop(cfg: TransformerConfig, max_new_tokens: int,
                       temperature: float, fwd):
    """The shared decode loop (cache init, prefill, then single-token
    decodes) over the forward ``fwd(params, tokens, cache) -> (logits,
    cache, extra)``. Returns ``loop(params, prompt, generator) -> (toks
    (B, max_new_tokens) int32, extra of the prefill, extra summed over
    the decodes, P)``; wrappers decide what ``extra`` means (dense:
    nothing; MoE: router drop fractions)."""

    @torch.no_grad()
    def loop(params: dict, prompt: torch.Tensor,
             generator: torch.Generator | None = None):
        B, P = prompt.shape
        cache = init_cache(cfg, B, max_len=P + max_new_tokens,
                           device=prompt.device)
        logits, cache, extra0 = fwd(params, prompt, cache)
        tok = _sample(logits[:, -1, :], generator, temperature)
        toks, esum = [tok], 0.0
        # max_new_tokens - 1 decode forwards produce the remaining tokens
        for _ in range(max_new_tokens - 1):
            logits, cache, e = fwd(params, tok[:, None], cache)
            tok = _sample(logits[:, -1, :], generator, temperature)
            toks.append(tok)
            esum = esum + e
        return torch.stack(toks, dim=1), extra0, esum, P

    return loop


def make_generate(cfg: TransformerConfig, max_new_tokens: int,
                  temperature: float = 0.0):
    """Returns ``generate(params, prompt, generator) -> (B,
    max_new_tokens)`` int32. ``prompt`` is (B, P) int; the cache is
    sized to ``P + max_new_tokens`` so serving memory is exactly what
    the request class needs. The first token comes from the prefill,
    the remaining ``max_new_tokens - 1`` from single-token decodes."""

    def fwd(params, tokens, cache):
        return _forward_with_cache_impl(cfg, params, tokens, cache)

    loop = make_generate_loop(cfg, max_new_tokens, temperature, fwd)

    def generate(params: dict, prompt: torch.Tensor,
                 generator: torch.Generator | None = None) -> torch.Tensor:
        return loop(params, prompt, generator)[0]

    return generate


def make_serve_step(cfg: TransformerConfig, max_new_tokens: int,
                    temperature: float = 0.0):
    """A Job-shaped batch-inference loop: ``state`` is (params,
    generator, requests_served); each step generates one batch for
    ``prompts`` and bumps the counter — the latency-sensitive tenant,
    multiplexed against other work by the credit scheduler."""
    gen = make_generate(cfg, max_new_tokens, temperature)

    def serve_step(state, prompts: torch.Tensor):
        params, generator, served = state
        toks = gen(params, prompts, generator)
        metrics = {"tokens": toks.shape[0] * toks.shape[1]}
        return (params, generator, served + 1), metrics

    return serve_step
