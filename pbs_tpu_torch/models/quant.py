"""Weight-only int8 quantization for serving tenants.

The port of ``pbs_tpu.models.quant``. Serving tenants are priced by
device-memory residency, and weight-only int8 halves a bf16 tenant's
bill while keeping the KV cache and activations untouched.

Scheme: symmetric per-output-channel scales on every >=2-D weight (norm
vectors stay fp32). A quantized leaf is ``{"q": int8, "s": fp32}``;
the serving forwards dequantize at use via :func:`wload` — ``q.to(dt)
* s`` — so the resident copy stays int8 (eager PyTorch materializes
the dequantized weight for the product that consumes it, and frees it
after). The tree's shape is preserved (stacked layer leaves quantize
along the last axis), so quantized params flow through the same layer
loop as fp params — one forward implementation serves both.
"""

from __future__ import annotations

import torch

from pbs_tpu_torch.runtime.memory import nbytes_of

__all__ = ["quantize_weights", "quantized_nbytes", "wload", "embed_rows"]


def _quantize_leaf(w: torch.Tensor) -> dict:
    """Symmetric per-output-channel int8: scale over the last axis.
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    amax = w.abs().amax(dim=-2, keepdim=True)  # reduce d_in
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return {"q": q, "s": scale.to(torch.float32)}


def quantize_weights(params: dict) -> dict:
    """Quantize a transformer param tree (the layout of
    ``models.transformer.init_params``) for the *cached/serving*
    forwards: the embed and head matrices, plus every stacked layer
    matrix (ndim >= 3 — ``(L, d_in, d_out)`` dense, ``(L, E, d, f)``
    experts). Stacked norm vectors ``(L, d)``, the final norm, and an
    MoE ``router`` pass through — norms because per-channel scaling
    across layers is meaningless, the router because routing decisions
    are disproportionately sensitive to weight noise (and it is tiny)."""
    out = dict(params)
    out["embed"] = _quantize_leaf(params["embed"])
    out["head"] = _quantize_leaf(params["head"])
    out["layers"] = {
        k: (_quantize_leaf(v) if v.ndim >= 3 and k != "router" else v)
        for k, v in params["layers"].items()
    }
    return out


def wload(w, dt: torch.dtype) -> torch.Tensor:
    """A weight in the compute dtype: dequantize a ``{"q", "s"}`` leaf,
    or cast a plain tensor (a no-op, no copy, when the weight was
    already cast at load, ``params_from_numpy(..., dtype=...)``)."""
    if isinstance(w, dict):
        return w["q"].to(dt) * w["s"].to(dt)
    return w.to(dt)


def embed_rows(w, tokens: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """Embedding gather that never dequantizes or casts the whole table:
    gather the rows first (int8 rows of a quantized table, then scaled
    by the per-column scales), then cast."""
    if isinstance(w, dict):
        return w["q"][tokens.long()].to(dt) * w["s"][0].to(dt)
    return w[tokens.long()].to(dt)


def quantized_nbytes(params: dict) -> int:
    """Device-resident bytes of a (possibly quantized) param tree — what
    the admission account should charge. Delegates to the same
    accounting the memory manager uses (``runtime.memory.nbytes_of``),
    so the serving bill and the admission bill cannot drift."""
    return nbytes_of(params)
