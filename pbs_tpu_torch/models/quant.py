"""Weight access for the serving forwards.

The port of ``pbs_tpu.models.quant``'s ``wload`` and ``embed_rows`` for
plain (fp32/bf16) weights. The reference also serves int8
weight-only quantized leaves (``{"q", "s"}`` dicts); that path is not
ported yet (ROADMAP) and such a leaf raises.
"""

from __future__ import annotations

import torch

_INT8_MISSING = ("int8 {'q','s'} weight leaves are not ported yet "
                 "(ROADMAP queue 1, models/quant.py)")


def wload(w, dt: torch.dtype) -> torch.Tensor:
    """A weight in the compute dtype. A no-op (no copy) when the weight
    was already cast at load (``params_from_numpy(..., dtype=...)``)."""
    if isinstance(w, dict):
        raise NotImplementedError(_INT8_MISSING)
    return w.to(dt)


def embed_rows(w, tokens: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """Embedding gather, then cast: the same values as casting the whole
    table first (the cast is elementwise), without copying the table."""
    if isinstance(w, dict):
        raise NotImplementedError(_INT8_MISSING)
    return w[tokens.long()].to(dt)
