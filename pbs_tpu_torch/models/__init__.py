from pbs_tpu_torch.models.generate import (
    forward_with_cache,
    init_cache,
    make_generate,
    make_serve_step,
    prefill,
)
from pbs_tpu_torch.models.transformer import (
    TransformerConfig,
    cast_params,
    forward,
    forward_hidden,
    init_params,
    params_from_numpy,
)

__all__ = [
    "TransformerConfig",
    "cast_params",
    "forward",
    "forward_hidden",
    "forward_with_cache",
    "init_cache",
    "init_params",
    "make_generate",
    "make_serve_step",
    "params_from_numpy",
    "prefill",
]
