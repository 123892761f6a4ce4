from pbs_tpu_torch.models.generate import (
    forward_with_cache,
    init_cache,
    make_generate,
    make_serve_step,
    prefill,
)
from pbs_tpu_torch.models.microstep import make_micro_train_step
from pbs_tpu_torch.models.transformer import (
    TransformerConfig,
    cast_params,
    forward,
    forward_hidden,
    init_params,
    make_eval_step,
    make_train_step,
    next_token_loss,
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
    "make_eval_step",
    "make_generate",
    "make_micro_train_step",
    "make_serve_step",
    "make_train_step",
    "next_token_loss",
    "params_from_numpy",
    "prefill",
]
