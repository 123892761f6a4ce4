from pbs_tpu_torch.models.generate import (
    forward_with_cache,
    init_cache,
    make_generate,
    make_serve_step,
    prefill,
)
from pbs_tpu_torch.models.microstep import make_micro_train_step
from pbs_tpu_torch.models.quant import quantize_weights, quantized_nbytes
from pbs_tpu_torch.models.serving import (
    Completion,
    ContinuousBatcher,
    SpeculativeBatcher,
    make_continuous_serve_step,
)
from pbs_tpu_torch.models.speculative import (
    make_speculative_generate,
    make_speculative_serve_step,
)
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
    "Completion",
    "ContinuousBatcher",
    "SpeculativeBatcher",
    "TransformerConfig",
    "cast_params",
    "forward",
    "forward_hidden",
    "forward_with_cache",
    "init_cache",
    "init_params",
    "make_continuous_serve_step",
    "make_eval_step",
    "make_generate",
    "make_micro_train_step",
    "make_serve_step",
    "make_speculative_generate",
    "make_speculative_serve_step",
    "make_train_step",
    "next_token_loss",
    "params_from_numpy",
    "prefill",
    "quantize_weights",
    "quantized_nbytes",
]
