from pbs_tpu_torch.ops.attention import flash_attention, flash_attention_lse
from pbs_tpu_torch.ops.matmul import MatmulStats, instrumented_matmul, scale_stats

__all__ = [
    "MatmulStats",
    "flash_attention",
    "flash_attention_lse",
    "instrumented_matmul",
    "scale_stats",
]
