"""Kernel 2.1 (``ops/csrc/flash_fwd.cu``): the least time its launches
in the traced window could take (the larger of FLOPs over the bf16 peak
and bytes over HBM bandwidth, ``benchmark/flops.py``, at the batch
tenant's attention shape) over their device time, in percent."""
from benchmark import flops as F


def read(run):
    if run.trace is None or "flash_fwd" not in run.trace["flash"]:
        return None
    got = run.trace["flash"]["flash_fwd"]
    B, S = run.batch.flash_shape
    c = run.cfg
    H, Hkv, hd = (c["num_attention_heads"], c["num_key_value_heads"],
                  c["head_dim"])
    bound = F.bound_seconds(F.flash_fwd_flops(B, S, H, hd),
                            F.flash_fwd_bytes(B, S, H, Hkv, hd), F.PEAK)
    return 100.0 * got["launches"] * bound / (got["ns"] / 1e9)
