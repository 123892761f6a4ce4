"""Kernels 2.2 and 2.3 (``ops/csrc/flash_bwd.cu``) together: the least
time of each backward (one dq and one dkv launch) over their device
time, in percent."""
from benchmark import flops as F


def read(run):
    if run.trace is None or "flash_bwd" not in run.trace["flash"]:
        return None
    got = run.trace["flash"]["flash_bwd"]
    B, S = run.batch.flash_shape
    c = run.cfg
    H, Hkv, hd = (c["num_attention_heads"], c["num_key_value_heads"],
                  c["head_dim"])
    bound = F.bound_seconds(F.flash_bwd_flops(B, S, H, hd),
                            F.flash_bwd_bytes(B, S, H, Hkv, hd), F.PEAK)
    return 100.0 * (got["launches"] / 2) * bound / (got["ns"] / 1e9)
