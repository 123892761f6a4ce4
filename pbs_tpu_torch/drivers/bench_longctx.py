"""Long-context attention benchmark: where flash earns its keep.

The port of ``bench_longctx.py``. At S=1024 dense attention is hard to
beat; the flash kernels' case is long context, where dense attention
materializes S^2 scores per head while the kernels (``ops/csrc/
flash_fwd.cu``, ``flash_bwd.cu``) stream K/V tiles through shared memory
at O(S) activation memory. This measures one card's training
throughput of the flagship decoder at S in {4096, 8192} with attn in
{xla (dense torch), pallas (the flash kernels)}, remat "dots", AdamW at
3e-4, and prints one JSON line per point, then a ``pallas_speedup``
line per length where both columns ran. A point that does not fit
(the "xla" column at 8192 keeps ~4.3 GB of fp32 scores a layer) is an
error row, not a failure.

A chunk is 6 steps queued back to back with one synchronise at the
loss read (the reference scans them on the device); 1 warm and 2
timed chunks a point.

    python -m pbs_tpu_torch.drivers.bench_longctx              # the card
    PBST_LONGCTX_TINY=1 python -m pbs_tpu_torch.drivers.bench_longctx
"""

from __future__ import annotations

import dataclasses
import json
import sys

from pbs_tpu_torch.drivers.bench_common import (PEAK_FLOPS,
                                                abandon_if_unavailable,
                                                bench_device, error_row,
                                                release, timed_training,
                                                tiny_mode)

# (seq, batch): batch shrinks as S grows to hold tokens/step roughly
# constant and fit device memory.
POINTS = [(4096, 2), (8192, 1)]
ATTN = ["xla", "pallas"]
STEPS = 6  # per timed chunk
#: The tiny mode's grid, as in the reference (xla column only).
TINY = dict(points=[(256, 1)], steps=2, attn=["xla"])


def measure_point(cfg_base, seq, batch, attn, warm_chunks=1, timed_chunks=2,
                  device=None, steps=STEPS) -> tuple[dict, dict]:
    """One point: (the reference's row, the raw measurement of
    ``bench_common.timed_training``, its first loss and peak memory
    included)."""
    cfg = dataclasses.replace(cfg_base, max_seq=seq, attn_impl=attn,
                              remat=True, remat_policy="dots")
    m = timed_training(cfg, batch, seq, steps, device,
                       warm_chunks=warm_chunks, timed_chunks=timed_chunks)
    toks_per_s = m["tokens_per_s"]
    # MFU on the 6ND dense-FLOP convention; at long S the attention
    # FLOPs (12*L*d*S per token) are no longer negligible, so report
    # attn-inclusive MFU too.
    dense = 6 * m["n_params"]
    attn_flops = 12 * cfg.n_layers * cfg.d_model * seq  # per token
    row = {
        "seq": seq,
        "batch": batch,
        "attn": attn,
        "tokens_per_s": round(toks_per_s, 1),
        "mfu_dense": round(toks_per_s * dense / PEAK_FLOPS, 4),
        "mfu_incl_attn": round(toks_per_s * (dense + attn_flops)
                               / PEAK_FLOPS, 4),
        "step_ms": round(m["step_ms"], 1),
        "compile_s": round(m["compile_s"], 1),
        "loss": round(m["loss"], 3),
    }
    return row, m


def run_point(cfg_base, seq, batch, attn, warm_chunks=1, timed_chunks=2,
              device=None, steps=STEPS) -> dict:
    return measure_point(cfg_base, seq, batch, attn, warm_chunks,
                         timed_chunks, device, steps)[0]


def speedup_rows(results: list[dict], points) -> list[dict]:
    """``pallas_speedup`` per length where both columns ran."""
    ok = [r for r in results if "error" not in r]
    rows = []
    for seq, _ in points:
        cols = {r["attn"]: r for r in ok if r["seq"] == seq}
        if "xla" in cols and "pallas" in cols:
            rows.append({"seq": seq, "pallas_speedup": round(
                cols["pallas"]["tokens_per_s"]
                / cols["xla"]["tokens_per_s"], 3)})
    return rows


def main(argv=None) -> int:
    import argparse

    from pbs_tpu_torch.drivers.graft_entry import _flagship_cfg

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="run here (default: the card; tiny mode: cpu)")
    args = ap.parse_args(argv)
    tiny = tiny_mode("PBST_LONGCTX_TINY")
    device = bench_device(tiny, args.device)
    cfg_base = _flagship_cfg(tiny=tiny)
    points, steps, attns = ((TINY["points"], TINY["steps"], TINY["attn"])
                            if tiny else (POINTS, STEPS, ATTN))

    results = []
    for (seq, batch), attn in [(p, a) for p in points for a in attns]:
        fatal = None
        try:
            r = run_point(cfg_base, seq, batch, attn, device=device,
                          steps=steps)
        except Exception as e:  # noqa: BLE001 — OOM etc. is a result
            r = {"seq": seq, "batch": batch, "attn": attn,
                 "error": error_row(e)}
            fatal = e.with_traceback(None)  # drop the point's frames
        print(json.dumps(r), flush=True)
        results.append(r)
        stop = fatal is not None and abandon_if_unavailable(
            fatal, "the remaining long-context points")
        fatal = None
        release(device)
        if stop:
            break
    for row in speedup_rows(results, points):
        print(json.dumps(row), flush=True)
    return 0 if any("error" not in r for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
