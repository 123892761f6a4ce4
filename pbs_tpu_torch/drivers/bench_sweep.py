"""Flagship throughput sweep: justify the benchmarked configuration.

The port of ``bench_sweep.py``. Runs the flagship decoder across remat
policy x batch x attention implementation in one process, timing a
short training chunk per point (8 steps queued back to back, one
synchronise at the loss read), at S=1024. Output: one JSON line per
point plus a final ``best`` line.

Knobs, all validated before the device is touched, with the reference's
messages: ``PBST_SWEEP_BATCHES`` (ints >= 1), ``PBST_SWEEP_ATTN``
(xla|pallas; it also drops the "full" remat row, as there),
``PBST_SWEEP_LOSS_CHUNKS`` (an int >= 1 dividing the sequence) and
``PBST_SWEEP_MU_DTYPE`` (bf16 | f32). The reference lets a bad ATTN or
LOSS_CHUNKS fail at its first point; the twin refuses it up front.

Usage:
    python -m pbs_tpu_torch.drivers.bench_sweep               # the card
    PBST_SWEEP_TINY=1 python -m pbs_tpu_torch.drivers.bench_sweep   # CPU
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import sys

from pbs_tpu_torch.drivers.bench_common import (PEAK_FLOPS,
                                                abandon_if_unavailable,
                                                bench_device, error_row,
                                                parse_mu_dtype, release,
                                                timed_training, tiny_mode)

REMAT = [("none", False, "full"), ("dots", True, "dots"),
         ("full", True, "full")]
BATCHES = [4, 6, 8]
ATTN = ["xla", "pallas"]
SEQ = 1024
STEPS = 8  # per timed chunk


def run_point(cfg_base, remat_name, remat, policy, batch, attn,
              warm_chunks=1, timed_chunks=2, mu_dtype=None, device=None,
              seq=SEQ, steps=STEPS) -> dict:
    cfg = dataclasses.replace(cfg_base, remat=remat, remat_policy=policy,
                              attn_impl=attn)
    m = timed_training(cfg, batch, seq, steps, device,
                       warm_chunks=warm_chunks, timed_chunks=timed_chunks,
                       mu_dtype=mu_dtype)
    return {
        "remat": remat_name,
        "batch": batch,
        "attn": attn,
        "tokens_per_s": round(m["tokens_per_s"], 1),
        "mfu": round(m["tokens_per_s"] * 6 * m["n_params"] / PEAK_FLOPS, 4),
        "step_ms": round(m["step_ms"], 1),
        "compile_s": round(m["compile_s"], 1),
        "loss": round(m["loss"], 3),
        "n_params": m["n_params"],
    }


def parse_knobs(tiny: bool) -> dict:
    """The grid and options from the env knobs; raises ValueError with
    the message the error row prints. Touches no device."""
    seq, steps, batches = (128, 2, [2]) if tiny else (SEQ, STEPS, BATCHES)
    attns, remats = ATTN, REMAT
    loss_chunks = 0
    lc_env = os.environ.get("PBST_SWEEP_LOSS_CHUNKS")
    if lc_env:
        # Chunked cross-entropy: the (B, S, vocab) fp32 logits never
        # materialize at once.
        try:
            loss_chunks = int(lc_env)
        except ValueError:
            loss_chunks = 0
        if loss_chunks < 1:
            raise ValueError(
                f"PBST_SWEEP_LOSS_CHUNKS must be an int >= 1: {lc_env}")
        if seq % loss_chunks:
            raise ValueError(
                f"PBST_SWEEP_LOSS_CHUNKS={loss_chunks} must divide "
                f"seq={seq}")
    try:
        mu_dtype, mu_label = parse_mu_dtype(
            os.environ.get("PBST_SWEEP_MU_DTYPE"))
    except ValueError as e:
        raise ValueError(f"PBST_SWEEP_MU_DTYPE: {e}") from None
    batches_env = os.environ.get("PBST_SWEEP_BATCHES")
    if batches_env:
        # e.g. PBST_SWEEP_BATCHES=8,12,16 — probe beyond the default grid.
        try:
            batches = [int(b) for b in batches_env.split(",") if b.strip()]
        except ValueError:
            batches = []
        if not batches or any(b < 1 for b in batches):
            raise ValueError("PBST_SWEEP_BATCHES must be ints >= 1: "
                             f"{batches_env}")
    attn_env = os.environ.get("PBST_SWEEP_ATTN")
    if attn_env:
        attns = attn_env.split(",")
        if not attns or any(a not in ("xla", "pallas") for a in attns):
            raise ValueError(f"PBST_SWEEP_ATTN must be xla|pallas: {attn_env}")
        # flash frees the S^2 probs memory, so remat=none may fit where
        # the xla column could not — keep it in.
        remats = [r for r in REMAT if r[0] in ("none", "dots")]
    return dict(seq=seq, steps=steps, batches=batches, attns=attns,
                remats=remats, loss_chunks=loss_chunks, mu_dtype=mu_dtype,
                mu_label=mu_label)


def main(argv=None) -> int:
    import argparse

    from pbs_tpu_torch.drivers.graft_entry import _flagship_cfg

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="run here (default: the card; tiny mode: cpu)")
    args = ap.parse_args(argv)
    tiny = tiny_mode("PBST_SWEEP_TINY")
    try:
        k = parse_knobs(tiny)
    except ValueError as e:
        print(json.dumps({"error": str(e)}), flush=True)
        return 1
    device = bench_device(tiny, args.device)
    cfg_base = _flagship_cfg(tiny=tiny)
    if k["loss_chunks"]:
        cfg_base = dataclasses.replace(cfg_base, loss_chunks=k["loss_chunks"])

    results = []
    grid = list(itertools.product(k["remats"], k["batches"], k["attns"]))
    for (rname, remat, policy), batch, attn in grid:
        fatal = None
        try:
            r = run_point(cfg_base, rname, remat, policy, batch, attn,
                          mu_dtype=k["mu_dtype"], device=device,
                          seq=k["seq"], steps=k["steps"])
            if cfg_base.loss_chunks > 1:
                r["loss_chunks"] = cfg_base.loss_chunks
            if k["mu_dtype"] is not None:
                r["mu_dtype"] = k["mu_label"]
        except Exception as e:  # noqa: BLE001 — a failing point (OOM, eg)
            r = {"remat": rname, "batch": batch, "attn": attn,
                 "error": error_row(e)}
            fatal = e.with_traceback(None)  # drop the point's frames
        print(json.dumps(r), flush=True)
        results.append(r)
        stop = fatal is not None and abandon_if_unavailable(
            fatal, "the remaining sweep points")
        fatal = None
        release(device)
        if stop:
            break
    if not results:
        print(json.dumps({"error": "sweep emitted no points "
                          f"(grid had {len(grid)})"}), flush=True)
        return 1
    ok = [r for r in results if "error" not in r]
    if ok:
        best = max(ok, key=lambda r: r["tokens_per_s"])
        print(json.dumps({"best": best}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
