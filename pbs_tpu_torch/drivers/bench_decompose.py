"""Roofline decomposition of the flagship step: where the MFU goes.

The port of ``bench_decompose.py``: the same sections, one JSON line
each, with these counterparts on the card.

- **model_flops_per_token**: one counted train step (fwd + bwd +
  AdamW) through ``telemetry.source.count_invocation`` /
  ``CountedCost`` (PyTorch's FLOP counter and a byte counter over every
  aten op), divided by tokens, against the 6N dense convention. This
  takes the place of XLA's cost analysis, a stated departure: the
  kernels launched through ``ctypes`` are not counted, as XLA counts
  none of the reference's ``pallas_call``s; the flagship's default
  ``attn_impl="xla"`` (dense torch) is counted in full.
- **remat_tax**: the counted FLOPs of remat "dots" against remat off;
  if remat off does not fit on the card, that is the row.
- **membw**: an in-place ``add_`` over a 1 GiB fp32 buffer, 64 reps,
  timed with CUDA events: read + write bytes over the time.
- **attention_share**: analytic, as in the reference.
- **dispatch_overhead**: one step closed by a synchronise against 10
  steps queued with a single synchronise (the reference's 10-step
  ``lax.scan`` chunk; the keys keep its ``scan`` names).
- **measured split**: one profiled 10-step chunk through
  ``TorchQuantumProfiler`` — device compute/memory/collective fractions.
- **reconciliation**: the measured memory share against the share the
  roofline predicts from the counted bytes at the measured bandwidth.

One JSON line per section; one card. ``PBST_DECOMP_TINY=1`` smokes on
the CPU (the host's clock stands in for CUDA events there).
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

from pbs_tpu_torch.drivers.bench_common import (PEAK_FLOPS, bench_device,
                                                error_row, release,
                                                synchronize, tiny_mode)


def counted_step(cfg, batch: int, seq: int, device):
    """(flops, bytes) of one train step from fresh params on seeded
    tokens, counted by ``count_invocation``. Frees what it made."""
    import torch

    from pbs_tpu_torch.models import init_params, make_train_step
    from pbs_tpu_torch.telemetry.source import count_invocation

    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(cfg, gen, device=device)
    init_opt, train_step = make_train_step(cfg, learning_rate=3e-4)
    state = (params, init_opt(params), 0)
    del params
    tokens = torch.randint(0, cfg.vocab, (batch, seq), generator=gen,
                           device=device, dtype=torch.int32)
    cost = count_invocation(train_step, (state, tokens), {},
                            lambda: synchronize(device))
    del state
    release(device)
    return cost.flops, cost.nbytes


def elapsed_ms(fn, device) -> float:
    """``fn()``'s time: CUDA events on the card, the host clock on the
    host."""
    import torch

    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end)


def membw(device, tiny: bool) -> dict:
    """Achieved device-memory bandwidth of an in-place add over a
    ``mb`` MiB fp32 buffer, ``reps`` times: 2 x bytes x reps / time."""
    import torch

    mb = 16 if tiny else 1024
    reps = 8 if tiny else 64
    buf = torch.zeros((mb, 1024, 256), dtype=torch.float32, device=device)

    def stream():
        for _ in range(reps):
            buf.add_(1.0)

    stream()  # warm
    synchronize(device)
    floor_ms = elapsed_ms(lambda: None, device)
    dt_ms = max(elapsed_ms(stream, device), 1e-6)
    nbytes = mb * 1024 * 1024
    del buf
    return {
        "membw_gbs": round(2 * nbytes * reps / (dt_ms / 1e3) / 1e9, 1),
        "membw_buffer_mib": mb,
        "membw_stream_reps": reps,
        # an empty timed span: the timing's own floor, not subtracted
        "membw_rtt_ms": round(floor_ms, 4),
    }


def main(argv=None) -> int:
    import argparse

    import torch

    from pbs_tpu_torch.drivers.graft_entry import _flagship_cfg
    from pbs_tpu_torch.models import init_params, make_train_step
    from pbs_tpu_torch.telemetry.profiler import TorchQuantumProfiler

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="run here (default: the card; tiny mode: cpu)")
    args = ap.parse_args(argv)
    tiny = tiny_mode("PBST_DECOMP_TINY")
    device = bench_device(tiny, args.device)
    cfg = _flagship_cfg(tiny=tiny)
    B, S = (2, 128) if tiny else (6, 1024)
    n_params = cfg.num_params()
    toks_per_step = B * (S - 1)

    def _label(c):
        return f"remat={c.remat_policy if c.remat else 'none'}"

    # -- 1+2: counted cost, remat tax
    flops_base, bytes_base = counted_step(cfg, B, S, device)
    print(json.dumps({
        "config": _label(cfg),
        "flops_per_token": round(flops_base / toks_per_step, 1),
        "dense_6N": 6 * n_params,
        "ratio_vs_6N": round(flops_base / toks_per_step / (6 * n_params), 4),
        "hbm_bytes_per_token": round(bytes_base / toks_per_step, 1),
    }), flush=True)

    try:
        flops_none, _ = counted_step(dataclasses.replace(cfg, remat=False),
                                     B, S, device)
        tax = (flops_base - flops_none) / max(flops_none, 1)
        r = {"remat_tax_frac": round(tax, 4),
             "flops_none_per_token": round(flops_none / toks_per_step, 1)}
    except Exception as e:  # noqa: BLE001 — not fitting is a result
        r = {"remat_none": f"does not fit: {error_row(e)[:140]}"}
    release(device)
    print(json.dumps(r), flush=True)

    # -- 2b: measured device-memory bandwidth, the roofline's other axis
    membw_gbs = None
    try:
        row = membw(device, tiny)
        membw_gbs = row["membw_gbs"]
        print(json.dumps(row), flush=True)
    except Exception as e:  # noqa: BLE001 — a probe, not the bench
        print(json.dumps({"membw": f"probe failed: {error_row(e)[:120]}"}),
              flush=True)
    release(device)

    # -- 3: analytic attention share (causal matmul FLOPs, fwd+bwd)
    attn_per_tok = 12 * cfg.n_layers * cfg.d_model * S // 2
    print(json.dumps({
        "attention_flops_per_token": attn_per_tok,
        "attention_share_of_6N": round(attn_per_tok / (6 * n_params), 4),
    }), flush=True)

    # -- 4: dispatch overhead: a synchronised step vs 10 queued steps.
    # The two variants run on fresh states one after the other, so at
    # most one full train state lives on the card at a time.
    init_opt, train_step = make_train_step(cfg, learning_rate=3e-4)
    gen = torch.Generator(device=device).manual_seed(0)
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen,
                           device=device, dtype=torch.int32)

    def fresh_state():
        params = init_params(cfg, torch.Generator(device=device)
                             .manual_seed(0), device=device)
        return (params, init_opt(params), 0)

    def chunk(st, n=10):
        for _ in range(n):
            st, m = train_step(st, tokens)
        return st, float(m["loss"])  # the chunk's one synchronise

    state = fresh_state()
    state, _ = chunk(state)  # warm
    t0 = time.perf_counter()
    for _ in range(2):
        state, _ = chunk(state)
    t_chunk = (time.perf_counter() - t0) / 20

    # -- 5: measured split of one profiled chunk (state still live)
    prof = TorchQuantumProfiler(device=device)
    holder = [state]

    def profiled():
        holder[0], loss = chunk(holder[0])
        return loss

    _, st = prof.profile(profiled)
    del state, holder
    release(device)

    state_b = fresh_state()
    state_b, m = train_step(state_b, tokens)
    synchronize(device)  # warm
    t0 = time.perf_counter()
    for _ in range(3):
        state_b, m = train_step(state_b, tokens)
        synchronize(device)
    t_one = (time.perf_counter() - t0) / 3
    del state_b
    release(device)
    toks_per_s = toks_per_step / t_chunk
    print(json.dumps({
        "step_ms_hostloop": round(1e3 * t_one, 2),
        "step_ms_scan": round(1e3 * t_chunk, 2),
        "dispatch_overhead_ms": round(1e3 * (t_one - t_chunk), 2),
        "tokens_per_s_scan": round(toks_per_s, 1),
        "mfu_6N": round(toks_per_s * 6 * n_params / PEAK_FLOPS, 4),
        "mfu_cost_analysis": round(
            toks_per_s * flops_base / toks_per_step / PEAK_FLOPS, 4),
    }), flush=True)
    if st is not None and st.n_ops:
        busy = max(st.compute_ns + st.memory_ns + st.collective_ns, 1)
        print(json.dumps({
            "measured_source": st.source,
            "compute_frac": round(st.compute_ns / busy, 4),
            "stall_frac": round(st.stall_frac, 4),
            "collective_frac": round(st.collective_frac, 4),
            "top_ops": st.top_ops[:5],
        }), flush=True)
        # -- 6: stall-proxy reconciliation. The feedback loop's
        # HBM-stall input is a TIME proxy (non-tensor-core kernel time);
        # the roofline predicts the memory-bound share independently
        # from the counted BYTES at the measured bandwidth.
        if membw_gbs:
            bytes_per_s = (bytes_base / toks_per_step) * toks_per_s
            pred = bytes_per_s / (membw_gbs * 1e9)
            meas = st.memory_ns / busy
            print(json.dumps({
                "reconcile_predicted_mem_frac": round(pred, 4),
                "reconcile_measured_mem_frac": round(meas, 4),
                "reconcile_proxy_correction": round(
                    meas / max(pred, 1e-9), 3),
                "reconcile_note": (
                    "proxy correction = measured device-lane memory "
                    "share / roofline-predicted share at the measured "
                    "bandwidth; 1.0 = the proxy is faithful"),
            }), flush=True)
    else:
        print(json.dumps({"measured_split": f"no sample: "
                          f"{prof.last_error}"}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
