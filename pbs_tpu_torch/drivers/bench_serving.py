"""Serving benchmark: flagship decode throughput + prefill latency.

The port of ``bench_serving.py``: steady-state decode tokens/s of the
KV-cached lockstep generate loop, prefill time-to-first-token latency,
and the continuous-batching engine matrix {dense, MoE} x {plain,
speculative} x {bf16, int8}, on the flagship ~700M decoder. One JSON
line per metric, the reference's keys.

The lockstep path (``models/generate.py``) runs no kernel: its attention
is the dense ``_cached_attention``, as the reference's default
``attn_impl="xla"`` is. Every timing is bracketed by
``torch.cuda.synchronize()``, which takes the place of the reference's
host fetch of an in-graph scalar (its tunnel backend could report
readiness early; a synchronise waits for every queued kernel).

    python -m pbs_tpu_torch.drivers.bench_serving                # the card
    PBST_BENCH_TINY=1 python -m pbs_tpu_torch.drivers.bench_serving  # CPU
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

from pbs_tpu_torch.drivers.bench_common import (abandon_if_unavailable,
                                                bench_device, error_row,
                                                release, synchronize,
                                                tiny_mode)

#: The reference's eight engine rows, in its order.
ENGINE_NAMES = (
    "continuous_bf16", "continuous_int8", "spec_continuous_bf16",
    "spec_continuous_int8", "continuous_moe_dropless",
    "spec_continuous_moe_dropless", "continuous_moe_int8",
    "spec_continuous_moe_int8",
)


def sizes(tiny: bool) -> dict:
    """The reference's batch and length settings (``bench_serving.py``
    :37-40 and :134-137), at full width and in tiny mode."""
    if tiny:
        return dict(batch=2, prompt_len=16, new_tokens=8, iters=2,
                    n_slots=2, eng_new=8, bucket=16)
    return dict(batch=8, prompt_len=512, new_tokens=128, iters=5,
                n_slots=8, eng_new=64, bucket=512)


def prefill_row(cfg, params, prompt, new_tokens: int, device,
                reps: int = 10) -> tuple[dict, float]:
    """Prefill latency (the TTFT floor): the prompt pass into a fresh
    cache, one warm call and then ``reps`` timed ones, each closed by a
    synchronise. Returns (the JSON row, the median in ms)."""
    import torch

    from pbs_tpu_torch.models.generate import init_cache, prefill

    batch, prompt_len = prompt.shape

    @torch.no_grad()
    def pre():
        cache = init_cache(cfg, batch, max_len=prompt_len + new_tokens,
                           device=device)
        logits, _ = prefill(cfg, params, prompt, cache)
        return torch.sum(logits.float())

    pre()
    synchronize(device)
    ttfts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        pre()
        synchronize(device)
        ttfts.append((time.perf_counter() - t0) * 1e3)
    ttfts.sort()
    med = ttfts[len(ttfts) // 2]
    return {
        "metric": "serving_prefill_ms",
        "value": round(med, 1),
        "unit": "ms",
        "p90_ms": round(ttfts[max(int(len(ttfts) * 0.9) - 1, 0)], 1),
        "batch": batch,
        "prompt_len": prompt_len,
    }, med


def decode_row(cfg, params, prompt, new_tokens: int, device, prefill_ms,
               iters: int) -> dict:
    """Decode throughput: the full generate loop (prefill + new_tokens -
    1 decode steps), one warm call and ``iters`` timed ones, each closed
    by a synchronise as each timed prefill was, so subtracting the
    median prefill isolates the decode rate."""
    import torch

    from pbs_tpu_torch.models.generate import make_generate

    gen_fn = make_generate(cfg, max_new_tokens=new_tokens, temperature=0.0)
    gen_fn(params, prompt)
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        gen_fn(params, prompt)
        synchronize(device)
    dt = time.perf_counter() - t0
    batch = prompt.shape[0]
    total_new = batch * new_tokens * iters
    decode_dt = max(dt - iters * prefill_ms / 1e3, 1e-9)
    dev = torch.device(device)
    return {
        "metric": "serving_decode_throughput",
        "value": round(total_new / decode_dt, 1),
        "unit": "tokens/s",
        "per_step_ms": round(1e3 * decode_dt / (new_tokens * iters), 2),
        "batch": batch,
        "new_tokens": new_tokens,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev)),
    }


def moe_config(cfg):
    """The matrix's second model family: the flagship's attention dims
    with E=4 experts of d_ff / 4 (total params match the dense
    flagship), provably dropless routing (the mode engine parity and
    speculative verification need)."""
    from pbs_tpu_torch.models.moe import MoEConfig

    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    return MoEConfig(**{**fields, "d_ff": cfg.d_ff // 4}, n_experts=4,
                     top_k=2, dropless=True)


def engine_factories(cfg, params, device, sz: dict, seed: int = 0) -> dict:
    """name -> a zero-argument factory of each of the eight engines. The
    int8 trees and the MoE masters are built at first use and kept (the
    fp32 MoE masters must not sit on the card while the dense rows run);
    the engine classes are looked up in ``pbs_tpu_torch.models`` when a
    factory runs."""
    import torch

    from pbs_tpu_torch import models
    from pbs_tpu_torch.models.moe import init_moe_params, moe_slot_mlp
    from pbs_tpu_torch.models.quant import quantize_weights

    mcfg = moe_config(cfg)
    memo: dict = {}

    def once(key, make):
        if key not in memo:
            memo[key] = make()
        return memo[key]

    def qparams():
        return once("q", lambda: quantize_weights(params))

    def mparams():
        return once("m", lambda: init_moe_params(
            mcfg, torch.Generator(device=device).manual_seed(seed),
            device=device))

    def qmparams():
        # int8 MoE tree: experts int8 per output channel, router fp32.
        return once("qm", lambda: quantize_weights(mparams()))

    n_slots, bucket = sz["n_slots"], sz["bucket"]
    kw = dict(n_slots=n_slots, prompt_bucket=bucket,
              max_len=bucket + sz["eng_new"] + 8, device=device)
    mlp = dict(mlp_fn=moe_slot_mlp(mcfg))
    return {
        "continuous_bf16": lambda: models.ContinuousBatcher(
            cfg, params, **kw),
        "continuous_int8": lambda: models.ContinuousBatcher(
            cfg, qparams(), **kw),
        "spec_continuous_bf16": lambda: models.SpeculativeBatcher(
            cfg, params, cfg, params, k=4, **kw),
        "spec_continuous_int8": lambda: models.SpeculativeBatcher(
            cfg, qparams(), cfg, params, k=4, **kw),
        "continuous_moe_dropless": lambda: models.ContinuousBatcher(
            mcfg, mparams(), **kw, **mlp),
        # Self-draft (the MoE drafts for itself): the acceptance ceiling,
        # mirroring the dense row.
        "spec_continuous_moe_dropless": lambda: models.SpeculativeBatcher(
            mcfg, mparams(), mcfg, mparams(), k=4, **kw, **mlp,
            draft_mlp_fn=moe_slot_mlp(mcfg)),
        "continuous_moe_int8": lambda: models.ContinuousBatcher(
            mcfg, qmparams(), **kw, **mlp),
        # int8 MoE target + fp MoE draft: the deployment-shaped pair.
        "spec_continuous_moe_int8": lambda: models.SpeculativeBatcher(
            mcfg, qmparams(), mcfg, mparams(), k=4, **kw, **mlp,
            draft_mlp_fn=moe_slot_mlp(mcfg)),
    }


def engine_prompts(n_slots: int) -> list[list[int]]:
    return [list(range(1, 1 + (3 + i % 5))) for i in range(2 * n_slots)]


def engine_row(name: str, make_eng, prompts, eng_new: int,
               device) -> dict:
    """One engine of the matrix: build it, submit ``prompts`` and step it
    until idle; tokens/s over the stepping wall time (closed by a
    synchronise), ticks, completions and the engine's own TTFT and
    latency percentiles. Raises what the engine raises."""
    eng = make_eng()
    for p in prompts:
        eng.submit(p, max_new_tokens=eng_new)
    t0 = time.perf_counter()
    while eng.has_work():
        eng.step()
    synchronize(device)
    dt = time.perf_counter() - t0
    st = eng.stats()
    row = {
        "metric": f"serving_{name}_throughput",
        "value": round(st["tokens_emitted"] / dt, 1),
        "unit": "tokens/s",
        "ticks": st["steps"],
        "requests": st["completed"],
        "ttft_p50_s": st["ttft_p50_s"],
        "ttft_p99_s": st["ttft_p99_s"],
        "latency_p99_s": st["latency_p99_s"],
    }
    if "spec_acceptance" in st:
        row["acceptance"] = st["spec_acceptance"]
    return row


def run_engines(factories: dict, names, prompts, eng_new: int,
                device) -> tuple[list[dict], bool]:
    """The engine rows ``names`` in turn, each dropped (and the card's
    cache emptied) before the next is built; one engine failing is an
    error row, a fatal error (``bench_common.backend_unavailable``)
    abandons the rest. Returns (rows, any engine ok)."""
    rows, any_ok = [], False
    for name in names:
        release(device)
        fatal = None
        try:
            row = engine_row(name, factories[name], prompts, eng_new, device)
            any_ok = True
        except Exception as e:  # noqa: BLE001 — keep the matrix going
            row = {"metric": f"serving_{name}_throughput",
                   "error": error_row(e)}
            fatal = e.with_traceback(None)  # drop the engine's frames
        print(json.dumps(row), flush=True)
        rows.append(row)
        if fatal is not None and abandon_if_unavailable(
                fatal, "the remaining serving engines"):
            break
    release(device)
    return rows, any_ok


def setup(tiny: bool, device, seed: int = 0):
    """(cfg, fp32 master params, prompt) on ``device``, seeded."""
    import torch

    from pbs_tpu_torch.drivers.graft_entry import _flagship_cfg
    from pbs_tpu_torch.models import init_params

    sz = sizes(tiny)
    cfg = _flagship_cfg(tiny=tiny)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_params(cfg, gen, device=device)
    prompt = torch.randint(0, cfg.vocab, (sz["batch"], sz["prompt_len"]),
                           generator=gen, device=device, dtype=torch.int32)
    return cfg, params, prompt


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="run here (default: the card; tiny mode: cpu)")
    args = ap.parse_args(argv)
    tiny = tiny_mode("PBST_BENCH_TINY")
    device = bench_device(tiny, args.device)
    sz = sizes(tiny)
    cfg, params, prompt = setup(tiny, device)

    row, prefill_ms = prefill_row(cfg, params, prompt, sz["new_tokens"],
                                  device)
    print(json.dumps(row), flush=True)
    print(json.dumps(decode_row(cfg, params, prompt, sz["new_tokens"],
                                device, prefill_ms, sz["iters"])),
          flush=True)

    factories = engine_factories(cfg, params, device, sz)
    _, any_ok = run_engines(factories, ENGINE_NAMES,
                            engine_prompts(sz["n_slots"]), sz["eng_new"],
                            device)
    return 0 if any_ok else 1


if __name__ == "__main__":
    sys.exit(main())
