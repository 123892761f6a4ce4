"""Drive the PyTorch/CUDA port (``pbs_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. build   — compile every kernel of the port from ``pbs_tpu_torch/ops/csrc``
             (one nvcc per source, all at once) and print the build time.
2. kernels — hold each kernel against its plain PyTorch version on the card,
             on the shapes and with the tolerances printed beside each check.
3. main    — the feedback-scheduling loop at flagship width: one Partition
             with a CudaBackend and a FeedbackPolicy over three tenants (a
             KV-cache serving tenant answering 4 x 128-token prompts, a
             forward-scoring tenant on (4, 1024) tokens through the flash
             kernel, an instrumented-matmul tenant on 4096^3 bf16), checking
             ledger words, kernel FLOP counters, launch counts and the
             adapted slices.
4. numerics — the scoring forward through the flash kernel against the dense
             attention path on the same weights, and the KV-cache prefill
             against the full forward.
5. times   — each kernel, its plain version and one PyTorch library call
             computing the same function, at the main path's shapes.

Prints the card's name and power limit, then one ``{"kernels": [...]}`` line,
then, last, ``{"ok": true, "device": {...}}``. Exits non-zero, printing no
result, when no CUDA device is available or the port cannot be imported.
Float32 products run in full fp32 here (TF32 off).
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time

FLAGSHIP = dict(vocab=32_768, d_model=2048, n_layers=12, n_heads=16,
                n_kv_heads=8, d_ff=5_632, max_seq=1024)
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 4, 128, 32
SCORE_BATCH, SCORE_SEQ = 4, 1024
MM_N, MM_BLOCK = 4096, 256
STEPS = {"serve": 4, "score": 6, "mm": 8}
H100_PEAK_BF16_FLOPS = 989e12  # dense, data sheet
H100_PEAK_HBM_BW = 3.35e12

KERNELS = {
    "flash_fwd": dict(source="pbs_tpu_torch/ops/csrc/flash_fwd.cu",
                      replaces="pbs_tpu/ops/attention.py:70"),
    "instrumented_matmul": dict(
        source="pbs_tpu_torch/ops/csrc/instrumented_matmul.cu",
        replaces="pbs_tpu/ops/matmul.py:43"),
}


class Failed(Exception):
    pass


def check(ok: bool, what: str) -> None:
    print(f"  {'ok  ' if ok else 'FAIL'} {what}", flush=True)
    if not ok:
        raise Failed(what)


def phase(name: str) -> None:
    print(f"\n== {name} ==", flush=True)


def max_abs(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def rel_err(a, b) -> float:
    return max_abs(a, b) / (float(b.float().abs().max()) + 1e-9)


# The flash kernel computes in fp32 and rounds only its output, so it is
# held element by element against the plain version's fp32 result:
# |o - ref| <= FLASH_ATOL + r * |ref|, with r = 2^-8 (at most half a
# bf16 ulp) for a bf16 o and r = 0 for an fp32 o; lse within FLASH_ATOL.
FLASH_ATOL = 2e-4
BF16_HALF_ULP = 2.0 ** -8


def flash_against_plain(torch, q, k, v, causal, out_f32=False):
    """Run kernel 2.1 and its plain version (fp32 output) on q, k, v.
    Returns (ok, max abs err of o, max abs err of lse, the limit)."""
    from pbs_tpu_torch.ops.attention import (flash_attention_cuda,
                                             flash_attention_plain)

    o, lse = flash_attention_cuda(q, k, v, causal, out_f32=out_f32)
    ref, ref_lse = flash_attention_plain(q, k, v, causal, out_f32=True)
    r = BF16_HALF_ULP if o.dtype == torch.bfloat16 else 0.0
    diff = (o.float() - ref).abs()
    err_l = max_abs(lse, ref_lse)
    ok = (bool((diff <= FLASH_ATOL + r * ref.abs()).all())
          and bool(torch.isfinite(o).all()) and err_l <= FLASH_ATOL)
    return ok, float(diff.max()), err_l, f"{FLASH_ATOL:g} + {r:g}|ref|"


def time_ms(torch, fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def timed_in_turns(torch, fns: dict, iters: int) -> dict:
    """Each callable timed twice, in the order A B C C B A; the mean."""
    order = list(fns) + list(reversed(fns))
    acc = {k: [] for k in fns}
    for k in order:
        acc[k].append(time_ms(torch, fns[k], iters))
    return {k: sum(v) / len(v) for k, v in acc.items()}


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops = flops / H100_PEAK_BF16_FLOPS * 1e3
    t_mem = nbytes / H100_PEAK_HBM_BW * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


# -- phase 2 -----------------------------------------------------------------


def check_kernels(torch, gen) -> None:
    from pbs_tpu_torch.ops.matmul import (instrumented_matmul_cuda,
                                          instrumented_matmul_plain,
                                          scale_stats)

    def qkv(B, S, H, Hkv, hd, dtype):
        return tuple(torch.randn(B, S, h, hd, device="cuda", generator=gen)
                     .to(dtype) for h in (H, Hkv, Hkv))

    for B, S, H, Hkv, hd, dtype, causal in (
            (2, 512, 8, 4, 128, torch.bfloat16, True),
            (2, 512, 8, 4, 128, torch.bfloat16, False),
            (2, 511, 8, 4, 128, torch.bfloat16, True),  # ragged S
            (1, 2048, 8, 4, 128, torch.bfloat16, True),
            (2, 384, 8, 2, 64, torch.float32, True)):
        for out_f32 in (False, True):
            ok, err_o, err_l, limit = flash_against_plain(
                torch, *qkv(B, S, H, Hkv, hd, dtype), causal, out_f32)
            check(ok, f"flash {str(dtype)[6:]} B{B} S{S} H{H}/{Hkv} hd{hd} "
                      f"causal={causal} out_f32={out_f32}: |o-ref| max "
                      f"{err_o:.2e} <= {limit}, lse {err_l:.2e} <= "
                      f"{FLASH_ATOL:g}")

    a = torch.randn(512, 512, device="cuda", generator=gen).bfloat16()
    b = torch.randn(512, 512, device="cuda", generator=gen).bfloat16()
    out, raw = instrumented_matmul_cuda(a, b, 256, 256, 256)
    ref, ref_raw = instrumented_matmul_plain(a, b, 256, 256, 256)
    st = scale_stats(raw, 256, 256, 256)
    err = rel_err(out, ref)
    check(raw.tolist() == ref_raw.tolist() and st.mxu_tiles == 8
          and st.flops == 8 * 2 * 256 ** 3 and err < 1e-3,
          f"matmul bf16 512^3: stats {raw.tolist()} == plain "
          f"{ref_raw.tolist()}, mxu_tiles 8, rel err {err:.2e} < 1e-3")
    a, b = mm_operands(torch, gen)
    out, raw = instrumented_matmul_cuda(a, b, MM_BLOCK, MM_BLOCK, MM_BLOCK)
    ref, ref_raw = instrumented_matmul_plain(a, b, MM_BLOCK, MM_BLOCK,
                                             MM_BLOCK)
    err = rel_err(out, ref)
    check(raw.tolist() == ref_raw.tolist() and raw.tolist()[1] > 0
          and err < 1e-3,
          f"matmul bf16 4096^3 with planted zero tiles: stats "
          f"{raw.tolist()} == plain {ref_raw.tolist()}, rel err "
          f"{err:.2e} < 1e-3")


def mm_operands(torch, gen):
    a = torch.randn(MM_N, MM_N, device="cuda", generator=gen).bfloat16()
    b = torch.randn(MM_N, MM_N, device="cuda", generator=gen).bfloat16()
    blk = MM_BLOCK
    for i, k in ((0, 0), (3, 5), (7, 15), (15, 2)):  # planted zero A tiles
        a[i * blk:(i + 1) * blk, k * blk:(k + 1) * blk] = 0
    return a, b


# -- phase 3 -----------------------------------------------------------------


def run_main_path(torch, gen, cfg, params):
    from pbs_tpu_torch.models import forward, make_serve_step
    from pbs_tpu_torch.ops.attention import flash_attention_cuda
    from pbs_tpu_torch.ops.matmul import (instrumented_matmul,
                                          instrumented_matmul_cuda,
                                          scale_stats)
    from pbs_tpu_torch.runtime import Job, Partition, SchedParams
    from pbs_tpu_torch.sched import FeedbackPolicy
    from pbs_tpu_torch.telemetry import Counter, CudaBackend

    prompts = torch.randint(0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT),
                            device="cuda", generator=gen)
    score_tokens = torch.randint(0, cfg.vocab, (SCORE_BATCH, SCORE_SEQ),
                                 device="cuda", generator=gen)
    score_cfg = dataclasses.replace(cfg, attn_impl="pallas")
    a, b = mm_operands(torch, gen)
    serve_step = make_serve_step(cfg, max_new_tokens=SERVE_NEW)

    def serve_fn(state):
        return serve_step(state, prompts)

    @torch.no_grad()
    def score_fn(state):
        logits = forward(score_cfg, params, score_tokens)
        # the (B,) next-token predictions are the tenant's answer
        return logits[:, -1].argmax(dim=-1), {"tokens": score_tokens.numel()}

    def mm_fn(state):
        out, raw = instrumented_matmul(a, b, MM_BLOCK, MM_BLOCK, MM_BLOCK)
        return out, scale_stats(raw, MM_BLOCK, MM_BLOCK, MM_BLOCK).metrics()

    serve_state = (params, torch.Generator(device="cuda").manual_seed(1), 0)
    # Warm each tenant once outside the partition (cuBLAS handles, the
    # caching allocator), so a slow first step is not charged as
    # device time.
    for fn, st in ((serve_fn, serve_state), (score_fn, None), (mm_fn, None)):
        fn(st)
    torch.cuda.synchronize()

    be = CudaBackend()
    part = Partition("smoke", source=be)
    fb = FeedbackPolicy(part)
    jobs = {
        "serve": Job("serve", step_fn=serve_fn, state=serve_state,
                     params=SchedParams(weight=256, tslice_us=100,
                                        boost_on_wake=True),
                     max_steps=STEPS["serve"]),
        "score": Job("score", step_fn=score_fn, state=None,
                     params=SchedParams(weight=256),
                     max_steps=STEPS["score"]),
        "mm": Job("mm", step_fn=mm_fn, state=None,
                  params=SchedParams(weight=512), max_steps=STEPS["mm"]),
    }
    for job in jobs.values():
        part.add_job(job)
    flash_attention_cuda.launches = 0
    instrumented_matmul_cuda.launches = 0
    t0 = time.monotonic()
    quanta = part.run()
    wall = time.monotonic() - t0
    launches = {"flash_fwd": flash_attention_cuda.launches,
                "instrumented_matmul": instrumented_matmul_cuda.launches}
    print(f"  {quanta} quanta in {wall:.2f} s wall; kernel launches "
          f"{launches}", flush=True)
    print(f"  {'tenant':<6} {'steps':>5} {'device_ms':>10} "
          f"{'stall_rate':>10} {'tslice_us':>9} {'sched':>5}")
    for name, job in jobs.items():
        ctx = job.contexts[0]
        print(f"  {name:<6} {job.steps_retired():>5} "
              f"{int(ctx.counters[Counter.DEVICE_TIME_NS]) / 1e6:>10.2f} "
              f"{job.stall_rate:>10.1f} {job.params.tslice_us:>9} "
              f"{ctx.sched_count:>5}", flush=True)
    print(f"  feedback: {json.dumps(fb.dump())}")

    for name, job in jobs.items():
        check(job.error is None and job.steps_retired() == STEPS[name],
              f"{name}: {job.steps_retired()} steps retired, no fault "
              f"({job.error})")
        ctx = job.contexts[0]
        snap = part.ledger.snapshot(ctx.ledger_slot)
        check(snap.tolist() == ctx.counters.tolist(),
              f"{name}: ledger snapshot equals the context counters")
        check(fb.min_us <= job.params.tslice_us <= fb.max_us,
              f"{name}: tslice {job.params.tslice_us} us inside the "
              f"feedback band [{fb.min_us}, {fb.max_us}]")
    mm_flops = int(jobs["mm"].contexts[0].counters[Counter.DEVICE_FLOPS])
    check(mm_flops == STEPS["mm"] * 2 * MM_N ** 3,
          f"mm: ledger DEVICE_FLOPS {mm_flops} == steps x 2 x 4096^3")
    tokens = int(jobs["serve"].contexts[0].counters[Counter.TOKENS])
    check(tokens == STEPS["serve"] * SERVE_BATCH * SERVE_NEW
          and jobs["serve"].state[2] == STEPS["serve"],
          f"serve: {jobs['serve'].state[2]} batches answered, {tokens} "
          f"tokens == {STEPS['serve']} x {SERVE_BATCH} x {SERVE_NEW}")
    pred = jobs["score"].state
    check(pred.shape == (SCORE_BATCH,) and bool(((pred >= 0)
                                                 & (pred < cfg.vocab)).all()),
          f"score: next-token predictions {pred.tolist()} in [0, vocab)")
    for name, n in launches.items():
        check(n > 0, f"{name}: {n} launches on the main path")
    return launches


# -- phase 4 -----------------------------------------------------------------


def check_numerics(torch, gen, cfg, params) -> None:
    from pbs_tpu_torch.models import forward, forward_with_cache, init_cache

    tokens = torch.randint(0, cfg.vocab, (SCORE_BATCH, SCORE_SEQ),
                           device="cuda", generator=gen)
    with torch.no_grad():
        flash = forward(dataclasses.replace(cfg, attn_impl="pallas"), params,
                        tokens)
        dense = forward(cfg, params, tokens)
        finite = bool(torch.isfinite(flash).all())
        err = max_abs(flash, dense)
        rel = rel_err(flash, dense)
        del flash
        check(finite and tuple(dense.shape) == (SCORE_BATCH, SCORE_SEQ,
                                                cfg.vocab) and rel < 0.05,
              f"score logits, flash vs dense attention at width (bf16): "
              f"finite, max abs diff {err:.3e}, rel {rel:.3e} < 0.05")
        prompt = tokens[:, :SERVE_PROMPT]
        cache = init_cache(cfg, SCORE_BATCH, max_len=SERVE_PROMPT + 1,
                           device="cuda")
        cached, cache = forward_with_cache(cfg, params, prompt, cache)
        full = forward(cfg, params, prompt)
        rel = rel_err(cached, full)
        check(cache["pos"] == SERVE_PROMPT and rel < 0.05,
              f"KV-cache prefill vs full forward (bf16): rel {rel:.3e} "
              f"< 0.05")


# -- phase 5 -----------------------------------------------------------------


def time_kernels(torch, gen, launches) -> list:
    import torch.nn.functional as F

    from pbs_tpu_torch.ops.attention import (flash_attention_cuda,
                                             flash_attention_plain)
    from pbs_tpu_torch.ops.matmul import (instrumented_matmul_cuda,
                                          instrumented_matmul_plain)

    rows = []
    B, S, H, Hkv, hd = SCORE_BATCH, SCORE_SEQ, FLAGSHIP["n_heads"], \
        FLAGSHIP["n_kv_heads"], FLAGSHIP["d_model"] // FLAGSHIP["n_heads"]
    q = torch.randn(B, S, H, hd, device="cuda", generator=gen).bfloat16()
    k = torch.randn(B, S, Hkv, hd, device="cuda", generator=gen).bfloat16()
    v = torch.randn(B, S, Hkv, hd, device="cuda", generator=gen).bfloat16()
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    # the main path's call: bf16 o, causal
    flash_ok, err, err_l, limit = flash_against_plain(torch, q, k, v, True)
    check(flash_ok, f"flash at the main path's shape: |o-ref| max "
                    f"{err:.2e} <= {limit}, lse {err_l:.2e} <= "
                    f"{FLASH_ATOL:g}")
    t = timed_in_turns(torch, {
        "ms": lambda: flash_attention_cuda(q, k, v, True),
        "plain_ms": lambda: flash_attention_plain(q, k, v, True),
        "library_ms": lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True),
    }, iters=10)
    pairs = S * (S + 1) // 2  # causal (query, key) pairs per (b, h)
    flops = 4 * B * H * hd * pairs
    nbytes = 2 * (2 * B * S * H * hd + 2 * B * S * Hkv * hd) + 4 * B * S * H
    bms, by = bound(flops, nbytes)
    rows.append(dict(name="flash_fwd", route="cuda", **KERNELS["flash_fwd"],
                     launches=launches["flash_fwd"], max_abs_err=err, **t,
                     bound_ms=bms, bound_by=by, ok=flash_ok,
                     tolerance=f"|o-ref| <= {limit}, ref = plain fp32 o",
                     shape=f"q ({B},{S},{H},{hd}) k/v ({B},{S},{Hkv},{hd}) "
                           "bf16 causal"))

    a, b = mm_operands(torch, gen)
    blk = MM_BLOCK
    out, raw = instrumented_matmul_cuda(a, b, blk, blk, blk)
    ref, ref_raw = instrumented_matmul_plain(a, b, blk, blk, blk)
    err, rel = max_abs(out, ref), rel_err(out, ref)
    mm_ok = raw.tolist() == ref_raw.tolist() and rel < 1e-3
    check(mm_ok, f"matmul at the main path's shape: stats {raw.tolist()} "
                 f"== plain, rel err {rel:.2e} < 1e-3")
    fns = {
        "ms": lambda: instrumented_matmul_cuda(a, b, blk, blk, blk),
        "plain_ms": lambda: instrumented_matmul_plain(a, b, blk, blk, blk),
    }
    library = mm_library_call(torch, a, b, ref)
    if library is not None:
        fns["library_ms"] = library
    t = {"library_ms": None, **timed_in_turns(torch, fns, iters=5)}
    flops = 2 * MM_N ** 3
    nbytes = 2 * 2 * MM_N * MM_N + 4 * MM_N * MM_N + 16
    bms, by = bound(flops, nbytes)
    rows.append(dict(name="instrumented_matmul", route="cuda",
                     **KERNELS["instrumented_matmul"],
                     launches=launches["instrumented_matmul"],
                     max_abs_err=err, **t, bound_ms=bms, bound_by=by,
                     ok=mm_ok, tolerance="stats equal, rel err < 1e-3",
                     shape=f"{MM_N}^3 bf16 in, fp32 out, blocks {blk}"))
    for r in rows:
        print(f"  {r['name']}: {r['ms']:.3f} ms (plain {r['plain_ms']:.3f}, "
              f"library {r['library_ms']}, bound {r['bound_ms']:.4f} "
              f"by {r['bound_by']}) at {r['shape']}", flush=True)
    return rows


def mm_library_call(torch, a, b, ref):
    """The one PyTorch call that writes the fp32 product of bf16
    operands, ``torch.mm(..., out_dtype=torch.float32)``, or None where
    this torch build lacks it (``torch.matmul`` writes a bf16 result, a
    different function)."""
    try:
        out = torch.mm(a, b, out_dtype=torch.float32)
    except (TypeError, RuntimeError) as e:
        print(f"  torch.mm(out_dtype=float32) unavailable, library_ms "
              f"null: {str(e).splitlines()[0]}", flush=True)
        return None
    rel = rel_err(out, ref)
    check(out.dtype == torch.float32 and rel < 1e-3,
          f"library torch.mm(out_dtype=float32): fp32 out, rel err "
          f"{rel:.2e} < 1e-3")
    return lambda: torch.mm(a, b, out_dtype=torch.float32)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from pbs_tpu_torch.models import (TransformerConfig, cast_params,
                                      init_params)
    from pbs_tpu_torch.ops import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    phase("1 build")
    t0 = time.monotonic()
    built = cuda_build.build()
    for r in built.values():
        regs = [ln.strip() for ln in r.log.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"  {r.name}: {r.seconds:.1f} s -> {r.path.name}")
        for ln in regs:
            print(f"    {ln}")
    print(f"  build wall {time.monotonic() - t0:.1f} s", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    phase("2 kernels against their plain versions")
    check_kernels(torch, gen)

    phase("3 main path: Partition + FeedbackPolicy + CudaBackend")
    cfg = TransformerConfig(**FLAGSHIP, dtype=torch.bfloat16)
    # cast once at load: the values of wload's per-call cast
    params = cast_params(init_params(cfg, gen, device="cuda"), cfg.dtype)
    print(f"  flagship: {cfg.num_params() / 1e6:.0f}M params, bf16, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    launches = run_main_path(torch, gen, cfg, params)

    phase("4 numerics at width")
    check_numerics(torch, gen, cfg, params)
    del params

    phase("5 times at the main path's shapes")
    rows = time_kernels(torch, gen, launches)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
