"""Drive the PyTorch/CUDA port (``pbs_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. build   — compile every kernel of the port from ``pbs_tpu_torch/ops/csrc``
             (one nvcc per source, all at once) and print the build time
             and each kernel's registers and spills (ptxas).
2. kernels — hold each kernel against its plain PyTorch version on the card,
             on the shapes and with the tolerances printed beside each check,
             and the route each launch took (bf16 inputs TMA can address run
             on the tensor cores, "wgmma"; the rest on the CUDA cores, "simt":
             fp32 inputs, and for the backward an fp32 do).
3. main    — the feedback-scheduling loop at flagship width: one Partition
             with a CudaBackend and a FeedbackPolicy over three tenants (a
             KV-cache serving tenant answering 4 x 128-token prompts, a
             forward-scoring tenant on (4, 1024) tokens through the flash
             kernel, an instrumented-matmul tenant on 4096^3 bf16), checking
             ledger words, kernel FLOP counters, launch counts (every
             launch of kernels 2.1 and 2.4 on the tensor-core route) and the
             adapted slices.
3t. train  — the flagship training step as a micro-stepped Job: a second
             Partition holds the training tenant (remat "dots", attention
             through the flash kernels, 3 micro-batches of (2, 1024) tokens
             per AdamW step, 2 steps) beside the KV-cache serving tenant,
             checking retired steps, ledger tokens, yields at chunk
             boundaries, losses, parameter movement, that every
             backward went through kernels 2.2 and 2.3 and every forward
             through kernel 2.1, all on the tensor-core route.
3m. measured — serve, score, mm and the training Job in one Partition
             under FeedbackPolicy, with a CompileAdmission and CudaBackend
             (profile_every=2): each tenant's first invocation and every
             2nd after it run under torch.profiler, and the stall fraction
             measured from the card's kernels sets HBM_STALL_NS. Checks
             every sample came from the device lane with no profiler
             failure, train measured more memory-bound than mm, mm below
             its roofline estimate, an overflow sample on serve's TOKENS
             that fires once and stays disarmed until rearmed, no compile
             charged to any tenant, and that phase 1's nvcc runs are the
             CompileMeter's compiles; prints each tenant's measured
             fractions and top kernels beside the roofline estimate, its
             final slice, and its sampled and unsampled device time.
3s. engine — the serving engine (``ContinuousBatcher``) on a seeded script of
             24 staggered requests at flagship width, 8 slots: (a) bf16, as a
             Job beside score and mm under FeedbackPolicy + CudaBackend,
             checking completions, ledger TOKENS, prefix hits and that every
             launch of kernels 2.1 and 2.4 took the tensor-core route; (b) an
             fp32 engine token-exact against the lockstep ``make_generate``
             at B=1 (a divergence passes only at a near-tie of the lockstep
             run's top-2 logits); (c) the ``SpeculativeBatcher`` (k=4, a
             noisy-head draft) token-exact against (b) in fewer ticks; (d)
             int8 weight-only serving at bf16 compute: bytes, prefill logits
             against bf16, every request served. Prints each engine's TTFT
             and latency p50/p99, decode-tick and prefill ms, tokens/s and
             acceptance beside the card's name and power limit.
4. numerics — the scoring forward through the flash kernel against the dense
             attention path on the same weights, the KV-cache prefill
             against the full forward, and one micro-batch's training loss
             and gradients through the flash kernels against the dense
             attention path.
5. times   — each kernel, its plain version and one PyTorch library call
             computing the same function, at the main paths' shapes (2.1 at
             the serving and at the training shape), with achieved TFLOP/s
             and the fraction of the bound each kernel reaches; 2.2 and 2.3
             also on their CUDA-core route and beside the row-delta
             reduction they read; one profiled training micro-step (device
             time by kernel, idle share).

``--trace-out PATH`` also writes one profiled quantum's Chrome trace,
trimmed to a few dozen events (the CPU tests parse such a trace from
``tests/data/``).

Prints the card's name and power limit, then one ``{"kernels": [...]}`` line,
then, last, ``{"ok": true, "device": {...}}``. Exits non-zero, printing no
result, when no CUDA device is available or the port cannot be imported.
Float32 products run in full fp32 here (TF32 off).
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import time

FLAGSHIP = dict(vocab=32_768, d_model=2048, n_layers=12, n_heads=16,
                n_kv_heads=8, d_ff=5_632, max_seq=1024)
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 4, 128, 32
SCORE_BATCH, SCORE_SEQ = 4, 1024
MM_N, MM_BLOCK = 4096, 256
STEPS = {"serve": 4, "score": 6, "mm": 8}
# The training tenant: micro-batch (2, 1024), 3 micro-batches per AdamW
# step (a global batch of 6 x 1024), 2 steps.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO, TRAIN_STEPS, TRAIN_LR = 2, 1024, 3, 2, 3e-4
# Phase 3m, measured telemetry: every tenant at width, each sampled by
# torch.profiler on its first invocation and every 2nd after it; fewer
# steps than phases 3 and 3t, and one slice for all to start from.
MEASURED_STEPS = {"serve": 3, "score": 4, "mm": 8}
MEASURED_TRAIN_STEPS = 2
MEASURED_PROFILE_EVERY = 2
MEASURED_TSLICE_US = 300
MEASURED_COMPILE_BUDGET_NS = 600 * 10 ** 9
# Phase 3s, the serving engine: a seeded script of 24 requests (prompts of
# 16-128 tokens, budgets of 8-64), 8 at tick 0 then 2 a tick, the last 4
# repeating the first 4 prompts; 8 slots, prompts padded to 128, slabs of
# 512 positions, a prefix cache of 32 entries.
ENGINE_SEED = 6
ENGINE_REQUESTS, ENGINE_FIRST, ENGINE_PER_TICK, ENGINE_REPEATS = 24, 8, 2, 4
ENGINE_PROMPT, ENGINE_NEW = (16, 128), (8, 64)
ENGINE_SLOTS, ENGINE_BUCKET, ENGINE_MAX_LEN, ENGINE_PREFIX = 8, 128, 512, 32
# The speculative engine's draft: the target with its head perturbed by
# seeded Gaussian noise at 5% of the head's standard deviation, k = 4.
ENGINE_K, ENGINE_DRAFT_NOISE = 4, 0.05
# A greedy divergence passes only at a near-tie: the lockstep run's top-2
# fp32 logits within 1e-4 of the larger one's magnitude.
ENGINE_TIE = 1e-4
# int8 weight-only: under 0.55 x the bf16 tree's bytes, and prefill logits
# within 0.35 std of the bf16 tree's (the bound of tests/test_quant.py).
ENGINE_INT8_BYTES, ENGINE_INT8_LOGITS = 0.55, 0.35
# The int8 engine's own prefill logits against the lockstep prefill's on
# the same int8 tree, in std of the latter: two bf16 paths, one function
# (a sound H100 run read 0.0000 to four places; a wrong scale or slice in
# the engine's int8 path moves the logits by ~1 std).
ENGINE_INT8_PATHS = 0.02
# Decode ticks of the bf16 engine profiled after (a), all slots busy.
ENGINE_PROFILED_TICKS = 3
H100_PEAK_BF16_FLOPS = 989e12  # dense, data sheet
H100_PEAK_HBM_BW = 3.35e12

KERNELS = {
    "flash_fwd": dict(source="pbs_tpu_torch/ops/csrc/flash_fwd.cu",
                      replaces="pbs_tpu/ops/attention.py:70"),
    "flash_bwd_dq": dict(source="pbs_tpu_torch/ops/csrc/flash_bwd.cu",
                         replaces="pbs_tpu/ops/attention.py:164"),
    "flash_bwd_dkv": dict(source="pbs_tpu_torch/ops/csrc/flash_bwd.cu",
                          replaces="pbs_tpu/ops/attention.py:209"),
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


# The backward kernels also accumulate in fp32 and round once, so each
# gradient is held against the plain backward's fp32 result on the same
# inputs: |g - ref| <= BWD_REL[dtype] * max|ref| + r * |ref|, r = 2^-8
# for a bf16 gradient (half a bf16 ulp) and 0 for an fp32 one. Beside
# each check the smallest BWD_REL that would have passed is printed. On an
# H100 that was <= 1.1e-7 (bf16, where the 2^-8 term carries the rounding)
# and <= 1.7e-6 (fp32, summation order over up to 2048 keys); 1e-5 keeps
# room for other seeds and lengths and is 100x tighter than a wrong
# kernel's error.
BWD_REL = {"bfloat16": 1e-5, "float32": 1e-5}


def bwd_against_plain(torch, gen, q, k, v, causal, with_dlse):
    """Run kernels 2.2 and 2.3 through the backward wrapper on q, k, v,
    the forward kernel's (o, lse) and a random do (and dlse when
    ``with_dlse``: the lse variant's fp32 o, fp32 do, random lse
    cotangent), and the plain backward in fp32 on the same inputs.
    Returns (ok, max abs err, the smallest BWD_REL that passes, the
    limit, the routes of the dq and the dk/dv launch)."""
    from pbs_tpu_torch.ops.attention import (flash_attention_bwd,
                                             flash_attention_bwd_dkv_cuda,
                                             flash_attention_bwd_dq_cuda,
                                             flash_attention_bwd_plain,
                                             flash_attention_cuda)

    o, lse = flash_attention_cuda(q, k, v, causal, out_f32=with_dlse)
    do = torch.randn(o.shape, device="cuda", generator=gen).to(o.dtype)
    dlse = (torch.randn(lse.shape, device="cuda", generator=gen)
            if with_dlse else None)
    wrappers = (flash_attention_bwd_dq_cuda, flash_attention_bwd_dkv_cuda)
    before = [dict(w.launches_by_route) for w in wrappers]
    got = flash_attention_bwd(q, k, v, o, lse, do, dlse, causal)
    routes = tuple(route_taken(w, b) for w, b in zip(wrappers, before))
    ref = flash_attention_bwd_plain(q.float(), k.float(), v.float(), o, lse,
                                    do.float(), dlse, causal)
    ok, err, need = True, 0.0, 0.0
    name = str(q.dtype)[6:]
    r = BF16_HALF_ULP if q.dtype == torch.bfloat16 else 0.0
    for g, want in zip(got, ref):
        diff = (g.float() - want).abs()
        scale = float(want.abs().max())
        ok = (ok and g.dtype == q.dtype and bool(torch.isfinite(g).all())
              and bool((diff <= BWD_REL[name] * scale
                        + r * want.abs()).all()))
        err = max(err, float(diff.max()))
        need = max(need, float((diff - r * want.abs()).clamp_min(0).max())
                   / scale)
    return ok, err, need, f"{BWD_REL[name]:g} max|ref| + {r:g}|ref|", routes


def route_taken(wrapper, before: dict) -> str:
    """The route of the one launch ``wrapper`` made since ``before`` (a
    copy of its ``launches_by_route``), or a description of what else
    happened."""
    grew = {k: n - before[k] for k, n in wrapper.launches_by_route.items()
            if n != before[k]}
    return next(iter(grew)) if list(grew.values()) == [1] else f"{grew}"


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
    from pbs_tpu_torch.ops.attention import flash_attention_cuda
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
            (2, 384, 8, 2, 64, torch.float32, True),
            # the training path's call: S - 1 = 1023 after the shift
            (TRAIN_BATCH, TRAIN_SEQ - 1, 16, 8, 128, torch.bfloat16, True)):
        for out_f32 in (False, True):
            before = dict(flash_attention_cuda.launches_by_route)
            ok, err_o, err_l, limit = flash_against_plain(
                torch, *qkv(B, S, H, Hkv, hd, dtype), causal, out_f32)
            route = route_taken(flash_attention_cuda, before)
            want = "wgmma" if dtype == torch.bfloat16 else "simt"
            check(ok and route == want,
                  f"flash {str(dtype)[6:]} B{B} S{S} H{H}/{Hkv} hd{hd} "
                  f"causal={causal} out_f32={out_f32} [{route}]: |o-ref| "
                  f"max {err_o:.2e} <= {limit}, lse {err_l:.2e} <= "
                  f"{FLASH_ATOL:g}")

    for B, S, H, Hkv, hd, dtype, causal in (
            (2, 512, 8, 4, 128, torch.bfloat16, True),
            (2, 512, 8, 4, 128, torch.bfloat16, False),
            (2, 511, 8, 4, 128, torch.bfloat16, True),  # ragged S
            (1, 2048, 8, 4, 128, torch.bfloat16, True),
            (2, 130, 8, 4, 64, torch.bfloat16, True),
            (2, 17, 4, 2, 32, torch.bfloat16, False),
            (1, 200, 4, 4, 16, torch.bfloat16, True),
            (2, 384, 8, 2, 64, torch.float32, True),
            # the training path's call: S - 1 = 1023 after the shift
            (TRAIN_BATCH, TRAIN_SEQ - 1, 16, 8, 128, torch.bfloat16, True)):
        for with_dlse in (False, True):
            ok, err, need, limit, routes = bwd_against_plain(
                torch, gen, *qkv(B, S, H, Hkv, hd, dtype), causal, with_dlse)
            # the lse variant's do is fp32: the CUDA-core route
            want = ("wgmma" if dtype == torch.bfloat16 and not with_dlse
                    else "simt")
            check(ok and routes == (want, want),
                  f"flash bwd {str(dtype)[6:]} B{B} S{S} H{H}/{Hkv} hd{hd} "
                  f"causal={causal} dlse={'rand' if with_dlse else 0} "
                  f"[{'/'.join(routes)}]: dq/dk/dv |g-ref| max {err:.2e} <= "
                  f"{limit} (passes down to {need:.1e} max|ref|)")

    a = torch.randn(512, 512, device="cuda", generator=gen).bfloat16()
    b = torch.randn(512, 512, device="cuda", generator=gen).bfloat16()
    before = dict(instrumented_matmul_cuda.launches_by_route)
    out, raw = instrumented_matmul_cuda(a, b, 256, 256, 256)
    route = route_taken(instrumented_matmul_cuda, before)
    ref, ref_raw = instrumented_matmul_plain(a, b, 256, 256, 256)
    st = scale_stats(raw, 256, 256, 256)
    err = rel_err(out, ref)
    check(raw.tolist() == ref_raw.tolist() and st.mxu_tiles == 8
          and st.flops == 8 * 2 * 256 ** 3 and err < 1e-3
          and route == "wgmma",
          f"matmul bf16 512^3 [{route}]: stats {raw.tolist()} "
          f"== plain {ref_raw.tolist()}, mxu_tiles 8, rel err {err:.2e} "
          f"< 1e-3")
    # K = 12: rows of 24 bytes, which TMA cannot address
    a = torch.randn(64, 12, device="cuda", generator=gen).bfloat16()
    a[:4, :4] = 0
    b = torch.randn(12, 64, device="cuda", generator=gen).bfloat16()
    before = dict(instrumented_matmul_cuda.launches_by_route)
    out, raw = instrumented_matmul_cuda(a, b, 4, 4, 4)
    route = route_taken(instrumented_matmul_cuda, before)
    ref, ref_raw = instrumented_matmul_plain(a, b, 4, 4, 4)
    err = rel_err(out, ref)
    check(raw.tolist() == ref_raw.tolist() and err < 1e-3
          and route == "simt",
          f"matmul bf16 64x12x64 blocks 4 [{route}]: stats "
          f"{raw.tolist()} == plain {ref_raw.tolist()}, rel err {err:.2e} "
          f"< 1e-3")
    a, b = mm_operands(torch, gen)
    before = dict(instrumented_matmul_cuda.launches_by_route)
    out, raw = instrumented_matmul_cuda(a, b, MM_BLOCK, MM_BLOCK, MM_BLOCK)
    route = route_taken(instrumented_matmul_cuda, before)
    ref, ref_raw = instrumented_matmul_plain(a, b, MM_BLOCK, MM_BLOCK,
                                             MM_BLOCK)
    err = rel_err(out, ref)
    check(raw.tolist() == ref_raw.tolist() and raw.tolist()[1] > 0
          and err < 1e-3 and route == "wgmma",
          f"matmul bf16 4096^3 with planted zero tiles [{route}]: stats "
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


def serving_tenant(torch, gen, cfg, params):
    """The KV-cache serving tenant: (step_fn, state), answering
    SERVE_BATCH prompts of SERVE_PROMPT tokens with SERVE_NEW greedy
    tokens a batch."""
    from pbs_tpu_torch.models import make_serve_step

    prompts = torch.randint(0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT),
                            device="cuda", generator=gen)
    serve_step = make_serve_step(cfg, max_new_tokens=SERVE_NEW)

    def serve_fn(state):
        return serve_step(state, prompts)

    return serve_fn, (params, torch.Generator(device="cuda").manual_seed(1), 0)


def check_served(job, counters) -> None:
    tokens = int(job.contexts[0].counters[counters.TOKENS])
    check(job.state[2] == STEPS["serve"]
          and tokens == STEPS["serve"] * SERVE_BATCH * SERVE_NEW,
          f"serve: {job.state[2]} batches answered, {tokens} "
          f"tokens == {STEPS['serve']} x {SERVE_BATCH} x {SERVE_NEW}")


def print_tenants(jobs, counters) -> None:
    print(f"  {'tenant':<6} {'steps':>5} {'device_ms':>10} "
          f"{'stall_rate':>10} {'tslice_us':>9} {'sched':>5} {'yields':>6}")
    for name, job in jobs.items():
        ctx = job.contexts[0]
        print(f"  {name:<6} {job.steps_retired():>5} "
              f"{int(ctx.counters[counters.DEVICE_TIME_NS]) / 1e6:>10.2f} "
              f"{job.stall_rate:>10.1f} {job.params.tslice_us:>9} "
              f"{ctx.sched_count:>5} "
              f"{int(ctx.counters[counters.YIELDS]):>6}", flush=True)


def scoring_tenant(torch, gen, cfg, params):
    """The forward-scoring tenant: (SCORE_BATCH, SCORE_SEQ) tokens
    through the flash kernel; its answer is the next-token predictions."""
    from pbs_tpu_torch.models import forward

    score_tokens = torch.randint(0, cfg.vocab, (SCORE_BATCH, SCORE_SEQ),
                                 device="cuda", generator=gen)
    score_cfg = dataclasses.replace(cfg, attn_impl="pallas")

    @torch.no_grad()
    def score_fn(state):
        logits = forward(score_cfg, params, score_tokens)
        # the (B,) next-token predictions are the tenant's answer
        return logits[:, -1].argmax(dim=-1), {"tokens": score_tokens.numel()}

    return score_fn


def mm_tenant(torch, gen):
    """The instrumented-matmul tenant on MM_N^3 bf16 with planted zero
    tiles: its in-kernel counters are its FLOP and byte metrics."""
    from pbs_tpu_torch.ops.matmul import instrumented_matmul, scale_stats

    a, b = mm_operands(torch, gen)

    def mm_fn(state):
        out, raw = instrumented_matmul(a, b, MM_BLOCK, MM_BLOCK, MM_BLOCK)
        return out, scale_stats(raw, MM_BLOCK, MM_BLOCK, MM_BLOCK).metrics()

    return mm_fn


def run_main_path(torch, gen, cfg, params):
    from pbs_tpu_torch.ops.attention import flash_attention_cuda
    from pbs_tpu_torch.ops.matmul import instrumented_matmul_cuda
    from pbs_tpu_torch.runtime import Job, Partition, SchedParams
    from pbs_tpu_torch.sched import FeedbackPolicy
    from pbs_tpu_torch.telemetry import Counter, CudaBackend

    serve_fn, serve_state = serving_tenant(torch, gen, cfg, params)
    score_fn = scoring_tenant(torch, gen, cfg, params)
    mm_fn = mm_tenant(torch, gen)

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
    wrappers = {"flash_fwd": flash_attention_cuda,
                "instrumented_matmul": instrumented_matmul_cuda}
    reset_counts(wrappers.values())
    t0 = time.monotonic()
    quanta = part.run()
    wall = time.monotonic() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    routes = {k: dict(w.launches_by_route) for k, w in wrappers.items()}
    print(f"  {quanta} quanta in {wall:.2f} s wall; kernel launches "
          f"{launches}, by route {routes}", flush=True)
    print_tenants(jobs, Counter)
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
    check_served(jobs["serve"], Counter)
    pred = jobs["score"].state
    check(pred.shape == (SCORE_BATCH,) and bool(((pred >= 0)
                                                 & (pred < cfg.vocab)).all()),
          f"score: next-token predictions {pred.tolist()} in [0, vocab)")
    for name, n in launches.items():
        check(n > 0, f"{name}: {n} launches on the main path")
        check(routes[name] == {"wgmma": n, "simt": 0},
              f"{name}: every launch on the tensor-core route "
              f"({routes[name]})")
    serve_ctx = jobs["serve"].contexts[0]
    serve_ms_per_token = (int(serve_ctx.counters[Counter.DEVICE_TIME_NS])
                          / 1e6 / int(serve_ctx.counters[Counter.TOKENS]))
    return launches, routes, serve_ms_per_token


# -- phase 3t ----------------------------------------------------------------


def train_config(torch):
    """The flagship's training configuration (``__graft_entry__``'s
    ``_flagship_cfg()``: bf16 compute, fp32 master params, remat "dots"),
    attending through the flash kernels."""
    from pbs_tpu_torch.models import TransformerConfig

    return TransformerConfig(**FLAGSHIP, dtype=torch.bfloat16, remat=True,
                             remat_policy="dots", attn_impl="pallas")


def bwd_counts():
    from pbs_tpu_torch.ops.attention import (flash_attention_bwd_dkv_cuda,
                                             flash_attention_bwd_dq_cuda,
                                             flash_attention_cuda)
    from pbs_tpu_torch.ops.matmul import instrumented_matmul_cuda

    return (flash_attention_cuda, flash_attention_bwd_dq_cuda,
            flash_attention_bwd_dkv_cuda, instrumented_matmul_cuda)


def reset_counts(wrappers) -> None:
    """Set every launch count of the wrappers to 0, per route too where
    a wrapper has routes."""
    from pbs_tpu_torch.ops.cuda_build import new_route_counts

    for w in wrappers:
        w.launches = 0
        if hasattr(w, "launches_by_route"):
            w.launches_by_route = new_route_counts()


def training_tenant(torch, gen, n_steps: int) -> dict:
    """The flagship training tenant: fresh fp32 master params, a loader
    of n_steps x TRAIN_MICRO seeded micro-batches (and one spare the run
    never sees, for warm-up), the micro-step and the Job's micro-step
    function, which records each micro-batch's loss."""
    from pbs_tpu_torch.models import init_params, make_micro_train_step

    cfg = train_config(torch)
    params = init_params(cfg, gen, device="cuda")  # fp32 master params
    batches = torch.randint(0, cfg.vocab,
                            (n_steps * TRAIN_MICRO + 1, TRAIN_BATCH,
                             TRAIN_SEQ), device="cuda", generator=gen)
    cursor = [0]

    def next_batch(micro: int):
        # a loader: micro-batch after micro-batch of a seeded stream
        i = cursor[0]
        cursor[0] += 1
        return batches[i]

    init_state, micro_step = make_micro_train_step(
        cfg, n_micro=TRAIN_MICRO, learning_rate=TRAIN_LR,
        next_batch=next_batch)
    losses = []

    def train_fn(state):
        state, metrics = micro_step(state)
        losses.append(metrics["loss"])
        return state, metrics

    return dict(cfg=cfg, params=params, spare=batches[-1],
                init_state=init_state, micro_step=micro_step,
                train_fn=train_fn, losses=losses)


def run_train_path(torch, gen, serve_cfg, serve_params):
    """The micro-stepped training tenant beside the serving tenant.
    Returns (launch counts of this run, the flash kernels' launches by
    route, the training config, the trained params, the micro_step
    function and its final state)."""
    from pbs_tpu_torch.models.transformer import loss_and_grads
    from pbs_tpu_torch.runtime import Job, Partition, SchedParams
    from pbs_tpu_torch.sched import FeedbackPolicy
    from pbs_tpu_torch.telemetry import Counter, CudaBackend

    tenant = training_tenant(torch, gen, TRAIN_STEPS)
    cfg, params = tenant["cfg"], tenant["params"]
    init_state, micro_step = tenant["init_state"], tenant["micro_step"]
    train_fn, losses = tenant["train_fn"], tenant["losses"]
    n_micro_total = TRAIN_STEPS * TRAIN_MICRO

    serve_fn, serve_state = serving_tenant(torch, gen, serve_cfg,
                                           serve_params)
    # Warm up outside the partition: one loss/gradient pass on a batch
    # the run never sees (cuBLAS handles, the caching allocator), and one
    # serving batch.
    loss_and_grads(cfg, params, tenant["spare"])
    serve_fn(serve_state)
    torch.cuda.synchronize()
    watch = {"embed": params["embed"][:8].clone(),
             "wq": params["layers"]["wq"][0, :8].clone(),
             "head": params["head"][:, :8].clone()}

    be = CudaBackend()
    part = Partition("train", source=be)
    fb = FeedbackPolicy(part)
    jobs = {
        "train": Job("train", micro_step_fn=train_fn,
                     micro_per_step=TRAIN_MICRO, state=init_state(params),
                     params=SchedParams(weight=512, tslice_us=100),
                     max_steps=TRAIN_STEPS),
        "serve": Job("serve", step_fn=serve_fn, state=serve_state,
                     params=SchedParams(weight=256, tslice_us=100,
                                        boost_on_wake=True),
                     max_steps=STEPS["serve"]),
    }
    for job in jobs.values():
        part.add_job(job)
    wrappers = bwd_counts()
    reset_counts(wrappers)
    t0 = time.monotonic()
    quanta = part.run()
    wall = time.monotonic() - t0
    launches = dict(zip(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                         "instrumented_matmul"),
                        (w.launches for w in wrappers)))
    routes = dict(zip(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
                      (dict(w.launches_by_route) for w in wrappers[:3])))
    print(f"  {quanta} quanta in {wall:.2f} s wall; kernel launches "
          f"{launches}; by route {routes}", flush=True)
    print_tenants(jobs, Counter)
    print(f"  feedback: {json.dumps(fb.dump())}")
    loss_vals = [float(x) for x in losses]
    print(f"  micro-step losses {[round(x, 4) for x in loss_vals]}")

    train, ctx = jobs["train"], jobs["train"].contexts[0]
    for name, job in jobs.items():
        check(job.error is None and job.steps_retired() == job.max_steps,
              f"{name}: {job.steps_retired()} steps retired, no fault "
              f"({job.error})")
        snap = part.ledger.snapshot(job.contexts[0].ledger_slot)
        check(snap.tolist() == job.contexts[0].counters.tolist(),
              f"{name}: ledger snapshot equals the context counters")
    check(train.state["step"] == TRAIN_STEPS and train.state["micro"] == 0
          and ctx.micro_progress == 0,
          f"train: {train.state['step']} optimizer steps, micro cursor "
          f"{train.state['micro']}, progress {ctx.micro_progress}")
    tokens = int(ctx.counters[Counter.TOKENS])
    want = TRAIN_STEPS * TRAIN_MICRO * TRAIN_BATCH * (TRAIN_SEQ - 1)
    check(tokens == want, f"train: ledger TOKENS {tokens} == {TRAIN_STEPS} "
                          f"x {TRAIN_MICRO} x {TRAIN_BATCH} x "
                          f"{TRAIN_SEQ - 1}")
    yields = int(ctx.counters[Counter.YIELDS])
    check(yields > 0, f"train: {yields} yields, cut at chunk boundaries")
    check(len(loss_vals) == n_micro_total
          and all(math.isfinite(x) for x in loss_vals),
          f"train: {len(loss_vals)} micro-step losses, all finite")
    moved = {
        "embed": max_abs(params["embed"][:8], watch["embed"]),
        "wq": max_abs(params["layers"]["wq"][0, :8], watch["wq"]),
        "head": max_abs(params["head"][:, :8], watch["head"]),
    }
    check(all(x > 0 for x in moved.values()),
          f"train: params moved (max |delta| {moved})")
    check_served(jobs["serve"], Counter)
    per_step = cfg.n_layers * n_micro_total
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        check(launches[name] == per_step,
              f"{name}: {launches[name]} launches == {cfg.n_layers} layers "
              f"x {n_micro_total} micro-steps")
    check(launches["flash_fwd"] == 2 * per_step,
          f"flash_fwd: {launches['flash_fwd']} launches == 2 x "
          f"{per_step}: each layer's forward, and its recompute in the "
          f"backward under remat")
    for name, r in routes.items():
        check(r == {"wgmma": launches[name], "simt": 0},
              f"{name}: every launch on the tensor-core route ({r})")
    ms = int(ctx.counters[Counter.DEVICE_TIME_NS]) / 1e6 / n_micro_total
    print(f"  train: {ms:.2f} ms per micro-step (ledger device time / "
          f"{n_micro_total})", flush=True)
    return launches, routes, cfg, params, micro_step, train.state


# -- phase 3m ----------------------------------------------------------------


def warm_profiler(torch) -> float:
    """One throwaway torch.profiler session with CUDA activity: CUPTI's
    first start can take seconds, which would otherwise land in the
    first sampled quantum's device time. Returns its wall seconds."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.monotonic()
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.ones(1 << 20, device="cuda").mul_(2)
        torch.cuda.synchronize()
    return time.monotonic() - t0


def roofline_frac(be, metrics: dict) -> float:
    """The stall fraction the backend itself charges a step with these
    counted FLOPs and bytes before its first sample: one second charged
    with no measured sample, read back from HBM_STALL_NS."""
    import numpy as np

    from pbs_tpu_torch.telemetry.counters import NUM_COUNTERS, Counter

    deltas = np.zeros(NUM_COUNTERS, dtype=np.uint64)
    be._charge(deltas, 10 ** 9, 0, 0, metrics, measured=None)
    return int(deltas[Counter.HBM_STALL_NS]) / 10 ** 9


def run_measured_path(torch, gen, cfg, params, built) -> tuple:
    """serve, score, mm and the micro-stepped training Job in one
    Partition under FeedbackPolicy, with CudaBackend sampling every
    MEASURED_PROFILE_EVERY-th invocation of each tenant through
    torch.profiler, a CompileAdmission that admits all four, and an
    overflow sample armed on serve's TOKENS. Returns (launch counts of
    this run, launches by route)."""
    from pbs_tpu_torch.models.transformer import loss_and_grads
    from pbs_tpu_torch.runtime import (CompileAdmission, CompileBudget, Job,
                                       Partition, SchedParams, Virq)
    from pbs_tpu_torch.sched import FeedbackPolicy
    from pbs_tpu_torch.telemetry import CompileMeter, Counter, CudaBackend

    meter = CompileMeter.install()
    n_built = sum(1 for r in built.values() if r.seconds > 0)
    ambient = meter.peek_all().get("<ambient>", (0, 0))
    print(f"  compile meter: {meter.total_compiles} nvcc runs, "
          f"{meter.total_compile_ns / 1e9:.1f} s (mean "
          f"{meter.mean_compile_ns / 1e9:.1f} s), unattributed "
          f"{ambient}; phase 1 built {n_built} sources", flush=True)
    check(meter.total_compiles == n_built and ambient[0] == n_built,
          f"phase 1's build went through the CompileMeter: "
          f"{meter.total_compiles} compiles == {n_built} sources nvcc "
          f"built in this run, all unattributed")

    serve_fn, serve_state = serving_tenant(torch, gen, cfg, params)
    score_fn = scoring_tenant(torch, gen, cfg, params)
    mm_fn = mm_tenant(torch, gen)
    tenant = training_tenant(torch, gen, MEASURED_TRAIN_STEPS)
    # Warm every tenant outside the partition, then CUPTI.
    for fn, st in ((serve_fn, serve_state), (score_fn, None), (mm_fn, None)):
        fn(st)
    loss_and_grads(tenant["cfg"], tenant["params"], tenant["spare"])
    torch.cuda.synchronize()
    print(f"  profiler warm-up session: {warm_profiler(torch):.2f} s",
          flush=True)

    be = CudaBackend(profile_every=MEASURED_PROFILE_EVERY)
    gate = CompileAdmission(CompileBudget(
        max_programs=4, budget_ns=MEASURED_COMPILE_BUDGET_NS))
    part = Partition("measured", source=be, compile_admission=gate)
    fb = FeedbackPolicy(part)

    def params_(weight):
        return SchedParams(weight=weight, tslice_us=MEASURED_TSLICE_US)

    jobs = {
        "serve": Job("serve", step_fn=serve_fn, state=serve_state,
                     params=params_(256),
                     max_steps=MEASURED_STEPS["serve"]),
        "score": Job("score", step_fn=score_fn, params=params_(256),
                     max_steps=MEASURED_STEPS["score"]),
        "mm": Job("mm", step_fn=mm_fn, params=params_(512),
                  max_steps=MEASURED_STEPS["mm"]),
        "train": Job("train", micro_step_fn=tenant["train_fn"],
                     micro_per_step=TRAIN_MICRO,
                     state=tenant["init_state"](tenant["params"]),
                     params=params_(512), max_steps=MEASURED_TRAIN_STEPS),
    }
    for job in jobs.values():
        part.add_job(job)
    print(f"  compile admission: {json.dumps(gate.dump())}")
    period = SERVE_BATCH * SERVE_NEW  # one served batch of tokens
    serve_ctx = jobs["serve"].contexts[0]
    sid = part.sampler.arm(serve_ctx, Counter.TOKENS, period=period)
    virqs = []
    part.events.bind_virq(Virq.TELEMETRY, virqs.append)

    wrappers = bwd_counts()
    reset_counts(wrappers)
    t0 = time.monotonic()
    quanta = part.run()
    wall = time.monotonic() - t0
    names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
             "instrumented_matmul")
    launches = dict(zip(names, (w.launches for w in wrappers)))
    routes = dict(zip(names, (dict(w.launches_by_route) for w in wrappers)))
    part.events.deliver_pending()
    print(f"  profile_every={MEASURED_PROFILE_EVERY}: {quanta} quanta in "
          f"{wall:.2f} s wall; {be.profiler.samples} samples, "
          f"{be.profiler.failures} failures ({be.profiler.last_error}); "
          f"kernel launches {launches}; by route {routes}", flush=True)
    print_tenants(jobs, Counter)
    print(f"  feedback: {json.dumps(fb.dump())}")

    roof_mm = roofline_frac(be, mm_fn(None)[1])
    # Charged device ms of a sampled and an unsampled invocation, and
    # the profiler's own ms per sample (kept out of the charge).
    print(f"  {'tenant':<6} {'stall':>6} {'compute':>7} {'coll':>5} "
          f"{'roofline':>8} {'ops':>5} {'busy_ms':>8} {'sampled_ms':>10} "
          f"{'unsampled_ms':>12} {'profiler_ms':>11}  top ops")
    for name, job in jobs.items():
        m = be.measured(name)
        if m is None:
            print(f"  {name:<6} no sample")
            continue
        busy = m.compute_ns + m.memory_ns + m.collective_ns
        # only mm counts FLOPs and bytes: the others have no estimate
        roof = f"{roof_mm:.3f}" if name == "mm" else "none"
        n_s, s_ns, p_ns = be.profile_cost.get(name, (0, 0, 0))
        n_u = job.max_steps * job.micro_per_step - n_s
        u_ns = int(job.contexts[0].counters[Counter.DEVICE_TIME_NS]) - s_ns
        top = "; ".join(f"{k[:48]} {v / 1e6:.3f} ms" for k, v in m.top_ops[:3])
        print(f"  {name:<6} {m.stall_frac:>6.3f} "
              f"{m.compute_ns / busy if busy else 0.0:>7.3f} "
              f"{m.collective_frac:>5.3f} {roof:>8} {m.n_ops:>5} "
              f"{m.device_time_ns / 1e6:>8.3f} "
              f"{s_ns / n_s / 1e6 if n_s else 0.0:>10.2f} "
              f"{u_ns / n_u / 1e6 if n_u else 0.0:>12.2f} "
              f"{p_ns / n_s / 1e6 if n_s else 0.0:>11.2f}  {top}", flush=True)

    for name, job in jobs.items():
        check(job.error is None and job.steps_retired() == job.max_steps,
              f"{name}: {job.steps_retired()} steps retired, no fault "
              f"({job.error})")
    check(be.profiler.failures == 0 and be.profiler.samples >= len(jobs),
          f"profiler: {be.profiler.samples} samples >= one per job, "
          f"{be.profiler.failures} failures")
    measured = {name: be.measured(name) for name in jobs}
    for name, m in measured.items():
        check(m is not None and m.source == "device" and m.n_ops > 0,
              f"{name}: measured from the device lane "
              f"({m.source if m else None}, {m.n_ops if m else 0} ops)")
    check(measured["train"].stall_frac > measured["mm"].stall_frac,
          f"measured stall: train {measured['train'].stall_frac:.3f} > mm "
          f"{measured['mm'].stall_frac:.3f}")
    check(measured["mm"].stall_frac < roof_mm,
          f"mm: measured stall {measured['mm'].stall_frac:.3f} < its "
          f"roofline estimate {roof_mm:.3f}")
    events = part.sampler.drain()
    before = part.sampler.dump()[0]
    tokens = int(serve_ctx.counters[Counter.TOKENS])
    check(len(events) == 1 and events[0].seq == 1
          and events[0].threshold == period and events[0].value >= period
          and virqs == [int(Virq.TELEMETRY)] and not before["armed"]
          and before["fired"] == 1 and tokens >= 2 * period,
          f"serve TOKENS overflow at {period}: fired once "
          f"({[(e.value, e.seq) for e in events]}, virqs {virqs}) and "
          f"stayed disarmed to {tokens} tokens")
    part.sampler.rearm(sid)
    after = part.sampler.dump()[0]
    check(after["armed"] and after["threshold"] == tokens + period,
          f"serve TOKENS sample rearmed at {after['threshold']}")
    for name, job in jobs.items():
        ctx = job.contexts[0]
        n_c = int(ctx.counters[Counter.COMPILES])
        check(n_c == 0 and int(ctx.counters[Counter.COMPILE_TIME_NS]) == 0,
              f"{name}: ledger COMPILES {n_c}, phase 1 built everything")
        snap = part.ledger.snapshot(ctx.ledger_slot)
        check(snap.tolist() == ctx.counters.tolist(),
              f"{name}: ledger snapshot equals the context counters")
    for name, n in launches.items():
        check(n > 0 and routes[name] == {"wgmma": n, "simt": 0},
              f"{name}: {n} launches, every one on the tensor-core route "
              f"({routes[name]})")
    losses = [float(x) for x in tenant["losses"]]
    check(len(losses) == MEASURED_TRAIN_STEPS * TRAIN_MICRO
          and all(math.isfinite(x) for x in losses),
          f"train: {len(losses)} micro-step losses, all finite")
    return launches, routes


# -- phase 3s ----------------------------------------------------------------


def engine_script():
    """The seeded request script: (prompt, max_new) pairs and, for each
    tick, the indices arriving then (ENGINE_FIRST at tick 0, then
    ENGINE_PER_TICK a tick); the last ENGINE_REPEATS prompts repeat the
    first ones exactly."""
    import numpy as np

    rng = np.random.default_rng(ENGINE_SEED)
    reqs = []
    for i in range(ENGINE_REQUESTS):
        plen = int(rng.integers(ENGINE_PROMPT[0], ENGINE_PROMPT[1] + 1))
        prompt = rng.integers(0, FLAGSHIP["vocab"], plen).astype(np.int32)
        reqs.append((prompt, int(rng.integers(ENGINE_NEW[0],
                                              ENGINE_NEW[1] + 1))))
    n_new = ENGINE_REQUESTS - ENGINE_REPEATS
    for i in range(ENGINE_REPEATS):
        reqs[n_new + i] = (reqs[i][0].copy(), reqs[n_new + i][1])
    arrivals = {0: list(range(ENGINE_FIRST))}
    for i in range(ENGINE_FIRST, ENGINE_REQUESTS):
        tick = 1 + (i - ENGINE_FIRST) // ENGINE_PER_TICK
        arrivals.setdefault(tick, []).append(i)
    return reqs, arrivals


def engine_ticks(budgets: list, arrivals: dict, n_slots: int) -> int:
    """Ticks a continuous-batching engine needs to finish these requests
    (no EOS): each tick admits queued requests into free slots in slot
    order (the prefill samples a request's first token), retires what is
    already done, then decodes one token for every busy slot; a request
    retires in the tick that samples its last token."""
    from collections import deque

    queue, busy, left = deque(), [False] * n_slots, [0] * n_slots
    done = tick = 0
    while done < len(budgets):
        queue.extend(arrivals.get(tick, []))
        for s in range(n_slots):
            if not busy[s] and queue:
                busy[s], left[s] = True, budgets[queue.popleft()] - 1
        for s in range(n_slots):
            if busy[s] and not left[s]:
                busy[s], done = False, done + 1
        for s in range(n_slots):
            if busy[s]:
                left[s] -= 1
                if not left[s]:
                    busy[s], done = False, done + 1
        tick += 1
    return tick


def drive_engine(torch, eng, reqs, arrivals) -> dict:
    """Feed the script to an engine tick by tick until it drains. Returns
    completions by request index, each tick's host ms (the tick ends in
    the read of its sampled tokens, a device synchronise) with its
    number of admissions, and the wall seconds."""
    rid_of, done, ticks = {}, {}, []
    t0 = time.monotonic()
    tick = 0
    while tick <= max(arrivals) or eng.has_work():
        for i in arrivals.get(tick, []):
            rid_of[eng.submit(*reqs[i])] = i
        t = time.monotonic()
        for c in eng.step():
            done[rid_of[c.request_id]] = c
        ticks.append(((time.monotonic() - t) * 1e3, len(eng._admitted)))
        tick += 1
    return dict(done=done, ticks=ticks, wall=time.monotonic() - t0)


def decode_tick_ms(ticks) -> float:
    """Median host ms of the ticks that admitted nothing."""
    return statistics.median(ms for ms, admitted in ticks if not admitted)


def engine_line(name, eng, wall, tick_ms, prefill_ms, lockstep_ms, card,
                extra="") -> str:
    """One engine's numbers: ``stats()``'s TTFT and latency percentiles,
    the median decode tick, a prefill, tokens/s over the run's wall time
    and, beside them, the lockstep serve tenant's ms per token (phase
    3's ledger), then the card."""
    st = eng.stats()
    tok_s = st["tokens_emitted"] / wall
    return (f"  {name}: completed {st['completed']}, prefix hits "
            f"{st['prefix_hits']}; TTFT p50 {st['ttft_p50_s'] * 1e3:.2f} / "
            f"p99 {st['ttft_p99_s'] * 1e3:.2f} ms, latency p50 "
            f"{st['latency_p50_s'] * 1e3:.2f} / p99 "
            f"{st['latency_p99_s'] * 1e3:.2f} ms (host clock); decode tick "
            f"{tick_ms:.2f} ms (median), prefill {prefill_ms:.2f} ms; "
            f"{tok_s:.1f} tok/s ({1e3 / tok_s:.3f} ms per token) over "
            f"{st['steps']} ticks, {wall:.2f} s{extra}; lockstep serve "
            f"tenant (phase 3) {lockstep_ms:.3f} ms per token [{card}]")


def profile_ticks(torch, eng, n: int, card: str) -> None:
    """``n`` decode ticks of a busy engine under torch.profiler: host ms
    per tick, device busy ms and kernels per tick, the device's idle
    share, the top kernels. A measurement, not a check."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    busy_slots = int(eng.active.sum())
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(n):
            eng.step()
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    dev = [e for e in prof.key_averages()
           if getattr(e, "device_type", None) == DeviceType.CUDA]
    busy = sum(device_self_us(e) for e in dev)
    if busy <= 0:
        print("  profiled decode ticks: no device time recorded; not "
              "measured", flush=True)
        return
    kernels = sum(e.count for e in dev)
    print(f"  profiled decode ticks ({n}, {busy_slots} slots busy): "
          f"{wall_us / n / 1e3:.2f} ms per tick (profiler on), "
          f"{busy / n / 1e3:.3f} ms device busy, {kernels / n:.0f} kernels "
          f"per tick, idle share {1 - busy / wall_us:.3f} [{card}]",
          flush=True)
    for e in sorted(dev, key=device_self_us, reverse=True)[:5]:
        print(f"    {device_self_us(e) / n / 1e3:8.3f} ms/tick  "
              f"x{e.count // n:<4} {e.key[:90]}")


def time_prefill(torch, eng, prompt) -> float:
    """Median host ms of three prefills of ``prompt`` into slot 0 of an
    idle engine (each ends in the read of its first token); the slot is
    left free."""
    import numpy as np

    padded = np.zeros(eng.bucket, np.int32)
    padded[:len(prompt)] = prompt
    out = []
    for _ in range(3):
        t = time.monotonic()
        int(eng._prefill(0, padded, len(prompt))[0])
        out.append((time.monotonic() - t) * 1e3)
    eng.cache["pos"][0] = 0
    return statistics.median(out)


def lockstep_margin(torch, cfg, params, prompt, toks, j) -> float:
    """The lockstep run's top-2 fp32 logit gap at output position j, over
    the larger logit's magnitude: a B=1 prefill, then decodes of its
    tokens[:j], as ``make_generate`` computes them."""
    from pbs_tpu_torch.models import forward_with_cache, init_cache

    cache = init_cache(cfg, 1, max_len=len(prompt) + j + 1, device="cuda")
    with torch.no_grad():
        logits, cache = forward_with_cache(
            cfg, params, torch.tensor(prompt[None], device="cuda"), cache)
        for t in toks[:j]:
            logits, cache = forward_with_cache(
                cfg, params, torch.tensor([[t]], device="cuda"), cache)
    top = logits[0, -1].topk(2).values
    return float(top[0] - top[1]) / float(top[0].abs())


def compare_tokens(torch, cfg, params, reqs, got: dict, want: dict,
                   what: str) -> list:
    """Request by request, ``got`` against ``want`` (token lists). A
    divergence passes only where the lockstep run's top-2 logits at
    that position are within ENGINE_TIE of each other (a tie two GEMM
    shapes may break differently); it is printed either way. Returns
    the divergences as (request, position, margin)."""
    ties = []
    for i, w in want.items():
        g = got[i]
        j = next((n for n, (a, b) in enumerate(zip(g, w)) if a != b), None)
        if j is None:
            check(len(g) == len(w), f"{what}: request {i} has {len(g)} "
                                    f"tokens == {len(w)}")
            continue
        margin = lockstep_margin(torch, cfg, params, reqs[i][0], w, j)
        print(f"  {what}: request {i} diverges at token {j} ({g[j]} vs "
              f"{w[j]}); lockstep top-2 gap {margin:.3e} of |top-1|",
              flush=True)
        check(margin < ENGINE_TIE, f"{what}: request {i}'s divergence is a "
                                   f"near-tie (gap {margin:.3e} < "
                                   f"{ENGINE_TIE:g})")
        ties.append((i, j, margin))
    return ties


def run_engine_path(torch, gen, cfg, params, serve_ms_per_token, card):
    """Phase 3s: (a) the bf16 engine as a tenant beside score and mm,
    (b) an fp32 engine token-exact against the lockstep generate, (c) the
    speculative engine against (b), (d) int8 weight-only serving.
    Returns the launch counts and routes of (a)'s run."""
    from pbs_tpu_torch.models import (ContinuousBatcher, SpeculativeBatcher,
                                      TransformerConfig, cast_params,
                                      init_params, make_continuous_serve_step,
                                      make_generate, prefill,
                                      quantize_weights, quantized_nbytes)
    import numpy as np

    from pbs_tpu_torch.models.generate import init_cache
    from pbs_tpu_torch.runtime import Job, Partition, SchedParams, nbytes_of
    from pbs_tpu_torch.sched import FeedbackPolicy
    from pbs_tpu_torch.telemetry import Counter, CudaBackend

    t_phase = time.monotonic()
    reqs, arrivals = engine_script()
    budgets = [n for _, n in reqs]
    n_ticks = engine_ticks(budgets, arrivals, ENGINE_SLOTS)
    print(f"  script: {len(reqs)} requests, prompts "
          f"{min(len(p) for p, _ in reqs)}-{max(len(p) for p, _ in reqs)} "
          f"tokens, budgets {min(budgets)}-{max(budgets)} ({sum(budgets)} "
          f"tokens), {ENGINE_FIRST} at tick 0 then {ENGINE_PER_TICK} a tick; "
          f"{n_ticks} ticks with {ENGINE_SLOTS} slots", flush=True)
    kw = dict(n_slots=ENGINE_SLOTS, prompt_bucket=ENGINE_BUCKET,
              max_len=ENGINE_MAX_LEN, prefix_cache_size=ENGINE_PREFIX)

    # (a) the bf16 engine as a scheduled tenant beside score and mm
    t0 = time.monotonic()
    eng = ContinuousBatcher(cfg, params, **kw)
    built_s = time.monotonic() - t0
    serve_step = make_continuous_serve_step(
        eng, next_requests=lambda t: [reqs[i] for i in arrivals.get(t, [])])
    ticks = []

    def engine_fn(state):
        t = time.monotonic()
        out = serve_step(state)
        ticks.append(((time.monotonic() - t) * 1e3, len(eng._admitted)))
        return out

    score_fn = scoring_tenant(torch, gen, cfg, params)
    mm_fn = mm_tenant(torch, gen)
    for fn in (score_fn, mm_fn):
        fn(None)
    torch.cuda.synchronize()
    part = Partition("engine", source=CudaBackend(profile_every=0))
    fb = FeedbackPolicy(part)
    jobs = {
        "engine": Job("engine", step_fn=engine_fn,
                      state={"step": 0, "completed": 0},
                      params=SchedParams(weight=256, tslice_us=100,
                                         boost_on_wake=True),
                      max_steps=n_ticks),
        "score": Job("score", step_fn=score_fn, params=SchedParams(weight=256),
                     max_steps=STEPS["score"]),
        "mm": Job("mm", step_fn=mm_fn, params=SchedParams(weight=512),
                  max_steps=STEPS["mm"]),
    }
    for job in jobs.values():
        part.add_job(job)
    wrappers = bwd_counts()
    reset_counts(wrappers)
    t0 = time.monotonic()
    quanta = part.run()
    wall = time.monotonic() - t0
    names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
             "instrumented_matmul")
    launches = dict(zip(names, (w.launches for w in wrappers)))
    routes = dict(zip(names, (dict(w.launches_by_route) for w in wrappers)))
    print(f"  (a) engine built (warm-up included) in {built_s:.2f} s; "
          f"{quanta} quanta in {wall:.2f} s wall; kernel launches "
          f"{launches}, by route {routes}", flush=True)
    print_tenants(jobs, Counter)
    print(f"  feedback: {json.dumps(fb.dump())}")
    for name, job in jobs.items():
        check(job.error is None and job.steps_retired() == job.max_steps,
              f"{name}: {job.steps_retired()} steps retired, no fault "
              f"({job.error})")
    st = eng.stats()
    ctx = jobs["engine"].contexts[0]
    tokens = int(ctx.counters[Counter.TOKENS])
    check(st["completed"] == len(reqs) == jobs["engine"].state["completed"]
          and not eng.has_work(),
          f"(a) engine: {st['completed']} of {len(reqs)} requests completed "
          f"in the {n_ticks} ticks the script needs")
    check(tokens == eng.tokens_emitted == sum(budgets),
          f"(a) engine: ledger TOKENS {tokens} == tokens_emitted "
          f"{eng.tokens_emitted} == the budgets' sum {sum(budgets)}")
    check(st["prefix_hits"] == ENGINE_REPEATS
          and eng.prefill_count == len(reqs) - ENGINE_REPEATS,
          f"(a) engine: prefix hits {st['prefix_hits']} == {ENGINE_REPEATS}, "
          f"prefill_count {eng.prefill_count} == "
          f"{len(reqs) - ENGINE_REPEATS}")
    for name in ("flash_fwd", "instrumented_matmul"):
        n = launches[name]
        check(n > 0 and routes[name] == {"wgmma": n, "simt": 0},
              f"{name}: {n} launches beside the engine, every one on the "
              f"tensor-core route ({routes[name]})")
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        check(launches[name] == 0,
              f"{name}: {launches[name]} launches beside the engine == 0 "
              f"(no training tenant in this run)")
    ms_eng = int(ctx.counters[Counter.DEVICE_TIME_NS]) / 1e6
    print(engine_line(
        "(a) bf16 engine (tenant)", eng, wall, decode_tick_ms(ticks),
        time_prefill(torch, eng, reqs[0][0]), serve_ms_per_token, card,
        f"; ledger {ms_eng / n_ticks:.2f} ms per tick, "
        f"{ms_eng / tokens:.3f} ms per token"), flush=True)
    # all 8 slots busy again (prefix hits, no prefill), then profiled
    for i in range(ENGINE_SLOTS):
        eng.submit(*reqs[i])
    eng.step()
    profile_ticks(torch, eng, ENGINE_PROFILED_TICKS, card)
    del eng
    print(f"  (a) wall {time.monotonic() - t_phase:.1f} s", flush=True)

    # (b) an fp32 engine, token-exact against the lockstep generate
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    master = init_params(cfg32, torch.Generator(device="cuda").manual_seed(
        ENGINE_SEED), device="cuda")
    first = {i: reqs[i] for i in range(ENGINE_FIRST)}
    first_arrivals = {0: list(first)}
    plain = ContinuousBatcher(cfg32, master, **kw)
    b = drive_engine(torch, plain, reqs, first_arrivals)
    b_toks = {i: c.tokens for i, c in b["done"].items()}
    check(sorted(b_toks) == list(first)
          and all(len(b_toks[i]) == reqs[i][1] for i in first),
          f"(b) fp32 engine: {len(b_toks)} requests, each with its budget")
    want = {}
    for i, (prompt, n) in first.items():
        out = make_generate(cfg32, n)(
            master, torch.tensor(prompt[None], device="cuda"))
        want[i] = out[0].tolist()
    ties = compare_tokens(torch, cfg32, master, reqs, b_toks, want,
                          "(b) fp32 engine vs lockstep make_generate (B=1)")
    print(f"  (b) fp32 engine token-exact against the lockstep generate on "
          f"{len(want) - len(ties)} of {len(want)} requests, the rest "
          f"near-ties {ties}", flush=True)
    print(engine_line("(b) fp32 engine", plain, b["wall"],
                      decode_tick_ms(b["ticks"]),
                      time_prefill(torch, plain, reqs[0][0]),
                      serve_ms_per_token, card),
          flush=True)
    b_steps = plain.stats()["steps"]
    del plain

    # (c) the speculative engine against (b)
    head = master["head"]
    noise = torch.randn(head.shape, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(ENGINE_SEED + 1))
    draft = dict(master, head=head + ENGINE_DRAFT_NOISE * head.std() * noise)
    spec = SpeculativeBatcher(cfg32, master, cfg32, draft, k=ENGINE_K, **kw)
    c = drive_engine(torch, spec, reqs, first_arrivals)
    c_toks = {i: r.tokens for i, r in c["done"].items()}
    check(sorted(c_toks) == list(first),
          f"(c) speculative engine: {len(c_toks)} requests completed")
    spec_ties = compare_tokens(torch, cfg32, master, reqs, c_toks, b_toks,
                               "(c) speculative vs (b)'s engine")
    sst = spec.stats()
    check(sst["steps"] < b_steps,
          f"(c) speculative engine: {sst['steps']} ticks < (b)'s {b_steps}")
    print(engine_line("(c) fp32 speculative engine, k=4", spec, c["wall"],
                      decode_tick_ms(c["ticks"]),
                      time_prefill(torch, spec, reqs[0][0]),
                      serve_ms_per_token, card,
                      f"; spec_acceptance {sst['spec_acceptance']} "
                      f"({sst['spec_accepted']} of {sst['spec_proposed']}); "
                      f"near-ties {spec_ties}"), flush=True)
    del spec, draft, noise

    # (d) int8 weight-only serving at bf16 compute
    q = quantize_weights(master)
    bf16 = cast_params(master, cfg.dtype)
    del master
    q_bytes, b_bytes = quantized_nbytes(q), nbytes_of(bf16)
    check(q_bytes < ENGINE_INT8_BYTES * b_bytes,
          f"(d) int8 tree {q_bytes / 2**30:.3f} GiB < {ENGINE_INT8_BYTES} x "
          f"the bf16 tree's {b_bytes / 2**30:.3f} GiB")
    prompt = torch.tensor(reqs[0][0][None], device="cuda")
    with torch.no_grad():
        l16, _ = prefill(cfg, bf16, prompt,
                         init_cache(cfg, 1, len(reqs[0][0]), device="cuda"))
        l8, _ = prefill(cfg, q, prompt,
                        init_cache(cfg, 1, len(reqs[0][0]), device="cuda"))
    err = float((l16 - l8).abs().max()) / float(l16.std())
    check(bool(torch.isfinite(l8).all()) and err < ENGINE_INT8_LOGITS,
          f"(d) first request's prefill logits: max|l_bf16 - l_int8| / "
          f"std(l_bf16) = {err:.4f} < {ENGINE_INT8_LOGITS}")
    del bf16
    eng8 = ContinuousBatcher(cfg, q, **kw)
    d = drive_engine(torch, eng8, reqs, arrivals)
    check(sorted(d["done"]) == list(range(len(reqs)))
          and all(len(d["done"][i].tokens) == reqs[i][1]
                  for i in d["done"]),
          f"(d) int8 engine: all {len(d['done'])} requests completed with "
          f"their budgets")
    # the engine's own int8 prefill (padded bucket, slot slab, embed_rows
    # and layer_params on {"q","s"} leaves) against the lockstep one
    padded = np.zeros(eng8.bucket, np.int32)
    padded[:len(reqs[0][0])] = reqs[0][0]
    with torch.no_grad():
        le = eng8._prefill(0, padded, len(reqs[0][0]))[1].float()
    eng8.cache["pos"][0] = 0
    l8_last = l8[0].float()  # prefill's logits are (B, vocab)
    err = float((le - l8_last).abs().max()) / float(l8_last.std())
    check(bool(torch.isfinite(le).all()) and err < ENGINE_INT8_PATHS,
          f"(d) int8 engine's prefill logits against the lockstep prefill's "
          f"on the same int8 tree: max|diff| / std = {err:.3e} < "
          f"{ENGINE_INT8_PATHS}")
    print(engine_line("(d) int8 weight-only engine, bf16 compute", eng8,
                      d["wall"], decode_tick_ms(d["ticks"]),
                      time_prefill(torch, eng8, reqs[0][0]),
                      serve_ms_per_token, card),
          flush=True)
    del eng8, q
    print(f"  phase 3s wall {time.monotonic() - t_phase:.1f} s [{card}]",
          flush=True)
    return launches, routes


def write_trace_fixture(torch, gen, path: str) -> None:
    """Profile one quantum of kernels 2.1-2.4 and a short tanh chain on
    the card and write its Chrome trace, trimmed to the device lane,
    its process names and a few host runtime calls, to ``path``."""
    import os
    import tempfile

    from pbs_tpu_torch.ops.attention import (flash_attention_bwd,
                                             flash_attention_cuda)
    from pbs_tpu_torch.ops.matmul import instrumented_matmul
    from pbs_tpu_torch.telemetry.profiler import (DEVICE_CATS,
                                                  TorchQuantumProfiler)

    a = torch.randn(512, 512, device="cuda", generator=gen).bfloat16()
    q, k, v = (torch.randn(1, 256, h, 128, device="cuda", generator=gen)
               .bfloat16() for h in (4, 2, 2))
    x = torch.randn(1 << 20, device="cuda", generator=gen)

    def quantum():
        instrumented_matmul(a, a, 256, 256, 256)
        o, lse = flash_attention_cuda(q, k, v, True)
        flash_attention_bwd(q, k, v, o, lse, o, None, True)
        y = x
        for _ in range(4):
            y = torch.tanh(y)
        torch.cuda.synchronize()

    with tempfile.TemporaryDirectory() as tmp:
        prof = TorchQuantumProfiler("cuda", keep_dir=tmp)
        _, stats = prof.profile(quantum)
        with open(os.path.join(tmp, "trace_0.json")) as f:
            doc = json.load(f)
    events = doc["traceEvents"]
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    pids = {e.get("pid") for e in device}
    runtime = [e for e in events if e.get("cat") == "cuda_runtime"][:6]
    pids |= {e.get("pid") for e in runtime}
    meta = [e for e in events if e.get("ph") == "M" and e.get("pid") in pids]
    out = {"schemaVersion": doc.get("schemaVersion"),
           "deviceProperties": doc.get("deviceProperties"),
           "traceEvents": meta + runtime + device}
    with open(path, "w") as f:
        json.dump(out, f, indent=0)
    print(f"  trace fixture: {len(device)} device events, "
          f"{os.path.getsize(path)} bytes -> {path}; stall "
          f"{stats.stall_frac:.3f}, top {stats.top_ops[:4]}", flush=True)


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


def named_leaves(tree, prefix=""):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from named_leaves(val, f"{prefix}{key}/")
        else:
            yield prefix + key, val


def check_train_numerics(torch, gen, cfg, params) -> None:
    """One micro-batch's loss and gradients through the flash kernels
    against the dense attention path, bf16 compute, same weights."""
    from pbs_tpu_torch.models.transformer import loss_and_grads

    tokens = torch.randint(0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ),
                           device="cuda", generator=gen)
    loss_f, g_f = loss_and_grads(cfg, params, tokens)
    loss_d, g_d = loss_and_grads(dataclasses.replace(cfg, attn_impl="xla"),
                                 params, tokens)
    loss_f, loss_d = float(loss_f), float(loss_d)
    rel_loss = abs(loss_f - loss_d) / abs(loss_d)
    check(math.isfinite(loss_f) and rel_loss < 1e-2,
          f"train loss, flash vs dense attention at width (bf16): "
          f"{loss_f:.5f} vs {loss_d:.5f}, rel {rel_loss:.2e} < 1e-2")
    dense = dict(named_leaves(g_d))
    rels = {}
    for name, g in named_leaves(g_f):
        d = dense[name]
        rels[name] = float(torch.linalg.vector_norm(g - d)
                           / torch.linalg.vector_norm(d))
    print(f"  |g_flash - g_dense| / |g_dense| per leaf: "
          f"{ {k: float(f'{v:.3e}') for k, v in rels.items()} }")
    worst = max(rels, key=rels.get)
    check(all(math.isfinite(v) and v < 0.05 for v in rels.values()),
          f"train gradients, flash vs dense: every leaf's relative norm "
          f"difference < 0.05 (largest {rels[worst]:.3e}, {worst})")


# -- phase 5 -----------------------------------------------------------------


def sdpa_pair(qt, kt, vt):
    """SDPA's forward on (B, H, S, hd) leaves, for the backward pair's
    yardstick: the flash backend pinned with ``sdpa_kernel`` where it
    takes ``enable_gqa``, else PyTorch's own dispatch. Returns (output,
    which backend)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def call():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)
    try:
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            return call(), "SDPA flash backend (pinned), enable_gqa"
    except RuntimeError as e:
        why = str(e).splitlines()[0][:160]
        return call(), f"SDPA default dispatch (flash refused: {why})"


def unaligned_copy(torch, t):
    """A contiguous copy of ``t`` 2 bytes past an aligned base: TMA
    cannot address it, so a wrapper takes the CUDA-core route on it."""
    flat = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    out = flat[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    return out


def time_bwd_kernels(torch, gen, launches, routes) -> list:
    """Kernels 2.2 and 2.3 at the training path's shape (bf16 o and do,
    no lse cotangent, as the model calls them), beside their CUDA-core
    route on the same values (through an unaligned copy of q), the
    row-delta reduction they read, the plain backward and one library
    call, SDPA's backward, each of the last two computing dq, dk and dv
    together."""
    from pbs_tpu_torch.ops import attention as A

    B, S, H, Hkv = TRAIN_BATCH, TRAIN_SEQ - 1, FLAGSHIP["n_heads"], \
        FLAGSHIP["n_kv_heads"]
    hd = FLAGSHIP["d_model"] // H
    q = torch.randn(B, S, H, hd, device="cuda", generator=gen).bfloat16()
    k = torch.randn(B, S, Hkv, hd, device="cuda", generator=gen).bfloat16()
    v = torch.randn(B, S, Hkv, hd, device="cuda", generator=gen).bfloat16()
    o, lse = A.flash_attention_cuda(q, k, v, True)
    do = torch.randn(o.shape, device="cuda", generator=gen).bfloat16()
    row = A._row_delta(o, do, None)
    qu = unaligned_copy(torch, q)
    check(A.backward_route(q, k, v, do) == "wgmma"
          and A.backward_route(qu, k, v, do) == "simt",
          "backward routes at the training path's shape: wgmma, and simt "
          "for an unaligned copy of q")
    ref = A.flash_attention_bwd_plain(q.float(), k.float(), v.float(), o,
                                      lse, do.float(), None, True)
    limit = BWD_REL["bfloat16"]
    errs = {}
    for route, qq in (("wgmma", q), ("simt", qu)):
        dq = A.flash_attention_bwd_dq_cuda(qq, k, v, do, lse, row, True)
        dk, dv = A.flash_attention_bwd_dkv_cuda(qq, k, v, do, lse, row, True)
        oks, err = [], []
        for g, want in zip((dq, dk, dv), ref):
            diff = (g.float() - want).abs()
            oks.append(bool((diff <= limit * float(want.abs().max())
                             + BF16_HALF_ULP * want.abs()).all()))
            err.append(float(diff.max()))
        errs[route] = (oks, err)
        check(all(oks), f"flash bwd ({route}) at the training path's shape: "
                        f"dq/dk/dv |g-ref| max {err} <= {limit:g} max|ref| "
                        f"+ {BF16_HALF_ULP:g}|ref|")

    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    out, backend = sdpa_pair(qt, kt, vt)
    dot = do.transpose(1, 2)
    lib_dq = torch.autograd.grad(out, (qt, kt, vt), dot,
                                 retain_graph=True)[0].transpose(1, 2)
    lib_rel = rel_err(lib_dq, ref[0])
    check(lib_rel < 0.05, f"library SDPA backward ({backend}): dq rel err "
                          f"{lib_rel:.2e} < 0.05 against the plain fp32 dq")
    t = timed_in_turns(torch, {
        "dq": lambda: A.flash_attention_bwd_dq_cuda(q, k, v, do, lse, row,
                                                     True),
        "dkv": lambda: A.flash_attention_bwd_dkv_cuda(q, k, v, do, lse, row,
                                                       True),
        "dq_simt": lambda: A.flash_attention_bwd_dq_cuda(qu, k, v, do, lse,
                                                          row, True),
        "dkv_simt": lambda: A.flash_attention_bwd_dkv_cuda(qu, k, v, do, lse,
                                                            row, True),
        "row_delta": lambda: A._row_delta(o, do, None),
        "plain": lambda: A.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                     None, True),
        # SDPA's pair wanders between calls: more iterations than the rest
        "library": lambda: [torch.autograd.grad(out, (qt, kt, vt), dot,
                                                retain_graph=True)
                            for _ in range(5)],
    }, iters=20)
    t["library"] /= 5
    pairs = S * (S + 1) // 2  # causal (query, key) pairs per (b, h)
    shape = (f"q ({B},{S},{H},{hd}) k/v ({B},{S},{Hkv},{hd}) bf16 causal, "
             "bf16 do, no lse cotangent")
    in_bytes = (2 * (2 * B * S * H * hd + 2 * B * S * Hkv * hd)
                + 2 * 4 * B * S * H)  # q, do, k, v; lse, row delta
    oks, err = errs["wgmma"]
    rows = []
    for name, key, flops, out_bytes, e, ok in (
            ("flash_bwd_dq", "dq", 6 * B * H * hd * pairs,
             2 * B * S * H * hd, err[0], oks[0]),
            ("flash_bwd_dkv", "dkv", 8 * B * H * hd * pairs,
             2 * 2 * B * S * Hkv * hd, max(err[1:]), all(oks[1:]))):
        bms, by = bound(flops, in_bytes + out_bytes)
        entry = dict(
            name=name, route="cuda", kernel_route=route_of(routes[name]),
            **KERNELS[name], launches=launches[name],
            launches_by_route=routes[name],
            path="training", max_abs_err=e, ms=t[key],
            simt_ms=t[f"{key}_simt"], row_delta_ms=t["row_delta"],
            plain_ms=t["plain"], library_ms=t["library"],
            library_backend=backend, bound_ms=bms, bound_by=by, ok=ok,
            tolerance=f"|g-ref| <= {limit:g} max|ref| + {BF16_HALF_ULP:g}"
                      "|ref|, ref = plain fp32 backward",
            plain_and_library_compute="dq, dk and dv in one call (pair)",
            shape=shape)
        entry.update(redesign_rates(entry, flops))
        rows.append(entry)
    return rows


def device_self_us(e) -> float:
    """A ``key_averages()`` row's device time of its own, in us."""
    return float(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0)))


def profile_micro_step(torch, micro_step, state) -> None:
    """One more training micro-step under torch.profiler: device time by
    kernel and the device's idle share of the step's wall time, each of
    the port's flash kernels on its own and everything else by the
    telemetry plane's classifier (``classify_kernel``). A measurement,
    not a check: where the profiler records no device time it says so."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pbs_tpu_torch.telemetry.profiler import classify_kernel

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        micro_step(state)
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    dev = [e for e in prof.key_averages()
           if getattr(e, "device_type", None) == DeviceType.CUDA]
    busy = sum(device_self_us(e) for e in dev)
    if busy <= 0:
        print("  profile: no device time recorded; device time by kernel "
              "not measured", flush=True)
        return
    groups = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0,
              "compute": 0.0, "memory": 0.0, "collective": 0.0}
    for e in dev:
        key = e.key
        g = next((k for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
                  if f"{k}_" in key), None) or classify_kernel(key)
        groups[g] += device_self_us(e)
    print(f"  profiled micro-step: {wall_us / 1e3:.2f} ms wall (profiler "
          f"on), {busy / 1e3:.2f} ms device busy, idle share "
          f"{1 - busy / wall_us:.3f}", flush=True)
    print("  device ms by group (the flash kernels, then the rest by "
          "classify_kernel): " + json.dumps(
              {k: round(v / 1e3, 3) for k, v in groups.items()}))
    for e in sorted(dev, key=device_self_us, reverse=True)[:10]:
        print(f"    {device_self_us(e) / 1e3:9.3f} ms  x{e.count:<5} "
              f"{e.key[:90]}")


def time_remat_policies(torch, gen, cfg, params) -> None:
    """One micro-batch's loss and gradients under each remat setting:
    host wall time closed by a synchronise, and peak device memory. A
    measurement of where the training step's time goes, not a check."""
    from pbs_tpu_torch.models.transformer import loss_and_grads

    tokens = torch.randint(0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ),
                           device="cuda", generator=gen)
    for remat, policy in ((False, "dots"), (True, "dots"), (True, "full")):
        c = dataclasses.replace(cfg, remat=remat, remat_policy=policy)
        loss_and_grads(c, params, tokens)  # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        for _ in range(2):
            loss_and_grads(c, params, tokens)
        torch.cuda.synchronize()
        ms = (time.monotonic() - t0) / 2 * 1e3
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"  loss+grads, remat={remat} policy={policy if remat else '-'}"
              f": {ms:.2f} ms per micro-batch (host clock), peak "
              f"{peak:.2f} GiB allocated", flush=True)


def route_of(counts: dict) -> str:
    """The route(s) a main path's launches took, from a wrapper's
    ``launches_by_route``: "wgmma", "simt", or both joined by "+"."""
    return "+".join(r for r, n in counts.items() if n) or "none"


def redesign_rates(row: dict, flops: float) -> dict:
    """Achieved TFLOP/s (useful work over kernel time) and the fraction
    of the bound the kernel reaches (bound_ms / ms)."""
    return dict(tflops=flops / (row["ms"] * 1e-3) / 1e12,
                bound_fraction=row["bound_ms"] / row["ms"])


def time_flash_fwd(torch, gen, B, S, launches, routes, path) -> dict:
    """Kernel 2.1 at one main path's shape (bf16, causal, bf16 o), held
    against its plain version, timed beside it and beside SDPA."""
    import torch.nn.functional as F

    from pbs_tpu_torch.ops.attention import (flash_attention_cuda,
                                             flash_attention_plain)

    H, Hkv = FLAGSHIP["n_heads"], FLAGSHIP["n_kv_heads"]
    hd = FLAGSHIP["d_model"] // H
    q = torch.randn(B, S, H, hd, device="cuda", generator=gen).bfloat16()
    k = torch.randn(B, S, Hkv, hd, device="cuda", generator=gen).bfloat16()
    v = torch.randn(B, S, Hkv, hd, device="cuda", generator=gen).bfloat16()
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    ok, err, err_l, limit = flash_against_plain(torch, q, k, v, True)
    check(ok, f"flash at the {path} path's shape: |o-ref| max {err:.2e} <= "
              f"{limit}, lse {err_l:.2e} <= {FLASH_ATOL:g}")
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
    row = dict(name="flash_fwd" if path == "serving"
               else "flash_fwd_training_shape", route="cuda",
               kernel_route=route_of(routes), **KERNELS["flash_fwd"],
               launches=launches, launches_by_route=routes, path=path,
               max_abs_err=err, **t, bound_ms=bms, bound_by=by, ok=ok,
               tolerance=f"|o-ref| <= {limit}, ref = plain fp32 o",
               shape=f"q ({B},{S},{H},{hd}) k/v ({B},{S},{Hkv},{hd}) "
                     "bf16 causal")
    row.update(redesign_rates(row, flops))
    return row


def time_kernels(torch, gen, launches, routes, train_launches,
                 train_routes) -> list:
    from pbs_tpu_torch.ops.matmul import (instrumented_matmul_cuda,
                                          instrumented_matmul_plain)

    rows = [time_flash_fwd(torch, gen, SCORE_BATCH, SCORE_SEQ,
                           launches["flash_fwd"], routes["flash_fwd"],
                           "serving"),
            time_flash_fwd(torch, gen, TRAIN_BATCH, TRAIN_SEQ - 1,
                           train_launches["flash_fwd"],
                           train_routes["flash_fwd"], "training")]
    rows += time_bwd_kernels(torch, gen, train_launches, train_routes)

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
    row = dict(name="instrumented_matmul", route="cuda",
               kernel_route=route_of(routes["instrumented_matmul"]),
               **KERNELS["instrumented_matmul"],
               launches=launches["instrumented_matmul"],
               launches_by_route=routes["instrumented_matmul"], path="serving",
               max_abs_err=err, **t, bound_ms=bms, bound_by=by,
               ok=mm_ok, tolerance="stats equal, rel err < 1e-3",
               shape=f"{MM_N}^3 bf16 in, fp32 out, blocks {blk}")
    row.update(redesign_rates(row, flops))
    rows.append(row)
    for r in rows:
        rates = (f", {r['tflops']:.1f} TFLOP/s, {r['bound_fraction']:.3f} "
                 f"of the bound" if "tflops" in r else "")
        if "simt_ms" in r:
            rates += (f"; CUDA-core route {r['simt_ms']:.4f} ms, row delta "
                      f"{r['row_delta_ms']:.4f} ms; library: "
                      f"{r['library_backend']}")
        print(f"  {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.3f}, "
              f"library {r['library_ms']}, bound {r['bound_ms']:.4f} "
              f"by {r['bound_by']}{rates}) at {r['shape']}", flush=True)
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


_TEMPLATE_ARG = re.compile(r"13__nv_bfloat16|S\d*_|Li(\d+)E|f")


def ptxas_report(log: str) -> list[str]:
    """nvcc's -Xptxas -v output cut to one line per kernel: its name and
    template arguments, registers, static shared memory and spills (the
    wgmma kernels' shared memory is dynamic, sized in their sources)."""
    lines, name, spill = [], "?", ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            m = re.search(r"\d\d?([a-z][a-z_]*_kernel)(?:I(\w*?E)E)?", ln)
            if m is None:
                name = ln.strip()
                continue
            args: list[str] = []
            for t in _TEMPLATE_ARG.finditer(m.group(2) or ""):
                # a substitution (S_) repeats the type before it
                args.append("bf16" if t.group(0)[0] == "1" else "fp32"
                            if t.group(0) == "f" else t.group(1)
                            or args[-1])
            name = f"{m.group(1)}<{', '.join(args)}>" if args else m.group(1)
        elif "spill stores" in ln:
            spill = ln.strip()
        elif "registers" in ln:
            lines.append(f"{name}: {ln.split(':', 1)[1].strip()}; {spill}")
    return lines


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return smi.splitlines()[0]


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trace-out", default=None,
                    help="also write one profiled quantum's trimmed Chrome "
                         "trace (kernels 2.1-2.4 and a tanh chain) here")
    args = ap.parse_args()
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
        print(f"  {r.name}: {r.seconds:.1f} s -> {r.path.name}")
        for ln in ptxas_report(r.log):
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
    launches, routes, serve_ms_per_token = run_main_path(torch, gen, cfg,
                                                         params)

    phase("3t train: a micro-stepped training Job beside the serving tenant")
    (train_launches, train_routes, train_cfg, train_params, micro_step,
     train_state) = run_train_path(torch, gen, cfg, params)

    phase("3m measured telemetry: torch.profiler samples steer the slices")
    m_launches, m_routes = run_measured_path(torch, gen, cfg, params, built)
    if args.trace_out:
        write_trace_fixture(torch, gen, args.trace_out)

    phase("3s serving engine: continuous batching as a tenant, fp32 "
          "exactness, speculative and int8 serving")
    e_launches, e_routes = run_engine_path(torch, gen, cfg, params,
                                           serve_ms_per_token, card_line())

    phase("4 numerics at width")
    check_numerics(torch, gen, cfg, params)
    del params
    check_train_numerics(torch, gen, train_cfg, train_params)

    phase("5 times at the main paths' shapes")
    rows = time_kernels(torch, gen, launches, routes, train_launches,
                        train_routes)
    for r in rows:  # phase 3m's launches of the same kernel
        kernel = "flash_fwd" if r["name"].startswith("flash_fwd") \
            else r["name"]
        r["measured_path_launches"] = m_launches[kernel]
        r["measured_path_launches_by_route"] = m_routes[kernel]
        # phase 3s's run: 2.1 (score) and 2.4 (mm) beside the engine
        r["engine_path_launches"] = e_launches[kernel]
        r["engine_path_launches_by_route"] = e_routes[kernel]
    profile_micro_step(torch, micro_step, train_state)
    del micro_step, train_state
    time_remat_policies(torch, gen, train_cfg, train_params)

    print(card_line())
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
