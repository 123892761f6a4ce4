"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``: on a host without a CUDA device every test here skips
with that reason. On the card host they run with the other port tests:

    python -m pytest tests/test_torch_*.py -q

Tolerances: the flash kernel computes in fp32 and rounds only its
output, so its o is held element by element against the plain
version's fp32 o: |o - ref| <= 2e-4 + r * |ref|, r = 2^-8 (at most half
a bf16 ulp) for a bf16 o and 0 for an fp32 o; lse within 2e-4. The
matmul's counter vector must be exactly equal.

Routes: bf16 inputs that TMA can address run on the tensor cores
("wgmma"), everything else on the CUDA cores ("simt"); for the backward
kernels that includes do, so the lse variant's fp32 do takes "simt".
Each test asserts which route its launch took.
"""

from __future__ import annotations

import pytest
import torch

from pbs_tpu_torch.ops import attention, matmul

# The suite runs in parallel worker processes: uncapped, torch's intra-op
# pool takes every core in each of them and oversubscribes the host.
torch.set_num_threads(2)

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _qkv(gen, B, S, H, Hkv, hd, dtype):
    return tuple(torch.randn(B, S, h, hd, device="cuda", generator=gen)
                 .to(dtype) for h in (H, Hkv, Hkv))


def _assert_close_to_fp32(o, ref):
    r = 2.0 ** -8 if o.dtype == torch.bfloat16 else 0.0
    diff = (o.float() - ref).abs()
    assert bool((diff <= 2e-4 + r * ref.abs()).all()), float(diff.max())


def _routes(wrapper):
    return dict(wrapper.launches_by_route)


def _one_more(before, after, route):
    want = dict(before)
    want[route] += 1
    return after == want


@pytest.mark.parametrize("hd", attention.KERNEL_HEAD_DIMS)
@pytest.mark.parametrize("S,causal", [(512, True), (511, False), (130, True),
                                      (1023, True), (17, True), (17, False)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_flash_kernel_matches_plain(gen, hd, S, causal, dtype):
    q, k, v = _qkv(gen, 2, S, 8, 4, hd, dtype)
    route = "wgmma" if dtype == torch.bfloat16 else "simt"
    before = attention.flash_attention_cuda.launches
    routes = _routes(attention.flash_attention_cuda)
    o, lse = attention.flash_attention_lse(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert attention.flash_attention_cuda.launches == before + 1
    assert _one_more(routes, _routes(attention.flash_attention_cuda), route)
    ref_o, ref_lse = attention.flash_attention_plain(q, k, v, causal, True)
    assert o.dtype == torch.float32
    _assert_close_to_fp32(o, ref_o)
    assert float((lse - ref_lse).abs().max()) <= 2e-4
    out = attention.flash_attention(q, k, v, causal=causal)
    assert out.dtype == dtype and out.shape == q.shape
    _assert_close_to_fp32(out, ref_o)


@pytest.mark.parametrize("B,S", [(4, 1024), (2, 1023)],
                         ids=["serving", "training"])
def test_flash_kernel_at_the_main_paths_shapes(gen, B, S):
    """The flagship's heads (16 query, 8 kv, head_dim 128), bf16,
    causal, at the serving path's (4, 1024) and the training path's
    (2, 1023): the tensor-core route."""
    q, k, v = _qkv(gen, B, S, 16, 8, 128, torch.bfloat16)
    routes = _routes(attention.flash_attention_cuda)
    for out_f32 in (False, True):
        o, lse = attention.flash_attention_cuda(q, k, v, True, out_f32)
        ref_o, ref_lse = attention.flash_attention_plain(q, k, v, True, True)
        _assert_close_to_fp32(o, ref_o)
        assert float((lse - ref_lse).abs().max()) <= 2e-4
    routes["wgmma"] += 2
    assert _routes(attention.flash_attention_cuda) == routes


def test_flash_kernel_unaligned_bf16_takes_the_cuda_core_route(gen):
    """A contiguous bf16 view 2 bytes past an aligned base: TMA cannot
    address it, so the launch takes the CUDA-core route, and agrees."""
    B, S, H, Hkv, hd = 2, 130, 8, 4, 64
    flat = torch.randn(B * S * H * hd + 1, device="cuda",
                       generator=gen).bfloat16()
    q = flat[1:].view(B, S, H, hd)
    _, k, v = _qkv(gen, B, S, H, Hkv, hd, torch.bfloat16)
    assert attention.forward_route(q, k, v) == "simt"
    routes = _routes(attention.flash_attention_cuda)
    o, lse = attention.flash_attention_cuda(q, k, v, True)
    assert _one_more(routes, _routes(attention.flash_attention_cuda), "simt")
    ref_o, ref_lse = attention.flash_attention_plain(q, k, v, True, True)
    _assert_close_to_fp32(o, ref_o)
    assert float((lse - ref_lse).abs().max()) <= 2e-4


def test_flash_kernel_refuses_what_it_does_not_take(gen):
    q, k, v = _qkv(gen, 1, 64, 2, 1, 48, torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        attention.flash_attention(q, k, v)
    q, k, v = _qkv(gen, 1, 64, 2, 1, 64, torch.float16)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        attention.flash_attention(q, k, v)


def _assert_grad_close(g, ref):
    r = 2.0 ** -8 if g.dtype == torch.bfloat16 else 0.0
    diff = (g.float() - ref).abs()
    limit = 1e-5 * float(ref.abs().max()) + r * ref.abs()
    assert bool((diff <= limit).all()), float(diff.max())


_BWD = (attention.flash_attention_bwd_dq_cuda,
        attention.flash_attention_bwd_dkv_cuda)


@pytest.mark.parametrize("hd", attention.KERNEL_HEAD_DIMS)
@pytest.mark.parametrize("S,causal", [(512, True), (511, False), (130, True),
                                      (17, True), (17, False)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("use_lse", [False, True], ids=["o", "o+lse"])
def test_flash_backward_kernels_match_plain(gen, hd, S, causal, dtype,
                                            use_lse):
    """Kernels 2.2 and 2.3 through autograd: a loss of o alone (do in
    the input dtype, no lse cotangent) or of the lse variant's fp32 o
    and its lse. bf16 with a bf16 do takes the tensor cores; fp32, and
    the lse variant's fp32 do, the CUDA cores."""
    q, k, v = (t.requires_grad_() for t in _qkv(gen, 2, S, 8, 4, hd, dtype))
    w = torch.randn(q.shape, device="cuda", generator=gen)
    route = "wgmma" if dtype == torch.bfloat16 and not use_lse else "simt"
    before = (attention.flash_attention_bwd_dq_cuda.launches,
              attention.flash_attention_bwd_dkv_cuda.launches)
    routes = [_routes(fn) for fn in _BWD]
    if use_lse:
        wl = torch.randn((2, S, 8, 1), device="cuda", generator=gen)
        o, lse = attention.flash_attention_lse(q, k, v, causal=causal)
        ((o * w).sum() + (lse * wl).sum()).backward()
    else:
        w, wl = w.to(dtype), None
        o = attention.flash_attention(q, k, v, causal=causal)
        o.backward(w)
        _, lse = attention.flash_attention_cuda(q.detach(), k.detach(),
                                                v.detach(), causal)
    torch.cuda.synchronize()
    assert (attention.flash_attention_bwd_dq_cuda.launches,
            attention.flash_attention_bwd_dkv_cuda.launches) == (
        before[0] + 1, before[1] + 1)
    for fn, was in zip(_BWD, routes):
        assert _one_more(was, _routes(fn), route)
    qf, kf, vf = (t.detach().float() for t in (q, k, v))
    ref = attention.flash_attention_bwd_plain(
        qf, kf, vf, o.detach(), lse.detach(), w.float(), wl, causal)
    for g, r in zip((q.grad, k.grad, v.grad), ref):
        assert g.dtype == dtype and g.shape == r.shape
        _assert_grad_close(g, r)


def _bwd_inputs(gen, B, S, H, Hkv, hd, do_dtype=torch.bfloat16):
    q, k, v = _qkv(gen, B, S, H, Hkv, hd, torch.bfloat16)
    o, lse = attention.flash_attention_cuda(q, k, v, True)
    do = torch.randn(o.shape, device="cuda", generator=gen).to(do_dtype)
    return q, k, v, o, lse, do


def _bwd_launch(q, k, v, o, lse, do, route):
    """Both backward kernels on one input set; asserts each took
    ``route``; returns (dq, dk, dv) and the plain fp32 reference."""
    routes = [_routes(fn) for fn in _BWD]
    row = attention._row_delta(o, do, None)
    dq = attention.flash_attention_bwd_dq_cuda(q, k, v, do, lse, row, True)
    dk, dv = attention.flash_attention_bwd_dkv_cuda(q, k, v, do, lse, row,
                                                    True)
    torch.cuda.synchronize()
    for fn, was in zip(_BWD, routes):
        assert _one_more(was, _routes(fn), route)
    ref = attention.flash_attention_bwd_plain(
        q.float(), k.float(), v.float(), o, lse, do.float(), None, True)
    return (dq, dk, dv), ref


def test_flash_backward_at_the_training_shape(gen):
    """The training path's call (B 2, S 1023, 16/8 heads, head_dim 128,
    bf16, causal, bf16 do): both passes on the tensor cores."""
    inputs = _bwd_inputs(gen, 2, 1023, 16, 8, 128)
    got, ref = _bwd_launch(*inputs, "wgmma")
    for g, r in zip(got, ref):
        assert g.dtype == torch.bfloat16
        _assert_grad_close(g, r)


def test_flash_backward_bf16_with_fp32_do_takes_the_cuda_core_route(gen):
    """bf16 q, k, v with an fp32 do (the lse variant's cotangent): the
    CUDA-core route, which takes fp32 do, and agrees."""
    inputs = _bwd_inputs(gen, 2, 130, 8, 4, 64, do_dtype=torch.float32)
    assert attention.backward_route(*inputs[:3], inputs[5]) == "simt"
    got, ref = _bwd_launch(*inputs, "simt")
    for g, r in zip(got, ref):
        assert g.dtype == torch.bfloat16
        _assert_grad_close(g, r)


def test_flash_backward_unaligned_bf16_takes_the_cuda_core_route(gen):
    """A contiguous bf16 q 2 bytes past an aligned base: TMA cannot
    address it, so both passes take the CUDA-core route, and agree."""
    q, k, v, o, lse, do = _bwd_inputs(gen, 2, 130, 8, 4, 64)
    flat = torch.empty(q.numel() + 8, dtype=q.dtype, device="cuda")
    qu = flat[1:1 + q.numel()].view(q.shape)
    qu.copy_(q)
    assert attention.backward_route(qu, k, v, do) == "simt"
    got, ref = _bwd_launch(qu, k, v, o, lse, do, "simt")
    for g, r in zip(got, ref):
        _assert_grad_close(g, r)


@pytest.mark.parametrize("route", ["wgmma", "simt"])
def test_flash_backward_is_deterministic(gen, route):
    """No atomics: two calls on the same inputs give bitwise-equal dq,
    dk and dv on either route."""
    q, k, v, o, lse, do = _bwd_inputs(gen, 2, 511, 8, 4, 128)
    if route == "simt":
        do = do.float()
    first, _ = _bwd_launch(q, k, v, o, lse, do, route)
    again, _ = _bwd_launch(q, k, v, o, lse, do, route)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_flash_backward_refuses_what_it_does_not_take(gen):
    q, k, v = _qkv(gen, 1, 64, 2, 1, 64, torch.bfloat16)
    o, lse = attention.flash_attention_cuda(q, k, v)
    row = torch.zeros((1, 64, 2), device="cuda")
    with pytest.raises(ValueError, match="do in"):
        attention.flash_attention_bwd_dq_cuda(q, k, v, o.half(), lse, row)
    q48, k48, v48 = _qkv(gen, 1, 64, 2, 1, 48, torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        attention.flash_attention_bwd_dkv_cuda(q48, k48, v48, q48, lse, row)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        attention.flash_attention_bwd(q.half(), k.half(), v.half(), o, lse,
                                      o)


@pytest.mark.parametrize("M,K,N,blk", [(512, 512, 512, 256),
                                       (256, 768, 384, 128),
                                       (384, 256, 256, 64),
                                       (4096, 512, 4096, 256),
                                       (8, 12, 8, 4)])  # K: no TMA
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_matmul_kernel_matches_plain(gen, M, K, N, blk, dtype):
    a = torch.randn(M, K, device="cuda", generator=gen).to(dtype)
    a[:blk, :blk] = 0  # a data-derived zero tile
    b = torch.randn(K, N, device="cuda", generator=gen).to(dtype)
    route = ("wgmma" if dtype == torch.bfloat16 and K % 8 == 0 and N % 8 == 0
             else "simt")
    before = matmul.instrumented_matmul_cuda.launches
    routes = _routes(matmul.instrumented_matmul_cuda)
    out, raw = matmul.instrumented_matmul(a, b, blk, blk, blk)
    torch.cuda.synchronize()
    assert matmul.instrumented_matmul_cuda.launches == before + 1
    assert _one_more(routes, _routes(matmul.instrumented_matmul_cuda), route)
    ref, ref_raw = matmul.instrumented_matmul_plain(a, b, blk, blk, blk)
    assert raw.tolist() == ref_raw.tolist()
    assert raw.tolist()[matmul.STAT_A_ZERO_TILES] == N // blk
    rel = float((out - ref).abs().max() / ref.abs().max())
    assert out.dtype == torch.float32 and rel < 1e-3


# -- measured telemetry: torch.profiler on the card ---------------------------


def _profiled(fn, keep_dir):
    from pbs_tpu_torch.telemetry.profiler import TorchQuantumProfiler

    prof = TorchQuantumProfiler("cuda", keep_dir=str(keep_dir))

    def quantum():
        fn()
        torch.cuda.synchronize()

    _, stats = prof.profile(quantum)
    assert (prof.samples, prof.failures) == (1, 0), prof.last_error
    return stats


def test_profiler_bills_each_wgmma_kernel_as_compute(gen, tmp_path):
    import json

    from pbs_tpu_torch.telemetry.profiler import (DEVICE_CATS,
                                                  classify_kernel)

    q, k, v = _qkv(gen, 1, 256, 4, 2, 128, torch.bfloat16)
    a = torch.randn(512, 512, device="cuda", generator=gen).bfloat16()

    def fn():
        o, lse = attention.flash_attention_cuda(q, k, v, True)
        attention.flash_attention_bwd(q, k, v, o, lse, o, None, True)
        matmul.instrumented_matmul(a, a, 256, 256, 256)

    stats = _profiled(fn, tmp_path)
    assert stats.source == "device" and stats.compute_ns > 0
    doc = json.loads((tmp_path / "trace_0.json").read_text())
    names = {e["name"] for e in doc["traceEvents"]
             if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS}
    for kernel in ("flash_fwd_wgmma_kernel", "flash_bwd_dq_wgmma_kernel",
                   "flash_bwd_dkv_wgmma_kernel", "mm_wgmma_kernel"):
        hits = [n for n in names if kernel in n]
        assert hits, (kernel, sorted(names))
        assert all(classify_kernel(n) == "compute" for n in hits)


def test_profiler_reads_a_tanh_chain_as_memory_and_apart_from_a_matmul(
        gen, tmp_path):
    x = torch.randn(1 << 24, device="cuda", generator=gen)
    a = torch.randn(2048, 2048, device="cuda", generator=gen).bfloat16()

    def chain():
        y = x
        for _ in range(8):
            y = torch.tanh(y)

    tanh = _profiled(chain, tmp_path / "tanh")
    mm = _profiled(lambda: matmul.instrumented_matmul(a, a, 256, 256, 256),
                   tmp_path / "mm")
    assert tanh.source == mm.source == "device"
    assert tanh.stall_frac > 0.95, tanh.top_ops
    assert tanh.stall_frac - mm.stall_frac > 0.5, (tanh.top_ops, mm.top_ops)


# -- the serving engine on the card ------------------------------------------


def _engine_model(gen):
    from pbs_tpu_torch.models import TransformerConfig, init_params

    cfg = TransformerConfig(vocab=256, d_model=128, n_layers=2, n_heads=4,
                            n_kv_heads=2, d_ff=256, max_seq=128,
                            dtype=torch.float32)
    return cfg, init_params(cfg, gen)


def _staggered(eng, reqs):
    got, pending, tick = {}, list(reqs), 0
    while pending or eng.has_work():
        if pending and tick % 2 == 0:
            eng.submit(*pending.pop(0))
        got.update({c.request_id: c.tokens for c in eng.step()})
        tick += 1
    return got


def _requests(n):
    rng = torch.Generator().manual_seed(3)
    return [(torch.randint(0, 256, (int(torch.randint(1, 16, (1,),
                                                      generator=rng)),),
                           generator=rng).tolist(),
             int(torch.randint(1, 24, (1,), generator=rng)))
            for _ in range(n)]


def test_engine_is_token_exact_against_lockstep_generate(gen):
    """fp32 on the card: staggered requests through 3 slots give each
    request the tokens of the port's lockstep generate at B=1."""
    from pbs_tpu_torch.models import ContinuousBatcher, make_generate

    cfg, params = _engine_model(gen)
    reqs = _requests(7)
    eng = ContinuousBatcher(cfg, params, n_slots=3, prompt_bucket=16,
                            max_len=64, prefix_cache_size=16)
    assert eng.device.type == "cuda" and eng.cache["pos"].is_cuda
    got = _staggered(eng, reqs + reqs[:2])
    assert eng.prefix_hits == 2
    for rid, (prompt, n) in enumerate(reqs + reqs[:2]):
        want = make_generate(cfg, n)(
            params, torch.tensor([prompt], device="cuda"))[0].tolist()
        assert got[rid] == want, rid


def test_speculative_engine_matches_the_plain_engine(gen):
    from pbs_tpu_torch.models import ContinuousBatcher, SpeculativeBatcher

    cfg, params = _engine_model(gen)
    noise = torch.randn(params["head"].shape, device="cuda", generator=gen)
    draft = dict(params, head=params["head"] + 0.05 * params["head"].std()
                 * noise)
    reqs = _requests(7)
    kw = dict(n_slots=3, prompt_bucket=16, max_len=64)
    plain = ContinuousBatcher(cfg, params, **kw)
    spec = SpeculativeBatcher(cfg, params, cfg, draft, k=4, **kw)
    assert _staggered(spec, reqs) == _staggered(plain, reqs)
    assert spec.stats()["steps"] < plain.stats()["steps"]
    assert spec.stats()["spec_acceptance"] > 0
