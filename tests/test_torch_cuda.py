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

import math

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


# -- memory admission, paging and the loader on the card --------------------


def test_device_memory_stats_reads_the_caching_allocator(gen):
    from pbs_tpu_torch.runtime import MemoryManager, device_memory_stats

    x = torch.empty(1 << 20, device="cuda")
    stats = device_memory_stats()
    assert set(stats) == {"bytes_in_use", "bytes_limit"}
    assert stats["bytes_in_use"] == torch.cuda.memory_allocated()
    assert stats["bytes_in_use"] >= x.numel() * 4
    assert stats["bytes_limit"] == torch.cuda.mem_get_info()[1]
    mm = MemoryManager.for_device()
    assert mm.capacity == stats["bytes_limit"]
    assert mm.reserve == torch.cuda.memory_allocated()


def test_page_out_and_in_on_the_card_is_bitwise(gen):
    """A sleeping tenant's CUDA state goes to pinned host memory (the
    allocator's count drops by its bytes) and comes back bit for bit,
    on its device, ordered before its next step."""
    from pbs_tpu_torch.runtime import Job, Partition, page_out_job
    from pbs_tpu_torch.telemetry import CudaBackend

    state = {"w": torch.randn(512, 1024, device="cuda", generator=gen),
             "b": torch.randn(777, device="cuda", generator=gen).bfloat16(),
             "n": torch.arange(5, dtype=torch.int32, device="cuda"),
             "step": 3}
    want = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
            for k, v in state.items()}
    nbytes = 512 * 1024 * 4 + 777 * 2 + 5 * 4
    part = Partition("p", source=CudaBackend())
    job = part.add_job(Job("t", step_fn=lambda s: dict(s, w=s["w"] * 2),
                           state=state, max_steps=1))
    del state
    torch.cuda.synchronize()
    part.sleep_job(job)
    before = torch.cuda.memory_allocated()
    assert page_out_job(part, job) == nbytes
    assert before - torch.cuda.memory_allocated() >= nbytes
    part.wake_job(job)
    for k in ("w", "b", "n"):
        assert job.state[k].is_cuda and job.state[k].dtype == want[k].dtype
        assert torch.equal(job.state[k], want[k]), k
    part.run(max_rounds=2)
    assert torch.equal(job.state["w"], want["w"] * 2)


def test_prefetcher_batches_on_the_card_equal_their_windows(gen, tmp_path):
    import numpy as np

    from pbs_tpu_torch.data import (Prefetcher, ShardedBatchSource,
                                    TokenDataset, write_token_file)

    path = str(tmp_path / "c.tok")
    write_token_file(path, np.arange(50_000) % 30_000)
    ds = TokenDataset(path)
    src = ShardedBatchSource(ds, global_batch=2, seq_len=1024, seed=1)
    want = ShardedBatchSource(ds, global_batch=2, seq_len=1024, seed=1)
    with Prefetcher(src, depth=2) as pf:
        for _ in range(6):
            got = next(pf)
            assert got.is_cuda and got.dtype == torch.int32
            # a consumer-stream kernel reads it only after its copy
            assert torch.equal((got + 0).cpu(), torch.from_numpy(want()))
    ds.close()


# -- the MoE family on the card -----------------------------------------------


def test_moe_ffn_and_train_step_on_the_card_match_the_host(gen):
    """fp32, attention through the flash kernels, full remat: the routed
    FFN, the loss and every gradient on the card against the same
    weights on the host's plain path (rtol 2e-4, atol 2e-5, the bound
    of tests/test_torch_train.py; routing the same), and one training
    step launching 2.1 twice per layer (forward and recompute) and 2.2
    and 2.3 once, each on the CUDA-core route (fp32)."""
    from pbs_tpu_torch.models import MoEConfig, init_moe_params
    from pbs_tpu_torch.models.moe import (make_moe_train_step, moe_loss,
                                          moe_mlp)
    from pbs_tpu_torch.models.transformer import (tree_leaves, tree_map,
                                                  unstack_layers,
                                                  value_and_grad)

    cfg = MoEConfig(vocab=256, d_model=128, n_layers=2, n_heads=4,
                    n_kv_heads=2, d_ff=96, max_seq=128, n_experts=4,
                    top_k=2, dtype=torch.float32, attn_impl="pallas",
                    remat=True)
    params = init_moe_params(cfg, gen)
    host = tree_map(lambda t: t.cpu(), params)
    tol = dict(rtol=2e-4, atol=2e-5)
    x = torch.randn(2, 64, 128, device="cuda", generator=gen)
    got = moe_mlp(cfg, x, unstack_layers(params)[0])
    want = moe_mlp(cfg, x.cpu(), unstack_layers(host)[0])
    torch.testing.assert_close(got[0].cpu(), want[0], **tol)
    for g, w in zip(got[1:], want[1:]):
        assert abs(float(g) - float(w)) <= 1e-6

    toks = torch.randint(0, 256, (2, 65), device="cuda", generator=gen)
    (loss, parts), grads = value_and_grad(
        lambda p: moe_loss(cfg, p, toks), params)
    (hloss, hparts), hgrads = value_and_grad(
        lambda p: moe_loss(cfg, p, toks.cpu()), host)
    torch.testing.assert_close(loss.cpu(), hloss, **tol)
    assert abs(float(parts[2]) - float(hparts[2])) <= 1e-6  # drop
    for g, w in zip(tree_leaves(grads), tree_leaves(hgrads)):
        torch.testing.assert_close(g.cpu(), w, **tol)

    wrappers = (attention.flash_attention_cuda,
                attention.flash_attention_bwd_dq_cuda,
                attention.flash_attention_bwd_dkv_cuda)
    before = [_routes(w) for w in wrappers]
    init, step = make_moe_train_step(cfg, learning_rate=1e-3)
    state, metrics = step((params, init(params), 0), toks)
    assert state[2] == 1 and 0.0 <= float(metrics["moe_drop_frac"]) < 1.0
    L = cfg.n_layers
    for w, b, n in zip(wrappers, before, (2 * L, L, L)):
        want_routes = dict(b)
        want_routes["simt"] += n
        assert _routes(w) == want_routes


# -- the partition's control plane on the card (chip_smoke phase 3c) ----------


def _kernel_jobs(gen, steps=6):
    """A matmul tenant (kernel 2.4) and a flash tenant (kernel 2.1), bf16
    on the tensor-core route, as Jobs."""
    from pbs_tpu_torch.runtime import Job, SchedParams

    a = torch.randn(512, 512, device="cuda", generator=gen).bfloat16()
    b = torch.randn(512, 512, device="cuda", generator=gen).bfloat16()
    q, k, v = _qkv(gen, 2, 512, 8, 4, 128, torch.bfloat16)

    def mm_fn(state):
        out, raw = matmul.instrumented_matmul(a, b, 128, 128, 128)
        return out, matmul.scale_stats(raw, 128, 128, 128).metrics()

    def flash_fn(state):
        return attention.flash_attention(q, k, v, causal=True)

    return [Job("mm", step_fn=mm_fn, params=SchedParams(weight=512),
                max_steps=steps),
            Job("flash", step_fn=flash_fn, params=SchedParams(weight=256),
                max_steps=steps)]


def _wrapper_routes():
    return (_routes(matmul.instrumented_matmul_cuda),
            _routes(attention.flash_attention_cuda))


def test_credit2_drives_the_kernels_on_two_lanes_of_one_card(gen):
    from pbs_tpu_torch.runtime import Partition
    from pbs_tpu_torch.telemetry import CudaBackend

    lane = torch.device("cuda", 0)
    part = Partition("c2", source=CudaBackend(), scheduler="credit2",
                     devices=[lane, lane],
                     sched_params={"executors_per_runq": 1})
    jobs = [part.add_job(j) for j in _kernel_jobs(gen)]
    before = _wrapper_routes()
    part.run()
    after = _wrapper_routes()
    assert all(j.error is None and j.steps_retired() == 6 for j in jobs)
    assert all(ex.dispatch_count > 0 for ex in part.executors)
    for b, a in zip(before, after):
        assert a["wgmma"] - b["wgmma"] == 6 and a["simt"] == b["simt"]


def test_record_and_replay_kernel_tenants_on_the_card(gen, tmp_path):
    """chip_smoke phase 3r in small: the kernel tenants run under
    ``HwCounterSource`` over a cuda ``CudaBackend`` with the run recorder
    on, every launch on the tensor-core route; the trace replays offline
    to the recorded counter totals."""
    from pbs_tpu_torch.hwtelem import HwCounterSource
    from pbs_tpu_torch.runtime import Partition
    from pbs_tpu_torch.sched import FeedbackPolicy
    from pbs_tpu_torch.sim import TraceRecorder, load_trace, replay_partition
    from pbs_tpu_torch.telemetry import Counter, CudaBackend

    src = HwCounterSource(inner=CudaBackend())
    part = Partition("rec", source=src, scheduler="credit")
    fb = FeedbackPolicy.from_source(part, src)
    path = str(tmp_path / "rec.jsonl")
    part.recorder = TraceRecorder(path)
    jobs = [part.add_job(j) for j in _kernel_jobs(gen)]
    before = _wrapper_routes()
    part.run()
    fb.timer.stop()
    part.recorder.close()
    src.close()
    after = _wrapper_routes()
    for b, a in zip(before, after):
        assert a["wgmma"] - b["wgmma"] == 6 and a["simt"] == b["simt"]
    recs = load_trace(path)
    assert sum(1 for r in recs if r["kind"] == "quantum") == \
        sum(j.contexts[0].sched_count for j in jobs)
    replay = replay_partition(recs)
    replay.run()
    for job in jobs:
        got = replay.job(job.name).contexts[0].counters
        want = job.contexts[0].counters
        assert all(int(got[c]) == int(want[c]) for c in Counter
                   if c is not Counter.RUNQ_WAIT_NS), job.name


def test_arinc653_picks_start_in_their_own_windows_on_the_card(gen):
    from pbs_tpu_torch.obs.trace import Ev
    from pbs_tpu_torch.runtime import Partition
    from pbs_tpu_torch.telemetry import CudaBackend

    frame = [("mm", 4_000), ("flash", 4_000), (None, 2_000)]
    part = Partition("a653", source=CudaBackend(), scheduler="arinc653")
    jobs = {j.name: part.add_job(j) for j in _kernel_jobs(gen, steps=20)}
    part.scheduler.set_schedule(frame)
    part.run()
    sched = part.scheduler
    frame_ns = 10_000_000
    frame0 = sched.frame_start_ns - sched.frame_count * frame_ns
    by_slot = {j.contexts[0].ledger_slot: n for n, j in jobs.items()}
    starts = {"mm": 0, "flash": 4_000_000}
    picks = [r for r in part.drain_traces().tolist()
             if r[1] == int(Ev.SCHED_PICK)]
    assert len(picks) == sum(j.contexts[0].sched_count
                             for j in jobs.values())
    for ts, _, slot, *_ in picks:
        off = (ts - frame0) % frame_ns - starts[by_slot[slot]]
        # inside its own 4 ms window, or the record's few microseconds
        # after a decision at the window's very end
        assert 0 <= off < 4_000_000 + 200_000, (by_slot[slot], off)
    assert all(j.steps_retired() == 20 for j in jobs.values())


def test_wall_watchdog_barks_once_at_a_card_hold(gen):
    from pbs_tpu_torch.runtime import Job, Partition, WallWatchdog
    from pbs_tpu_torch.telemetry import CudaBackend

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(100_000_000)
    end.record()
    end.synchronize()
    hz = 100_000_000 / (start.elapsed_time(end) / 1e3)

    def hold(state):
        torch.cuda._sleep(int(1.0 * hz))
        torch.cuda.synchronize()
        return state

    part = Partition("wd", source=CudaBackend())
    part.add_job(_kernel_jobs(gen)[0])
    part.add_job(Job("hold", step_fn=hold, max_steps=1))
    barks = []
    wd = WallWatchdog(part, timeout_s=0.3, poll_s=0.02,
                      on_bark=lambda p, idle: barks.append(idle))
    with wd:
        part.run()
    assert wd.barks == 1 and barks[0] >= 0.3


# -- the twins of tpu_tests/test_on_chip.py's remaining five ------------------


def _tiny_cfg(**over):
    import dataclasses

    from pbs_tpu_torch.drivers.graft_entry import _flagship_cfg

    return dataclasses.replace(_flagship_cfg(tiny=True), **over)


@pytest.mark.parametrize("B,S,H,Hkv", [(1, 2048, 8, 4), (2, 4095, 16, 8),
                                       (1, 8191, 16, 8)],
                         ids=["S2048", "S4095", "S8191"])
def test_flash_long_context_numerics(gen, B, S, H, Hkv):
    """``tpu_tests/test_on_chip.py:127``, extended to the long-context
    training path's shapes (S - 1 after the shift): the forward at
    bf16 against the plain version as the online softmax folds up to
    128 key tiles, on the tensor cores. CPU twin:
    ``tests/test_torch_attention.py::test_flash_matches_reference``."""
    q, k, v = _qkv(gen, B, S, H, Hkv, 128, torch.bfloat16)
    routes = _routes(attention.flash_attention_cuda)
    o, lse = attention.flash_attention_cuda(q, k, v, True)
    ref_o, ref_lse = attention.flash_attention_plain(q, k, v, True, True)
    _assert_close_to_fp32(o, ref_o)
    assert float((lse - ref_lse).abs().max()) <= 2e-4
    assert _one_more(routes, _routes(attention.flash_attention_cuda),
                     "wgmma")


def test_pallas_train_step_on_the_card(gen):
    """``tpu_tests/test_on_chip.py:194``: ``attn_impl="pallas"`` through
    a full forward, backward and AdamW step (the tiny config in bf16),
    every flash launch on the tensor cores. CPU twin:
    ``tests/test_torch_train.py::test_loss_and_grads_match_reference``
    [pallas]."""
    from pbs_tpu_torch.models import init_params, make_train_step

    cfg = _tiny_cfg(attn_impl="pallas", dtype=torch.bfloat16)
    params = init_params(cfg, gen)
    init_opt, step = make_train_step(cfg, learning_rate=1e-3)
    toks = torch.randint(0, cfg.vocab, (2, 128), generator=gen,
                         device="cuda", dtype=torch.int32)
    wrappers = (attention.flash_attention_cuda,
                attention.flash_attention_bwd_dq_cuda,
                attention.flash_attention_bwd_dkv_cuda)
    before = [_routes(w) for w in wrappers]
    _, m = step((params, init_opt(params), 0), toks)
    assert torch.isfinite(m["loss"])
    grew = [{r: n - b[r] for r, n in _routes(w).items()}
            for w, b in zip(wrappers, before)]
    assert grew == [{"wgmma": 2, "simt": 0}, {"wgmma": 2, "simt": 0},
                    {"wgmma": 2, "simt": 0}]


def test_bf16_moments_train_step_on_the_card(gen):
    """``tpu_tests/test_on_chip.py:213``: ``mu_dtype=torch.bfloat16``
    through three train steps; both moments stay bf16 on the card. CPU
    twin: ``tests/test_torch_train.py::
    test_bf16_adam_moments_storage_and_parity``."""
    from pbs_tpu_torch.models import init_params, make_train_step

    cfg = _tiny_cfg(dtype=torch.bfloat16)
    params = init_params(cfg, gen)
    init_opt, step = make_train_step(cfg, learning_rate=1e-3,
                                     mu_dtype=torch.bfloat16)
    state = (params, init_opt(params), 0)
    toks = torch.randint(0, cfg.vocab, (2, 128), generator=gen,
                         device="cuda", dtype=torch.int32)
    for _ in range(3):
        state, m = step(state, toks)
    assert torch.isfinite(m["loss"])
    opt = state[1]
    assert int(opt["count"]) == 3
    for moment in ("mu", "nu"):
        leaf = opt[moment]["layers"]["wq"]
        assert leaf.dtype == torch.bfloat16 and leaf.is_cuda, moment


def test_dropless_moe_serving_on_the_card(gen):
    """``tpu_tests/test_on_chip.py:243``: a small dropless MoE target
    serves a prompt through the slot engine with zero drops, token for
    token the lockstep ``make_moe_generate``'s. CPU twins:
    ``tests/test_torch_serving.py::test_moe_dropless_engine_matches_reference``
    and ``tests/test_torch_moe.py::
    test_moe_generate_token_exact_with_the_drop_fraction``."""
    from pbs_tpu_torch.models import (ContinuousBatcher, MoEConfig,
                                      init_moe_params, make_moe_generate)
    from pbs_tpu_torch.models.moe import moe_slot_mlp

    mcfg = MoEConfig(vocab=256, d_model=256, n_layers=2, n_heads=8,
                     n_kv_heads=4, d_ff=512, max_seq=128,
                     dtype=torch.bfloat16, n_experts=4, top_k=2,
                     dropless=True)
    mparams = init_moe_params(mcfg, gen)
    prompt = torch.tensor([[5, 6, 7, 8]], dtype=torch.int32, device="cuda")
    ref, drop = make_moe_generate(mcfg, 8, temperature=0.0)(mparams, prompt)
    ref_toks = [int(t) for t in ref[0]]
    assert float(drop) == 0.0
    eng = ContinuousBatcher(mcfg, mparams, n_slots=2, prompt_bucket=4,
                            max_len=32, mlp_fn=moe_slot_mlp(mcfg))
    eng.submit([5, 6, 7, 8], max_new_tokens=8)
    got = None
    for _ in range(100):
        for c in eng.step():
            got = [int(t) for t in c.tokens]
        if not eng.has_work():
            break
    assert got == ref_toks, (got, ref_toks)
    assert eng.stats()["mlp_extra_mean"] == 0.0  # provably dropless


def test_chunked_ce_train_step_on_the_card(gen):
    """``tpu_tests/test_on_chip.py:281``: ``loss_chunks=4`` (the logits
    never materialize at once) through one train step; its loss within
    the reference's 5e-3 x max(1, |loss|) of the materialized one. CPU
    twin: ``tests/test_torch_train.py::
    test_loss_variants_match_materialized`` [chunked]."""
    import dataclasses

    from pbs_tpu_torch.models import init_params, make_train_step
    from pbs_tpu_torch.models.transformer import tree_map

    base = _tiny_cfg(dtype=torch.bfloat16)
    params = init_params(base, gen)
    toks = torch.randint(0, base.vocab, (2, 128), generator=gen,
                         device="cuda", dtype=torch.int32)
    losses = {}
    for name, cfg in (("mat", base),
                      ("chunk", dataclasses.replace(base, loss_chunks=4))):
        init_opt, step = make_train_step(cfg, learning_rate=1e-3,
                                         full_seq=True)
        p = tree_map(torch.clone, params)  # the step updates in place
        _, m = step((p, init_opt(p), 0), toks)
        losses[name] = float(m["loss"])
    assert math.isfinite(losses["chunk"])
    assert abs(losses["chunk"] - losses["mat"]) < 5e-3 * max(
        1.0, abs(losses["mat"]))
