"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``: on a host without a CUDA device every test here skips
with that reason. On the card host they run with the other port tests:

    python -m pytest tests/test_torch_*.py -q

Tolerances: the flash kernel computes in fp32 and rounds only its
output, so its o is held element by element against the plain
version's fp32 o: |o - ref| <= 2e-4 + r * |ref|, r = 2^-8 (at most half
a bf16 ulp) for a bf16 o and 0 for an fp32 o; lse within 2e-4. The
matmul's counter vector must be exactly equal.
"""

from __future__ import annotations

import pytest
import torch

from pbs_tpu_torch.ops import attention, matmul

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


@pytest.mark.parametrize("hd", attention.KERNEL_HEAD_DIMS)
@pytest.mark.parametrize("S,causal", [(512, True), (511, False), (130, True)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_flash_kernel_matches_plain(gen, hd, S, causal, dtype):
    q, k, v = _qkv(gen, 2, S, 8, 4, hd, dtype)
    before = attention.flash_attention_cuda.launches
    o, lse = attention.flash_attention_lse(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert attention.flash_attention_cuda.launches == before + 1
    ref_o, ref_lse = attention.flash_attention_plain(q, k, v, causal, True)
    assert o.dtype == torch.float32
    _assert_close_to_fp32(o, ref_o)
    assert float((lse - ref_lse).abs().max()) <= 2e-4
    out = attention.flash_attention(q, k, v, causal=causal)
    assert out.dtype == dtype and out.shape == q.shape
    _assert_close_to_fp32(out, ref_o)


def test_flash_kernel_refuses_what_it_does_not_take(gen):
    q, k, v = _qkv(gen, 1, 64, 2, 1, 48, torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        attention.flash_attention(q, k, v)
    q, k, v = _qkv(gen, 1, 64, 2, 1, 64, torch.float16)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        attention.flash_attention(q, k, v)


@pytest.mark.parametrize("M,K,N,blk", [(512, 512, 512, 256),
                                       (256, 768, 384, 128),
                                       (384, 256, 256, 64)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_matmul_kernel_matches_plain(gen, M, K, N, blk, dtype):
    a = torch.randn(M, K, device="cuda", generator=gen).to(dtype)
    a[:blk, :blk] = 0  # a data-derived zero tile
    b = torch.randn(K, N, device="cuda", generator=gen).to(dtype)
    before = matmul.instrumented_matmul_cuda.launches
    out, raw = matmul.instrumented_matmul(a, b, blk, blk, blk)
    torch.cuda.synchronize()
    assert matmul.instrumented_matmul_cuda.launches == before + 1
    ref, ref_raw = matmul.instrumented_matmul_plain(a, b, blk, blk, blk)
    assert raw.tolist() == ref_raw.tolist()
    assert raw.tolist()[matmul.STAT_A_ZERO_TILES] == N // blk
    rel = float((out - ref).abs().max() / ref.abs().max())
    assert out.dtype == torch.float32 and rel < 1e-3
