"""Flash attention forward (causal or full, GQA) for PyTorch.

The port of ``pbs_tpu.ops.attention``'s forward. Public functions take
(B, S, H, hd) queries and (B, S, Hkv, hd) keys/values, as the
reference's do, and keep its semantics: H must be a multiple of Hkv
(``ValueError`` otherwise); any S is accepted, keys past S being masked
(the reference pads a ragged S and masks the padded keys — the result
is the same); masked scores are NEG_INF = -1e30 and the normalizer is
clamped at 1e-30; the lse variant returns o in fp32 beside the fp32
per-row logsumexp.

For CUDA tensors the forward is the hand-written kernel
``csrc/flash_fwd.cu`` (head_dim 16, 32, 64 or 128; fp32 or bf16), which
never writes attention probabilities to device memory. For CPU tensors
it is :func:`flash_attention_plain`, the same arithmetic in plain
PyTorch. Both sit behind one ``torch.autograd.Function`` whose backward
raises: the backward kernels are not ported yet, and differentiating
the plain version instead would silently change what runs.
"""

from __future__ import annotations

import ctypes
import math

import torch

from pbs_tpu_torch.ops import cuda_build

NEG_INF = -1e30
#: The reference's default block knobs; the CUDA kernel picks its own
#: tiles (32 query rows x 64 keys), so these are validated, not used.
DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_K = 128
KERNEL_HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = (torch.float32, torch.bfloat16)

_BACKWARD_MISSING = (
    "flash attention backward is not ported yet: ROADMAP queue 2, "
    "kernels 2.2 (_bwd_dq_kernel) and 2.3 (_bwd_dkv_kernel)")


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  block_q: int, block_k: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            f"expected q (B,S,H,hd) and k, v (B,S,Hkv,hd); got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, hd = q.shape
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != hd:
        raise ValueError(f"k/v shape {tuple(k.shape)} does not match "
                         f"q {tuple(q.shape)}")
    Hkv = k.shape[2]
    if H % Hkv:
        raise ValueError(f"H={H} not a multiple of Hkv={Hkv}")
    for name, blk in (("block_q", block_q), ("block_k", block_k)):
        if not isinstance(blk, int) or blk <= 0:
            raise ValueError(f"{name} must be a positive int, got {blk!r}")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, causal: bool = True,
                          out_f32: bool = False
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, on any device: fp32 scores
    of sm_scale-scaled queries, NEG_INF masking, the max-shifted
    softmax the online recurrence ends at, o = acc / max(l, 1e-30) and
    lse = m + log(max(l, 1e-30)). Returns (o (B,S,H,hd) in the input
    dtype or fp32, lse (B,S,H,1) fp32)."""
    B, S, H, hd = q.shape
    group = H // k.shape[2]
    sm_scale = 1.0 / math.sqrt(hd)
    qf = q.float().transpose(1, 2) * sm_scale  # (B, H, S, hd)
    kf = k.float().repeat_interleave(group, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(group, dim=2).transpose(1, 2)
    s = qf @ kf.transpose(-1, -2)  # (B, H, S, S)
    if causal:
        pos = torch.arange(S, device=q.device)
        s = s.masked_fill(pos[None, :] > pos[:, None], NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = (p @ vf) / l
    lse = m + torch.log(l)
    o = o.transpose(1, 2).to(torch.float32 if out_f32 else q.dtype)
    return o.contiguous(), lse.transpose(1, 2).contiguous()


def _flash_function():
    lib = cuda_build.load("flash_fwd")
    fn = lib.pbs_flash_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, out_f32: bool = False
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel; raises on any input it does not take."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"q, k, v must share one CUDA device, got "
                         f"{q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash kernel takes fp32 or bf16 q/k/v of one "
                         f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash kernel needs contiguous q, k, v")
    B, S, H, hd = q.shape
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim in "
                         f"{KERNEL_HEAD_DIMS}, got {hd}")
    lib, fn = _flash_function()
    o = torch.empty((B, S, H, hd),
                    dtype=torch.float32 if out_f32 else q.dtype,
                    device=q.device)
    lse = torch.empty((B, S, H, 1), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), B, S, H, k.shape[2], hd, int(causal),
            int(q.dtype == torch.bfloat16), int(out_f32),
            1.0 / math.sqrt(hd), stream)
    cuda_build.check(lib, rc, "flash_fwd")
    flash_attention_cuda.launches += 1
    return o, lse


flash_attention_cuda.launches = 0


class _FlashForward(torch.autograd.Function):
    """Forward through the kernel (CUDA) or the plain version (CPU);
    backward refuses until kernels 2.2 and 2.3 are ported."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, out_f32: bool):
        if q.device.type == "cpu":
            return flash_attention_plain(q, k, v, causal, out_f32)
        return flash_attention_cuda(q, k, v, causal, out_f32)

    @staticmethod
    def backward(ctx, do, dlse):
        raise NotImplementedError(_BACKWARD_MISSING)


def flash_attention(
    q: torch.Tensor,  # (B, S, H, hd)
    k: torch.Tensor,  # (B, S, Hkv, hd)
    v: torch.Tensor,  # (B, S, Hkv, hd)
    causal: bool = True,
    block_q: int = DEFAULT_BLOCK_Q,
    block_k: int = DEFAULT_BLOCK_K,
) -> torch.Tensor:
    """Returns (B, S, H, hd) in the input dtype. GQA: H must be a
    multiple of Hkv. Any S is accepted."""
    _check_shapes(q, k, v, block_q, block_k)
    return _FlashForward.apply(q, k, v, causal, False)[0]


def flash_attention_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    block_q: int = DEFAULT_BLOCK_Q,
    block_k: int = DEFAULT_BLOCK_K,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Like :func:`flash_attention` but also returns the per-row
    logsumexp, shape (B, S, H, 1) fp32 — the combiner state for folding
    independently computed attention partials. o is fp32 so a fold
    accumulates at full precision whatever the compute dtype."""
    _check_shapes(q, k, v, block_q, block_k)
    return _FlashForward.apply(q, k, v, causal, True)
