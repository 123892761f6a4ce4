"""Flash attention (causal or full, GQA) for PyTorch, forward and backward.

The port of ``pbs_tpu.ops.attention``. Public functions take
(B, S, H, hd) queries and (B, S, Hkv, hd) keys/values, as the
reference's do, and keep its semantics: H must be a multiple of Hkv
(``ValueError`` otherwise); any S is accepted, keys past S being masked
(the reference pads a ragged S and masks the padded keys — the result
is the same); masked scores are NEG_INF = -1e30 and the normalizer is
clamped at 1e-30; the lse variant returns o in fp32 beside the fp32
per-row logsumexp.

For CUDA tensors the forward is the hand-written kernel
``csrc/flash_fwd.cu`` and the backward the two kernels of
``csrc/flash_bwd.cu`` (a dq pass, and a dk/dv pass that sums the GQA
group in-kernel); head_dim 16, 32, 64 or 128; fp32 or bf16. bf16 inputs
TMA can address run on the tensor cores, the rest on the CUDA cores
(:func:`forward_route`, :func:`backward_route`). Neither
direction writes attention probabilities to device memory: the backward
recomputes p = exp(s - lse) tile by tile. For CPU tensors both
directions are plain PyTorch (:func:`flash_attention_plain`,
:func:`flash_attention_bwd_plain`), the same arithmetic. One
``torch.autograd.Function`` holds them; autograd never differentiates
the plain forward, on either device.
"""

from __future__ import annotations

import ctypes
import math

import torch

from pbs_tpu_torch.ops import cuda_build

NEG_INF = -1e30
#: The reference's default block knobs; the CUDA kernels pick their own
#: tiles, so these are validated, not used.
DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_K = 128
KERNEL_HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = (torch.float32, torch.bfloat16)


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
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


def forward_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The forward kernel's route for these inputs: "wgmma" (tensor
    cores, TMA loads) for bf16 q, k, v that TMA can address, else
    "simt" (fp32 FMAs on the CUDA cores)."""
    ok = all(cuda_build.tma_addressable(t) for t in (q, k, v))
    return "wgmma" if ok else "simt"


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
    route = forward_route(q, k, v)
    lib, fn = _flash_function()
    o = torch.empty((B, S, H, hd),
                    dtype=torch.float32 if out_f32 else q.dtype,
                    device=q.device)
    lse = torch.empty((B, S, H, 1), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), B, S, H, k.shape[2], hd, int(causal),
            int(q.dtype == torch.bfloat16), int(out_f32),
            int(route == "wgmma"), 1.0 / math.sqrt(hd), stream)
    cuda_build.check(lib, rc, f"flash_fwd ({route})")
    flash_attention_cuda.launches += 1
    flash_attention_cuda.launches_by_route[route] += 1
    return o, lse


flash_attention_cuda.launches = 0
flash_attention_cuda.launches_by_route = cuda_build.new_route_counts()


def _row_delta(o: torch.Tensor, do: torch.Tensor,
               dlse: torch.Tensor | None) -> torch.Tensor:
    """(B, S, H) fp32 rowsum(do * o) - dlse: the softmax-jacobian
    diagonal minus the lse output's own cotangent (d lse_i / d s_ij =
    p_ij), so ds = p * (dp - row_delta). A plain reduction, as the
    reference leaves it to XLA."""
    delta = (do.float() * o.float()).sum(dim=-1)
    if dlse is not None:
        delta = delta - dlse.float()[..., 0]
    return delta.contiguous()


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor,
                              dlse: torch.Tensor | None = None,
                              causal: bool = True
                              ) -> tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Plain PyTorch version of the backward kernels, on any device:
    p = exp(s - lse) from the forward's lse (NEG_INF-masked entries give
    0), dp = do v^T, ds = p (dp - delta + dlse), dq = ds k sm_scale,
    dk = ds^T (q sm_scale), dv = p^T do, each GQA group summed into its
    kv head; all in fp32. Returns (dq, dk, dv) in q's, k's, v's dtype."""
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    group = H // Hkv
    sm_scale = 1.0 / math.sqrt(hd)
    qf = q.float().transpose(1, 2) * sm_scale  # (B, H, S, hd)
    kf = k.float().repeat_interleave(group, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(group, dim=2).transpose(1, 2)
    dof = do.float().transpose(1, 2)
    row = _row_delta(o, do, dlse).transpose(1, 2)[..., None]  # (B,H,S,1)
    s = qf @ kf.transpose(-1, -2)  # (B, H, S, S)
    if causal:
        pos = torch.arange(S, device=q.device)
        s = s.masked_fill(pos[None, :] > pos[:, None], NEG_INF)
    p = torch.exp(s - lse.transpose(1, 2))
    ds = p * (dof @ vf.transpose(-1, -2) - row)
    dq = (ds @ kf) * sm_scale
    dk = (ds.transpose(-1, -2) @ qf).reshape(B, Hkv, group, S, hd).sum(2)
    dv = (p.transpose(-1, -2) @ dof).reshape(B, Hkv, group, S, hd).sum(2)
    return (dq.transpose(1, 2).to(q.dtype).contiguous(),
            dk.transpose(1, 2).to(k.dtype).contiguous(),
            dv.transpose(1, 2).to(v.dtype).contiguous())


def _bwd_functions():
    lib = cuda_build.load("flash_bwd")
    dq = lib.pbs_flash_bwd_dq
    dq.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_void_p])
    dq.restype = ctypes.c_int
    dkv = lib.pbs_flash_bwd_dkv
    dkv.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
                    + [ctypes.c_float, ctypes.c_void_p])
    dkv.restype = ctypes.c_int
    return lib, dq, dkv


def _check_bwd_inputs(q, k, v, do, lse, row) -> None:
    """What the backward kernels take: one CUDA device; q/k/v of one
    dtype, fp32 or bf16; do in that dtype or fp32 (the lse variant's o
    is fp32); fp32 lse (B,S,H,1) and row delta (B,S,H); all contiguous;
    head_dim in KERNEL_HEAD_DIMS."""
    ts = (q, k, v, do, lse, row)
    if not (q.is_cuda and all(t.device == q.device for t in ts)):
        raise ValueError("flash backward needs q, k, v, do, lse on one "
                         f"CUDA device, got {[str(t.device) for t in ts]}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash backward takes fp32 or bf16 q/k/v of one "
                         f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if do.dtype not in (q.dtype, torch.float32):
        raise ValueError(f"flash backward takes do in {q.dtype} or fp32, "
                         f"got {do.dtype}")
    if lse.dtype != torch.float32 or row.dtype != torch.float32:
        raise ValueError("flash backward takes fp32 lse and row delta")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("flash backward needs contiguous q, k, v, do, lse")
    B, S, H, hd = q.shape
    if (do.shape != q.shape or lse.shape != (B, S, H, 1)
            or row.shape != (B, S, H)):
        raise ValueError(f"do {tuple(do.shape)}, lse {tuple(lse.shape)}, "
                         f"row delta {tuple(row.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash backward takes head_dim in "
                         f"{KERNEL_HEAD_DIMS}, got {hd}")


def backward_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   do: torch.Tensor) -> str:
    """The backward kernels' route for these inputs: "wgmma" (tensor
    cores, TMA loads) for bf16 q, k, v and a bf16 do that TMA can
    address, else "simt" (fp32 FMAs on the CUDA cores: fp32 inputs, and
    the lse variant's fp32 do)."""
    ok = all(cuda_build.tma_addressable(t) for t in (q, k, v, do))
    return "wgmma" if ok else "simt"


def _bwd_args(q, k, do, causal, route):
    B, S, H, hd = q.shape
    return (B, S, H, k.shape[2], hd, int(causal),
            int(q.dtype == torch.bfloat16),
            int(do.dtype == torch.float32), int(route == "wgmma"),
            1.0 / math.sqrt(hd),
            torch.cuda.current_stream(q.device).cuda_stream)


def flash_attention_bwd_dq_cuda(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, do: torch.Tensor,
                                lse: torch.Tensor, row: torch.Tensor,
                                causal: bool = True) -> torch.Tensor:
    """Launch kernel 2.2 (the dq pass); ``row`` is :func:`_row_delta`.
    Raises on any input it does not take."""
    _check_bwd_inputs(q, k, v, do, lse, row)
    route = backward_route(q, k, v, do)
    lib, fn, _ = _bwd_functions()
    dq = torch.empty_like(q)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), row.data_ptr(), dq.data_ptr(),
            *_bwd_args(q, k, do, causal, route))
    cuda_build.check(lib, rc, f"flash_bwd_dq ({route})")
    flash_attention_bwd_dq_cuda.launches += 1
    flash_attention_bwd_dq_cuda.launches_by_route[route] += 1
    return dq


flash_attention_bwd_dq_cuda.launches = 0
flash_attention_bwd_dq_cuda.launches_by_route = cuda_build.new_route_counts()


def flash_attention_bwd_dkv_cuda(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, do: torch.Tensor,
                                 lse: torch.Tensor, row: torch.Tensor,
                                 causal: bool = True
                                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch kernel 2.3 (the dk/dv pass, GQA group summed in-kernel).
    Raises on any input it does not take."""
    _check_bwd_inputs(q, k, v, do, lse, row)
    route = backward_route(q, k, v, do)
    lib, _, fn = _bwd_functions()
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), row.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *_bwd_args(q, k, do, causal, route))
    cuda_build.check(lib, rc, f"flash_bwd_dkv ({route})")
    flash_attention_bwd_dkv_cuda.launches += 1
    flash_attention_bwd_dkv_cuda.launches_by_route[route] += 1
    return dk, dv


flash_attention_bwd_dkv_cuda.launches = 0
flash_attention_bwd_dkv_cuda.launches_by_route = cuda_build.new_route_counts()


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, dlse: torch.Tensor | None = None,
                        causal: bool = True
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of the flash forward that produced (o, lse), for the
    cotangents do and dlse (None: lse unused). CPU tensors take the plain
    version; any other tensor goes to kernels 2.2 and 2.3 or raises."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, dlse, causal)
    row = _row_delta(o, do, dlse)
    dq = flash_attention_bwd_dq_cuda(q, k, v, do, lse, row, causal)
    dk, dv = flash_attention_bwd_dkv_cuda(q, k, v, do, lse, row, causal)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Forward through kernel 2.1 (CUDA) or the plain version (CPU),
    saving q, k, v, o, lse; backward through kernels 2.2 and 2.3 (CUDA)
    or the plain backward (CPU). o is saved as returned: in the input
    dtype for :func:`flash_attention`, fp32 for the lse variant, as the
    reference's residuals are."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, out_f32: bool):
        if q.device.type == "cpu":
            o, lse = flash_attention_plain(q, k, v, causal, out_f32)
        else:
            o, lse = flash_attention_cuda(q, k, v, causal, out_f32)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        ctx.set_materialize_grads(False)  # None: that output was unused
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        do = torch.zeros_like(o) if do is None else do.contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, dlse,
                                         ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor,  # (B, S, H, hd)
    k: torch.Tensor,  # (B, S, Hkv, hd)
    v: torch.Tensor,  # (B, S, Hkv, hd)
    causal: bool = True,
    block_q: int = DEFAULT_BLOCK_Q,
    block_k: int = DEFAULT_BLOCK_K,
) -> torch.Tensor:
    """Returns (B, S, H, hd) in the input dtype. GQA: H must be a
    multiple of Hkv. Any S is accepted. Differentiable in q, k, v
    (backward kernels 2.2 and 2.3 on the card)."""
    _check_shapes(q, k, v, block_q, block_k)
    return _FlashAttention.apply(q, k, v, causal, False)[0]


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
    accumulates at full precision whatever the compute dtype. The lse
    output takes part in autograd: its cotangent enters ds."""
    _check_shapes(q, k, v, block_q, block_k)
    return _FlashAttention.apply(q, k, v, causal, True)
