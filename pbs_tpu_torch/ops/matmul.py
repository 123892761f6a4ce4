"""Instrumented matmul: the kernel counts its own work.

The port of ``pbs_tpu.ops.matmul``. Alongside the fp32-accumulated
product, the kernel emits a counter vector over a (bm, bn, bk) counting
grid — tile invocations, all-zero A tiles (from the data), tile read
and write traffic — which the host scales into FLOPs and bytes and the
``CudaBackend`` charges to the job's ledger ahead of any static
estimate, the way perf tooling scales PMC event counts.

For a CUDA tensor :func:`instrumented_matmul` launches the hand-written
kernel (``csrc/instrumented_matmul.cu``) or raises; for a CPU tensor it
runs :func:`instrumented_matmul_plain`, the same function in plain
PyTorch. The counts are integers and equal the TPU kernel's exactly.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from pbs_tpu_torch.ops import cuda_build

DEFAULT_BLOCK = 256

# Stat vector slots (i32; tile counts, not raw flops — the host scales).
STAT_MXU_TILES = 0
STAT_A_ZERO_TILES = 1
STAT_READ_KIB = 2
STAT_WRITE_KIB = 3
N_STATS = 4

_DTYPES = (torch.float32, torch.bfloat16)


@dataclasses.dataclass(frozen=True)
class MatmulStats:
    """Host-scaled view of the kernel's counter vector."""

    mxu_tiles: int
    a_zero_tiles: int
    flops: int  # tiles x 2 x bm x bn x bk (software-scaled, PMC-style)
    hbm_read_bytes: int
    hbm_write_bytes: int

    def metrics(self) -> dict[str, int]:
        """Shape expected by the Job metrics channel (step_fn returning
        ``(state, metrics)``) — lands in DEVICE_FLOPS / HBM_BYTES ledger
        slots via ``CudaBackend._METRIC_KEYS``' outranking rule."""
        return {
            "device_flops": self.flops,
            "hbm_bytes": self.hbm_read_bytes + self.hbm_write_bytes,
        }


def scale_stats(raw, block_m: int, block_n: int, block_k: int) -> MatmulStats:
    """raw: the (N_STATS,) i32 vector from :func:`instrumented_matmul`
    (a tensor on any device, or a sequence of ints)."""
    if isinstance(raw, torch.Tensor):
        raw = raw.tolist()
    tiles = int(raw[STAT_MXU_TILES])
    return MatmulStats(
        mxu_tiles=tiles,
        a_zero_tiles=int(raw[STAT_A_ZERO_TILES]),
        flops=tiles * 2 * block_m * block_n * block_k,
        hbm_read_bytes=int(raw[STAT_READ_KIB]) * 1024,
        hbm_write_bytes=int(raw[STAT_WRITE_KIB]) * 1024,
    )


def _blocks(a: torch.Tensor, b: torch.Tensor, block_m: int, block_n: int,
            block_k: int) -> tuple[int, int, int]:
    """The reference's shape contract: inner dims agree, blocks clamp to
    the dims, and the dims divide by the clamped blocks."""
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"expected 2-D operands, got {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    M, K = a.shape
    K2, N = b.shape
    if K != K2:
        raise ValueError(f"inner dims differ: {K} vs {K2}")
    bm, bn, bk = min(block_m, M), min(block_n, N), min(block_k, K)
    if M % bm or N % bn or K % bk:
        raise ValueError(
            f"shape ({M},{K})x({K},{N}) not divisible by blocks "
            f"({bm},{bn},{bk})")
    return bm, bn, bk


def _tile_kib(a: torch.Tensor, b: torch.Tensor, bm: int, bn: int,
              bk: int) -> tuple[int, int, int]:
    """Per-cell floors of the A, B and (fp32) output tile bytes / 1024."""
    return ((bm * bk * a.element_size()) // 1024,
            (bk * bn * b.element_size()) // 1024,
            (bm * bn * 4) // 1024)


def instrumented_matmul_plain(a: torch.Tensor, b: torch.Tensor,
                              block_m: int = DEFAULT_BLOCK,
                              block_n: int = DEFAULT_BLOCK,
                              block_k: int = DEFAULT_BLOCK
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, on any device: the fp32
    product of the operands (upcast exactly), and the counter vector
    computed from the same tiles the kernel counts."""
    bm, bn, bk = _blocks(a, b, block_m, block_n, block_k)
    M, K = a.shape
    N = b.shape[1]
    out = a.float() @ b.float()
    n_i, n_j, n_k = M // bm, N // bn, K // bk
    tiles = n_i * n_j * n_k
    nonzero = (a != 0).reshape(n_i, bm, n_k, bk).any(dim=3).any(dim=1)
    zero_tiles = int((~nonzero).sum()) * n_j  # once per column block j
    a_kib, b_kib, o_kib = _tile_kib(a, b, bm, bn, bk)
    stats = torch.tensor(
        [tiles, zero_tiles, tiles * (a_kib + b_kib), n_i * n_j * o_kib],
        dtype=torch.int32, device=out.device)
    return out, stats


def _mm_function():
    lib = cuda_build.load("instrumented_matmul")
    fn = lib.pbs_instrumented_matmul
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


def instrumented_matmul_cuda(a: torch.Tensor, b: torch.Tensor, bm: int,
                             bn: int, bk: int
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on validated blocks; raises on any operand
    it does not take."""
    if not (a.is_cuda and b.is_cuda) or a.device != b.device:
        raise ValueError(f"operands must share one CUDA device, got "
                         f"{a.device} and {b.device}")
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise ValueError(f"instrumented_matmul kernel takes fp32 or bf16 "
                         f"operands of one dtype, got {a.dtype}, {b.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("instrumented_matmul kernel needs contiguous operands")
    M, K = a.shape
    N = b.shape[1]
    lib, fn = _mm_function()
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    stats = torch.zeros(N_STATS, dtype=torch.int32, device=a.device)
    a_kib, b_kib, o_kib = _tile_kib(a, b, bm, bn, bk)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), stats.data_ptr(),
            M, N, K, bm, bn, bk, int(a.dtype == torch.bfloat16),
            a_kib, b_kib, o_kib, stream)
    cuda_build.check(lib, rc, "instrumented_matmul")
    instrumented_matmul_cuda.launches += 1
    return out, stats


instrumented_matmul_cuda.launches = 0


def instrumented_matmul(
    a: torch.Tensor,  # (M, K)
    b: torch.Tensor,  # (K, N)
    block_m: int = DEFAULT_BLOCK,
    block_n: int = DEFAULT_BLOCK,
    block_k: int = DEFAULT_BLOCK,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(a @ b, stats)`` — stats is the raw (N_STATS,) i32
    counter vector on the operands' device; scale with
    :func:`scale_stats`. fp32 accumulation whatever the input dtype.
    CUDA operands go to the kernel, CPU operands to the plain version."""
    bm, bn, bk = _blocks(a, b, block_m, block_n, block_k)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return instrumented_matmul_plain(a, b, bm, bn, bk)
    return instrumented_matmul_cuda(a, b, bm, bn, bk)
