// Instrumented matmul for Hopper (sm_90a): the kernel counts its own work.
//
// Replaces the TPU kernel `_mm_kernel` of pbs_tpu/ops/matmul.py (:43-75,
// launched by `instrumented_matmul` :110-155): an fp32-accumulated
// (M,K)x(K,N) product of fp32 or bf16 operands, plus an int32[4]
// counter vector over the (bm, bn, bk) counting grid, equal to the TPU
// kernel's: [0] grid cells (i,j,k); [1] cells whose A tile (i,k) is
// all zero, counted from the data, once per column block j; [2] per
// cell floor(A-tile bytes/1024) + floor(B-tile bytes/1024); [3] per
// finished (i,j) floor(out-tile bytes/1024).
//
// Bound on an H100 at the tenant's shape (4096^3, bf16 in, fp32 out):
// 137 GFLOP, ~139 us at the bf16 tensor-core peak, against ~134 MB of
// operand and result traffic, ~40 us at 3.35 TB/s: compute-bound, so the
// product belongs on the tensor cores.
//
// Counting: the TPU kernel accumulated its counters across a grid that
// runs in order on one core. Hopper blocks run in parallel and in no
// order, so (M/bm)*(K/bk) counting blocks each own one A tile (i,k) of
// the counting grid: they scan it for a non-zero element and add the
// counts of the N/bn cells (i,j,k) that share that A tile with one
// atomicAdd per counter into the vector the wrapper zeroed. Every
// counting cell is counted exactly once, whatever the compute tile, and
// the counts are integers, so their sum does not depend on the order of
// the atomics.
//
// Two routes for the product, chosen by the caller from dtype and
// alignment:
//
// wgmma (bf16 operands TMA can address: 16-byte aligned bases, K and N
// multiples of 8): one block per 128x256 output tile, three warpgroups.
// A producer thread issues TMA loads of A (128 x 64, K-major) and B
// (64 x 256 as four 64-column boxes; B is (K, N) row-major, so MN-major
// for wgmma, read with the transpose flag, no copy) into a 4-stage ring
// (192 KB) with 128-byte swizzle, guarded by full/empty mbarriers. The
// producer warpgroup gives up registers (setmaxnreg) so that the two
// consumer warpgroups can hold 64x256 fp32 accumulators each; they run
// wgmma m64n256k16 over their 64 rows, keeping one k-tile's products in
// flight while the next tile's are issued, and
// write fp32 from registers, masked at the ragged M and N edges; TMA
// zero-fills the ragged K. The counting blocks run as a second launch
// on the same stream.
//
// simt (fp32 operands, or bf16 shapes TMA cannot take, e.g. K = 12):
// one launch of ceil(M/128)*ceil(N/128) compute blocks (256 threads,
// 8x8 fp32 register tile per thread, operands staged through shared
// memory in k-steps of 8, fp32 FMAs on the CUDA cores) followed in the
// same grid by the counting blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

// simt route
constexpr int TM = 128, TN = 128, TK = 8;
constexpr int NTHREADS = 256;  // 16 x 16; each thread an 8x8 output tile
constexpr int SCAN_UNROLL = 8; // 16-byte loads in flight per counting thread

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ void gemm_tile(const T* __restrict__ a, const T* __restrict__ b,
                          float* __restrict__ out, int M, int N, int K,
                          int tile) {
  __shared__ float As[TK][TM];  // A tile, k-major
  __shared__ float Bs[TK][TN];
  const int grid_n = (N + TN - 1) / TN;
  const int row0 = (tile / grid_n) * TM;
  const int col0 = (tile % grid_n) * TN;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += TK) {
    for (int e = tid; e < TM * TK; e += NTHREADS) {
      const int r = e / TK, kk = e % TK;
      const int gr = row0 + r, gk = k0 + kk;
      As[kk][r] = (gr < M && gk < K) ? to_f(a[(long)gr * K + gk]) : 0.f;
    }
    for (int e = tid; e < TK * TN; e += NTHREADS) {
      const int kk = e / TN, c = e % TN;
      const int gk = k0 + kk, gc = col0 + c;
      Bs[kk][c] = (gk < K && gc < N) ? to_f(b[(long)gk * N + gc]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      float ar[8], br[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) ar[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) br[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c < N) out[(long)r * N + c] = acc[i][j];
    }
  }
}

template <typename T>
__device__ void count_a_tile(const T* __restrict__ a, int* __restrict__ stats,
                             int N, int K, int bm, int bn, int bk, int a_kib,
                             int b_kib, int o_kib, int cell) {
  const int n_k = K / bk;
  const int i = cell / n_k, kb = cell % n_k;
  const T* base = a + (long)i * bm * K + (long)kb * bk;
  int nonzero = 0;
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  if (bk % VEC == 0 && K % VEC == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0) {
    // 16-byte loads, SCAN_UNROLL in flight per thread before each test: an
    // all-zero tile (the case that reads every element) costs a few
    // memory latencies, not one per element. An element is zero when its
    // bits other than the sign are (-0.0 is zero, NaN is not).
    constexpr uint32_t MAG = sizeof(T) == 2 ? 0x7FFF7FFFu : 0x7FFFFFFFu;
    const int per_row = bk / VEC, nv = bm * per_row;
    for (int v0 = threadIdx.x; v0 < nv && !nonzero; v0 += SCAN_UNROLL * NTHREADS) {
      uint32_t bits = 0;
#pragma unroll
      for (int u = 0; u < SCAN_UNROLL; ++u) {
        const int v = v0 + u * NTHREADS;
        if (v < nv) {
          const uint4 w = *reinterpret_cast<const uint4*>(
              base + (long)(v / per_row) * K + (v % per_row) * VEC);
          bits |= (w.x & MAG) | (w.y & MAG) | (w.z & MAG) | (w.w & MAG);
        }
      }
      nonzero = bits != 0;
    }
  } else {
    for (int e = threadIdx.x; e < bm * bk && !nonzero; e += NTHREADS) {
      const int r = e / bk, c = e % bk;
      nonzero = to_f(base[(long)r * K + c]) != 0.f;  // -0.0 is zero, NaN is not
    }
  }
  nonzero = __syncthreads_or(nonzero);
  if (threadIdx.x == 0) {
    const int n_j = N / bn;  // the cells (i, j, kb) that read this A tile
    atomicAdd(&stats[0], n_j);
    if (!nonzero) atomicAdd(&stats[1], n_j);
    atomicAdd(&stats[2], n_j * (a_kib + b_kib));
    if (kb == n_k - 1) atomicAdd(&stats[3], n_j * o_kib);  // (i, j) finished
  }
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
instrumented_mm_kernel(const T* __restrict__ a, const T* __restrict__ b,
                       float* __restrict__ out, int* __restrict__ stats,
                       int M, int N, int K, int n_gemm_blocks, int bm,
                       int bn, int bk, int a_kib, int b_kib, int o_kib) {
  if ((int)blockIdx.x < n_gemm_blocks) {
    gemm_tile<T>(a, b, out, M, N, K, blockIdx.x);
  } else {
    count_a_tile<T>(a, stats, N, K, bm, bn, bk, a_kib, b_kib, o_kib,
                    blockIdx.x - n_gemm_blocks);
  }
}

template <typename T>
cudaError_t launch_simt(const void* a, const void* b, void* out, void* stats,
                   int M, int N, int K, int bm, int bn, int bk, int a_kib,
                   int b_kib, int o_kib, cudaStream_t stream) {
  const long n_gemm = (long)((M + TM - 1) / TM) * ((N + TN - 1) / TN);
  const long n_count = (long)(M / bm) * (K / bk);
  if (n_gemm + n_count > 0x7fffffffL) return cudaErrorInvalidConfiguration;
  instrumented_mm_kernel<T><<<(unsigned)(n_gemm + n_count), NTHREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<float*>(out), static_cast<int*>(stats), M, N, K,
      (int)n_gemm, bm, bn, bk, a_kib, b_kib, o_kib);
  return cudaGetLastError();
}

// ---- wgmma route -----------------------------------------------------------

namespace tc {
constexpr int BM = 128, BN = 256, BK = 64, STAGES = 4;
constexpr int NTHREADS = 384;              // consumers 0, 1; producer 2
constexpr int A_BYTES = BM * BK * 2;       // 128 rows x 128 bytes
constexpr int B_CHUNK = BK * 64 * 2;       // 64 k-rows x 64 columns
constexpr int B_CHUNKS = BN / 64;
constexpr int STAGE_BYTES = A_BYTES + B_CHUNKS * B_CHUNK;
// registers per thread after rebalancing: 128 x 40 + 256 x 232 <= 65536
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int BAR_OFF = STAGES * STAGE_BYTES;
constexpr size_t SMEM = BAR_OFF + 16 * STAGES + 1024;  // + alignment slack
}  // namespace tc

__global__ void __launch_bounds__(tc::NTHREADS, 1)
mm_wgmma_kernel(const __grid_constant__ CUtensorMap tm_a,
                const __grid_constant__ CUtensorMap tm_b,
                float* __restrict__ out, int M, int N, int K) {
  using namespace tc;
  extern __shared__ uint8_t smem_raw[];
  uint32_t base = hopper::smem_u32(smem_raw);
  base = (base + 1023) & ~1023u;  // swizzled tiles sit on 1024-byte boundaries
  const uint32_t full_bar = base + BAR_OFF;          // + 8 * stage
  const uint32_t empty_bar = full_bar + 8 * STAGES;  // + 8 * stage
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int n_k = (K + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(full_bar + 8 * s, 1);
      hopper::mbar_init(empty_bar + 8 * s, 256);  // every consumer thread
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // producer: one thread issues every load
    hopper::regs_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == 256) {
      for (int kt = 0; kt < n_k; ++kt) {
        const int stage = kt % STAGES;
        hopper::mbar_wait(empty_bar + 8 * stage, ((kt / STAGES) & 1) ^ 1);
        const uint32_t full = full_bar + 8 * stage;
        const uint32_t sA = base + stage * STAGE_BYTES;
        hopper::mbar_expect_tx(full, STAGE_BYTES);
        hopper::tma_load_2d(sA, &tm_a, full, kt * BK, m0);
        for (int c = 0; c < B_CHUNKS; ++c)
          hopper::tma_load_2d(sA + A_BYTES + c * B_CHUNK, &tm_b, full, n0 + 64 * c, kt * BK);
      }
    }
    return;
  }

  hopper::regs_alloc<CONSUMER_REGS>();
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < n_k; ++kt) {
    const int stage = kt % STAGES;
    hopper::mbar_wait(full_bar + 8 * stage, (kt / STAGES) & 1);
    const uint32_t sA = base + stage * STAGE_BYTES + wg * 64 * 128;
    const uint32_t sB = base + stage * STAGE_BYTES + A_BYTES;
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks)
      hopper::wgmma_m64n256_ss_mnmajor(
          acc, hopper::desc(sA + ks * 32, 16, 1024, 1),
          hopper::desc(sB + ks * 16 * 128, B_CHUNK, 1024, 1));
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();  // k-tile kt-1's products are done: free its stage
    hopper::fence_regs(acc);
    if (kt > 0) hopper::mbar_arrive(empty_bar + 8 * ((kt - 1) % STAGES));
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);

  const int lane = threadIdx.x % 32;
  const int row = m0 + wg * 64 + (threadIdx.x % 128) / 32 * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = n0 + 8 * j + 2 * (lane % 4);
    if (c >= N) continue;  // N % 8 == 0 on this route: c + 1 < N too
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row + 8 * r < M)
        *reinterpret_cast<float2*>(out + (long)(row + 8 * r) * N + c) =
            make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
  }
}

cudaError_t launch_wgmma(const void* a, const void* b, void* out, void* stats,
                         int M, int N, int K, int bm, int bn, int bk,
                         int a_kib, int b_kib, int o_kib, cudaStream_t stream) {
  CUtensorMap ta, tb;
  const uint64_t adims[2] = {(uint64_t)K, (uint64_t)M};
  const uint64_t astr[1] = {(uint64_t)K * 2};
  const uint32_t abox[2] = {tc::BK, tc::BM};
  const uint64_t bdims[2] = {(uint64_t)N, (uint64_t)K};
  const uint64_t bstr[1] = {(uint64_t)N * 2};
  const uint32_t bbox[2] = {64, tc::BK};  // one 64-column chunk of the tile
  cudaError_t err = hopper::make_map(&ta, 2, a, adims, astr, abox);
  if (err == cudaSuccess) err = hopper::make_map(&tb, 2, b, bdims, bstr, bbox);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(mm_wgmma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)tc::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + tc::BN - 1) / tc::BN, (M + tc::BM - 1) / tc::BM);
  mm_wgmma_kernel<<<grid, tc::NTHREADS, tc::SMEM, stream>>>(
      ta, tb, static_cast<float*>(out), M, N, K);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the counting blocks alone: no compute blocks in this grid
  const long n_count = (long)(M / bm) * (K / bk);
  if (n_count > 0x7fffffffL) return cudaErrorInvalidConfiguration;
  instrumented_mm_kernel<__nv_bfloat16><<<(unsigned)n_count, NTHREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
      static_cast<float*>(out), static_cast<int*>(stats), M, N, K, 0, bm, bn,
      bk, a_kib, b_kib, o_kib);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// a (M,K), b (K,N) contiguous, both fp32 or both bf16 (in_bf16); out
// (M,N) fp32; stats int32[4], zeroed by the caller. bm | M, bn | N,
// bk | K. The *_kib arguments are the per-tile floors of the TPU
// kernel. wgmma selects the tensor-core route: bf16 only, 16-byte
// aligned bases, K % 8 == 0 and N % 8 == 0 (refused otherwise, never
// swapped for the other route). Returns the launch's cudaError_t (0 on
// success).
int pbs_instrumented_matmul(const void* a, const void* b, void* out,
                            void* stats, int M, int N, int K, int bm,
                            int bn, int bk, int in_bf16, int wgmma,
                            int a_kib, int b_kib, int o_kib, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || bm <= 0 || bn <= 0 || bk <= 0 ||
      M % bm || N % bn || K % bk)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wgmma) {
    if (!in_bf16 || ((uintptr_t)a | (uintptr_t)b) % 16 || K % 8 || N % 8)
      return cudaErrorInvalidValue;
    return launch_wgmma(a, b, out, stats, M, N, K, bm, bn, bk, a_kib, b_kib, o_kib, st);
  }
  if (in_bf16)
    return launch_simt<__nv_bfloat16>(a, b, out, stats, M, N, K, bm, bn, bk, a_kib, b_kib, o_kib, st);
  return launch_simt<float>(a, b, out, stats, M, N, K, bm, bn, bk, a_kib, b_kib, o_kib, st);
}

const char* pbs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
