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
// operand and result traffic, ~40 us at 3.35 TB/s: compute-bound. This
// first kernel multiplies in fp32 on the CUDA cores (no mma/wgmma), so
// it runs well above that bound; the tensor-core version is later work.
//
// Design: the TPU kernel accumulated its counters across a grid that
// runs in order on one core. Hopper blocks run in parallel and in no
// order, so one launch holds two kinds of block. The first
// ceil(M/128)*ceil(N/128) blocks each compute a 128x128 output tile
// (256 threads, 8x8 fp32 register tile per thread, operands staged
// through shared memory in k-steps of 8). The remaining (M/bm)*(K/bk)
// blocks each own one A tile (i,k) of the counting grid: they scan it
// for a non-zero element and add the counts of the N/bn cells (i,j,k)
// that share that A tile with one atomicAdd per counter into the
// vector the wrapper zeroed. Every counting cell is therefore counted
// exactly once, whatever the compute tile, and the counts are
// integers, so their sum does not depend on the order of the atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TM = 128, TN = 128, TK = 8;
constexpr int NTHREADS = 256;  // 16 x 16; each thread an 8x8 output tile

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
  for (int e = threadIdx.x; e < bm * bk && !nonzero; e += NTHREADS) {
    const int r = e / bk, c = e % bk;
    nonzero = to_f(base[(long)r * K + c]) != 0.f;  // -0.0 is zero, NaN is not
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
cudaError_t launch(const void* a, const void* b, void* out, void* stats,
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

}  // namespace

extern "C" {

// a (M,K), b (K,N) contiguous, both fp32 or both bf16 (in_bf16); out
// (M,N) fp32; stats int32[4], zeroed by the caller. bm | M, bn | N,
// bk | K. The *_kib arguments are the per-tile floors of the TPU
// kernel. Returns the launch's cudaError_t (0 on success).
int pbs_instrumented_matmul(const void* a, const void* b, void* out,
                            void* stats, int M, int N, int K, int bm,
                            int bn, int bk, int in_bf16, int a_kib,
                            int b_kib, int o_kib, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || bm <= 0 || bn <= 0 || bk <= 0 ||
      M % bm || N % bn || K % bk)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_bf16)
    return launch<__nv_bfloat16>(a, b, out, stats, M, N, K, bm, bn, bk, a_kib, b_kib, o_kib, st);
  return launch<float>(a, b, out, stats, M, N, K, bm, bn, bk, a_kib, b_kib, o_kib, st);
}

const char* pbs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
