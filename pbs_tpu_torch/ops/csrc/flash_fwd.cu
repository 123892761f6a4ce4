// Flash-attention forward for Hopper (sm_90a): causal or full, GQA.
//
// Replaces the TPU kernel `_fwd_kernel` of pbs_tpu/ops/attention.py
// (:70-122, launched by `_fwd_call` :125-158). It computes what that
// kernel computes: per query row, an online softmax over k-tiles
// (running max m, normalizer l, fp32 accumulator), masked entries set
// to NEG_INF = -1e30, keys at or beyond `S` masked, o = acc / max(l,
// 1e-30) and lse = m + log(max(l, 1e-30)). Probabilities never reach
// device memory.
//
// Bound on an H100 at the serving shape (B 4, S 1024, H 16, Hkv 8,
// hd 128, causal, bf16): ~17.2 GFLOP of useful work, ~17 us at the
// bf16 tensor-core peak, against ~50 MB of q/k/v/o/lse traffic, ~15 us
// at 3.35 TB/s: compute-bound on paper. This first kernel does its
// arithmetic in fp32 on the CUDA cores (no mma/wgmma), so it sits far
// from that bound; the tensor-core version is later work.
//
// Design: one block per (q-tile of BQ=32 rows, head, batch); 128
// threads as 8 row-groups x 16 lanes. The kv head is h / (H / Hkv). The
// block loops over k-tiles of BK=64 keys held in shared memory (fp32,
// rows padded by one word so column walks are bank-conflict free),
// visiting under `causal` only the tiles up to its diagonal. Each
// thread owns 4 query rows: a 4x4 register tile of scores and a
// 4 x (hd/16) register tile of the output accumulator, so the row
// max/sum reductions are 16-lane shuffles and m, l never touch shared
// memory. Inputs are read in the caller's (B, S, H, hd) layout, so the
// wrapper needs no transpose or padding copy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 32;        // query rows per block
constexpr int BK = 64;        // keys per k-tile
constexpr int NTHREADS = 128; // 8 row-groups x 16 lanes
constexpr int RPT = BQ / 8;   // query rows per thread
constexpr int CPT = BK / 16;  // score columns per thread
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as XLA and torch cast
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * (HD + 1) + BK * (HD + 1) + BK * HD + BQ * (BK + 1));
}

template <typename T, typename TO, int HD>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, TO* __restrict__ o,
                 float* __restrict__ lse, int S, int H, int Hkv, int causal,
                 float sm_scale) {
  constexpr int QLD = HD + 1;
  constexpr int KLD = HD + 1;
  constexpr int PLD = BK + 1;
  constexpr int DPT = HD / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;             // [BQ][QLD], pre-scaled by sm_scale
  float* Ks = Qs + BQ * QLD;    // [BK][KLD]
  float* Vs = Ks + BK * KLD;    // [BK][HD]
  float* Ps = Vs + BK * HD;     // [BQ][PLD]

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int tx = tid % 16;      // lane within the row-group
  const int ty = tid / 16;      // row-group: rows ty*RPT .. ty*RPT+RPT-1

  const long q_stride = (long)H * HD;    // elements between positions
  const long kv_stride = (long)Hkv * HD;
  const T* qb = q + (long)b * S * q_stride + (long)h * HD;
  const T* kb = k + (long)b * S * kv_stride + (long)hk * HD;
  const T* vb = v + (long)b * S * kv_stride + (long)hk * HD;

  for (int idx = tid; idx < BQ * HD; idx += NTHREADS) {
    const int r = idx / HD, d = idx % HD;
    const int s = q0 + r;
    Qs[r * QLD + d] = s < S ? to_f(qb[s * q_stride + d]) * sm_scale : 0.f;
  }

  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  int n_tiles = (S + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, (q0 + BQ + BK - 1) / BK);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's Ks/Vs/Ps reads are done
    for (int idx = tid; idx < BK * HD; idx += NTHREADS) {
      const int r = idx / HD, d = idx % HD;
      const int s = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (s < S) {
        kx = to_f(kb[s * kv_stride + d]);
        vx = to_f(vb[s * kv_stride + d]);
      }
      Ks[r * KLD + d] = kx;
      Vs[r * HD + d] = vx;
    }
    __syncthreads();

    float sc[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qa[RPT], ka[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qa[i] = Qs[(ty * RPT + i) * QLD + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) ka[j] = Ks[(tx + 16 * j) * KLD + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) sc[i][j] = fmaf(qa[i], ka[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qpos = q0 + ty * RPT + i;
      float rmax = NEG_INF;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kpos = k0 + tx + 16 * j;
        if ((causal && kpos > qpos) || kpos >= S) sc[i][j] = NEG_INF;
        rmax = fmaxf(rmax, sc[i][j]);
      }
      // The 16 lanes of a row-group share rows: reduce across them.
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        sc[i][j] = expf(sc[i][j] - m_new);
        rsum += sc[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + rsum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= alpha;
#pragma unroll
      for (int j = 0; j < CPT; ++j) Ps[(ty * RPT + i) * PLD + tx + 16 * j] = sc[i][j];
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pa[RPT], va[DPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pa[i] = Ps[(ty * RPT + i) * PLD + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) va[j] = Vs[c * HD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[i][j] = fmaf(pa[i], va[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int s = q0 + ty * RPT + i;
    if (s >= S) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    const long row = ((long)b * S + s) * H + h;
    TO* orow = o + row * HD;
#pragma unroll
    for (int j = 0; j < DPT; ++j) orow[tx + 16 * j] = from_f<TO>(acc[i][j] / lc);
    if (tx == 0) lse[row] = m[i] + logf(lc);
  }
}

template <typename T, typename TO, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int S, int H, int Hkv, int causal,
                   float sm_scale, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, TO, HD>;
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<TO*>(o),
      static_cast<float*>(lse), S, H, Hkv, causal, sm_scale);
  return cudaGetLastError();
}

template <typename T, typename TO>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        void* o, void* lse, int B, int S, int H, int Hkv,
                        int causal, float sm_scale, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, TO, 16>(q, k, v, o, lse, B, S, H, Hkv, causal, sm_scale, stream);
    case 32: return launch<T, TO, 32>(q, k, v, o, lse, B, S, H, Hkv, causal, sm_scale, stream);
    case 64: return launch<T, TO, 64>(q, k, v, o, lse, B, S, H, Hkv, causal, sm_scale, stream);
    case 128: return launch<T, TO, 128>(q, k, v, o, lse, B, S, H, Hkv, causal, sm_scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B,S,H,hd), k/v (B,S,Hkv,hd), contiguous, fp32 or bf16 (in_bf16);
// o (B,S,H,hd) in the input type, or fp32 when out_f32; lse (B,S,H) fp32.
// Returns the launch's cudaError_t (0 on success).
int pbs_flash_fwd(const void* q, const void* k, const void* v, void* o,
                  void* lse, int B, int S, int H, int Hkv, int hd,
                  int causal, int in_bf16, int out_f32, float sm_scale,
                  void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Hkv <= 0 || H % Hkv) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!in_bf16)
    return dispatch_hd<float, float>(hd, q, k, v, o, lse, B, S, H, Hkv, causal, sm_scale, st);
  if (out_f32)
    return dispatch_hd<__nv_bfloat16, float>(hd, q, k, v, o, lse, B, S, H, Hkv, causal, sm_scale, st);
  return dispatch_hd<__nv_bfloat16, __nv_bfloat16>(hd, q, k, v, o, lse, B, S, H, Hkv, causal, sm_scale, st);
}

const char* pbs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
