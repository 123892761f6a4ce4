// Flash-attention forward for Hopper (sm_90a): causal or full, GQA.
//
// Replaces the TPU kernel `_fwd_kernel` of pbs_tpu/ops/attention.py
// (:70-122, launched by `_fwd_call` :125-158). It computes what that
// kernel computes: per query row, an online softmax over k-tiles
// (running max m, normalizer l, fp32 accumulator), masked entries set
// to NEG_INF = -1e30, keys at or beyond `S` masked, o = acc / max(l,
// 1e-30) and lse = m + log(max(l, 1e-30)). Probabilities never reach
// device memory. Inputs are read in the caller's (B, S, H, hd) layout:
// no transpose, no padding copy.
//
// Bound on an H100 at the serving shape (B 4, S 1024, H 16, Hkv 8,
// hd 128, causal, bf16): ~17.2 GFLOP of useful work, ~17 us at the
// bf16 tensor-core peak, against ~50 MB of q/k/v/o/lse traffic, ~15 us
// at 3.35 TB/s: compute-bound, so the products belong on the tensor
// cores.
//
// Two routes, chosen by the caller from dtype and alignment:
//
// wgmma (bf16 q/k/v whose base pointers TMA can address): one block per
// (head, batch, q-tile of BQ = 128 rows), the q-tiles with the most
// causal work launched first. Three warpgroups: a producer whose one
// thread issues TMA loads, and two consumers of 64 query rows each,
// which own their rows' m and l in registers. Q is loaded once; K and V
// tiles of BK = 64 keys move through a ring of 2 shared-memory stages
// guarded by mbarriers (full: TMA bytes landed; empty: both consumers
// done). TMA reads 4-D boxes over (hd, head, S, B), swizzled at the
// row's width (128 bytes at hd 64 and 128, 64 at hd 32, 32 at hd 16),
// and zero-fills rows past S; their scores are still masked to NEG_INF.
// S = Q K^T is one wgmma m64n64k16 chain per consumer over unscaled
// bf16 q and k with fp32 accumulation, scaled afterwards in fp32 (the
// reference scales q in fp32 first; scaled bf16 q is not representable).
// The online softmax runs in registers in the exp2 domain (log2(e)
// folded into the scale). P V is wgmma with P from registers and V from
// shared memory (MN-major, transpose flag): p is split into bf16 hi =
// bf16(p) and lo = bf16(p - hi), two products into one accumulator, so
// P V keeps ~2^-17 relative accuracy for 1.5x the tensor work of one
// bf16 product. o and lse are stored from registers, masked at S.
//
// simt (fp32 inputs, or bf16 TMA cannot address): one block per
// (q-tile of 32 rows, head, batch); 128 threads as 8 row-groups x 16
// lanes, fp32 FMAs on the CUDA cores over K/V tiles of 64 keys staged
// in shared memory, each thread a 4x4 score tile and a 4 x (hd/16)
// output tile, row reductions by 16-lane shuffles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

// simt route
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
flash_fwd_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
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
cudaError_t launch_simt(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int S, int H, int Hkv, int causal,
                   float sm_scale, cudaStream_t stream) {
  auto kern = flash_fwd_simt_kernel<T, TO, HD>;
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

// ---- wgmma route -----------------------------------------------------------

template <int HD>
struct Tc {
  static constexpr int BQ = 128;       // query rows per block: 2 consumers x 64
  static constexpr int BK = 64;        // keys per k-tile
  static constexpr int STAGES = 2;     // K/V ring depth
  static constexpr int NTHREADS = 384; // consumers 0, 1; producer 2
  static constexpr int CW = HD < 64 ? HD : 64;  // elements per swizzled row
  static constexpr int ROWB = CW * 2;           // 32, 64 or 128 bytes
  static constexpr int Q_CHUNK = BQ * ROWB;     // one CW-wide column chunk
  static constexpr int KV_CHUNK = BK * ROWB;
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int KV_BYTES = BK * HD * 2;
  static constexpr int SBO = 8 * ROWB;
  static constexpr uint32_t LAYOUT = hopper::layout_of(ROWB);
  static constexpr int BAR_OFF = Q_BYTES + STAGES * 2 * KV_BYTES;
  static constexpr size_t SMEM = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;  // + alignment slack
};

__device__ __forceinline__ void store_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

template <typename TO, int HD>
__global__ void __launch_bounds__(Tc<HD>::NTHREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       TO* __restrict__ o, float* __restrict__ lse, int S,
                       int H, int Hkv, int causal, float scale_log2) {
  using C = Tc<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint32_t base = hopper::smem_u32(smem_raw);
  base = (base + 1023) & ~1023u;  // swizzled tiles sit on 1024-byte boundaries
  const uint32_t sQ = base;
  const uint32_t sKV = base + C::Q_BYTES;  // stage s: K at +2s*KV_BYTES, V after
  const uint32_t q_bar = base + C::BAR_OFF;
  const uint32_t full_bar = q_bar + 8;                  // + 8 * stage
  const uint32_t empty_bar = full_bar + 8 * C::STAGES;  // + 8 * stage

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * C::BQ;  // longest causal tiles first
  const int hk = h / (H / Hkv);
  int n_tiles = (S + C::BK - 1) / C::BK;
  if (causal) n_tiles = min(n_tiles, (q0 + C::BQ + C::BK - 1) / C::BK);

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_bar, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      hopper::mbar_init(full_bar + 8 * s, 1);
      hopper::mbar_init(empty_bar + 8 * s, 256);  // every consumer thread
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // producer: one thread issues every load
    if (threadIdx.x == 256) {
      hopper::mbar_expect_tx(q_bar, C::Q_BYTES);
      for (int c = 0; c < HD / C::CW; ++c)
        hopper::tma_load_4d(sQ + c * C::Q_CHUNK, &tm_q, q_bar, c * C::CW, h, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int stage = t % C::STAGES;
        const uint32_t round = t / C::STAGES;
        hopper::mbar_wait(empty_bar + 8 * stage, (round & 1) ^ 1);
        const uint32_t full = full_bar + 8 * stage;
        const uint32_t sK = sKV + 2 * stage * C::KV_BYTES;
        hopper::mbar_expect_tx(full, 2 * C::KV_BYTES);
        for (int c = 0; c < HD / C::CW; ++c) {
          hopper::tma_load_4d(sK + c * C::KV_CHUNK, &tm_k, full, c * C::CW, hk,
                              t * C::BK, b);
          hopper::tma_load_4d(sK + C::KV_BYTES + c * C::KV_CHUNK, &tm_v, full,
                              c * C::CW, hk, t * C::BK, b);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: query rows q0 + 64 wg .. + 63
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int r0 = (tid / 32) * 16 + lane / 4;  // this thread's rows: r0, r0 + 8
  const int qrow[2] = {q0 + wg * 64 + r0, q0 + wg * 64 + r0 + 8};
  const int wg_first = q0 + wg * 64, wg_last = wg_first + 63;
  const int col = 2 * (lane % 4);

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums

  hopper::mbar_wait(q_bar, 0);
  const uint32_t sQw = sQ + wg * 64 * C::ROWB;

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t % C::STAGES;
    hopper::mbar_wait(full_bar + 8 * stage, (t / C::STAGES) & 1);
    const int k0 = t * C::BK;
    if (!causal || k0 <= wg_last) {
      const uint32_t sK = sKV + 2 * stage * C::KV_BYTES;
      const uint32_t sV = sK + C::KV_BYTES;
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      hopper::fence_regs(s);
      hopper::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks) {
        const uint32_t off = (ks * 16) / C::CW * C::Q_CHUNK + (ks * 16) % C::CW * 2;
        const uint32_t koff = (ks * 16) / C::CW * C::KV_CHUNK + (ks * 16) % C::CW * 2;
        hopper::wgmma_m64n64_ss_kmajor(
            s, hopper::desc(sQw + off, 16, C::SBO, C::LAYOUT),
            hopper::desc(sK + koff, 16, C::SBO, C::LAYOUT));
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);

      const bool need_mask = k0 + C::BK > S || (causal && k0 + C::BK - 1 > wg_first);
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[4 * j + e] * scale_log2;
          if (need_mask) {
            const int kpos = k0 + 8 * j + col + (e & 1);
            if (kpos >= S || (causal && kpos > qrow[e >> 1])) x = NEG_INF;
          }
          s[4 * j + e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // the four lanes of a quad share a row
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = exp2f(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float p = exp2f(s[i] - m[(i >> 1) & 1]);
        l[(i >> 1) & 1] += p;
        s[i] = p;
      }
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

      // p as bf16 hi + lo, in the register-operand pattern of the
      // accumulator: 16-key slice kt is accumulator columns 16kt..16kt+15.
      uint32_t hi[4][4], lo[4][4];
      hopper::split_bf16(s, hi, lo);
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kt = 0; kt < 4; ++kt) {
        const uint64_t dv = hopper::desc(sV + kt * 16 * C::ROWB, C::KV_CHUNK, C::SBO, C::LAYOUT);
        hopper::wgmma_rs_mnmajor<HD>(acc, hi[kt], dv);
        hopper::wgmma_rs_mnmajor<HD>(acc, lo[kt], dv);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
    }
    hopper::mbar_arrive(empty_bar + 8 * stage);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qrow[r] >= S) continue;
    const float lc = fmaxf(l[r], 1e-30f);
    const long row = ((long)b * S + qrow[r]) * H + h;
    TO* orow = o + row * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      store_pair(orow + 8 * j + col, acc[4 * j + 2 * r] / lc, acc[4 * j + 2 * r + 1] / lc);
    if (lane % 4 == 0) lse[row] = m[r] * 0.69314718055994530942f + logf(lc);
  }
}

template <typename TO, int HD>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o,
                         void* lse, int B, int S, int H, int Hkv, int causal,
                         float sm_scale, cudaStream_t stream) {
  using C = Tc<HD>;
  CUtensorMap tq, tk, tv;
  const uint64_t qdims[4] = {(uint64_t)HD, (uint64_t)H, (uint64_t)S, (uint64_t)B};
  const uint64_t qstr[3] = {(uint64_t)HD * 2, (uint64_t)H * HD * 2, (uint64_t)S * H * HD * 2};
  const uint64_t kdims[4] = {(uint64_t)HD, (uint64_t)Hkv, (uint64_t)S, (uint64_t)B};
  const uint64_t kstr[3] = {(uint64_t)HD * 2, (uint64_t)Hkv * HD * 2, (uint64_t)S * Hkv * HD * 2};
  const uint32_t qbox[4] = {(uint32_t)C::CW, 1, (uint32_t)C::BQ, 1};
  const uint32_t kbox[4] = {(uint32_t)C::CW, 1, (uint32_t)C::BK, 1};
  cudaError_t err = hopper::make_map(&tq, 4, q, qdims, qstr, qbox);
  if (err == cudaSuccess) err = hopper::make_map(&tk, 4, k, kdims, kstr, kbox);
  if (err == cudaSuccess) err = hopper::make_map(&tv, 4, v, kdims, kstr, kbox);
  if (err != cudaSuccess) return err;
  auto kern = flash_fwd_wgmma_kernel<TO, HD>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, B, (S + C::BQ - 1) / C::BQ);
  kern<<<grid, C::NTHREADS, C::SMEM, stream>>>(
      tq, tk, tv, static_cast<TO*>(o), static_cast<float*>(lse), S, H, Hkv,
      causal, sm_scale * 1.4426950408889634f);
  return cudaGetLastError();
}

template <typename T, typename TO>
cudaError_t dispatch_hd(int hd, int wgmma, const void* q, const void* k,
                        const void* v, void* o, void* lse, int B, int S, int H,
                        int Hkv, int causal, float sm_scale, cudaStream_t st) {
#define PBS_FWD_CASE(HD)                                                         \
  case HD:                                                                      \
    if constexpr (sizeof(T) == 2) {                                             \
      if (wgmma)                                                                \
        return launch_wgmma<TO, HD>(q, k, v, o, lse, B, S, H, Hkv, causal, sm_scale, st); \
    }                                                                           \
    return launch_simt<T, TO, HD>(q, k, v, o, lse, B, S, H, Hkv, causal, sm_scale, st);
  switch (hd) {
    PBS_FWD_CASE(16)
    PBS_FWD_CASE(32)
    PBS_FWD_CASE(64)
    PBS_FWD_CASE(128)
    default: return cudaErrorInvalidValue;
  }
#undef PBS_FWD_CASE
}

}  // namespace

extern "C" {

// q (B,S,H,hd), k/v (B,S,Hkv,hd), contiguous, fp32 or bf16 (in_bf16);
// o (B,S,H,hd) in the input type, or fp32 when out_f32; lse (B,S,H) fp32.
// wgmma selects the tensor-core route: bf16 only, q/k/v 16-byte aligned
// (refused otherwise, never swapped for the other route). Returns the
// launch's cudaError_t (0 on success).
int pbs_flash_fwd(const void* q, const void* k, const void* v, void* o,
                  void* lse, int B, int S, int H, int Hkv, int hd,
                  int causal, int in_bf16, int out_f32, int wgmma,
                  float sm_scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Hkv <= 0 || H % Hkv) return cudaErrorInvalidValue;
  if (wgmma && (!in_bf16 || ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!in_bf16)
    return dispatch_hd<float, float>(hd, 0, q, k, v, o, lse, B, S, H, Hkv, causal, sm_scale, st);
  if (out_f32)
    return dispatch_hd<__nv_bfloat16, float>(hd, wgmma, q, k, v, o, lse, B, S, H, Hkv, causal, sm_scale, st);
  return dispatch_hd<__nv_bfloat16, __nv_bfloat16>(hd, wgmma, q, k, v, o, lse, B, S, H, Hkv, causal, sm_scale, st);
}

const char* pbs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
