// Flash-attention backward for Hopper (sm_90a): causal or full, GQA.
//
// Replaces the TPU kernels `_bwd_dq_kernel` (pbs_tpu/ops/attention.py
// :164-206, launched :297) and `_bwd_dkv_kernel` (:209-265, launched
// :318). Both recompute the probabilities tile by tile from q, k and
// the forward's per-row logsumexp, p = exp(q.k * sm_scale - lse), with
// entries masked by causality or by a key at or beyond S set to 0, and
// never write p or ds to device memory:
//
//   dp = do . v^T,  ds = p * (dp - row),  row = rowsum(do * o) - dlse
//   dq = sm_scale * ds . k                    (pass 1, one q-tile a block)
//   dk = ds^T . (q * sm_scale),  dv = p^T . do  (pass 2, one k-tile a block)
//
// `row` is computed by the wrapper (a plain reduction, as the reference
// leaves it to XLA) and folds the lse cotangent in.
//
// Bound on an H100 at the training path's shape (q (2,1023,16,128),
// k/v (2,1023,8,128), bf16, causal; 523,776 causal pairs per (b, h)):
// pass 1 does ~12.9 GFLOP of useful work (6 hd per pair: q.k, do.v,
// ds.k), ~13 us at the bf16 tensor-core peak, against ~34 MB of traffic
// (~10 us at 3.35 TB/s); pass 2 ~17.2 GFLOP (8 hd per pair), ~17 us.
// Both are compute-bound, so the products belong on the tensor cores.
//
// No atomics in either route: every output element is written by
// exactly one block, so gradients are deterministic. Inputs are read in
// the caller's (B, S, H, hd) layout and lse (B, S, H, 1); rows at or
// beyond S get p = 0 and are never written, so the wrapper needs no
// padding, no transpose, and no zero cotangent for padded rows.
//
// Two routes, chosen by the caller from dtype and alignment:
//
// wgmma (bf16 q, k, v and bf16 do, all of which TMA can address). Three
// warpgroups a block: a producer whose one thread issues TMA 4-D boxes
// over (hd, head, S, B), swizzled at the row's width as in flash_fwd.cu
// (rows past S read as zeros), and two consumers. Products are wgmma
// m64n64k16 chains with both operands in shared memory (K-major) for the
// scores and dp, over unscaled bf16 with fp32 accumulation, scaled after
// in fp32 in the exp2 domain (p = exp2(s * sm_scale * log2 e - lse *
// log2 e)); the gradient products take p or ds from registers (the
// accumulator of one product is the A fragment of the next) and the
// other operand MN-major from the same shared tile. p and ds are split
// into bf16 hi + lo, two products into one accumulator, which keeps the
// fp32-class accuracy the plain backward is held to. The producer gives
// registers to the consumers (setmaxnreg).
// - pass 1: one block per (head, batch, q-tile of 128 rows), the q-tiles
//   with the most causal work launched first; each consumer owns 64 rows.
//   Q and dO are loaded once, K and V tiles of 64 keys move through a
//   2-stage mbarrier ring. S = Q K^T and dP = dO V^T, then dQ += dS K
//   with K read MN-major; dq is scaled by sm_scale at the end.
// - pass 2: one block per (kv head, batch, k-tile of 64 keys), the first
//   k-tiles (most causal work) launched first. K and V are loaded once;
//   Q and dO tiles of 64 rows, for each query head of the GQA group and
//   each q-tile from the diagonal on, move through a 4-stage ring, with
//   their rows' lse and row delta, which the producer warp stages with
//   ordinary loads (a TMA box over them would have 4-byte rows). The two
//   consumers take alternate tiles, both for all 64 keys: S^T = K Q^T and
//   dP^T = V dO^T, then dV += P^T dO and dK += dS^T Q. At the end the
//   second consumer's partial dK and dV go through shared memory to the
//   first, which adds them in a fixed order and stores; dk is scaled by
//   sm_scale there.
//
// simt (fp32 inputs, bf16 inputs with an fp32 do, or bf16 TMA cannot
// address): fp32 FMAs on the CUDA cores, fp32 tiles in shared memory
// with rows padded by one word, so the column walks are bank-conflict
// free.
// - pass 1: one block per (q-tile of 32 rows, head, batch), 128 threads
//   as 8 row-groups x 16 lanes; it loops over k-tiles of 64 keys up to
//   its diagonal (causal), recomputing a 4x4 register tile of s and of
//   dp per thread, staging ds through shared memory, and accumulating a
//   4 x hd/16 register tile of dq.
// - pass 2: one block per (k-tile of 32 keys, kv head, batch); it loops
//   over the GQA group's query heads and, for each, over q-tiles of 32
//   rows from its diagonal on, so the group reduction happens in-kernel.
//   Each thread owns 4 keys: a 4 x hd/16 register tile of dk and of dv.
//   p^T and ds^T are staged through shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int NTHREADS = 128;  // 8 row-groups x 16 lanes

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as XLA and torch cast
}

// -- pass 1: dq -------------------------------------------------------------

constexpr int DQ_BQ = 32;  // query rows per block
constexpr int DQ_BK = 64;  // keys per k-tile

template <int HD>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (2 * DQ_BQ * (HD + 1) + 2 * DQ_BK * (HD + 1) + DQ_BQ * (DQ_BK + 1));
}

template <typename T, typename TD, int HD>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const TD* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ row,
                    T* __restrict__ dq, int S, int H, int Hkv, int causal,
                    float sm_scale) {
  constexpr int LD = HD + 1;
  constexpr int PLD = DQ_BK + 1;
  constexpr int RPT = DQ_BQ / 8;   // query rows per thread
  constexpr int CPT = DQ_BK / 16;  // keys per thread in the score tile
  constexpr int DPT = HD / 16;     // dq columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;               // [BQ][LD], pre-scaled by sm_scale
  float* dOs = Qs + DQ_BQ * LD;   // [BQ][LD]
  float* Ks = dOs + DQ_BQ * LD;   // [BK][LD]
  float* Vs = Ks + DQ_BK * LD;    // [BK][LD]
  float* dSs = Vs + DQ_BK * LD;   // [BQ][PLD]

  const int q0 = blockIdx.x * DQ_BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  const long q_stride = (long)H * HD;  // elements between positions
  const long kv_stride = (long)Hkv * HD;
  const long qoff = (long)b * S * q_stride + (long)h * HD;
  const T* kb = k + (long)b * S * kv_stride + (long)hk * HD;
  const T* vb = v + (long)b * S * kv_stride + (long)hk * HD;

  for (int idx = tid; idx < DQ_BQ * HD; idx += NTHREADS) {
    const int r = idx / HD, d = idx % HD;
    const int s = q0 + r;
    float qx = 0.f, ox = 0.f;
    if (s < S) {
      qx = to_f(q[qoff + s * q_stride + d]) * sm_scale;
      ox = to_f(dout[qoff + s * q_stride + d]);
    }
    Qs[r * LD + d] = qx;
    dOs[r * LD + d] = ox;
  }
  float lse_r[RPT], row_r[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int s = q0 + ty * RPT + i;
    const long st = ((long)b * S + s) * H + h;
    lse_r[i] = s < S ? lse[st] : 0.f;
    row_r[i] = s < S ? row[st] : 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  int n_tiles = (S + DQ_BK - 1) / DQ_BK;
  if (causal) n_tiles = min(n_tiles, (q0 + DQ_BQ + DQ_BK - 1) / DQ_BK);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * DQ_BK;
    __syncthreads();  // the previous tile's Ks/Vs/dSs reads are done
    for (int idx = tid; idx < DQ_BK * HD; idx += NTHREADS) {
      const int r = idx / HD, d = idx % HD;
      const int s = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (s < S) {
        kx = to_f(kb[s * kv_stride + d]);
        vx = to_f(vb[s * kv_stride + d]);
      }
      Ks[r * LD + d] = kx;
      Vs[r * LD + d] = vx;
    }
    __syncthreads();

    float sc[RPT][CPT], dp[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qa[RPT], oa[RPT], ka[CPT], va[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        qa[i] = Qs[(ty * RPT + i) * LD + d];
        oa[i] = dOs[(ty * RPT + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        ka[j] = Ks[(tx + 16 * j) * LD + d];
        va[j] = Vs[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          sc[i][j] = fmaf(qa[i], ka[j], sc[i][j]);
          dp[i][j] = fmaf(oa[i], va[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qpos = q0 + ty * RPT + i;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool keep = kpos < S && qpos < S && !(causal && kpos > qpos);
        const float p = keep ? expf(sc[i][j] - lse_r[i]) : 0.f;
        dSs[(ty * RPT + i) * PLD + tx + 16 * j] = p * (dp[i][j] - row_r[i]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < DQ_BK; ++c) {
      float da[RPT], kc[DPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) da[i] = dSs[(ty * RPT + i) * PLD + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) kc[j] = Ks[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[i][j] = fmaf(da[i], kc[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int s = q0 + ty * RPT + i;
    if (s >= S) continue;
    T* out = dq + qoff + s * q_stride;
#pragma unroll
    for (int j = 0; j < DPT; ++j) out[tx + 16 * j] = from_f<T>(acc[i][j] * sm_scale);
  }
}

// -- pass 2: dk, dv ---------------------------------------------------------

constexpr int KV_BK = 32;  // keys per block
constexpr int KV_BQ = 32;  // query rows per q-tile

template <int HD>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) *
         (2 * KV_BK * (HD + 1) + 2 * KV_BQ * (HD + 1) + 2 * KV_BK * (KV_BQ + 1) + 2 * KV_BQ);
}

template <typename T, typename TD, int HD>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const TD* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ row,
                     T* __restrict__ dk, T* __restrict__ dv, int S, int H,
                     int Hkv, int causal, float sm_scale) {
  constexpr int LD = HD + 1;
  constexpr int PLD = KV_BQ + 1;
  constexpr int KPT = KV_BK / 8;   // keys per thread
  constexpr int QPT = KV_BQ / 16;  // query rows per thread in the score tile
  constexpr int DPT = HD / 16;     // dk/dv columns per thread
  extern __shared__ float smem[];
  float* Ks = smem;              // [BK][LD]
  float* Vs = Ks + KV_BK * LD;   // [BK][LD]
  float* Qs = Vs + KV_BK * LD;   // [BQ][LD], pre-scaled by sm_scale
  float* dOs = Qs + KV_BQ * LD;  // [BQ][LD]
  float* Pt = dOs + KV_BQ * LD;  // [BK][PLD]: p transposed
  float* dSt = Pt + KV_BK * PLD; // [BK][PLD]: ds transposed
  float* Ls = dSt + KV_BK * PLD; // [BQ]: lse of the q-tile's rows
  float* Rs = Ls + KV_BQ;        // [BQ]: row delta of the q-tile's rows

  const int k0 = blockIdx.x * KV_BK;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = H / Hkv;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  const long q_stride = (long)H * HD;
  const long kv_stride = (long)Hkv * HD;
  const long kvoff = (long)b * S * kv_stride + (long)hk * HD;

  for (int idx = tid; idx < KV_BK * HD; idx += NTHREADS) {
    const int r = idx / HD, d = idx % HD;
    const int s = k0 + r;
    float kx = 0.f, vx = 0.f;
    if (s < S) {
      kx = to_f(k[kvoff + s * kv_stride + d]);
      vx = to_f(v[kvoff + s * kv_stride + d]);
    }
    Ks[r * LD + d] = kx;
    Vs[r * LD + d] = vx;
  }
  float dk_acc[KPT][DPT], dv_acc[KPT][DPT];
#pragma unroll
  for (int i = 0; i < KPT; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  const int n_qt = (S + KV_BQ - 1) / KV_BQ;
  const int t0 = causal ? k0 / KV_BQ : 0;  // q-tiles from the diagonal on

  for (int r = 0; r < group; ++r) {
    const int h = hk * group + r;
    const long qoff = (long)b * S * q_stride + (long)h * HD;
    for (int t = t0; t < n_qt; ++t) {
      const int qs0 = t * KV_BQ;
      __syncthreads();  // the previous tile's Qs/dOs/Pt/dSt reads are done
      for (int idx = tid; idx < KV_BQ * HD; idx += NTHREADS) {
        const int rr = idx / HD, d = idx % HD;
        const int s = qs0 + rr;
        float qx = 0.f, ox = 0.f;
        if (s < S) {
          qx = to_f(q[qoff + s * q_stride + d]) * sm_scale;
          ox = to_f(dout[qoff + s * q_stride + d]);
        }
        Qs[rr * LD + d] = qx;
        dOs[rr * LD + d] = ox;
      }
      if (tid < KV_BQ) {
        const int s = qs0 + tid;
        const long st = ((long)b * S + s) * H + h;
        Ls[tid] = s < S ? lse[st] : 0.f;
        Rs[tid] = s < S ? row[st] : 0.f;
      }
      __syncthreads();

      float sc[KPT][QPT], dp[KPT][QPT];
#pragma unroll
      for (int i = 0; i < KPT; ++i)
#pragma unroll
        for (int j = 0; j < QPT; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        float ka[KPT], va[KPT], qa[QPT], oa[QPT];
#pragma unroll
        for (int i = 0; i < KPT; ++i) {
          ka[i] = Ks[(ty * KPT + i) * LD + d];
          va[i] = Vs[(ty * KPT + i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < QPT; ++j) {
          qa[j] = Qs[(tx + 16 * j) * LD + d];
          oa[j] = dOs[(tx + 16 * j) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < KPT; ++i)
#pragma unroll
          for (int j = 0; j < QPT; ++j) {
            sc[i][j] = fmaf(ka[i], qa[j], sc[i][j]);
            dp[i][j] = fmaf(va[i], oa[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < KPT; ++i) {
        const int kpos = k0 + ty * KPT + i;
#pragma unroll
        for (int j = 0; j < QPT; ++j) {
          const int qr = tx + 16 * j;
          const int qpos = qs0 + qr;
          const bool keep = kpos < S && qpos < S && !(causal && kpos > qpos);
          const float p = keep ? expf(sc[i][j] - Ls[qr]) : 0.f;
          Pt[(ty * KPT + i) * PLD + qr] = p;
          dSt[(ty * KPT + i) * PLD + qr] = p * (dp[i][j] - Rs[qr]);
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int c = 0; c < KV_BQ; ++c) {
        float pa[KPT], sa[KPT], oc[DPT], qc[DPT];
#pragma unroll
        for (int i = 0; i < KPT; ++i) {
          pa[i] = Pt[(ty * KPT + i) * PLD + c];
          sa[i] = dSt[(ty * KPT + i) * PLD + c];
        }
#pragma unroll
        for (int j = 0; j < DPT; ++j) {
          oc[j] = dOs[c * LD + tx + 16 * j];
          qc[j] = Qs[c * LD + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < KPT; ++i)
#pragma unroll
          for (int j = 0; j < DPT; ++j) {
            dv_acc[i][j] = fmaf(pa[i], oc[j], dv_acc[i][j]);
            dk_acc[i][j] = fmaf(sa[i], qc[j], dk_acc[i][j]);
          }
      }
    }
  }

  // dk was accumulated against pre-scaled q: the sm_scale factor of
  // d(s)/d(k) is already in, so no extra scaling here.
#pragma unroll
  for (int i = 0; i < KPT; ++i) {
    const int s = k0 + ty * KPT + i;
    if (s >= S) continue;
    const long off = kvoff + s * kv_stride;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      dk[off + tx + 16 * j] = from_f<T>(dk_acc[i][j]);
      dv[off + tx + 16 * j] = from_f<T>(dv_acc[i][j]);
    }
  }
}

// -- wgmma route --------------------------------------------------------------

constexpr float LOG2E = 1.4426950408889634f;
constexpr int TC_THREADS = 384;  // consumers 0, 1; producer 2
// registers per thread after rebalancing: 128 x 40 + 256 x 232 <= 65536
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// Shared tiles as TMA writes them: rows of CW elements swizzled at the
// row's width, one CW-wide column chunk after another (flash_fwd.cu).
template <int HD>
struct Sw {
  static constexpr int CW = HD < 64 ? HD : 64;  // elements per swizzled row
  static constexpr int ROWB = CW * 2;           // 32, 64 or 128 bytes
  static constexpr int SBO = 8 * ROWB;
  static constexpr uint32_t LAYOUT = hopper::layout_of(ROWB);
};

// K-major descriptor of the 16-wide k-slice ks of a tile of `rows` rows
// (the chunk stride), starting at `tile`.
template <int HD>
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int rows, int ks) {
  using W = Sw<HD>;
  return hopper::desc(tile + (ks * 16) / W::CW * rows * W::ROWB + (ks * 16) % W::CW * 2,
                      16, W::SBO, W::LAYOUT);
}

// d(64x64) += A B^T over the head dim: A the 64 rows at `a` of a tile of
// a_rows rows, B the 64 rows at `b` of a tile of b_rows rows, both K-major.
template <int HD>
__device__ __forceinline__ void scores(float (&d)[32], uint32_t a, int a_rows, uint32_t b,
                                       int b_rows) {
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks)
    hopper::wgmma_m64n64_ss_kmajor(d, kmajor<HD>(a, a_rows, ks), kmajor<HD>(b, b_rows, ks));
}

// acc(64 x HD) += X Y: X (64x64, registers, as bf16 hi + lo), Y the 64-row
// tile at `y` read MN-major (the tile that was K-major in `scores`).
template <int HD>
__device__ __forceinline__ void grad_product(float (&acc)[HD / 2], const uint32_t (&hi)[4][4],
                                             const uint32_t (&lo)[4][4], uint32_t y) {
  using W = Sw<HD>;
#pragma unroll
  for (int kt = 0; kt < 4; ++kt) {
    const uint64_t d = hopper::desc(y + kt * 16 * W::ROWB, 64 * W::ROWB, W::SBO, W::LAYOUT);
    hopper::wgmma_rs_mnmajor<HD>(acc, hi[kt], d);
    hopper::wgmma_rs_mnmajor<HD>(acc, lo[kt], d);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.f;
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// -- pass 1 (wgmma): dq

template <int HD>
struct DqTc {
  static constexpr int BQ = 128;     // query rows per block: 2 consumers x 64
  static constexpr int BK = 64;      // keys per k-tile
  static constexpr int STAGES = 2;   // K/V ring depth
  static constexpr int Q_BYTES = BQ * HD * 2;   // Q, and dO
  static constexpr int KV_BYTES = BK * HD * 2;  // K, and V
  static constexpr int BAR_OFF = 2 * Q_BYTES + STAGES * 2 * KV_BYTES;
  static constexpr size_t SMEM = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;  // + alignment slack
};

template <int HD>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const float* __restrict__ lse, const float* __restrict__ row,
                          __nv_bfloat16* __restrict__ dq, int S, int H, int Hkv,
                          int causal, float scale_log2, float sm_scale) {
  using W = Sw<HD>;
  using C = DqTc<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint32_t base = hopper::smem_u32(smem_raw);
  base = (base + 1023) & ~1023u;  // swizzled tiles sit on 1024-byte boundaries
  const uint32_t sQ = base, sdO = base + C::Q_BYTES;
  const uint32_t sKV = base + 2 * C::Q_BYTES;  // stage s: K at +2s*KV_BYTES, V after
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
    hopper::regs_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == 256) {
      hopper::mbar_expect_tx(q_bar, 2 * C::Q_BYTES);
      for (int c = 0; c < HD / W::CW; ++c) {
        hopper::tma_load_4d(sQ + c * C::BQ * W::ROWB, &tm_q, q_bar, c * W::CW, h, q0, b);
        hopper::tma_load_4d(sdO + c * C::BQ * W::ROWB, &tm_do, q_bar, c * W::CW, h, q0, b);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int stage = t % C::STAGES;
        hopper::mbar_wait(empty_bar + 8 * stage, ((t / C::STAGES) & 1) ^ 1);
        const uint32_t full = full_bar + 8 * stage;
        const uint32_t sK = sKV + 2 * stage * C::KV_BYTES;
        hopper::mbar_expect_tx(full, 2 * C::KV_BYTES);
        for (int c = 0; c < HD / W::CW; ++c) {
          hopper::tma_load_4d(sK + c * C::BK * W::ROWB, &tm_k, full, c * W::CW, hk,
                              t * C::BK, b);
          hopper::tma_load_4d(sK + C::KV_BYTES + c * C::BK * W::ROWB, &tm_v, full,
                              c * W::CW, hk, t * C::BK, b);
        }
      }
    }
    return;
  }
  hopper::regs_alloc<CONSUMER_REGS>();

  // consumer warpgroup wg: query rows q0 + 64 wg .. + 63
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int r0 = (tid / 32) * 16 + lane / 4;  // this thread's rows: r0, r0 + 8
  const int qrow[2] = {q0 + wg * 64 + r0, q0 + wg * 64 + r0 + 8};
  const int wg_first = q0 + wg * 64, wg_last = wg_first + 63;
  const int col = 2 * (lane % 4);
  float lse2[2], rd[2];  // lse * log2(e) (+inf past S: p = 0) and row delta
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long st = ((long)b * S + qrow[r]) * H + h;
    lse2[r] = qrow[r] < S ? lse[st] * LOG2E : inf_f();
    rd[r] = qrow[r] < S ? row[st] : 0.f;
  }
  float acc[HD / 2];
  zero(acc);

  hopper::mbar_wait(q_bar, 0);
  const uint32_t sQw = sQ + wg * 64 * W::ROWB, sdOw = sdO + wg * 64 * W::ROWB;

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t % C::STAGES;
    hopper::mbar_wait(full_bar + 8 * stage, (t / C::STAGES) & 1);
    const int k0 = t * C::BK;
    if (!causal || k0 <= wg_last) {
      const uint32_t sK = sKV + 2 * stage * C::KV_BYTES;
      const uint32_t sV = sK + C::KV_BYTES;
      float s[32], dp[32];
      zero(s);
      zero(dp);
      hopper::fence_regs(s);
      hopper::fence_regs(dp);
      hopper::wgmma_fence();
      scores<HD>(s, sQw, C::BQ, sK, C::BK);    // S = Q K^T
      scores<HD>(dp, sdOw, C::BQ, sV, C::BK);  // dP = dO V^T
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);
      hopper::fence_regs(dp);

      const bool need_mask = k0 + C::BK > S || (causal && k0 + C::BK - 1 > wg_first);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e, r = e >> 1;
          float p = exp2f(fmaf(s[i], scale_log2, -lse2[r]));
          if (need_mask) {
            const int kpos = k0 + 8 * j + col + (e & 1);
            if (kpos >= S || (causal && kpos > qrow[r])) p = 0.f;
          }
          s[i] = p * (dp[i] - rd[r]);  // ds
        }
      uint32_t hi[4][4], lo[4][4];
      hopper::split_bf16(s, hi, lo);
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
      grad_product<HD>(acc, hi, lo, sK);  // dQ += dS K
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
    }
    hopper::mbar_arrive(empty_bar + 8 * stage);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qrow[r] >= S) continue;
    __nv_bfloat16* out = dq + (((long)b * S + qrow[r]) * H + h) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      store_pair(out + 8 * j + col, acc[4 * j + 2 * r] * sm_scale,
                 acc[4 * j + 2 * r + 1] * sm_scale);
  }
}

// -- pass 2 (wgmma): dk, dv

template <int HD>
struct DkvTc {
  static constexpr int BK = 64;      // keys per block, shared by both consumers
  static constexpr int BQ = 64;      // query rows per ring tile
  static constexpr int STAGES = 4;   // tile i in stage i % 4, for consumer i % 2
  static constexpr int KV_BYTES = BK * HD * 2;    // K, and V
  static constexpr int TILE_BYTES = BQ * HD * 2;  // Q, and dO
  static constexpr int STAGE_BYTES = 2 * TILE_BYTES;
  static constexpr int RING_OFF = 2 * KV_BYTES;
  // per stage: BQ floats of lse * log2(e), then BQ of row delta
  static constexpr int ROWS_OFF = RING_OFF + STAGES * STAGE_BYTES;
  static constexpr int BAR_OFF = ROWS_OFF + STAGES * 2 * BQ * 4;
  static constexpr size_t SMEM = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;  // + alignment slack
  // the second consumer's partial dK and dV pass through the ring at the end
  static_assert(2 * (HD / 2) * 128 * 4 <= STAGES * STAGE_BYTES, "partials fit in the ring");
};

template <int HD>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_do,
                           const float* __restrict__ lse, const float* __restrict__ row,
                           __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                           int S, int H, int Hkv, int causal, float scale_log2,
                           float sm_scale) {
  using W = Sw<HD>;
  using C = DkvTc<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // swizzled tiles on 1024-byte boundaries
  uint8_t* const gbase = smem_raw + (base - raw);  // the same bytes, generic pointer
  const uint32_t sK = base, sV = base + C::KV_BYTES;
  const uint32_t sRing = base + C::RING_OFF;  // stage s: Q at +s*STAGE_BYTES, dO after
  float* const rows_s = reinterpret_cast<float*>(gbase + C::ROWS_OFF);
  const uint32_t kv_bar = base + C::BAR_OFF;
  const uint32_t full_bar = kv_bar + 8;                 // + 8 * stage
  const uint32_t empty_bar = full_bar + 8 * C::STAGES;  // + 8 * stage

  const int hk = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * C::BK;  // the first k-tiles, most causal work, first
  const int group = H / Hkv;
  const int n_qt = (S + C::BQ - 1) / C::BQ;
  const int t0 = causal ? k0 / C::BQ : 0;  // q-tiles from the diagonal on
  const int per_head = n_qt - t0;
  const int n_items = group * per_head;    // item i: head i / per_head, q-tile t0 + i % per_head

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_bar, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      hopper::mbar_init(full_bar + 8 * s, 32);    // the producer warp
      hopper::mbar_init(empty_bar + 8 * s, 128);  // the one consumer of the stage's tile
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // producer warp: lane 0 issues TMA, all 32 stage lse and row
    hopper::regs_dealloc<PRODUCER_REGS>();
    if (threadIdx.x < 256 + 32) {
      const int lane = threadIdx.x % 32;
      if (lane == 0) {
        hopper::mbar_expect_tx(kv_bar, 2 * C::KV_BYTES);
        for (int c = 0; c < HD / W::CW; ++c) {
          hopper::tma_load_4d(sK + c * C::BK * W::ROWB, &tm_k, kv_bar, c * W::CW, hk, k0, b);
          hopper::tma_load_4d(sV + c * C::BK * W::ROWB, &tm_v, kv_bar, c * W::CW, hk, k0, b);
        }
      }
      for (int it = 0; it < n_items; ++it) {
        const int stage = it % C::STAGES;
        hopper::mbar_wait(empty_bar + 8 * stage, ((it / C::STAGES) & 1) ^ 1);
        const int h = hk * group + it / per_head;
        const int qs0 = (t0 + it % per_head) * C::BQ;
        float* L = rows_s + stage * 2 * C::BQ;
        for (int rr = lane; rr < C::BQ; rr += 32) {
          const int s = qs0 + rr;
          const long st = ((long)b * S + s) * H + h;
          L[rr] = s < S ? lse[st] * LOG2E : inf_f();  // p = 0 past S
          L[C::BQ + rr] = s < S ? row[st] : 0.f;
        }
        const uint32_t full = full_bar + 8 * stage;
        if (lane == 0) {  // its arrival carries the TMA byte count
          const uint32_t sQ = sRing + stage * C::STAGE_BYTES;
          hopper::mbar_expect_tx(full, C::STAGE_BYTES);
          for (int c = 0; c < HD / W::CW; ++c) {
            hopper::tma_load_4d(sQ + c * C::BQ * W::ROWB, &tm_q, full, c * W::CW, h, qs0, b);
            hopper::tma_load_4d(sQ + C::TILE_BYTES + c * C::BQ * W::ROWB, &tm_do, full,
                                c * W::CW, h, qs0, b);
          }
        } else {
          hopper::mbar_arrive(full);
        }
      }
    }
    return;
  }
  hopper::regs_alloc<CONSUMER_REGS>();

  // consumer warpgroup wg: the tiles it, it % 2 == wg, for all 64 keys
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int r0 = (tid / 32) * 16 + lane / 4;  // this thread's keys: k0 + r0, + 8
  const int col = 2 * (lane % 4);
  float dk_acc[HD / 2], dv_acc[HD / 2];
  zero(dk_acc);
  zero(dv_acc);

  hopper::mbar_wait(kv_bar, 0);
  for (int it = wg; it < n_items; it += 2) {
    const int stage = it % C::STAGES;
    hopper::mbar_wait(full_bar + 8 * stage, (it / C::STAGES) & 1);
    const int qs0 = (t0 + it % per_head) * C::BQ;
    const uint32_t sQ = sRing + stage * C::STAGE_BYTES, sdO = sQ + C::TILE_BYTES;
    const float* L = rows_s + stage * 2 * C::BQ;
    float st[32], dpt[32];
    zero(st);
    zero(dpt);
    hopper::fence_regs(st);
    hopper::fence_regs(dpt);
    hopper::wgmma_fence();
    scores<HD>(st, sK, C::BK, sQ, C::BQ);    // S^T = K Q^T
    scores<HD>(dpt, sV, C::BK, sdO, C::BQ);  // dP^T = V dO^T
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(st);
    hopper::fence_regs(dpt);

    const bool need_mask = k0 + C::BK > S || (causal && qs0 < k0 + C::BK - 1);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int qc = 8 * j + col;  // this thread's query columns qc, qc + 1
      const float2 l2 = *reinterpret_cast<const float2*>(L + qc);
      const float2 d2 = *reinterpret_cast<const float2*>(L + C::BQ + qc);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        float p = exp2f(fmaf(st[i], scale_log2, -((e & 1) ? l2.y : l2.x)));
        if (need_mask) {
          const int key = k0 + r0 + 8 * (e >> 1), q = qs0 + qc + (e & 1);
          if (key >= S || (causal && key > q)) p = 0.f;
        }
        dpt[i] = p * (dpt[i] - ((e & 1) ? d2.y : d2.x));  // ds^T
        st[i] = p;                                        // p^T
      }
    }
    uint32_t phi[4][4], plo[4][4], dhi[4][4], dlo[4][4];
    hopper::split_bf16(st, phi, plo);
    hopper::split_bf16(dpt, dhi, dlo);
    hopper::fence_regs(dv_acc);
    hopper::fence_regs(dk_acc);
    hopper::wgmma_fence();
    grad_product<HD>(dv_acc, phi, plo, sdO);  // dV += P^T dO
    grad_product<HD>(dk_acc, dhi, dlo, sQ);   // dK += dS^T Q
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dv_acc);
    hopper::fence_regs(dk_acc);
    hopper::mbar_arrive(empty_bar + 8 * stage);
  }

  // Sum the two consumers' partials in a fixed order: consumer 1 hands its
  // registers to consumer 0 through the ring, which holds no live tile once
  // both have finished (every loaded tile was waited for and consumed).
  float* const part = reinterpret_cast<float*>(gbase + C::RING_OFF);
  hopper::bar_sync(1, 256);
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) {
      part[i * 128 + tid] = dk_acc[i];
      part[(HD / 2 + i) * 128 + tid] = dv_acc[i];
    }
  }
  hopper::bar_sync(1, 256);
  if (wg == 1) return;
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) {
    dk_acc[i] += part[i * 128 + tid];
    dv_acc[i] += part[(HD / 2 + i) * 128 + tid];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + r0 + 8 * r;
    if (key >= S) continue;
    const long off = (((long)b * S + key) * Hkv + hk) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int c = 8 * j + col, a = 4 * j + 2 * r;
      store_pair(dk + off + c, dk_acc[a] * sm_scale, dk_acc[a + 1] * sm_scale);
      store_pair(dv + off + c, dv_acc[a], dv_acc[a + 1]);
    }
  }
}

// -- launch -----------------------------------------------------------------

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* row;
  void* out0;  // dq, or dk
  void* out1;  // dv (pass 2 only)
  int B, S, H, Hkv, causal;
  float sm_scale;
  cudaStream_t stream;
};

template <typename T, typename TD, int HD>
cudaError_t launch_dq(const Args& a) {
  auto kern = flash_bwd_dq_simt_kernel<T, TD, HD>;
  const size_t smem = dq_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + DQ_BQ - 1) / DQ_BQ, a.H, a.B);
  kern<<<grid, NTHREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const TD*>(a.dout), a.lse,
      a.row, static_cast<T*>(a.out0), a.S, a.H, a.Hkv, a.causal, a.sm_scale);
  return cudaGetLastError();
}

template <typename T, typename TD, int HD>
cudaError_t launch_dkv(const Args& a) {
  auto kern = flash_bwd_dkv_simt_kernel<T, TD, HD>;
  const size_t smem = dkv_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + KV_BK - 1) / KV_BK, a.Hkv, a.B);
  kern<<<grid, NTHREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const TD*>(a.dout), a.lse,
      a.row, static_cast<T*>(a.out0), static_cast<T*>(a.out1), a.S, a.H,
      a.Hkv, a.causal, a.sm_scale);
  return cudaGetLastError();
}

template <typename T, typename TD>
cudaError_t dispatch_hd(bool dkv, int hd, const Args& a) {
  switch (hd) {
    case 16: return dkv ? launch_dkv<T, TD, 16>(a) : launch_dq<T, TD, 16>(a);
    case 32: return dkv ? launch_dkv<T, TD, 32>(a) : launch_dq<T, TD, 32>(a);
    case 64: return dkv ? launch_dkv<T, TD, 64>(a) : launch_dq<T, TD, 64>(a);
    case 128: return dkv ? launch_dkv<T, TD, 128>(a) : launch_dq<T, TD, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

// TMA maps over q and do (B,S,H,hd) in boxes of q_rows rows and over k and
// v (B,S,Hkv,hd) in boxes of kv_rows rows, CW columns each.
struct Maps {
  CUtensorMap q, k, v, dout;
};

template <int HD>
cudaError_t make_maps(const Args& a, int q_rows, int kv_rows, Maps* m) {
  constexpr uint32_t CW = Sw<HD>::CW;
  const uint64_t B = a.B, S = a.S, H = a.H, Hkv = a.Hkv;
  const uint64_t qdims[4] = {HD, H, S, B};
  const uint64_t qstr[3] = {HD * 2, H * HD * 2, S * H * HD * 2};
  const uint64_t kdims[4] = {HD, Hkv, S, B};
  const uint64_t kstr[3] = {HD * 2, Hkv * HD * 2, S * Hkv * HD * 2};
  const uint32_t qbox[4] = {CW, 1, (uint32_t)q_rows, 1};
  const uint32_t kbox[4] = {CW, 1, (uint32_t)kv_rows, 1};
  cudaError_t err = hopper::make_map(&m->q, 4, a.q, qdims, qstr, qbox);
  if (err == cudaSuccess) err = hopper::make_map(&m->dout, 4, a.dout, qdims, qstr, qbox);
  if (err == cudaSuccess) err = hopper::make_map(&m->k, 4, a.k, kdims, kstr, kbox);
  if (err == cudaSuccess) err = hopper::make_map(&m->v, 4, a.v, kdims, kstr, kbox);
  return err;
}

template <int HD>
cudaError_t launch_dq_wgmma(const Args& a) {
  using C = DqTc<HD>;
  Maps m;
  cudaError_t err = make_maps<HD>(a, C::BQ, C::BK, &m);
  if (err != cudaSuccess) return err;
  auto kern = flash_bwd_dq_wgmma_kernel<HD>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.H, a.B, (a.S + C::BQ - 1) / C::BQ);
  kern<<<grid, TC_THREADS, C::SMEM, a.stream>>>(
      m.q, m.k, m.v, m.dout, a.lse, a.row, static_cast<__nv_bfloat16*>(a.out0),
      a.S, a.H, a.Hkv, a.causal, a.sm_scale * LOG2E, a.sm_scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dkv_wgmma(const Args& a) {
  using C = DkvTc<HD>;
  Maps m;
  cudaError_t err = make_maps<HD>(a, C::BQ, C::BK, &m);
  if (err != cudaSuccess) return err;
  auto kern = flash_bwd_dkv_wgmma_kernel<HD>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.Hkv, a.B, (a.S + C::BK - 1) / C::BK);
  kern<<<grid, TC_THREADS, C::SMEM, a.stream>>>(
      m.q, m.k, m.v, m.dout, a.lse, a.row, static_cast<__nv_bfloat16*>(a.out0),
      static_cast<__nv_bfloat16*>(a.out1), a.S, a.H, a.Hkv, a.causal,
      a.sm_scale * LOG2E, a.sm_scale);
  return cudaGetLastError();
}

cudaError_t dispatch_wgmma(bool dkv, int hd, const Args& a) {
  switch (hd) {
    case 16: return dkv ? launch_dkv_wgmma<16>(a) : launch_dq_wgmma<16>(a);
    case 32: return dkv ? launch_dkv_wgmma<32>(a) : launch_dq_wgmma<32>(a);
    case 64: return dkv ? launch_dkv_wgmma<64>(a) : launch_dq_wgmma<64>(a);
    case 128: return dkv ? launch_dkv_wgmma<128>(a) : launch_dq_wgmma<128>(a);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch(bool dkv, int hd, int in_bf16, int do_f32, int wgmma,
                     const Args& a) {
  if (a.B <= 0 || a.S <= 0 || a.H <= 0 || a.Hkv <= 0 || a.H % a.Hkv)
    return cudaErrorInvalidValue;
  if (wgmma) {  // bf16 q, k, v and do on 16-byte aligned bases only
    const uintptr_t bases = (uintptr_t)a.q | (uintptr_t)a.k | (uintptr_t)a.v |
                            (uintptr_t)a.dout;
    if (!in_bf16 || do_f32 || bases % 16) return cudaErrorInvalidValue;
    return dispatch_wgmma(dkv, hd, a);
  }
  if (!in_bf16) {
    if (!do_f32) return cudaErrorInvalidValue;  // fp32 inputs take fp32 do
    return dispatch_hd<float, float>(dkv, hd, a);
  }
  if (do_f32) return dispatch_hd<__nv_bfloat16, float>(dkv, hd, a);
  return dispatch_hd<__nv_bfloat16, __nv_bfloat16>(dkv, hd, a);
}

}  // namespace

extern "C" {

// q, do (B,S,H,hd); k, v (B,S,Hkv,hd); lse (B,S,H) and row (B,S,H) fp32;
// all contiguous. q/k/v fp32 or bf16 (in_bf16); do fp32 (do_f32) or the
// input type. dq (B,S,H,hd) in the input type. wgmma selects the
// tensor-core route: bf16 q/k/v and bf16 do, 16-byte aligned (refused
// otherwise, never swapped for the other route). Returns the launch's
// cudaError_t (0 on success).
int pbs_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* row,
                     void* dq, int B, int S, int H, int Hkv, int hd,
                     int causal, int in_bf16, int do_f32, int wgmma,
                     float sm_scale, void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(row), dq, nullptr, B, S, H, Hkv,
               causal, sm_scale, static_cast<cudaStream_t>(stream)};
  return dispatch(false, hd, in_bf16, do_f32, wgmma, a);
}

// As pbs_flash_bwd_dq; dk, dv (B,S,Hkv,hd) in the input type.
int pbs_flash_bwd_dkv(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* row,
                      void* dk, void* dv, int B, int S, int H, int Hkv,
                      int hd, int causal, int in_bf16, int do_f32, int wgmma,
                      float sm_scale, void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(row), dk, dv, B, S, H, Hkv,
               causal, sm_scale, static_cast<cudaStream_t>(stream)};
  return dispatch(true, hd, in_bf16, do_f32, wgmma, a);
}

const char* pbs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
