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
// Both are compute-bound on paper. These first kernels multiply in fp32
// on the CUDA cores (no mma/wgmma), as flash_fwd.cu does, so they sit
// far from that bound; tensor cores are later work.
//
// Design. No atomics, every output element written by exactly one
// block, so gradients are deterministic:
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
// All tiles are fp32 in shared memory with rows padded by one word, so
// the column walks are bank-conflict free. Inputs are read in the
// caller's (B, S, H, hd) layout and lse (B, S, H, 1); rows at or beyond
// S are never read or written (loaded as zeros, p forced to 0), so the
// wrapper needs no padding, no transpose, and no zero cotangent for
// padded rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
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
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
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
  auto kern = flash_bwd_dq_kernel<T, TD, HD>;
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
  auto kern = flash_bwd_dkv_kernel<T, TD, HD>;
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

cudaError_t dispatch(bool dkv, int hd, int in_bf16, int do_f32, const Args& a) {
  if (a.B <= 0 || a.S <= 0 || a.H <= 0 || a.Hkv <= 0 || a.H % a.Hkv)
    return cudaErrorInvalidValue;
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
// input type. dq (B,S,H,hd) in the input type. Returns the launch's
// cudaError_t (0 on success).
int pbs_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* row,
                     void* dq, int B, int S, int H, int Hkv, int hd,
                     int causal, int in_bf16, int do_f32, float sm_scale,
                     void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(row), dq, nullptr, B, S, H, Hkv,
               causal, sm_scale, static_cast<cudaStream_t>(stream)};
  return dispatch(false, hd, in_bf16, do_f32, a);
}

// As pbs_flash_bwd_dq; dk, dv (B,S,Hkv,hd) in the input type.
int pbs_flash_bwd_dkv(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* row,
                      void* dk, void* dv, int B, int S, int H, int Hkv,
                      int hd, int causal, int in_bf16, int do_f32,
                      float sm_scale, void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(row), dk, dv, B, S, H, Hkv,
               causal, sm_scale, static_cast<cudaStream_t>(stream)};
  return dispatch(true, hd, in_bf16, do_f32, a);
}

const char* pbs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
