// Flash attention, forward and backward, for Hopper (sm_90a), behind a
// plain C interface that paddle_tpu_torch/ops/fa_kernel.py loads through
// ctypes.
//
// Replaces three TPU kernels of paddle_tpu/ops/pallas/_fa_kernel.py, the
// arms the LLaMA training step runs (no mask, no segment ids, no dropout,
// Sq == Sk):
//   K1 _fa_fwd_kernel     (pallas_call at _fa_kernel.py:540): online-softmax
//      forward, causal k-loop bound, GQA (query head h reads kv head
//      h / G), optional log-sum-exp output;
//   K2 _fa_bwd_dq_kernel  (pallas_call at _fa_kernel.py:811): p = exp(s -
//      lse), ds = p * (dp - delta), dq += ds K scale;
//   K3 _fa_bwd_dkv_kernel (pallas_call at _fa_kernel.py:862): dv += p^T dO,
//      dk += ds^T Q scale, summed over the G query heads of a kv head.
// Same semantics. Where the scale is applied: the backward kernels scale
// s after the dot (as the TPU kernels do); the CUDA-core forward scales q
// before its dot (as the TPU forward does), the tensor-core forward, which
// the bf16 training path runs, scales s after its dot (equal up to
// float32 ulps: the bf16 q stays unrounded for the mma). A row's output is
// acc / max(l, 1e-30) and its lse m + log(max(l, 1e-30)); delta =
// rowsum(dO * O) (minus dlse) is computed by the caller.
//
// Layouts: q, o, dO [B, S, H, D], k, v [B, S, HKV, D], contiguous, read
// and written in place with strides (no [B*H, S, D] transposes); lse and
// delta [B, H, S] float32. bf16 or float32 in, outputs in the input type.
//
// What bounds it on this card: operations. Causal attention at the
// training step's shape (B 4, S 2048, H 32, D 128) does 4*B*H*S^2*D/2 =
// 1.37e11 flops forward (K2 three products of that size, K3 four) over
// about 0.3 GB of q/k/v/o: ~450 flops a byte, above the ~295 where the
// tensor cores rather than HBM become the limit. The bound is 0.139 ms
// (K1), 0.208 ms (K2), 0.278 ms (K3) at 989 TFLOP/s.
//
// What the design does about that: every intermediate stays out of
// device memory (scores, probabilities and the online-softmax state live
// in shared memory and registers; only q/k/v/o/lse/delta and the
// gradients touch HBM), tiles above the causal diagonal are skipped, and
// K/V stay at their own head count (never repeated in memory; K3 reads a
// kv tile once for its whole GQA group). Two forms of each kernel, chosen
// by dtype and head_dim:
//   - bf16 at head_dim 64 or 128 (the training path): the products run
//     on the tensor cores through mma.sync (bf16 in, float32 accumulate),
//     four warps of 16 rows each;
//   - float32 (float32 math, no TF32) and head_dim 256: the products run
//     on the CUDA cores in float32, 256 threads each owning a 4 x 4 block
//     of scores and a 4 x D/16 block of the accumulator.
// Neither uses wgmma or TMA yet: a ring of TMA-fed tiles consumed by
// wgmma is the next lever. Rows and keys past a ragged S are masked in
// the kernel, so any S is taken.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

enum DType { kF32 = 0, kBF16 = 1 };

constexpr int kThreads = 256;  // a 16 x 16 grid: ty = tid / 16, tx = tid % 16

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Reductions over the 16 threads that share a row (tx = lane bits 0..3).
__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Tiles: 64 x 64 for D 64 and 128, 32 x 32 for D 256 (shared memory).
template <int D>
struct Tile {
  static constexpr int BQ = 64, BK = 64;
};
template <>
struct Tile<256> {
  static constexpr int BQ = 32, BK = 32;
};

__device__ __forceinline__ long long row_off(int b, int s, int h, int S,
                                             int heads, int D) {
  return ((static_cast<long long>(b) * S + s) * heads + h) * D;
}

// Rows [s0, s0 + ROWS) of head h of X [B, S, heads, D], times mul, into
// dst[r * pitch + d] (row-major) or dst[d * pitch + r] (transposed);
// rows past S are zeros.
template <typename T, int D, int ROWS, bool kTransposed>
__device__ __forceinline__ void load_rows(float* dst, int pitch,
                                          const T* __restrict__ X, int b,
                                          int s0, int h, int S, int heads,
                                          float mul) {
  for (int idx = threadIdx.x; idx < ROWS * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int s = s0 + r;
    const float x =
        s < S ? to_float(X[row_off(b, s, h, S, heads, D) + d]) * mul : 0.f;
    dst[kTransposed ? d * pitch + r : r * pitch + d] = x;
  }
}

// -- K1: forward -------------------------------------------------------------
// One block per (q tile, head, batch). Thread (ty, tx) owns query rows
// ty + 16 i, key columns tx + 16 j of each score tile, and output columns
// tx + 16 e.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ out,
                  float* __restrict__ lse, int S, int H, int HKV,
                  float scale, int causal) {
  constexpr int BQ = Tile<D>::BQ, BK = Tile<D>::BK;
  constexpr int RI = BQ / 16, CJ = BK / 16, E = D / 16;
  constexpr int QP = D + 1, KP = BK + 1, PP = BK + 1;
  extern __shared__ float smem[];
  float* Qs = smem;            // [BQ][QP]  q * scale
  float* Kt = Qs + BQ * QP;    // [D][KP]   K transposed
  float* Vs = Kt + D * KP;     // [BK][D]
  float* Ps = Vs + BK * D;     // [BQ][PP]  probabilities of the tile

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / HKV);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  load_rows<T, D, BQ, false>(Qs, QP, q, b, q0, h, S, H, scale);

  float m[RI], l[RI], acc[RI][E];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;  // this thread's share of the row sum
#pragma unroll
    for (int e = 0; e < E; ++e) acc[i][e] = 0.f;
  }

  const int n_all = (S + BK - 1) / BK;
  const int n_kt = causal ? min(n_all, (q0 + BQ + BK - 1) / BK) : n_all;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the last tile's readers are done
    load_rows<T, D, BK, true>(Kt, KP, k, b, k0, hk, S, HKV, 1.f);
    load_rows<T, D, BK, false>(Vs, D, v, b, k0, hk, S, HKV, 1.f);
    __syncthreads();

    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RI], kv[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) qv[i] = Qs[(ty + 16 * i) * QP + d];
#pragma unroll
      for (int j = 0; j < CJ; ++j) kv[j] = Kt[d * KP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = q0 + ty + 16 * i;
      float mb = -INFINITY;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int c = k0 + tx + 16 * j;
        if (c >= S || (causal && c > r)) s[i][j] = -INFINITY;
        mb = fmaxf(mb, s[i][j]);
      }
      mb = row_max16(mb);
      const float mn = fmaxf(m[i], mb);
      const float ms = mn == -INFINITY ? 0.f : mn;  // rows masked so far
      const float corr = expf(m[i] - ms);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float p = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - ms);
        Ps[(ty + 16 * i) * PP + tx + 16 * j] = p;
        ps += p;
      }
      l[i] = l[i] * corr + ps;
      m[i] = mn;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[i][e] *= corr;
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pv[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) pv[i] = Ps[(ty + 16 * i) * PP + j];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float vv = Vs[j * D + tx + 16 * e];
#pragma unroll
        for (int i = 0; i < RI; ++i) acc[i][e] = fmaf(pv[i], vv, acc[i][e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const float lt = fmaxf(row_sum16(l[i]), 1e-30f);
    const int r = q0 + ty + 16 * i;
    if (r < S) {
      T* orow = out + row_off(b, r, h, S, H, D);
#pragma unroll
      for (int e = 0; e < E; ++e)
        orow[tx + 16 * e] = from_float<T>(acc[i][e] / lt);
      if (lse != nullptr && tx == 0)
        lse[(static_cast<long long>(b) * H + h) * S + r] = m[i] + logf(lt);
    }
  }
}

// -- K2: dq ------------------------------------------------------------------
// One block per (q tile, head, batch), over the k tiles at or below the
// diagonal. Thread (ty, tx) owns rows ty + 16 i, key columns tx + 16 j and
// dq columns tx + 16 e; dq is accumulated in float32 and cast on store.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dq,
                     int S, int H, int HKV, float scale, int causal) {
  constexpr int BQ = Tile<D>::BQ, BK = Tile<D>::BK;
  constexpr int RI = BQ / 16, CJ = BK / 16, E = D / 16;
  constexpr int QP = D + 1, KP = BK + 1, PP = BK + 1;
  extern __shared__ float smem[];
  float* Qs = smem;             // [BQ][QP]
  float* dOs = Qs + BQ * QP;    // [BQ][QP]
  float* Kt = dOs + BQ * QP;    // [D][KP]
  float* Vt = Kt + D * KP;      // [D][KP]
  float* dSs = Vt + D * KP;     // [BQ][PP]

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / HKV);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  load_rows<T, D, BQ, false>(Qs, QP, q, b, q0, h, S, H, 1.f);
  load_rows<T, D, BQ, false>(dOs, QP, dout, b, q0, h, S, H, 1.f);

  const long long st = (static_cast<long long>(b) * H + h) * S;
  float lse_r[RI], del_r[RI], dqa[RI][E];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = q0 + ty + 16 * i;
    lse_r[i] = r < S ? lse[st + r] : 0.f;
    del_r[i] = r < S ? delta[st + r] : 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) dqa[i][e] = 0.f;
  }

  const int n_all = (S + BK - 1) / BK;
  const int n_kt = causal ? min(n_all, (q0 + BQ + BK - 1) / BK) : n_all;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_rows<T, D, BK, true>(Kt, KP, k, b, k0, hk, S, HKV, 1.f);
    load_rows<T, D, BK, true>(Vt, KP, v, b, k0, hk, S, HKV, 1.f);
    __syncthreads();

    float s[RI][CJ], dp[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RI], ov[RI], kv[CJ], vv[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        qv[i] = Qs[(ty + 16 * i) * QP + d];
        ov[i] = dOs[(ty + 16 * i) * QP + d];
      }
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        kv[j] = Kt[d * KP + tx + 16 * j];
        vv[j] = Vt[d * KP + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int c = k0 + tx + 16 * j;
        const bool live = c < S && !(causal && c > r);
        const float p = live ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        dSs[(ty + 16 * i) * PP + tx + 16 * j] = p * (dp[i][j] - del_r[i]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float dsv[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) dsv[i] = dSs[(ty + 16 * i) * PP + c];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float kk = Kt[(tx + 16 * e) * KP + c];
#pragma unroll
        for (int i = 0; i < RI; ++i) dqa[i][e] = fmaf(dsv[i], kk, dqa[i][e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r < S) {
      T* row = dq + row_off(b, r, h, S, H, D);
#pragma unroll
      for (int e = 0; e < E; ++e)
        row[tx + 16 * e] = from_float<T>(dqa[i][e] * scale);
    }
  }
}

// -- K3: dk, dv --------------------------------------------------------------
// One block per (k tile, kv head, batch). The TPU kernel accumulated across
// its innermost grid axis (query head of the group, q tile); here that is
// a loop inside the block, so dk/dv stay in registers with no atomics.
// Thread (ty, tx) owns key rows ty + 16 j, query columns tx + 16 i of each
// score tile and dk/dv columns tx + 16 e.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    fa_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int S, int H, int HKV, float scale,
                      int causal) {
  constexpr int BQ = Tile<D>::BQ, BK = Tile<D>::BK;
  constexpr int RI = BQ / 16, CJ = BK / 16, E = D / 16;
  constexpr int KP = D + 1, QTP = BQ + 1;
  extern __shared__ float smem[];
  float* Ks = smem;              // [BK][KP]
  float* Vs = Ks + BK * KP;      // [BK][KP]
  float* Qt = Vs + BK * KP;      // [D][QTP]  Q transposed
  float* dOt = Qt + D * QTP;     // [D][QTP]  dO transposed
  float* Pt = dOt + D * QTP;     // [BK][QTP] p transposed
  float* dSt = Pt + BK * QTP;    // [BK][QTP] ds transposed
  float* lse_s = dSt + BK * QTP;  // [BQ]
  float* del_s = lse_s + BQ;      // [BQ]

  const int k0 = blockIdx.x * BK, hk = blockIdx.y, b = blockIdx.z;
  const int G = H / HKV;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  load_rows<T, D, BK, false>(Ks, KP, k, b, k0, hk, S, HKV, 1.f);
  load_rows<T, D, BK, false>(Vs, KP, v, b, k0, hk, S, HKV, 1.f);

  float dka[CJ][E], dva[CJ][E];
#pragma unroll
  for (int j = 0; j < CJ; ++j)
#pragma unroll
    for (int e = 0; e < E; ++e) dka[j][e] = dva[j][e] = 0.f;

  const int n_qt = (S + BQ - 1) / BQ;
  const int qt0 = causal ? k0 / BQ : 0;  // q tiles from the diagonal on
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const long long st = (static_cast<long long>(b) * H + h) * S;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();
      load_rows<T, D, BQ, true>(Qt, QTP, q, b, q0, h, S, H, 1.f);
      load_rows<T, D, BQ, true>(dOt, QTP, dout, b, q0, h, S, H, 1.f);
      for (int r = threadIdx.x; r < BQ; r += kThreads) {
        lse_s[r] = q0 + r < S ? lse[st + q0 + r] : 0.f;
        del_s[r] = q0 + r < S ? delta[st + q0 + r] : 0.f;
      }
      __syncthreads();

      float s[CJ][RI], dp[CJ][RI];
#pragma unroll
      for (int j = 0; j < CJ; ++j)
#pragma unroll
        for (int i = 0; i < RI; ++i) s[j][i] = dp[j][i] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kv[CJ], vv[CJ], qv[RI], ov[RI];
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          kv[j] = Ks[(ty + 16 * j) * KP + d];
          vv[j] = Vs[(ty + 16 * j) * KP + d];
        }
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          qv[i] = Qt[d * QTP + tx + 16 * i];
          ov[i] = dOt[d * QTP + tx + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < CJ; ++j)
#pragma unroll
          for (int i = 0; i < RI; ++i) {
            s[j][i] = fmaf(kv[j], qv[i], s[j][i]);
            dp[j][i] = fmaf(vv[j], ov[i], dp[j][i]);
          }
      }
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int c = k0 + ty + 16 * j;
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          const int rl = tx + 16 * i, r = q0 + rl;
          const bool live = r < S && c < S && !(causal && c > r);
          const float p = live ? expf(s[j][i] * scale - lse_s[rl]) : 0.f;
          Pt[(ty + 16 * j) * QTP + rl] = p;
          dSt[(ty + 16 * j) * QTP + rl] = p * (dp[j][i] - del_s[rl]);
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        float pv[CJ], dsv[CJ];
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          pv[j] = Pt[(ty + 16 * j) * QTP + r];
          dsv[j] = dSt[(ty + 16 * j) * QTP + r];
        }
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float ov = dOt[(tx + 16 * e) * QTP + r];
          const float qv = Qt[(tx + 16 * e) * QTP + r];
#pragma unroll
          for (int j = 0; j < CJ; ++j) {
            dva[j][e] = fmaf(pv[j], ov, dva[j][e]);
            dka[j][e] = fmaf(dsv[j], qv, dka[j][e]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < CJ; ++j) {
    const int c = k0 + ty + 16 * j;
    if (c < S) {
      T* krow = dk + row_off(b, c, hk, S, HKV, D);
      T* vrow = dv + row_off(b, c, hk, S, HKV, D);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        krow[tx + 16 * e] = from_float<T>(dka[j][e] * scale);
        vrow[tx + 16 * e] = from_float<T>(dva[j][e]);
      }
    }
  }
}

// -- the tensor-core path: bf16, head_dim 64 or 128 ---------------------------
// The same three functions with every product on mma.sync.m16n8k16 (bf16
// in, float32 accumulate). 128 threads, four warps; each warp owns 16 rows
// of the block's tile (query rows in K1/K2, key rows in K3) and keeps its
// accumulators in the mma fragment layout: thread (g = lane / 4, t = lane
// % 4) holds rows g and g + 8, columns 2t and 2t + 1 of each 8-wide tile.
// Probabilities and ds are rounded to bf16 for the second product of each
// pair (p V, ds K, p^T dO, ds^T Q); scores, softmax statistics and every
// sum stay float32. Tiles are staged in shared memory as bf16, rows padded
// by 8 elements so the fragment loads hit 32 distinct banks; an operand
// that the mma reads along its other axis is staged transposed.

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// c += a (16 x 16, row) * b (16 x 8, col)
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of rows [0, 16) and columns [c0, c0 + 16) of a
// row-major bf16 tile with row pitch ld (in elements).
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile,
                                       int ld, int c0) {
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const bf16* p = tile + g * ld + c0 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// The A fragment (rows of the warp, k columns [16 kk, 16 kk + 16)) of a
// score-like accumulator x[n][4] held in the C layout.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&x0)[4],
                                       const float (&x1)[4]) {
  a[0] = pack_bf16(x0[0], x0[1]);
  a[1] = pack_bf16(x0[2], x0[3]);
  a[2] = pack_bf16(x1[0], x1[1]);
  a[3] = pack_bf16(x1[2], x1[3]);
}

// acc[n] += A (16 x 16 k) * B, B's column n*8 + g read from the
// k-contiguous rows of a shared tile: b[k][n] = rows[(n*8 + g) * ld + k0 + k]
template <int NT>
__device__ __forceinline__ void mma_rows(float (&acc)[NT][4],
                                         const uint32_t (&a)[4],
                                         const bf16* rows, int ld, int k0) {
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const bf16* p = rows + (n * 8 + g) * ld + k0 + 2 * t;
    mma16816(acc[n], a, ld32(p), ld32(p + 8));
  }
}

constexpr int kMmaThreads = 128;

// Rows [s0, s0 + ROWS) of head h of X [B, S, heads, D] into dst, row-major
// with pitch D + 8 (kTransposed: dst[d * (ROWS + 8) + r]); rows past S are
// zeros. 16-byte global loads.
template <int D, int ROWS, bool kTransposed>
__device__ __forceinline__ void stage(bf16* dst, const bf16* __restrict__ X,
                                      int b, int s0, int h, int S,
                                      int heads) {
  constexpr int V = D / 8;  // 16-byte vectors per row
  for (int idx = threadIdx.x; idx < ROWS * V; idx += kMmaThreads) {
    const int r = kTransposed ? idx % ROWS : idx / V;
    const int c = 8 * (kTransposed ? idx / ROWS : idx % V);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (s0 + r < S)
      val = *reinterpret_cast<const uint4*>(
          X + row_off(b, s0 + r, h, S, heads, D) + c);
    if (kTransposed) {
      const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
      for (int i = 0; i < 8; ++i) dst[(c + i) * (ROWS + 8) + r] = e[i];
    } else {
      *reinterpret_cast<uint4*>(dst + r * (D + 8) + c) = val;
    }
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

constexpr int kMmaBQ = 64, kMmaBK = 64, kMmaBQ3 = 32;

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    fa_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ out,
                      float* __restrict__ lse, int S, int H, int HKV,
                      float scale, int causal) {
  constexpr int BQ = kMmaBQ, BK = kMmaBK, LD = D + 8, LDT = BK + 8;
  constexpr int KS = D / 16, NK = BK / 8, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LD]
  bf16* Ks = Qs + BQ * LD;                        // [BK][LD]
  bf16* Vt = Ks + BK * LD;                        // [D][LDT]  V transposed

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / HKV);
  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) / 4,
            t = threadIdx.x % 4;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  stage<D, BQ, false>(Qs, q, b, q0, h, S, H);
  __syncthreads();
  uint32_t qa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    load_a(qa[kk], Qs + warp * 16 * LD, LD, kk * 16);

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  const int n_all = (S + BK - 1) / BK;
  const int n_kt = causal ? min(n_all, (q0 + BQ + BK - 1) / BK) : n_all;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    stage<D, BK, false>(Ks, k, b, k0, hk, S, HKV);
    stage<D, BK, true>(Vt, v, b, k0, hk, S, HKV);
    __syncthreads();

    float s[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) mma_rows<NK>(s, qa[kk], Ks, LD, kk * 16);

    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = k0 + j * 8 + 2 * t + (e & 1), r = e < 2 ? r0 : r1;
        float x = s[j][e] * scale;
        if (c >= S || (causal && c > r)) x = -INFINITY;
        s[j][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    const float ms0 = mn0 == -INFINITY ? 0.f : mn0;
    const float ms1 = mn1 == -INFINITY ? 0.f : mn1;
    const float corr0 = expf(m0 - ms0), corr1 = expf(m1 - ms1);
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[j][e];
        const float p = x == -INFINITY ? 0.f : expf(x - (e < 2 ? ms0 : ms1));
        s[j][e] = p;
        if (e < 2) ps0 += p; else ps1 += p;
      }
    l0 = l0 * corr0 + ps0;
    l1 = l1 * corr1 + ps1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= corr0; o[n][1] *= corr0;
      o[n][2] *= corr1; o[n][3] *= corr1;
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      c_to_a(pa, s[2 * kk], s[2 * kk + 1]);
      mma_rows<ND>(o, pa, Vt, LDT, kk * 16);
    }
  }

  const float lt0 = fmaxf(quad_sum(l0), 1e-30f);
  const float lt1 = fmaxf(quad_sum(l1), 1e-30f);
  const long long st = (static_cast<long long>(b) * H + h) * S;
  if (r0 < S) {
    bf16* row = out + row_off(b, r0, h, S, H, D) + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(row + n * 8) =
          pack_bf16(o[n][0] / lt0, o[n][1] / lt0);
    if (lse != nullptr && t == 0) lse[st + r0] = m0 + logf(lt0);
  }
  if (r1 < S) {
    bf16* row = out + row_off(b, r1, h, S, H, D) + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(row + n * 8) =
          pack_bf16(o[n][2] / lt1, o[n][3] / lt1);
    if (lse != nullptr && t == 0) lse[st + r1] = m1 + logf(lt1);
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    fa_bwd_dq_mma_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dq, int S, int H, int HKV,
                         float scale, int causal) {
  constexpr int BQ = kMmaBQ, BK = kMmaBK, LD = D + 8, LDT = BK + 8;
  constexpr int KS = D / 16, NK = BK / 8, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LD]
  bf16* dOs = Qs + BQ * LD;                       // [BQ][LD]
  bf16* Ks = dOs + BQ * LD;                       // [BK][LD]
  bf16* Vs = Ks + BK * LD;                        // [BK][LD]
  bf16* Kt = Vs + BK * LD;                        // [D][LDT]  K transposed

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / HKV);
  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) / 4,
            t = threadIdx.x % 4;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  stage<D, BQ, false>(Qs, q, b, q0, h, S, H);
  stage<D, BQ, false>(dOs, dout, b, q0, h, S, H);
  const long long st = (static_cast<long long>(b) * H + h) * S;
  const float lse0 = r0 < S ? lse[st + r0] : 0.f;
  const float lse1 = r1 < S ? lse[st + r1] : 0.f;
  const float del0 = r0 < S ? delta[st + r0] : 0.f;
  const float del1 = r1 < S ? delta[st + r1] : 0.f;
  const bf16* Qw = Qs + warp * 16 * LD;
  const bf16* dOw = dOs + warp * 16 * LD;

  float dqa[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
    dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.f;

  const int n_all = (S + BK - 1) / BK;
  const int n_kt = causal ? min(n_all, (q0 + BQ + BK - 1) / BK) : n_all;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    stage<D, BK, false>(Ks, k, b, k0, hk, S, HKV);
    stage<D, BK, false>(Vs, v, b, k0, hk, S, HKV);
    stage<D, BK, true>(Kt, k, b, k0, hk, S, HKV);
    __syncthreads();

    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[4];
      load_a(a, Qw, LD, kk * 16);
      mma_rows<NK>(s, a, Ks, LD, kk * 16);
      load_a(a, dOw, LD, kk * 16);
      mma_rows<NK>(dp, a, Vs, LD, kk * 16);
    }
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = k0 + j * 8 + 2 * t + (e & 1), r = e < 2 ? r0 : r1;
        const bool live = c < S && !(causal && c > r);
        const float p =
            live ? expf(s[j][e] * scale - (e < 2 ? lse0 : lse1)) : 0.f;
        s[j][e] = p * (dp[j][e] - (e < 2 ? del0 : del1));  // ds
      }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      c_to_a(a, s[2 * kk], s[2 * kk + 1]);
      mma_rows<ND>(dqa, a, Kt, LDT, kk * 16);
    }
  }

  if (r0 < S) {
    bf16* row = dq + row_off(b, r0, h, S, H, D) + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(row + n * 8) =
          pack_bf16(dqa[n][0] * scale, dqa[n][1] * scale);
  }
  if (r1 < S) {
    bf16* row = dq + row_off(b, r1, h, S, H, D) + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(row + n * 8) =
          pack_bf16(dqa[n][2] * scale, dqa[n][3] * scale);
  }
}

// One block per (64-key tile, kv head, batch); each warp owns 16 keys and
// computes the transposed scores s^T = K Q^T of its keys against a 32-row
// q tile, looping over the G query heads and the q tiles from the
// diagonal on, dk and dv in registers.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    fa_bwd_dkv_mma_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const bf16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv,
                          int S, int H, int HKV, float scale, int causal) {
  constexpr int BQ = kMmaBQ3, BK = kMmaBK, LD = D + 8, LDT = BQ + 8;
  constexpr int KS = D / 16, NQ = BQ / 8, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [BK][LD]
  bf16* Vs = Ks + BK * LD;                        // [BK][LD]
  bf16* Qs = Vs + BK * LD;                        // [BQ][LD]
  bf16* dOs = Qs + BQ * LD;                       // [BQ][LD]
  bf16* Qt = dOs + BQ * LD;                       // [D][LDT]  Q transposed
  bf16* dOt = Qt + D * LDT;                       // [D][LDT]  dO transposed
  float* lse_s = reinterpret_cast<float*>(dOt + D * LDT);  // [BQ]
  float* del_s = lse_s + BQ;                                 // [BQ]

  const int k0 = blockIdx.x * BK, hk = blockIdx.y, b = blockIdx.z;
  const int G = H / HKV;
  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) / 4,
            t = threadIdx.x % 4;
  const int c0 = k0 + warp * 16 + g, c1 = c0 + 8;  // this thread's keys
  stage<D, BK, false>(Ks, k, b, k0, hk, S, HKV);
  stage<D, BK, false>(Vs, v, b, k0, hk, S, HKV);
  const bf16* Kw = Ks + warp * 16 * LD;
  const bf16* Vw = Vs + warp * 16 * LD;

  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  const int n_qt = (S + BQ - 1) / BQ;
  const int qt0 = causal ? k0 / BQ : 0;  // q tiles from the diagonal on
  for (int gi = 0; gi < G; ++gi) {
    const int h = hk * G + gi;
    const long long st = (static_cast<long long>(b) * H + h) * S;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();
      stage<D, BQ, false>(Qs, q, b, q0, h, S, H);
      stage<D, BQ, false>(dOs, dout, b, q0, h, S, H);
      stage<D, BQ, true>(Qt, q, b, q0, h, S, H);
      stage<D, BQ, true>(dOt, dout, b, q0, h, S, H);
      for (int r = threadIdx.x; r < BQ; r += kMmaThreads) {
        lse_s[r] = q0 + r < S ? lse[st + q0 + r] : 0.f;
        del_s[r] = q0 + r < S ? delta[st + q0 + r] : 0.f;
      }
      __syncthreads();

      float s[NQ][4], dp[NQ][4];  // s^T and dp^T: rows keys, columns q
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t a[4];
        load_a(a, Kw, LD, kk * 16);
        mma_rows<NQ>(s, a, Qs, LD, kk * 16);
        load_a(a, Vw, LD, kk * 16);
        mma_rows<NQ>(dp, a, dOs, LD, kk * 16);
      }
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = j * 8 + 2 * t + (e & 1), r = q0 + ql;
          const int c = e < 2 ? c0 : c1;
          const bool live = r < S && c < S && !(causal && c > r);
          const float p = live ? expf(s[j][e] * scale - lse_s[ql]) : 0.f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - del_s[ql]);  // ds^T
        }
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        uint32_t a[4];
        c_to_a(a, s[2 * kk], s[2 * kk + 1]);
        mma_rows<ND>(dva, a, dOt, LDT, kk * 16);
        c_to_a(a, dp[2 * kk], dp[2 * kk + 1]);
        mma_rows<ND>(dka, a, Qt, LDT, kk * 16);
      }
    }
  }

  if (c0 < S) {
    bf16* krow = dk + row_off(b, c0, hk, S, HKV, D) + 2 * t;
    bf16* vrow = dv + row_off(b, c0, hk, S, HKV, D) + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<uint32_t*>(krow + n * 8) =
          pack_bf16(dka[n][0] * scale, dka[n][1] * scale);
      *reinterpret_cast<uint32_t*>(vrow + n * 8) =
          pack_bf16(dva[n][0], dva[n][1]);
    }
  }
  if (c1 < S) {
    bf16* krow = dk + row_off(b, c1, hk, S, HKV, D) + 2 * t;
    bf16* vrow = dv + row_off(b, c1, hk, S, HKV, D) + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<uint32_t*>(krow + n * 8) =
          pack_bf16(dka[n][2] * scale, dka[n][3] * scale);
      *reinterpret_cast<uint32_t*>(vrow + n * 8) =
          pack_bf16(dva[n][2], dva[n][3]);
    }
  }
}

// -- launches ----------------------------------------------------------------

template <int D>
constexpr int fwd_smem() {
  return 4 * (Tile<D>::BQ * (D + 1) + D * (Tile<D>::BK + 1) +
              Tile<D>::BK * D + Tile<D>::BQ * (Tile<D>::BK + 1));
}
template <int D>
constexpr int dq_smem() {
  return 4 * (2 * Tile<D>::BQ * (D + 1) + 2 * D * (Tile<D>::BK + 1) +
              Tile<D>::BQ * (Tile<D>::BK + 1));
}
template <int D>
constexpr int dkv_smem() {
  return 4 * (2 * Tile<D>::BK * (D + 1) + 2 * D * (Tile<D>::BQ + 1) +
              2 * Tile<D>::BK * (Tile<D>::BQ + 1) + 2 * Tile<D>::BQ);
}
template <int D>
constexpr int fwd_mma_smem() {
  return 2 * ((kMmaBQ + kMmaBK) * (D + 8) + D * (kMmaBK + 8));
}
template <int D>
constexpr int dq_mma_smem() {
  return 2 * (2 * (kMmaBQ + kMmaBK) * (D + 8) + D * (kMmaBK + 8));
}
template <int D>
constexpr int dkv_mma_smem() {
  return 2 * (2 * (kMmaBK + kMmaBQ3) * (D + 8) + 2 * D * (kMmaBQ3 + 8)) +
         4 * 2 * kMmaBQ3;
}

struct Args {
  const void *q, *k, *v, *o_or_dout;
  const float *lse_in, *delta;
  void *out0, *out1;  // forward: out; dq: dq; dkv: dk, dv
  float* lse_out;
  int B, S, H, HKV;
  float scale;
  int causal;
  cudaStream_t stream;
};

enum Which { kFwd = 0, kDq = 1, kDkv = 2 };

// Set the kernel's dynamic shared memory, launch, and return
// cudaGetLastError() (0 = launched).
template <typename Kernel, typename... Ps>
int launch(Kernel kernel, dim3 grid, int threads, int smem,
           cudaStream_t stream, Ps... ps) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, stream>>>(ps...);
  return static_cast<int>(cudaGetLastError());
}

int tiles(int n, int tile) { return (n + tile - 1) / tile; }

// The CUDA-core kernels: float32, and bf16 at head_dim 256.
template <typename T, int D>
int launch_core(const Args& a, int which) {
  const T *q = static_cast<const T*>(a.q), *k = static_cast<const T*>(a.k),
          *v = static_cast<const T*>(a.v),
          *dout = static_cast<const T*>(a.o_or_dout);
  T *out0 = static_cast<T*>(a.out0), *out1 = static_cast<T*>(a.out1);
  const dim3 qgrid(tiles(a.S, Tile<D>::BQ), a.H, a.B);
  switch (which) {
    case kFwd:
      return launch(fa_fwd_kernel<T, D>, qgrid, kThreads, fwd_smem<D>(),
                    a.stream, q, k, v, out0, a.lse_out, a.S, a.H, a.HKV,
                    a.scale, a.causal);
    case kDq:
      return launch(fa_bwd_dq_kernel<T, D>, qgrid, kThreads, dq_smem<D>(),
                    a.stream, q, k, v, dout, a.lse_in, a.delta, out0, a.S,
                    a.H, a.HKV, a.scale, a.causal);
    case kDkv:
      return launch(fa_bwd_dkv_kernel<T, D>,
                    dim3(tiles(a.S, Tile<D>::BK), a.HKV, a.B), kThreads,
                    dkv_smem<D>(), a.stream, q, k, v, dout, a.lse_in,
                    a.delta, out0, out1, a.S, a.H, a.HKV, a.scale, a.causal);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The tensor-core kernels: bf16 at head_dim 64 and 128.
template <int D>
int launch_mma(const Args& a, int which) {
  const bf16 *q = static_cast<const bf16*>(a.q),
             *k = static_cast<const bf16*>(a.k),
             *v = static_cast<const bf16*>(a.v),
             *dout = static_cast<const bf16*>(a.o_or_dout);
  bf16 *out0 = static_cast<bf16*>(a.out0), *out1 = static_cast<bf16*>(a.out1);
  const dim3 qgrid(tiles(a.S, kMmaBQ), a.H, a.B);
  switch (which) {
    case kFwd:
      return launch(fa_fwd_mma_kernel<D>, qgrid, kMmaThreads,
                    fwd_mma_smem<D>(), a.stream, q, k, v, out0, a.lse_out,
                    a.S, a.H, a.HKV, a.scale, a.causal);
    case kDq:
      return launch(fa_bwd_dq_mma_kernel<D>, qgrid, kMmaThreads,
                    dq_mma_smem<D>(), a.stream, q, k, v, dout, a.lse_in,
                    a.delta, out0, a.S, a.H, a.HKV, a.scale, a.causal);
    case kDkv:
      return launch(fa_bwd_dkv_mma_kernel<D>,
                    dim3(tiles(a.S, kMmaBK), a.HKV, a.B), kMmaThreads,
                    dkv_mma_smem<D>(), a.stream, q, k, v, dout, a.lse_in,
                    a.delta, out0, out1, a.S, a.H, a.HKV, a.scale, a.causal);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int dispatch(const Args& a, int head_dim, int dtype, int which) {
  if (a.B <= 0 || a.S <= 0) return 0;
  if (a.HKV <= 0 || a.H % a.HKV != 0 || a.H > 65535 || a.B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kF32) {
    switch (head_dim) {
      case 64: return launch_core<float, 64>(a, which);
      case 128: return launch_core<float, 128>(a, which);
      case 256: return launch_core<float, 256>(a, which);
    }
  } else if (dtype == kBF16) {
    switch (head_dim) {
      case 64: return launch_mma<64>(a, which);
      case 128: return launch_mma<128>(a, which);
      case 256: return launch_core<bf16, 256>(a, which);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Each entry returns cudaGetLastError() after its launch (0 = launched),
// or cudaErrorInvalidValue for a shape or dtype the kernels do not take.
// The wrapper has checked devices, dtypes, shapes and contiguity.

// K1. out [B,S,H,D]; lse [B,H,S] float32, or null when not wanted.
extern "C" int fa_forward(const void* q, const void* k, const void* v,
                          void* out, float* lse, int B, int S, int H,
                          int HKV, int head_dim, float scale, int causal,
                          int dtype, void* stream) {
  Args a{q, k, v, nullptr, nullptr, nullptr, out, nullptr, lse, B, S, H,
         HKV, scale, causal, static_cast<cudaStream_t>(stream)};
  return dispatch(a, head_dim, dtype, kFwd);
}

// K2. dq [B,S,H,D] from q, k, v, dout, lse and delta [B,H,S] float32.
extern "C" int fa_backward_dq(const void* q, const void* k, const void* v,
                              const void* dout, const float* lse,
                              const float* delta, void* dq, int B, int S,
                              int H, int HKV, int head_dim, float scale,
                              int causal, int dtype, void* stream) {
  Args a{q, k, v, dout, lse, delta, dq, nullptr, nullptr, B, S, H, HKV,
         scale, causal, static_cast<cudaStream_t>(stream)};
  return dispatch(a, head_dim, dtype, kDq);
}

// K3. dk, dv [B,S,HKV,D], each the sum over the G query heads of its group.
extern "C" int fa_backward_dkv(const void* q, const void* k, const void* v,
                               const void* dout, const float* lse,
                               const float* delta, void* dk, void* dv, int B,
                               int S, int H, int HKV, int head_dim,
                               float scale, int causal, int dtype,
                               void* stream) {
  Args a{q, k, v, dout, lse, delta, dk, dv, nullptr, B, S, H, HKV, scale,
         causal, static_cast<cudaStream_t>(stream)};
  return dispatch(a, head_dim, dtype, kDkv);
}
