// Ragged paged attention for Hopper (sm_90a), behind a plain C interface
// that paddle_tpu_torch/serving/attention.py loads through ctypes.
//
// Replaces the TPU kernel paddle_tpu/serving/attention.py
// ::_ragged_attention_kernel (its pl.pallas_call is at attention.py:289).
// Same semantics: every packed query token t reads its lane's page-table
// row, context length and absolute position; it attends keys k with
//   k <= pos[t],  k < context_len[lane],  k > pos[t] - window (window > 0),
// scores in float32 scaled by `scale`, an online softmax over the keys,
// output acc / max(l, 1e-20) cast to q's dtype (a row with no key left
// comes out 0, never NaN). int8 pages are dequantized as
// code * scale[slot, kv_head].
//
// What bounds it: bytes. Per (token, kv head) the kernel reads
// 2 * ctx * D * sizeof(K/V) bytes of K and V (2 * ctx * KV * D * bytes per
// token over all kv heads) and does 4 * D flops per key per query head,
// about one flop per byte at D=128 in bf16: far below the ~295 flop/byte
// where the H100's tensor cores would become the limit.
//
// What this design does about that:
// - It reads only the lane's live keys, [first key of the window,
//   min(pos + 1, ctx)), through the page table. The TPU kernel read the
//   whole page pool in every grid cell; a page-table row here may be 256
//   pages wide (max_position_embeddings / page_size) and the loop never
//   looks past the lane's last live key.
// - One thread block per (token, kv head); one warp per query head of
//   the GQA group. K and V come through shared memory in chunks of 8 KB
//   each, copied with 16-byte cp.async and double-buffered: the copy of
//   chunk c+1 is in flight while the warps score chunk c, so a block
//   keeps 16 KB of loads outstanding instead of one element. A kv head's
//   bytes are fetched once per token however many query heads share it.
// - Each thread owns D/32 elements of d (element i*32 + lane, so shared
//   memory reads are free of bank conflicts); dot products are reduced
//   by warp shuffle, and the running (m, l, acc) stay in registers.
// Not done yet: tokens of one lane each re-read the lane's K/V (from L2
// for a prefill chunk), no TMA or wgmma, no split over long contexts
// (a decode step has only tokens x kv_heads blocks).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTileBytes = 8192;  // bytes of K (and of V) per chunk
constexpr int kSub = 16;          // keys scored per online-softmax update

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Asynchronous global -> shared copies; a copy with valid == false
// writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename QT, typename KT, int D>
__global__ void __launch_bounds__(1024) ragged_paged_attention_kernel(
    const QT* __restrict__ q, const KT* __restrict__ k_pages,
    const KT* __restrict__ v_pages, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales, const int* __restrict__ page_table,
    const int* __restrict__ context_lens, const int* __restrict__ positions,
    const int* __restrict__ token_lane, QT* __restrict__ out, int num_heads,
    int num_kv_heads, int page_size, int max_pages, int window,
    float scale) {
  constexpr int EPT = D / 32;                                // d per lane
  constexpr bool kQuant = std::is_same<KT, int8_t>::value;
  constexpr int KC = kTileBytes / (D * (int)sizeof(KT));     // keys/chunk
  constexpr int SUB = KC < kSub ? KC : kSub;
  constexpr int VEC = 16 / (int)sizeof(KT);        // elements per copy
  constexpr int VPR = D / VEC;                     // copies per key row
  __shared__ __align__(16) KT k_tile[2][KC][D];
  __shared__ __align__(16) KT v_tile[2][KC][D];
  __shared__ float ks_tile[2][KC];  // int8 scales of the chunk's keys
  __shared__ float vs_tile[2][KC];

  const int t = blockIdx.x;
  const int kvh = blockIdx.y;
  const int group = num_heads / num_kv_heads;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int head = kvh * group + warp;

  const int ln = token_lane[t];
  const int qpos = positions[t];
  const int* pt = page_table + static_cast<long long>(ln) * max_pages;
  const int kend =
      min(min(qpos + 1, context_lens[ln]), max_pages * page_size);
  const int kstart = window > 0 ? max(0, qpos - window + 1) : 0;
  const int nchunks = kend > kstart ? (kend - kstart + KC - 1) / KC : 0;

  // Start the copies of the KC keys from c0 into buffer buf.
  auto stage = [&](int buf, int c0) {
    for (int idx = threadIdx.x; idx < KC * VPR; idx += blockDim.x) {
      const int j = idx / VPR, col = (idx % VPR) * VEC;
      const int kp = c0 + j;
      const bool valid = kp < kend;
      long long r = 0;  // (slot, kv head) row
      if (valid) {
        const long long page = __ldg(pt + kp / page_size);
        r = (page * page_size + kp % page_size) * num_kv_heads + kvh;
      }
      cp_async16(&k_tile[buf][j][col], k_pages + r * D + col, valid);
      cp_async16(&v_tile[buf][j][col], v_pages + r * D + col, valid);
      if (kQuant && col == 0) {
        cp_async4(&ks_tile[buf][j], k_scales + r, valid);
        cp_async4(&vs_tile[buf][j], v_scales + r, valid);
      }
    }
    cp_async_commit();
  };

  float qv[EPT], acc[EPT];
  const QT* qrow = q + (static_cast<long long>(t) * num_heads + head) * D;
#pragma unroll
  for (int i = 0; i < EPT; ++i) {
    qv[i] = to_float(qrow[i * 32 + lane]);
    acc[i] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  if (nchunks > 0) stage(0, kstart);
  for (int c = 0; c < nchunks; ++c) {
    const int buf = c & 1;
    const int c0 = kstart + c * KC;
    if (c + 1 < nchunks) {
      stage(buf ^ 1, c0 + KC);  // that buffer was released at c-1's end
      cp_async_wait<1>();       // chunk c has landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    for (int j0 = 0; j0 < KC; j0 += SUB) {
      const int n = min(SUB, kend - (c0 + j0));
      if (n <= 0) break;
      float s[SUB];
      float cmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < SUB; ++j) {
        float p = 0.f;
#pragma unroll
        for (int i = 0; i < EPT; ++i)
          p += qv[i] * to_float(k_tile[buf][j0 + j][i * 32 + lane]);
        p = warp_sum(p);
        if (kQuant) p *= ks_tile[buf][j0 + j];
        s[j] = j < n ? p * scale : -INFINITY;
        cmax = fmaxf(cmax, s[j]);
      }
      const float mnew = fmaxf(m, cmax);   // finite: n >= 1 keys
      const float alpha = expf(m - mnew);  // 0 on the first update
      l *= alpha;
#pragma unroll
      for (int i = 0; i < EPT; ++i) acc[i] *= alpha;
#pragma unroll
      for (int j = 0; j < SUB; ++j) {
        const float p = j < n ? expf(s[j] - mnew) : 0.f;
        l += p;
        const float pv = kQuant ? p * vs_tile[buf][j0 + j] : p;
#pragma unroll
        for (int i = 0; i < EPT; ++i)
          acc[i] += pv * to_float(v_tile[buf][j0 + j][i * 32 + lane]);
      }
      m = mnew;
    }
    __syncthreads();  // every warp is done with buf before it is refilled
  }
  const float inv = 1.f / fmaxf(l, 1e-20f);
  QT* orow = out + (static_cast<long long>(t) * num_heads + head) * D;
#pragma unroll
  for (int i = 0; i < EPT; ++i)
    orow[i * 32 + lane] = from_float<QT>(acc[i] * inv);
}

struct Args {
  const void *q, *k_pages, *v_pages, *k_scales, *v_scales;
  const int *page_table, *context_lens, *positions, *token_lane;
  void* out;
  int num_tokens, num_heads, num_kv_heads, page_size, max_pages, window;
  float scale;
  cudaStream_t stream;
};

template <typename QT, typename KT, int D>
int launch(const Args& a) {
  const dim3 grid(a.num_tokens, a.num_kv_heads);
  const dim3 block(32 * (a.num_heads / a.num_kv_heads));
  ragged_paged_attention_kernel<QT, KT, D><<<grid, block, 0, a.stream>>>(
      static_cast<const QT*>(a.q), static_cast<const KT*>(a.k_pages),
      static_cast<const KT*>(a.v_pages),
      static_cast<const float*>(a.k_scales),
      static_cast<const float*>(a.v_scales), a.page_table, a.context_lens,
      a.positions, a.token_lane, static_cast<QT*>(a.out), a.num_heads,
      a.num_kv_heads, a.page_size, a.max_pages, a.window, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, typename KT>
int launch_d(const Args& a, int head_dim) {
  switch (head_dim) {
    case 64: return launch<QT, KT, 64>(a);
    case 128: return launch<QT, KT, 128>(a);
    case 256: return launch<QT, KT, 256>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename QT>
int launch_kv(const Args& a, int head_dim, int kv_dtype) {
  switch (kv_dtype) {
    case kF32: return launch_d<QT, float>(a, head_dim);
    case kBF16: return launch_d<QT, __nv_bfloat16>(a, head_dim);
    case kI8: return launch_d<QT, int8_t>(a, head_dim);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a shape or dtype the kernel does not take.
// The wrapper has checked shapes, dtypes, contiguity and the 16-byte
// alignment of the page pools already.
extern "C" int ragged_paged_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* page_table,
    const void* context_lens, const void* positions, const void* token_lane,
    void* out, int num_tokens, int num_heads, int num_kv_heads,
    int head_dim, int page_size, int max_pages, int window, float scale,
    int q_dtype, int kv_dtype, void* stream) {
  if (num_tokens == 0) return 0;
  if (num_kv_heads <= 0 || num_heads % num_kv_heads != 0 ||
      num_heads / num_kv_heads > 32 || page_size <= 0 || max_pages <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k_pages, v_pages, k_scales, v_scales,
               static_cast<const int*>(page_table),
               static_cast<const int*>(context_lens),
               static_cast<const int*>(positions),
               static_cast<const int*>(token_lane), out, num_tokens,
               num_heads, num_kv_heads, page_size, max_pages, window, scale,
               static_cast<cudaStream_t>(stream)};
  switch (q_dtype) {
    case kF32: return launch_kv<float>(a, head_dim, kv_dtype);
    case kBF16: return launch_kv<__nv_bfloat16>(a, head_dim, kv_dtype);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
