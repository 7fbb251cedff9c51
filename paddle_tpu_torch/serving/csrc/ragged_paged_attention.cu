// Ragged paged attention for Hopper (sm_90a), behind a plain C interface
// that paddle_tpu_torch/serving/attention.py loads through ctypes.
//
// Replaces the TPU kernel paddle_tpu/serving/attention.py
// ::_ragged_attention_kernel (its pl.pallas_call is at attention.py:289).
// Same semantics: every packed query token t reads its lane's page-table
// row, context length and absolute position; it attends keys k with
//   k <= pos[t],  k < context_len[lane],  k > pos[t] - window (window > 0),
// i.e. the token's live keys [kstart, kend); scores in float32 scaled by
// `scale`, a softmax over the live keys, output acc / max(l, 1e-20) cast
// to q's dtype (a row with no live key comes out 0, never NaN). int8
// pages are dequantized as code * scale[slot, kv_head]: the K scale
// multiplies the score after the dot, the V scale the probability before
// the product with V.
//
// What bounds it: bytes. A token reads 2 * live keys * KV * D * sizeof(K/V)
// bytes and does 4 * D flops a live key and query head, about one flop a
// byte at D 128 in bf16 (the H100's tensor cores become the limit near
// 295). At LLaMA-2-7B's decode step (8 lanes x 1 token, contexts 37-2047,
// H = KV = 32, D 128, bf16) the 7826 live keys are 128 MB of K/V: 0.0383 ms
// at 3.35 TB/s. A 256-token prefill chunk at context 1024 reads one lane's
// 1024 keys (16.8 MB) once: 0.0063 ms of bytes against 0.0038 ms of bf16
// tensor-core operations. The two shapes want different kernels, so there
// are two forms; the wrapper picks them from shapes alone (no host read of
// a length) and a combine kernel finishes the first:
//
// (a) rpa_split_kernel, the decode / split-K form (CUDA cores; any query
//     dtype; bf16, float32 or int8 pages). One block per (token, kv head,
//     split); a split is a fixed span of `split_keys` live keys from the
//     token's kstart, and the number of splits is a static bound from the
//     page-table width (and the window), so a decode step launches tokens x
//     kv heads x splits blocks instead of tokens x kv heads single-warp
//     blocks: enough to keep 132 SMs streaming. A split past the token's
//     live keys writes an empty partial (m = -inf, l = 0) and exits. Inside
//     a block, 16-lane half-warps stream the span's keys through the page
//     table with 16-byte cp.async into a two-stage shared ring of 64-key
//     chunks; each key row is fetched once per block and scored against
//     every query head of its GQA group. A half-warp spreads a key row over
//     its 16 lanes and scores 8 keys at once; a transposing butterfly (8
//     shuffles for 8 keys) leaves each lane pair the full dot product of one
//     key, so the reduction costs one shuffle a key instead of five. The
//     half-warps of a head merge in shared memory and write one partial (m,
//     l in log2 units, acc) per (token, head, split) in float32.
// (b) rpa_tile_kernel, the prefill / tile form (tensor cores; bf16 queries
//     over bf16 or int8 pages, D 64 or 128). One block per (tile, kv head):
//     a tile is up to 64 / G consecutive tokens of one lane, times the G
//     query heads of the group, as the 64 rows of an mma.sync m16n8k16
//     tile (bf16 in, float32 accumulate), four warps of 16 rows. K/V tiles
//     of 64 keys are gathered through the page table with cp.async into a
//     double-buffered ring (int8 codes converted to bf16 at staging, exact
//     for |code| <= 127); S = Q K^T and O += P V run on the tensor cores,
//     fragments from ldmatrix (.trans for V), the online softmax in
//     registers with exp2 and scale * log2(e) folded into one multiply;
//     P enters its product as three bf16 parts, each 16-key slice summed
//     apart and added to the output in float32, so the output keeps the
//     precision of float32 probabilities (a bf16 P moved the served
//     logits measurably).
//     Every row keeps its own limits (its position, the context, the
//     window), so rows need not hold consecutive positions; only key tiles
//     that straddle some row's limit are masked. The lane's K/V is read
//     once per tile instead of once per token.
// rpa_combine_kernel merges each split token's partials and writes the
// output in q's dtype.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

typedef __nv_bfloat16 bf16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16(x);
}

// The elements of one 32-bit word of a row, as float32.
template <typename T>
__device__ __forceinline__ void unpack_word(float* dst, uint32_t w) {
  if constexpr (std::is_same<T, float>::value) {
    dst[0] = __uint_as_float(w);
  } else if constexpr (std::is_same<T, bf16>::value) {
    dst[0] = __uint_as_float(w << 16);
    dst[1] = __uint_as_float(w & 0xffff0000u);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      dst[i] = static_cast<float>(
          static_cast<int8_t>(static_cast<uint8_t>(w >> (8 * i))));
  }
}

// N consecutive elements at p (aligned to their size) as float32, read in
// the widest vectors they fill.
template <typename T, int N>
__device__ __forceinline__ void load_row(float (&x)[N], const T* p) {
  constexpr int W = N * static_cast<int>(sizeof(T)) / 4;  // 32-bit words
  constexpr int EPW = 4 / static_cast<int>(sizeof(T));
  uint32_t w[W];
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int c = 0; c < W / 4; ++c) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[c];
      w[4 * c] = u.x;
      w[4 * c + 1] = u.y;
      w[4 * c + 2] = u.z;
      w[4 * c + 3] = u.w;
    }
  } else if constexpr (W % 2 == 0) {
#pragma unroll
    for (int c = 0; c < W / 2; ++c) {
      const uint2 u = reinterpret_cast<const uint2*>(p)[c];
      w[2 * c] = u.x;
      w[2 * c + 1] = u.y;
    }
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
#pragma unroll
  for (int i = 0; i < W; ++i) unpack_word<T>(x + i * EPW, w[i]);
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

// The live keys [kstart, kend) of a token at position pos of a lane of
// context ctx.
struct Span {
  int lo, hi;
};
__device__ __forceinline__ Span live_keys(int pos, int ctx, int max_keys,
                                          int window) {
  return Span{window > 0 ? max(0, pos - window + 1) : 0,
              min(min(pos + 1, ctx), max_keys)};
}

// The (slot, kv head) row of key kp through a lane's page-table row pt.
__device__ __forceinline__ long long key_row(const int* pt, int kp,
                                             int page_size, int num_kv_heads,
                                             int kvh) {
  const long long page = __ldg(pt + kp / page_size);
  return (page * page_size + kp % page_size) * num_kv_heads + kvh;
}

struct Common {
  const void *q, *k_pages, *v_pages;
  const float *k_scales, *v_scales;
  const int *page_table, *context_lens, *positions, *token_lane;
  int num_tokens, num_heads, num_kv_heads, page_size, max_pages, window;
  float scale;
};

// -- (a) the split form -------------------------------------------------------

struct SplitArgs {
  Common c;
  const int* split_tok;  // 1 where the token takes this form, or null: all
  float *part_m, *part_l, *part_acc;  // [T, H, NS] (m, l), [T, H, NS, D]
  int n_splits, split_keys;
};

constexpr int kChunkBytes = 16384;  // most bytes of K (and of V) a chunk holds

template <typename KT, int D>
struct SplitShape {
  static constexpr int EPL = D / 16;  // elements of a key row per lane
  static constexpr int KC =
      kChunkBytes / (D * static_cast<int>(sizeof(KT))) < 64
          ? kChunkBytes / (D * static_cast<int>(sizeof(KT)))
          : 64;  // keys per chunk: 64, or 32 / 16 for wide rows
  static constexpr int VEC = 16 / static_cast<int>(sizeof(KT));
  static constexpr int VPR = D / VEC;  // 16-byte copies per key row
  static constexpr int ring_bytes =
      2 * 2 * KC * D * static_cast<int>(sizeof(KT)) +
      (std::is_same<KT, int8_t>::value ? 2 * 2 * KC * 4 : 0);
};

template <typename QT, typename KT, int D>
__global__ void __launch_bounds__(512) rpa_split_kernel(const SplitArgs a) {
  using SS = SplitShape<KT, D>;
  constexpr int EPL = SS::EPL, KC = SS::KC, VPR = SS::VPR, VEC = SS::VEC;
  constexpr bool kQuant = std::is_same<KT, int8_t>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  KT* k_ring = reinterpret_cast<KT*>(smem);  // [2][KC][D]
  KT* v_ring = k_ring + 2 * KC * D;          // [2][KC][D]
  float* ks_ring = reinterpret_cast<float*>(v_ring + 2 * KC * D);  // [2][KC]
  float* vs_ring = ks_ring + 2 * KC;                                // [2][KC]

  const Common& c = a.c;
  const int t = blockIdx.x, kvh = blockIdx.y, split = blockIdx.z;
  if (a.split_tok != nullptr && a.split_tok[t] == 0) return;
  const int G = c.num_heads / c.num_kv_heads;
  const int NS = a.n_splits;
  const int ln = c.token_lane[t];
  const Span live = live_keys(c.positions[t], c.context_lens[ln],
                              c.max_pages * c.page_size, c.window);
  const int lo = live.lo + split * a.split_keys;
  const int hi = min(lo + a.split_keys, live.hi);
  // partial (token, head kvh * G + g, split) at pbase + g * NS
  const long long pbase =
      (static_cast<long long>(t) * c.num_heads + kvh * G) * NS + split;
  if (lo >= hi) {  // the span lies past the token's live keys
    for (int g = threadIdx.x; g < G; g += blockDim.x) {
      a.part_m[pbase + static_cast<long long>(g) * NS] = -INFINITY;
      a.part_l[pbase + static_cast<long long>(g) * NS] = 0.f;
    }
    return;
  }

  // half-warp hw = g + G * kslot scores query head g against the 8-key
  // groups kslot, kslot + KS, ... of every chunk
  const int hw = threadIdx.x >> 4, hl = threadIdx.x & 15;
  const int nhw = blockDim.x >> 4;
  const int KS = nhw / G;
  const int g = hw % G, kslot = hw / G;
  const bool active = kslot < KS;
  const unsigned hm = 0xffffu << (threadIdx.x & 16);  // this half-warp

  const QT* q = static_cast<const QT*>(c.q);
  const KT* k_pages = static_cast<const KT*>(c.k_pages);
  const KT* v_pages = static_cast<const KT*>(c.v_pages);
  float qv[EPL], acc[EPL];
  const float qscale = c.scale * kLog2e;
#pragma unroll
  for (int e = 0; e < EPL; ++e) qv[e] = acc[e] = 0.f;
  if (active) {
    load_row<QT, EPL>(
        qv, q + (static_cast<long long>(t) * c.num_heads + kvh * G + g) * D +
                hl * EPL);
#pragma unroll
    for (int e = 0; e < EPL; ++e) qv[e] *= qscale;
  }
  float m = -INFINITY, l = 0.f;  // l: the even lanes' share

  const int* pt = c.page_table + static_cast<long long>(ln) * c.max_pages;
  auto stage = [&](int buf, int c0) {
    for (int idx = threadIdx.x; idx < KC * VPR; idx += blockDim.x) {
      const int j = idx / VPR, col = (idx % VPR) * VEC;
      const int kp = c0 + j;
      const bool valid = kp < hi;
      const long long r =
          valid ? key_row(pt, kp, c.page_size, c.num_kv_heads, kvh) : 0;
      cp_async16(&k_ring[(buf * KC + j) * D + col], k_pages + r * D + col,
                 valid);
      cp_async16(&v_ring[(buf * KC + j) * D + col], v_pages + r * D + col,
                 valid);
      if (kQuant && col == 0) {
        cp_async4(&ks_ring[buf * KC + j], c.k_scales + r, valid);
        cp_async4(&vs_ring[buf * KC + j], c.v_scales + r, valid);
      }
    }
    cp_async_commit();
  };

  const int nchunks = (hi - lo + KC - 1) / KC;
  stage(0, lo);
  for (int ch = 0; ch < nchunks; ++ch) {
    const int buf = ch & 1;
    const int c0 = lo + ch * KC;
    if (ch + 1 < nchunks) {
      stage(buf ^ 1, c0 + KC);  // that buffer was released at ch-1's end
      cp_async_wait<1>();       // chunk ch has landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      for (int grp = kslot; grp < KC / 8; grp += KS) {
        const int j0 = grp * 8;
        const int nlive = hi - (c0 + j0);
        if (nlive <= 0) break;
        const KT* kr = k_ring + (buf * KC + j0) * D + hl * EPL;
        float s[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float kx[EPL];
          load_row<KT, EPL>(kx, kr + j * D);
          float d = 0.f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) d = fmaf(qv[e], kx[e], d);
          s[j] = d;
        }
        // transposing butterfly: lane hl keeps the keys of its bit and
        // sends the others, so lane pair hl >> 1 ends with key hl >> 1
        float x4[4], x2[2];
        {
          const bool b = hl & 8;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float keep = b ? s[i + 4] : s[i];
            const float send = b ? s[i] : s[i + 4];
            x4[i] = keep + __shfl_xor_sync(hm, send, 8);
          }
        }
        {
          const bool b = hl & 4;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float keep = b ? x4[i + 2] : x4[i];
            const float send = b ? x4[i] : x4[i + 2];
            x2[i] = keep + __shfl_xor_sync(hm, send, 4);
          }
        }
        float sc;
        {
          const bool b = hl & 2;
          const float keep = b ? x2[1] : x2[0];
          const float send = b ? x2[0] : x2[1];
          sc = keep + __shfl_xor_sync(hm, send, 2);
        }
        sc += __shfl_xor_sync(hm, sc, 1);
        const int jk = hl >> 1;
        if (kQuant) sc *= ks_ring[buf * KC + j0 + jk];
        if (jk >= nlive) sc = -INFINITY;
        float gm = fmaxf(sc, __shfl_xor_sync(hm, sc, 2));
        gm = fmaxf(gm, __shfl_xor_sync(hm, gm, 4));
        gm = fmaxf(gm, __shfl_xor_sync(hm, gm, 8));
        const float mnew = fmaxf(m, gm);     // finite: key j0 is live
        const float alpha = exp2f(m - mnew);  // 0 on the first update
        const float p = exp2f(sc - mnew);     // 0 where masked
        l = l * alpha + ((hl & 1) ? 0.f : p);
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[e] *= alpha;
        const float pv = kQuant ? p * vs_ring[buf * KC + j0 + jk] : p;
        const KT* vr = v_ring + (buf * KC + j0) * D + hl * EPL;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float pj = __shfl_sync(hm, pv, 2 * j, 16);
          float vx[EPL];
          load_row<KT, EPL>(vx, vr + j * D);
#pragma unroll
          for (int e = 0; e < EPL; ++e) acc[e] = fmaf(pj, vx[e], acc[e]);
        }
        m = mnew;
      }
    }
    __syncthreads();  // every half-warp is done with buf before its refill
  }

  // merge the KS half-warps of each head (the ring is free now)
  float* rm = reinterpret_cast<float*>(smem);  // [nhw]
  float* rl = rm + nhw;                        // [nhw]
  float* racc = rl + nhw;                      // [nhw][D]
  if (active) {
    float lt = l;
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) lt += __shfl_xor_sync(hm, lt, o);
    if (hl == 0) {
      rm[hw] = m;
      rl[hw] = lt;
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) racc[hw * D + hl * EPL + e] = acc[e];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * D; idx += blockDim.x) {
    const int gg = idx / D, d = idx % D;
    float M = -INFINITY;
    for (int s = 0; s < KS; ++s) M = fmaxf(M, rm[gg + G * s]);
    float L = 0.f, A = 0.f;
    for (int s = 0; s < KS; ++s) {
      const int h = gg + G * s;
      const float w = rm[h] == -INFINITY ? 0.f : exp2f(rm[h] - M);
      L += w * rl[h];
      A += w * racc[h * D + d];
    }
    const long long pi = pbase + static_cast<long long>(gg) * NS;
    a.part_acc[pi * D + d] = A;
    if (d == 0) {
      a.part_m[pi] = M;
      a.part_l[pi] = L;
    }
  }
}

// One block per (token, query head), a thread per element of d: the
// partials of the token's splits, weighted by exp2(m_s - max m), summed.
template <typename QT, int D>
__global__ void __launch_bounds__(D) rpa_combine_kernel(
    const float* __restrict__ part_m, const float* __restrict__ part_l,
    const float* __restrict__ part_acc, const int* __restrict__ split_tok,
    QT* __restrict__ out, int num_heads, int n_splits) {
  const int t = blockIdx.x, h = blockIdx.y, d = threadIdx.x;
  if (split_tok != nullptr && split_tok[t] == 0) return;
  const long long base =
      (static_cast<long long>(t) * num_heads + h) * n_splits;
  float M = -INFINITY;
  for (int s = 0; s < n_splits; ++s) M = fmaxf(M, part_m[base + s]);
  float L = 0.f, A = 0.f;
  if (M != -INFINITY) {
    for (int s = 0; s < n_splits; ++s) {
      const float ms = part_m[base + s];
      if (ms == -INFINITY) continue;  // an empty split
      const float w = exp2f(ms - M);
      L += w * part_l[base + s];
      A += w * part_acc[(base + s) * D + d];
    }
  }
  out[(static_cast<long long>(t) * num_heads + h) * D + d] =
      from_float<QT>(A / fmaxf(L, 1e-20f));
}

// -- (b) the tile form --------------------------------------------------------

struct TileArgs {
  Common c;
  const int* tiles;  // [n_tiles][2] (first token, tokens), or null: rect
  int rect_s;        // with tiles null: rows of rect_s tokens, lane = row
  int tile_tokens;   // tokens a tile holds at most (64 / G)
  bf16* out;
};

constexpr int kTileRows = 64, kTileKeys = 64, kTileThreads = 128;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x0, x1 as three bf16 pairs: hi = bf16(x), lo = bf16(x - hi), lo2 =
// bf16(x - hi - lo); x = hi + lo + lo2 to about 2^-26 of x.
__device__ __forceinline__ void split_bf16(uint32_t& hi, uint32_t& lo,
                                           uint32_t& lo2, float x0,
                                           float x1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = x0 - hf.x, r1 = x1 - hf.y;
  const __nv_bfloat162 l = __floats2bfloat162_rn(r0, r1);
  const float2 lf = __bfloat1622float2(l);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
  lo2 = pack_bf16(r0 - lf.x, r1 - lf.y);
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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <typename KT, int D>
struct TileShape {
  static constexpr bool kQuant = std::is_same<KT, int8_t>::value;
  static constexpr int LD = D + 8;  // bf16 row pitch: ldmatrix rows on
                                    // distinct banks
  static constexpr int kBufs = kQuant ? 1 : 2;  // bf16 K/V tiles
  static constexpr int bytes =
      2 * (kTileRows + 2 * kBufs * kTileKeys) * LD +
      (kQuant ? 2 * 2 * kTileKeys * D + 2 * 2 * kTileKeys * 4 : 0) +
      2 * kTileRows * 4;
};

template <typename KT, int D>
__global__ void __launch_bounds__(kTileThreads) rpa_tile_kernel(
    const TileArgs a) {
  using TS = TileShape<KT, D>;
  constexpr bool kQuant = TS::kQuant;
  constexpr int BK = kTileKeys, LD = TS::LD;
  constexpr int KK = D / 16, NK = BK / 8, ND = D / 8;
  constexpr int VEC = 16 / static_cast<int>(sizeof(KT));
  constexpr int VPR = D / VEC;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);      // [64][LD]
  bf16* Kb = Qs + kTileRows * LD;                // [kBufs][BK][LD]
  bf16* Vb = Kb + TS::kBufs * BK * LD;           // [kBufs][BK][LD]
  int8_t* Kc = reinterpret_cast<int8_t*>(Vb + TS::kBufs * BK * LD);
  int8_t* Vc = Kc + (kQuant ? 2 * BK * D : 0);   // int8: [2][BK][D] each
  float* ks_ring = reinterpret_cast<float*>(Vc + (kQuant ? 2 * BK * D : 0));
  float* vs_ring = ks_ring + (kQuant ? 2 * BK : 0);  // int8: [2][BK] each
  int* rlo = reinterpret_cast<int*>(vs_ring + (kQuant ? 2 * BK : 0));
  int* rhi = rlo + kTileRows;  // each row's live keys [rlo, rhi)

  const Common& c = a.c;
  int t0, n;
  if (a.tiles != nullptr) {
    t0 = a.tiles[2 * blockIdx.x];
    n = a.tiles[2 * blockIdx.x + 1];
  } else {
    const int per = (a.rect_s + a.tile_tokens - 1) / a.tile_tokens;
    const int i = blockIdx.x % per;
    t0 = (blockIdx.x / per) * a.rect_s + i * a.tile_tokens;
    n = min(a.tile_tokens, a.rect_s - i * a.tile_tokens);
  }
  if (n <= 0) return;  // a slot of the bound with no tile
  const int kvh = blockIdx.y;
  const int G = c.num_heads / c.num_kv_heads;
  const int ln = c.token_lane[t0];
  const int ctx = c.context_lens[ln];
  const int max_keys = c.max_pages * c.page_size;
  const int tid = threadIdx.x;
  const bf16* q = static_cast<const bf16*>(c.q);

  // row r: token t0 + r / G, query head kvh * G + r % G
  if (tid < kTileRows) {
    const int tok = tid / G;
    int lo_r = INT_MAX, hi_r = INT_MIN;  // no key for a row past the tile
    if (tok < n) {
      const Span s = live_keys(c.positions[t0 + tok], ctx, max_keys,
                               c.window);
      lo_r = s.lo;
      hi_r = s.hi;
    }
    rlo[tid] = lo_r;
    rhi[tid] = hi_r;
  }
  for (int idx = tid; idx < kTileRows * (D / 8); idx += kTileThreads) {
    const int r = idx / (D / 8), col = (idx % (D / 8)) * 8;
    const int tok = r / G;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (tok < n)
      val = *reinterpret_cast<const uint4*>(
          q + (static_cast<long long>(t0 + tok) * c.num_heads + kvh * G +
               r % G) * D + col);
    *reinterpret_cast<uint4*>(Qs + r * LD + col) = val;
  }
  __syncthreads();

  // the tile's keys [lo, hi) (the union of its rows'), and the keys every
  // row sees [max_lo, min_hi): a key tile inside those needs no masking
  int lo = INT_MAX, hi = INT_MIN, max_lo = INT_MIN, min_hi = INT_MAX;
  for (int r = 0; r < kTileRows; ++r) {
    const int a_ = rlo[r], b_ = rhi[r];
    if (a_ == INT_MAX) continue;
    lo = min(lo, a_);
    hi = max(hi, b_);
    max_lo = max(max_lo, a_);
    min_hi = min(min_hi, b_);
  }
  const int warp = tid / 32, lane = tid % 32, g8 = lane / 4, t4 = lane % 4;
  const int r0 = warp * 16 + g8, r1 = r0 + 8;
  const int lo0 = rlo[r0], hi0 = rhi[r0], lo1 = rlo[r1], hi1 = rhi[r1];

  uint32_t qa[KK][4];
#pragma unroll
  for (int kk = 0; kk < KK; ++kk)
    ldmatrix_x4(qa[kk], Qs + (warp * 16 + lane % 16) * LD + kk * 16 +
                            (lane / 16) * 8);

  float o[ND][4];
#pragma unroll
  for (int nn = 0; nn < ND; ++nn)
    o[nn][0] = o[nn][1] = o[nn][2] = o[nn][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  const float qscale = c.scale * kLog2e;

  const KT* k_pages = static_cast<const KT*>(c.k_pages);
  const KT* v_pages = static_cast<const KT*>(c.v_pages);
  const int* pt = c.page_table + static_cast<long long>(ln) * c.max_pages;
  auto stage = [&](int buf, int k0) {
    for (int idx = tid; idx < BK * VPR; idx += kTileThreads) {
      const int j = idx / VPR, col = (idx % VPR) * VEC;
      const int kp = k0 + j;
      const bool valid = kp < hi;
      const long long r =
          valid ? key_row(pt, kp, c.page_size, c.num_kv_heads, kvh) : 0;
      if constexpr (kQuant) {
        cp_async16(&Kc[(buf * BK + j) * D + col], k_pages + r * D + col,
                   valid);
        cp_async16(&Vc[(buf * BK + j) * D + col], v_pages + r * D + col,
                   valid);
        if (col == 0) {
          cp_async4(&ks_ring[buf * BK + j], c.k_scales + r, valid);
          cp_async4(&vs_ring[buf * BK + j], c.v_scales + r, valid);
        }
      } else {
        cp_async16(&Kb[(buf * BK + j) * LD + col], k_pages + r * D + col,
                   valid);
        cp_async16(&Vb[(buf * BK + j) * LD + col], v_pages + r * D + col,
                   valid);
      }
    }
    cp_async_commit();
  };

  const int nkt = hi > lo ? (hi - lo + BK - 1) / BK : 0;
  if (nkt > 0) stage(0, lo);
  for (int kt = 0; kt < nkt; ++kt) {
    const int buf = kt & 1;
    const int k0 = lo + kt * BK;
    if (kt + 1 < nkt) {
      stage(buf ^ 1, k0 + BK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Kt = Kb + (kQuant ? 0 : buf * BK * LD);
    const bf16* Vt = Vb + (kQuant ? 0 : buf * BK * LD);
    if constexpr (kQuant) {  // codes -> bf16, exact for |code| <= 127
      for (int idx = tid; idx < BK * D / 8; idx += kTileThreads) {
        const int j = idx / (D / 8), col = (idx % (D / 8)) * 8;
        float xk[8], xv[8];
        load_row<int8_t, 8>(xk, Kc + (buf * BK + j) * D + col);
        load_row<int8_t, 8>(xv, Vc + (buf * BK + j) * D + col);
        uint4 pk, pv;
        pk.x = pack_bf16(xk[0], xk[1]);
        pk.y = pack_bf16(xk[2], xk[3]);
        pk.z = pack_bf16(xk[4], xk[5]);
        pk.w = pack_bf16(xk[6], xk[7]);
        pv.x = pack_bf16(xv[0], xv[1]);
        pv.y = pack_bf16(xv[2], xv[3]);
        pv.z = pack_bf16(xv[4], xv[5]);
        pv.w = pack_bf16(xv[6], xv[7]);
        *reinterpret_cast<uint4*>(Kb + j * LD + col) = pk;
        *reinterpret_cast<uint4*>(Vb + j * LD + col) = pv;
      }
      __syncthreads();
    }

    // S = Q K^T: K rows are keys, so plain ldmatrix gives the B fragments
    float s[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
#pragma unroll
      for (int j = 0; j < NK; j += 2) {
        uint32_t b[4];
        const int mi = lane / 8;
        ldmatrix_x4(b, Kt + (j * 8 + (mi / 2) * 8 + lane % 8) * LD +
                           kk * 16 + (mi % 2) * 8);
        mma16816(s[j], qa[kk], b[0], b[1]);
        mma16816(s[j + 1], qa[kk], b[2], b[3]);
      }
    }

    const bool interior = k0 >= max_lo && k0 + BK <= min_hi;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cl = j * 8 + 2 * t4 + (e & 1);
        float x = s[j][e] * qscale;
        if (kQuant) x *= ks_ring[buf * BK + cl];
        if (!interior) {
          const int kp = k0 + cl;
          const bool live = e < 2 ? (kp >= lo0 && kp < hi0)
                                  : (kp >= lo1 && kp < hi1);
          if (!live) x = -INFINITY;
        }
        s[j][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    const float ms0 = mn0 == -INFINITY ? 0.f : mn0;  // rows masked so far
    const float ms1 = mn1 == -INFINITY ? 0.f : mn1;
    const float corr0 = exp2f(m0 - ms0), corr1 = exp2f(m1 - ms1);
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pr = exp2f(s[j][e] - (e < 2 ? ms0 : ms1));  // 0 at -inf
        if (e < 2) ps0 += pr; else ps1 += pr;
        s[j][e] = kQuant ? pr * vs_ring[buf * BK + j * 8 + 2 * t4 + (e & 1)]
                         : pr;
      }
    l0 = l0 * corr0 + ps0;
    l1 = l1 * corr1 + ps1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int nn = 0; nn < ND; ++nn) {
      o[nn][0] *= corr0; o[nn][1] *= corr0;
      o[nn][2] *= corr1; o[nn][3] *= corr1;
    }
    // O += P V: V rows are keys, so ldmatrix.trans gives the B fragments.
    // Two things keep the probabilities as precise as the plain version's
    // float32 ones (a coarser P moves the served logits measurably): p
    // goes in as three bf16 parts, hi = bf16(p), lo = bf16(p - hi), lo2 =
    // bf16(p - hi - lo), so that hi + lo + lo2 = p to ~2^-26; and each
    // 16-key slice is summed into a fresh accumulator, smallest part
    // first, then added to o in float32, so that the tensor core's
    // truncating adds never act at o's magnitude. The products are not
    // what bounds this form.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t hi[4], lo[4], lo2[4];
      split_bf16(hi[0], lo[0], lo2[0], s[2 * kk][0], s[2 * kk][1]);
      split_bf16(hi[1], lo[1], lo2[1], s[2 * kk][2], s[2 * kk][3]);
      split_bf16(hi[2], lo[2], lo2[2], s[2 * kk + 1][0], s[2 * kk + 1][1]);
      split_bf16(hi[3], lo[3], lo2[3], s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int nn = 0; nn < ND; nn += 2) {
        uint32_t b[4];
        const int mi = lane / 8;
        ldmatrix_x4_trans(b, Vt + (kk * 16 + (mi % 2) * 8 + lane % 8) * LD +
                                 nn * 8 + (mi / 2) * 8);
        float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
        mma16816(t0, lo2, b[0], b[1]);
        mma16816(t1, lo2, b[2], b[3]);
        mma16816(t0, lo, b[0], b[1]);
        mma16816(t1, lo, b[2], b[3]);
        mma16816(t0, hi, b[0], b[1]);
        mma16816(t1, hi, b[2], b[3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          o[nn][e] += t0[e];
          o[nn + 1][e] += t1[e];
        }
      }
    }
    __syncthreads();  // every warp is done with buf before its refill
  }

  const float inv0 = 1.f / fmaxf(quad_sum(l0), 1e-20f);
  const float inv1 = 1.f / fmaxf(quad_sum(l1), 1e-20f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? r1 : r0;
    const int tok = r / G;
    if (tok >= n) continue;
    const float inv = half ? inv1 : inv0;
    bf16* row = a.out + (static_cast<long long>(t0 + tok) * c.num_heads +
                         kvh * G + r % G) * D + 2 * t4;
#pragma unroll
    for (int nn = 0; nn < ND; ++nn)
      *reinterpret_cast<uint32_t*>(row + nn * 8) =
          pack_bf16(o[nn][2 * half] * inv, o[nn][2 * half + 1] * inv);
  }
}

// -- launches -----------------------------------------------------------------

// Set the kernel's dynamic shared memory limit, launch, and return
// cudaGetLastError() (0 = launched).
template <typename Kernel, typename Args>
int launch(Kernel kernel, dim3 grid, int threads, int smem,
           cudaStream_t stream, const Args& args) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

// Half-warps of a split block: 8 (128 threads) for a group of up to 8
// query heads, else one per head rounded up to whole warps.
int split_threads(int group) {
  return 16 * (group <= 8 ? 8 : (group + 1) / 2 * 2);
}

template <typename QT, typename KT, int D>
int launch_split(const SplitArgs& a, cudaStream_t stream) {
  using SS = SplitShape<KT, D>;
  const int threads = split_threads(a.c.num_heads / a.c.num_kv_heads);
  const int red = 4 * (threads / 16) * (D + 2);  // the final merge
  const int smem = SS::ring_bytes > red ? SS::ring_bytes : red;
  return launch(rpa_split_kernel<QT, KT, D>,
                dim3(a.c.num_tokens, a.c.num_kv_heads, a.n_splits), threads,
                smem, stream, a);
}

Common make_common(const void* q, const void* k_pages, const void* v_pages,
                   const void* k_scales, const void* v_scales,
                   const void* page_table, const void* context_lens,
                   const void* positions, const void* token_lane,
                   int num_tokens, int num_heads, int num_kv_heads,
                   int page_size, int max_pages, int window, float scale) {
  return Common{q, k_pages, v_pages,
                static_cast<const float*>(k_scales),
                static_cast<const float*>(v_scales),
                static_cast<const int*>(page_table),
                static_cast<const int*>(context_lens),
                static_cast<const int*>(positions),
                static_cast<const int*>(token_lane), num_tokens, num_heads,
                num_kv_heads, page_size, max_pages, window, scale};
}

bool bad_common(const Common& c) {
  return c.num_kv_heads <= 0 || c.num_heads % c.num_kv_heads != 0 ||
         c.num_heads / c.num_kv_heads > 32 || c.page_size <= 0 ||
         c.max_pages <= 0 || c.num_kv_heads > 65535;
}

}  // namespace

// Each entry returns cudaGetLastError() after its launch (0 = launched),
// or cudaErrorInvalidValue for a shape or dtype its kernel does not take.
// The wrapper has checked shapes, dtypes, contiguity and the 16-byte
// alignment of the page pools. Common arguments: q [T, H, D], the page
// pools [NP, PS, KV, D] (int8: codes, and scales [NP, PS, KV] float32),
// page_table [L, max_pages], context_lens [L], positions [T], token_lane
// [T], all int32.

// (a) The split form: partials (m, l) [T, H, n_splits] and acc [T, H,
// n_splits, D] float32 of every token whose split_tok is 1 (all tokens
// when split_tok is null); split s covers the live keys [kstart + s *
// split_keys, kstart + (s + 1) * split_keys).
extern "C" int rpa_split(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* page_table,
    const void* context_lens, const void* positions, const void* token_lane,
    const void* split_tok, void* part_m, void* part_l, void* part_acc,
    int num_tokens, int num_heads, int num_kv_heads, int head_dim,
    int page_size, int max_pages, int window, int n_splits, int split_keys,
    float scale, int q_dtype, int kv_dtype, void* stream) {
  if (num_tokens == 0) return 0;
  const SplitArgs a{
      make_common(q, k_pages, v_pages, k_scales, v_scales, page_table,
                  context_lens, positions, token_lane, num_tokens, num_heads,
                  num_kv_heads, page_size, max_pages, window, scale),
      static_cast<const int*>(split_tok), static_cast<float*>(part_m),
      static_cast<float*>(part_l), static_cast<float*>(part_acc), n_splits,
      split_keys};
  if (bad_common(a.c) || n_splits <= 0 || n_splits > 65535 ||
      split_keys <= 0)
    return kInvalid;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RPA_SPLIT_D(QT, KT)                                \
  switch (head_dim) {                                      \
    case 64: return launch_split<QT, KT, 64>(a, s);        \
    case 128: return launch_split<QT, KT, 128>(a, s);      \
    case 256: return launch_split<QT, KT, 256>(a, s);      \
    default: return kInvalid;                              \
  }
#define RPA_SPLIT_KV(QT)                                   \
  switch (kv_dtype) {                                      \
    case kF32: RPA_SPLIT_D(QT, float)                      \
    case kBF16: RPA_SPLIT_D(QT, bf16)                      \
    case kI8: RPA_SPLIT_D(QT, int8_t)                      \
    default: return kInvalid;                              \
  }
  switch (q_dtype) {
    case kF32: RPA_SPLIT_KV(float)
    case kBF16: RPA_SPLIT_KV(bf16)
    default: return kInvalid;
  }
  return kInvalid;
#undef RPA_SPLIT_KV
#undef RPA_SPLIT_D
}

// The split form's second pass: out [T, H, D] in q's dtype for every token
// whose split_tok is 1 (all when null).
extern "C" int rpa_combine(const void* part_m, const void* part_l,
                           const void* part_acc, const void* split_tok,
                           void* out, int num_tokens, int num_heads,
                           int head_dim, int n_splits, int q_dtype,
                           void* stream) {
  if (num_tokens == 0) return 0;
  if (n_splits <= 0 || num_heads <= 0 || num_heads > 65535) return kInvalid;
  const dim3 grid(num_tokens, num_heads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pm = static_cast<const float*>(part_m);
  const float* pl = static_cast<const float*>(part_l);
  const float* pa = static_cast<const float*>(part_acc);
  const int* st = static_cast<const int*>(split_tok);
#define RPA_COMBINE(QT, D)                                                  \
  rpa_combine_kernel<QT, D><<<grid, D, 0, s>>>(pm, pl, pa, st,              \
                                               static_cast<QT*>(out),       \
                                               num_heads, n_splits);        \
  return static_cast<int>(cudaGetLastError());
#define RPA_COMBINE_D(QT)                    \
  switch (head_dim) {                        \
    case 64: { RPA_COMBINE(QT, 64) }         \
    case 128: { RPA_COMBINE(QT, 128) }       \
    case 256: { RPA_COMBINE(QT, 256) }       \
    default: return kInvalid;                \
  }
  switch (q_dtype) {
    case kF32: RPA_COMBINE_D(float)
    case kBF16: RPA_COMBINE_D(bf16)
    default: return kInvalid;
  }
  return kInvalid;
#undef RPA_COMBINE_D
#undef RPA_COMBINE
}

// (b) The tile form: bf16 q over bf16 or int8 pages, head_dim 64 or 128.
// out [T, H, D] bf16 for the tokens of the tiles: with a tile table
// [n_tiles][2] of (first token, tokens), or with tiles null the rectangular
// layout of rows of rect_s tokens (lane = row), each row cut every
// tile_tokens tokens (n_tiles = rows * ceil(rect_s / tile_tokens)). A
// tile's tokens share one lane; tile_tokens * G <= 64.
extern "C" int rpa_tile(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* page_table,
    const void* context_lens, const void* positions, const void* token_lane,
    const void* tiles, int n_tiles, int rect_s, int tile_tokens, void* out,
    int num_tokens, int num_heads, int num_kv_heads, int head_dim,
    int page_size, int max_pages, int window, float scale, int kv_dtype,
    void* stream) {
  if (num_tokens == 0 || n_tiles == 0) return 0;
  const TileArgs a{
      make_common(q, k_pages, v_pages, k_scales, v_scales, page_table,
                  context_lens, positions, token_lane, num_tokens, num_heads,
                  num_kv_heads, page_size, max_pages, window, scale),
      static_cast<const int*>(tiles), rect_s, tile_tokens,
      static_cast<bf16*>(out)};
  const int G = num_kv_heads > 0 ? num_heads / num_kv_heads : 0;
  if (bad_common(a.c) || n_tiles < 0 || tile_tokens <= 0 ||
      tile_tokens * G > kTileRows || (tiles == nullptr && rect_s <= 0))
    return kInvalid;
  const dim3 grid(n_tiles, num_kv_heads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RPA_TILE(KT, D)                                                     \
  return launch(rpa_tile_kernel<KT, D>, grid, kTileThreads,                 \
                TileShape<KT, D>::bytes, s, a);
  if (kv_dtype == kBF16 && head_dim == 64) { RPA_TILE(bf16, 64) }
  if (kv_dtype == kBF16 && head_dim == 128) { RPA_TILE(bf16, 128) }
  if (kv_dtype == kI8 && head_dim == 64) { RPA_TILE(int8_t, 64) }
  if (kv_dtype == kI8 && head_dim == 128) { RPA_TILE(int8_t, 128) }
#undef RPA_TILE
  return kInvalid;
}
