// Weight-only GEMM (K7) for Hopper (sm_90a), behind a plain C interface
// that paddle_tpu_torch/ops/weight_only_kernel.py loads through ctypes.
//
// Replaces no TPU kernel: the JAX package has no Pallas kernel here. Its
// weight-only linear (paddle_tpu/nn/quant/__init__.py:140-156) and PTQ's
// int8 product (paddle_tpu/quantization/ptq.py:60-70) are jnp code that
// XLA fuses, the convert and scale folded into the dot's operand read, so
// no dequantized copy of a weight ever exists in device memory. PyTorch
// fuses nothing of the kind: dequantizing into a bf16 tensor and calling
// a matmul would move ~5 bytes a weight instead of 1 (int8) or 0.5
// (int4), slower than the unquantized model. So the dequantization
// happens here, in registers.
//
//   y[M, N] = x[M, K] . dequant(codes)^T (+ bias)
//
// codes [N, K] int8, or [N, K/2] int4 (byte i of a row holds k = 2i in
// its low nibble and 2i + 1 in its high one, signed), scales [N, K/g]
// float32 (g = K for per-channel scales). The arithmetic is the
// reference's: the scale is rounded to x's dtype, each weight code *
// scale is rounded to x's dtype, the products are summed in float32 (the
// sum's order is the only freedom), the sum rounded to x's dtype, and
// the bias (in x's dtype) added and rounded again. A8 (x int8, codes
// int8, per-channel scales): the int32 sum of x * code, exact, then
// (float)acc * (sx * (scale / 127)), each op rounded as written, in the
// output dtype.
//
// What bounds it: at decode (M <= 8) bytes. The weights are read once:
// LLaMA-2-7B's trunk is 6.48 GB in int8 (1.93 ms at 3.35 TB/s) and 3.24
// GB in int4 (0.97 ms), against 12.95 GB (3.87 ms) in bf16. At prefill
// (M in the hundreds or thousands) bf16 tensor-core operations. The
// forms, picked by the wrapper's plan() from M and the dtypes (times
// below: LLaMA-2-7B's gate/up, k 4096 -> n 11008, on an H100 SXM at 700
// W, from paddle_tpu_torch/tools/k7_ab.py):
//
// (a) k7_decode_kernel (CUDA cores): float32 x and A8 at any M, bf16 at
//     M <= 8 where K is not a multiple of 64, MT <= 8 tokens a pass. A
//     block of 8 warps owns 4 output rows and MT tokens; its warps split
//     K (warp w takes 16-element chunks w*32 + lane, w*32 + lane + 256,
//     ...), so even N = 1024 (GQA k/v) gives 256 blocks. A lane reads 16
//     codes a row with a streaming load that does not allocate in L1,
//     where x stays. Each code becomes a float by the magic-number trick
//     (byte into a float's mantissa, then one subtract), is scaled and
//     rounded, and enters MT fused multiply-adds; A8 sums with dp4a.
//     Lanes reduce with shuffles, warps through shared memory in a fixed
//     order, and the epilogue rounds and adds the bias.
// (a') k7_decode_mma_kernel (bf16, int8 codes, M <= 8): the same
//     streaming with the multiply-adds on the tensor cores (described
//     above it). Bound by bytes: ~58 % of its byte bound, faster than
//     cuBLAS on the unquantized bf16 weight (~0.023 against ~0.034 ms).
// (a'') k7_decode_int4_kernel (bf16, int4 codes, M <= 8). The int4 arm of
//     (a') was bound by its conversion, not by bytes: it read ~0.025 ms,
//     ~0.009 with the conversion patched out, and no faster with x read
//     from L1 (so not the x re-reads from L2) or with 16-byte loads (so
//     not the bytes in flight). Now a lane loads 16 bytes of codes (32
//     nibbles) a row, and a byte's two nibbles become one bf16x2 A
//     register in a PRMT, a LOP3 and two HFMA2 (pair4: exact, the one
//     rounding the scale's multiply), so ~0.015 ms, faster than int8.
//     Left: the loop's latency (three blocks an SM, one chunk a warp in
//     flight; more rows a warp or deeper buffering read no faster).
// (b) k7_tile_wgmma_kernel (bf16 x, M > 8). The first tile form
//     (mma.sync over 64 x 64 tiles, each step's codes dequantized into a
//     bf16 tile in shared memory between barriers) was bound by its
//     products and its dequantization, done once a 64-row tile of x: ~4x
//     cuBLAS at a 256-row prefill chunk. Now "swap AB" on wgmma: the
//     block's 128 weight rows are wgmma's M (64 a consumer warpgroup),
//     the tokens its N (a token tile of 64, 128 or 256: a 256-row chunk
//     is one tile, so each weight is dequantized once a call). A
//     producer warp keeps a 4-stage mbarrier ring full by TMA: x [TN][64]
//     (128-byte swizzle, K-major B operand; rows past M come in as
//     zeros) and the codes [128][64 bytes int8, 32 int4] (64/32-byte
//     swizzle). Each consumer thread turns its rows' codes into the A
//     fragments in registers (wgmma's RS form: a dequantized weight
//     never goes through shared memory; the int4 pair a register is one
//     byte's two nibbles), step s + 1's while step s's wgmma runs. Where
//     the blocks would leave SMs idle, K is split across blocks into
//     float32 partials that k7_finish_kernel sums in split order with
//     the epilogue; plan() picks the token tile and the split from a
//     cost model fitted to the kernel's times (k7_ab.py --sweep, --fit).
//     ~0.057 ms at M 256 (~3.2x faster than the first form, ~1.5x
//     cuBLAS), ~0.62 at M 4096 (~1.2x cuBLAS). What bounds it, from the
//     K7_PROBE builds (k7_ab.py --probe, int8): at M 40 the ring of loads
//     (0.025 of 0.035 ms with no dequantization and no products; x
//     loaded once saves ~2 %, the split partials ~6 %): one block an SM
//     streams ~16 KB a stage, plus a fixed cost a wave. At M 256 the 86
//     blocks leave 46 SMs idle (a split fills them, its partials cost
//     more) and the A build is ~20 %. At M 4096 the A build (~19 %: each
//     weight is dequantized once a 256-token tile) and the products
//     (0.50 ms without the A build, ~75 % of the bf16 peak); x's L2
//     re-reads cost ~3 %. Left: more bytes in flight an SM at small M,
//     and fewer A builds at large M.
#include <cuda.h>  // CUtensorMap (types only: no driver library is linked)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

// Probes: a build with K7_PROBE defined as n (paddle_tpu_torch/tools/
// k7_ab.py --probe builds a file that defines it and includes this one)
// drops one part of a form's work, so its values are wrong and only its
// time is read. 0, the shipped build, drops nothing.
//   1 the tile form's A fragments made of the scales alone (no codes read
//     from shared memory, no conversion): what the dequantization costs
//   2 the int4 decode form's conversion
//   3 the tile form's consumers only wait for each stage and free it (no
//     dequantization, no products): what the ring of loads alone takes
//   4 the tile form's x loaded in the ring's first round only, the later
//     stages computing on stale x: what x's re-reads from L2 cost
//   5 the split tile form's partials neither written nor summed
#ifndef K7_PROBE
#define K7_PROBE 0
#endif

namespace {

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };
typedef __nv_bfloat16 bf16;

constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);
constexpr int kWarps = 8;             // decode form: warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 4;              // decode form: output rows a block
constexpr int kChunk = 16;            // k elements a lane takes at a time

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// mbarriers, TMA, wgmma and the host's tensor maps, shared with the
// flash-attention kernels
#include "sm90.cuh"

struct Args {
  const void* x;        // [M, K] float32, bf16 or (A8) int8
  const int8_t* codes;  // [N, K] int8 or [N, K/2] int4
  const float* scale;   // [N, K/group]
  const void* bias;     // [N] in the output dtype, or null
  void* y;              // [M, N]
  float* part;          // [splits, M, N] float32 partials (tile form)
  int M, N, K, group, groups, splits, steps_per_split;
  float sx;             // A8: the activation scale / 127
};

// -- loads -------------------------------------------------------------------

// 16 bytes of codes, streamed: read once, not kept in L1 (x lives there).
__device__ __forceinline__ uint4 ld_stream16(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}
__device__ __forceinline__ uint2 ld_stream8(const void* p) {
  uint2 v;
  asm volatile("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];"
               : "=r"(v.x), "=r"(v.y)
               : "l"(p));
  return v;
}

// The 16 codes of a row's chunk as four 32-bit words: int8 codes one byte
// each; int4 codes as 8 nibbles a word (the first two words).
template <bool W4>
__device__ __forceinline__ void load_codes(uint32_t (&q)[4], const Args& a,
                                           int row, int k0) {
  if (row >= a.N) {
    q[0] = q[1] = q[2] = q[3] = 0u;
    return;
  }
  if constexpr (W4) {
    const uint2 v = ld_stream8(a.codes + static_cast<long long>(row) *
                                             (a.K / 2) + k0 / 2);
    q[0] = v.x;
    q[1] = v.y;
    q[2] = q[3] = 0u;
  } else {
    const uint4 v =
        ld_stream16(a.codes + static_cast<long long>(row) * a.K + k0);
    q[0] = v.x;
    q[1] = v.y;
    q[2] = v.z;
    q[3] = v.w;
  }
}

// -- codes to floats ------------------------------------------------------

// Element e (0..3) of a word of int8 codes, exactly, as a float: the
// biased byte c + 128 placed in the mantissa of 2^23, then 2^23 + 128
// subtracted (no integer-to-float conversion, which runs at a quarter of
// the FMA rate).
__device__ __forceinline__ float code8(uint32_t biased, int e) {
  return __int_as_float(
             static_cast<int>(__byte_perm(biased, 0x4B000000u, 0x7540 + e))) -
         8388736.0f;
}
// Element e (0..7) of a word of int4 codes (nibble e), exactly.
__device__ __forceinline__ float code4(uint32_t biased, int e) {
  return __int_as_float(static_cast<int>(((biased >> (4 * e)) & 0xFu) |
                                         0x4B000000u)) -
         8388616.0f;
}

// Code j (0..15) of a chunk as a float.
template <bool W4>
__device__ __forceinline__ float code_at(const uint32_t (&b)[4], int j) {
  if constexpr (W4)
    return code4(b[j >> 3], j & 7);
  else
    return code8(b[j >> 2], j & 3);
}

template <bool W4>
__device__ __forceinline__ void bias_codes(uint32_t (&b)[4],
                                           const uint32_t (&q)[4]) {
  const uint32_t flip = W4 ? 0x88888888u : 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i) b[i] = q[i] ^ flip;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The scale of element k0 + j of a row, rounded to x's dtype. Groups of a
// multiple of 16 give a chunk one scale; other group sizes (any that
// divides K) look each element up.
template <bool BF16>
__device__ __forceinline__ float scale_at(const Args& a, int row, int k) {
  const float s = row < a.N ? a.scale[static_cast<long long>(row) * a.groups +
                                      k / a.group]
                            : 0.0f;
  return BF16 ? round_bf16(s) : s;
}

// -- the epilogue ---------------------------------------------------------

template <int OT>
__device__ __forceinline__ void store_out(const Args& a, int m, int n,
                                          float acc) {
  const long long i = static_cast<long long>(m) * a.N + n;
  if constexpr (OT == kBF16) {
    bf16 v = __float2bfloat16_rn(acc);
    if (a.bias)
      v = __float2bfloat16_rn(__bfloat162float(v) +
                              __bfloat162float(
                                  static_cast<const bf16*>(a.bias)[n]));
    static_cast<bf16*>(a.y)[i] = v;
  } else {
    float v = acc;
    if (a.bias) v = __fadd_rn(v, static_cast<const float*>(a.bias)[n]);
    static_cast<float*>(a.y)[i] = v;
  }
}

// -- (a) the decode form ----------------------------------------------------

// 4 consecutive x elements of one token as floats (bf16 / float32).
template <int XT>
__device__ __forceinline__ void load_x4(float (&v)[4], const Args& a, int m,
                                        int k) {
  const long long i = static_cast<long long>(m) * a.K + k;
  if constexpr (XT == kBF16) {
    const uint2 u =
        __ldg(reinterpret_cast<const uint2*>(static_cast<const bf16*>(a.x) + i));
    v[0] = __uint_as_float(u.x << 16);
    v[1] = __uint_as_float(u.x & 0xffff0000u);
    v[2] = __uint_as_float(u.y << 16);
    v[3] = __uint_as_float(u.y & 0xffff0000u);
  } else {
    const float4 u =
        __ldg(reinterpret_cast<const float4*>(static_cast<const float*>(a.x) + i));
    v[0] = u.x;
    v[1] = u.y;
    v[2] = u.z;
    v[3] = u.w;
  }
}

// XT: x's dtype (kF32, kBF16, or kI8 for A8); OT: y's dtype.
template <int XT, int OT, bool W4, int MT>
__global__ void __launch_bounds__(kThreads, 2)
    k7_decode_kernel(const Args a) {
  constexpr bool A8 = XT == kI8;
  typedef typename std::conditional<A8, int, float>::type Acc;
  __shared__ Acc red[kWarps][kRows][MT];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * kRows;
  const int m0 = blockIdx.y * MT;
  const int nch = a.K / kChunk;
  Acc acc[kRows][MT];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[r][m] = 0;

  for (int c = threadIdx.x; c < nch; c += kThreads) {
    const int k0 = c * kChunk;
    uint32_t q[kRows][4];
#pragma unroll
    for (int r = 0; r < kRows; ++r) load_codes<W4>(q[r], a, n0 + r, k0);
    if constexpr (A8) {
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m0 + m >= a.M) break;
        const uint4 u = __ldg(reinterpret_cast<const uint4*>(
            static_cast<const int8_t*>(a.x) +
            static_cast<long long>(m0 + m) * a.K + k0));
        const int xv[4] = {static_cast<int>(u.x), static_cast<int>(u.y),
                           static_cast<int>(u.z), static_cast<int>(u.w)};
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[r][m] = __dp4a(xv[i], static_cast<int>(q[r][i]), acc[r][m]);
      }
    } else {
      constexpr bool BF16 = XT == kBF16;
      const bool one = a.group % kChunk == 0;
      float s[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        bias_codes<W4>(q[r], q[r]);
        s[r] = scale_at<BF16>(a, n0 + r, k0);
      }
      // four elements at a time: the weights of every row, then every
      // token's x against them
#pragma unroll
      for (int sub = 0; sub < kChunk / 4; ++sub) {
        float w[kRows][4];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = 4 * sub + e;
            const float sc = one ? s[r] : scale_at<BF16>(a, n0 + r, k0 + j);
            const float v = __fmul_rn(code_at<W4>(q[r], j), sc);
            w[r][e] = BF16 ? round_bf16(v) : v;
          }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          if (m0 + m >= a.M) break;
          float xv[4];
          load_x4<XT>(xv, a, m0 + m, k0 + 4 * sub);
#pragma unroll
          for (int r = 0; r < kRows; ++r)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[r][m] = fmaf(xv[e], w[r][e], acc[r][m]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      Acc v = acc[r][m];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane == 0) red[warp][r][m] = v;
    }
  __syncthreads();
  if (threadIdx.x < kRows * MT) {
    const int r = threadIdx.x / MT, m = threadIdx.x % MT;
    const int n = n0 + r, mm = m0 + m;
    if (n < a.N && mm < a.M) {
      Acc v = red[0][r][m];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) v += red[w][r][m];
      if constexpr (A8) {
        // (float)acc * (sx * (scale / 127)), each op rounded in turn
        const float s = __fmul_rn(a.sx, __fdiv_rn(a.scale[n], 127.0f));
        const float f = __fmul_rn(__int2float_rn(v), s);
        const long long i = static_cast<long long>(mm) * a.N + n;
        if constexpr (OT == kBF16)
          static_cast<bf16*>(a.y)[i] = __float2bfloat16_rn(f);
        else
          static_cast<float*>(a.y)[i] = f;
      } else {
        store_out<OT>(a, mm, n, v);
      }
    }
  }
}

__device__ __forceinline__ uint32_t bf2_fma(uint32_t a, uint32_t b,
                                            uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}
constexpr uint32_t kBf2NegOne = 0xBF80BF80u, kBf2NegZero = 0x80008000u;

// Two codes as two bf16 weights (low half k, high half k + 1), each code *
// scale rounded once, as dequantize() rounds it. Every step before the
// multiply is exact: the code is built as a bf16 integer 128 + m (the
// magic exponent 2^7, m in the 7-bit mantissa) less a bf16 integer, and
// a code of at most 8 bits times a bf16 scale fits float32's product, so
// the one rounding is the multiply's (fma with -0).
// int8: p holds code k in bits 0-7 and code k + 1 in bits 16-23; a code c
// = m - 128 s (m its low 7 bits, s its sign bit) is (128 + m) - (128 +
// 128 s), the second term 0x4300 or 0x4380.
__device__ __forceinline__ uint32_t pair8(uint32_t p, uint32_t s2) {
  const uint32_t mag = (p & 0x007F007Fu) | 0x43004300u;
  const uint32_t off = (p & 0x00800080u) | 0x43004300u;
  return bf2_fma(bf2_fma(off, kBf2NegOne, mag), s2, kBf2NegZero);
}
// int4: p holds nibble k in bits 0-3 and nibble k + 1 in bits 16-19; the
// nibble with its sign bit flipped is c + 8, so the half is 136 + c.
__device__ __forceinline__ uint32_t pair4(uint32_t p, uint32_t s2) {
  const uint32_t v = (p & 0x000F000Fu) ^ 0x43084308u;
  return bf2_fma(bf2_fma(0x43084308u, kBf2NegOne, v), s2, kBf2NegZero);
}
// The bf16x2 scales of codes k and k + 1 of a row (each rounded to bf16),
// 0 past the last row.
__device__ __forceinline__ uint32_t scale2(const Args& a, int row, int k) {
  if (row >= a.N) return 0u;
  const float* s = a.scale + static_cast<long long>(row) * a.groups;
  const float lo = __ldg(s + k / a.group);
  const float hi = a.group % 2 ? __ldg(s + (k + 1) / a.group) : lo;
  return pack_bf16(lo, hi);
}
// Byte j of w in byte 0 and byte j of w >> 4 in byte 2: the byte's low
// nibble in bits 0-3, its high nibble in bits 16-19, as pair4 takes them.
__device__ __forceinline__ uint32_t nibble_pair(uint32_t w, uint32_t w4,
                                                int j) {
  return __byte_perm(w, w4, j | (4 + j) << 8);
}

// (a') the decode form in bf16 over int8 codes (M <= 8, K a multiple of
// 64): the same
// weight streaming, with the multiply-adds on the tensor cores instead
// of the CUDA cores ("swap AB": the 16 output rows of a warp are the A
// operand of mma.sync m16n8k16, the 8 tokens of x its B operand). The
// sum runs over k in any order, so a lane's 16 codes of a row (one
// 16-byte load) and its 16 x values of a token (two 16-byte loads) are
// placed in the fragments of four consecutive mma k-steps: lane (g, q)
// holds real k = base + 16 q + 4 s + {0, 1} as the virtual k 2q, 2q + 1
// of step s, and + {2, 3} as 2q + 8, 2q + 9, in A and B alike. A block's
// 8 warps own 16 rows and split K in 64-wide chunks, two in flight a
// warp (double-buffering the registers for four cost occupancy and
// time); the CUDA cores only dequantize (about 3.5 operations a
// weight).
__device__ __forceinline__ void dequant_pairs(uint32_t (&w)[8],
                                              uint32_t (&q)[4],
                                              const Args& a, int row,
                                              int k0) {
  bias_codes<false>(q, q);
  const bool one = a.group % kChunk == 0;
  const float s0 = scale_at<true>(a, row, k0);
#pragma unroll
  for (int j = 0; j < kChunk / 2; ++j) {
    float v[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = 2 * j + e;
      const float sc = one ? s0 : scale_at<true>(a, row, k0 + i);
      v[e] = __fmul_rn(code_at<false>(q, i), sc);
    }
    const __nv_bfloat162 p = __floats2bfloat162_rn(v[0], v[1]);
    w[j] = *reinterpret_cast<const uint32_t*>(&p);
  }
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

__global__ void __launch_bounds__(kThreads)
    k7_decode_mma_kernel(const Args a) {
  constexpr int kSpan = 64;  // k a warp's chunk covers (4 mma k-steps)
  __shared__ float red[kWarps][16][8];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int n0 = blockIdx.x * 16;
  const bf16* xrow = static_cast<const bf16*>(a.x) +
                     static_cast<long long>(min(g, a.M - 1)) * a.K;
  const int nch = a.K / kSpan;
  float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int ch = warp; ch < nch; ch += 2 * kWarps) {
    uint32_t qa[2][4], qb[2][4], xw[2][8];
#pragma unroll
    for (int u = 0; u < 2; ++u) {   // both chunks' loads first
      const int cu = min(ch + u * kWarps, nch - 1);
      const int k0 = cu * kSpan + q * kChunk;
      load_codes<false>(qa[u], a, n0 + g, k0);
      load_codes<false>(qb[u], a, n0 + g + 8, k0);
      const uint4* xp = reinterpret_cast<const uint4*>(xrow + k0);
      const uint4 x0 = __ldg(xp), x1 = __ldg(xp + 1);
      xw[u][0] = x0.x; xw[u][1] = x0.y; xw[u][2] = x0.z; xw[u][3] = x0.w;
      xw[u][4] = x1.x; xw[u][5] = x1.y; xw[u][6] = x1.z; xw[u][7] = x1.w;
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (ch + u * kWarps >= nch) break;
      const int k0 = (ch + u * kWarps) * kSpan + q * kChunk;
      uint32_t wa[8], wb[8];
      dequant_pairs(wa, qa[u], a, n0 + g, k0);
      dequant_pairs(wb, qb[u], a, n0 + g + 8, k0);
#pragma unroll
      for (int st = 0; st < 4; ++st) {
        const uint32_t af[4] = {wa[2 * st], wb[2 * st], wa[2 * st + 1],
                                wb[2 * st + 1]};
        mma16816(c, af, xw[u][2 * st], xw[u][2 * st + 1]);
      }
    }
  }
  // c0, c1: row g, tokens 2q, 2q + 1; c2, c3: row g + 8
  red[warp][g][2 * q] = c[0];
  red[warp][g][2 * q + 1] = c[1];
  red[warp][g + 8][2 * q] = c[2];
  red[warp][g + 8][2 * q + 1] = c[3];
  __syncthreads();
  if (threadIdx.x < 16 * 8) {
    const int r = threadIdx.x >> 3, m = threadIdx.x & 7;
    if (n0 + r < a.N && m < a.M) {
      float v = red[0][r][m];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) v += red[w][r][m];
      store_out<kBF16>(a, m, n0 + r, v);
    }
  }
}

// The 16 weight pairs of a lane's 32 k of one row (byte j of the 16 bytes
// q: pair j), k0 the first k; srow the row's scale under per-channel scales.
__device__ __forceinline__ void dequant16(uint32_t (&w)[16], const uint4& q,
                                          const Args& a, int row, int k0,
                                          bool one, uint32_t srow) {
  uint32_t s[16];
  if (one) {
    const uint32_t s0 = a.groups == 1 ? srow : scale2(a, row, k0);
#pragma unroll
    for (int j = 0; j < 16; ++j) s[j] = s0;
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j) s[j] = scale2(a, row, k0 + 2 * j);
  }
  const uint32_t v[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t hi = v[i] >> 4;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#if K7_PROBE == 2
      w[4 * i + j] = nibble_pair(v[i], hi, j) ^ s[4 * i + j];
#else
      w[4 * i + j] = pair4(nibble_pair(v[i], hi, j), s[4 * i + j]);
#endif
  }
}

// (a'') the decode form's int4 arm (bf16, M <= 8, K a multiple of 64): as
// (a'), but a lane loads 16 bytes of a row's codes (32 nibbles, k = base +
// 32 q + 0..31) and the codes become weights in bf16x2 (pair4), a byte's
// two nibbles one A register of mma.sync (byte j is the virtual k pair of
// step j / 2: even j 2q, 2q + 1, odd j 2q + 8, 2q + 9; x's 32-bit word j
// the same pair of token g). A warp's chunk spans 128 k, one chunk a loop.
// The loop is bound by latency: three blocks an SM (at most 85 registers)
// ran faster than two; a rolling double buffer of chunks, two chunks in
// flight, or 32 or 64 rows a warp sharing x's fragments, no faster.
struct Chunk4 {
  uint4 qa, qb;       // rows g and g + 8: 16 bytes of codes each
  uint32_t xw[16];    // token g's x at the same 32 k
};

__device__ __forceinline__ void load_chunk4(Chunk4& c, const Args& a,
                                            const bf16* xrow, int n0, int g,
                                            int k0, bool ok) {
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const long long pitch = a.K / 2;
  c.qa = ok && n0 + g < a.N ? ld_stream16(a.codes + (n0 + g) * pitch + k0 / 2)
                            : zero;
  c.qb = ok && n0 + g + 8 < a.N
             ? ld_stream16(a.codes + (n0 + g + 8) * pitch + k0 / 2)
             : zero;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint4 v =
        ok ? __ldg(reinterpret_cast<const uint4*>(xrow + k0) + i) : zero;
    c.xw[4 * i] = v.x;
    c.xw[4 * i + 1] = v.y;
    c.xw[4 * i + 2] = v.z;
    c.xw[4 * i + 3] = v.w;
  }
}

__global__ void __launch_bounds__(kThreads, 3)
    k7_decode_int4_kernel(const Args a) {
  constexpr int kSpan = 128;
  __shared__ float red[kWarps][16][8];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int n0 = blockIdx.x * 16;
  const bf16* xrow = static_cast<const bf16*>(a.x) +
                     static_cast<long long>(min(g, a.M - 1)) * a.K;
  const int nch = (a.K + kSpan - 1) / kSpan;
  const bool one = a.group % 32 == 0;
  // per-channel scales: one a row, read once
  const uint32_t sa = a.groups == 1 ? scale2(a, n0 + g, 0) : 0u;
  const uint32_t sb = a.groups == 1 ? scale2(a, n0 + g + 8, 0) : 0u;
  float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  auto k_of = [&](int ch) { return ch * kSpan + q * 32; };
  auto compute = [&](const Chunk4& ck, int ch) {
    // a lane past K (K % 128 == 64) has zero codes and x; its scales are
    // read at the last k
    const int k0 = min(k_of(ch), a.K - 32);
    uint32_t wa[16], wb[16];
    dequant16(wa, ck.qa, a, n0 + g, k0, one, sa);
    dequant16(wb, ck.qb, a, n0 + g + 8, k0, one, sb);
#pragma unroll
    for (int st = 0; st < 8; ++st) {
      const uint32_t af[4] = {wa[2 * st], wb[2 * st], wa[2 * st + 1],
                              wb[2 * st + 1]};
      mma16816(c, af, ck.xw[2 * st], ck.xw[2 * st + 1]);
    }
  };
  for (int ch = warp; ch < nch; ch += kWarps) {
    Chunk4 ck;
    load_chunk4(ck, a, xrow, n0, g, k_of(ch), k_of(ch) < a.K);
    compute(ck, ch);
  }
  red[warp][g][2 * q] = c[0];
  red[warp][g][2 * q + 1] = c[1];
  red[warp][g + 8][2 * q] = c[2];
  red[warp][g + 8][2 * q + 1] = c[3];
  __syncthreads();
  if (threadIdx.x < 16 * 8) {
    const int r = threadIdx.x >> 3, m = threadIdx.x & 7;
    if (n0 + r < a.N && m < a.M) {
      float v = red[0][r][m];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) v += red[w][r][m];
      store_out<kBF16>(a, m, n0 + r, v);
    }
  }
}

// -- (b) the tile form --------------------------------------------------------

constexpr int kTRows = 128;   // weight rows a block: two warpgroups of 64
constexpr int kTK = 64;       // k a stage (four wgmma k-steps)
constexpr int kTStages = 4;   // the ring's stages
constexpr int kKAlign = 32;   // every form takes K a multiple of this

template <bool W4, int TN>
struct TileShape {
  static constexpr int code_row = W4 ? kTK / 2 : kTK;  // bytes a row a stage
  static constexpr int x_bytes = TN * kTK * 2;  // [TN][64] bf16, 128B swizzle
  static constexpr int c_bytes = kTRows * code_row;
  static constexpr int stage = x_bytes + c_bytes;  // a multiple of 1024
  // the stages, 2 mbarriers a stage, + 1024 to align
  static constexpr int smem = kTStages * stage + 2 * kTStages * 8 + 1024;
};

// d (64 x N, float32) += A (64 x 16, bf16, registers) * B (16 x N, bf16,
// shared memory, K-major: the transpose bit clear).
template <int N>
__device__ __forceinline__ void wgmma_rs_kmajor(float (&d)[N / 2],
                                                const uint32_t (&a)[4],
                                                uint64_t db);
template <>
__device__ __forceinline__ void wgmma_rs_kmajor<64>(float (&d)[32],
                                                    const uint32_t (&a)[4],
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_kmajor<128>(float (&d)[64],
                                                    const uint32_t (&a)[4],
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_kmajor<256>(float (&d)[128],
                                                    const uint32_t (&a)[4],
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Keep the compiler from reusing A registers that an issued wgmma may still
// read: they stay live until this point, after the wait.
__device__ __forceinline__ void keep_regs(const uint32_t (&x)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" ::"r"(x[i]) : "memory");
}

// 16 bytes of shared memory at a shared-window address (an explicit
// ld.shared: a pointer realigned by integer arithmetic reads through the
// slower generic path otherwise); volatile, so that it stays after the
// stage's mbarrier wait.
__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

// One stage's A fragments of a thread, dequantized: the codes of rows r and
// r + 8 of the block (a tile at shared address `tile`, TMA's 64B (int8) or
// 32B (int4) swizzle), k0 the stage's first k. A[4 s + i] is fragment register
// i of k-step s: i = 0 row r and i = 1 row r + 8 at k 16 s + 2 t, + 1; i = 2
// and 3 the same rows at k 16 s + 8 + 2 t, + 1. sel picks those two codes
// out of a row's words (int8: bytes 2t, 2t + 1 of two words; int4: byte t
// of one word, whose nibbles are the pair). s2r: the rows' scales where
// the stage has one scale a row (per_step), else looked up a pair.
template <bool W4>
__device__ __forceinline__ void dequant_stage(uint32_t (&A)[16],
                                              uint32_t tile, const Args& a,
                                              int r, int n0, int k0, int t,
                                              uint32_t sel,
                                              const uint32_t (&s2r)[2],
                                              bool per_step) {
  constexpr int kRow = W4 ? kTK / 2 : kTK;
#if K7_PROBE == 1
#pragma unroll
  for (int i = 0; i < 16; ++i) A[i] = s2r[0] ^ (0x3f803f80u + i + k0);
  return;
#endif
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rr = r + 8 * h;
    const uint32_t p = tile + rr * kRow;
    const int swz = W4 ? (rr >> 2) & 1 : (rr >> 1) & 3;
    uint32_t w[kRow / 4];
#pragma unroll
    for (int j = 0; j < kRow / 16; ++j) {
      const uint4 v = lds128(p + 16 * (j ^ swz));
      w[4 * j] = v.x;
      w[4 * j + 1] = v.y;
      w[4 * j + 2] = v.z;
      w[4 * j + 3] = v.w;
    }
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int k = k0 + 16 * s + 2 * t;
      const uint32_t slo = per_step ? s2r[h] : scale2(a, n0 + rr, k);
      const uint32_t shi = per_step ? s2r[h] : scale2(a, n0 + rr, k + 8);
      if constexpr (W4) {
        A[4 * s + h] = pair4(__byte_perm(w[2 * s], w[2 * s] >> 4, sel), slo);
        A[4 * s + 2 + h] =
            pair4(__byte_perm(w[2 * s + 1], w[2 * s + 1] >> 4, sel), shi);
      } else {
        A[4 * s + h] = pair8(__byte_perm(w[4 * s], w[4 * s + 1], sel), slo);
        A[4 * s + 2 + h] =
            pair8(__byte_perm(w[4 * s + 2], w[4 * s + 3], sel), shi);
      }
    }
  }
}

template <bool W4, int TN>
__global__ void __launch_bounds__(kWgThreads, 1)
    k7_tile_wgmma_kernel(const Args a, const __grid_constant__ CUtensorMap tx,
                         const __grid_constant__ CUtensorMap tc) {
  using S = TileShape<W4, TN>;
  extern __shared__ unsigned char k7_smem[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(k7_smem) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(base + kTStages * S::stage);
  uint64_t* empty = full + kTStages;
  auto xs = [&](int st) {
    return reinterpret_cast<const bf16*>(base + st * S::stage);
  };
  auto cs = [&](int st) {
    return reinterpret_cast<const uint8_t*>(base + st * S::stage + S::x_bytes);
  };
  const int n0 = blockIdx.x * kTRows, m0 = blockIdx.y * TN;
  const int s0 = blockIdx.z * a.steps_per_split;
  const int n_it = min(a.K / kTK, s0 + a.steps_per_split) - s0;
  const int warp = warp_uniform(threadIdx.x / 32), lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kTStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWgConsumers / 32);  // one arrival a warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kWgConsumers / 32) {
    // -- the producer: one thread keeps the ring of x and code tiles full
    producer_regs();
    if (warp == kWgConsumers / 32 && lane == 0) {
      for (int it = 0; it < n_it; ++it) {
        const int st = it % kTStages;
        mbar_wait(&empty[st], ((it / kTStages) & 1) ^ 1);
        const bool load_x = K7_PROBE != 4 || it < kTStages;
        mbar_expect_tx(&full[st], load_x ? S::stage : S::c_bytes);
        if (load_x)
          tma_load(const_cast<bf16*>(xs(st)), &tx, &full[st],
                   (s0 + it) * kTK, m0, 0);
        tma_load(const_cast<uint8_t*>(cs(st)), &tc, &full[st],
                 (s0 + it) * S::code_row, n0, 0);
      }
    }
    return;
  }
  // -- the consumer warpgroups: 64 weight rows each, all TN tokens
  consumer_regs();
  const int wg = warp / 4, w4 = warp % 4, g = lane / 4, t = lane % 4;
  const int r = wg * 64 + w4 * 16 + g;  // this thread's rows: r, r + 8
  const uint32_t sel = W4 ? t | (4 + t) << 8 : 2 * t | (2 * t + 1) << 8;
  const bool per_step = a.group % kTK == 0, fixed = a.groups == 1;
  uint32_t s2r[2] = {0u, 0u};
  if (fixed)
    for (int h = 0; h < 2; ++h) s2r[h] = scale2(a, n0 + r + 8 * h, 0);
  float acc[TN / 2];
#pragma unroll
  for (int i = 0; i < TN / 2; ++i) acc[i] = 0.0f;
  uint32_t A0[16], A1[16];

  auto dequant = [&](uint32_t (&A)[16], int it) {
    const int st = it % kTStages;
    const int k0 = (s0 + it) * kTK;
    if (per_step && !fixed)
      for (int h = 0; h < 2; ++h) s2r[h] = scale2(a, n0 + r + 8 * h, k0);
    mbar_wait(&full[st], (it / kTStages) & 1);
    dequant_stage<W4>(A, smem_u32(cs(st)), a, r, n0, k0, t, sel, s2r,
                      per_step);
  };
  auto mma = [&](const uint32_t (&A)[16], int it) {
    const bf16* xt = xs(it % kTStages);
    wg_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const uint32_t f[4] = {A[4 * s], A[4 * s + 1], A[4 * s + 2],
                             A[4 * s + 3]};
      wgmma_rs_kmajor<TN>(acc, f, wg_desc(xt + 16 * s, 16));
    }
    wg_commit();
  };
  auto release = [&](const uint32_t (&A)[16], int it) {
    wg_wait0();
    wg_fence_regs(acc);
    keep_regs(A);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[it % kTStages]);
  };
#if K7_PROBE == 3
  for (int it = 0; it < n_it; ++it) {
    mbar_wait(&full[it % kTStages], (it / kTStages) & 1);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[it % kTStages]);
  }
#else
  // step it's products run while step it + 1's codes are dequantized
  if (n_it > 0) dequant(A0, 0);
  for (int it = 0; it < n_it; it += 2) {
    mma(A0, it);
    if (it + 1 < n_it) dequant(A1, it + 1);
    release(A0, it);
    if (it + 1 >= n_it) break;
    mma(A1, it + 1);
    if (it + 2 < n_it) dequant(A0, it + 2);
    release(A1, it + 1);
  }
#endif

  // acc[4 j + 2 h + e]: weight row r + 8 h, token 8 j + 2 t + e
#pragma unroll
  for (int j = 0; j < TN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = m0 + 8 * j + 2 * t + e, n = n0 + r + 8 * h;
        if (m >= a.M || n >= a.N) continue;
        const float v = acc[4 * j + 2 * h + e];
        if (a.splits == 1)
          store_out<kBF16>(a, m, n, v);
        else if (K7_PROBE != 5 || v != v)
          a.part[(static_cast<long long>(blockIdx.z) * a.M + m) * a.N + n] =
              v;
      }
}

// The split tile form's partials summed in split order, then the epilogue.
__global__ void k7_finish_kernel(const Args a) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const long long total = static_cast<long long>(a.M) * a.N;
  if (K7_PROBE == 5 || i >= total) return;
  float v = a.part[i];
  for (int s = 1; s < a.splits; ++s) v += a.part[s * total + i];
  store_out<kBF16>(a, static_cast<int>(i / a.N), static_cast<int>(i % a.N),
                   v);
}

template <int XT, int OT, bool W4>
int launch_decode(const Args& a, int mt, cudaStream_t s) {
  const dim3 grid((a.N + kRows - 1) / kRows, (a.M + mt - 1) / mt);
  if (grid.y > 65535) return kInvalid;
  switch (mt) {
    case 1: k7_decode_kernel<XT, OT, W4, 1><<<grid, kThreads, 0, s>>>(a); break;
    case 2: k7_decode_kernel<XT, OT, W4, 2><<<grid, kThreads, 0, s>>>(a); break;
    case 4: k7_decode_kernel<XT, OT, W4, 4><<<grid, kThreads, 0, s>>>(a); break;
    case 8: k7_decode_kernel<XT, OT, W4, 8><<<grid, kThreads, 0, s>>>(a); break;
    default: return kInvalid;
  }
  return static_cast<int>(cudaGetLastError());
}

// The tensor map of codes [N, row_bytes] bytes, read in [128 rows][64 or 32
// bytes] boxes with the 64B (int8) or 32B (int4) swizzle; rows past N come
// in as zeros.
bool codes_map(CUtensorMap* map, const void* codes, int N, int row_bytes,
               bool w4) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(row_bytes),
                              static_cast<cuuint64_t>(N), 1};
  const cuuint64_t strides[2] = {dims[0], dims[0] * dims[1]};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(w4 ? kTK / 2 : kTK),
                             static_cast<cuuint32_t>(kTRows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(codes),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             w4 ? CU_TENSOR_MAP_SWIZZLE_32B : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool W4, int TN>
int launch_tile(const Args& a, const dim3& grid, cudaStream_t s) {
  using S = TileShape<W4, TN>;
  CUtensorMap tx, tc;
  // x [M, K] as [1, M, K]: [TN rows][64] boxes, rows past M zeros
  if (!tensor_map(&tx, a.x, 1, a.M, 1, a.K, TN) ||
      !codes_map(&tc, a.codes, a.N, W4 ? a.K / 2 : a.K, W4))
    return kInvalid;
  static std::atomic<uint64_t> raised{0};
  const cudaError_t err = raise_smem_once(
      raised, reinterpret_cast<const void*>(k7_tile_wgmma_kernel<W4, TN>),
      S::smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  k7_tile_wgmma_kernel<W4, TN><<<grid, kWgThreads, S::smem, s>>>(a, tx, tc);
  return static_cast<int>(cudaGetLastError());
}

template <bool W4>
int launch_tile(const Args& a, int tn, const dim3& grid, cudaStream_t s) {
  switch (tn) {
    case 64: return launch_tile<W4, 64>(a, grid, s);
    case 128: return launch_tile<W4, 128>(a, grid, s);
    case 256: return launch_tile<W4, 256>(a, grid, s);
    default: return kInvalid;
  }
}

}  // namespace

// y = x . dequant(codes)^T (+ bias). form 0: the decode form, MT tokens a
// pass (1, 2, 4 or 8); form 1: the tile form (bf16 x, mt = the token tile,
// 64, 128 or 256; split K into `splits` with `part` [splits, M, N] float32
// when splits > 1). x_dtype and y_dtype: 0 float32, 1 bf16, 2 int8 (x
// only: A8, with sx = the activation scale / 127). K must be a multiple of
// 32 (64 for the tile form), every pointer 16-byte aligned. Returns the
// CUDA error of the launches (0 = none).
extern "C" int k7_gemm(const void* x, const void* codes, const void* scale,
                       const void* bias, void* y, void* part, int M, int N,
                       int K, int group, int int4, int x_dtype, int y_dtype,
                       float sx, int form, int mt, int splits, void* stream) {
  if (M == 0 || N == 0) return 0;
  if (M < 0 || N < 0 || K <= 0 || K % kKAlign || group <= 0 || K % group)
    return kInvalid;
  const int groups = K / group;
  Args a{x,
         static_cast<const int8_t*>(codes),
         static_cast<const float*>(scale),
         bias,
         y,
         static_cast<float*>(part),
         M, N, K, group, groups, 1, 0, sx};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (form == 1) {
    if (x_dtype != kBF16 || y_dtype != kBF16 || splits < 1 || K % kTK)
      return kInvalid;
    const int steps = K / kTK;
    a.steps_per_split = (steps + splits - 1) / splits;
    a.splits = (steps + a.steps_per_split - 1) / a.steps_per_split;
    if (a.splits != splits || (splits > 1 && part == nullptr) || mt <= 0)
      return kInvalid;
    const dim3 grid((N + kTRows - 1) / kTRows, (M + mt - 1) / mt, splits);
    if (grid.y > 65535 || grid.z > 65535) return kInvalid;
    int rc = int4 ? launch_tile<true>(a, mt, grid, s)
                  : launch_tile<false>(a, mt, grid, s);
    if (rc || splits == 1) return rc;
    const long long total = static_cast<long long>(M) * N;
    k7_finish_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0,
                       s>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  if (form != 0) return kInvalid;
  if (x_dtype == kI8) {
    if (int4 || groups != 1) return kInvalid;
    if (y_dtype == kBF16) return launch_decode<kI8, kBF16, false>(a, mt, s);
    if (y_dtype == kF32) return launch_decode<kI8, kF32, false>(a, mt, s);
    return kInvalid;
  }
  if (x_dtype != y_dtype) return kInvalid;
  if (x_dtype == kBF16 && M <= 8 && K % 64 == 0) {
    if (!int4) {
      k7_decode_mma_kernel<<<dim3((N + 15) / 16), kThreads, 0, s>>>(a);
      return static_cast<int>(cudaGetLastError());
    }
    k7_decode_int4_kernel<<<dim3((N + 15) / 16), kThreads, 0, s>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  if (x_dtype == kBF16)
    return int4 ? launch_decode<kBF16, kBF16, true>(a, mt, s)
                : launch_decode<kBF16, kBF16, false>(a, mt, s);
  if (x_dtype == kF32)
    return int4 ? launch_decode<kF32, kF32, true>(a, mt, s)
                : launch_decode<kF32, kF32, false>(a, mt, s);
  return kInvalid;
}
