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
// happens here, in registers or shared memory.
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
// (M in the hundreds or thousands) bf16 tensor-core operations. Two
// forms, picked by the wrapper from M and the dtypes:
//
// (a) k7_decode_kernel (CUDA cores; float32 and A8 at any M, bf16 at
//     M <= 8 where K is not a multiple of 64, MT <= 8 tokens a pass) and
//     k7_decode_mma_kernel (bf16 at M <= 8, the multiply-adds on the
//     tensor cores, described above it). A block of 8 warps owns 4 output
//     rows and MT <= 8 tokens; its warps split K between them (warp w
//     takes 16-element chunks w*32 + lane, w*32 + lane + 256, ...), so
//     even N = 1024 (GQA k/v) gives 256 blocks. A lane reads 16 codes a
//     row (16 bytes int8, 8 int4) with a streaming load that does not
//     allocate in L1, where x stays: x is read through the read-only
//     cache, 4 elements a token at a time. Each code becomes a float by
//     the magic-number trick (byte into a float's mantissa, then one
//     subtract), is scaled and rounded, and enters MT fused
//     multiply-adds; A8 sums with dp4a. Lanes then reduce with shuffles,
//     warps through shared memory in a fixed order, and the epilogue
//     rounds and adds the bias.
// (b) k7_tile_kernel (tensor cores; bf16 x at M > 8): 64 x 64 output
//     tiles, 4 warps of 32 x 32, K in steps of 64 through a two-stage
//     cp.async ring (x and the raw codes); each step's codes are
//     dequantized into a bf16 tile in shared memory, then mma.sync
//     m16n8k16 with float32 accumulation. Where the tiles are too few to
//     fill the card (the speculative verify's M of 40, a prefill chunk's
//     256), K is split across blocks into float32 partials that
//     k7_finish_kernel sums in a fixed order with the epilogue.
//
// Neither form uses wgmma, TMA or a persistent schedule: a first kernel,
// right and simple.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };
typedef __nv_bfloat16 bf16;

constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);
constexpr int kWarps = 8;             // decode form: warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 4;              // decode form: output rows a block
constexpr int kChunk = 16;            // k elements a lane takes at a time

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

// (a') the decode form in bf16 (M <= 8, K a multiple of 64): the same
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
template <bool W4>
__device__ __forceinline__ void dequant_pairs(uint32_t (&w)[8],
                                              uint32_t (&q)[4],
                                              const Args& a, int row,
                                              int k0) {
  bias_codes<W4>(q, q);
  const bool one = a.group % kChunk == 0;
  const float s0 = scale_at<true>(a, row, k0);
#pragma unroll
  for (int j = 0; j < kChunk / 2; ++j) {
    float v[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = 2 * j + e;
      const float sc = one ? s0 : scale_at<true>(a, row, k0 + i);
      v[e] = __fmul_rn(code_at<W4>(q, i), sc);
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

template <bool W4>
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
      load_codes<W4>(qa[u], a, n0 + g, k0);
      load_codes<W4>(qb[u], a, n0 + g + 8, k0);
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
      dequant_pairs<W4>(wa, qa[u], a, n0 + g, k0);
      dequant_pairs<W4>(wb, qb[u], a, n0 + g + 8, k0);
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

// -- (b) the tile form --------------------------------------------------------

constexpr int kBM = 64, kBN = 64, kBK = 64;
constexpr int kTileThreads = 128;
constexpr int kLD = kBK + 8;  // bf16 row pitch of the x and weight tiles:
                              // fragment loads fall on distinct banks
constexpr int kKAlign = 32;   // every form takes K a multiple of this

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t ld_smem32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <bool W4>
__global__ void __launch_bounds__(kTileThreads)
    k7_tile_kernel(const Args a) {
  constexpr int kCodeBytes = W4 ? kBK / 2 : kBK;  // a row's codes a step
  __shared__ __align__(16) bf16 xs[2][kBM][kLD];
  __shared__ __align__(16) int8_t cs[2][kBN][kCodeBytes];
  __shared__ __align__(16) bf16 ws[kBN][kLD];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int steps = a.K / kBK;
  const int s0 = blockIdx.z * a.steps_per_split;
  const int s1 = min(steps, s0 + a.steps_per_split);
  const bf16* x = static_cast<const bf16*>(a.x);
  const long long code_pitch = W4 ? a.K / 2 : a.K;

  auto issue = [&](int step, int buf) {
    const int k0 = step * kBK;
    // x: 64 rows x 128 bytes, four 16-byte pieces a thread
    constexpr int kXPer = kBK * 2 / 16;   // pieces a row
#pragma unroll
    for (int i = 0; i < kBM * kXPer / kTileThreads; ++i) {
      const int p = tid + i * kTileThreads;
      const int row = p / kXPer, col = (p % kXPer) * 8;
      const bool ok = m0 + row < a.M;
      cp_async16(&xs[buf][row][col],
                 x + static_cast<long long>(ok ? m0 + row : 0) * a.K + k0 +
                     col,
                 ok);
    }
    // codes: 64 rows x kCodeBytes (int8 two pieces a thread, int4 one)
    constexpr int kPer = kCodeBytes / 16;
#pragma unroll
    for (int i = 0; i < kBN * kPer / kTileThreads; ++i) {
      const int p = tid + i * kTileThreads;
      const int row = p / kPer, col = (p % kPer) * 16;
      const bool ok = n0 + row < a.N;
      cp_async16(&cs[buf][row][col],
                 a.codes + (ok ? n0 + row : 0) * code_pitch +
                     (W4 ? k0 / 2 : k0) + col,
                 ok);
    }
    cp_async_commit();
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int g = lane >> 2, q2 = (lane & 3) * 2;

  if (s0 < s1) issue(s0, 0);
  for (int step = s0; step < s1; ++step) {
    const int buf = (step - s0) & 1;
    if (step + 1 < s1) {
      issue(step + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // dequantize this step's codes: two 16-code chunks of one row a
    // thread
#pragma unroll
    for (int cc = 0; cc < kBK * kBN / (kChunk * kTileThreads); ++cc) {
      const int row = tid >> 1;
      const int kk = (tid & 1) * (kBK / 2) + cc * kChunk;
      uint32_t q[4];
      const uint32_t* src = reinterpret_cast<const uint32_t*>(
          &cs[buf][row][W4 ? kk / 2 : kk]);
      q[0] = src[0];
      q[1] = src[1];
      q[2] = W4 ? 0u : src[2];
      q[3] = W4 ? 0u : src[3];
      uint32_t packed[kChunk / 2];
      dequant_pairs<W4>(packed, q, a, n0 + row, step * kBK + kk);
      uint4* dst = reinterpret_cast<uint4*>(&ws[row][kk]);
      dst[0] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
      dst[1] = make_uint4(packed[4], packed[5], packed[6], packed[7]);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm + 16 * i + g;
        af[i][0] = ld_smem32(&xs[buf][r][kk + q2]);
        af[i][1] = ld_smem32(&xs[buf][r + 8][kk + q2]);
        af[i][2] = ld_smem32(&xs[buf][r][kk + q2 + 8]);
        af[i][3] = ld_smem32(&xs[buf][r + 8][kk + q2 + 8]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cn = wn + 8 * j + g;
        const uint32_t b0 = ld_smem32(&ws[cn][kk + q2]);
        const uint32_t b1 = ld_smem32(&ws[cn][kk + q2 + 8]);
#pragma unroll
        for (int i = 0; i < 2; ++i) mma16816(acc[i][j], af[i], b0, b1);
      }
    }
    __syncthreads();  // the next step overwrites this buffer and ws
  }
  // c0, c1: row g, cols q2, q2 + 1; c2, c3: row g + 8
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm + 16 * i + g + (e >> 1) * 8;
        const int n = n0 + wn + 8 * j + q2 + (e & 1);
        if (m >= a.M || n >= a.N) continue;
        if (a.splits == 1)
          store_out<kBF16>(a, m, n, acc[i][j][e]);
        else
          a.part[(static_cast<long long>(blockIdx.z) * a.M + m) * a.N + n] =
              acc[i][j][e];
      }
}

// The split tile form's partials summed in split order, then the epilogue.
__global__ void k7_finish_kernel(const Args a) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const long long total = static_cast<long long>(a.M) * a.N;
  if (i >= total) return;
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

}  // namespace

// y = x . dequant(codes)^T (+ bias). form 0: the decode form, MT tokens a
// pass (1, 2, 4 or 8); form 1: the tile form (bf16 x, split K into
// `splits` with `part` [splits, M, N] float32 when splits > 1). x_dtype
// and y_dtype: 0 float32, 1 bf16, 2 int8 (x only: A8, with sx = the
// activation scale / 127). K must be a multiple of 32 (64 for the tile
// form), every pointer 16-byte aligned. Returns the CUDA error of the
// launches (0 = none).
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
    if (x_dtype != kBF16 || y_dtype != kBF16 || splits < 1 || K % kBK)
      return kInvalid;
    const int steps = K / kBK;
    a.steps_per_split = (steps + splits - 1) / splits;
    a.splits = (steps + a.steps_per_split - 1) / a.steps_per_split;
    if (a.splits != splits || (splits > 1 && part == nullptr))
      return kInvalid;
    const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, splits);
    if (grid.y > 65535 || grid.z > 65535) return kInvalid;
    if (int4)
      k7_tile_kernel<true><<<grid, kTileThreads, 0, s>>>(a);
    else
      k7_tile_kernel<false><<<grid, kTileThreads, 0, s>>>(a);
    int rc = static_cast<int>(cudaGetLastError());
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
    const dim3 grid((N + 15) / 16);
    if (int4)
      k7_decode_mma_kernel<true><<<grid, kThreads, 0, s>>>(a);
    else
      k7_decode_mma_kernel<false><<<grid, kThreads, 0, s>>>(a);
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
