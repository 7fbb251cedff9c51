// Flash attention, forward and backward, for Hopper (sm_90a), behind a
// plain C interface that paddle_tpu_torch/ops/fa_kernel.py loads through
// ctypes.
//
// Replaces four TPU kernels of paddle_tpu/ops/pallas/_fa_kernel.py, every
// arm of each:
//   K1 _fa_fwd_kernel        (pallas_call at _fa_kernel.py:540): the
//      resident-K/V online-softmax forward, Sq == Sk, no mask: causal
//      k-loop bound, GQA (query head h reads kv head h / G), optional
//      log-sum-exp output; segment ids (:231-249) and the counter-hash
//      dropout (:226) as compile-time arms;
//   K6 _fa_fwd_stream_kernel (pallas_call at _fa_kernel.py:540): the
//      streamed forward the JAX package routes masked and cross-length
//      calls to (_fa_kernel.py:446): as K1, and Sq may differ from Sk (the
//      causal diagonal at offset = Sk - Sq), an additive float32 mask
//      [B|1, H|1, Sq, Sk], one or two FlashMask row bands per key column
//      [B|1, H|1, Sk] int32, segment ids (:312-318), and k tiles dead for
//      the whole q tile skipped; no dropout (the TPU file refuses it too);
//   K2 _fa_bwd_dq_kernel     (pallas_call at _fa_kernel.py:811): p = exp(s -
//      lse), dp = dO V^T (times keep / (1 - p) under dropout, :607),
//      ds = p * (dp - delta), dq += ds K scale;
//   K3 _fa_bwd_dkv_kernel    (pallas_call at _fa_kernel.py:862): dv += (p
//      keep)^T dO, dk += ds^T Q scale, summed over the G query heads of a kv
//      head; under dropout each query head hashes with its own b * H + h
//      (:676-679).
// Each kernel is compiled in the arms it takes (kArm: kArmMask the additive
// mask and the bands, kArmSeg segment ids, kArmDrop dropout), so the plain
// LLaMA arms compile to the code they had before the others existed. Every
// kernel masks through one function, mask_score (the TPU file's
// _masked_scores), in its order: rows past Sq and keys past Sk, causal,
// each band [start, end) of the key's column, the additive mask, then the
// segment test (equal ids match, a negative id matches nothing). A row
// with no live key gives out 0 and lse -inf (acc / max(l, 1e-30),
// m + log(max(l, 1e-30)) with m = -inf), and zero gradients: p is taken
// only where the masked score is finite, as _fa_kernel.py:600-601 does.
//
// Dropout is the TPU file's _keep_scale (:129-161) for one element: two
// murmur3 fmix32 rounds over row * 0x9E3779B1 ^ col * 0x85EBCA77 ^
// (b * H + h) * 0xC2B2AE3D ^ seed in uint32, the link kept where the hash
// is >= the threshold min(p * 2^32, 2^32 - 1) and scaled by float32(1 /
// (1 - p)); the host computes both as the JAX function does. Rows and
// columns are absolute positions, so the forward and both backward
// kernels draw the same mask bit for bit. As in _online_softmax_step, the
// forward's l and lse stay undropped and only p V takes the kept links.
//
// Where the scale is applied: the backward kernels scale s after the dot
// (as the TPU kernels do); the CUDA-core forward scales q before its dot
// (as the TPU forward does), the tensor-core forwards, which the bf16
// training path runs, scale s after their dot (equal up to float32 ulps:
// the bf16 q stays unrounded for the mma; K1 folds log2(e) into that
// multiply and takes exp2). delta = rowsum(dO * O) (minus
// dlse) is computed by the caller.
//
// Layouts: q, o, dO [B, Sq, H, D], k, v [B, Sk, HKV, D], contiguous, read
// and written in place with strides (no [B*H, S, D] transposes); lse and
// delta [B, H, Sq] float32; the mask read through its four element strides
// (0 over a broadcast dim), the bands [n, MB, MH, Sk] through theirs; the
// segment ids [B, Sq] and [B, Sk] int32. bf16 or float32 in, outputs in
// the input type.
//
// What bounds it on this card: operations. Causal attention at the LLaMA
// step's shape (B 4, S 2048, H 32, D 128) does 4*B*H*S^2*D/2 = 1.37e11
// flops forward (K2 three products of that size, K3 four) over about 0.3
// GB of q/k/v/o: ~450 flops a byte, above the ~295 where the tensor cores
// rather than HBM become the limit. Mistral's 4096-key window at S 8192
// keeps 25.2M of the 33.6M causal (row, key) pairs of a head; K6, K2 and
// K3 skip the tiles outside the band, so their bound counts live pairs.
// The dropout hash costs about 20 integer operations a score, beside the
// 4 D flops of the products.
//
// What the design does about that: every intermediate stays out of
// device memory (scores, probabilities, keep masks and the online-softmax
// state live in shared memory and registers; only q/k/v/o/lse/delta, the
// mask, the bands, the segment ids and the gradients touch HBM), tiles
// that causality, the first band or the segment ids kill are skipped
// before their K/V (or Q/dO) are loaded, and K/V stay at their own head
// count (never repeated in memory; K3 reads a kv tile once for its whole
// GQA group, and takes each query head's own band and mask row). Two forms
// of each kernel, chosen by dtype and head_dim:
//   - bf16 at head_dim 64 or 128 (the training path): the products run
//     on the tensor cores (bf16 in, float32 accumulate). K1 and K6 are one
//     warp-specialised forward under two kernel names (fa_fwd_sm90.cuh): a
//     producer warp keeps TMA loads of 128-key K/V tiles in flight into a
//     two-stage shared ring (mbarriers), handing on only the tiles that
//     are live for a consumer warpgroup, and two consumer warpgroups of 64
//     rows run wgmma on them. K2 and K3 (fa_bwd_sm90.cuh) are their
//     siblings: 128 resident rows (K2 query rows with Q and dO, K3 keys
//     with K and V), 64-row tiles of the other side streamed through the
//     same kind of ring, both first products and the accumulating ones on
//     wgmma, the second operand of the latter read MN-major through the
//     transpose bit;
//   - float32 (float32 math, no TF32) and head_dim 256: the products run
//     on the CUDA cores in float32, 256 threads each owning a 4 x 4 block
//     of scores and a 4 x D/16 block of the accumulator.
// Rows and keys past a ragged Sq or Sk are masked in the kernel, so any
// length is taken.
#include <cuda.h>  // CUtensorMap (types only: no driver library is linked)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

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

// -- masking -----------------------------------------------------------------

// The compile-time arms of a kernel. kArmMask: the additive mask and the
// bands (K6 always, K2/K3 when given either); kArmSeg: segment ids;
// kArmDrop: the counter-hash dropout (K1, K2, K3; never with kArmMask).
constexpr int kArmMask = 1, kArmSeg = 2, kArmDrop = 4;

// An arm that tests each tile block-wide (dead / interior).
__host__ __device__ constexpr bool tile_tested(int arm) {
  return (arm & (kArmMask | kArmSeg)) != 0;
}

struct Mask {
  int causal;
  int offset;        // Sk - Sq: query row r sees keys c <= r + offset
  const float* add;  // additive [B|1, H|1, Sq, Sk] float32, or null
  long long a_b, a_h, a_r, a_c;  // its element strides, 0 over a broadcast
  const int* fm;     // n_fm / 2 bands of (start, end) rows [MB, MH, Sk]
  int n_fm;          // 0, 2 or 4
  long long f_band, f_b, f_h;    // the bands' strides, 0 over a broadcast
  const int* qseg;   // segment ids [B, Sq] int32, or null
  const int* kseg;   // segment ids [B, Sk] int32 (with qseg)
};

struct Params {
  const void *q, *k, *v, *dout;
  const float *lse_in, *delta;
  void *out0, *out1;  // forward: out; dq: dq; dkv: dk, dv
  float* lse_out;
  int B, Sq, Sk, H, HKV;
  float scale;
  Mask mk;
  uint32_t seed;      // dropout (kArmDrop): the seed's 32 bits,
  uint32_t keep_min;  // the threshold a kept link's hash reaches,
  float keep_scale;   // and float32(1 / (1 - p))
};

// _keep_scale of _fa_kernel.py for the link of query row r and key c of
// flat head bh = b * H + h (the query head's): keep_scale where kept, else
// 0. uint32 arithmetic wraps as the TPU's int32 does; its masked
// arithmetic shifts are the logical shifts here.
__device__ __forceinline__ float keep_of(const Params& p, int bh, int r,
                                         int c) {
  uint32_t x = static_cast<uint32_t>(r) * 0x9E3779B1u ^
               static_cast<uint32_t>(c) * 0x85EBCA77u ^
               static_cast<uint32_t>(bh) * 0xC2B2AE3Du ^ p.seed;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    x ^= x >> 16;
    x *= 0x85EBCA6Bu;
    x ^= x >> 13;
    x *= 0xC2B2AE35u;
    x ^= x >> 16;
  }
  return x >= p.keep_min ? p.keep_scale : 0.f;
}

// The one masking preamble of K1, K6, K2 and K3 (the TPU file's
// _masked_scores): the scaled score s of query row r against key c of
// head h of batch b, or -inf where that pair is masked. cl indexes the
// key's bands in `bands`, band i at i * stride (kArmMask only): c - k0 in
// the [n_fm][BK] bands of the key's tile staged in shared memory (stride
// BK), c in the head's row of the bands in device memory (stride f_band),
// or 0 in the key's own bands loaded into registers by the caller (stride
// 1: K6 loads a key's bands once for both of a thread's rows). Rows past
// Sq and keys past Sk are masked; then causal with the diagonal at Sk -
// Sq; then each band [start, end) of column c; then the additive mask is
// added; then the segment ids must be equal and non-negative.
template <int kArm, int BK>
__device__ __forceinline__ float mask_score(const Mask& mk, const int* bands,
                                            float s, int b, int h, int r,
                                            int c, int cl, int Sq, int Sk,
                                            long long stride = BK) {
  if (r >= Sq || c >= Sk || (mk.causal && c > r + mk.offset))
    return -INFINITY;
  if (kArm & kArmMask) {
#pragma unroll
    for (int i = 0; i < 4; i += 2)
      if (i < mk.n_fm && r >= bands[i * stride + cl] &&
          r < bands[(i + 1) * stride + cl])
        return -INFINITY;
    if (mk.add != nullptr)
      s += mk.add[b * mk.a_b + h * mk.a_h + r * mk.a_r + c * mk.a_c];
  }
  if (kArm & kArmSeg) {
    const int qs = mk.qseg[static_cast<long long>(b) * Sq + r];
    if (qs < 0 || qs != mk.kseg[static_cast<long long>(b) * Sk + c])
      return -INFINITY;
  }
  return s;
}

// The bands of keys [k0, k0 + BK) for query head h of batch b into dst
// [n_fm][BK], by NT threads, this one `tid` (K3 stages them once per query
// head: the CUDA-core K3 for its mask_score, the wgmma K3's producer warp
// for its tile flags). A key past Sk gets a band over every row: it is
// masked anyway.
template <int BK, int NT>
__device__ __forceinline__ void stage_bands(int* dst, const Mask& mk, int b,
                                            int h, int k0, int Sk, int tid) {
  const int* f = mk.fm + b * mk.f_b + h * mk.f_h;
  for (int idx = tid; idx < mk.n_fm * BK; idx += NT) {
    const int i = idx / BK, c = k0 + idx % BK;
    dst[idx] = c < Sk ? f[i * mk.f_band + c] : (i % 2 == 0 ? INT_MIN : INT_MAX);
  }
}

// A tile's two block-wide tests in a tested arm, for the q rows [q0, q1)
// against the keys [k0, k0 + BK). Each thread starts from the neutral
// values tile_flags gives and thread cl < BK folds in key k0 + cl through
// key_flags; __syncthreads_and then combines them:
//   dead: every key is dead for all the rows, because its first band
//     covers them (the TPU kernel's test, _fa_kernel.py:320-328; a second
//     band only masks more) or because no row shares its segment id (a
//     per-key form of the TPU's min/max overlap test, :312-318, that
//     assumes no order of the ids), so the tile is skipped;
//   interior: no band of any key meets the rows, no additive mask, every
//     row and key in range and causally visible, and every row's id equal
//     to every key's, non-negative: the scores need no masking at all.
struct TileFlags {
  bool cover, clear;
};

// The flags a wgmma kernel's producer hands on beside a tile (tile_parts):
// consumer warpgroup w's part is dead (skipped) at bit 2w, interior (no
// row or key of it masked) at bit 2w + 1; a last stage marked kTileEnd
// alone ends the consumers' loop.
constexpr int kTileDead = 1, kTileInterior = 2, kTileEnd = 16;

__device__ __forceinline__ TileFlags tile_flags(const Mask& mk, int q0, int q1,
                                                int BQ, int k0, int BK,
                                                int Sk) {
  return TileFlags{mk.n_fm > 0 || mk.qseg != nullptr,
                   mk.add == nullptr && q1 == q0 + BQ && k0 + BK <= Sk &&
                       (!mk.causal || k0 + BK - 1 <= q0 + mk.offset)};
}

// The least and greatest segment id of the q rows [q0, q1) of batch b
// (kArmSeg only), each warp reducing them on its own, so no barrier: the
// wgmma K1, K6 and K2 take it once per block for each consumer
// warpgroup's rows, K3 once per q tile, the CUDA-core kernels once per
// block or q tile.
struct QSpan {
  int lo, hi;
};

template <int kArm>
__device__ __forceinline__ QSpan q_span(const Mask& mk, int b, int q0, int q1,
                                        int Sq) {
  if (!(kArm & kArmSeg)) return QSpan{0, 0};
  const int* qs = mk.qseg + static_cast<long long>(b) * Sq;
  int lo = INT_MAX, hi = INT_MIN;
  for (int r = q0 + threadIdx.x % 32; r < q1; r += 32) {
    lo = min(lo, qs[r]);
    hi = max(hi, qs[r]);
  }
  return QSpan{__reduce_min_sync(0xffffffffu, lo),
               __reduce_max_sync(0xffffffffu, hi)};
}

// What key c's test reads: its bands (kb points at its first band's start,
// the band values `stride` apart) and its segment id, every load issued
// with no branch before it, so that their latencies overlap (a producer
// warp tests a tile's keys while the consumers wait for it).
struct KeyVals {
  bool in;  // c < Sk
  int bd[4];
  int ks;
};

__device__ __forceinline__ KeyVals key_load(const Mask& mk, const int* kb,
                                            int stride, int b, int c,
                                            int Sk) {
  KeyVals kv;
  kv.in = c < Sk;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    kv.bd[i] = kv.in && i < mk.n_fm ? kb[i * stride] : 0;
  kv.ks = kv.in && mk.qseg != nullptr
              ? mk.kseg[static_cast<long long>(b) * Sk + c]
              : 0;
  return kv;
}

// A key's part of the tests for the q rows [q0, q1), from its loaded
// values. An end of INT_MAX (the C=1 form) is compared, never added to. A
// key past Sk is covered and not clear. The segment test decides from the
// rows' span qsp alone when the key's id lies outside it or every row
// shares one id (a padded batch, a tile inside one document); only a key
// inside a mixed span reads the rows' ids, eight independent loads a
// round, up to the round that holds the first match.
__device__ __forceinline__ void key_test(TileFlags& fl, const KeyVals& kv,
                                         const Mask& mk, int b, int q0,
                                         int q1, int Sq, QSpan qsp) {
  if (!kv.in) {
    fl.clear = false;
    return;
  }
  fl.cover = mk.n_fm > 0 && kv.bd[0] <= q0 && kv.bd[1] >= q1;
#pragma unroll
  for (int i = 0; i < 4; i += 2)
    if (i < mk.n_fm)
      fl.clear = fl.clear && (kv.bd[i] >= q1 || kv.bd[i + 1] <= q0 ||
                              kv.bd[i] >= kv.bd[i + 1]);
  if (mk.qseg != nullptr) {
    const int ks = kv.ks;
    const bool inside = ks >= qsp.lo && ks <= qsp.hi;
    const bool all = inside && qsp.lo == qsp.hi && ks >= 0;
    bool any = inside && qsp.lo == qsp.hi;
    if (inside && !any) {
      const int* qs = mk.qseg + static_cast<long long>(b) * Sq;
      for (int r = q0; r < q1 && !any; r += 8) {
        int id[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) id[j] = r + j < q1 ? qs[r + j] : ~ks;
#pragma unroll
        for (int j = 0; j < 8; ++j) any = any || id[j] == ks;
      }
    }
    fl.cover = fl.cover || ks < 0 || !any;
    fl.clear = fl.clear && all;
  }
}

// Key c = k0 + cl's part: kb points at its first band's start in the
// staged bands (or the head's row of them), the band values `stride`
// apart.
__device__ __forceinline__ void key_flags(TileFlags& fl, const Mask& mk,
                                          const int* kb, int stride, int b,
                                          int c, int q0, int q1, int Sq,
                                          int Sk, QSpan qsp) {
  key_test(fl, key_load(mk, kb, stride, b, c, Sk), mk, b, q0, q1, Sq, qsp);
}

// The head's row of the bands in device memory, or null.
template <int kArm>
__device__ __forceinline__ const int* head_bands(const Mask& mk, int b,
                                                 int h) {
  return (kArm & kArmMask) && mk.n_fm > 0 ? mk.fm + b * mk.f_b + h * mk.f_h
                                          : nullptr;
}

// The flags of a tile's two parts, one per consumer warpgroup of the
// wgmma kernels (K1, K6, K2, K3): query rows [a0[w], a1[w]) (at most 64)
// against the NK keys [c0[w], c0[w] + NK), as one warp computes them (lane
// l folds in keys c0[w] + 32 i + l; key c's band i at f[i * stride + c -
// f0]), part w's at bits 2w and 2w + 1 (kTileDead, kTileInterior). A part
// is dead when no row is in range, every key is past Sk or after its last
// row's causal diagonal, or (in a tested arm) every key is dead for all
// its rows; interior as tile_flags and key_flags decide it. kShared: both
// parts test the same keys (c0[0] == c0[1]), whose values are then loaded
// once, every load of the tile before any test.
template <int kArm, int NK, bool kShared>
__device__ __forceinline__ int tile_parts(const Mask& mk, int b,
                                          const int* f, int f0, int stride,
                                          const int (&a0)[2],
                                          const int (&a1)[2],
                                          const int (&c0)[2],
                                          const QSpan (&qsp)[2], int Sq,
                                          int Sk) {
  bool live[2], cover[2], clear[2];
  TileFlags tf[2];
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    live[w] = a1[w] > a0[w] && c0[w] < Sk &&
              !(mk.causal && c0[w] > a1[w] - 1 + mk.offset);
    tf[w] = tile_flags(mk, a0[w], a1[w], 64, c0[w], NK, Sk);
    cover[w] = true;
    clear[w] = tf[w].clear;
  }
  if (tile_tested(kArm)) {  // (a part that is not live is dead anyway)
    const int lane = threadIdx.x % 32;
    if constexpr (kShared) {
      KeyVals kv[NK / 32];
#pragma unroll
      for (int i = 0; i < NK / 32; ++i) {
        const int c = c0[0] + 32 * i + lane;
        kv[i] = key_load(mk, f == nullptr ? nullptr : f + c - f0, stride, b,
                         c, Sk);
      }
#pragma unroll
      for (int i = 0; i < NK / 32; ++i)
#pragma unroll
        for (int w = 0; w < 2; ++w) {
          TileFlags fl = tf[w];
          key_test(fl, kv[i], mk, b, a0[w], a1[w], Sq, qsp[w]);
          cover[w] = cover[w] && fl.cover;
          clear[w] = clear[w] && fl.clear;
        }
    } else {
#pragma unroll
      for (int w = 0; w < 2; ++w)
#pragma unroll
        for (int i = 0; i < NK / 32; ++i) {
          TileFlags fl = tf[w];
          const int c = c0[w] + 32 * i + lane;
          key_flags(fl, mk, f == nullptr ? nullptr : f + c - f0, stride, b,
                    c, a0[w], a1[w], Sq, Sk, qsp[w]);
          cover[w] = cover[w] && fl.cover;
          clear[w] = clear[w] && fl.clear;
        }
    }
  }
  int out = 0;
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    bool dead = !live[w], interior = clear[w];
    if (tile_tested(kArm)) {
      dead = __all_sync(0xffffffffu, cover[w]) || dead;
      interior = __all_sync(0xffffffffu, clear[w]);
    }
    out |= (dead ? kTileDead : interior ? kTileInterior : 0) << (2 * w);
  }
  return out;
}

// The forward's and K2's per-tile staging in a tested arm: thread cl < BK
// stages the bands of key k0 + cl into bands[i * BK + cl] and folds in its
// flags. Published (with the flags) by the caller's __syncthreads_and.
template <int BK>
__device__ __forceinline__ TileFlags stage_key_flags(int* bands,
                                                     const Mask& mk, int b,
                                                     int h, int k0, int Sq,
                                                     int Sk, int q0, int q1,
                                                     int BQ, QSpan qsp) {
  TileFlags fl = tile_flags(mk, q0, q1, BQ, k0, BK, Sk);
  const int cl = threadIdx.x;
  if (cl < BK) {
    const int c = k0 + cl;
    if (mk.n_fm > 0) {
      const int* f = mk.fm + b * mk.f_b + h * mk.f_h + c;
      for (int i = 0; i < mk.n_fm; ++i)
        bands[i * BK + cl] =
            c < Sk ? f[i * mk.f_band] : (i % 2 == 0 ? INT_MIN : INT_MAX);
    }
    key_flags(fl, mk, bands + cl, BK, b, c, q0, q1, Sq, Sk, qsp);
  }
  return fl;
}

// The barrier after a tile's operands are staged; in a tested arm it also
// says whether the tile is interior (the block-wide AND of `clear`).
template <int kArm>
__device__ __forceinline__ bool sync_interior(bool clear) {
  if (tile_tested(kArm)) return __syncthreads_and(clear);
  __syncthreads();
  return false;
}

// The k tiles the q rows [q0, q1) scan: all, or under causal up to the one
// that holds key q1 - 1 + offset (none when that key is < 0).
__device__ __forceinline__ int k_tiles(const Mask& mk, int q1, int BK,
                                       int Sk) {
  const int n_all = (Sk + BK - 1) / BK;
  if (!mk.causal) return n_all;
  const int last = q1 - 1 + mk.offset;
  return last < 0 ? 0 : min(n_all, last / BK + 1);
}

// The first q tile that key k0 is causally visible to: the one holding
// row k0 - offset (the TPU kernels' k0 / BQ, shifted by the offset).
__device__ __forceinline__ int first_q_tile(const Mask& mk, int k0, int BQ) {
  return mk.causal ? max(0, (k0 - mk.offset) / BQ) : 0;
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

// -- K1 and K6: forward ------------------------------------------------------
// One block per (q tile, head, batch), looping over the live k tiles.
// Thread (ty, tx) owns query rows ty + 16 i, key columns tx + 16 j of each
// score tile, and output columns tx + 16 e. kArm with kArmMask = K6.
template <typename T, int D, int kArm>
__device__ __forceinline__ void fwd_core(const Params& p) {
  constexpr int BQ = Tile<D>::BQ, BK = Tile<D>::BK;
  constexpr int RI = BQ / 16, CJ = BK / 16, E = D / 16;
  constexpr int QP = D + 1, KP = BK + 1, PP = BK + 1;
  extern __shared__ float smem[];
  float* Qs = smem;            // [BQ][QP]  q * scale
  float* Kt = Qs + BQ * QP;    // [D][KP]   K transposed
  float* Vs = Kt + D * KP;     // [BK][D]
  float* Ps = Vs + BK * D;     // [BQ][PP]  probabilities of the tile
  int* bands = reinterpret_cast<int*>(Ps + BQ * PP);  // [n_fm][BK]

  const T* __restrict__ q = static_cast<const T*>(p.q);
  const T* __restrict__ k = static_cast<const T*>(p.k);
  const T* __restrict__ v = static_cast<const T*>(p.v);
  T* __restrict__ out = static_cast<T*>(p.out0);
  const int Sq = p.Sq, Sk = p.Sk, H = p.H, HKV = p.HKV;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int q1 = min(q0 + BQ, Sq);
  const int hk = h / (H / HKV);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  load_rows<T, D, BQ, false>(Qs, QP, q, b, q0, h, Sq, H, p.scale);

  float m[RI], l[RI], acc[RI][E];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;  // this thread's share of the row sum
#pragma unroll
    for (int e = 0; e < E; ++e) acc[i][e] = 0.f;
  }

  const QSpan qsp = q_span<kArm>(p.mk, b, q0, q1, Sq);
  const int n_kt = k_tiles(p.mk, q1, BK, Sk);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the last tile's readers are done
    TileFlags fl{false, false};
    if (tile_tested(kArm)) {
      fl = stage_key_flags<BK>(bands, p.mk, b, h, k0, Sq, Sk, q0, q1, BQ,
                               qsp);
      if (__syncthreads_and(fl.cover)) continue;  // a dead tile
    }
    load_rows<T, D, BK, true>(Kt, KP, k, b, k0, hk, Sk, HKV, 1.f);
    load_rows<T, D, BK, false>(Vs, D, v, b, k0, hk, Sk, HKV, 1.f);
    const bool interior = sync_interior<kArm>(fl.clear);

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
        const int cl = tx + 16 * j;
        if (!interior)
          s[i][j] = mask_score<kArm, BK>(p.mk, bands, s[i][j], b, h, r,
                                         k0 + cl, cl, Sq, Sk);
        mb = fmaxf(mb, s[i][j]);
      }
      mb = row_max16(mb);
      const float mn = fmaxf(m[i], mb);
      const float ms = mn == -INFINITY ? 0.f : mn;  // rows masked so far
      const float corr = expf(m[i] - ms);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float pr = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - ms);
        // l sums the undropped p; p V takes the kept links
        Ps[(ty + 16 * i) * PP + tx + 16 * j] =
            (kArm & kArmDrop) ? pr * keep_of(p, b * H + h, r, k0 + tx + 16 * j)
                              : pr;
        ps += pr;
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
    if (r < Sq) {
      T* orow = out + row_off(b, r, h, Sq, H, D);
#pragma unroll
      for (int e = 0; e < E; ++e)
        orow[tx + 16 * e] = from_float<T>(acc[i][e] / lt);
      if (p.lse_out != nullptr && tx == 0)
        p.lse_out[(static_cast<long long>(b) * H + h) * Sq + r] =
            m[i] + logf(lt);
    }
  }
}

template <typename T, int D, int kArm>
__global__ void __launch_bounds__(kThreads) fa_fwd_kernel(const Params p) {
  fwd_core<T, D, kArm>(p);
}

template <typename T, int D, int kArm>
__global__ void __launch_bounds__(kThreads)
    fa_fwd_stream_kernel(const Params p) {
  fwd_core<T, D, kArm>(p);
}

// -- K2: dq ------------------------------------------------------------------
// One block per (q tile, head, batch), over the live k tiles. Thread (ty,
// tx) owns rows ty + 16 i, key columns tx + 16 j and dq columns tx + 16 e;
// dq is accumulated in float32 and cast on store.
template <typename T, int D, int kArm>
__global__ void __launch_bounds__(kThreads) fa_bwd_dq_kernel(const Params p) {
  constexpr int BQ = Tile<D>::BQ, BK = Tile<D>::BK;
  constexpr int RI = BQ / 16, CJ = BK / 16, E = D / 16;
  constexpr int QP = D + 1, KP = BK + 1, PP = BK + 1;
  extern __shared__ float smem[];
  float* Qs = smem;             // [BQ][QP]
  float* dOs = Qs + BQ * QP;    // [BQ][QP]
  float* Kt = dOs + BQ * QP;    // [D][KP]
  float* Vt = Kt + D * KP;      // [D][KP]
  float* dSs = Vt + D * KP;     // [BQ][PP]
  int* bands = reinterpret_cast<int*>(dSs + BQ * PP);  // [n_fm][BK]

  const T* __restrict__ q = static_cast<const T*>(p.q);
  const T* __restrict__ k = static_cast<const T*>(p.k);
  const T* __restrict__ v = static_cast<const T*>(p.v);
  const T* __restrict__ dout = static_cast<const T*>(p.dout);
  T* __restrict__ dq = static_cast<T*>(p.out0);
  const int Sq = p.Sq, Sk = p.Sk, H = p.H, HKV = p.HKV;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int q1 = min(q0 + BQ, Sq);
  const int hk = h / (H / HKV);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  load_rows<T, D, BQ, false>(Qs, QP, q, b, q0, h, Sq, H, 1.f);
  load_rows<T, D, BQ, false>(dOs, QP, dout, b, q0, h, Sq, H, 1.f);

  const long long st = (static_cast<long long>(b) * H + h) * Sq;
  float lse_r[RI], del_r[RI], dqa[RI][E];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = q0 + ty + 16 * i;
    lse_r[i] = r < Sq ? p.lse_in[st + r] : 0.f;
    del_r[i] = r < Sq ? p.delta[st + r] : 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) dqa[i][e] = 0.f;
  }

  const QSpan qsp = q_span<kArm>(p.mk, b, q0, q1, Sq);
  const int n_kt = k_tiles(p.mk, q1, BK, Sk);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    TileFlags fl{false, false};
    if (tile_tested(kArm)) {
      fl = stage_key_flags<BK>(bands, p.mk, b, h, k0, Sq, Sk, q0, q1, BQ,
                               qsp);
      if (__syncthreads_and(fl.cover)) continue;  // a dead tile
    }
    load_rows<T, D, BK, true>(Kt, KP, k, b, k0, hk, Sk, HKV, 1.f);
    load_rows<T, D, BK, true>(Vt, KP, v, b, k0, hk, Sk, HKV, 1.f);
    const bool interior = sync_interior<kArm>(fl.clear);

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
        const int cl = tx + 16 * j;
        const float sc = s[i][j] * p.scale;
        const float x = interior ? sc
                                 : mask_score<kArm, BK>(p.mk, bands, sc, b, h,
                                                        r, k0 + cl, cl, Sq,
                                                        Sk);
        const float pr = isfinite(x) ? expf(x - lse_r[i]) : 0.f;
        const float dpk = (kArm & kArmDrop)
                              ? dp[i][j] * keep_of(p, b * H + h, r, k0 + cl)
                              : dp[i][j];
        dSs[(ty + 16 * i) * PP + cl] = pr * (dpk - del_r[i]);
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
    if (r < Sq) {
      T* row = dq + row_off(b, r, h, Sq, H, D);
#pragma unroll
      for (int e = 0; e < E; ++e)
        row[tx + 16 * e] = from_float<T>(dqa[i][e] * p.scale);
    }
  }
}

// -- K3: dk, dv --------------------------------------------------------------
// One block per (k tile, kv head, batch). The TPU kernel accumulated across
// its innermost grid axis (query head of the group, q tile); here that is
// a loop inside the block, so dk/dv stay in registers with no atomics. Each
// query head of the group reads its own band and mask rows. Thread (ty, tx)
// owns key rows ty + 16 j, query columns tx + 16 i of each score tile and
// dk/dv columns tx + 16 e.
template <typename T, int D, int kArm>
__global__ void __launch_bounds__(kThreads) fa_bwd_dkv_kernel(const Params p) {
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
  int* bands = reinterpret_cast<int*>(del_s + BQ);  // [n_fm][BK]

  const T* __restrict__ q = static_cast<const T*>(p.q);
  const T* __restrict__ k = static_cast<const T*>(p.k);
  const T* __restrict__ v = static_cast<const T*>(p.v);
  const T* __restrict__ dout = static_cast<const T*>(p.dout);
  T* __restrict__ dk = static_cast<T*>(p.out0);
  T* __restrict__ dv = static_cast<T*>(p.out1);
  const int Sq = p.Sq, Sk = p.Sk, H = p.H, HKV = p.HKV;
  const int k0 = blockIdx.x * BK, hk = blockIdx.y, b = blockIdx.z;
  const int G = H / HKV;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  load_rows<T, D, BK, false>(Ks, KP, k, b, k0, hk, Sk, HKV, 1.f);
  load_rows<T, D, BK, false>(Vs, KP, v, b, k0, hk, Sk, HKV, 1.f);

  float dka[CJ][E], dva[CJ][E];
#pragma unroll
  for (int j = 0; j < CJ; ++j)
#pragma unroll
    for (int e = 0; e < E; ++e) dka[j][e] = dva[j][e] = 0.f;

  const int n_qt = (Sq + BQ - 1) / BQ;
  const int qt0 = first_q_tile(p.mk, k0, BQ);
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const long long st = (static_cast<long long>(b) * H + h) * Sq;
    if ((kArm & kArmMask) && p.mk.n_fm > 0) {
      __syncthreads();  // the last head's readers of the bands are done
      stage_bands<BK, kThreads>(bands, p.mk, b, h, k0, Sk, threadIdx.x);
      __syncthreads();
    }
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * BQ, q1 = min(q0 + BQ, Sq);
      TileFlags fl{false, false};
      if (tile_tested(kArm)) {
        fl = tile_flags(p.mk, q0, q1, BQ, k0, BK, Sk);
        const QSpan qsp = q_span<kArm>(p.mk, b, q0, q1, Sq);
        const int cl = threadIdx.x;
        if (cl < BK)
          key_flags(fl, p.mk, bands + cl, BK, b, k0 + cl, q0, q1, Sq, Sk,
                    qsp);
        // also the barrier after the last q tile's readers
        if (__syncthreads_and(fl.cover)) continue;  // a dead tile
      } else {
        __syncthreads();
      }
      load_rows<T, D, BQ, true>(Qt, QTP, q, b, q0, h, Sq, H, 1.f);
      load_rows<T, D, BQ, true>(dOt, QTP, dout, b, q0, h, Sq, H, 1.f);
      for (int r = threadIdx.x; r < BQ; r += kThreads) {
        lse_s[r] = q0 + r < Sq ? p.lse_in[st + q0 + r] : 0.f;
        del_s[r] = q0 + r < Sq ? p.delta[st + q0 + r] : 0.f;
      }
      const bool interior = sync_interior<kArm>(fl.clear);

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
        const int cl = ty + 16 * j;
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          const int rl = tx + 16 * i;
          const float sc = s[j][i] * p.scale;
          const float x =
              interior ? sc
                       : mask_score<kArm, BK>(p.mk, bands, sc, b, h, q0 + rl,
                                              k0 + cl, cl, Sq, Sk);
          const float pr = isfinite(x) ? expf(x - lse_s[rl]) : 0.f;
          // the query head's own b * H + h, as _fa_kernel.py:676-679
          const float ks =
              (kArm & kArmDrop) ? keep_of(p, b * H + h, q0 + rl, k0 + cl) : 1.f;
          Pt[cl * QTP + rl] = (kArm & kArmDrop) ? pr * ks : pr;
          dSt[cl * QTP + rl] =
              pr * (((kArm & kArmDrop) ? dp[j][i] * ks : dp[j][i]) -
                    del_s[rl]);
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
    if (c < Sk) {
      T* krow = dk + row_off(b, c, hk, Sk, HKV, D);
      T* vrow = dv + row_off(b, c, hk, Sk, HKV, D);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        krow[tx + 16 * e] = from_float<T>(dka[j][e] * p.scale);
        vrow[tx + 16 * e] = from_float<T>(dva[j][e]);
      }
    }
  }
}

// -- the tensor-core path: bf16, head_dim 64 or 128 ---------------------------
// K1, K6, K2 and K3 on TMA + wgmma (fa_fwd_sm90.cuh: fa_fwd_wgmma_kernel,
// fa_fwd_stream_wgmma_kernel; fa_bwd_sm90.cuh: fa_bwd_dq_wgmma_kernel,
// fa_bwd_dkv_wgmma_kernel). A thread (g = lane / 4, t = lane % 4) of a
// 16-row warp slice holds rows g and g + 8, columns 2t and 2t + 1 of each
// 8-wide column group of a wgmma accumulator. Probabilities and ds are
// rounded to bf16 for the second products; scores, softmax statistics and
// every sum stay float32.

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Reductions over the four threads that share a row of an accumulator.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

#include "fa_fwd_sm90.cuh"
#include "fa_bwd_sm90.cuh"

// -- launches ----------------------------------------------------------------

// The bands' shared memory of a kArmMask arm: up to 4 rows of BK ints.
constexpr int band_smem(int bk, int arm) {
  return (arm & kArmMask) ? 16 * bk : 0;
}

template <int D>
constexpr int fwd_smem(int arm) {
  return 4 * (Tile<D>::BQ * (D + 1) + D * (Tile<D>::BK + 1) +
              Tile<D>::BK * D + Tile<D>::BQ * (Tile<D>::BK + 1)) +
         band_smem(Tile<D>::BK, arm);
}
template <int D>
constexpr int dq_smem(int arm) {
  return 4 * (2 * Tile<D>::BQ * (D + 1) + 2 * D * (Tile<D>::BK + 1) +
              Tile<D>::BQ * (Tile<D>::BK + 1)) +
         band_smem(Tile<D>::BK, arm);
}
template <int D>
constexpr int dkv_smem(int arm) {
  return 4 * (2 * Tile<D>::BK * (D + 1) + 2 * D * (Tile<D>::BQ + 1) +
              2 * Tile<D>::BK * (Tile<D>::BQ + 1) + 2 * Tile<D>::BQ) +
         band_smem(Tile<D>::BK, arm);
}
// K1 and K6 are the two forward kernels; K2 and K3 take the arm of their
// call.
enum Which { kFwd = 0, kStream = 1, kDq = 2, kDkv = 3 };

// Set the kernel's dynamic shared memory, launch, and return
// cudaGetLastError() (0 = launched).
template <typename Kernel>
int launch(Kernel kernel, dim3 grid, int threads, int smem,
           cudaStream_t stream, const Params& p) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int tiles(int n, int tile) { return (n + tile - 1) / tile; }

constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);

// The CUDA-core kernels in arm kArm: float32, and bf16 at head_dim 256.
// Only the arms a kernel takes are compiled: K1 without kArmMask, K6 with
// it and without kArmDrop.
template <typename T, int D, int kArm>
int launch_core(const Params& p, int which, cudaStream_t stream) {
  const dim3 qgrid(tiles(p.Sq, Tile<D>::BQ), p.H, p.B);
  const dim3 kgrid(tiles(p.Sk, Tile<D>::BK), p.HKV, p.B);
  if constexpr (!(kArm & kArmMask)) {
    if (which == kFwd)
      return launch(fa_fwd_kernel<T, D, kArm>, qgrid, kThreads,
                    fwd_smem<D>(kArm), stream, p);
  }
  if constexpr ((kArm & kArmMask) && !(kArm & kArmDrop)) {
    if (which == kStream)
      return launch(fa_fwd_stream_kernel<T, D, kArm>, qgrid, kThreads,
                    fwd_smem<D>(kArm), stream, p);
  }
  if (which == kDq)
    return launch(fa_bwd_dq_kernel<T, D, kArm>, qgrid, kThreads,
                  dq_smem<D>(kArm), stream, p);
  if (which == kDkv)
    return launch(fa_bwd_dkv_kernel<T, D, kArm>, kgrid, kThreads,
                  dkv_smem<D>(kArm), stream, p);
  return kInvalid;
}

// The tensor-core kernels in arm kArm: bf16 at head_dim 64 and 128, K1,
// K6, K2 and K3 on TMA + wgmma.
template <int D, int kArm>
int launch_mma(const Params& p, int which, cudaStream_t stream) {
  if constexpr (!(kArm & kArmMask)) {
    if (which == kFwd) return launch_wgmma<D, kArm>(p, stream);
  }
  if constexpr ((kArm & kArmMask) && !(kArm & kArmDrop)) {
    if (which == kStream) return launch_stream_wgmma<D, kArm>(p, stream);
  }
  if (which == kDq || which == kDkv)
    return launch_bwd_wgmma<D, kArm>(p, which == kDq, stream);
  return kInvalid;
}

// One form (CUDA-core <T, D> or tensor-core <D>) over the six arms that
// exist: none, mask, segments, mask + segments, dropout, segments +
// dropout.
template <typename T, int D, bool kMma>
int launch_arm(const Params& p, int arm, int which, cudaStream_t stream) {
#define FA_ARM(A)                                      \
  case A:                                              \
    if constexpr (kMma) return launch_mma<D, A>(p, which, stream); \
    else return launch_core<T, D, A>(p, which, stream);
  switch (arm) {
    FA_ARM(0)
    FA_ARM(kArmMask)
    FA_ARM(kArmSeg)
    FA_ARM(kArmMask | kArmSeg)
    FA_ARM(kArmDrop)
    FA_ARM(kArmSeg | kArmDrop)
    default: return kInvalid;
  }
#undef FA_ARM
}

int dispatch(const Params& p, int dropout, int head_dim, int dtype, int which,
             cudaStream_t stream) {
  const Mask& mk = p.mk;
  const bool masked = mk.add != nullptr || mk.n_fm > 0;
  const bool seg = mk.qseg != nullptr;
  if (p.B == 0) return 0;
  if (p.B < 0 || p.Sq <= 0 || p.Sk <= 0 || p.HKV <= 0 || p.H % p.HKV != 0 ||
      p.H > 65535 || p.B > 65535 || (mk.n_fm != 0 && mk.n_fm != 2 &&
                                     mk.n_fm != 4) ||
      (mk.n_fm > 0 && mk.fm == nullptr) || (seg != (mk.kseg != nullptr)))
    return kInvalid;
  // K1 takes neither a mask nor bands nor Sq != Sk: those are K6's; dropout
  // rides K1 and its backward only (_fa_kernel.py:447-456, :754-759)
  if (which == kFwd && (masked || p.Sq != p.Sk)) return kInvalid;
  if (dropout && (which == kStream || masked || p.Sq != p.Sk))
    return kInvalid;
  const int arm = (masked || which == kStream ? kArmMask : 0) |
                  (seg ? kArmSeg : 0) | (dropout ? kArmDrop : 0);
  if (dtype == kF32) {
    switch (head_dim) {
      case 64: return launch_arm<float, 64, false>(p, arm, which, stream);
      case 128: return launch_arm<float, 128, false>(p, arm, which, stream);
      case 256: return launch_arm<float, 256, false>(p, arm, which, stream);
    }
  } else if (dtype == kBF16) {
    switch (head_dim) {
      case 64: return launch_arm<bf16, 64, true>(p, arm, which, stream);
      case 128: return launch_arm<bf16, 128, true>(p, arm, which, stream);
      case 256: return launch_arm<bf16, 256, false>(p, arm, which, stream);
    }
  }
  return kInvalid;
}

Mask make_mask(int Sq, int Sk, int causal, const float* add, long long a_b,
               long long a_h, long long a_r, long long a_c, const int* fm,
               int n_fm, long long f_band, long long f_b, long long f_h,
               const int* qseg, const int* kseg) {
  return Mask{causal, Sk - Sq, add, a_b, a_h, a_r, a_c,
              fm, n_fm, f_band, f_b, f_h, qseg, kseg};
}

}  // namespace

// Each entry returns cudaGetLastError() after its launch (0 = launched),
// or cudaErrorInvalidValue for a shape, dtype, mask or arm the kernels do
// not take. The wrapper has checked devices, dtypes, shapes and
// contiguity. Common arguments: B, Sq, Sk, H, HKV, head_dim; scale;
// causal; the additive mask (or null) and its element strides over (batch,
// head, row, key); the bands [n_fm, MB, MH, Sk] (or null), n_fm (0, 2 or 4)
// and their strides over (band, batch, head); the segment ids [B, Sq] and
// [B, Sk] int32 (or both null); dropout (0 or 1), its seed's 32 bits, the
// threshold a kept link's hash reaches and the kept links' scale; dtype;
// stream.
#define FA_MASK_ARGS                                                        \
  int B, int Sq, int Sk, int H, int HKV, int head_dim, float scale,         \
      int causal, const float *mask, long long m_b, long long m_h,          \
      long long m_r, long long m_c, const int *fm, int n_fm,                \
      long long f_band, long long f_b, long long f_h, const int *qseg,      \
      const int *kseg, int dropout, unsigned seed, unsigned keep_min,       \
      float keep_scale, int dtype, void *stream
#define FA_MASK                                                             \
  make_mask(Sq, Sk, causal, mask, m_b, m_h, m_r, m_c, fm, n_fm, f_band, f_b, \
            f_h, qseg, kseg),                                               \
      seed, keep_min, keep_scale

// K1. out [B,S,H,D]; lse [B,H,S] float32, or null when not wanted. Sq ==
// Sk, no mask, no bands.
extern "C" int fa_forward(const void* q, const void* k, const void* v,
                          void* out, float* lse, FA_MASK_ARGS) {
  const Params p{q, k, v, nullptr, nullptr, nullptr, out, nullptr, lse,
                 B, Sq, Sk, H, HKV, scale, FA_MASK};
  return dispatch(p, dropout, head_dim, dtype, kFwd,
                  static_cast<cudaStream_t>(stream));
}

// K6. out [B,Sq,H,D]; lse [B,H,Sq] float32, or null when not wanted.
extern "C" int fa_forward_stream(const void* q, const void* k, const void* v,
                                 void* out, float* lse, FA_MASK_ARGS) {
  const Params p{q, k, v, nullptr, nullptr, nullptr, out, nullptr, lse,
                 B, Sq, Sk, H, HKV, scale, FA_MASK};
  return dispatch(p, dropout, head_dim, dtype, kStream,
                  static_cast<cudaStream_t>(stream));
}

// K2. dq [B,Sq,H,D] from q, k, v, dout, lse and delta [B,H,Sq] float32.
extern "C" int fa_backward_dq(const void* q, const void* k, const void* v,
                              const void* dout, const float* lse,
                              const float* delta, void* dq, FA_MASK_ARGS) {
  const Params p{q, k, v, dout, lse, delta, dq, nullptr, nullptr,
                 B, Sq, Sk, H, HKV, scale, FA_MASK};
  return dispatch(p, dropout, head_dim, dtype, kDq,
                  static_cast<cudaStream_t>(stream));
}

// K3. dk, dv [B,Sk,HKV,D], each the sum over the G query heads of its group.
extern "C" int fa_backward_dkv(const void* q, const void* k, const void* v,
                               const void* dout, const float* lse,
                               const float* delta, void* dk, void* dv,
                               FA_MASK_ARGS) {
  const Params p{q, k, v, dout, lse, delta, dk, dv, nullptr,
                 B, Sq, Sk, H, HKV, scale, FA_MASK};
  return dispatch(p, dropout, head_dim, dtype, kDkv,
                  static_cast<cudaStream_t>(stream));
}
