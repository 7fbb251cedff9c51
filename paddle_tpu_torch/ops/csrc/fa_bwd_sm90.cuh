// K2 (dq) and K3 (dk, dv), the flash-attention backward, for Hopper:
// TMA-fed shared-memory ring, wgmma products, warp specialisation.
// Included by flash_attention.cu inside its anonymous namespace (it uses
// that file's Params, mask_score, keep_of and tile tests, and sm90.cuh's
// Hopper building blocks, shared with K1's forward); bf16 at head_dim 64
// and 128, in every arm launch_arm dispatches (none, kArmMask, kArmSeg,
// kArmMask | kArmSeg, kArmDrop, kArmSeg | kArmDrop): causal or not, GQA,
// Sq != Sk with the causal diagonal at Sk - Sq, the additive mask through
// its strides, 1-2 FlashMask bands, segment ids, dropout, and the dlse
// fold (already in delta).
//
// Replaces _fa_bwd_dq_kernel (paddle_tpu/ops/pallas/_fa_kernel.py:555,
// pallas_call :811) and _fa_bwd_dkv_kernel (:622, pallas_call :862).
//
// What bounds them on this card: operations. K2 does three products a
// live (row, key) pair (S = Q K^T, dP = dO V^T, dQ += dS K) and K3 four
// (S^T = K Q^T, dP^T = V dO^T, dV += P^T dO, dK += dS^T Q), 2 D flops
// each, over bf16 operands read once: at the LLaMA step's shape (B 4, S
// 2048, H 32, D 128, causal) that is 2.1e11 and 2.8e11 flops over ~0.2 GB,
// far above the ~295 flops a byte where the tensor cores, not HBM, are
// the limit. Only wgmma reaches their full rate.
//
// What the design does about that (each kernel a sibling of K1):
// - a block keeps 128 rows resident (K2: query rows of one query head,
//   Q and dO; K3: keys of one kv head, K and V), one 64-row slice for each
//   of two consumer warpgroups, and streams 64-row tiles of the other side
//   (K2: keys, K and V; K3: query rows, Q and dO, with their lse and
//   delta) through a two-stage ring;
// - the producer warp (warp 8; setmaxnreg hands its registers to the
//   consumers: 240 each in K3, 232 in K2, whose producer keeps 40) issues
//   every load by TMA (3-D tensor maps over
//   [B, S, heads * D], [rows][64] boxes, 128-byte swizzle) and computes,
//   for each tile and each warpgroup's 64 x 64 part of it, the dead and
//   interior flags (tile_parts: every load of a key's test issued at once,
//   since one warp's load latency per tile is what the masked arms waited
//   on; K3 keeps the current query head's bands of its keys in shared
//   memory for this alone). A tile dead for both warpgroups is never
//   loaded nor handed on; a last stage marked kTileEnd ends the
//   consumers' loop. Beside each stage it writes the flags, the tile's
//   position (and query head, K3) and, in K3, the rows' lse * log2(e) and
//   delta. Nothing else is staged: a tile's few masked elements (on the
//   diagonal, at a band's edge) read their bands from device memory;
// - each consumer warpgroup runs both first products by wgmma SS m64n64k16
//   (both operands K-major in shared memory), the second as soon as its
//   tile lands, and turns S into P while dP is still in flight:
//   P = exp2(S scale log2(e) - lse log2(e)), mask_score only on tiles that
//   are not interior; dS = P (dP keep - delta) with keep_of per element
//   under dropout (the wgmma accumulator holds element (row, col) where
//   mma.sync's C layout does, per 16-row warp slice, so the keep pattern
//   is the same bit for bit); then the accumulating products by wgmma RS
//   m64nDk16 with P or dS rounded to bf16 from registers as the A fragment
//   and the streamed or resident tile read MN-major through the transpose
//   bit (no element-wise transpose anywhere), as K1 reads V;
// - K2 walks its key tiles (and, under causal, its q tiles in reverse
//   order so the longest rows start first); K3 walks the q tiles of every
//   query head of its kv head's group from the first one its keys are
//   visible to (key tiles in forward order: tile 0 sees every q tile), so
//   dk and dv sum the group in registers: no atomics, each gradient row is
//   written once by one block, and two calls give the same bits.
// No __syncthreads after the roles split: the ring's mbarriers alone order
// them.

#include "sm90.cuh"

// resident rows of a block, rows of a streamed tile, stages of the ring
constexpr int kBwdRes = 128, kBwdTile = 64, kBwdStages = 2;
// K2's consumers hold 128 accumulator registers, K3's 192: K2 hands its
// producer more of the register file (128 x 40 + 256 x 232 <= 65536)
constexpr int kDqProducerRegs = 40, kDqConsumerRegs = 232;

template <int D>
struct BwdShape {
  static constexpr int res_bytes = kBwdRes * D * 2;    // one resident tensor
  static constexpr int tile_bytes = kBwdTile * D * 2;  // one streamed tile
  // elements of a 64-column box of a resident / a streamed tile
  static constexpr int HALF_R = kBwdRes * 64, HALF_T = kBwdTile * 64;
  // two resident tensors, two streamed ones in each stage, the barriers
  // (one for the resident pair, three per stage) and the stage records; +
  // 1024 to align the tiles for the swizzle
  // (and K3's producer-only band cache, [4][128] ints)
  static constexpr int smem = 2 * res_bytes + kBwdStages * 2 * tile_bytes +
                              8 * (1 + 3 * kBwdStages) +
                              kBwdStages * (16 + 8 * kBwdTile) +
                              16 * kBwdRes + 1024;
};

// What the producer writes beside a stage's tiles.
struct BwdStage {
  int flags;  // both warpgroups' flags, or kTileEnd
  int pos;    // the tile's first key (K2) or query row (K3)
  int g;      // its query head within the kv head's group (K3)
  int pad;
  float lse2[kBwdTile];   // K3: the tile's rows' lse * log2(e), 0 past Sq
  float delta[kBwdTile];  // K3: their delta, 0 past Sq
};

// p = exp(s scale - lse) of one score s, in the log2 domain (lse2 = lse
// log2(e)): 0 where mask_score masks the pair; no masking on an interior
// tile. `bands` is the head's row of the bands in device memory (kArmMask
// with bands, else null). In kArmMask the additive mask is added to the
// natural-log score.
template <int kArm>
__device__ __forceinline__ float bwd_prob(const Params& p, const int* bands,
                                          float s, bool interior,
                                          float scale2, float lse2, int b,
                                          int h, int r, int c) {
  if (interior) return exp2f(s * scale2 - lse2);
  float x;
  if constexpr ((kArm & kArmMask) != 0)
    x = mask_score<kArm, kBwdTile>(p.mk, bands, s * p.scale, b, h, r, c, c,
                                   p.Sq, p.Sk, p.mk.f_band) * kLog2e;
  else
    x = mask_score<kArm, kBwdTile>(p.mk, bands, s * scale2, b, h, r, c, c,
                                   p.Sq, p.Sk);
  // a row with no live key has lse -inf: its p is 0, never -inf - -inf
  return x == -INFINITY ? 0.f : exp2f(x - lse2);
}

// d (64 x 64) = A (64 x D) B^T (D x 64): the first products, both operands
// K-major tiles of 64-column boxes `ha` and `hb` elements apart.
template <int D>
__device__ __forceinline__ void wgmma_rows(float (&d)[32], const bf16* a,
                                           int ha, const bf16* bt, int hb) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int j = kk / 4, off = (kk % 4) * 16;  // box, elements in it
    wgmma_ss_n64(d, wg_desc(a + j * ha + off, 16),
                 wg_desc(bt + j * hb + off, 16), kk > 0);
  }
}

// -- K2: dq --------------------------------------------------------------
template <int D, int kArm>
__global__ void __launch_bounds__(kWgThreads, 1)
    fa_bwd_dq_wgmma_kernel(const Params p,
                           const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tdo,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv) {
  using BS = BwdShape<D>;
  constexpr int NS = kBwdStages, BK = kBwdTile;
  constexpr int HALF_R = BS::HALF_R, HALF_T = BS::HALF_T;
  extern __shared__ unsigned char fa_wg_smem[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(fa_wg_smem) + 1023) & ~uintptr_t(1023));
  bf16* Qs = reinterpret_cast<bf16*>(base);  // [halves][128][64]
  bf16* dOs = Qs + kBwdRes * D;              // [halves][128][64]
  bf16* Ks = dOs + kBwdRes * D;              // [NS][halves][64][64]
  bf16* Vs = Ks + NS * BK * D;               // [NS][halves][64][64]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + NS * BK * D);
  uint64_t* k_full = q_full + 1;  // [NS]
  uint64_t* v_full = k_full + NS;  // [NS]
  uint64_t* empty = v_full + NS;   // [NS]
  BwdStage* stage = reinterpret_cast<BwdStage*>(empty + NS);

  const int Sq = p.Sq, Sk = p.Sk, H = p.H;
  const int h = blockIdx.x, b = blockIdx.y;
  const int n_qt = gridDim.z;
  const int qt = p.mk.causal ? n_qt - 1 - blockIdx.z : blockIdx.z;
  const int q0 = qt * kBwdRes, q1 = min(q0 + kBwdRes, Sq);
  const int hk = h / (H / p.HKV);
  const int warp = warp_uniform(threadIdx.x / 32), lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], kWgConsumers / 32);  // one arrival a warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kWgConsumers / 32) {
    // -- the producer warp --------------------------------------------------
    producer_regs<kDqProducerRegs>();
    if (warp > kWgConsumers / 32) return;
    if (lane == 0) {
      mbar_expect_tx(q_full, 2 * BS::res_bytes);
      tma_rows<D>(Qs, HALF_R, &tq, q_full, h, q0, b);
      tma_rows<D>(dOs, HALF_R, &tdo, q_full, h, q0, b);
    }
    // each warpgroup's rows and their segment-id span
    const int a0[2] = {q0, q0 + 64};
    const int a1[2] = {min(q0 + 64, Sq), q1};
    const QSpan qsp[2] = {q_span<kArm>(p.mk, b, a0[0], a1[0], Sq),
                          q_span<kArm>(p.mk, b, a0[1], a1[1], Sq)};
    const int* bands = head_bands<kArm>(p.mk, b, h);
    const int n_kt = k_tiles(p.mk, q1, BK, Sk);
    int it = 0;
    for (int kt = 0; kt < n_kt; ++kt) {
      const int k0 = kt * BK;
      const int c0[2] = {k0, k0};
      const int fl = tile_parts<kArm, kBwdTile, false>(p.mk, b, bands, 0,
                                      static_cast<int>(p.mk.f_band), a0, a1,
                                      c0, qsp, Sq, Sk);
      if ((fl & kTileDead) && (fl & kTileDead << 2)) continue;
      const int st = it % NS;
      const uint32_t ph = (it / NS) & 1;
      ++it;
      mbar_wait(&empty[st], ph ^ 1);
      if (lane == 0) {  // the record, then the arrival that publishes it
        stage[st].flags = fl;
        stage[st].pos = k0;
        mbar_expect_tx(&k_full[st], BS::tile_bytes);
        tma_rows<D>(Ks + st * BK * D, HALF_T, &tk, &k_full[st], hk, k0, b);
        mbar_expect_tx(&v_full[st], BS::tile_bytes);
        tma_rows<D>(Vs + st * BK * D, HALF_T, &tv, &v_full[st], hk, k0, b);
      }
    }
    const int st = it % NS;
    mbar_wait(&empty[st], ((it / NS) & 1) ^ 1);
    if (lane == 0) {
      stage[st].flags = kTileEnd;
      mbar_arrive(&k_full[st]);
    }
  } else {
    // -- the consumer warpgroups --------------------------------------------
    consumer_regs<kDqConsumerRegs>();
    const int wg = warp / 4, w4 = warp % 4, t4 = lane % 4;
    const int r0 = q0 + wg * 64 + w4 * 16 + lane / 4, r1 = r0 + 8;
    const float scale2 = p.scale * kLog2e;
    const long long rows = (static_cast<long long>(b) * H + h) * Sq;
    const float lse0 = r0 < Sq ? p.lse_in[rows + r0] * kLog2e : 0.f;
    const float lse1 = r1 < Sq ? p.lse_in[rows + r1] * kLog2e : 0.f;
    const float del0 = r0 < Sq ? p.delta[rows + r0] : 0.f;
    const float del1 = r1 < Sq ? p.delta[rows + r1] : 0.f;
    const int* bands = head_bands<kArm>(p.mk, b, h);
    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
    const bf16* Qw = Qs + wg * 64 * 64;  // this warpgroup's 64 rows
    const bf16* dOw = dOs + wg * 64 * 64;
    mbar_wait(q_full, 0);

    for (int it = 0;; ++it) {
      const int st = it % NS;
      const uint32_t ph = (it / NS) & 1;
      mbar_wait(&k_full[st], ph);
      const int all = warp_uniform(stage[st].flags);
      if (all & kTileEnd) break;
      const int flags = all >> (2 * wg);
      if (flags & kTileDead) {  // the other warpgroup's tile alone
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[st]);
        continue;
      }
      const bool interior = flags & kTileInterior;
      const int k0 = stage[st].pos;
      const bf16* Kt = Ks + st * BK * D;
      const bf16* Vt = Vs + st * BK * D;

      float s[32], dp[32];
      wg_fence();
      wgmma_rows<D>(s, Qw, HALF_R, Kt, HALF_T);
      wg_commit();
      mbar_wait(&v_full[st], ph);
      wgmma_rows<D>(dp, dOw, HALF_R, Vt, HALF_T);
      wg_commit();
      wg_wait1();  // S is in; dP still in flight
      wg_fence_regs(s);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[4 * j + e] = bwd_prob<kArm>(
              p, bands, s[4 * j + e], interior, scale2, e < 2 ? lse0 : lse1,
              b, h, e < 2 ? r0 : r1, k0 + j * 8 + 2 * t4 + (e & 1));
      wg_wait0();
      wg_fence_regs(dp);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float d = dp[4 * j + e];
          if (kArm & kArmDrop)
            d *= keep_of(p, b * H + h, e < 2 ? r0 : r1,
                         k0 + j * 8 + 2 * t4 + (e & 1));
          dp[4 * j + e] = s[4 * j + e] * (d - (e < 2 ? del0 : del1));  // dS
        }

      // dQ += dS K: keys [16 kk, 16 kk + 16) are two 8-row atoms down the
      // tile; the second 64-column box of d lies BK * 128 bytes on
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t a[4];
        acc_to_a(a, dp, kk);
        wgmma_pv<D>(dq, a, wg_desc(Kt + kk * 16 * 64, BK * 128));
      }
      wg_commit();
      wg_wait0();
      wg_fence_regs(dq);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }
    bf16* __restrict__ out = static_cast<bf16*>(p.out0);
    if (r0 < Sq) {
      bf16* row = out + row_off(b, r0, h, Sq, H, D) + 2 * t4;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(row + n * 8) =
            pack_bf16(dq[4 * n] * p.scale, dq[4 * n + 1] * p.scale);
    }
    if (r1 < Sq) {
      bf16* row = out + row_off(b, r1, h, Sq, H, D) + 2 * t4;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(row + n * 8) =
            pack_bf16(dq[4 * n + 2] * p.scale, dq[4 * n + 3] * p.scale);
    }
  }
}

// -- K3: dk, dv ----------------------------------------------------------
template <int D, int kArm>
__global__ void __launch_bounds__(kWgThreads, 1)
    fa_bwd_dkv_wgmma_kernel(const Params p,
                            const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tdo,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv) {
  using BS = BwdShape<D>;
  constexpr int NS = kBwdStages, BQ = kBwdTile, NK = kBwdRes;
  constexpr int HALF_R = BS::HALF_R, HALF_T = BS::HALF_T;
  extern __shared__ unsigned char fa_wg_smem[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(fa_wg_smem) + 1023) & ~uintptr_t(1023));
  bf16* Ks = reinterpret_cast<bf16*>(base);  // [halves][128][64]
  bf16* Vs = Ks + NK * D;                     // [halves][128][64]
  bf16* Qs = Vs + NK * D;                     // [NS][halves][64][64]
  bf16* dOs = Qs + NS * BQ * D;               // [NS][halves][64][64]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(dOs + NS * BQ * D);
  uint64_t* q_full = kv_full + 1;  // [NS]
  uint64_t* o_full = q_full + NS;  // [NS]
  uint64_t* empty = o_full + NS;   // [NS]
  BwdStage* stage = reinterpret_cast<BwdStage*>(empty + NS);
  int* cache = reinterpret_cast<int*>(stage + NS);  // [4][NK], the producer's

  const int Sq = p.Sq, Sk = p.Sk, H = p.H, HKV = p.HKV;
  const int hk = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * NK;
  const int G = H / HKV;
  const int warp = warp_uniform(threadIdx.x / 32), lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(&q_full[s], 1);
      mbar_init(&o_full[s], 1);
      mbar_init(&empty[s], kWgConsumers / 32);  // one arrival a warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kWgConsumers / 32) {
    // -- the producer warp --------------------------------------------------
    producer_regs();
    if (warp > kWgConsumers / 32) return;
    if (lane == 0) {
      mbar_expect_tx(kv_full, 2 * BS::res_bytes);
      tma_rows<D>(Ks, HALF_R, &tk, kv_full, hk, k0, b);
      tma_rows<D>(Vs, HALF_R, &tv, kv_full, hk, k0, b);
    }
    const int n_qt = (Sq + BQ - 1) / BQ;
    const int qt0 = first_q_tile(p.mk, k0, BQ);
    const int c0[2] = {k0, k0 + 64};  // each warpgroup's keys
    int it = 0;
    for (int g = 0; g < G; ++g) {
      const int h = hk * G + g;
      const long long rows = (static_cast<long long>(b) * H + h) * Sq;
      // this head's bands of the block's keys, read by this warp alone
      if ((kArm & kArmMask) && p.mk.n_fm > 0) {
        stage_bands<NK, 32>(cache, p.mk, b, h, k0, Sk, lane);
        __syncwarp();
      }
      for (int qt = qt0; qt < n_qt; ++qt) {
        const int q0 = qt * BQ, q1 = min(q0 + BQ, Sq);
        const int a0[2] = {q0, q0}, a1[2] = {q1, q1};
        const QSpan sp = q_span<kArm>(p.mk, b, q0, q1, Sq);
        const QSpan qsp[2] = {sp, sp};
        const int fl = tile_parts<kArm, kBwdTile, false>(
            p.mk, b, (kArm & kArmMask) && p.mk.n_fm > 0 ? cache : nullptr,
            k0, NK, a0, a1, c0, qsp, Sq, Sk);
        if ((fl & kTileDead) && (fl & kTileDead << 2)) continue;
        // the rows' lse and delta, loaded before the stage is free
        float lse2[BQ / 32], del[BQ / 32];
#pragma unroll
        for (int i = 0; i < BQ / 32; ++i) {
          const int r = q0 + 32 * i + lane;
          lse2[i] = r < Sq ? p.lse_in[rows + r] * kLog2e : 0.f;
          del[i] = r < Sq ? p.delta[rows + r] : 0.f;
        }
        const int st = it % NS;
        const uint32_t ph = (it / NS) & 1;
        ++it;
        mbar_wait(&empty[st], ph ^ 1);
        BwdStage& sg = stage[st];
#pragma unroll
        for (int i = 0; i < BQ / 32; ++i) {
          sg.lse2[32 * i + lane] = lse2[i];
          sg.delta[32 * i + lane] = del[i];
        }
        if (lane == 0) {
          sg.flags = fl;
          sg.pos = q0;
          sg.g = g;
        }
        // every lane's stores before lane 0's arrival publishes them
        __threadfence_block();
        __syncwarp();
        if (lane == 0) {
          mbar_expect_tx(&q_full[st], BS::tile_bytes);
          tma_rows<D>(Qs + st * BQ * D, HALF_T, &tq, &q_full[st], h, q0, b);
          mbar_expect_tx(&o_full[st], BS::tile_bytes);
          tma_rows<D>(dOs + st * BQ * D, HALF_T, &tdo, &o_full[st], h, q0,
                      b);
        }
      }
    }
    const int st = it % NS;
    mbar_wait(&empty[st], ((it / NS) & 1) ^ 1);
    if (lane == 0) {
      stage[st].flags = kTileEnd;
      mbar_arrive(&q_full[st]);
    }
  } else {
    // -- the consumer warpgroups --------------------------------------------
    consumer_regs();
    const int wg = warp / 4, w4 = warp % 4, t4 = lane % 4;
    // this thread's keys: the rows of its accumulators
    const int c0 = k0 + wg * 64 + w4 * 16 + lane / 4, c1 = c0 + 8;
    const float scale2 = p.scale * kLog2e;
    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    const bf16* Kw = Ks + wg * 64 * 64;  // this warpgroup's 64 keys
    const bf16* Vw = Vs + wg * 64 * 64;
    mbar_wait(kv_full, 0);

    for (int it = 0;; ++it) {
      const int st = it % NS;
      const uint32_t ph = (it / NS) & 1;
      mbar_wait(&q_full[st], ph);
      const BwdStage& sg = stage[st];
      const int all = warp_uniform(sg.flags);
      if (all & kTileEnd) break;
      const int flags = all >> (2 * wg);
      if (flags & kTileDead) {  // the other warpgroup's tile alone
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[st]);
        continue;
      }
      const bool interior = flags & kTileInterior;
      const int q0 = sg.pos, h = hk * G + sg.g;
      const int* bands = head_bands<kArm>(p.mk, b, h);
      const bf16* Qt = Qs + st * BQ * D;
      const bf16* dOt = dOs + st * BQ * D;

      // S^T and dP^T: rows this warpgroup's keys, columns the tile's rows
      float s[32], dp[32];
      wg_fence();
      wgmma_rows<D>(s, Kw, HALF_R, Qt, HALF_T);
      wg_commit();
      mbar_wait(&o_full[st], ph);
      wgmma_rows<D>(dp, Vw, HALF_R, dOt, HALF_T);
      wg_commit();
      wg_wait1();  // S^T is in; dP^T still in flight
      wg_fence_regs(s);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = j * 8 + 2 * t4 + (e & 1);
          s[4 * j + e] = bwd_prob<kArm>(p, bands, s[4 * j + e], interior,
                                        scale2, sg.lse2[ql], b, h, q0 + ql,
                                        e < 2 ? c0 : c1);
        }
      wg_wait0();
      wg_fence_regs(dp);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = j * 8 + 2 * t4 + (e & 1);
          const float pr = s[4 * j + e];
          float d = dp[4 * j + e];
          if (kArm & kArmDrop) {
            // the query head's own b * H + h, as _fa_kernel.py:676-679
            const float ks = keep_of(p, b * H + h, q0 + ql, e < 2 ? c0 : c1);
            d *= ks;
            s[4 * j + e] = pr * ks;
          }
          dp[4 * j + e] = pr * (d - sg.delta[ql]);  // dS^T
        }

      // dV += (P keep)^T dO and dK += dS^T Q: rows [16 kk, 16 kk + 16) of
      // the tile are two 8-row atoms down it; its second 64-column box
      // lies BQ * 128 bytes on
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        uint32_t a[4];
        acc_to_a(a, s, kk);
        wgmma_pv<D>(dv, a, wg_desc(dOt + kk * 16 * 64, BQ * 128));
        acc_to_a(a, dp, kk);
        wgmma_pv<D>(dk, a, wg_desc(Qt + kk * 16 * 64, BQ * 128));
      }
      wg_commit();
      wg_wait0();
      wg_fence_regs(dv);
      wg_fence_regs(dk);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }
    bf16* __restrict__ dkp = static_cast<bf16*>(p.out0);
    bf16* __restrict__ dvp = static_cast<bf16*>(p.out1);
    if (c0 < Sk) {
      bf16* krow = dkp + row_off(b, c0, hk, Sk, HKV, D) + 2 * t4;
      bf16* vrow = dvp + row_off(b, c0, hk, Sk, HKV, D) + 2 * t4;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<uint32_t*>(krow + n * 8) =
            pack_bf16(dk[4 * n] * p.scale, dk[4 * n + 1] * p.scale);
        *reinterpret_cast<uint32_t*>(vrow + n * 8) =
            pack_bf16(dv[4 * n], dv[4 * n + 1]);
      }
    }
    if (c1 < Sk) {
      bf16* krow = dkp + row_off(b, c1, hk, Sk, HKV, D) + 2 * t4;
      bf16* vrow = dvp + row_off(b, c1, hk, Sk, HKV, D) + 2 * t4;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<uint32_t*>(krow + n * 8) =
            pack_bf16(dk[4 * n + 2] * p.scale, dk[4 * n + 3] * p.scale);
        *reinterpret_cast<uint32_t*>(vrow + n * 8) =
            pack_bf16(dv[4 * n + 2], dv[4 * n + 3]);
      }
    }
  }
}

// K2 (dq = true: grid (head, batch, 128-row q tile)) or K3 (grid (kv head,
// batch, 128-key tile)) in arm kArm at head_dim D.
template <int D, int kArm>
int launch_bwd_wgmma(const Params& p, bool dq, cudaStream_t stream) {
  const int q_rows = dq ? kBwdRes : kBwdTile;
  const int k_rows = dq ? kBwdTile : kBwdRes;
  CUtensorMap tq, tdo, tk, tv;
  if (!tensor_map(&tq, p.q, p.B, p.Sq, p.H, D, q_rows) ||
      !tensor_map(&tdo, p.dout, p.B, p.Sq, p.H, D, q_rows) ||
      !tensor_map(&tk, p.k, p.B, p.Sk, p.HKV, D, k_rows) ||
      !tensor_map(&tv, p.v, p.B, p.Sk, p.HKV, D, k_rows))
    return static_cast<int>(cudaErrorInvalidValue);
  static std::atomic<uint64_t> raised_dq{0}, raised_dkv{0};
  if (dq) {
    const auto kernel = fa_bwd_dq_wgmma_kernel<D, kArm>;
    constexpr int smem = BwdShape<D>::smem;
    const cudaError_t err = raise_smem_once(
        raised_dq, reinterpret_cast<const void*>(kernel), smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(p.H, p.B, (p.Sq + kBwdRes - 1) / kBwdRes);
    kernel<<<grid, kWgThreads, smem, stream>>>(p, tq, tdo, tk, tv);
  } else {
    const auto kernel = fa_bwd_dkv_wgmma_kernel<D, kArm>;
    constexpr int smem = BwdShape<D>::smem;
    const cudaError_t err = raise_smem_once(
        raised_dkv, reinterpret_cast<const void*>(kernel), smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(p.HKV, p.B, (p.Sk + kBwdRes - 1) / kBwdRes);
    kernel<<<grid, kWgThreads, smem, stream>>>(p, tq, tdo, tk, tv);
  }
  return static_cast<int>(cudaGetLastError());
}
