// K1's forward for Hopper: TMA-fed shared-memory ring, wgmma products,
// warp specialisation. Included by flash_attention.cu inside its
// anonymous namespace (it uses that file's Params, masking, dropout and
// tile tests); bf16 at head_dim 64 and 128, every arm K1 takes (none,
// kArmSeg, kArmDrop, kArmSeg | kArmDrop), causal or not, GQA, lse on or
// off. K6 and the CUDA-core forms keep fwd_mma / fwd_core. The Hopper
// building blocks (mbarriers, TMA, wgmma, tensor maps) are sm90.cuh's,
// shared with K2/K3's backward (fa_bwd_sm90.cuh).
//
// A block owns 128 query rows of one head (q tiles in reverse order under
// causal, so the longest rows start first) and has three roles:
// - the producer warp (warp 8, the first of the third warpgroup, which
//   hands its registers to the consumers with setmaxnreg) loads the q
//   tile once, then for each key
//   tile of 128 keys computes the tile's dead / interior flags (the
//   per-key test of stage_key_flags in the segment arms; the causal and
//   ragged test of tile_flags in every arm), writes them beside the
//   tile's stage and, unless the tile is dead, issues its K and V loads:
//   TMA (cp.async.bulk.tensor, 128-byte swizzle) of [128 keys][64 d] boxes
//   through tensor maps over [B, S, heads * D], into a two-stage ring whose
//   stages say "full" (K and V apart) and "empty" through mbarriers;
// - two consumer warpgroups of 64 rows each: S = Q K^T by wgmma
//   m64n128k16 with Q and K from shared memory (K-major descriptors), the
//   online softmax in registers (exp2, scale * log2(e) folded into one
//   multiply; mask_score only on tiles that are not interior), dropout's
//   keep_of per accumulator element (the wgmma accumulator holds element
//   (row, col) where mma.sync's C layout does, per 16-row warp slice, so the
//   hash is the same), then O += P V by wgmma with P from registers (the
//   accumulator converted to the A fragment in place) and V from shared
//   memory as an MN-major operand (the transpose bit: no element-wise
//   transpose). l and lse stay undropped; lse is stored in natural log.
// No __syncthreads after the roles split: the ring's mbarriers alone order
// them.

#include "sm90.cuh"

constexpr int kWgBQ = 128, kWgBK = 128, kWgStages = 2;

template <int D>
struct WgShape {
  static constexpr int q_bytes = kWgBQ * D * 2;
  static constexpr int kv_bytes = kWgBK * D * 2;  // one K or V tile
  static constexpr int ring = kWgStages * 2 * kv_bytes;
  // tiles, then 7 mbarriers and the stages' flags; + 1024 to align
  static constexpr int smem = q_bytes + ring + 128 + 1024;
};

template <int D, int kArm>
__global__ void __launch_bounds__(kWgThreads, 1)
    fa_fwd_wgmma_kernel(const Params p, const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv) {
  using WS = WgShape<D>;
  constexpr int BQ = kWgBQ, BK = kWgBK, NS = kWgStages;
  constexpr int HALF_Q = BQ * 64, HALF_K = BK * 64;  // elements of a column
  extern __shared__ unsigned char fa_wg_smem[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(fa_wg_smem) + 1023) & ~uintptr_t(1023));
  bf16* Qs = reinterpret_cast<bf16*>(base);           // [halves][BQ][64]
  bf16* Ks = Qs + BQ * D;                              // [NS][halves][BK][64]
  bf16* Vs = Ks + NS * BK * D;                         // [NS][halves][BK][64]
  uint64_t* bars = reinterpret_cast<uint64_t*>(Vs + NS * BK * D);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;       // [NS]
  uint64_t* v_full = k_full + NS;    // [NS]
  uint64_t* empty = v_full + NS;     // [NS]
  int* info = reinterpret_cast<int*>(empty + NS);  // [NS] stage flags

  const int Sq = p.Sq, Sk = p.Sk, H = p.H, HKV = p.HKV;
  const int h = blockIdx.x, b = blockIdx.y;
  const int n_qt = gridDim.z;
  const int qt = p.mk.causal ? n_qt - 1 - blockIdx.z : blockIdx.z;
  const int q0 = qt * BQ, q1 = min(q0 + BQ, Sq);
  const int hk = h / (H / HKV);
  const int n_kt = k_tiles(p.mk, q1, BK, Sk);
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
    producer_regs();
    if (warp > kWgConsumers / 32) return;
    if (lane == 0) {
      mbar_expect_tx(q_full, WS::q_bytes);
      tma_rows<D>(Qs, HALF_Q, &tq, q_full, h, q0, b);
    }
    const QSpan qsp = q_span<kArm>(p.mk, b, q0, q1, Sq);
    for (int kt = 0; kt < n_kt; ++kt) {
      const int st = kt % NS;
      const uint32_t ph = (kt / NS) & 1;
      const int k0 = kt * BK;
      // the flags before the stage is free: they read no shared memory
      const TileFlags tf = tile_flags(p.mk, q0, q1, BQ, k0, BK, Sk);
      bool dead = false, interior = tf.clear;
      if (tile_tested(kArm)) {
        bool cover = true, clear = true;
        for (int i = 0; i < BK / 32; ++i) {
          TileFlags f = tf;
          key_flags(f, p.mk, nullptr, BK, b, k0 + 32 * i + lane, q0, q1,
                    Sq, Sk, qsp);
          cover = cover && f.cover;
          clear = clear && f.clear;
        }
        dead = __all_sync(0xffffffffu, cover);
        interior = __all_sync(0xffffffffu, clear);
      }
      mbar_wait(&empty[st], ph ^ 1);
      if (lane == 0) {
        info[st] = (dead ? kTileDead : 0) | (interior ? kTileInterior : 0);
        if (dead) {
          mbar_arrive(&k_full[st]);
          mbar_arrive(&v_full[st]);
        } else {
          bf16* kd = Ks + st * BK * D;
          bf16* vd = Vs + st * BK * D;
          mbar_expect_tx(&k_full[st], WS::kv_bytes);
          tma_rows<D>(kd, HALF_K, &tk, &k_full[st], hk, k0, b);
          mbar_expect_tx(&v_full[st], WS::kv_bytes);
          tma_rows<D>(vd, HALF_K, &tv, &v_full[st], hk, k0, b);
        }
      }
      __syncwarp();
    }
  } else {
    // -- the consumer warpgroups --------------------------------------------
    consumer_regs();
    const int wg = warp / 4, w4 = warp % 4, g8 = lane / 4, t4 = lane % 4;
    const int r0 = q0 + wg * 64 + w4 * 16 + g8, r1 = r0 + 8;
    const float scale2 = p.scale * kLog2e;
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    const bf16* Qw = Qs + wg * 64 * 64;  // this warpgroup's 64 rows
    mbar_wait(q_full, 0);

    for (int kt = 0; kt < n_kt; ++kt) {
      const int st = kt % NS;
      const uint32_t ph = (kt / NS) & 1;
      const int k0 = kt * BK;
      mbar_wait(&k_full[st], ph);
      const int flags = warp_uniform(info[st]);
      if (flags & kTileDead) {
        mbar_wait(&v_full[st], ph);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[st]);
        continue;
      }
      const bool interior = flags & kTileInterior;
      const bf16* Kt = Ks + st * BK * D;
      const bf16* Vt = Vs + st * BK * D;

      float s[64];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int j = kk / 4, off = (kk % 4) * 16;  // column, elements in it
        wgmma_ss_n128(s, wg_desc(Qw + j * HALF_Q + off, 16),
                      wg_desc(Kt + j * HALF_K + off, 16), kk > 0);
      }
      wg_commit();
      wg_wait0();
      wg_fence_regs(s);

      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int cl = j * 8 + 2 * t4 + (e & 1);
          float x = s[4 * j + e] * scale2;
          if (!interior)
            x = mask_score<kArm, BK>(p.mk, nullptr, x, b, h, e < 2 ? r0 : r1,
                                     k0 + cl, cl, Sq, Sk);
          s[4 * j + e] = x;
          if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
        }
      const float mn0 = fmaxf(m0, quad_max(mx0));
      const float mn1 = fmaxf(m1, quad_max(mx1));
      const float ms0 = mn0 == -INFINITY ? 0.f : mn0;  // rows masked so far
      const float ms1 = mn1 == -INFINITY ? 0.f : mn1;
      const float corr0 = exp2f(m0 - ms0), corr1 = exp2f(m1 - ms1);
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // 0 where masked (-inf)
          const float pr = exp2f(s[4 * j + e] - (e < 2 ? ms0 : ms1));
          if (e < 2) ps0 += pr; else ps1 += pr;
          // l sums the undropped p; p V takes the kept links
          s[4 * j + e] = (kArm & kArmDrop)
                             ? pr * keep_of(p, b * H + h, e < 2 ? r0 : r1,
                                            k0 + j * 8 + 2 * t4 + (e & 1))
                             : pr;
        }
      l0 = l0 * corr0 + ps0;
      l1 = l1 * corr1 + ps1;
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[4 * n] *= corr0; o[4 * n + 1] *= corr0;
        o[4 * n + 2] *= corr1; o[4 * n + 3] *= corr1;
      }

      mbar_wait(&v_full[st], ph);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t pa[4];
        acc_to_a(pa, s, kk);
        // keys [16 kk, 16 kk + 16): two 8-row atoms down the tile; the
        // second 64-column half of d lies BK * 128 bytes on
        wgmma_pv<D>(o, pa, wg_desc(Vt + kk * 16 * 64, BK * 128));
      }
      wg_commit();
      wg_wait0();
      wg_fence_regs(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }

    const float lt0 = fmaxf(quad_sum(l0), 1e-30f);
    const float lt1 = fmaxf(quad_sum(l1), 1e-30f);
    bf16* __restrict__ out = static_cast<bf16*>(p.out0);
    const long long st_ = (static_cast<long long>(b) * H + h) * Sq;
    if (r0 < Sq) {
      bf16* row = out + row_off(b, r0, h, Sq, H, D) + 2 * t4;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(row + n * 8) =
            pack_bf16(o[4 * n] / lt0, o[4 * n + 1] / lt0);
      if (p.lse_out != nullptr && t4 == 0)
        p.lse_out[st_ + r0] = m0 * kLn2 + logf(lt0);
    }
    if (r1 < Sq) {
      bf16* row = out + row_off(b, r1, h, Sq, H, D) + 2 * t4;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(row + n * 8) =
            pack_bf16(o[4 * n + 2] / lt1, o[4 * n + 3] / lt1);
      if (p.lse_out != nullptr && t4 == 0)
        p.lse_out[st_ + r1] = m1 * kLn2 + logf(lt1);
    }
  }
}

// K1 in arm kArm at head_dim D: the grid (head, batch, q tile).
template <int D, int kArm>
int launch_wgmma(const Params& p, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, p.q, p.B, p.Sq, p.H, D, kWgBQ) ||
      !tensor_map(&tk, p.k, p.B, p.Sk, p.HKV, D, kWgBK) ||
      !tensor_map(&tv, p.v, p.B, p.Sk, p.HKV, D, kWgBK))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = fa_fwd_wgmma_kernel<D, kArm>;
  const int smem = WgShape<D>::smem;
  static std::atomic<uint64_t> raised{0};
  const cudaError_t err = raise_smem_once(
      raised, reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.H, p.B, (p.Sq + kWgBQ - 1) / kWgBQ);
  kernel<<<grid, kWgThreads, smem, stream>>>(p, tq, tk, tv);
  return static_cast<int>(cudaGetLastError());
}
