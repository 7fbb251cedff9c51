// K1's and K6's forward for Hopper: TMA-fed shared-memory ring, wgmma
// products, warp specialisation. Included by flash_attention.cu inside its
// anonymous namespace (it uses that file's Params, masking, dropout and
// tile tests); bf16 at head_dim 64 and 128. One body, fwd_wgmma, under two
// kernel names, so that a profile and the SASS tell them apart:
// - K1, fa_fwd_wgmma_kernel: Sq == Sk, the arms none, kArmSeg, kArmDrop
//   and kArmSeg | kArmDrop;
// - K6, fa_fwd_stream_wgmma_kernel (the TPU file's _fa_fwd_stream_kernel,
//   paddle_tpu/ops/pallas/_fa_kernel.py:257, pallas_call :540; its masking
//   _masked_scores :85, its dead-block skip :312-328): the arms kArmMask
//   and kArmMask | kArmSeg, so the additive mask [B|1, H|1, Sq, Sk], one
//   or two FlashMask bands per key column, Sq != Sk with the causal
//   diagonal at Sk - Sq, and segment ids;
// both causal or not, GQA, lse on or off. The CUDA-core forms keep
// fwd_core. The Hopper building blocks (mbarriers, TMA, wgmma, tensor
// maps) are sm90.cuh's, shared with K2/K3's backward (fa_bwd_sm90.cuh).
//
// What bounds K6 on this card: operations on its live (row, key) pairs
// (4 D flops each): at Mistral's training shape (B 2, S 8192, 32 over 8
// heads, D 128, causal, a 4096-token window) 1.61e9 pairs, 8.2e11 flops,
// over ~0.3 GB of q/k/v/o. What decides whether it gets there is how much
// of a block's life goes to tiles that do no work: a late q tile of that
// shape scans up to 31 dead key tiles ahead of the window before its
// first live one, and a tile's test is a round of dependent device loads.
//
// A block owns 128 query rows of one head (q tiles in reverse order under
// causal, so the longest rows start first) and has three roles:
// - the producer warpgroup (the third, which hands its registers to the
//   consumers with setmaxnreg) tests the key tiles of 128 keys: for each
//   consumer warpgroup's 64 rows, whether the tile is dead for them or
//   interior (tile_parts: causality and ragged ends in every arm; in the
//   tested arms, the kArmMask and kArmSeg ones, each key's bands and id,
//   every load of the tile issued before any test, the bands read from
//   the head's row in device memory, no order of the bands or ids
//   assumed). In a tested arm its four warps test four tiles at once, so
//   a run of dead tiles costs a quarter of the rounds; in the others, the
//   tests read nothing and its first warp alone runs. That warp hands on
//   only the tiles live for a warpgroup: it writes the flags and the
//   tile's first key beside a stage of a two-stage ring and issues the
//   TMA loads (cp.async.bulk.tensor, 128-byte swizzle) of its K and V
//   [128 keys][64 d] boxes through tensor maps over [B, S, heads * D]; a
//   dead tile is neither loaded nor handed on, and a last stage marked
//   kTileEnd ends the consumers' loop. The stages say "full" (K and V
//   apart) and "empty" through mbarriers;
// - two consumer warpgroups of 64 rows each: S = Q K^T by wgmma
//   m64n128k16 with Q and K from shared memory (K-major descriptors), the
//   online softmax in registers (exp2, scale * log2(e) folded into one
//   multiply; mask_score only on a part that is not interior, with a
//   key's bands loaded once for both of a thread's rows; under an
//   additive mask, which is in natural-log units, K6 adds it to s * scale
//   and only then multiplies by log2(e), as K2/K3's bwd_prob do; one
//   branch around the masking of a whole part, never one per score: a
//   branch per score inside the unrolled loop cost K6 half its speed at
//   Mistral's window on the H100),
//   dropout's keep_of per accumulator element (K1; the wgmma accumulator
//   holds element (row, col) where mma.sync's C layout does, per 16-row
//   warp slice, so the hash is the same), then O += P V by wgmma with P
//   from registers (the accumulator converted to the A fragment in place)
//   and V from shared memory as an MN-major operand (the transpose bit: no
//   element-wise transpose). A part dead for one warpgroup costs it one
//   barrier arrival. l and lse stay undropped; lse is stored in natural
//   log. A row with no live key gives out 0 and lse -inf.
// No __syncthreads after the roles split: the ring's mbarriers (and the
// producer warpgroup's own named barrier) alone order them. Flags and
// roles reach the wgmma code through warp_uniform, so that ptxas need not
// serialise the wgmma instructions.

#include "sm90.cuh"

constexpr int kWgBQ = 128, kWgBK = 128, kWgStages = 2;
// the tested arms' producer warps hold a tile's loaded key values: 40
// registers, the consumers 232 (128 x 40 + 256 x 232 <= 65536)
constexpr int kFwdTestProducerRegs = 40, kFwdTestConsumerRegs = 232;
// warps of the producer warpgroup that test tiles in a tested arm
constexpr int kFwdTesters = 4;

template <int D>
struct WgShape {
  static constexpr int q_bytes = kWgBQ * D * 2;
  static constexpr int kv_bytes = kWgBK * D * 2;  // one K or V tile
  static constexpr int ring = kWgStages * 2 * kv_bytes;
  // tiles, then 7 mbarriers, the stages' records (flags, first key) and
  // the testers' flags (two batches); + 1024 to align
  static constexpr int smem = q_bytes + ring + 128 + 1024;
};

template <int D, int kArm>
__device__ __forceinline__ void fwd_wgmma(const Params& p,
                                          const CUtensorMap* tq,
                                          const CUtensorMap* tk,
                                          const CUtensorMap* tv) {
  using WS = WgShape<D>;
  constexpr int BQ = kWgBQ, BK = kWgBK, NS = kWgStages;
  constexpr int HALF_Q = BQ * 64, HALF_K = BK * 64;  // elements of a column
  constexpr bool kTested = tile_tested(kArm);
  constexpr int NT = kTested ? kFwdTesters : 1;
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
  int* rec = reinterpret_cast<int*>(empty + NS);  // [NS][flags, first key]
  int* batch = rec + 2 * NS;                       // [2][kFwdTesters]

  const int Sq = p.Sq, Sk = p.Sk, H = p.H, HKV = p.HKV;
  const int h = blockIdx.x, b = blockIdx.z;
  const int n_qt = gridDim.y;
  const int qt = p.mk.causal ? n_qt - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BQ, q1 = min(q0 + BQ, Sq);
  const int hk = h / (H / HKV);
  const int warp = warp_uniform(threadIdx.x / 32), lane = threadIdx.x % 32;
  // the head's row of the bands in device memory (kArmMask), or null
  const int* bands = head_bands<kArm>(p.mk, b, h);

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
    // -- the producer warpgroup ---------------------------------------------
    producer_regs<kTested ? kFwdTestProducerRegs : kWgProducerRegs>();
    const int pw = warp - kWgConsumers / 32;
    if (pw >= NT) return;
    if (pw == 0 && lane == 0) {
      mbar_expect_tx(q_full, WS::q_bytes);
      tma_rows<D>(Qs, HALF_Q, tq, q_full, h, q0, b);
    }
    // each consumer warpgroup's rows and their segment-id span
    const int a0[2] = {q0, q0 + 64};
    const int a1[2] = {min(q0 + 64, Sq), q1};
    const QSpan qsp[2] = {q_span<kArm>(p.mk, b, a0[0], a1[0], Sq),
                          q_span<kArm>(p.mk, b, a0[1], a1[1], Sq)};
    const int stride = static_cast<int>(p.mk.f_band);
    const int n_kt = k_tiles(p.mk, q1, BK, Sk);
    int it = 0;  // stages handed on (the first warp's count)
    for (int kb = 0, n = 0; kb < n_kt; kb += NT, ++n) {
      // tiles kb .. kb + NT - 1: tester pw takes tile kb + pw
      const int kt = kb + pw;
      const int c0[2] = {kt * BK, kt * BK};
      const int mine =
          kt < n_kt ? tile_parts<kArm, BK, true>(p.mk, b, bands, 0, stride,
                                                 a0, a1, c0, qsp, Sq, Sk)
                    : kTileDead | kTileDead << 2;
      int* flags = batch + kFwdTesters * (n & 1);
      if constexpr (NT > 1) {
        // (two batches of flags: a tester writes this one while the first
        // warp may still read the last)
        if (lane == 0) flags[pw] = mine;
        producer_sync();
        if (pw != 0) continue;
      }
      for (int j = 0; j < NT && kb + j < n_kt; ++j) {
        const int fl = NT > 1 ? warp_uniform(flags[j]) : mine;
        if ((fl & kTileDead) && (fl & kTileDead << 2)) continue;
        const int k0 = (kb + j) * BK;
        const int st = it % NS;
        const uint32_t ph = (it / NS) & 1;
        ++it;
        mbar_wait(&empty[st], ph ^ 1);
        if (lane == 0) {  // the record, then the arrival that publishes it
          rec[2 * st] = fl;
          rec[2 * st + 1] = k0;
          mbar_expect_tx(&k_full[st], WS::kv_bytes);
          tma_rows<D>(Ks + st * BK * D, HALF_K, tk, &k_full[st], hk, k0, b);
          mbar_expect_tx(&v_full[st], WS::kv_bytes);
          tma_rows<D>(Vs + st * BK * D, HALF_K, tv, &v_full[st], hk, k0, b);
        }
        __syncwarp();
      }
    }
    if (pw == 0) {
      const int st = it % NS;
      mbar_wait(&empty[st], ((it / NS) & 1) ^ 1);
      if (lane == 0) {
        rec[2 * st] = kTileEnd;
        mbar_arrive(&k_full[st]);
      }
    }
  } else {
    // -- the consumer warpgroups --------------------------------------------
    consumer_regs<kTested ? kFwdTestConsumerRegs : kWgConsumerRegs>();
    const int wg = warp / 4, w4 = warp % 4, g8 = lane / 4, t4 = lane % 4;
    const int r0 = q0 + wg * 64 + w4 * 16 + g8, r1 = r0 + 8;
    const float scale2 = p.scale * kLog2e;
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    const bf16* Qw = Qs + wg * 64 * 64;  // this warpgroup's 64 rows
    mbar_wait(q_full, 0);

    for (int it = 0;; ++it) {
      const int st = it % NS;
      const uint32_t ph = (it / NS) & 1;
      mbar_wait(&k_full[st], ph);
      const int all = warp_uniform(rec[2 * st]);
      if (all & kTileEnd) break;
      const int flags = all >> (2 * wg);
      if (flags & kTileDead) {  // the other warpgroup's tile alone
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[st]);
        continue;
      }
      const bool interior = flags & kTileInterior;
      const int k0 = rec[2 * st + 1];
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

      // the scores in the log2 domain, masked only on a part that is not
      // interior (one branch around the whole tile, never one per score)
      if (interior) {
#pragma unroll
        for (int i = 0; i < 64; ++i) s[i] *= scale2;
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e1 = 0; e1 < 2; ++e1) {
            // key c's bands, loaded once for both of this thread's rows
            const int c = k0 + j * 8 + 2 * t4 + e1;
            int cb[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
              cb[i] = (kArm & kArmMask) && c < Sk && i < p.mk.n_fm
                          ? bands[i * p.mk.f_band + c]
                          : 0;
#pragma unroll
            for (int e2 = 0; e2 < 2; ++e2) {  // rows r0, r1
              float& x = s[4 * j + 2 * e2 + e1];
              const int r = e2 ? r1 : r0;
              if constexpr ((kArm & kArmMask) != 0)
                x = mask_score<kArm, BK>(p.mk, cb, x * p.scale, b, h, r, c,
                                         0, Sq, Sk, 1) *
                    kLog2e;
              else
                x = mask_score<kArm, BK>(p.mk, nullptr, x * scale2, b, h, r,
                                         c, c - k0, Sq, Sk);
            }
          }
      }
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
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

// K1: Sq == Sk, no mask, no bands (the arms without kArmMask).
template <int D, int kArm>
__global__ void __launch_bounds__(kWgThreads, 1)
    fa_fwd_wgmma_kernel(const Params p, const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv) {
  fwd_wgmma<D, kArm>(p, &tq, &tk, &tv);
}

// K6: the streamed masked forward (the arms with kArmMask).
template <int D, int kArm>
__global__ void __launch_bounds__(kWgThreads, 1)
    fa_fwd_stream_wgmma_kernel(const Params p,
                               const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv) {
  fwd_wgmma<D, kArm>(p, &tq, &tk, &tv);
}

// One of the two forward kernels at head_dim D: the tensor maps, the
// shared memory limit (raised once per device in `raised`), the grid
// (head, q tile, batch): the blocks in flight at once are the heads and
// neighbouring q tiles of one batch row, whose K/V tiles the L2 cache then
// serves again.
template <int D, typename Kernel>
int launch_fwd_wgmma(Kernel kernel, std::atomic<uint64_t>& raised,
                     const Params& p, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, p.q, p.B, p.Sq, p.H, D, kWgBQ) ||
      !tensor_map(&tk, p.k, p.B, p.Sk, p.HKV, D, kWgBK) ||
      !tensor_map(&tv, p.v, p.B, p.Sk, p.HKV, D, kWgBK))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = WgShape<D>::smem;
  const cudaError_t err = raise_smem_once(
      raised, reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.H, (p.Sq + kWgBQ - 1) / kWgBQ, p.B);
  kernel<<<grid, kWgThreads, smem, stream>>>(p, tq, tk, tv);
  return static_cast<int>(cudaGetLastError());
}

// K1 in arm kArm at head_dim D.
template <int D, int kArm>
int launch_wgmma(const Params& p, cudaStream_t stream) {
  static std::atomic<uint64_t> raised{0};
  return launch_fwd_wgmma<D>(fa_fwd_wgmma_kernel<D, kArm>, raised, p,
                             stream);
}

// K6 in arm kArm (kArmMask, with or without kArmSeg) at head_dim D.
template <int D, int kArm>
int launch_stream_wgmma(const Params& p, cudaStream_t stream) {
  static std::atomic<uint64_t> raised{0};
  return launch_fwd_wgmma<D>(fa_fwd_stream_wgmma_kernel<D, kArm>, raised, p,
                             stream);
}
