// K1's forward for Hopper: TMA-fed shared-memory ring, wgmma products,
// warp specialisation. Included by flash_attention.cu inside its
// anonymous namespace (it uses that file's Params, masking, dropout and
// tile tests); bf16 at head_dim 64 and 128, every arm K1 takes (none,
// kArmSeg, kArmDrop, kArmSeg | kArmDrop), causal or not, GQA, lse on or
// off. K6 and the CUDA-core forms keep fwd_mma / fwd_core.
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

constexpr int kWgBQ = 128, kWgBK = 128, kWgStages = 2;
// two consumer warpgroups and a producer warpgroup (one warp of it works);
// setmaxnreg moves the producer's registers to the consumers:
// 128 x 24 + 256 x 240 <= 65536
constexpr int kWgConsumers = 256, kWgThreads = kWgConsumers + 128;
constexpr int kWgProducerRegs = 24, kWgConsumerRegs = 240;
constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;

template <int D>
struct WgShape {
  static constexpr int kHalves = D / 64;  // 64-element (128-byte) columns
  static constexpr int q_bytes = kWgBQ * D * 2;
  static constexpr int kv_bytes = kWgBK * D * 2;  // one K or V tile
  static constexpr int ring = kWgStages * 2 * kv_bytes;
  // tiles, then 7 mbarriers and the stages' flags; + 1024 to align
  static constexpr int smem = q_bytes + ring + 128 + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
// Wait until the barrier's phase `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// One [rows][64] box of a [B, S, heads * D] bf16 tensor map at (column
// c0, row s0, batch b) into dst, completing on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int s0,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(s0), "r"(b)
      : "memory");
}

// The wgmma descriptor of a 128-byte-swizzled tile at p (1024-aligned
// atoms of 8 rows x 128 bytes): start address, leading byte offset lbo,
// stride byte offset 1024 (the next 8 rows), swizzle mode 128B.
__device__ __forceinline__ uint64_t wg_desc(const void* p, uint32_t lbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving accesses of x across the wgmma waits.
template <int N>
__device__ __forceinline__ void wg_fence_regs(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}

// d (64 x 128, float32) = A (64 x 16) * B (16 x 128) + (scale_d ? d : 0):
// A and B bf16 in shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 128, float32) += A (64 x 16, bf16, registers) * B (16 x 128, bf16,
// shared, MN-major: the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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

// d (64 x 64, float32) += A (64 x 16, bf16, registers) * B (16 x 64, bf16,
// shared, MN-major: the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
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

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (D == 128) wgmma_rs_n128(o, a, db);
  else wgmma_rs_n64(o, a, db);
}

// The stage flags the producer writes: the tile is dead (skipped, nothing
// loaded) / interior (no row or key of it is masked).
constexpr int kTileDead = 1, kTileInterior = 2;

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
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], kWgConsumers / 32);  // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kWgConsumers / 32) {
    // -- the producer warp --------------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kWgProducerRegs));
    if (warp > kWgConsumers / 32) return;
    if (lane == 0) {
      mbar_expect_tx(q_full, WS::q_bytes);
      for (int j = 0; j < WS::kHalves; ++j)
        tma_load(Qs + j * HALF_Q, &tq, q_full, h * D + 64 * j, q0, b);
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
          for (int j = 0; j < WS::kHalves; ++j)
            tma_load(kd + j * HALF_K, &tk, &k_full[st], hk * D + 64 * j, k0,
                     b);
          mbar_expect_tx(&v_full[st], WS::kv_bytes);
          for (int j = 0; j < WS::kHalves; ++j)
            tma_load(vd + j * HALF_K, &tv, &v_full[st], hk * D + 64 * j, k0,
                     b);
        }
      }
      __syncwarp();
    }
  } else {
    // -- the consumer warpgroups --------------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        kWgConsumerRegs));
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
      const int flags = info[st];
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
        pa[0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
        pa[1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
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

// -- host side ------------------------------------------------------------

// cuTensorMapEncodeTiled, fetched from the driver through the runtime, so
// that the library links no -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &res);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// The tensor map of a contiguous bf16 [B, S, heads, D] tensor seen as [B,
// S, heads * D], read in [rows][64] boxes with the 128-byte swizzle; rows
// past S come in as zeros.
bool tensor_map(CUtensorMap* map, const void* x, int B, int S, int heads,
                int D, int rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(heads) * D,
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {dims[0] * 2, dims[0] * 2 * dims[1]};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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
  // the shared memory limit above 48 KB, raised once per instantiation
  // and device (bit d of `raised` for device d < 64)
  static std::atomic<uint64_t> raised{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (!(raised.load() & bit)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    raised.fetch_or(bit);
  }
  const dim3 grid(p.H, p.B, (p.Sq + kWgBQ - 1) / kWgBQ);
  kernel<<<grid, kWgThreads, smem, stream>>>(p, tq, tk, tv);
  return static_cast<int>(cudaGetLastError());
}
