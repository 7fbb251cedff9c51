// Multi-tensor AdamW for Hopper (sm_90a), behind a plain C interface that
// paddle_tpu_torch/ops/adamw_kernel.py loads through ctypes.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/_adamw_kernel.py
// ::_adamw_kernel (its pl.pallas_call is at _adamw_kernel.py:114). Same
// rule, element by element, in float32, with the steps the JAX package's
// Optimizer.step runs around it folded in (optimizer.py, _update_one):
//   g  = grad * clip, rounded to the grad's dtype   (global-norm clip:
//        clip = min(clip_norm / max(|g|, 1e-12), 1), read from device
//        memory; only on leaves whose clip flag is set)
//   g += l1 * sign(p)                                (L1Decay)
//   g += wd * p                                      (coupled decay)
//   m1 = b1 * m1 + (1 - b1) * g;   m2 = b2 * m2 + (1 - b2) * g * g
//   upd = (m1 / bc1) / (sqrt(m2 / bc2) + eps)   (bc1 = 1 - b1^t,
//                                                bc2 = 1 - b2^t)
//   upd += wd * p (decoupled);     p_new = p - lr * upd
// where p is the float32 master weight when the leaf has one (bf16 params
// under multi_precision), else the param itself. The update is IN PLACE:
// master, m1 and m2 are overwritten, and the param is written (when it has
// a master, write-only: the master is the source of truth).
//
// Where the TPU kernel took one leaf per launch, this kernel takes every
// leaf of a step in ONE launch: the caller passes a table of leaves
// (pointers, size, first chunk) in device memory, rebuilt each step since
// the grads are new tensors; block c finds its leaf by binary search over
// the table's first-chunk column and updates elements [c0, c0 + kChunk)
// of it, 16-byte vectors where every pointer of the leaf is aligned.
//
// The grad has its own dtype (float32 grads under bf16 params with
// decorate(master_grad=True)). Every operation is rounded as written, in
// the plain version's order (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn:
// no FMA contraction), so master, moments and param are bit for bit what
// the plain version's separate PyTorch ops give.
//
// What bounds it: bytes. Per parameter with a master weight it reads the
// grad (2 B), master, m1, m2 (12 B) and writes the param (2 B), master,
// m1, m2 (12 B): 28 bytes for ~12 flops. At the training step's 1.881e9
// parameters that is 52.7 GB, 15.7 ms at 3.35 TB/s. The design moves each
// byte once (casts fused into the same pass, the bf16 param never read)
// and keeps every SM busy with one launch, so the wall time should sit
// near that bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

enum DType { kF32 = 0, kBF16 = 1 };

constexpr int kThreads = 256;
constexpr long long kChunk = 8192;  // elements per block

// One leaf, as the wrapper lays it out: ten int64 fields.
struct Leaf {
  long long param;    // param (written; read too when there is no master)
  long long master;   // float32 master weight, or 0
  long long grad;     // grad
  long long m1, m2;   // float32 moments
  long long n;        // elements
  long long chunk0;   // index of the leaf's first chunk over all leaves
  long long dtype;    // param dtype
  long long gdtype;   // grad dtype
  long long flags;    // kVec | kClip
};

constexpr long long kVec = 1;   // every pointer allows 4-element access
constexpr long long kClip = 2;  // the grad takes the clip factor

struct Hyper {
  float lr, b1, b2, omb1, omb2, eps, wd, bc1, bc2, l1;
  int decoupled;
};

__device__ __forceinline__ float load1(const void* p, long long i, int dt) {
  return dt == kBF16
             ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
             : static_cast<const float*>(p)[i];
}
__device__ __forceinline__ void store1(void* p, long long i, int dt,
                                       float x) {
  if (dt == kBF16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(x);
  else
    static_cast<float*>(p)[i] = x;
}

// four consecutive elements at i (a multiple of 4)
__device__ __forceinline__ float4 load4(const void* p, long long i, int dt) {
  if (dt == kBF16) {
    const uint2 raw = *reinterpret_cast<const uint2*>(
        static_cast<const __nv_bfloat16*>(p) + i);
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
    const float2 fa = __bfloat1622float2(a), fb = __bfloat1622float2(b);
    return make_float4(fa.x, fa.y, fb.x, fb.y);
  }
  return *reinterpret_cast<const float4*>(static_cast<const float*>(p) + i);
}
__device__ __forceinline__ void store4(void* p, long long i, int dt,
                                       float4 x) {
  if (dt == kBF16) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
    const __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
    uint2 raw;
    raw.x = *reinterpret_cast<const unsigned*>(&a);
    raw.y = *reinterpret_cast<const unsigned*>(&b);
    *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(p) + i) = raw;
  } else {
    *reinterpret_cast<float4*>(static_cast<float*>(p) + i) = x;
  }
}

// the grad as the rule sees it: clipped and rounded to its dtype, then
// the L1 term of the (master) weight added
__device__ __forceinline__ float prep_grad(float g, float p, float cf,
                                           bool clip, int gdt,
                                           const Hyper& h) {
  if (clip) {
    g = __fmul_rn(g, cf);
    if (gdt == kBF16) g = __bfloat162float(__float2bfloat16(g));
  }
  if (h.l1 != 0.f)
    g = __fadd_rn(g, p > 0.f ? h.l1 : (p < 0.f ? -h.l1 : 0.f));
  return g;
}

__device__ __forceinline__ void adam1(float g, float& p, float& m1,
                                      float& m2, float cf, bool clip,
                                      int gdt, const Hyper& h) {
  g = prep_grad(g, p, cf, clip, gdt, h);
  if (h.wd != 0.f && !h.decoupled) g = __fadd_rn(g, __fmul_rn(h.wd, p));
  m1 = __fadd_rn(__fmul_rn(h.b1, m1), __fmul_rn(h.omb1, g));
  m2 = __fadd_rn(__fmul_rn(h.b2, m2), __fmul_rn(__fmul_rn(h.omb2, g), g));
  float upd = __fdiv_rn(__fdiv_rn(m1, h.bc1),
                        __fadd_rn(__fsqrt_rn(__fdiv_rn(m2, h.bc2)), h.eps));
  if (h.wd != 0.f && h.decoupled) upd = __fadd_rn(upd, __fmul_rn(h.wd, p));
  p = __fsub_rn(p, __fmul_rn(h.lr, upd));
}

__global__ void __launch_bounds__(kThreads)
    adamw_multi_tensor_kernel(const Leaf* __restrict__ leaves, int n_leaves,
                              const float* __restrict__ clip_factor,
                              Hyper h) {
  const long long chunk = blockIdx.x;
  int lo = 0, hi = n_leaves - 1;  // the last leaf whose chunk0 <= chunk
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (leaves[mid].chunk0 <= chunk) lo = mid; else hi = mid - 1;
  }
  const Leaf L = leaves[lo];
  const int dt = static_cast<int>(L.dtype);
  const int gdt = static_cast<int>(L.gdtype);
  const bool clip = clip_factor != nullptr && (L.flags & kClip);
  const float cf = clip ? *clip_factor : 1.f;
  void* param = reinterpret_cast<void*>(L.param);
  float* master = reinterpret_cast<float*>(L.master);
  const void* grad = reinterpret_cast<const void*>(L.grad);
  float* m1p = reinterpret_cast<float*>(L.m1);
  float* m2p = reinterpret_cast<float*>(L.m2);
  const long long base = (chunk - L.chunk0) * kChunk;
  const long long end = min(L.n, base + kChunk);

  for (long long i = base + 4 * threadIdx.x; i < end; i += 4 * kThreads) {
    if ((L.flags & kVec) && i + 4 <= end) {
      const float4 g = load4(grad, i, gdt);
      float4 p = master != nullptr
                     ? *reinterpret_cast<const float4*>(master + i)
                     : load4(param, i, dt);
      float4 a = *reinterpret_cast<const float4*>(m1p + i);
      float4 b = *reinterpret_cast<const float4*>(m2p + i);
      adam1(g.x, p.x, a.x, b.x, cf, clip, gdt, h);
      adam1(g.y, p.y, a.y, b.y, cf, clip, gdt, h);
      adam1(g.z, p.z, a.z, b.z, cf, clip, gdt, h);
      adam1(g.w, p.w, a.w, b.w, cf, clip, gdt, h);
      *reinterpret_cast<float4*>(m1p + i) = a;
      *reinterpret_cast<float4*>(m2p + i) = b;
      if (master != nullptr) *reinterpret_cast<float4*>(master + i) = p;
      store4(param, i, dt, p);
    } else {
      for (long long t = i; t < min(i + 4, end); ++t) {
        float p = master != nullptr ? master[t] : load1(param, t, dt);
        float a = m1p[t], b = m2p[t];
        adam1(load1(grad, t, gdt), p, a, b, cf, clip, gdt, h);
        m1p[t] = a;
        m2p[t] = b;
        if (master != nullptr) master[t] = p;
        store1(param, t, dt, p);
      }
    }
  }
}

}  // namespace

// One launch over every leaf of the table (n_leaves rows of ten int64,
// in device memory, sorted by chunk0, every leaf non-empty; n_chunks =
// the sum of ceil(n / 8192)). clip_factor: one float32 in device memory,
// or null for no clip. Returns cudaGetLastError() after the launch (0 =
// launched).
extern "C" int adamw_multi_tensor(const void* table, int n_leaves,
                                  long long n_chunks,
                                  const float* clip_factor, float lr,
                                  float b1, float b2, float omb1, float omb2,
                                  float eps, float wd, float bc1, float bc2,
                                  float l1, int decoupled, void* stream) {
  if (n_leaves <= 0 || n_chunks <= 0) return 0;
  if (n_chunks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const Hyper h{lr, b1, b2, omb1, omb2, eps, wd, bc1, bc2, l1, decoupled};
  adamw_multi_tensor_kernel<<<static_cast<unsigned>(n_chunks), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Leaf*>(table), n_leaves, clip_factor, h);
  return static_cast<int>(cudaGetLastError());
}
