// Clip + AdamW + EMA in one pass over all of a trainer's f32 tensors, for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's update
// (topiaxl/pipelines/train.py:fused_adamw_ema_update) is one jnp function
// per parameter leaf that XLA fuses into one elementwise pass. Its math,
// per element, in f32 (gs: the clip's scale, the global norm's, read from
// the device so the host never waits for it):
//   gf = g * gs
//   m' = b1 * m + (1 - b1) * gf
//   v' = b2 * v + (1 - b2) * gf^2
//   u  = (m' / c1) / (sqrt(v' / c2) + eps)    (+ wd * p where wd != 0)
//   p' = p - lr * u
//   e' = decay * e + (1 - decay) * p'
// with IEEE division and square root (no fast-math flags); the
// complements 1 - b1, 1 - b2 and 1 - decay are taken in double and
// rounded once, as the plain version's scalars are, and each product is
// rounded where the plain version's CPU ops round it (a multiply-add
// where ``add_(alpha=)`` and ``addcmul_`` fuse one): the two differ only
// where the CPU's vectorised square root is not correctly rounded, by an
// f32 ulp. g is read and never written: the trainer drops it after the
// update.
//
// What bounds it on an H100: device-memory bytes. Each element reads p,
// g, m, v and e and writes p, m, v and e: 36 bytes, ~30 flops. The design:
// one launch covers every tensor through a table in device memory (per
// tensor the p, g, m, v, e pointers and its size, built each step since
// the gradients are new tensors each step) and a list of work items of
// kChunk elements (ops/adamw_ema.py:CHUNK) a block, so a
// large tensor spreads over many blocks and the small ones cost one small
// item each. A thread keeps kUnroll 16-byte loads of each of the five
// streams in flight before it computes; loads and stores are streaming
// (evict-first): nothing is read twice. A tensor whose five pointers are
// not all 16-byte aligned (an offset view) takes scalar loads, as does a
// chunk's ragged tail of fewer than 4 elements.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr long long kChunk = 32768;  // ops/adamw_ema.py:CHUNK

struct Hyper {
  float lr, c1, c2, b1, nb1, b2, nb2, eps, wd, decay, ndecay;
};

// one element; p, m, v, e updated in place
__device__ __forceinline__ void update(float& p, float g, float& m, float& v,
                                       float& e, float gs, const Hyper& h) {
  const float gf = g * gs;
  m = fmaf(h.nb1, gf, h.b1 * m);
  v = fmaf(h.nb2 * gf, gf, h.b2 * v);
  float u = (m / h.c1) / (sqrtf(v / h.c2) + h.eps);
  if (h.wd != 0.f) u = fmaf(h.wd, p, u);
  p = fmaf(-h.lr, u, p);
  e = fmaf(h.ndecay, p, h.decay * e);
}

__device__ __forceinline__ void update4(float4& p, const float4& g, float4& m,
                                        float4& v, float4& e, float gs,
                                        const Hyper& h) {
  update(p.x, g.x, m.x, v.x, e.x, gs, h);
  update(p.y, g.y, m.y, v.y, e.y, gs, h);
  update(p.z, g.z, m.z, v.z, e.z, gs, h);
  update(p.w, g.w, m.w, v.w, e.w, gs, h);
}

// tensors [n, 6]: p, g, m, v, e pointers and the element count; items
// [n_items]: tensor index << 32 | chunk index. One block per item.
__global__ void __launch_bounds__(kThreads)
    adamw_ema_kernel(const long long* __restrict__ tensors,
                     const long long* __restrict__ items,
                     const float* __restrict__ gscale, Hyper h) {
  const long long item = items[blockIdx.x];
  const long long* row = tensors + 6 * (item >> 32);
  const long long start = (item & 0xffffffffLL) * kChunk;
  const long long left = row[5] - start;
  const int count = static_cast<int>(left < kChunk ? left : kChunk);
  float* p = reinterpret_cast<float*>(row[0]) + start;
  const float* g = reinterpret_cast<const float*>(row[1]) + start;
  float* m = reinterpret_cast<float*>(row[2]) + start;
  float* v = reinterpret_cast<float*>(row[3]) + start;
  float* e = reinterpret_cast<float*>(row[4]) + start;
  const float gs = *gscale;

  int done = 0;
  // start is a multiple of 4 elements, so the bases decide the alignment
  if (((row[0] | row[1] | row[2] | row[3] | row[4]) & 15) == 0) {
    const int n4 = count >> 2;
    float4* p4 = reinterpret_cast<float4*>(p);
    float4* m4 = reinterpret_cast<float4*>(m);
    float4* v4 = reinterpret_cast<float4*>(v);
    float4* e4 = reinterpret_cast<float4*>(e);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    for (int base = threadIdx.x; base < n4; base += kThreads * kUnroll) {
      float4 rp[kUnroll], rg[kUnroll], rm[kUnroll], rv[kUnroll], re[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = base + u * kThreads;
        if (i < n4) {
          rp[u] = __ldcs(p4 + i);
          rg[u] = __ldcs(g4 + i);
          rm[u] = __ldcs(m4 + i);
          rv[u] = __ldcs(v4 + i);
          re[u] = __ldcs(e4 + i);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = base + u * kThreads;
        if (i < n4) {
          update4(rp[u], rg[u], rm[u], rv[u], re[u], gs, h);
          __stcs(p4 + i, rp[u]);
          __stcs(m4 + i, rm[u]);
          __stcs(v4 + i, rv[u]);
          __stcs(e4 + i, re[u]);
        }
      }
    }
    done = n4 << 2;
  }
  for (int i = done + threadIdx.x; i < count; i += kThreads) {
    float rp = __ldcs(p + i), rm = __ldcs(m + i), rv = __ldcs(v + i),
          re = __ldcs(e + i);
    update(rp, __ldcs(g + i), rm, rv, re, gs, h);
    __stcs(p + i, rp);
    __stcs(m + i, rm);
    __stcs(v + i, rv);
    __stcs(e + i, re);
  }
}

}  // namespace

// tensors [n, 6] int64 and items [n_items] int64 in device memory, as the
// kernel's comment above says; gscale one f32 on the
// device; lr, c1, c2, eps, wd as the plain version rounds them to f32; b1,
// b2 and decay in double (their complements are taken before rounding).
// Returns the launch's CUDA error code.
extern "C" int topiaxl_adamw_ema(const void* tensors, const void* items,
                                 int n_items,
                                 const void* gscale, float lr, float c1,
                                 float c2, double b1, double b2, float eps,
                                 float wd, double decay, void* stream) {
  if (n_items <= 0) return 0;
  const Hyper h{lr,
                c1,
                c2,
                static_cast<float>(b1),
                static_cast<float>(1.0 - b1),
                static_cast<float>(b2),
                static_cast<float>(1.0 - b2),
                eps,
                wd,
                static_cast<float>(decay),
                static_cast<float>(1.0 - decay)};
  adamw_ema_kernel<<<n_items, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(tensors),
      static_cast<const long long*>(items),
      static_cast<const float*>(gscale), h);
  return static_cast<int>(cudaGetLastError());
}
