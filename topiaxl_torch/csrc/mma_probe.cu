// Tensor-core rate probes for Hopper (sm_90a): chains of wgmma products
// on operands held in shared memory.
//
// Replaces the three TPU probe kernels of the matrix unit:
//   * benchmarks/microbench_pallas_int8.py:loop_kernel (mma_rate_loop):
//     out = sum_{i<L} (i % 3 - 1) * (A B), A [M, K], B [K, N]; bf16 in and
//     f32 out, or int8 in and int32 out;
//   * benchmarks/exp_dot_forms.py:_loop_kernel (dot_form_chain) and
//     benchmarks/exp_dot_forms2.py:_kernel (dot_form_accum): out = sum_{i<L}
//     A' B' for one attention dot form, bf16 in, f32 out, where A' is A
//     [M, K] or the transpose of A [K, M] and B' is B [K, N] or the
//     transpose of B [N, K] (the forms' dimension_numbers). The TPU chain
//     adds i * 1e-20 to A at step i so that Mosaic cannot hoist the
//     product out of its loop; this kernel issues every product anyway
//     and leaves the perturbation out (its test holds it against the
//     plain version, which keeps it).
//
// What bounds it on an H100: the tensor cores. Every product reuses
// operands already in shared memory, so device memory sees each input
// about once. The TPU ran one output block on one core; the dot forms
// have as few as 4 output tiles of 128 x BN, which on this card would
// leave 128 of the 132 SMs idle. The design:
//   * an output tile's work is L products on each of the contraction's
//     chunks (below). That (chunk, product) list, chunk-major, is cut into
//     S contiguous ranges, one block each (grid z): a split falls on
//     chunk boundaries where it can, so each block stages only its own
//     chunks, and inside a chunk it splits the product index (the rate
//     loop's coefficient follows the global index). The launcher picks S
//     so that tiles x S blocks fill the card's SMs in whole waves
//     (benchmarks/__init__.py:pick_splits); S = 1 stores the tile
//     directly. Otherwise each block stores its partial sum to slice z of
//     a workspace [S, out] and a second kernel sums the slices in slice
//     order: the result does not depend on which block ran first;
//   * a block is two warpgroups of 64 rows, each holding its sum in
//     registers for the whole launch;
//   * the TPU held whole operands in VMEM (512 x 1024 and 1024 x 1024 for
//     the int8 probe); a block's 227 KB cannot, so the block stages 256
//     bytes of the contraction at a time (128 bf16 or 256 int8 values of
//     each row of A and B) and runs its products on that chunk before
//     the next: chunk outer, iteration inner. That changes only the order
//     of summation, which is exact in int32;
//   * staging is plain 16-byte loads by every thread, once per chunk and
//     many products apart, so it needs no ring. It writes wgmma's
//     no-swizzle core-matrix layout (sm90.cuh), K-major or MN-major as the
//     operand arrives. 8-bit wgmma takes K-major operands only, so int8 B
//     ([K, N], N contiguous) is transposed as it is staged. A contraction
//     of 72 is zero-padded to 80 (wgmma's depth is 16 bf16); an output
//     width of 72 or 80 is a legal n72 or n80;
//   * every product goes into an accumulator of its own, d, which is then
//     added to the sum in registers, with its coefficient in the rate loop,
//     as the TPU bodies do (acc + d * c; o += dot): the rate loop issues
//     the products whose coefficient is 0 too. Summing hundreds of
//     thousands of products in place, in the tensor cores' own f32
//     accumulator, drifted from the plain f32 sum by more than 1e-3 on an
//     H100 (the products are exact; the accumulation is not rounded as the
//     plain adds are), so the chains do not. One product is in flight per
//     warpgroup; the block's two warpgroups overlap each other's adds.
//     Two accumulators in turn (product i + 1 issued before d_i is added)
//     were measured on an H100 and were no faster: as fast or slower on
//     every form, most on the transposed n72 forms, with more registers
//     (written as a rotated loop, ptxas also serialised its wgmmas, C7514).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kThreads = 256;      // two warpgroups
constexpr int kBlockM = 128;       // output rows per block, 64 per warpgroup
constexpr int kChunkBytes = 256;   // contraction bytes of each row per stage

template <typename T>
struct Elem;
template <>
struct Elem<__nv_bfloat16> {
  using Acc = float;
  static constexpr int kStep = 16;   // contraction depth of one wgmma
};
template <>
struct Elem<int8_t> {
  using Acc = int32_t;
  static constexpr int kStep = 32;
};

// rows [r0, r0 + R) of a row-major [rows, K] operand, contraction elements
// [k0, k0 + chunk), as K-major core matrices: kChunkBytes / 16 chunks of
// [R][16 bytes]; vectors past K read as zeros (K * sizeof(T) % 16 == 0)
template <typename T, int R>
__device__ __forceinline__ void stage_k_major(unsigned char* dst,
                                              const T* src, int K, int r0,
                                              int k0) {
  constexpr int kVecs = kChunkBytes / 16;
  constexpr int kPerVec = 16 / static_cast<int>(sizeof(T));
  for (int i = threadIdx.x; i < R * kVecs; i += kThreads) {
    const int r = i / kVecs;
    const int c = i - r * kVecs;
    const int k = k0 + c * kPerVec;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (k < K) {
      v = *reinterpret_cast<const uint4*>(
          src + static_cast<long long>(r0 + r) * K + k);
    }
    *reinterpret_cast<uint4*>(dst + c * R * 16 + r * 16) = v;
  }
}

// columns [c0, c0 + R) of a row-major bf16 [K, cols] operand, rows [k0,
// k0 + kChunkBytes / 2), as MN-major core matrices: R / 8 chunks of
// [kChunkBytes / 2][8]; rows past K read as zeros
template <int R>
__device__ __forceinline__ void stage_mn_major(unsigned char* dst,
                                               const __nv_bfloat16* src,
                                               int K, int cols, int c0,
                                               int k0) {
  constexpr int kRows = kChunkBytes / 2;
  constexpr int kVecs = R / 8;
  for (int i = threadIdx.x; i < kRows * kVecs; i += kThreads) {
    const int k = i / kVecs;
    const int c = i - k * kVecs;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (k0 + k < K) {
      v = *reinterpret_cast<const uint4*>(
          src + static_cast<long long>(k0 + k) * cols + c0 + c * 8);
    }
    *reinterpret_cast<uint4*>(dst + c * kRows * 16 + k * 16) = v;
  }
}

// columns [c0, c0 + R) of a row-major int8 [K, cols] operand, rows [k0,
// k0 + kChunkBytes), transposed into K-major core matrices (the layout of
// stage_k_major); rows past K read as zeros
template <int R>
__device__ __forceinline__ void stage_k_major_transposed(unsigned char* dst,
                                                         const int8_t* src,
                                                         int K, int cols,
                                                         int c0, int k0) {
  constexpr int kRows = kChunkBytes;
  constexpr int kVecs = R / 16;
  for (int i = threadIdx.x; i < kRows * kVecs; i += kThreads) {
    const int k = i / kVecs;
    const int c = i - k * kVecs;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (k0 + k < K) {
      v = *reinterpret_cast<const uint4*>(
          src + static_cast<long long>(k0 + k) * cols + c0 + c * 16);
    }
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    unsigned char* col = dst + (k >> 4) * R * 16 + (k & 15);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      col[(c * 16 + j) * 16] =
          static_cast<unsigned char>(w[j >> 2] >> (8 * (j & 3)));
    }
  }
}

template <typename T, int BN, int kTA, int kTB>
struct Probe {
  using Acc = typename Elem<T>::Acc;
  static constexpr bool k8 = sizeof(T) == 1;
  static constexpr int kChunk = kChunkBytes / static_cast<int>(sizeof(T));
  static constexpr int kStep = Elem<T>::kStep;
  static constexpr int kSteps = kChunk / kStep;   // wgmmas per full chunk
  static constexpr int kBmn = kTB && !k8;         // B read MN-major
  // bytes between the operands of consecutive wgmmas along the contraction
  static constexpr uint32_t kAStep = kTA ? 256 : 2 * kBlockM * 16;
  static constexpr uint32_t kBStep = kBmn ? 256 : 2 * BN * 16;
  static constexpr int kSmem = (kBlockM + BN) * kChunkBytes;
  static_assert(!k8 || (BN == 128 && !kTA), "int8: n128, A K-major only");
  static_assert(BN % 8 == 0 && BN <= 128, "BN");
};

// issues one product into d over the `steps` contraction steps of the
// staged chunk (the first overwrites d) as one wgmma group; d must not be
// read until that group has completed
template <typename T, int BN, int kTA, int kTB>
__device__ __forceinline__ void issue(
    typename Probe<T, BN, kTA, kTB>::Acc (&d)[BN / 2], uint64_t da,
    uint64_t db, int steps) {
  using P = Probe<T, BN, kTA, kTB>;
  fence_regs(d);
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < P::kSteps; ++s) {
    if (s < steps) {
      const uint64_t a = da + ((s * P::kAStep) >> 4);
      const uint64_t b = db + ((s * P::kBStep) >> 4);
      const int scale = s > 0 ? 1 : 0;
      if constexpr (P::k8) {
        wgmma_ss_s8_n128(d, a, b, scale);
      } else {
        wgmma_ss<BN, kTA, P::kBmn>(d, a, b, scale);
      }
    }
  }
  wgmma_commit();
}

// acc += c_i * d (rate loop: c_i = i % 3 - 1) or acc += d, once d's group
// has completed
template <bool kCoef, typename Acc, int N>
__device__ __forceinline__ void add(Acc (&acc)[N], Acc (&d)[N], int i) {
  fence_regs(d);
  if constexpr (kCoef) {
    const Acc c = static_cast<Acc>(i % 3 - 1);
#pragma unroll
    for (int j = 0; j < N; ++j) acc[j] += d[j] * c;
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) acc[j] += d[j];
  }
}

template <typename T, int BN, int kTA, int kTB, bool kCoef>
__global__ void __launch_bounds__(kThreads, 1)
mma_probe_kernel(const T* __restrict__ a, const T* __restrict__ b,
                 typename Elem<T>::Acc* __restrict__ out,
                 typename Elem<T>::Acc* __restrict__ ws, int M, int N, int K,
                 int L, int out_t) {
  using P = Probe<T, BN, kTA, kTB>;
  using Acc = typename P::Acc;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* As = smem;
  unsigned char* Bs = smem + kBlockM * kChunkBytes;

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid & 127) >> 5;
  const int lane = tid & 31;
  const int m0 = blockIdx.y * kBlockM;
  const int n0 = blockIdx.x * BN;
  // this warpgroup's 64 rows of A; all of B
  const uint64_t a_desc =
      kTA ? make_desc(As + wg * 8 * P::kChunk * 16, 128, P::kChunk * 16)
          : make_desc(As + wg * 64 * 16, kBlockM * 16, 128);
  const uint64_t b_desc = P::kBmn ? make_desc(Bs, 128, P::kChunk * 16)
                                  : make_desc(Bs, BN * 16, 128);

  // this block's range [w_lo, w_hi) of the tile's (chunk, product) list
  const int splits = static_cast<int>(gridDim.z);
  const long long work =
      static_cast<long long>((K + P::kChunk - 1) / P::kChunk) * L;
  const long long w_lo = work * blockIdx.z / splits;
  const long long w_hi = work * (blockIdx.z + 1) / splits;

  Acc acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  Acc d[BN / 2];

  for (long long w = w_lo; w < w_hi;) {
    const int chunk = static_cast<int>(w / L);
    const int i0 = static_cast<int>(w - static_cast<long long>(chunk) * L);
    const int i1 = static_cast<int>(
        min(static_cast<long long>(L), i0 + (w_hi - w)));
    const int k0 = chunk * P::kChunk;
    const int steps =
        min(P::kSteps, (K - k0 + P::kStep - 1) / P::kStep);
    __syncthreads();   // both warpgroups are done with the previous chunk
    if constexpr (kTA) {
      stage_mn_major<kBlockM>(As, a, K, M, m0, k0);
    } else {
      stage_k_major<T, kBlockM>(As, a, K, m0, k0);
    }
    if constexpr (P::kBmn) {
      stage_mn_major<BN>(Bs, b, K, N, n0, k0);
    } else if constexpr (kTB) {
      stage_k_major_transposed<BN>(Bs, b, K, N, n0, k0);
    } else {
      stage_k_major<T, BN>(Bs, b, K, n0, k0);
    }
    fence_proxy_async();
    __syncthreads();
    // one product in flight per warpgroup: the other warpgroup's products
    // keep the tensor cores busy while this one adds its d
    for (int i = i0; i < i1; ++i) {
      issue<T, BN, kTA, kTB>(d, a_desc, b_desc, steps);
      wgmma_wait<0>();
      add<kCoef>(acc, d, i);
    }
    w += i1 - i0;
  }

  // accumulator layout (sm90.cuh): rows g and g + 8 of the warp's 16,
  // columns 8 nt + 2 tg and + 1; out_t stores the [N, M] transpose. With
  // S > 1 the block's partial goes to its slice of the workspace, in the
  // output's layout.
  Acc* dst = splits > 1
                 ? ws + static_cast<long long>(blockIdx.z) * M * N
                 : out;
  const int row = m0 + wg * 64 + warp * 16 + (lane >> 2);
  const int col = n0 + 2 * (lane & 3);
#pragma unroll
  for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long r = row + (e >> 1) * 8;
      const long long c = col + nt * 8 + (e & 1);
      dst[out_t ? c * M + r : r * N + c] = acc[nt * 4 + e];
    }
  }
}

template <typename Acc>
struct Vec4;
template <>
struct Vec4<float> {
  using T = float4;
};
template <>
struct Vec4<int32_t> {
  using T = int4;
};

// out = sum over s of ws[s], s = 0, 1, ... in that order (n4 vectors of
// four elements per slice): the same sum on every launch
template <typename Acc>
__global__ void __launch_bounds__(256)
reduce_splits_kernel(const Acc* __restrict__ ws, Acc* __restrict__ out,
                     long long n4, int splits) {
  using V = typename Vec4<Acc>::T;
  const V* w = reinterpret_cast<const V*>(ws);
  V* o = reinterpret_cast<V*>(out);
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n4; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    V sum = w[i];
    for (int s = 1; s < splits; ++s) {
      const V v = w[s * n4 + i];
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    o[i] = sum;
  }
}

template <typename T_, int BN_, int kTA_, int kTB_, bool kCoef_>
struct Cfg {
  using T = T_;
  static constexpr int BN = BN_, kTA = kTA_, kTB = kTB_;
  static constexpr bool kCoef = kCoef_;
};

// fn(Cfg<...>{}) for the kernel the flags name; `bad` for a combination
// the kernel does not take
template <typename Fn>
int dispatch(int int8, int ta, int tb, int coef, int N, int bad, Fn&& fn) {
  using bf16 = __nv_bfloat16;
  if (coef || int8) {
    if (!coef || ta || !tb || N % 128) return bad;
    return int8 ? fn(Cfg<int8_t, 128, 0, 1, true>{})
                : fn(Cfg<bf16, 128, 0, 1, true>{});
  }
  auto chain = [&](auto bn) -> int {
    constexpr int BN = decltype(bn)::value;
    if (!ta && !tb) return fn(Cfg<bf16, BN, 0, 0, false>{});
    if (!ta && tb) return fn(Cfg<bf16, BN, 0, 1, false>{});
    if (ta && tb) return fn(Cfg<bf16, BN, 1, 1, false>{});
    return bad;
  };
  if (N % 128 == 0) return chain(std::integral_constant<int, 128>{});
  if (N == 80) return chain(std::integral_constant<int, 80>{});
  if (N == 72) return chain(std::integral_constant<int, 72>{});
  return bad;
}

}  // namespace

// out = sum_{i<L} c_i A' B' over row-major, contiguous operands, 16-byte
// aligned. ta = 0: A is [M, K], 1: A is [K, M] (A' its transpose); tb = 0:
// B is [N, K] (B' its transpose), 1: B is [K, N]. coef = 1: c_i = i % 3 - 1
// (the rate loop: bf16 or int8, ta 0, tb 1, N % 128 == 0), else c_i = 1
// (the dot forms: bf16, N % 128 == 0 or N in {72, 80}). int8 = 1: int8 in,
// int32 out, else bf16 in, f32 out. out is [M, N], or [N, M] when out_t.
// M % 128 == 0 and K * element bytes % 16 == 0. splits = S blocks share
// each output tile; with S > 1, ws holds S slices of out's size (f32 or
// int32, 16-byte aligned) and the partial sums are reduced into out by a
// second kernel on the same stream. Returns 0 or a CUDA error code.
extern "C" int topiaxl_mma_probe(const void* a, const void* b, void* out,
                                 void* ws, int int8, int ta, int tb, int coef,
                                 int M, int N, int K, int L, int out_t,
                                 int splits, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  const int elem = int8 ? 1 : 2;
  if (M <= 0 || N <= 0 || K <= 0 || L < 0 || M % kBlockM ||
      (K * elem) % 16 || splits < 1 || splits > 65535 ||
      (splits > 1 && ws == nullptr)) {
    return bad;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(int8, ta, tb, coef, N, bad, [&](auto cfg) -> int {
    using C = decltype(cfg);
    using T = typename C::T;
    using P = Probe<T, C::BN, C::kTA, C::kTB>;
    using Acc = typename P::Acc;
    const int err = allow_smem<
        mma_probe_kernel<T, C::BN, C::kTA, C::kTB, C::kCoef>>(P::kSmem);
    if (err != 0) return err;
    const dim3 grid(N / C::BN, M / kBlockM, splits);
    mma_probe_kernel<T, C::BN, C::kTA, C::kTB, C::kCoef>
        <<<grid, kThreads, P::kSmem, st>>>(
            static_cast<const T*>(a), static_cast<const T*>(b),
            static_cast<Acc*>(out), static_cast<Acc*>(ws), M, N, K, L,
            out_t);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
    const long long n4 = static_cast<long long>(M) * N / 4;
    const int blocks =
        static_cast<int>(std::min<long long>((n4 + 255) / 256, 4096));
    reduce_splits_kernel<Acc><<<blocks, 256, 0, st>>>(
        static_cast<const Acc*>(ws), static_cast<Acc*>(out), n4, splits);
    return static_cast<int>(cudaGetLastError());
  });
}

// blocks of the probe kernel for these flags that one SM holds at once
// (registers, shared memory, threads); 0 for flags it does not take or
// when the runtime cannot say
extern "C" int topiaxl_mma_probe_occupancy(int int8, int ta, int tb,
                                           int coef, int N) {
  return dispatch(int8, ta, tb, coef, N, 0, [&](auto cfg) -> int {
    using C = decltype(cfg);
    using T = typename C::T;
    using P = Probe<T, C::BN, C::kTA, C::kTB>;
    int blocks = 0;
    if (allow_smem<mma_probe_kernel<T, C::BN, C::kTA, C::kTB, C::kCoef>>(
            P::kSmem) != 0 ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, mma_probe_kernel<T, C::BN, C::kTA, C::kTB, C::kCoef>,
            kThreads, P::kSmem) != cudaSuccess) {
      return 0;
    }
    return blocks;
  });
}
