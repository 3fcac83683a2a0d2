// sparse_gossip: compact active-set mixing with the gather fused in.
//
// Replaces the TPU kernel src/repro/kernels/sparse_gossip/kernel.py:61
// sparse_gossip_pallas (body _sparse_gossip_kernel).  For an event whose A
// active workers are gidx[0..A), it computes the compact mixed rows
//
//     out[b, d] = Σ_a P_sub[a, b] · W[gidx[a], d]  −  Σ_a Q_sub[a, b] · G[a, d]
//               = ([−Q_sub; P_sub]ᵀ · [G; W[gidx]])[b, d]
//
// reading only the A gathered rows of the (N, D) carry W.  G is the (A, D)
// active-set gradient and Q_sub = diag(η·mask)·P_sub.  The wrapper clamps
// padded (-1) lanes to row 0 and zeroes their P/Q rows and columns, so their
// output rows are exactly zero; the kernels clamp indices into [0, N) on
// load as well (the gather semantics of the reference), so they never read
// outside W, and they write only out.
//
// What bounds it on an H100.  4·A²·D FLOP against 3·A·D elements moved
// (the gathered rows, G, out): 4·A/3 FLOP per element, A/3 FLOP per
// float32 byte.  At float32 parity a product costs three TF32 tensor-core
// products, 495/3 = 165 TFLOP/s, so the balance point is 165e12 / 3.35e12
// ≈ 49 FLOP/byte (the CUDA cores' 67 TFLOP/s would put it at 20).  At the
// 2-NN's widest leaf, D = 65536, float32:
// - A = 2 (the fused path): 1.6 MB, 0.0005 ms -- launch latency rules;
// - A = 16: 12.6 MB, 0.0038 ms, by bytes;
// - A = 64 (DSGD-AAU's merged and unmerged rows): 50 MB, 0.015 ms, by
//   bytes (21 FLOP/byte);
// - A = 256 (epoch barriers): 17.2 GFLOP, 0.104 ms, by operations
//   (85 FLOP/byte).
//
// Design: two bodies and one rule that picks between them.
// - A > SMALL_A: the two-pair 3xTF32 wgmma product of tf32_mix.cuh that
//   masked_gossip runs (a split prepass of [−Qᵀ | Pᵀ] into the caller's
//   scratch, then the 3-stage cp.async ring over [G; W] slabs), with the
//   W half gathered: each block copies gidx, clamped, into a table in
//   shared memory once and copies slab row k from W[table[k]].  The sum
//   order (the step half first, each slab's small terms before its large
//   ones) is masked_gossip's.  Two launches.
// - A ≤ SMALL_A: a CUDA-core body built for bytes.  A thread owns 4
//   columns of d and all A output rows (RB ≥ A accumulator rows, RB a power
//   of two, so no thread computes rows that A = 2 throws away); it walks
//   the lanes through a ring of RING lanes in shared memory that only it
//   reads, filled by 16-byte cp.async copies (8 bytes for bfloat16) of its
//   chunk of W[gidx[a]] and G[a], so RING − 1 lanes' loads are in flight
//   while it multiplies one.  P and Q sit in shared memory as float32.  No
//   barrier after the first: each thread waits only for its own copies.
//   One launch, no scratch.
// SMALL_A: at A ≤ 32 the wgmma body pads k to 32 and j to 64 columns, so
// most of its MMAs multiply zeros, and its prepass is a second launch; the
// CUDA-core body's A·4 accumulators a thread fit in its registers up to
// A = 32 (168-212 registers at RB = 32; only the bfloat16 element-wise
// variant spills, 16 bytes).  The measurements that set the rule are at
// SMALL_A below.
#include "tf32_mix.cuh"

namespace {

using repro::ceil_div;
using repro::from_f32;
using repro::to_f32;

// The rule: A ≤ SMALL_A runs the CUDA-core body, wider rows the wgmma body.
// Device ms with L2 emptied, float32, D = 65536, all lanes valid, wgmma
// body (prepass included) / CUDA-core body, two runs each (python
// src/repro_torch/xp/kernel_times.py, its "crossover" rows; NVIDIA H100
// 80GB HBM3, 700 W):
//   A =  8: 0.0144 / 0.0043      A = 24: 0.0161 / 0.0123
//   A = 16: 0.0149-0.0150 / 0.0068-0.0069
//   A = 32: 0.0177-0.0179 / 0.0157
// and the wgmma body alone at A = 48: 0.0286-0.0293, A = 64: 0.0298-0.0299
// (the CUDA-core body's accumulators do not fit there).  The CUDA-core
// body wins at every A it can take, so the rule is its register limit.
constexpr int SMALL_A = 32;

constexpr int ST = 64;      // threads per block of the CUDA-core body
constexpr int CH = 4;       // columns of d per thread
constexpr int RING = 8;     // lanes in a thread's ring of copies

// cp.async of `bytes` (4, 8 or 16; the first `src_bytes` read, the rest
// zero-filled) with a memory clobber: a thread re-fills ring slots it has
// just read, so no load of the ring may move past the copy
template <int BYTES>
__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           int src_bytes) {
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(repro::smem_addr(dst)), "l"(src), "r"(src_bytes)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(repro::smem_addr(dst)), "l"(src), "n"(BYTES),
                    "r"(src_bytes)
                 : "memory");
  }
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// a thread's chunk of a row: CH elements, copied and stored as one vector
template <typename T>
using Chunk = repro::tf32mix::Vec<T, CH>;

// out (A, D) = Pᵀ·W[gidx] − Qᵀ·G for A ≤ RB, on the CUDA cores.  VEC: D is
// a multiple of CH and every row starts on a chunk boundary, so each
// thread's chunk is one aligned copy; otherwise elements are loaded one
// by one, bounds-checked (odd widths such as the 2-NN's D = 10).
template <typename T, int RB, bool VEC>
__global__ void __launch_bounds__(ST)
small_kernel(const T* __restrict__ W, const T* __restrict__ G,
             const T* __restrict__ P, const T* __restrict__ Q,
             const int* __restrict__ gidx, T* __restrict__ out, int n_w,
             int A, int D) {
  __shared__ __align__(16) float sP[RB * RB];   // [a][b], zero past A
  __shared__ __align__(16) float sQ[RB * RB];
  __shared__ int sRow[RB];
  // the ring, chunks [slot][0: W, 1: G][thread]: a thread's own, only it
  // reads them (raw bytes: a __shared__ array takes no constructor)
  __shared__ __align__(16) unsigned char ring[(VEC ? RING : 1) * 2 * ST *
                                              sizeof(Chunk<T>)];
  auto chunk = [&](int a, int half) {
    return reinterpret_cast<Chunk<T>*>(ring) + ((a % RING) * 2 + half) * ST +
           threadIdx.x;
  };

  const int tid = threadIdx.x;
  for (int e = tid; e < RB * RB; e += ST) {
    const int a = e / RB, b = e % RB;
    const bool ok = a < A && b < A;
    sP[e] = ok ? to_f32(P[a * A + b]) : 0.f;
    sQ[e] = ok ? to_f32(Q[a * A + b]) : 0.f;
  }
  if (tid < RB) sRow[tid] = tid < A ? min(max(gidx[tid], 0), n_w - 1) : 0;
  __syncthreads();

  const long long d = (static_cast<long long>(blockIdx.x) * ST + tid) * CH;
  const bool in = d < D;
  float acc[RB][CH];
#pragma unroll
  for (int b = 0; b < RB; ++b)
#pragma unroll
    for (int c = 0; c < CH; ++c) acc[b][c] = 0.f;

  // lane a's contribution: acc[b] += P[a][b]·w − Q[a][b]·g, lane by lane,
  // the mix term before the step term
  auto fma_lane = [&](int a, const float (&w)[CH], const float (&g)[CH]) {
#pragma unroll
    for (int b = 0; b < RB; ++b) {
      const float p = sP[a * RB + b], q = sQ[a * RB + b];
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        acc[b][c] = fmaf(p, w[c], acc[b][c]);
        acc[b][c] = fmaf(-q, g[c], acc[b][c]);
      }
    }
  };

  if constexpr (VEC) {
    constexpr int BYTES = CH * sizeof(T);
    auto issue = [&](int a) {
      const bool ok = in && a < A;
      const T* w = ok ? W + static_cast<long long>(sRow[a]) * D + d : W;
      const T* g = ok ? G + static_cast<long long>(a) * D + d : G;
      copy_async<BYTES>(chunk(a, 0), w, ok ? BYTES : 0);
      copy_async<BYTES>(chunk(a, 1), g, ok ? BYTES : 0);
    };
#pragma unroll
    for (int a = 0; a < RING; ++a) {
      if (a < A) issue(a);
      commit_copies();
    }
    for (int a = 0; a < A; ++a) {
      wait_copies<RING - 1>();      // lane a's copies have landed
      const Chunk<T> cw = *chunk(a, 0), cg = *chunk(a, 1);
      float w[CH], g[CH];
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        w[c] = to_f32(cw.v[c]);
        g[c] = to_f32(cg.v[c]);
      }
      fma_lane(a, w, g);
      if (a + RING < A) issue(a + RING);   // into the slot just read
      commit_copies();
    }
  } else {
    for (int a = 0; a < A; ++a) {
      const T* wr = W + static_cast<long long>(sRow[a]) * D;
      const T* gr = G + static_cast<long long>(a) * D;
      float w[CH], g[CH];
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const bool ok = d + c < D;
        w[c] = ok ? to_f32(wr[d + c]) : 0.f;
        g[c] = ok ? to_f32(gr[d + c]) : 0.f;
      }
      fma_lane(a, w, g);
    }
  }

  if (!in) return;
#pragma unroll
  for (int b = 0; b < RB; ++b) {
    if (b >= A) break;
    T* o = out + static_cast<long long>(b) * D + d;
    if constexpr (VEC) {
      Chunk<T> v;
#pragma unroll
      for (int c = 0; c < CH; ++c) v.v[c] = from_f32<T>(acc[b][c]);
      *reinterpret_cast<Chunk<T>*>(o) = v;
    } else {
#pragma unroll
      for (int c = 0; c < CH; ++c)
        if (d + c < D) o[c] = from_f32<T>(acc[b][c]);
    }
  }
}

template <typename T, int RB>
int launch_small_rb(const T* W, const T* G, const T* P, const T* Q,
                    const int* gidx, T* out, int n_w, int A, int D,
                    cudaStream_t stream) {
  const long long blocks = ceil_div(D, static_cast<long long>(ST) * CH);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const bool vec = D % CH == 0 &&
      (reinterpret_cast<uintptr_t>(W) | reinterpret_cast<uintptr_t>(G) |
       reinterpret_cast<uintptr_t>(out)) % (CH * sizeof(T)) == 0;
  const dim3 grid(static_cast<unsigned>(blocks));
  if (vec)
    small_kernel<T, RB, true><<<grid, ST, 0, stream>>>(W, G, P, Q, gidx, out,
                                                       n_w, A, D);
  else
    small_kernel<T, RB, false><<<grid, ST, 0, stream>>>(W, G, P, Q, gidx, out,
                                                        n_w, A, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_small(const void* W, const void* G, const void* P, const void* Q,
                 const int* gidx, void* out, int n_w, int A, int D,
                 cudaStream_t stream) {
  const T* w = static_cast<const T*>(W);
  const T* g = static_cast<const T*>(G);
  const T* p = static_cast<const T*>(P);
  const T* q = static_cast<const T*>(Q);
  T* o = static_cast<T*>(out);
  if (A <= 2) return launch_small_rb<T, 2>(w, g, p, q, gidx, o, n_w, A, D, stream);
  if (A <= 4) return launch_small_rb<T, 4>(w, g, p, q, gidx, o, n_w, A, D, stream);
  if (A <= 8) return launch_small_rb<T, 8>(w, g, p, q, gidx, o, n_w, A, D, stream);
  if (A <= 16) return launch_small_rb<T, 16>(w, g, p, q, gidx, o, n_w, A, D, stream);
  static_assert(SMALL_A == 32, "the CUDA-core body's widest template is 32");
  return launch_small_rb<T, 32>(w, g, p, q, gidx, o, n_w, A, D, stream);
}

// The wgmma body: out (A, D) = Pᵀ·W[gidx] − Qᵀ·G as tf32_mix.cuh's
// two-pair product with W's (n_w, D) rows gathered through gidx; scratch
// holds 2·A·2·Kp float32 (Kp = A rounded up to 32), 16-byte aligned.
int launch_tensor(int dtype, const void* W, const void* G, const void* P,
                  const void* Q, const int* gidx, void* out, void* scratch,
                  int n_w, int A, int D, void* stream) {
  namespace tm = repro::tf32mix;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (A > tm::MAX_GATHER) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(scratch) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (dtype == repro::kFloat32)
    return tm::launch<float, 2, true>(W, G, P, Q, out, scratch, 1, A, D, s,
                                      gidx, n_w);
  if (dtype == repro::kBFloat16)
    return tm::launch<__nv_bfloat16, 2, true>(W, G, P, Q, out, scratch, 1, A,
                                              D, s, gidx, n_w);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Device kernels one call launches at A lanes under the rule: 1 (the
// CUDA-core body) for A ≤ SMALL_A, 2 (prepass and wgmma body) above.
extern "C" int sparse_gossip_kernels(int A) { return A <= SMALL_A ? 1 : 2; }

// out (A, D) = P_subᵀ·W[gidx] − Q_subᵀ·G; W (N, D), G (A, D), P/Q (A, A),
// gidx (A,) int32; every operand contiguous, float operands one dtype.
// scratch: 2·A·2·Kp float32 (Kp = A rounded up to 32), 16-byte aligned,
// read only by the wgmma body.  body: 0 follows the rule, 1 forces the
// CUDA-core body (A ≤ SMALL_A), 2 the wgmma body.
extern "C" int sparse_gossip_launch(int dtype, const void* W, const void* G,
                                    const void* P, const void* Q,
                                    const void* gidx, void* out, void* scratch,
                                    int N, int A, int D, int body,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* idx = static_cast<const int*>(gidx);
  if (N < 1 || body < 0 || body > 2 || (body == 1 && A > SMALL_A))
    return static_cast<int>(cudaErrorInvalidValue);
  if (body == 2 || (body == 0 && A > SMALL_A))
    return launch_tensor(dtype, W, G, P, Q, idx, out, scratch, N, A, D,
                         stream);
  if (dtype == repro::kFloat32)
    return launch_small<float>(W, G, P, Q, idx, out, N, A, D, s);
  if (dtype == repro::kBFloat16)
    return launch_small<__nv_bfloat16>(W, G, P, Q, idx, out, N, A, D, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
