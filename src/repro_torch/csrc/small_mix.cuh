// The CUDA-core body of the gossip products at few rows, shared by
// gossip_mix.cu, masked_gossip.cu and sparse_gossip.cu:
//
//   out[e] = P[e]ᵀ·W[e]                    (PAIRS = 1: gossip_mix, batched)
//   out    = Pᵀ·W − Qᵀ·G                   (PAIRS = 2: masked_gossip)
//   out    = Pᵀ·W[gidx] − Qᵀ·G             (PAIRS = 2, GATHER: sparse_gossip)
//
// W, G, out are (A, D) row-stacked leaves (W (n_w, D) when gathered), P and
// Q (A, A), A ≤ MAX_RB; the sum runs in float32 FMAs and is rounded once
// to W's dtype.  It is built for bytes: at A ≤ 32 the product is 2·A FLOP
// an element of W against 2 elements moved (read and write), so the
// card's 3.35 TB/s bound it long before the CUDA cores' 67 TFLOP/s, and
// the tensor-core body (tf32_mix.cuh) pads k to 32 and j to 64 and spends
// a second launch on its prepass.
//
// Precision.  Float32 FMAs round each step to nearest, so none of
// tf32_mix.cuh's slab rules apply: at N = 32 with an unnormalised P
// (outputs up to 16.5) the body is 3.974e-06 (one pair) and 5.542e-06 (two
// pairs) from the float64 product, cuBLAS 3.974e-06 and 3.700e-06
// (chip_smoke.py phase 2; NVIDIA H100 80GB HBM3, 700.00 W).
//
// Design.  A thread owns CH columns of d (one chunk) and all A output rows
// (RB ≥ A accumulator rows, RB a power of two, so that A = 2 computes no
// rows it throws away).  It walks the lanes through a ring of RING chunks
// in shared memory that only it reads, filled by cp.async copies of its
// chunk of W[a] (and G[a]), so RING − 1 lanes' loads are in flight while
// it multiplies one, and it waits only for its own copies: no barrier
// after P and Q are loaded (float32, shared memory).  One tile of
// THREADS·CH columns a block, the problem index on blockIdx.y.  One
// launch, no scratch.  At PAIRS = 2 with GATHER (one problem) it is
// sparse_gossip's CUDA-core body.
//
// Bytes in flight.  The card needs about 3.35 TB/s × ~1 µs ≈ 3.4 MB in
// flight, ~25 KB an SM.  A thread holds min(RING, A) × PAIRS chunks in
// flight.  At phase 26's N = 4, bf16, one pair: 4 chunks of 8 bytes; at 40
// registers an SM keeps 24 blocks, 1536 threads, 48 KB.  At the 100m
// preset's N = 8, float32, two pairs: 16 chunks of 16 bytes at 70
// registers, 13 blocks, 208 KB.  The widest template (RB = 32, two pairs,
// 182-211 registers, 4 blocks) keeps 32-64 KB.  (Registers and resident
// blocks: python -m repro_torch.xp.small_mix_variants; NVIDIA H100 80GB
// HBM3.)
#pragma once

#include <climits>
#include <cstdint>

#include "tf32_mix.cuh"

namespace repro {
namespace smallmix {

constexpr int THREADS = 64;   // threads a block
constexpr int CH = 4;         // columns of d a thread (see below)
constexpr int RING = 8;       // lanes in a thread's ring of copies
constexpr int MAX_RB = 32;    // the widest accumulator template

// CH: 4 columns a thread (16 bytes of float32, 8 of bfloat16), one tile of
// THREADS·CH columns a block.  Against 8 bfloat16 columns (a 16-byte
// chunk), and against a grid of every SM's resident blocks striding over
// the tiles, P loaded once a block, device ms with L2 emptied (python -m
// repro_torch.xp.small_mix_variants, which carries those variants in a
// kernel of its own; NVIDIA H100 80GB HBM3, 700.00 W; this body, then the
// tool's CH = 4 tile / stride, CH = 8 tile / stride; the bound is the
// bytes over 3.35 TB/s):
//   N = 4, D = 655,360,000, bf16, one pair (bound 3.1301):
//     3.4881; 3.4896 / 3.7990, 3.6175 / 4.4618
//   N = 8, D = 21,233,664, two pairs (bound 0.6085 fp32, 0.3042 bf16):
//     fp32 0.7724; 0.7096 / 0.7712
//     bf16 0.3273; 0.3438 / 0.3575, 0.3565 / 0.3740
//   D = 65536, bf16, N = 2-32: CH = 8 within 0.0002 ms of CH = 4 up to
//     N = 8, then slower (N = 16, two pairs: 0.0071 against 0.0057; at
//     N = 32 0.0425 against 0.0148, where 8·32 accumulators spill)
// Eight columns cost registers (56 against 37 at N = 4: 18 resident
// blocks an SM against 24) and win nothing, and the striding grid loses
// at the LM widths and ties at D = 65536.  (The tool's own CH = 4 tile,
// one tile a block as here, reads 8 % under this body at the 100m leaf in
// float32 and 5 % over it in bfloat16; unexplained, open.)

// a thread's chunk of a row: CH elements, copied and stored as one vector
template <typename T>
using Chunk = tf32mix::Vec<T, CH>;

// cp.async of `bytes` (4, 8 or 16; the first `src_bytes` read, the rest
// zero-filled) with a memory clobber: a thread re-fills ring slots it has
// just read, so no load of the ring may move past the copy
template <int BYTES>
__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           int src_bytes) {
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "n"(BYTES),
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

// out[e] (A, D) = P[e]ᵀ·W[e] (− Q[e]ᵀ·G[e]) for A ≤ RB, one tile of
// THREADS·CH columns a block, the problem e on blockIdx.y.  W holds n_w
// rows a problem (n_w = A unless gathered: then row a is W[gidx[a]],
// clamped into [0, n_w)).  VEC: D is a multiple of CH and every row starts
// on a chunk boundary, so each thread's chunk is one aligned copy;
// otherwise elements are loaded one by one, bounds-checked (odd widths
// such as the 2-NN's D = 10).
template <typename T, int RB, int PAIRS, bool GATHER, bool VEC>
__global__ void __launch_bounds__(THREADS)
small_kernel(const T* __restrict__ W, const T* __restrict__ G,
             const T* __restrict__ P, const T* __restrict__ Q,
             const int* __restrict__ gidx, T* __restrict__ out, int n_w,
             int A, int D) {
  static_assert(PAIRS == 1 || PAIRS == 2, "one or two operand pairs");
  __shared__ __align__(16) float sP[RB * RB];   // [a][b], zero past A
  __shared__ __align__(16) float sQ[PAIRS == 2 ? RB * RB : 1];
  __shared__ int sRow[GATHER ? RB : 1];   // the gathered rows, clamped
  // the ring, chunks [lane % RING][0: W, 1: G][thread]: a thread's own,
  // only it reads them (raw bytes: a __shared__ array takes no constructor)
  __shared__ __align__(16) unsigned char ring[(VEC ? RING : 1) * PAIRS *
                                              THREADS * sizeof(Chunk<T>)];
  auto chunk = [&](int a, int half) {
    return reinterpret_cast<Chunk<T>*>(ring) +
           ((a % RING) * PAIRS + half) * THREADS + threadIdx.x;
  };

  if constexpr (!GATHER) {   // problem e (gathered: one problem, E = 1)
    const long long e = blockIdx.y;
    const long long nd = static_cast<long long>(A) * D;
    W += e * nd;
    if constexpr (PAIRS == 2) G += e * nd;
    out += e * nd;
    P += e * A * A;
    if constexpr (PAIRS == 2) Q += e * A * A;
  }

  const int tid = threadIdx.x;
  for (int i = tid; i < RB * RB; i += THREADS) {
    const int a = i / RB, b = i % RB;
    const bool ok = a < A && b < A;
    sP[i] = ok ? to_f32(P[a * A + b]) : 0.f;
    if constexpr (PAIRS == 2) sQ[i] = ok ? to_f32(Q[a * A + b]) : 0.f;
  }
  if constexpr (GATHER)
    if (tid < RB) sRow[tid] = tid < A ? min(max(gidx[tid], 0), n_w - 1) : 0;
  __syncthreads();
  auto row = [&](int a) -> int {   // W's row of lane a
    if constexpr (GATHER) return sRow[a];
    else return a;
  };

  const long long d = (static_cast<long long>(blockIdx.x) * THREADS + tid) * CH;
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
      const float p = sP[a * RB + b];
      [[maybe_unused]] const float q = PAIRS == 2 ? sQ[a * RB + b] : 0.f;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        acc[b][c] = fmaf(p, w[c], acc[b][c]);
        if constexpr (PAIRS == 2) acc[b][c] = fmaf(-q, g[c], acc[b][c]);
      }
    }
  };

  if constexpr (VEC) {
    constexpr int BYTES = CH * sizeof(T);
    auto issue = [&](int a) {
      const bool ok = in && a < A;
      const T* w = ok ? W + static_cast<long long>(row(a)) * D + d : W;
      copy_async<BYTES>(chunk(a, 0), w, ok ? BYTES : 0);
      if constexpr (PAIRS == 2) {
        const T* g = ok ? G + static_cast<long long>(a) * D + d : G;
        copy_async<BYTES>(chunk(a, 1), g, ok ? BYTES : 0);
      }
    };
#pragma unroll
    for (int a = 0; a < RING; ++a) {
      if (a < A) issue(a);
      commit_copies();
    }
    for (int a = 0; a < A; ++a) {
      wait_copies<RING - 1>();      // lane a's copies have landed
      float w[CH], g[CH];
      const Chunk<T> cw = *chunk(a, 0);
#pragma unroll
      for (int c = 0; c < CH; ++c) w[c] = to_f32(cw.v[c]);
      if constexpr (PAIRS == 2) {
        const Chunk<T> cg = *chunk(a, 1);
#pragma unroll
        for (int c = 0; c < CH; ++c) g[c] = to_f32(cg.v[c]);
      }
      fma_lane(a, w, g);
      if (a + RING < A) issue(a + RING);   // into the slot just read
      commit_copies();
    }
  } else {
    for (int a = 0; a < A; ++a) {
      const T* wr = W + static_cast<long long>(row(a)) * D;
      const T* gr = PAIRS == 2 ? G + static_cast<long long>(a) * D : nullptr;
      float w[CH], g[CH];
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const bool ok = d + c < D;
        w[c] = ok ? to_f32(wr[d + c]) : 0.f;
        if constexpr (PAIRS == 2) g[c] = ok ? to_f32(gr[d + c]) : 0.f;
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

// One template of the body over E problems of A rows.  Returns the CUDA
// status of the launch.
template <typename T, int RB, int PAIRS, bool GATHER>
int launch_at(const void* W, const void* G, const void* P, const void* Q,
              const int* gidx, void* out, int n_w, int E, int A, int D,
              cudaStream_t stream) {
  const long long blocks = ceil_div(D, static_cast<long long>(THREADS) * CH);
  if (blocks > INT_MAX || E > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const T* w = static_cast<const T*>(W);
  const T* g = static_cast<const T*>(G);
  const T* p = static_cast<const T*>(P);
  const T* q = static_cast<const T*>(Q);
  T* o = static_cast<T*>(out);
  const bool vec = D % CH == 0 &&
      (reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(g) |
       reinterpret_cast<uintptr_t>(o)) % sizeof(Chunk<T>) == 0;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(E));
  if (vec)
    small_kernel<T, RB, PAIRS, GATHER, true><<<grid, THREADS, 0, stream>>>(
        w, g, p, q, gidx, o, n_w, A, D);
  else
    small_kernel<T, RB, PAIRS, GATHER, false><<<grid, THREADS, 0, stream>>>(
        w, g, p, q, gidx, o, n_w, A, D);
  return static_cast<int>(cudaGetLastError());
}

// The body for dtype code `dtype` at 1 ≤ A ≤ MAX_RB: the smallest RB ≥ A.
// PAIRS = 1 takes W and P (G and Q null); GATHER takes gidx (E = 1).
template <int PAIRS, bool GATHER>
int dispatch(int dtype, const void* W, const void* G, const void* P,
             const void* Q, const int* gidx, void* out, int n_w, int E, int A,
             int D, cudaStream_t s) {
  static_assert(MAX_RB == 32, "the widest template below is 32");
  if (A < 1 || A > MAX_RB || (GATHER && E != 1) ||
      (G != nullptr) != (PAIRS == 2) || (Q != nullptr) != (PAIRS == 2))
    return static_cast<int>(cudaErrorInvalidValue);
  auto go = [&](auto tag) {
    using T = decltype(tag);
    if (A <= 2) return launch_at<T, 2, PAIRS, GATHER>(W, G, P, Q, gidx, out, n_w, E, A, D, s);
    if (A <= 4) return launch_at<T, 4, PAIRS, GATHER>(W, G, P, Q, gidx, out, n_w, E, A, D, s);
    if (A <= 8) return launch_at<T, 8, PAIRS, GATHER>(W, G, P, Q, gidx, out, n_w, E, A, D, s);
    if (A <= 16) return launch_at<T, 16, PAIRS, GATHER>(W, G, P, Q, gidx, out, n_w, E, A, D, s);
    return launch_at<T, 32, PAIRS, GATHER>(W, G, P, Q, gidx, out, n_w, E, A, D, s);
  };
  if (dtype == kFloat32) return go(float{});
  if (dtype == kBFloat16) return go(__nv_bfloat16{});
  return static_cast<int>(cudaErrorInvalidValue);
}

// -- the dense rule -----------------------------------------------------------

// gossip_mix, gossip_mix_batched and masked_gossip run the CUDA-core body
// at N ≤ SMALL_N and the tensor-core body above; a caller may force either
// body, the CUDA-core one up to N = MAX_RB.  Device ms with L2 emptied,
// D = 65536, CUDA-core body / tensor-core body (prepass included), two
// runs (python src/repro_torch/xp/kernel_times.py, its "crossover" rows;
// NVIDIA H100 80GB HBM3, 700.00 W):
//            gossip_mix fp32  bf16             masked_gossip fp32  bf16
//   N =  2:  0.0024 / 0.0091  0.0024 / 0.0072  0.0025 / 0.0136  0.0024 / 0.0090
//   N =  4:  0.0026 / 0.0092  0.0025 / 0.0073  0.0030 / 0.0136  0.0027 / 0.0089
//   N =  8:  0.0033 / 0.0096  0.0031 / 0.0074  0.0040 / 0.0137  0.0035 / 0.0090
//   N = 16:  0.0049 / 0.0111  0.0048 / 0.0082  0.0067 / 0.0148  0.0062 / 0.0097
//   N = 24:  0.0086 / 0.0127  0.0090 / 0.0097  0.0122 / 0.0160  0.0127 / 0.0109
//   N = 32:  0.0108 / 0.0142  0.0116 / 0.0111  0.0157 / 0.0176  0.0164 / 0.0123
// and the tensor-core body alone at N = 48: 0.0181, 0.0123, 0.0278,
// 0.0166; N = 64: 0.0194, 0.0133, 0.0297, 0.0177.  At the LM widths the
// CUDA-core body wins by 4-13× (N = 4, D = 655,360,000: bf16 3.4931-
// 3.7576 / 43.7699-43.7715, fp32 7.3156-7.3162 / 62.9594-63.0933; N = 8,
// D = 21,233,664, two pairs: fp32 0.7702-0.7717 / 3.4728-3.4865, bf16
// 0.3309-0.3317 / 2.0132-2.1421).  In float32 it wins at every N it
// takes; in bfloat16 its FMAs outweigh the halved bytes from N = 24
// (masked_gossip 17 % behind there, both 4-33 % behind at N = 32).  The
// rule takes the N where it wins in both dtypes.
constexpr int SMALL_N = 16;
static_assert(SMALL_N <= MAX_RB, "the CUDA-core body takes N ≤ MAX_RB");

// Device kernels one dense call launches at N under the rule.
inline int dense_kernels(int N) { return N <= SMALL_N ? 1 : 2; }

// The dense products' dispatch.  body: 0 follows the rule, 1 forces the
// CUDA-core body (N ≤ MAX_RB), 2 the tensor-core body, which alone reads
// scratch (E·2·N·PAIRS·Kp float32, 16-byte aligned).
template <int PAIRS>
int dense_dispatch(int dtype, const void* W, const void* G, const void* P,
                   const void* Q, void* out, void* scratch, int E, int N,
                   int D, int body, void* stream) {
  if (body < 0 || body > 2 || (body == 1 && N > MAX_RB))
    return static_cast<int>(cudaErrorInvalidValue);
  if (body == 2 || (body == 0 && N > SMALL_N)) {
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return tf32mix::dispatch<PAIRS>(dtype, W, G, P, Q, out, scratch, E, N, D,
                                    stream);
  }
  return dispatch<PAIRS, false>(dtype, W, G, P, Q, nullptr, out, N, E, N, D,
                                static_cast<cudaStream_t>(stream));
}

}  // namespace smallmix
}  // namespace repro
