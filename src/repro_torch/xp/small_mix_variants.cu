// Variants of the gossip products' CUDA-core body (csrc/small_mix.cuh), for
// xp/small_mix_variants.py: any accumulator template RB, chunk width CH
// (4 columns, or 8 for bfloat16) and grid (one tile a block, or a capped
// grid whose blocks stride over the tiles, the ring of copies running on
// from one tile's lanes into the next's), one or two operand pairs, in a
// kernel of this file's own; and the body the port runs, from the header,
// beside them.
#include <type_traits>

#include "small_mix.cuh"

namespace {

namespace sm = repro::smallmix;
using repro::ceil_div;
using repro::from_f32;
using repro::to_f32;

// out[e] (A, D) = P[e]ᵀ·W[e] (− Q[e]ᵀ·G[e]) for A ≤ RB over `tiles` tiles
// of THREADS·CH columns, tile blockIdx.x + k·gridDim.x; the header's body
// otherwise (its ring, its sum order, its element-wise path)
template <typename T, int RB, int CH, int PAIRS, bool VEC>
__global__ void __launch_bounds__(sm::THREADS)
strided_kernel(const T* __restrict__ W, const T* __restrict__ G,
               const T* __restrict__ P, const T* __restrict__ Q,
               T* __restrict__ out, int A, int D, int tiles) {
  constexpr int THREADS = sm::THREADS, RING = sm::RING;
  using C = repro::tf32mix::Vec<T, CH>;
  __shared__ __align__(16) float sP[RB * RB];
  __shared__ __align__(16) float sQ[PAIRS == 2 ? RB * RB : 1];
  __shared__ __align__(16) unsigned char ring[(VEC ? RING : 1) * PAIRS *
                                              THREADS * sizeof(C)];
  auto chunk = [&](int slot, int half) {
    return reinterpret_cast<C*>(ring) + (slot * PAIRS + half) * THREADS +
           threadIdx.x;
  };

  const long long e = blockIdx.y;
  const long long nd = static_cast<long long>(A) * D;
  W += e * nd;
  if constexpr (PAIRS == 2) G += e * nd;
  out += e * nd;
  P += e * A * A;
  if constexpr (PAIRS == 2) Q += e * A * A;

  const int tid = threadIdx.x;
  for (int i = tid; i < RB * RB; i += THREADS) {
    const int a = i / RB, b = i % RB;
    const bool ok = a < A && b < A;
    sP[i] = ok ? to_f32(P[a * A + b]) : 0.f;
    if constexpr (PAIRS == 2) sQ[i] = ok ? to_f32(Q[a * A + b]) : 0.f;
  }
  __syncthreads();

  auto col = [&](int t) {
    return (static_cast<long long>(t) * THREADS + tid) * CH;
  };
  float acc[RB][CH];
  auto clear = [&]() {
#pragma unroll
    for (int b = 0; b < RB; ++b)
#pragma unroll
      for (int c = 0; c < CH; ++c) acc[b][c] = 0.f;
  };
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
  auto store = [&](int t) {
    const long long d = col(t);
    if (d >= D) return;
#pragma unroll
    for (int b = 0; b < RB; ++b) {
      if (b >= A) break;
      T* o = out + static_cast<long long>(b) * D + d;
      if constexpr (VEC) {
        C v;
#pragma unroll
        for (int c = 0; c < CH; ++c) v.v[c] = from_f32<T>(acc[b][c]);
        *reinterpret_cast<C*>(o) = v;
      } else {
#pragma unroll
        for (int c = 0; c < CH; ++c)
          if (d + c < D) o[c] = from_f32<T>(acc[b][c]);
      }
    }
  };

  clear();
  if constexpr (VEC) {
    constexpr int BYTES = CH * sizeof(T);
    // the copies run RING steps ahead of the reads: (nt, na) is the tile
    // and lane of the next copy, past the thread's last tile none
    int nt = blockIdx.x, na = 0;
    auto issue = [&](int slot) {
      if (nt < tiles) {
        const long long d = col(nt);
        const bool ok = d < D;
        const T* w = ok ? W + static_cast<long long>(na) * D + d : W;
        sm::copy_async<BYTES>(chunk(slot, 0), w, ok ? BYTES : 0);
        if constexpr (PAIRS == 2) {
          const T* g = ok ? G + static_cast<long long>(na) * D + d : G;
          sm::copy_async<BYTES>(chunk(slot, 1), g, ok ? BYTES : 0);
        }
        if (++na == A) {
          na = 0;
          nt += gridDim.x;
        }
      }
      sm::commit_copies();
    };
#pragma unroll
    for (int s = 0; s < RING; ++s) issue(s);
    int slot = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      for (int a = 0; a < A; ++a) {
        sm::wait_copies<RING - 1>();
        float w[CH], g[CH];
        const C cw = *chunk(slot, 0);
#pragma unroll
        for (int c = 0; c < CH; ++c) w[c] = to_f32(cw.v[c]);
        if constexpr (PAIRS == 2) {
          const C cg = *chunk(slot, 1);
#pragma unroll
          for (int c = 0; c < CH; ++c) g[c] = to_f32(cg.v[c]);
        }
        fma_lane(a, w, g);
        issue(slot);
        slot = (slot + 1) & (RING - 1);
      }
      store(t);
      clear();
    }
  } else {
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const long long d = col(t);
      for (int a = 0; a < A; ++a) {
        const T* wr = W + static_cast<long long>(a) * D;
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
      store(t);
      clear();
    }
  }
}

// blocks caps the grid's x (0: one tile a block)
template <typename T, int RB, int CH, int PAIRS>
int run_strided(const T* W, const T* G, const T* P, const T* Q, T* out,
                int E, int A, int D, int blocks, cudaStream_t stream) {
  const long long tiles = ceil_div(D, static_cast<long long>(sm::THREADS) * CH);
  if (tiles > INT_MAX || E > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const bool vec = D % CH == 0 &&
      (reinterpret_cast<uintptr_t>(W) | reinterpret_cast<uintptr_t>(G) |
       reinterpret_cast<uintptr_t>(out)) % (CH * sizeof(T)) == 0;
  const long long bx = blocks > 0 && blocks < tiles ? blocks : tiles;
  const dim3 grid(static_cast<unsigned>(bx), static_cast<unsigned>(E));
  const int t = static_cast<int>(tiles);
  if (vec)
    strided_kernel<T, RB, CH, PAIRS, true><<<grid, sm::THREADS, 0, stream>>>(
        W, G, P, Q, out, A, D, t);
  else
    strided_kernel<T, RB, CH, PAIRS, false><<<grid, sm::THREADS, 0, stream>>>(
        W, G, P, Q, out, A, D, t);
  return static_cast<int>(cudaGetLastError());
}

// registers, local (spilled) bytes and resident blocks an SM of a kernel
int attrs_of(const void* k, int* res) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, k);
  if (err != cudaSuccess) return static_cast<int>(err);
  res[0] = a.numRegs;
  res[1] = static_cast<int>(a.localSizeBytes);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      res + 2, k, sm::THREADS, 0));
}

// calls fn.template operator()<T, RB, CH, PAIRS>() for the runtime choice
template <typename F>
int pick(int dtype, int pairs, int rb, int ch, F&& fn) {
  auto by_rb = [&](auto t, auto c, auto p) {
    using T = decltype(t);
    constexpr int CH = decltype(c)::value, PAIRS = decltype(p)::value;
    switch (rb) {
      case 2: return fn.template operator()<T, 2, CH, PAIRS>();
      case 4: return fn.template operator()<T, 4, CH, PAIRS>();
      case 8: return fn.template operator()<T, 8, CH, PAIRS>();
      case 16: return fn.template operator()<T, 16, CH, PAIRS>();
      case 32: return fn.template operator()<T, 32, CH, PAIRS>();
    }
    return static_cast<int>(cudaErrorInvalidValue);
  };
  auto by_pairs = [&](auto t, auto c) {
    if (pairs == 1) return by_rb(t, c, std::integral_constant<int, 1>{});
    if (pairs == 2) return by_rb(t, c, std::integral_constant<int, 2>{});
    return static_cast<int>(cudaErrorInvalidValue);
  };
  if (dtype == repro::kFloat32 && ch == 4)
    return by_pairs(float{}, std::integral_constant<int, 4>{});
  if (dtype == repro::kBFloat16 && ch == 4)
    return by_pairs(__nv_bfloat16{}, std::integral_constant<int, 4>{});
  if (dtype == repro::kBFloat16 && ch == 8)
    return by_pairs(__nv_bfloat16{}, std::integral_constant<int, 8>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

// the launch and the attributes of the variant pick() chooses (a local
// class may hold no member template, so both live here).  blocks < 0: the
// header's body (CH = 4 only)
struct Run {
  const void *W, *G, *P, *Q;
  void* out;
  int E, A, D, blocks;
  cudaStream_t s;
  template <typename T, int RB, int CH, int PAIRS>
  int operator()() const {
    const void* g = PAIRS == 2 ? G : nullptr;
    const void* q = PAIRS == 2 ? Q : nullptr;
    if (blocks < 0) {
      if constexpr (CH != sm::CH) return static_cast<int>(cudaErrorInvalidValue);
      else return sm::launch_at<T, RB, PAIRS, false>(W, g, P, q, nullptr, out,
                                                      A, E, A, D, s);
    }
    return run_strided<T, RB, CH, PAIRS>(
        static_cast<const T*>(W), static_cast<const T*>(g),
        static_cast<const T*>(P), static_cast<const T*>(q),
        static_cast<T*>(out), E, A, D, blocks, s);
  }
};

struct Attrs {
  int* res;
  bool header;
  template <typename T, int RB, int CH, int PAIRS>
  int operator()() const {
    if (header) {
      if constexpr (CH != sm::CH) return static_cast<int>(cudaErrorInvalidValue);
      else return attrs_of(reinterpret_cast<const void*>(
                               sm::small_kernel<T, RB, PAIRS, false, true>),
                           res);
    }
    return attrs_of(reinterpret_cast<const void*>(
                        strided_kernel<T, RB, CH, PAIRS, true>),
                    res);
  }
};

}  // namespace

// out[e] = P[e]ᵀ·W[e] (− Q[e]ᵀ·G[e] for pairs = 2), W, G, out (E, A, D),
// P, Q (E, A, A), A ≤ rb; blocks caps the grid of this file's kernel (0:
// one tile a block), or -1 runs the header's body (ch = 4)
extern "C" int small_mix_variant(int dtype, int pairs, int rb, int ch,
                                 const void* W, const void* G, const void* P,
                                 const void* Q, void* out, int E, int A, int D,
                                 int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return pick(dtype, pairs, rb, ch, Run{W, G, P, Q, out, E, A, D, blocks, s});
}

// res[0..3) = registers a thread, spilled bytes a thread, resident blocks
// an SM of the aligned (VEC) kernel: the header's body (header != 0, ch =
// 4) or this file's
extern "C" int small_mix_attrs(int dtype, int pairs, int rb, int ch,
                               int header, int* res) {
  return pick(dtype, pairs, rb, ch, Attrs{res, header != 0});
}
