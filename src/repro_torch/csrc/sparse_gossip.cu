// sparse_gossip: compact active-set mixing with the gather fused in.
//
// Replaces the TPU kernel repro/kernels/sparse_gossip/kernel.py:
// sparse_gossip_pallas (body _sparse_gossip_kernel).  For an event whose A
// active workers are gidx[0..A), it computes the compact mixed rows
//
//     out[b, d] = Σ_a P_sub[a, b] · W[gidx[a], d]  −  Σ_a Q_sub[a, b] · G[a, d]
//
// reading only the A gathered rows of the (N, D) carry W.  G is the (A, D)
// active-set gradient and Q_sub = diag(η·mask)·P_sub.  The wrapper clamps
// padded (-1) lanes to row 0 and zeroes their P/Q rows and columns, so their
// output rows are exactly zero; the kernel clamps indices into [0, N) on
// load as well (the gather semantics of the reference), so it never reads
// outside W.
//
// What bounds it on an H100: 2·2·A²·D FLOP against (2·A·D + A·D) elements
// moved -- 4·A/3 FLOP per element, i.e. A/3 FLOP per float32 byte: about 5
// at A = 16, 21 at A = 64 and 85 at A = 256.  Against the card's float32
// balance point of 20 FLOP/byte, the A = 16 rung (most DSGD-AAU events at
// N = 256) is bound by memory, A = 64 sits at the balance point, and
// A = 256 by float32 arithmetic.  At the 2-NN's widths the small leaves
// (D = 256, 10) launch only a handful of blocks, and launch cost rules.
//
// Design: each block owns one 64-wide D tile and (for A <= 256) all A output
// rows.  It loads the worker indices itself -- the replacement for the TPU's
// scalar prefetch -- and walks the active lanes in slabs of 16: the slab's
// gathered W rows and G rows (16 × 64) and the slab's P_sub/Q_sub rows
// restricted to the block's output rows (16 × 16·RB) are staged in shared
// memory as float32, and each thread accumulates RB output rows × 4 columns
// in registers.  RB (1, 2, 4, 8 or 16) is the smallest that covers A; wider
// A uses more blocks along y, 256 output rows each.
#include "common.cuh"

namespace {

constexpr int BD = 64;    // D columns per block
constexpr int BA = 16;    // active lanes (reduction) per slab
constexpr int TD = 4;     // columns per thread
constexpr int COLS = BD / TD;       // 16 column groups
constexpr int ROWS = 16;            // row groups: thread (ty) owns b = ty + 16·r
constexpr int THREADS = COLS * ROWS;  // 256

template <typename T, int RB>
__global__ void __launch_bounds__(THREADS)
sparse_gossip_kernel(const T* __restrict__ W, const T* __restrict__ G,
                     const T* __restrict__ P, const T* __restrict__ Q,
                     const int* __restrict__ gidx, T* __restrict__ out,
                     int N, int A, int D) {
  constexpr int BB = ROWS * RB;  // output rows per block
  __shared__ __align__(16) float sP[BA][BB];
  __shared__ __align__(16) float sQ[BA][BB];
  __shared__ __align__(16) float sW[BA][BD];
  __shared__ __align__(16) float sG[BA][BD];
  __shared__ int sRow[BA];

  const int tid = threadIdx.x;
  const int tx = tid % COLS;
  const int ty = tid / COLS;
  const int b0 = blockIdx.y * BB;
  const long long d0 = static_cast<long long>(blockIdx.x) * BD;

  float acc[RB][TD];
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int c = 0; c < TD; ++c) acc[r][c] = 0.f;

  for (int a0 = 0; a0 < A; a0 += BA) {
    if (tid < BA) {
      const int a = a0 + tid;
      const int g = a < A ? gidx[a] : 0;
      sRow[tid] = min(max(g, 0), N - 1);
    }
    for (int e = tid; e < BA * BB; e += THREADS) {
      const int aa = e / BB, bb = e % BB;
      const int a = a0 + aa, b = b0 + bb;
      const bool ok = a < A && b < A;
      const long long at = static_cast<long long>(a) * A + b;
      sP[aa][bb] = ok ? repro::to_f32(P[at]) : 0.f;
      sQ[aa][bb] = ok ? repro::to_f32(Q[at]) : 0.f;
    }
    __syncthreads();  // sRow is read below
    for (int e = tid; e < BA * BD; e += THREADS) {
      const int aa = e / BD, dd = e % BD;
      const int a = a0 + aa;
      const long long d = d0 + dd;
      const bool ok = a < A && d < D;
      sW[aa][dd] = ok ? repro::to_f32(W[static_cast<long long>(sRow[aa]) * D + d]) : 0.f;
      sG[aa][dd] = ok ? repro::to_f32(G[static_cast<long long>(a) * D + d]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int aa = 0; aa < BA; ++aa) {
      const float4 w = *reinterpret_cast<const float4*>(&sW[aa][tx * TD]);
      const float4 g = *reinterpret_cast<const float4*>(&sG[aa][tx * TD]);
      const float wc[TD] = {w.x, w.y, w.z, w.w};
      const float gc[TD] = {g.x, g.y, g.z, g.w};
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const float p = sP[aa][ty + ROWS * r];
        const float q = sQ[aa][ty + ROWS * r];
#pragma unroll
        for (int c = 0; c < TD; ++c) {
          acc[r][c] = fmaf(p, wc[c], acc[r][c]);
          acc[r][c] = fmaf(-q, gc[c], acc[r][c]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < RB; ++r) {
    const int b = b0 + ty + ROWS * r;
    if (b >= A) continue;
#pragma unroll
    for (int c = 0; c < TD; ++c) {
      const long long d = d0 + tx * TD + c;
      if (d < D) out[static_cast<long long>(b) * D + d] = repro::from_f32<T>(acc[r][c]);
    }
  }
}

template <typename T, int RB>
void launch_rb(const void* W, const void* G, const void* P, const void* Q,
               const int* gidx, void* out, int N, int A, int D,
               cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(repro::ceil_div(D, BD)),
                  static_cast<unsigned>(repro::ceil_div(A, ROWS * RB)));
  sparse_gossip_kernel<T, RB><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(W), static_cast<const T*>(G),
      static_cast<const T*>(P), static_cast<const T*>(Q), gidx,
      static_cast<T*>(out), N, A, D);
}

template <typename T>
void launch(const void* W, const void* G, const void* P, const void* Q,
            const int* gidx, void* out, int N, int A, int D,
            cudaStream_t stream) {
  if (A <= ROWS * 1) {
    launch_rb<T, 1>(W, G, P, Q, gidx, out, N, A, D, stream);
  } else if (A <= ROWS * 2) {
    launch_rb<T, 2>(W, G, P, Q, gidx, out, N, A, D, stream);
  } else if (A <= ROWS * 4) {
    launch_rb<T, 4>(W, G, P, Q, gidx, out, N, A, D, stream);
  } else if (A <= ROWS * 8) {
    launch_rb<T, 8>(W, G, P, Q, gidx, out, N, A, D, stream);
  } else {
    launch_rb<T, 16>(W, G, P, Q, gidx, out, N, A, D, stream);
  }
}

}  // namespace

// out (A, D) = P_subᵀ·W[gidx] − Q_subᵀ·G; W (N, D), G (A, D), P/Q (A, A),
// gidx (A,) int32; every operand contiguous, float operands one dtype.
extern "C" int sparse_gossip_launch(int dtype, const void* W, const void* G,
                                    const void* P, const void* Q,
                                    const void* gidx, void* out, int N, int A,
                                    int D, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* idx = static_cast<const int*>(gidx);
  if (dtype == repro::kFloat32) {
    launch<float>(W, G, P, Q, idx, out, N, A, D, s);
  } else if (dtype == repro::kBFloat16) {
    launch<__nv_bfloat16>(W, G, P, Q, idx, out, N, A, D, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
