// masked_gossip: the dense DSGD event update  out = Pᵀ·W − Qᵀ·G.
//
// Replaces the TPU kernel repro/kernels/gossip_mix/kernel.py:
// masked_gossip_pallas (body _masked_gossip_kernel).  W, G are (N, D)
// worker-stacked leaves, P the (N, N) consensus matrix and Q = diag(η·mask)·P
// (folded by the wrapper), so out = Pᵀ·(W − η·mask⊙G) in one pass without
// the masked-gradient intermediate.  out[j, d] = Σ_i P[i,j]·W[i,d] − Q[i,j]·G[i,d].
//
// What bounds it on an H100: at the main path's N = 256 and the 2-NN's
// largest leaf D = 65536 it does 2·2·N²·D = 17.2 GFLOP against 3·N·D·4 B =
// 201 MB in float32 -- 86 FLOP per byte, far above the card's float32
// balance point (67 TFLOP/s over 3.35 TB/s = 20), so it is bound by float32
// arithmetic on the CUDA cores (TF32 tensor cores are off: the port holds
// float32 parity with the reference).
//
// Design: a plain tiled product.  Each block owns a 64 (j) × 64 (d) output
// patch and walks the reduction axis i in 16-row slabs: the slab's P and Q
// columns (16 × 64) and W and G rows (16 × 64) are staged in shared memory
// as float32, then every thread accumulates a 4 × 4 register micro-tile
// with two FMAs per output per i.  Float4 shared-memory reads keep the
// inner loop at one load per four FMAs.  Ragged edges in N and D are masked
// here (zero-filled on load, skipped on store), so the wrapper pads
// nothing.  The TPU kernel's 8-row N padding with identity rows and its
// 512-wide D tiles are gone.
#include "common.cuh"

namespace {

constexpr int BJ = 64;  // output rows (receiving workers j) per block
constexpr int BD = 64;  // output columns (parameter index d) per block
constexpr int BI = 16;  // reduction rows (sending workers i) per slab
constexpr int TJ = 4;   // micro-tile rows per thread
constexpr int TD = 4;   // micro-tile columns per thread
constexpr int THREADS = (BJ / TJ) * (BD / TD);  // 256

template <typename T>
__global__ void __launch_bounds__(THREADS)
masked_gossip_kernel(const T* __restrict__ W, const T* __restrict__ G,
                     const T* __restrict__ P, const T* __restrict__ Q,
                     T* __restrict__ out, int N, int D) {
  __shared__ __align__(16) float sP[BI][BJ];
  __shared__ __align__(16) float sQ[BI][BJ];
  __shared__ __align__(16) float sW[BI][BD];
  __shared__ __align__(16) float sG[BI][BD];

  const int tid = threadIdx.x;
  const int tx = tid % (BD / TD);  // column group: d = d0 + 4·tx + c
  const int ty = tid / (BD / TD);  // row group:    j = j0 + 4·ty + r
  const int j0 = blockIdx.y * BJ;
  const long long d0 = static_cast<long long>(blockIdx.x) * BD;

  float acc[TJ][TD];
#pragma unroll
  for (int r = 0; r < TJ; ++r)
#pragma unroll
    for (int c = 0; c < TD; ++c) acc[r][c] = 0.f;

  for (int i0 = 0; i0 < N; i0 += BI) {
    for (int e = tid; e < BI * BJ; e += THREADS) {
      const int ii = e / BJ, jj = e % BJ;
      const int i = i0 + ii, j = j0 + jj;
      const bool ok = i < N && j < N;
      const long long at = static_cast<long long>(i) * N + j;
      sP[ii][jj] = ok ? repro::to_f32(P[at]) : 0.f;
      sQ[ii][jj] = ok ? repro::to_f32(Q[at]) : 0.f;
    }
    for (int e = tid; e < BI * BD; e += THREADS) {
      const int ii = e / BD, dd = e % BD;
      const int i = i0 + ii;
      const long long d = d0 + dd;
      const bool ok = i < N && d < D;
      const long long at = static_cast<long long>(i) * D + d;
      sW[ii][dd] = ok ? repro::to_f32(W[at]) : 0.f;
      sG[ii][dd] = ok ? repro::to_f32(G[at]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int ii = 0; ii < BI; ++ii) {
      const float4 p = *reinterpret_cast<const float4*>(&sP[ii][ty * TJ]);
      const float4 q = *reinterpret_cast<const float4*>(&sQ[ii][ty * TJ]);
      const float4 w = *reinterpret_cast<const float4*>(&sW[ii][tx * TD]);
      const float4 g = *reinterpret_cast<const float4*>(&sG[ii][tx * TD]);
      const float pr[TJ] = {p.x, p.y, p.z, p.w};
      const float qr[TJ] = {q.x, q.y, q.z, q.w};
      const float wc[TD] = {w.x, w.y, w.z, w.w};
      const float gc[TD] = {g.x, g.y, g.z, g.w};
#pragma unroll
      for (int r = 0; r < TJ; ++r)
#pragma unroll
        for (int c = 0; c < TD; ++c) {
          acc[r][c] = fmaf(pr[r], wc[c], acc[r][c]);
          acc[r][c] = fmaf(-qr[r], gc[c], acc[r][c]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < TJ; ++r) {
    const int j = j0 + ty * TJ + r;
    if (j >= N) continue;
#pragma unroll
    for (int c = 0; c < TD; ++c) {
      const long long d = d0 + tx * TD + c;
      if (d < D) out[static_cast<long long>(j) * D + d] = repro::from_f32<T>(acc[r][c]);
    }
  }
}

template <typename T>
void launch(const void* W, const void* G, const void* P, const void* Q,
            void* out, int N, int D, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(repro::ceil_div(D, BD)),
                  static_cast<unsigned>(repro::ceil_div(N, BJ)));
  masked_gossip_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(W), static_cast<const T*>(G),
      static_cast<const T*>(P), static_cast<const T*>(Q),
      static_cast<T*>(out), N, D);
}

}  // namespace

// out (N, D) = Pᵀ·W − Qᵀ·G; every operand contiguous, one dtype.
extern "C" int masked_gossip_launch(int dtype, const void* W, const void* G,
                                    const void* P, const void* Q, void* out,
                                    int N, int D, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32) {
    launch<float>(W, G, P, Q, out, N, D, s);
  } else if (dtype == repro::kBFloat16) {
    launch<__nv_bfloat16>(W, G, P, Q, out, N, D, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
