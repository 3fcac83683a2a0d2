// gossip_mix: the plain consensus mix  out = Pᵀ·W, single and batched.
//
// Replaces the TPU kernels repro/kernels/gossip_mix/kernel.py:
// gossip_mix_pallas (body _gossip_kernel) and gossip_mix_batched_pallas
// (body _gossip_batched_kernel).  W is an (N, D) worker-stacked leaf and P
// the (N, N) consensus matrix; out[j, d] = Σ_i P[i, j]·W[i, d], summed in
// float32 and rounded once to W's dtype.  The batched entry point takes E
// such problems stacked as W (E, N, D), P (E, N, N); the single one is its
// E = 1 case.
//
// What bounds it on an H100 (float32; TF32 tensor cores stay off, the port
// holds float32 parity with the reference):
// - gossip_mix at N = 256, D = 65536: 2·N²·D = 8.6 GFLOP / 67 TFLOP/s =
//   0.128 ms, against 2·N·D·4 B = 134 MB / 3.35 TB/s = 0.040 ms -- bound
//   by operations (64 FLOP per byte against the card's balance of 20).
// - gossip_mix_batched at E = 32, N = 64, D = 65536: 2·E·N·D·4 B = 1.07 GB
//   / 3.35 TB/s = 0.32 ms, against 2·E·N²·D = 17.2 GFLOP / 67 TFLOP/s =
//   0.256 ms -- bound by bytes (16 FLOP per byte).
//
// Design: the plain tiled float32 product of masked_gossip.cu with one
// operand pair.  Each block owns a 64 (j) × 64 (d) output patch of one
// problem (blockIdx.z = e, with the per-problem strides N·N and N·D) and
// walks the reduction axis i in 16-row slabs: the slab's P columns and W
// rows (16 × 64 each) are staged in shared memory as float32, then every
// thread accumulates a 4 × 4 register micro-tile, one FMA per output per
// i, with float4 shared-memory reads.  Ragged N and D are masked here
// (zero-filled on load, skipped on store), so the wrapper pads nothing: the
// TPU wrapper's identity rows for N and its 512-wide D tiles are gone.
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
gossip_mix_kernel(const T* __restrict__ W, const T* __restrict__ P,
                  T* __restrict__ out, int N, int D) {
  __shared__ __align__(16) float sP[BI][BJ];
  __shared__ __align__(16) float sW[BI][BD];

  const long long e = blockIdx.z;
  const long long nd = static_cast<long long>(N) * D;
  W += e * nd;
  out += e * nd;
  P += e * static_cast<long long>(N) * N;

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
    for (int k = tid; k < BI * BJ; k += THREADS) {
      const int ii = k / BJ, jj = k % BJ;
      const int i = i0 + ii, j = j0 + jj;
      sP[ii][jj] = (i < N && j < N)
          ? repro::to_f32(P[static_cast<long long>(i) * N + j]) : 0.f;
    }
    for (int k = tid; k < BI * BD; k += THREADS) {
      const int ii = k / BD, dd = k % BD;
      const int i = i0 + ii;
      const long long d = d0 + dd;
      sW[ii][dd] = (i < N && d < D)
          ? repro::to_f32(W[static_cast<long long>(i) * D + d]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int ii = 0; ii < BI; ++ii) {
      const float4 p = *reinterpret_cast<const float4*>(&sP[ii][ty * TJ]);
      const float4 w = *reinterpret_cast<const float4*>(&sW[ii][tx * TD]);
      const float pr[TJ] = {p.x, p.y, p.z, p.w};
      const float wc[TD] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int r = 0; r < TJ; ++r)
#pragma unroll
        for (int c = 0; c < TD; ++c) acc[r][c] = fmaf(pr[r], wc[c], acc[r][c]);
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
void launch(const void* W, const void* P, void* out, int E, int N, int D,
            cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(repro::ceil_div(D, BD)),
                  static_cast<unsigned>(repro::ceil_div(N, BJ)),
                  static_cast<unsigned>(E));
  gossip_mix_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(W), static_cast<const T*>(P),
      static_cast<T*>(out), N, D);
}

int dispatch(int dtype, const void* W, const void* P, void* out, int E,
             int N, int D, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (dtype == repro::kFloat32) {
    launch<float>(W, P, out, E, N, D, s);
  } else if (dtype == repro::kBFloat16) {
    launch<__nv_bfloat16>(W, P, out, E, N, D, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out (N, D) = Pᵀ·W; every operand contiguous, one dtype.
extern "C" int gossip_mix_launch(int dtype, const void* W, const void* P,
                                 void* out, int N, int D, void* stream) {
  return dispatch(dtype, W, P, out, 1, N, D, stream);
}

// out[e] (N, D) = P[e]ᵀ·W[e] for e < E; W, out (E, N, D), P (E, N, N).
extern "C" int gossip_mix_batched_launch(int dtype, const void* W,
                                         const void* P, void* out, int E,
                                         int N, int D, void* stream) {
  return dispatch(dtype, W, P, out, E, N, D, stream);
}
