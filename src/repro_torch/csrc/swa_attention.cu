// swa_attention: causal sliding-window attention for prefill, with GQA.
//
// Replaces the TPU kernel repro/kernels/swa_attention/kernel.py:
// swa_attention_pallas (body _swa_kernel).  q is (B·H, T, dh) and k, v are
// (B·KV, T, dh), batch-major, so the KV head of q head bh is bh / n_groups.
// Query i attends to keys j with i − window < j ≤ i; the softmax is taken
// online over key tiles and the final normaliser is clamped at 1e-30, as in
// the TPU kernel.  Positions are 0..T−1 for every row: left-padded prompts
// attend to their padding like any other token, as the reference does.
//
// What bounds it on an H100: at the serve path's B=4, H=10, KV=1, dh=256,
// window 2048 and T=4096 the unmasked band is ~258 GFLOP against ~185 MB
// of bfloat16 q, k, v and output, so the bound is arithmetic (0.26 ms at
// the bf16 tensor-core peak).  This first kernel does its arithmetic in
// float32 on the CUDA cores (no mma / wgmma yet), so it runs far from that
// bound; PERF.md carries its time.
//
// Design: one block of 256 threads per (64-query tile, q head).  The tile
// of q (pre-scaled) and each 64-key tile of k are staged transposed in
// shared memory as float32 and v row-major, so both products read float4
// rows without bank conflicts.  The 16×16 threads split the work: thread
// (ty, tx) owns query rows 4·ty..4·ty+3, computes their scores against
// keys 4·tx..4·tx+3 of the tile, and keeps the output accumulator for the
// same rows at columns 64·g + 4·tx..+3 (g < dh/64) -- 64 float32 registers
// at dh = 256, so the 64×256 accumulator is spread over the whole block.
// A row's running max and sum live in the registers of the 16 threads of
// its row group (reduced with xor shuffles), so no shared state is updated
// between the two products.  At dh = 256 the tiles take 222 KB of dynamic
// shared memory; the launch raises the kernel's limit first and reports a
// refusal.  Only the key tiles of the band are visited, from the diagonal
// tile back to the tile of the first row's oldest key (the TPU kernel's
// n_band), and ragged T is masked here (rows past T are never stored, keys
// past T never weigh), so nothing is padded.
#include "common.cuh"

namespace {

constexpr int BQ = 64;            // query rows per block
constexpr int BK = 64;            // keys per tile
constexpr int LD = BQ + 4;        // row length of the transposed tiles (floats)
constexpr int THREADS = 256;
constexpr float kMasked = -1e30f;

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * DH * LD + BK * DH + BK * LD);
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
swa_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int Tn,
                     int n_groups, int window, float scale) {
  constexpr int NG = DH / 64;     // 64-column groups of the head
  extern __shared__ __align__(16) float smem[];
  float* sQt = smem;              // [DH][LD]  (q · scale)ᵀ of the tile
  float* sKt = sQt + DH * LD;     // [DH][LD]  kᵀ of the key tile
  float* sV = sKt + DH * LD;      // [BK][DH]  v of the key tile
  float* sPt = sV + BK * DH;      // [BK][LD]  probabilities, key-major

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = blockIdx.x * BQ;
  const long long bh = blockIdx.y;
  const long long kvh = bh / n_groups;
  const T* qb = q + bh * Tn * DH;
  const T* kb = k + kvh * Tn * DH;
  const T* vb = v + kvh * Tn * DH;

  for (int e = tid; e < BQ * DH; e += THREADS) {
    const int r = e / DH, d = e % DH;
    const int row = q0 + r;
    sQt[d * LD + r] = row < Tn
        ? repro::to_f32(qb[static_cast<long long>(row) * DH + d]) * scale : 0.f;
  }

  float acc[4][NG][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][g][c] = 0.f;
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
  }

  const int q_last = (q0 + BQ < Tn ? q0 + BQ : Tn) - 1;
  const int kt_hi = q_last / BK;                      // diagonal tile
  const int k_first = q0 - window + 1 > 0 ? q0 - window + 1 : 0;
  const int kt_lo = k_first / BK;                     // oldest key of row q0

  for (int kt = kt_hi; kt >= kt_lo; --kt) {
    const int k0 = kt * BK;
    __syncthreads();              // the q tile is in; the last tile is read
    for (int e = tid; e < BK * DH; e += THREADS) {
      const int r = e / DH, d = e % DH;
      const int key = k0 + r;
      const bool in = key < Tn;
      const long long at = static_cast<long long>(key) * DH + d;
      sKt[d * LD + r] = in ? repro::to_f32(kb[at]) : 0.f;
      sV[r * DH + d] = in ? repro::to_f32(vb[at]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(&sQt[d * LD + ty * 4]);
      const float4 ka = *reinterpret_cast<const float4*>(&sKt[d * LD + tx * 4]);
      const float qr[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kr[4] = {ka.x, ka.y, ka.z, ka.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qr[i], kr[j], s[i][j]);
    }

    // mask and online softmax; the 16 threads of a row group (one half
    // warp) hold the row's 64 keys, so xor shuffles over 8, 4, 2, 1 reduce it
    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = kMasked;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx * 4 + j;
        const bool keep = key <= row && key > row - window && key < Tn;
        s[i][j] = keep ? s[i][j] : kMasked;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      corr[i] = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = s[i][j] == kMasked ? 0.f : expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr[i] + sum;
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&sPt[(tx * 4 + j) * LD + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int g = 0; g < NG; ++g)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][g][c] *= corr[i];
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < BK; ++j) {
      const float4 pp = *reinterpret_cast<const float4*>(&sPt[j * LD + ty * 4]);
      const float pr[4] = {pp.x, pp.y, pp.z, pp.w};
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float4 vv =
            *reinterpret_cast<const float4*>(&sV[j * DH + g * 64 + tx * 4]);
        const float vc[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][g][c] = fmaf(pr[i], vc[c], acc[i][g][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Tn) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* o = out + (bh * Tn + row) * DH;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        o[g * 64 + tx * 4 + c] = repro::from_f32<T>(acc[i][g][c] / denom);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* out, int BH,
           int Tn, int n_groups, int window, float scale,
           cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      swa_attention_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(repro::ceil_div(Tn, BQ)),
                  static_cast<unsigned>(BH));
  swa_attention_kernel<T, DH><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Tn, n_groups, window,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dh(int dh, const void* q, const void* k, const void* v, void* out,
              int BH, int Tn, int n_groups, int window, float scale,
              cudaStream_t stream) {
  switch (dh) {
    case 64:
      return launch<T, 64>(q, k, v, out, BH, Tn, n_groups, window, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, BH, Tn, n_groups, window, scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, out, BH, Tn, n_groups, window, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// out (BH, T, dh) = softmax over the causal window of (q·kᵀ)·scale, times v;
// q (BH, T, dh), k and v (BH / n_groups, T, dh), contiguous, one dtype;
// dh ∈ {64, 128, 256}, 1 ≤ window ≤ T.
extern "C" int swa_attention_launch(int dtype, const void* q, const void* k,
                                    const void* v, void* out, int BH, int Tn,
                                    int dh, int n_groups, int window,
                                    float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (BH > 65535 || n_groups < 1 || window < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == repro::kFloat32)
    return launch_dh<float>(dh, q, k, v, out, BH, Tn, n_groups, window, scale, s);
  if (dtype == repro::kBFloat16)
    return launch_dh<__nv_bfloat16>(dh, q, k, v, out, BH, Tn, n_groups, window,
                                    scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
