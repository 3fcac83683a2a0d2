// linear_scan: the diagonal linear recurrence  h_t = a_t ⊙ h_{t-1} + x_t,
// h_0 = 0, over axis 1 of (B, T, W) operands (RecurrentGemma's RG-LRU).
//
// Replaces the TPU kernel repro/kernels/linear_scan/kernel.py:
// linear_scan_pallas (body _scan_kernel).  There the grid walks T tiles in
// order on one core and carries the (1, Dt) state in VMEM scratch from one
// tile to the next.  GPU blocks run in no order, so the carry across T has
// to live inside a block.
//
// What bounds it on an H100: it is an elementwise recurrence -- one FMA per
// element against 12 bytes moved in float32 (read a and x, write h) -- so it
// is bound by memory bytes.  At the serve path's B=4, T=4096, W=2560 that is
// 3 · 168 MB = 503 MB, 0.15 ms at 3.35 TB/s.  The hazard is parallelism,
// not arithmetic: one thread per (b, channel) is only B·W = 10,240 threads
// (about 78 an SM), each with 4096 dependent steps, too few loads in
// flight to stream from HBM.
//
// Design: a two-pass chunked scan inside each block.  A block owns 32
// consecutive channels of one batch row (one warp wide, so every load of a
// time step is one 128-byte row segment) and cuts T into 16 chunks, one
// warp each (512 threads).  Pass 1: each thread scans its chunk from 0 and
// keeps the chunk's summary (∏ a, local h) in shared memory.  Each thread
// then folds the summaries of the chunks before its own into its carry-in
// (at most 15 steps).  Pass 2: it scans its chunk again from that carry and
// writes h.  The chunk re-read makes it 5 passes over 168 MB instead of 3,
// in exchange for 16× the threads in flight.  This is the blocking the
// reference's rglru_scan uses (a scan per chunk, then the boundary carry).
// Ragged T and W are masked here (empty chunks are the identity, channels
// past W idle), so nothing is padded with a = 1, x = 0 as the TPU wrapper
// does.  Arithmetic is float32 whatever the operand dtype.
#include "common.cuh"

namespace {

constexpr int CH = 32;              // channels per block (one warp)
constexpr int NC = 16;              // T chunks per block (one warp each)
constexpr int THREADS = CH * NC;    // 512

template <typename T>
__global__ void __launch_bounds__(THREADS)
linear_scan_kernel(const T* __restrict__ a, const T* __restrict__ x,
                   T* __restrict__ out, int Tn, int W) {
  __shared__ float sA[NC][CH];   // ∏ a over each chunk
  __shared__ float sH[NC][CH];   // each chunk's scan from h = 0

  const int lane = threadIdx.x % CH;
  const int c = threadIdx.x / CH;
  const int w = blockIdx.x * CH + lane;
  const bool ok = w < W;
  const long long L = repro::ceil_div(Tn, NC);
  const long long t0 = c * L;
  const long long t1 = t0 + L < Tn ? t0 + L : Tn;
  const long long base = static_cast<long long>(blockIdx.y) * Tn * W + w;

  float A = 1.f, H = 0.f;
  if (ok) {
#pragma unroll 8
    for (long long t = t0; t < t1; ++t) {
      const float at = repro::to_f32(a[base + t * W]);
      H = fmaf(at, H, repro::to_f32(x[base + t * W]));
      A *= at;
    }
  }
  sA[c][lane] = A;
  sH[c][lane] = H;
  __syncthreads();

  float h = 0.f;
  for (int j = 0; j < c; ++j) h = fmaf(sA[j][lane], h, sH[j][lane]);
  if (!ok) return;
#pragma unroll 8
  for (long long t = t0; t < t1; ++t) {
    h = fmaf(repro::to_f32(a[base + t * W]), h, repro::to_f32(x[base + t * W]));
    out[base + t * W] = repro::from_f32<T>(h);
  }
}

template <typename T>
void launch(const void* a, const void* x, void* out, int B, int Tn, int W,
            cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(repro::ceil_div(W, CH)),
                  static_cast<unsigned>(B));
  linear_scan_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(x),
      static_cast<T*>(out), Tn, W);
}

}  // namespace

// out (B, T, W): h_t = a_t·h_{t-1} + x_t, h_0 = 0; every operand
// contiguous, one dtype.
extern "C" int linear_scan_launch(int dtype, const void* a, const void* x,
                                  void* out, int B, int Tn, int W,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (dtype == repro::kFloat32) {
    launch<float>(a, x, out, B, Tn, W, s);
  } else if (dtype == repro::kBFloat16) {
    launch<__nv_bfloat16>(a, x, out, B, Tn, W, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
