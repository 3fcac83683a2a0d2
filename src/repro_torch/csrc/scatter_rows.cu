// scatter_rows: write compact active-set rows into the (N, D) carry, in place.
//
// Replaces the TPU kernel repro/kernels/sparse_gossip/kernel.py:
// scatter_rows_pallas (body _scatter_rows_kernel).  For every lane a with
// 0 <= workers[a] < N it copies rows[a, :] into X[workers[a], :]; every
// other row of X is never touched.  Lanes outside [0, N) -- the -1 padding
// of the active-set batches, in any lane -- write nothing.  The TPU kernel
// had to re-write row 0's final content for pad lanes because every one of
// its grid steps writes its output window; a GPU block that writes nothing
// needs no such trick, and the result still equals the reference's
// X.at[workers].set(rows, mode="drop").  Valid indices are unique per event
// (the schedulers' active sets), so no two blocks write the same element.
//
// What bounds it on an H100: pure data movement, 2·A·D elements (read the
// compact rows, write the carry rows) and no arithmetic, so the card's
// memory rate: at A = 64, D = 65536, float32 it moves 33.5 MB, 0.010 ms at
// 3.35 TB/s.  The small calls (D ≤ 2560, A = 2 on the fused path) are
// bound by the launch instead.
//
// Design: a copy is a copy whatever the dtype, so the kernel moves bytes.
// Where a row is a whole number of 16-byte vectors and X and rows start on
// a 16-byte boundary, each thread copies 4 vectors of 16 bytes, all four
// loads issued before the first store, so 64 bytes per thread are in
// flight; a block of 256 threads then covers 16 KB of one lane, and the
// main shape's grid (64 lanes × 16 tiles) is about one wave of resident
// blocks (132 SMs × 8 blocks of 256 threads).  Elsewhere (D = 10, offset
// views) the same loop copies 4- or 2-byte elements.  Plain loads: the
// streaming hint (ld.global.cs) on the rows ran no faster from device
// memory and slower where the rows sat in L2, as the mix leaves them.  A
// block reads its lane's index once, through shared memory, and a pad
// lane's blocks exit before touching anything else.  It stays a separate
// launch after the mix, as in the reference: every gathered row is also a
// written row, and fusing the two is later work.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;                   // units in flight per thread
constexpr int TILE = THREADS * UNROLL;      // units per block

// U is the unit of the copy: uint4 (16 bytes), or one 4- or 2-byte element;
// n is the row length in units
template <typename U>
__global__ void __launch_bounds__(THREADS)
scatter_rows_kernel(U* __restrict__ X, const U* __restrict__ rows,
                    const int* __restrict__ workers, int N, long long n) {
  __shared__ int lane_row;
  const int a = blockIdx.y;
  if (threadIdx.x == 0) lane_row = workers[a];
  __syncthreads();
  const int w = lane_row;
  if (w < 0 || w >= N) return;
  U* dst = X + static_cast<long long>(w) * n;
  const U* src = rows + static_cast<long long>(a) * n;
  const long long base = static_cast<long long>(blockIdx.x) * TILE + threadIdx.x;
  U v[UNROLL];
#pragma unroll
  for (int k = 0; k < UNROLL; ++k) {
    const long long i = base + k * THREADS;
    if (i < n) v[k] = src[i];
  }
#pragma unroll
  for (int k = 0; k < UNROLL; ++k) {
    const long long i = base + k * THREADS;
    if (i < n) dst[i] = v[k];
  }
}

template <typename U>
int launch(void* X, const void* rows, const int* workers, int N, int A,
           long long n, cudaStream_t stream) {
  const long long tiles = repro::ceil_div(n, TILE);
  if (tiles > 0x7fffffffLL || A > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(A));
  scatter_rows_kernel<U><<<grid, THREADS, 0, stream>>>(
      static_cast<U*>(X), static_cast<const U*>(rows), workers, N, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// X (N, D) updated in place from rows (A, D) at workers (A,) int32.
extern "C" int scatter_rows_launch(int dtype, void* X, const void* rows,
                                   const void* workers, int N, int A, int D,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* idx = static_cast<const int*>(workers);
  const int size = dtype == repro::kFloat32 ? 4
                 : dtype == repro::kBFloat16 ? 2 : 0;
  if (size == 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long row_bytes = static_cast<long long>(D) * size;
  const bool vec = row_bytes % 16 == 0 &&
      (reinterpret_cast<uintptr_t>(X) | reinterpret_cast<uintptr_t>(rows)) % 16 == 0;
  if (vec) return launch<uint4>(X, rows, idx, N, A, row_bytes / 16, s);
  if (size == 4) return launch<unsigned int>(X, rows, idx, N, A, D, s);
  return launch<unsigned short>(X, rows, idx, N, A, D, s);
}
