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
// memory rate; at the 2-NN's leaf widths and the main path's A = 16..256 it
// moves 2 KB to 128 MB per call, and the small calls are bound by launch
// cost instead.
//
// Design: one block per (lane, 1024-column tile); a pad lane's blocks exit
// after reading one index.  Neighbouring threads copy neighbouring columns,
// so reads and writes are coalesced.  It stays a separate launch after the
// mix, as in the reference: every gathered row is also a written row, and
// fusing the two is later work.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 4;
constexpr int TILE = THREADS * PER_THREAD;  // columns per block

template <typename T>
__global__ void __launch_bounds__(THREADS)
scatter_rows_kernel(T* __restrict__ X, const T* __restrict__ rows,
                    const int* __restrict__ workers, int N, int D) {
  const int a = blockIdx.y;
  const int w = workers[a];
  if (w < 0 || w >= N) return;
  const long long base = static_cast<long long>(blockIdx.x) * TILE;
  T* dst = X + static_cast<long long>(w) * D;
  const T* src = rows + static_cast<long long>(a) * D;
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const long long d = base + k * THREADS + threadIdx.x;
    if (d < D) dst[d] = src[d];
  }
}

template <typename T>
void launch(void* X, const void* rows, const int* workers, int N, int A,
            int D, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(repro::ceil_div(D, TILE)),
                  static_cast<unsigned>(A));
  scatter_rows_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<T*>(X), static_cast<const T*>(rows), workers, N, D);
}

}  // namespace

// X (N, D) updated in place from rows (A, D) at workers (A,) int32.
extern "C" int scatter_rows_launch(int dtype, void* X, const void* rows,
                                   const void* workers, int N, int A, int D,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* idx = static_cast<const int*>(workers);
  if (dtype == repro::kFloat32) {
    launch<float>(X, rows, idx, N, A, D, s);
  } else if (dtype == repro::kBFloat16) {
    launch<__nv_bfloat16>(X, rows, idx, N, A, D, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
