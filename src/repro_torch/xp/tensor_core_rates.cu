// Peak issue rates of the tensor-core instructions the port's kernels can
// use, measured with operands that stay in registers (mma.sync) or in
// shared memory (wgmma), so that nothing but the MMA pipe is timed.  Built
// and run by tensor_core_rates.py.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int CHAINS = 16;   // independent accumulators a warp keeps busy

// mma.sync m16n8k8 TF32, or m16n8k16 bf16 (BF16 = true), CHAINS at a time
template <bool BF16>
__global__ void mma_sync_loop(float* out, int iters) {
  float acc[CHAINS][4] = {};
  const uint32_t a[4] = {threadIdx.x, 1u, 2u, 3u}, b[2] = {5u, 7u};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < CHAINS; ++j) {
      if constexpr (BF16) {
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
            : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]), "+f"(acc[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
      } else {
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
            : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]), "+f"(acc[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
      }
    }
  }
  float s = 0.f;
  for (int j = 0; j < CHAINS; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// wgmma m64n64k8 TF32, both operands K-major in shared memory (zeros),
// 4 k-steps a group
__global__ void wgmma_tf32_loop(float* out, int iters) {
  extern __shared__ __align__(1024) unsigned char sm[];
  const uint32_t raw = repro::smem_addr(sm);
  unsigned char* tile = sm + (((raw + 1023) & ~1023u) - raw);
  for (int i = threadIdx.x; i < 16384; i += blockDim.x)
    reinterpret_cast<float*>(tile)[i] = 0.f;
  repro::fence_proxy_async();
  __syncthreads();
  const uint32_t base = repro::smem_addr(tile);
  float d[32] = {};
  for (int it = 0; it < iters; ++it) {
    repro::wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
          "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
          "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
          "%30, %31}, %32, %33, p, 1, 1;\n}\n"
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
            "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
            "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
            "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
            "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
            "+f"(d[30]), "+f"(d[31])
          : "l"(repro::sw128_desc(base + 32 * k, 0)),
            "l"(repro::sw128_desc(base + 32768 + 32 * k, 0)), "r"(1));
    }
    repro::wgmma_commit();
    repro::wgmma_wait<0>();
  }
  repro::fence_acc(d);
  float s = 0.f;
  for (int j = 0; j < 32; ++j) s += d[j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

}  // namespace

// which: 0 mma.sync TF32, 1 mma.sync bf16, 2 wgmma TF32
extern "C" int tensor_core_probe(int which, float* out, int blocks,
                                 int threads, int iters, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (which == 0) mma_sync_loop<false><<<blocks, threads, 0, s>>>(out, iters);
  if (which == 1) mma_sync_loop<true><<<blocks, threads, 0, s>>>(out, iters);
  if (which == 2) {
    constexpr int bytes = 65536 + 1024;
    const cudaError_t err = cudaFuncSetAttribute(
        wgmma_tf32_loop, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    wgmma_tf32_loop<<<blocks, threads, bytes, s>>>(out, iters);
  }
  return static_cast<int>(cudaGetLastError());
}
