// Shared helpers of the port's CUDA kernels.
//
// Every kernel takes float32 or bfloat16 operands, multiplies them in
// float32 on the CUDA cores or on the tensor cores (bf16 or TF32 inputs),
// accumulates in float32 and rounds once on store (round to nearest even,
// as torch's .to(torch.bfloat16) does).  Each library exports
// plain C launch functions that return the CUDA status of the launch
// (cudaGetLastError right after it), plus repro_cuda_error_string to name
// a status.  Launches go to the stream the caller passes (PyTorch's current
// stream); nothing here synchronises or allocates.
#pragma once

#include <atomic>
#include <cstdint>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace repro {

// dtype codes shared with the Python wrappers
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x and y as two bf16 pairs, hi = bf16(x, y) and lo = bf16(x − hi, y − hi)
// (x in the low half, as a tensor-core fragment holds a pair): hi + lo
// keeps 16 of float32's 24 bits, so a product taken over hi and lo into
// one float32 sum is float32-accurate where bf16(x) alone is not
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__host__ __device__ constexpr long long ceil_div(long long a, long long b) {
  return (a + b - 1) / b;
}

// -- asynchronous copies into shared memory (cp.async, sm_80 and later) --

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src to the shared address dst, of which the first `bytes`
// (16 or 0) are read and the rest zero-filled
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// -- Hopper warpgroup MMA (wgmma, sm_90a) --------------------------------

// Shared-memory descriptor of a wgmma operand stored with the 128-byte
// swizzle: rows of 128 bytes whose 16-byte chunks are XOR-ed with row % 8,
// groups of 8 rows 1 KB apart, every group 1 KB aligned.  Fields: start
// address, leading and stride byte offsets (16-byte units), swizzle mode 1.
// The stride offset (1 KB) steps from one group of 8 rows to the next: rows
// of a K-major operand, K of an MN-major one.  The leading offset is not
// read when a K-major k-step lies inside one 128-byte row or an MN-major
// operand is one 128-byte row wide, the only uses here.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// make this thread's shared-memory writes visible to wgmma (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// wgmma writes its accumulator asynchronously: tie every register to a
// point after the wait, so that no read of it is scheduled before
template <int K>
__device__ __forceinline__ void fence_acc(float (&d)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// -- host: a kernel's dynamic shared-memory limit, set once per device --

constexpr int kMaxDevices = 64;

// cudaFuncSetAttribute costs host time; the limit it sets holds for the
// process, so a launch site keeps one flag per device (a static of its
// template instance, zero-initialised) and makes the call only the first
// time it launches on that device.
inline cudaError_t smem_limit_once(std::atomic<bool> (&done)[kMaxDevices],
                                   const void* kernel, int bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool flagged = dev >= 0 && dev < kMaxDevices;
  if (flagged && done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && flagged)
    done[dev].store(true, std::memory_order_release);
  return err;
}

}  // namespace repro

extern "C" const char* repro_cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
