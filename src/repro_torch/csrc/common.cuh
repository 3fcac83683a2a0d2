// Shared helpers of the port's CUDA kernels.
//
// Every kernel takes float32 or bfloat16 operands, converts them to float32
// on load, accumulates in float32 and rounds once on store (round to
// nearest even, as torch's .to(torch.bfloat16) does).  Each library exports
// plain C launch functions that return the CUDA status of the launch
// (cudaGetLastError right after it), plus repro_cuda_error_string to name
// a status.  Launches go to the stream the caller passes (PyTorch's current
// stream); nothing here synchronises or allocates.
#pragma once

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

__host__ __device__ constexpr long long ceil_div(long long a, long long b) {
  return (a + b - 1) / b;
}

}  // namespace repro

extern "C" const char* repro_cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
