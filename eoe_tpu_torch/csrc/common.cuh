// Helpers shared by the port's CUDA sources: element conversions, warp
// reductions, the error string and the opt-in to more than 48 KB of dynamic
// shared memory. Each source includes this file once and is built into a
// library of its own (ops/_build.py), so the definitions do not collide.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>

namespace eoe {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as XLA's convert
}

// Round to the element type and back: the TPU kernels' casts of P and dS.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

constexpr int kMaxDevices = 64;

// Above 48 KB a kernel must opt in to dynamic shared memory. Raise its cap
// once per device, to what its largest shape needs (`cap`), instead of on
// every launch. `raised` is the caller's per-kernel flag array.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t need, size_t cap, std::atomic<bool>* raised) {
  if (need <= 48 * 1024) return cudaSuccess;
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!raised[device].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)cap);
    if (err != cudaSuccess) return err;
    raised[device].store(true, std::memory_order_release);
  }
  return cudaSuccess;
}

}  // namespace eoe

// The message of a cudaError_t that a launcher returned.
extern "C" const char* eoe_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
