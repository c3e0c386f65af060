// Shared helpers of the port's hand-written Hopper kernels (built for sm_90a).
//
// Every kernel takes its element type as a runtime code from the Python wrapper
// (kFloat32 or kBFloat16) and is instantiated for both. Arithmetic is in fp32; a value
// is rounded to the element type exactly where the plain PyTorch version (and the TPU
// kernel it replaces) rounds it, so fp32 results agree to ulp level and bf16 results to
// the rounding of the element type. The paged attention kernels also read KV pages of a
// page type (kInt8, kFloat8E4M3: quantized codes with a per-(page, kv head) fp32 scale).
#pragma once

#include <cfloat>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

namespace dolo {

enum DType : int { kFloat32 = 0, kBFloat16 = 1, kInt8 = 2, kFloat8E4M3 = 3 };

// finfo(float32).min: the mask constant of the reference attention (`ops/attention.py`)
constexpr float kNegInf = -FLT_MAX;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(int8_t x) { return static_cast<float>(x); }
// exact: every e4m3 value is a half, and every half a float
__device__ __forceinline__ float to_float(__nv_fp8_e4m3 x) { return static_cast<float>(x); }

// page types that hold quantized codes (decoded as code * scale of the page's kv head)
template <typename P>
struct is_quantized : std::false_type {};
template <>
struct is_quantized<int8_t> : std::true_type {};
template <>
struct is_quantized<__nv_fp8_e4m3> : std::true_type {};

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as a PyTorch cast does
}

// round x to T's precision and back: the cast the plain version makes between two ops
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int offset = 16; offset > 0; offset >>= 1) v += __shfl_xor_sync(0xffffffffu, v, offset);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int offset = 16; offset > 0; offset >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, offset));
  return v;
}

// Block-wide sum or max; every thread gets the result. blockDim.x is a multiple of 32
// and `scratch` holds 32 floats of shared memory. Safe to call back to back.
template <bool kMax>
__device__ float block_reduce(float v, float* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int num_warps = blockDim.x >> 5;
  v = kMax ? warp_max(v) : warp_sum(v);
  __syncthreads();  // the previous call's readers are done with scratch[0]
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float w = lane < num_warps ? scratch[lane] : (kMax ? kNegInf : 0.f);
    w = kMax ? warp_max(w) : warp_sum(w);
    if (lane == 0) scratch[0] = w;
  }
  __syncthreads();
  return scratch[0];
}

// Opt a kernel into more than the default 48 KB of dynamic shared memory when needed.
template <typename Kernel>
inline cudaError_t allow_shared_memory(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace dolo
