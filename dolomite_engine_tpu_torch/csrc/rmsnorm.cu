// Fused RMSNorm (+ residual add), forward.
//
// Replaces the Pallas kernels `_rmsnorm_kernel` / `_rmsnorm_residual_kernel`
// (dolomite_engine_tpu/ops/pallas/rmsnorm.py, called from `_rmsnorm_fwd_call`).
// Bound on the H100: device-memory bytes (x, residual, weight in; normed, stream out),
// a few operations per byte. Design: one block per row; the row's values (after the add)
// stay in shared memory between the sum of squares and the scaling, so every input byte
// is read once and every output byte written once. fp32 statistics via warp shuffles.
//
// Numerics mirror `ops/normalization.rmsnorm`: s = x + r in the element type,
// normed = cast(s32 * rsqrt(mean(s32^2) + eps)), out = normed * cast(weight) in the
// element type.
#include "common.cuh"

namespace {

using namespace dolo;

constexpr int kThreads = 256;

template <typename T, bool kResidual>
__global__ void __launch_bounds__(kThreads) rmsnorm_kernel(
    const T* __restrict__ x, const T* __restrict__ residual, const float* __restrict__ weight,
    T* __restrict__ out, T* __restrict__ stream_out, int dim, float eps) {
  extern __shared__ float smem[];
  float* values = smem;         // [dim]
  float* scratch = smem + dim;  // [32]
  const int64_t base = static_cast<int64_t>(blockIdx.x) * dim;

  float sum_sq = 0.f;
  for (int c = threadIdx.x; c < dim; c += blockDim.x) {
    float v;
    if (kResidual) {
      const T s = from_float<T>(to_float(x[base + c]) + to_float(residual[base + c]));
      stream_out[base + c] = s;
      v = to_float(s);
    } else {
      v = to_float(x[base + c]);
    }
    values[c] = v;
    sum_sq += v * v;
  }
  const float total = block_reduce<false>(sum_sq, scratch);
  const float inv = rsqrtf(total / static_cast<float>(dim) + eps);
  for (int c = threadIdx.x; c < dim; c += blockDim.x) {
    const float normed = round_to<T>(values[c] * inv);
    out[base + c] = from_float<T>(normed * round_to<T>(weight[c]));
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* residual, const void* weight, void* out,
                   void* stream_out, int rows, int dim, float eps, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(dim + 32) * sizeof(float);
  if (residual != nullptr) {
    auto kernel = rmsnorm_kernel<T, true>;
    cudaError_t err = allow_shared_memory(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<rows, kThreads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(residual),
        static_cast<const float*>(weight), static_cast<T*>(out), static_cast<T*>(stream_out), dim,
        eps);
  } else {
    auto kernel = rmsnorm_kernel<T, false>;
    cudaError_t err = allow_shared_memory(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<rows, kThreads, smem, stream>>>(static_cast<const T*>(x), nullptr,
                                             static_cast<const float*>(weight),
                                             static_cast<T*>(out), nullptr, dim, eps);
  }
  return cudaGetLastError();
}

}  // namespace

// x, residual (may be null), out, stream_out: [rows, dim] of `dtype`; weight: [dim] fp32.
extern "C" int dolo_rmsnorm(const void* x, const void* residual, const void* weight, void* out,
                            void* stream_out, int rows, int dim, float eps, int dtype,
                            void* stream) {
  if (rows <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case dolo::kFloat32:
      return launch<float>(x, residual, weight, out, stream_out, rows, dim, eps, s);
    case dolo::kBFloat16:
      return launch<__nv_bfloat16>(x, residual, weight, out, stream_out, rows, dim, eps, s);
    default:
      return cudaErrorInvalidValue;
  }
}
