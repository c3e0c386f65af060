// Fused QKV rotary embedding, forward.
//
// Replaces the Pallas kernel `_rope_qkv_kernel` (dolomite_engine_tpu/ops/pallas/rope_qkv.py,
// called from `_rope_qkv_call`). Bound on the H100: device-memory bytes (the fused
// [rows, (Hq + 2 Hkv) * D] projection read once and written once, plus cos/sin). Design:
// one thread per element of the flat row, so neighbouring threads touch neighbouring
// addresses; heads below Hq + Hkv (the Q and K blocks) get x * cos + rotate_half(x) * sin,
// the V block is copied bit for bit. cos/sin arrive already cast to the element type.
#include "common.cuh"

namespace {

using namespace dolo;

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads) rope_qkv_kernel(
    const T* __restrict__ qkv, const T* __restrict__ cos, const T* __restrict__ sin,
    T* __restrict__ out, int64_t total, int row_width, int head_dim, int rope_cols) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int64_t row = idx / row_width;
  const int col = static_cast<int>(idx - row * row_width);
  if (col >= rope_cols) {
    out[idx] = qkv[idx];  // V heads pass through untouched
    return;
  }
  const int d = col % head_dim;
  const int half = head_dim >> 1;
  const float x = to_float(qkv[idx]);
  const float rotated = d < half ? -to_float(qkv[idx + half]) : to_float(qkv[idx - half]);
  const float c = to_float(cos[row * head_dim + d]);
  const float s = to_float(sin[row * head_dim + d]);
  out[idx] = from_float<T>(x * c + rotated * s);
}

template <typename T>
cudaError_t launch(const void* qkv, const void* cos, const void* sin, void* out, int rows,
                   int row_width, int head_dim, int rope_cols, cudaStream_t stream) {
  const int64_t total = static_cast<int64_t>(rows) * row_width;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  rope_qkv_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(cos), static_cast<const T*>(sin),
      static_cast<T*>(out), total, row_width, head_dim, rope_cols);
  return cudaGetLastError();
}

}  // namespace

// qkv, out: [rows, row_width] with row_width = (Hq + 2 Hkv) * head_dim; cos, sin:
// [rows, head_dim]; rope_cols = (Hq + Hkv) * head_dim. All of `dtype`.
extern "C" int dolo_rope_qkv(const void* qkv, const void* cos, const void* sin, void* out,
                             int rows, int row_width, int head_dim, int rope_cols, int dtype,
                             void* stream) {
  if (rows <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case dolo::kFloat32:
      return launch<float>(qkv, cos, sin, out, rows, row_width, head_dim, rope_cols, s);
    case dolo::kBFloat16:
      return launch<__nv_bfloat16>(qkv, cos, sin, out, rows, row_width, head_dim, rope_cols, s);
    default:
      return cudaErrorInvalidValue;
  }
}
