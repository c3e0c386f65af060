// Per-(page, kv head) absmax quantization of KV pages to int8 or fp8 e4m3 codes.
//
// Replaces the Pallas kernel `_quantize_kernel` (dolomite_engine_tpu/ops/pallas/kv_quant.py,
// `quantize_pages_pallas`). Input: fp32 pages [N, page_size, H, D] and valid [N, page_size]
// (the rows that hold real K/V); output: codes [N, page_size, H, D] and scales [N, H] fp32.
//
// The contract is byte identity with the plain version (`ops/kv_quant.quantize_pages_plain`,
// the JAX package's `quantize_pages_xla`): the pool's state must not depend on which of the
// two wrote it. The rounding traps on the way:
// - the scale is amax * inv_qmax, a reciprocal-multiply whose constant is float32(1.0 / qmax),
//   the double quotient rounded once, as the host passes it; neither 1.0f / 127.0f nor
//   amax / qmax, which may round differently;
// - the page is divided by the scale with a true IEEE division, x / s rounded to nearest
//   (__fdiv_rn, which no compiler flag turns into a reciprocal; the build has no
//   --use_fast_math either), and the scale's product is __fmul_rn, never contracted;
// - int8 rounds half to even (rintf), as jnp.round and torch.round do; never roundf,
//   which rounds halves away from zero;
// - the quotient is clipped to +-qmax before the cast: fp8 e4m3fn has no inf, and the cast
//   (__nv_fp8_e4m3, __NV_SATFINITE) rounds to nearest even, as the reference's does;
// - the absmax covers valid rows only (stale rows past a page's frontier are encoded but
//   never set the scale), and a page whose amax is 0 gets the scale 1.0.
// Inputs are finite (a NaN would clip differently here and in the reference).
//
// Bound on the H100: bytes (the fp32 window in, the codes out; a few operations per
// element). Design: one block per (page, kv head); its threads take the page's
// page_size x D values of that head, a block max-reduce gives the absmax (exact in any
// order), then one pass writes the codes. The second pass reads the values again from
// L1 / L2, not from device memory.
#include "common.cuh"

namespace {

using namespace dolo;

constexpr int kThreads = 128;

__device__ __forceinline__ void encode(float q, float qmax, int8_t* out) {
  const float r = fminf(fmaxf(rintf(q), -qmax), qmax);
  *out = static_cast<int8_t>(static_cast<int>(r));
}

__device__ __forceinline__ void encode(float q, float qmax, __nv_fp8_e4m3* out) {
  *out = __nv_fp8_e4m3(fminf(fmaxf(q, -qmax), qmax));
}

template <typename Q>
__global__ void __launch_bounds__(kThreads) kv_quant_kernel(
    const float* __restrict__ values,   // [N, page_size, H, D]
    const uint8_t* __restrict__ valid,  // [N, page_size]
    Q* __restrict__ codes,              // [N, page_size, H, D]
    float* __restrict__ scales,         // [N, H]
    int page_size, int num_heads, int head_dim, float qmax, float inv_qmax) {
  __shared__ float scratch[32];
  const int head = blockIdx.x;
  const int page = blockIdx.y;
  const int elems = page_size * head_dim;
  const int64_t row_stride = static_cast<int64_t>(num_heads) * head_dim;
  const int64_t base = static_cast<int64_t>(page) * page_size * row_stride +
                       static_cast<int64_t>(head) * head_dim;
  const uint8_t* page_valid = valid + static_cast<int64_t>(page) * page_size;

  float amax = 0.f;
  for (int i = threadIdx.x; i < elems; i += kThreads) {
    const int t = i / head_dim;
    if (page_valid[t]) amax = fmaxf(amax, fabsf(values[base + t * row_stride + (i - t * head_dim)]));
  }
  amax = block_reduce<true>(amax, scratch);
  const float scale = amax > 0.f ? __fmul_rn(amax, inv_qmax) : 1.f;
  if (threadIdx.x == 0) scales[static_cast<int64_t>(page) * num_heads + head] = scale;

  for (int i = threadIdx.x; i < elems; i += kThreads) {
    const int t = i / head_dim;
    const int64_t off = base + t * row_stride + (i - t * head_dim);
    encode(__fdiv_rn(values[off], scale), qmax, codes + off);
  }
}

template <typename Q>
cudaError_t launch(const float* values, const uint8_t* valid, void* codes, float* scales,
                   int num_pages, int page_size, int num_heads, int head_dim, float qmax,
                   float inv_qmax, cudaStream_t stream) {
  const dim3 grid(num_heads, num_pages);
  kv_quant_kernel<Q><<<grid, kThreads, 0, stream>>>(values, valid, static_cast<Q*>(codes), scales,
                                                    page_size, num_heads, head_dim, qmax, inv_qmax);
  return cudaGetLastError();
}

}  // namespace

extern "C" int dolo_kv_quant(const void* values, const void* valid, void* codes, void* scales,
                             int num_pages, int page_size, int num_heads, int head_dim,
                             float qmax, float inv_qmax, int code_dtype, void* stream) {
  if (num_pages <= 0) return cudaSuccess;
  if (num_pages > 65535) return cudaErrorInvalidValue;  // grid.y
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* v = static_cast<const float*>(values);
  const uint8_t* m = static_cast<const uint8_t*>(valid);
  float* sc = static_cast<float*>(scales);
  switch (code_dtype) {
    case dolo::kInt8:
      return launch<int8_t>(v, m, codes, sc, num_pages, page_size, num_heads, head_dim, qmax,
                            inv_qmax, s);
    case dolo::kFloat8E4M3:
      return launch<__nv_fp8_e4m3>(v, m, codes, sc, num_pages, page_size, num_heads, head_dim,
                                   qmax, inv_qmax, s);
    default:
      return cudaErrorInvalidValue;
  }
}
