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
//
// The fused scatter-quantize (`dolo_kv_quant_scatter`) is the whole of the JAX package's
// `paged_scatter_kv_quantized` (dolomite_engine_tpu/ops/attention.py, with
// `quantize_pages_pallas` inside) for K and V in one launch, in place: one block per
// (K or V, row, window page, kv head) finds the page under the row's write window
// (csrc/paged_write.cuh), returns at once when this call writes none of its rows or the
// page is the trash page 0 (block-uniform: the plain version sends such pages to page 0,
// never compared), else dequantizes the page's codes with its old scale (an fp32 product,
// __fmul_rn), overlays the new rows, takes the absmax over the valid rows (the committed
// prefix before the row's frontier, and this call's writes) and encodes the page as
// above. The block reads and writes only its own (page, head) slice, and a writable page
// belongs to one row (the pool's contract), so the update in place is safe. The second
// pass recomputes each value the first pass saw, from the codes it is about to replace.
#include "common.cuh"
#include "paged_write.cuh"

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

// at most this many rows a page (the written-row flags live in shared memory)
constexpr int kMaxPageSize = 256;

struct ScatterArgs {
  void* pages[2];   // K, V codes [num_pages, page_size, H, D]
  float* scales[2];  // K, V scales [num_pages, H]
  const void* rows[2];  // the new K, V [B, S, H, D] by the strides below
  int64_t batch_stride, seq_stride;
  PagedWindow window;
  int seq, num_heads, head_dim;
  float qmax, inv_qmax;
};

template <typename Q, typename T>
__global__ void __launch_bounds__(kThreads) kv_quant_scatter_kernel(const ScatterArgs a) {
  __shared__ float scratch[32];
  __shared__ bool written[kMaxPageSize];
  const int head = blockIdx.x;
  const int which = blockIdx.z & 1;  // 0: K, 1: V
  const int b = blockIdx.z >> 1;
  const PagedWindow& w = a.window;
  // positions past the view are clamped to 0 before the window is placed, so a row whose
  // first position is past the view writes nothing
  const int64_t start = w.row_start(b);
  if (start >= w.view_len()) return;
  const int64_t logical = start / w.page_size + blockIdx.y;
  if (logical >= w.max_pages) return;
  const int phys = w.table[static_cast<int64_t>(b) * w.max_pages + logical];
  if (phys == 0) return;
  const int64_t first = logical * w.page_size;  // the page's first position
  bool any = false;
  for (int r = threadIdx.x; r < w.page_size; r += kThreads) {
    const int64_t s = first + r - start;
    written[r] = s >= 0 && s < a.seq && w.unmasked(b, first + r);
    any |= written[r];
  }
  if (!__syncthreads_or(any)) return;

  const int64_t row_stride = static_cast<int64_t>(a.num_heads) * a.head_dim;
  Q* codes = static_cast<Q*>(a.pages[which]) + static_cast<int64_t>(phys) * w.page_size * row_stride +
             static_cast<int64_t>(head) * a.head_dim;
  float* scale_slot = a.scales[which] + static_cast<int64_t>(phys) * a.num_heads + head;
  const float old_scale = *scale_slot;
  const T* src = static_cast<const T*>(a.rows[which]) + b * a.batch_stride + static_cast<int64_t>(head) * a.head_dim;
  const int elems = w.page_size * a.head_dim;
  // the window value of element i: the new row where this call writes, else the page's
  // code times its old scale
  auto value = [&](int r, int d) -> float {
    if (written[r]) return to_float(src[(first + r - start) * a.seq_stride + d]);
    return __fmul_rn(to_float(codes[r * row_stride + d]), old_scale);
  };

  float amax = 0.f;
  for (int i = threadIdx.x; i < elems; i += kThreads) {
    const int r = i / a.head_dim;
    if (first + r < start || written[r]) amax = fmaxf(amax, fabsf(value(r, i - r * a.head_dim)));
  }
  amax = block_reduce<true>(amax, scratch);
  const float scale = amax > 0.f ? __fmul_rn(amax, a.inv_qmax) : 1.f;
  for (int i = threadIdx.x; i < elems; i += kThreads) {
    const int r = i / a.head_dim;
    const int d = i - r * a.head_dim;
    encode(__fdiv_rn(value(r, d), scale), a.qmax, codes + r * row_stride + d);
  }
  if (threadIdx.x == 0) *scale_slot = scale;  // every thread read the old one above
}

template <typename Q, typename T>
cudaError_t launch_scatter(const ScatterArgs& a, int batch, cudaStream_t stream) {
  const int span = (a.seq - 1) / a.window.page_size + 2;
  if (span > 65535 || 2 * batch > 65535) return cudaErrorInvalidValue;  // grid.y, grid.z
  const dim3 grid(a.num_heads, span, 2 * batch);
  kv_quant_scatter_kernel<Q, T><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename Q>
cudaError_t launch_scatter_rows(const ScatterArgs& a, int batch, int dtype, cudaStream_t stream) {
  switch (dtype) {
    case dolo::kFloat32:
      return launch_scatter<Q, float>(a, batch, stream);
    case dolo::kBFloat16:
      return launch_scatter<Q, __nv_bfloat16>(a, batch, stream);
    default:
      return cudaErrorInvalidValue;
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

// K and V of one layer's new tokens [B, S, H, D] (`dtype`, at the given element strides of
// a batch row and a position; the last two dimensions contiguous) quantized into their
// pools in place: codes [num_pages, page_size, H, D] of `code_dtype`, scales
// [num_pages, H] fp32; the window as in csrc/paged_write.cuh.
extern "C" int dolo_kv_quant_scatter(void* k_pages, void* v_pages, void* k_scales, void* v_scales,
                                     const void* key, const void* value, const void* table,
                                     const void* index, const void* mask, int batch, int seq,
                                     int num_heads, int head_dim, int page_size, int max_pages,
                                     int batch_stride, int seq_stride, int index_kind,
                                     int index_stride, int start, int mask_kind, int mask_stride,
                                     float qmax, float inv_qmax, int code_dtype, int dtype,
                                     void* stream) {
  if (batch <= 0 || seq <= 0) return cudaSuccess;
  if (page_size <= 0 || page_size > kMaxPageSize || max_pages <= 0) return cudaErrorInvalidValue;
  ScatterArgs a{};
  a.pages[0] = k_pages;
  a.pages[1] = v_pages;
  a.scales[0] = static_cast<float*>(k_scales);
  a.scales[1] = static_cast<float*>(v_scales);
  a.rows[0] = key;
  a.rows[1] = value;
  a.batch_stride = batch_stride;
  a.seq_stride = seq_stride;
  a.window = PagedWindow{static_cast<const int*>(table), index, mask, mask_stride, index_kind,
                         index_stride, start, mask_kind, page_size, max_pages};
  a.seq = seq;
  a.num_heads = num_heads;
  a.head_dim = head_dim;
  a.qmax = qmax;
  a.inv_qmax = inv_qmax;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (code_dtype) {
    case dolo::kInt8:
      return launch_scatter_rows<int8_t>(a, batch, dtype, s);
    case dolo::kFloat8E4M3:
      return launch_scatter_rows<__nv_fp8_e4m3>(a, batch, dtype, s);
    default:
      return cudaErrorInvalidValue;
  }
}
