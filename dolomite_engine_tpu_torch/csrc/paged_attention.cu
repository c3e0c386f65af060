// Ragged paged-attention decode (and the W-token verify window), forward.
//
// Replaces the Pallas kernel `_paged_decode_kernel`
// (dolomite_engine_tpu/ops/pallas/paged_attention.py, `paged_decode_attention`).
// Bound on the H100: device-memory bytes. At decode each query row meets every resident
// K/V byte of its slot once, about one multiply-add per byte, far below the card's
// operations-per-byte balance; the kernel has to keep many loads in flight. Design: one
// block per (slot, query head), so GQA stays native (query head h reads kv head
// h / (Hq / Hkv), never a repeated copy). The block loads its own page-table row and walks
// only min(cdiv(length + W, page_size), max_pages) pages: traffic follows the slot's
// resident tokens, not the worst-case view. QK gives each thread whole keys, read with
// 16-byte loads where the row allows; the fp32 score row stays in shared memory for an
// exact softmax, as the TPU kernel keeps it in VMEM; probabilities are rounded to the
// element type before the PV sum. PV splits the visible keys across the block's warps
// (lanes over the features, coalesced reads of a value row) and sums the warps' fp32
// partials at the end. An idle slot (all-zero table row, length 0) walks the trash page 0
// and yields finite garbage that is never read.
//
// Pages may be of another type P than the query's T: the model dtype, bf16 under an fp32
// model, or int8 / fp8 e4m3 codes with [P, Hkv] fp32 scale pools (a quantized pool). A
// code is dequantized as the Pallas kernel does it (`paged_attention.py`, the `quantized`
// branch): float(code) * scale[page, kv head], rounded to T before the dot or the PV sum.
// A 16-byte load then carries 16 codes; head_dim 64 and 80 still divide.
#include "common.cuh"

namespace {

using namespace dolo;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxFeaturesPerLane = 8;  // head_dim <= 256

// one stored K/V element as the T the attention computes in: a quantized code times its
// page's scale (an fp32 product, never contracted into an FMA) rounded to T, as the
// reference's dequantizing gather casts it; any other page type exactly as it is
template <typename T, typename P>
__device__ __forceinline__ float load_kv(P x, float scale) {
  if constexpr (is_quantized<P>::value) {
    return round_to<T>(__fmul_rn(to_float(x), scale));
  } else {
    return to_float(x);
  }
}

// q (fp32, shared memory) . key (page type, device memory) over head_dim features
template <typename T, typename P>
__device__ __forceinline__ float dot_key(const float* q, const P* key, int head_dim, bool vector,
                                         float scale) {
  float acc = 0.f;
  if (vector) {
    constexpr int kVec = 16 / sizeof(P);
    const uint4* chunks = reinterpret_cast<const uint4*>(key);
    for (int c = 0; c < head_dim / kVec; ++c) {
      const uint4 raw = chunks[c];
      const P* values = reinterpret_cast<const P*>(&raw);
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc += q[c * kVec + e] * load_kv<T>(values[e], scale);
    }
  } else {
    for (int d = 0; d < head_dim; ++d) acc += q[d] * load_kv<T>(key[d], scale);
  }
  return acc;
}

// the per-(page, kv head) scale of a quantized pool; 1 (unused) for other page types
template <typename P>
__device__ __forceinline__ float page_scale(const float* scales, int page, int num_kv_heads,
                                            int kv_head) {
  if constexpr (is_quantized<P>::value) {
    return scales[static_cast<int64_t>(page) * num_kv_heads + kv_head];
  } else {
    return 1.f;
  }
}

template <typename T, typename P>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const T* __restrict__ q,           // [S, W, Hq, D]
    const P* __restrict__ k_pages,     // [P, page_size, Hkv, D]
    const P* __restrict__ v_pages,     // [P, page_size, Hkv, D]
    const float* __restrict__ k_scales,  // [P, Hkv] for a quantized pool, else unused
    const float* __restrict__ v_scales,  // [P, Hkv] for a quantized pool, else unused
    const int* __restrict__ table,     // [S, max_pages]
    const int* __restrict__ lengths,   // [S]
    T* __restrict__ out,               // [S, W, Hq, D]
    int width, int num_q_heads, int num_kv_heads, int head_dim, int page_size, int max_pages,
    float scale) {
  extern __shared__ float smem[];
  const int head = blockIdx.x;
  const int slot = blockIdx.y;
  const int kv_head = head / (num_q_heads / num_kv_heads);
  const int view_len = max_pages * page_size;
  float* scores = smem;                                  // [W, view_len]
  float* qs = scores + width * view_len;                 // [W, D]
  float* partial = qs + width * head_dim;                // [kWarps, W, D]
  float* scratch = partial + kWarps * width * head_dim;  // [32]
  int* pages = reinterpret_cast<int*>(scratch + 32);     // [max_pages]

  const int length = lengths[slot];
  const int pages_needed = min((length + width + page_size - 1) / page_size, max_pages);
  const int num_keys = pages_needed * page_size;
  const int64_t token_stride = static_cast<int64_t>(num_kv_heads) * head_dim;
  const int64_t head_offset = static_cast<int64_t>(kv_head) * head_dim;
  const bool vector =
      (head_dim * sizeof(P)) % 16 == 0 && reinterpret_cast<uintptr_t>(k_pages) % 16 == 0;

  for (int i = threadIdx.x; i < pages_needed; i += blockDim.x)
    pages[i] = table[static_cast<int64_t>(slot) * max_pages + i];
  for (int i = threadIdx.x; i < width * head_dim; i += blockDim.x) {
    const int j = i / head_dim;
    const int d = i - j * head_dim;
    qs[i] = to_float(q[((static_cast<int64_t>(slot) * width + j) * num_q_heads + head) * head_dim + d]);
  }
  __syncthreads();

  // scores: each thread takes whole keys of the walked pages
  for (int t = threadIdx.x; t < num_keys; t += blockDim.x) {
    const int page = pages[t / page_size];
    const P* key = k_pages + (static_cast<int64_t>(page) * page_size + t % page_size) * token_stride +
                   head_offset;
    const float k_scale = page_scale<P>(k_scales, page, num_kv_heads, kv_head);
    for (int j = 0; j < width; ++j) {
      const float dot = dot_key<T>(qs + j * head_dim, key, head_dim, vector, k_scale);
      // the per-row causal frontier: query j of the slot sees positions <= length + j
      scores[j * view_len + t] = t <= length + j ? dot * scale : kNegInf;
    }
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int j = 0; j < width; ++j) {
    // exact fp32 softmax over the visible keys (a masked or unwalked key would be kNegInf
    // and add exactly 0), probabilities rounded to the element type
    float* row = scores + j * view_len;
    const int visible = min(num_keys, length + j + 1);
    float m = kNegInf;
    for (int t = threadIdx.x; t < visible; t += blockDim.x) m = fmaxf(m, row[t]);
    m = block_reduce<true>(m, scratch);
    float sum = 0.f;
    for (int t = threadIdx.x; t < visible; t += blockDim.x) {
      const float e = expf(row[t] - m);
      row[t] = e;
      sum += e;
    }
    sum = block_reduce<false>(sum, scratch);
    for (int t = threadIdx.x; t < visible; t += blockDim.x) row[t] = round_to<T>(row[t] / sum);
    __syncthreads();

    // PV: warps split the visible keys, lanes the features; fp32 partial sums per warp
    float acc[kMaxFeaturesPerLane];
#pragma unroll
    for (int f = 0; f < kMaxFeaturesPerLane; ++f) acc[f] = 0.f;
#pragma unroll 4
    for (int t = warp; t < visible; t += kWarps) {
      const float p = row[t];
      const int page = pages[t / page_size];
      const P* value = v_pages + (static_cast<int64_t>(page) * page_size + t % page_size) * token_stride +
                       head_offset;
      const float v_scale = page_scale<P>(v_scales, page, num_kv_heads, kv_head);
#pragma unroll
      for (int f = 0; f < kMaxFeaturesPerLane; ++f) {
        const int d = lane + 32 * f;
        if (d < head_dim) acc[f] += p * load_kv<T>(value[d], v_scale);
      }
    }
#pragma unroll
    for (int f = 0; f < kMaxFeaturesPerLane; ++f) {
      const int d = lane + 32 * f;
      if (d < head_dim) partial[(warp * width + j) * head_dim + d] = acc[f];
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < width * head_dim; i += blockDim.x) {
    float total = 0.f;
    for (int w = 0; w < kWarps; ++w) total += partial[w * width * head_dim + i];
    const int j = i / head_dim;
    const int d = i - j * head_dim;
    out[((static_cast<int64_t>(slot) * width + j) * num_q_heads + head) * head_dim + d] = from_float<T>(total);
  }
}

template <typename T, typename P>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages, const float* k_scales,
                   const float* v_scales, const int* table, const int* lengths, void* out,
                   int num_slots, int width, int num_q_heads, int num_kv_heads, int head_dim,
                   int page_size, int max_pages, float scale, cudaStream_t stream) {
  if (is_quantized<P>::value && (k_scales == nullptr || v_scales == nullptr))
    return cudaErrorInvalidValue;
  const size_t smem =
      (static_cast<size_t>(width) * (max_pages * page_size + (1 + kWarps) * head_dim) + 32) *
          sizeof(float) +
      static_cast<size_t>(max_pages) * sizeof(int);
  auto kernel = paged_decode_kernel<T, P>;
  cudaError_t err = allow_shared_memory(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(num_q_heads, num_slots);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(k_pages), static_cast<const P*>(v_pages),
      k_scales, v_scales, table, lengths, static_cast<T*>(out), width, num_q_heads, num_kv_heads,
      head_dim, page_size, max_pages, scale);
  return cudaGetLastError();
}

// the page types a T query reads: its own, bf16, int8 or fp8 e4m3 codes
template <typename T>
cudaError_t launch_pages(int page_dtype, const void* q, const void* k_pages, const void* v_pages,
                         const float* k_scales, const float* v_scales, const int* table,
                         const int* lengths, void* out, int num_slots, int width, int num_q_heads,
                         int num_kv_heads, int head_dim, int page_size, int max_pages, float scale,
                         cudaStream_t stream) {
#define DOLO_DECODE(P)                                                                          \
  launch<T, P>(q, k_pages, v_pages, k_scales, v_scales, table, lengths, out, num_slots, width, \
               num_q_heads, num_kv_heads, head_dim, page_size, max_pages, scale, stream)
  switch (page_dtype) {
    case dolo::kFloat32:
      if constexpr (std::is_same<T, float>::value) return DOLO_DECODE(float);
      return cudaErrorInvalidValue;  // fp32 pages under a bf16 query
    case dolo::kBFloat16:
      return DOLO_DECODE(__nv_bfloat16);
    case dolo::kInt8:
      return DOLO_DECODE(int8_t);
    case dolo::kFloat8E4M3:
      return DOLO_DECODE(__nv_fp8_e4m3);
    default:
      return cudaErrorInvalidValue;
  }
#undef DOLO_DECODE
}

}  // namespace

extern "C" int dolo_paged_decode(const void* q, const void* k_pages, const void* v_pages,
                                 const void* k_scales, const void* v_scales, const void* table,
                                 const void* lengths, void* out, int num_slots, int width,
                                 int num_q_heads, int num_kv_heads, int head_dim, int page_size,
                                 int max_pages, float scale, int dtype, int page_dtype,
                                 void* stream) {
  if (num_slots <= 0) return cudaSuccess;
  if (head_dim > 32 * kMaxFeaturesPerLane) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ks = static_cast<const float*>(k_scales);
  const float* vs = static_cast<const float*>(v_scales);
  const int* t = static_cast<const int*>(table);
  const int* l = static_cast<const int*>(lengths);
  switch (dtype) {
    case dolo::kFloat32:
      return launch_pages<float>(page_dtype, q, k_pages, v_pages, ks, vs, t, l, out, num_slots,
                                 width, num_q_heads, num_kv_heads, head_dim, page_size, max_pages,
                                 scale, s);
    case dolo::kBFloat16:
      return launch_pages<__nv_bfloat16>(page_dtype, q, k_pages, v_pages, ks, vs, t, l, out,
                                         num_slots, width, num_q_heads, num_kv_heads, head_dim,
                                         page_size, max_pages, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
