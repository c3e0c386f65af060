// Chunked-prefill flash attention through the page table, forward.
//
// Replaces the Pallas kernel `_prefill_kernel`
// (dolomite_engine_tpu/ops/pallas/prefill_attention.py, `paged_prefill_attention`).
// Bound on the H100: operations once a chunk is wide (a 512-token chunk does ~512 * 4
// operations per K/V element it reads), bytes for narrow chunks. Design: one block per
// (query block of kBlockQ rows, query head, chunk row). The block walks key tiles of
// kBlockK positions up to the causal frontier of its last query (start + q0 + kBlockQ),
// looking each position's page up in the table, so unmapped pages past the frontier are
// never read. K/V tiles are staged in shared memory in fp32 and shared by the block's
// kBlockQ queries; the flash recurrence (running max, denominator, fp32 accumulator per
// query row) replaces a chunk-wide score matrix. Query i of the chunk sees key positions
// <= start + i. Position 0 is always visible, so the running max is finite after the
// first tile. This first version computes on the CUDA cores in fp32; tensor-core tiles
// are later work.
//
// Pages may be of another type P than the query's T: the model dtype, bf16 under an fp32
// model, or int8 / fp8 e4m3 codes with [P, Hkv] fp32 scale pools (a quantized pool). The
// staging load dequantizes: float(code) * scale[page, kv head] in fp32, not rounded to T,
// as the Pallas prefill kernel does (`prefill_attention.py`, the `quantized` branch).
#include "common.cuh"

namespace {

using namespace dolo;

constexpr int kThreads = 128;
constexpr int kBlockQ = 32;
constexpr int kBlockK = 32;  // == warp size: one lane per key in the softmax update
static_assert(kBlockK == 32, "the online-softmax update maps one lane to one key");

__host__ __device__ constexpr size_t prefill_smem_floats(int head_dim) {
  return 2 * kBlockQ * head_dim                      // queries, accumulators
         + kBlockK * (head_dim + 1) + kBlockK * head_dim  // K tile (padded), V tile
         + kBlockQ * kBlockK + 3 * kBlockQ;          // scores, running max / sum / rescale
}

// one stored K/V element in fp32: a quantized code times its page's scale (never
// contracted into an FMA), any other page type exactly as it is
template <typename P>
__device__ __forceinline__ float stage_kv(P x, const float* scales, int page, int num_kv_heads,
                                          int kv_head) {
  if constexpr (is_quantized<P>::value) {
    return __fmul_rn(to_float(x), scales[static_cast<int64_t>(page) * num_kv_heads + kv_head]);
  } else {
    return to_float(x);
  }
}

template <typename T, typename P>
__global__ void __launch_bounds__(kThreads) paged_prefill_kernel(
    const T* __restrict__ q,          // [B, C, Hq, D]
    const P* __restrict__ k_pages,    // [P, page_size, Hkv, D]
    const P* __restrict__ v_pages,    // [P, page_size, Hkv, D]
    const float* __restrict__ k_scales,  // [P, Hkv] for a quantized pool, else unused
    const float* __restrict__ v_scales,  // [P, Hkv] for a quantized pool, else unused
    const int* __restrict__ table,    // [B, max_pages]
    const int* __restrict__ starts,   // [B]
    T* __restrict__ out,              // [B, C, Hq, D]
    int chunk, int num_q_heads, int num_kv_heads, int head_dim, int page_size, int max_pages,
    float scale) {
  extern __shared__ float smem[];
  const int q0 = blockIdx.x * kBlockQ;
  const int head = blockIdx.y;
  const int row = blockIdx.z;
  const int kv_head = head / (num_q_heads / num_kv_heads);
  const int ldk = head_dim + 1;  // odd stride: lanes reading one feature of 32 keys hit 32 banks
  float* qs = smem;
  float* acc = qs + kBlockQ * head_dim;
  float* ks = acc + kBlockQ * head_dim;
  float* vs = ks + kBlockK * ldk;
  float* s = vs + kBlockK * head_dim;
  float* m = s + kBlockQ * kBlockK;
  float* l = m + kBlockQ;
  float* alpha = l + kBlockQ;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int num_warps = kThreads >> 5;
  const int start = starts[row];
  const int view_len = max_pages * page_size;
  const int key_end = min(start + q0 + kBlockQ, view_len);  // exclusive
  const int64_t token_stride = static_cast<int64_t>(num_kv_heads) * head_dim;
  const int64_t head_offset = static_cast<int64_t>(kv_head) * head_dim;
  const int* table_row = table + static_cast<int64_t>(row) * max_pages;

  for (int i = tid; i < kBlockQ * head_dim; i += kThreads) {
    const int r = i / head_dim;
    const int d = i - r * head_dim;
    const int qi = q0 + r;
    qs[i] = qi < chunk
                ? to_float(q[((static_cast<int64_t>(row) * chunk + qi) * num_q_heads + head) * head_dim + d])
                : 0.f;
    acc[i] = 0.f;
  }
  for (int i = tid; i < kBlockQ; i += kThreads) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  __syncthreads();

  for (int k0 = 0; k0 < key_end; k0 += kBlockK) {
    for (int i = tid; i < kBlockK * head_dim; i += kThreads) {
      const int t = i / head_dim;
      const int d = i - t * head_dim;
      const int pos = k0 + t;
      float kv = 0.f, vv = 0.f;
      if (pos < key_end) {
        const int page = table_row[pos / page_size];
        const int64_t off = (static_cast<int64_t>(page) * page_size + pos % page_size) * token_stride +
                            head_offset + d;
        kv = stage_kv(k_pages[off], k_scales, page, num_kv_heads, kv_head);
        vv = stage_kv(v_pages[off], v_scales, page, num_kv_heads, kv_head);
      }
      ks[t * ldk + d] = kv;
      vs[t * head_dim + d] = vv;
    }
    __syncthreads();

    for (int i = tid; i < kBlockQ * kBlockK; i += kThreads) {
      const int r = i / kBlockK;
      const int t = i - r * kBlockK;
      const int pos = k0 + t;
      float dot = 0.f;
      for (int d = 0; d < head_dim; ++d) dot += qs[r * head_dim + d] * ks[t * ldk + d];
      s[i] = (pos <= start + q0 + r && pos < key_end) ? dot * scale : kNegInf;
    }
    __syncthreads();

    // flash recurrence, one warp per query row and one lane per key of the tile
    for (int r = warp; r < kBlockQ; r += num_warps) {
      const float score = s[r * kBlockK + lane];
      const float m_old = m[r];
      const float m_new = fmaxf(m_old, warp_max(score));
      const float p = expf(score - m_new);
      s[r * kBlockK + lane] = p;
      const float p_sum = warp_sum(p);
      if (lane == 0) {
        const float a = expf(m_old - m_new);
        alpha[r] = a;
        l[r] = l[r] * a + p_sum;
        m[r] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < kBlockQ * head_dim; i += kThreads) {
      const int r = i / head_dim;
      const int d = i - r * head_dim;
      float a = acc[i] * alpha[r];
      const float* probs = s + r * kBlockK;
#pragma unroll 8
      for (int t = 0; t < kBlockK; ++t) a += probs[t] * vs[t * head_dim + d];
      acc[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < kBlockQ * head_dim; i += kThreads) {
    const int r = i / head_dim;
    const int d = i - r * head_dim;
    const int qi = q0 + r;
    if (qi < chunk)
      out[((static_cast<int64_t>(row) * chunk + qi) * num_q_heads + head) * head_dim + d] =
          from_float<T>(acc[i] / l[r]);
  }
}

template <typename T, typename P>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages, const float* k_scales,
                   const float* v_scales, const int* table, const int* starts, void* out,
                   int num_rows, int chunk, int num_q_heads, int num_kv_heads, int head_dim,
                   int page_size, int max_pages, float scale, cudaStream_t stream) {
  if (is_quantized<P>::value && (k_scales == nullptr || v_scales == nullptr))
    return cudaErrorInvalidValue;
  const size_t smem = prefill_smem_floats(head_dim) * sizeof(float);
  auto kernel = paged_prefill_kernel<T, P>;
  cudaError_t err = allow_shared_memory(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((chunk + kBlockQ - 1) / kBlockQ, num_q_heads, num_rows);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(k_pages), static_cast<const P*>(v_pages),
      k_scales, v_scales, table, starts, static_cast<T*>(out), chunk, num_q_heads, num_kv_heads,
      head_dim, page_size, max_pages, scale);
  return cudaGetLastError();
}

// the page types a T query reads: its own, bf16, int8 or fp8 e4m3 codes
template <typename T>
cudaError_t launch_pages(int page_dtype, const void* q, const void* k_pages, const void* v_pages,
                         const float* k_scales, const float* v_scales, const int* table,
                         const int* starts, void* out, int num_rows, int chunk, int num_q_heads,
                         int num_kv_heads, int head_dim, int page_size, int max_pages, float scale,
                         cudaStream_t stream) {
#define DOLO_PREFILL(P)                                                                       \
  launch<T, P>(q, k_pages, v_pages, k_scales, v_scales, table, starts, out, num_rows, chunk, \
               num_q_heads, num_kv_heads, head_dim, page_size, max_pages, scale, stream)
  switch (page_dtype) {
    case dolo::kFloat32:
      if constexpr (std::is_same<T, float>::value) return DOLO_PREFILL(float);
      return cudaErrorInvalidValue;  // fp32 pages under a bf16 query
    case dolo::kBFloat16:
      return DOLO_PREFILL(__nv_bfloat16);
    case dolo::kInt8:
      return DOLO_PREFILL(int8_t);
    case dolo::kFloat8E4M3:
      return DOLO_PREFILL(__nv_fp8_e4m3);
    default:
      return cudaErrorInvalidValue;
  }
#undef DOLO_PREFILL
}

}  // namespace

extern "C" int dolo_paged_prefill(const void* q, const void* k_pages, const void* v_pages,
                                  const void* k_scales, const void* v_scales, const void* table,
                                  const void* starts, void* out, int num_rows, int chunk,
                                  int num_q_heads, int num_kv_heads, int head_dim, int page_size,
                                  int max_pages, float scale, int dtype, int page_dtype,
                                  void* stream) {
  if (num_rows <= 0 || chunk <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ks = static_cast<const float*>(k_scales);
  const float* vs = static_cast<const float*>(v_scales);
  const int* t = static_cast<const int*>(table);
  const int* st = static_cast<const int*>(starts);
  switch (dtype) {
    case dolo::kFloat32:
      return launch_pages<float>(page_dtype, q, k_pages, v_pages, ks, vs, t, st, out, num_rows,
                                 chunk, num_q_heads, num_kv_heads, head_dim, page_size, max_pages,
                                 scale, s);
    case dolo::kBFloat16:
      return launch_pages<__nv_bfloat16>(page_dtype, q, k_pages, v_pages, ks, vs, t, st, out,
                                         num_rows, chunk, num_q_heads, num_kv_heads, head_dim,
                                         page_size, max_pages, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// Shared-memory bytes the kernel needs at this head_dim (the wrapper checks the limit).
extern "C" int dolo_paged_prefill_smem_bytes(int head_dim) {
  return static_cast<int>(prefill_smem_floats(head_dim) * sizeof(float));
}
