// The page-table walk shared by the paged decode and chunked-prefill kernels (sm_90a).
//
// Both kernels stage tiles of consecutive key positions of one kv head from the page
// pool [P, page_size, Hkv, D] into shared memory with 16-byte cp.async copies: the
// source of each position is found once per row of the tile,
// (table[pos / page_size] * page_size + pos % page_size) * Hkv * D + kv_head * D, and
// both K and V of the row are copied from it. Rows at or past the tile's end are
// zero-filled, so no unmapped position is read. Quantized pages (int8 / fp8 e4m3 codes)
// bring each row's per-(page, kv head) fp32 K and V scales along in the same cp.async
// group.
#pragma once

#include "mma.cuh"

namespace dolo {

// Asynchronous 4-byte copy global -> shared (zero-filled when !valid).
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0));
}

// Eight consecutive elements as fp32 (exactly: every element type widens without loss),
// read with one 16-byte load (bf16), one 8-byte load (int8, fp8) or two 16-byte loads
// (fp32). The address is aligned to the load's width.
__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w, x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(pairs[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
template <typename P>
__device__ __forceinline__ void load8_bytes(const P* p, float (&x)[8]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const P* codes = reinterpret_cast<const P*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = to_float(codes[i]);
}
__device__ __forceinline__ void load8(const int8_t* p, float (&x)[8]) { load8_bytes(p, x); }
__device__ __forceinline__ void load8(const __nv_fp8_e4m3* p, float (&x)[8]) { load8_bytes(p, x); }

// Eight fp32 values stored as T (bf16: rounded to nearest even).
__device__ __forceinline__ void store8(float* p, const float (&x)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&x)[8]) {
  uint4 raw;
  __nv_bfloat162* pairs = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) pairs[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// Row stride (elements) of a staged page tile: 16 bytes of padding per row, so rows stay
// 16-byte aligned and neighbouring rows start in other shared-memory banks.
template <typename P, int D>
constexpr int kPageRowStride = D + 16 / static_cast<int>(sizeof(P));

// One kv head of the page pool and of its scale pools, as the kernels walk it.
template <typename P>
struct PagePool {
  const P* k;             // [P, page_size, Hkv, D], offset to the kv head
  const P* v;
  const float* k_scales;  // [P, Hkv] for a quantized pool, else null
  const float* v_scales;
  int64_t token_stride;   // Hkv * D
  int page_size;
  int num_kv_heads;
  int kv_head;
};

// Start the cp.async copies of key positions [k0, k0 + kRows) into the K and V tiles
// (rows kPageRowStride<P, D> apart) and, for quantized pages, each row's K and V scale;
// positions at or past `key_end` are zero-filled. `table_row` is the row's page-table
// row (shared or device memory). Two threads share a row where it holds two or more
// 16-byte chunks. The caller commits the group.
template <int kRows, int D, int kThreads, typename P>
__device__ __forceinline__ void fetch_page_tile(P* k_dst, P* v_dst, float* k_scale_dst,
                                                float* v_scale_dst, const PagePool<P>& pool,
                                                const int* table_row, int k0, int key_end) {
  constexpr int kLd = kPageRowStride<P, D>;
  constexpr int kVec = 16 / sizeof(P);
  constexpr int kChunks = D / kVec;  // 16-byte chunks in a row
  constexpr int kParts = kChunks >= 2 ? 2 : 1;
  static_assert(kRows * kParts <= kThreads, "one pass of the block stages the tile");
  if (threadIdx.x >= kRows * kParts) return;
  const int r = threadIdx.x / kParts;
  const int part = threadIdx.x - r * kParts;
  const int pos = k0 + r;
  const bool valid = pos < key_end;
  const int page = valid ? table_row[pos / pool.page_size] : 0;
  const int64_t src =
      (static_cast<int64_t>(page) * pool.page_size + (valid ? pos % pool.page_size : 0)) * pool.token_stride;
#pragma unroll
  for (int c = part; c < kChunks; c += kParts) {
    cp_async_16(k_dst + r * kLd + c * kVec, pool.k + src + c * kVec, valid);
    cp_async_16(v_dst + r * kLd + c * kVec, pool.v + src + c * kVec, valid);
  }
  if constexpr (is_quantized<P>::value) {
    if (part == 0) {
      const int64_t scale_row = static_cast<int64_t>(page) * pool.num_kv_heads + pool.kv_head;
      cp_async_4(k_scale_dst + r, pool.k_scales + scale_row, valid);
      cp_async_4(v_scale_dst + r, pool.v_scales + scale_row, valid);
    }
  }
}

}  // namespace dolo
