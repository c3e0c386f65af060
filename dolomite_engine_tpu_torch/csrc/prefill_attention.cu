// Chunked-prefill flash attention through the page table, forward.
//
// Replaces the Pallas kernel `_prefill_kernel`
// (dolomite_engine_tpu/ops/pallas/prefill_attention.py, `paged_prefill_attention`).
// Query i of chunk row b sees key positions <= start[b] + i; rows of the chunk's pad
// tail hold finite garbage that is never read.
//
// Bound on the H100: operations once the chunk is wide (a 512-token chunk does ~4 * 512
// operations per K/V element it reads: 6.7 GFLOP against 26 MB at start 1024, granite's
// 32 heads of 80), bytes for narrow chunks. Design (FlashAttention-2 on mma.sync, the
// machinery of the flash forward in flash_attention.cu without its segments and bias):
// one block of 4 warps per (64-query tile, query head, chunk row), the tiles with the
// most keys first; each warp owns 16 query rows. Q is held in registers as
// `mma.sync.m16n8k16` A fragments; the running max, the denominator and the fp32 output
// accumulator stay in registers, and P goes to bf16 A fragments for P V. The block
// loads its page-table row into shared memory once; tiles of 64 keys (4 pages of 16)
// stream through a two-stage cp.async ring (paged.cuh: the source of each row is found
// once per row, never per element), walked only up to the frontier of the tile's last
// real query. Key tiles wholly at or below the first query's frontier take no mask; only
// the one or two tiles that cross start + q0 ... start + q0 + 63 are masked per element.
// Scores run in log2 units (exp2f). One launch per call.
// Measured on an H100 (PERF.md §6, paged prefill row): faster than SDPA over the
// gathered page view at start 0 and 1024 and at the MoE shape, slower at granite's start
// 1536, and ~9x its operations bound at start 1024: the grid is 256 blocks for 132 SMs
// and the last query tile walks 24 key tiles in order, so the longest block sets the
// time (splitting its keys over warps is later work).
//
// Page types: the query's own type, bf16 under an fp32 query, or int8 / fp8 e4m3 codes
// with [P, Hkv] fp32 scale pools (a quantized pool). The plain version (and the Pallas
// kernel) dequantizes code * scale in fp32 and attends in fp32. Here:
// - bf16 query over codes: the codes are converted to bf16 in shared memory without
//   loss (int8 and e4m3 values are exact in bf16) and the scales move out of the
//   products: each key's K scale multiplies its fp32 score column, (q . code) * k_scale,
//   which is q . (code * k_scale) up to fp32 rounding; each key's V scale multiplies
//   its probability before P is rounded to bf16 for P V (the denominator sums the
//   unscaled fp32 probabilities). So the kernel rounds P * v_scale, not code * v_scale,
//   to bf16: the bf16 cases' 2e-2 tolerance covers it.
// - fp32 query: the same tiles through scalar FMA on the CUDA cores in full fp32 (no
//   TF32), P through shared memory, as the flash kernel's fp32 path does; pages of
//   another type are widened (codes dequantized as __fmul_rn(code, scale), the plain
//   version's one rounding) as they are converted, so fp32 agrees to 1e-5.
// Head dims 16, 64, 80 and 128 are instantiated; the wrapper raises for others.
#include <type_traits>

#include "paged.cuh"

namespace {

using namespace dolo;

constexpr int kBlock = 64;  // query and key tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 2;        // depth of the cp.async page ring
constexpr int kLdP = kBlock + 8;  // row stride of the fp32 path's P tile
constexpr float kLog2e = 1.4426950408889634f;

template <typename T>
constexpr bool kMma = std::is_same_v<T, __nv_bfloat16>;  // tensor cores, else scalar fp32

struct PrefillArgs {
  const void* q;         // [B, C, Hq, D]
  const void* k_pages;   // [P, page_size, Hkv, D]
  const void* v_pages;
  const float* k_scales;  // [P, Hkv] for a quantized pool, else null
  const float* v_scales;
  const int* table;   // [B, max_pages]
  const int* starts;  // [B]
  void* out;          // [B, C, Hq, D]
  int chunk, num_q_heads, num_kv_heads, page_size, max_pages;
  float scale;
};

// Shared memory, in order: the Q tile; the page ring [stage][K, V][kBlock rows]; the
// converted K / V tiles (pages of another type than the query's); the fp32 path's P
// tile; each stage's K and V scales (quantized pages); the page-table row.
template <typename T, typename P, int D>
struct Layout {
  static constexpr int kLd = D + 8;  // row stride of the Q and converted tiles
  static constexpr int kLdPage = kPageRowStride<P, D>;
  static constexpr bool kDirect = std::is_same_v<T, P>;  // the products read the ring
  static constexpr bool kQuant = is_quantized<P>::value;
  static constexpr size_t q_bytes = kBlock * kLd * sizeof(T);
  static constexpr size_t ring_bytes = kStages * 2 * kBlock * kLdPage * sizeof(P);
  static constexpr size_t tile_bytes = kDirect ? 0 : 2 * kBlock * kLd * sizeof(T);
  static constexpr size_t p_bytes = kMma<T> ? 0 : kBlock * kLdP * sizeof(T);
  static constexpr size_t scale_bytes = kQuant ? kStages * 2 * kBlock * sizeof(float) : 0;
  static constexpr size_t fixed_bytes = q_bytes + ring_bytes + tile_bytes + p_bytes + scale_bytes;
  static size_t bytes(int max_pages) { return fixed_bytes + static_cast<size_t>(max_pages) * sizeof(int); }
};

// The staged [K, V] tiles of one stage as T for the products. fp32 queries dequantize
// codes here (code * scale, one fp32 rounding, as the plain version); bf16 queries keep
// the codes, exact in bf16, and take the scales in the scores and P.
template <typename T, typename P, int D>
__device__ __forceinline__ void convert_tiles(T* dst, const P* src, const float* scales) {
  using L = Layout<T, P, D>;
  constexpr int kGroups = D / 8;
  for (int i = threadIdx.x; i < 2 * kBlock * kGroups; i += kThreads) {
    const int r = i / kGroups;  // K rows, then V rows
    const int c = i - r * kGroups;
    float x[8];
    load8(src + r * L::kLdPage + c * 8, x);
    if constexpr (L::kQuant && !kMma<T>) {
      const float s = scales[r];
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = __fmul_rn(x[e], s);
    }
    store8(dst + r * L::kLd + c * 8, x);
  }
}

template <typename T, typename P, int D>
__global__ void __launch_bounds__(kThreads) paged_prefill_kernel(PrefillArgs args) {
  using L = Layout<T, P, D>;
  constexpr int kLd = L::kLd;
  constexpr int kLdPage = L::kLdPage;
  constexpr int kLdTile = L::kDirect ? kLdPage : kLd;  // row stride of the tiles the products read
  constexpr int NTD = D / 8;
  constexpr int KTD = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  P* ring = reinterpret_cast<P*>(smem_raw + L::q_bytes);
  T* tiles = reinterpret_cast<T*>(smem_raw + L::q_bytes + L::ring_bytes);
  T* ps = reinterpret_cast<T*>(smem_raw + L::q_bytes + L::ring_bytes + L::tile_bytes);
  float* scales = reinterpret_cast<float*>(smem_raw + L::q_bytes + L::ring_bytes + L::tile_bytes + L::p_bytes);
  int* table_s = reinterpret_cast<int*>(smem_raw + L::fixed_bytes);

  const int qt = gridDim.x - 1 - blockIdx.x;  // the tiles with the most keys first
  const int head = blockIdx.y;
  const int row = blockIdx.z;
  const int kv_head = head / (args.num_q_heads / args.num_kv_heads);
  const int q0 = qt * kBlock;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
  const int start = args.starts[row];
  const int q_rows = min(kBlock, args.chunk - q0);  // real query rows of the tile
  const int view_len = args.max_pages * args.page_size;
  const int key_end = min(start + q0 + q_rows, view_len);  // one past the last real row's frontier
  const int num_key_tiles = (key_end + kBlock - 1) / kBlock;
  const int num_pages = (key_end + args.page_size - 1) / args.page_size;
  const int* table_row = args.table + static_cast<int64_t>(row) * args.max_pages;
  for (int i = threadIdx.x; i < num_pages; i += kThreads) table_s[i] = table_row[i];

  // the Q tile, rows past the chunk zero-filled: the first cp.async group
  const int64_t q_stride = static_cast<int64_t>(args.num_q_heads) * D;
  const T* q_base = static_cast<const T*>(args.q) + (static_cast<int64_t>(row) * args.chunk + q0) * q_stride +
                    static_cast<int64_t>(head) * D;
  {
    constexpr int kVec = 16 / sizeof(T);
    constexpr int kChunks = D / kVec;
    for (int i = threadIdx.x; i < kBlock * kChunks; i += kThreads) {
      const int r = i / kChunks;
      const int v = i - r * kChunks;
      const bool valid = r < q_rows;
      cp_async_16(qs + r * kLd + v * kVec, q_base + (valid ? r : 0) * q_stride + v * kVec, valid);
    }
    cp_async_commit();
  }
  __syncthreads();  // the table row

  const int64_t token_stride = static_cast<int64_t>(args.num_kv_heads) * D;
  const PagePool<P> pool{static_cast<const P*>(args.k_pages) + static_cast<int64_t>(kv_head) * D,
                         static_cast<const P*>(args.v_pages) + static_cast<int64_t>(kv_head) * D,
                         args.k_scales, args.v_scales, token_stride, args.page_size,
                         args.num_kv_heads, kv_head};
  auto fetch = [&](int t, int stage) {
    P* k_dst = ring + stage * 2 * kBlock * kLdPage;
    float* sc = scales + stage * 2 * kBlock;
    fetch_page_tile<kBlock, D, kThreads>(k_dst, k_dst + kBlock * kLdPage, sc, sc + kBlock, pool, table_s,
                                         t * kBlock, key_end);
    cp_async_commit();
  };

  const int rows[2] = {warp * 16 + g, warp * 16 + g + 8};
  const int frontier[2] = {start + q0 + rows[0], start + q0 + rows[1]};
  const float scale_log2 = args.scale * kLog2e;
  float m[2] = {-INFINITY, -INFINITY};  // running max of the scaled scores (log2 units)
  float l[2] = {0.f, 0.f};              // this lane's share of the denominator
  float o[1][NTD][4];
  zero_acc(o);
  uint32_t qf[KTD][4];  // Q as mma A fragments (tensor-core path)
  bool q_ready = false;

  int stage = 0;
  fetch(0, 0);  // key_end > 0: position 0 is always visible
  for (int t = 0; t < num_key_tiles; ++t) {
    if (t + 1 < num_key_tiles) {
      fetch(t + 1, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const P* staged = ring + stage * 2 * kBlock * kLdPage;
    const float* sc = scales + stage * 2 * kBlock;  // K scales, then V scales
    const T* ks;
    if constexpr (L::kDirect) {
      ks = reinterpret_cast<const T*>(staged);
    } else {
      convert_tiles<T, P, D>(tiles, staged, sc);
      __syncthreads();
      ks = tiles;
    }
    const T* vs = ks + kBlock * kLdTile;

    float s[1][8][4];
    zero_acc(s);
    if constexpr (kMma<T>) {
      if (!q_ready) {  // the Q tile arrived with the first key tile's group
        load_a_frags<KTD>(qf, qs + warp * 16 * kLd, kLd);
        q_ready = true;
      }
      warp_gemm_frags<8, KTD, true>(s, qf, ks, kLdTile);
    } else {
      warp_gemm<1, 8, true>(s, qs + warp * 16 * kLd, kLd, ks, kLdTile, D);
    }

    const int k0 = t * kBlock;
    const bool diagonal = k0 + kBlock - 1 > start + q0;  // a key past the first row's frontier
    float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int h = i >> 1;
        const int col = nt * 8 + 2 * c + (i & 1);
        float score = s[0][nt][i] * scale_log2;
        if constexpr (L::kQuant && kMma<T>) score *= sc[col];
        if (diagonal && k0 + col > frontier[h]) score = -INFINITY;
        s[0][nt][i] = score;
        tile_max[h] = fmaxf(tile_max[h], score);
      }
    float m_use[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m[h], quad_max(tile_max[h]));
      m_use[h] = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m[h] - m_use[h]);
      m[h] = m_new;
      l[h] *= alpha;
#pragma unroll
      for (int nt = 0; nt < NTD; ++nt) {
        o[0][nt][2 * h] *= alpha;
        o[0][nt][2 * h + 1] *= alpha;
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = exp2f(s[0][nt][i] - m_use[i >> 1]);
        l[i >> 1] += p;
        if constexpr (L::kQuant && kMma<T>) {
          s[0][nt][i] = p * sc[kBlock + nt * 8 + 2 * c + (i & 1)];  // the key's V scale
        } else {
          s[0][nt][i] = p;
        }
      }
    if constexpr (kMma<T>) {
      uint32_t pf[4][4];
      acc_to_a_frags<8>(pf, s);
      warp_gemm_frags<NTD, 4, false>(o, pf, vs, kLdTile);
    } else {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          store_pair(ps + rows[h] * kLdP + nt * 8 + 2 * c, s[0][nt][2 * h], s[0][nt][2 * h + 1]);
      __syncwarp();
      warp_gemm<1, NTD, false>(o, ps + warp * 16 * kLdP, kLdP, vs, kLdTile, kBlock);
    }
    __syncthreads();  // the stage (and the converted tiles) are refilled next
    stage ^= 1;
  }

  T* out = static_cast<T*>(args.out);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float inv = 1.f / quad_sum(l[h]);
    if (rows[h] >= q_rows) continue;
    T* dst = out + ((static_cast<int64_t>(row) * args.chunk + q0 + rows[h]) * args.num_q_heads + head) * D;
#pragma unroll
    for (int nt = 0; nt < NTD; ++nt)
      store_pair(dst + nt * 8 + 2 * c, o[0][nt][2 * h] * inv, o[0][nt][2 * h + 1] * inv);
  }
}

template <typename T, typename P, int D>
cudaError_t launch(const PrefillArgs& args, int num_rows, cudaStream_t stream) {
  if (is_quantized<P>::value && (args.k_scales == nullptr || args.v_scales == nullptr))
    return cudaErrorInvalidValue;
  const size_t smem = Layout<T, P, D>::bytes(args.max_pages);
  auto kernel = paged_prefill_kernel<T, P, D>;
  cudaError_t err = allow_shared_memory(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((args.chunk + kBlock - 1) / kBlock, args.num_q_heads, num_rows);
  kernel<<<grid, kThreads, smem, stream>>>(args);
  return cudaGetLastError();
}

template <typename T, typename P>
cudaError_t dispatch_dim(const PrefillArgs& args, int num_rows, int head_dim, cudaStream_t stream) {
  switch (head_dim) {
    case 16:
      return launch<T, P, 16>(args, num_rows, stream);
    case 64:
      return launch<T, P, 64>(args, num_rows, stream);
    case 80:
      return launch<T, P, 80>(args, num_rows, stream);
    case 128:
      return launch<T, P, 128>(args, num_rows, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// the page types a T query reads: its own, bf16, int8 or fp8 e4m3 codes
template <typename T>
cudaError_t dispatch_pages(const PrefillArgs& args, int num_rows, int head_dim, int page_dtype,
                           cudaStream_t stream) {
  switch (page_dtype) {
    case dolo::kFloat32:
      if constexpr (std::is_same<T, float>::value) return dispatch_dim<T, float>(args, num_rows, head_dim, stream);
      return cudaErrorInvalidValue;  // fp32 pages under a bf16 query
    case dolo::kBFloat16:
      return dispatch_dim<T, __nv_bfloat16>(args, num_rows, head_dim, stream);
    case dolo::kInt8:
      return dispatch_dim<T, int8_t>(args, num_rows, head_dim, stream);
    case dolo::kFloat8E4M3:
      return dispatch_dim<T, __nv_fp8_e4m3>(args, num_rows, head_dim, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
size_t smem_bytes_pages(int head_dim, int page_dtype, int max_pages) {
#define DOLO_SMEM(P)                                                      \
  switch (head_dim) {                                                     \
    case 16: return Layout<T, P, 16>::bytes(max_pages);                   \
    case 64: return Layout<T, P, 64>::bytes(max_pages);                   \
    case 80: return Layout<T, P, 80>::bytes(max_pages);                   \
    case 128: return Layout<T, P, 128>::bytes(max_pages);                 \
    default: return 0;                                                    \
  }
  switch (page_dtype) {
    case dolo::kFloat32:
      DOLO_SMEM(float)
    case dolo::kBFloat16:
      DOLO_SMEM(__nv_bfloat16)
    case dolo::kInt8:
      DOLO_SMEM(int8_t)
    case dolo::kFloat8E4M3:
      DOLO_SMEM(__nv_fp8_e4m3)
    default:
      return 0;
  }
#undef DOLO_SMEM
}

}  // namespace

extern "C" int dolo_paged_prefill(const void* q, const void* k_pages, const void* v_pages,
                                  const void* k_scales, const void* v_scales, const void* table,
                                  const void* starts, void* out, int num_rows, int chunk,
                                  int num_q_heads, int num_kv_heads, int head_dim, int page_size,
                                  int max_pages, float scale, int dtype, int page_dtype,
                                  void* stream) {
  if (num_rows <= 0 || chunk <= 0) return cudaSuccess;
  const PrefillArgs args{q, k_pages, v_pages, static_cast<const float*>(k_scales),
                         static_cast<const float*>(v_scales), static_cast<const int*>(table),
                         static_cast<const int*>(starts), out, chunk, num_q_heads, num_kv_heads,
                         page_size, max_pages, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case dolo::kFloat32:
      return dispatch_pages<float>(args, num_rows, head_dim, page_dtype, s);
    case dolo::kBFloat16:
      return dispatch_pages<__nv_bfloat16>(args, num_rows, head_dim, page_dtype, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// Shared-memory bytes one block needs for this query / page type, head_dim and table
// width; 0 for a head_dim the kernel is not built for (the wrapper checks both).
extern "C" int dolo_paged_prefill_smem_bytes(int head_dim, int dtype, int page_dtype, int max_pages) {
  switch (dtype) {
    case dolo::kFloat32:
      return static_cast<int>(smem_bytes_pages<float>(head_dim, page_dtype, max_pages));
    case dolo::kBFloat16:
      return static_cast<int>(smem_bytes_pages<__nv_bfloat16>(head_dim, page_dtype, max_pages));
    default:
      return 0;
  }
}
