// Ragged paged-attention decode (and the W-token verify window), forward.
//
// Replaces the Pallas kernel `_paged_decode_kernel`
// (dolomite_engine_tpu/ops/pallas/paged_attention.py, `paged_decode_attention`).
// Query j of slot s sees positions <= length[s] + j; an idle slot (all-zero table row,
// length 0) walks the trash page 0 and yields finite garbage that is never read.
//
// Bound on the H100: device-memory bytes. Each query row meets every resident K/V byte
// of its slot once, about one multiply-add per byte, far below the card's
// operations-per-byte balance; the kernel has to keep many loads in flight across the
// whole card. Design:
// - Split keys over blocks. One block of 4 warps per (key split of kSpan = 256
//   positions, kv head, slot), for the group's query rows (all Hq / Hkv query heads of
//   the kv head times the W rows, up to kQueries = 4 a block; a wider group takes more
//   blocks): GQA reads each K/V byte once, and a ragged batch spreads over the card (a
//   2047-token slot is 8 splits, a 64-token one 1) instead of the longest slot setting
//   the time. Blocks past a slot's last split exit at once.
// - Loads. The split's positions stream through a cp.async ring of 64-key tiles
//   (paged.cuh: 16-byte copies, the source of each row found once per row, the span's
//   page-table entries read into shared memory once); head_dim is
//   a template parameter, so every loop unrolls. Q K: two threads per key, each over
//   half the features in 8-element vectors (one 16-byte load for bf16). P V: lanes over
//   8-feature vectors of a value row (16 bytes a lane for bf16), several keys per warp.
// - Partials. Each split keeps an online-softmax partial per query row in fp32: its max
//   (log2 units), its denominator and its unnormalised output.
// - Merge, one launch. A slot with one split writes its rows directly. Otherwise each
//   split stores its partial, and the block that arrives last at the (slot, kv head,
//   query group)'s counter (a per-device int the wrapper allocates once, zeroed, and the
//   merging block resets) merges all partials in split order 0, 1, ..., each rescaled
//   by exp(m_split - m): the result does not depend on which block finishes last.
// - Shared memory holds a few tiles, whatever max_len is: no score row.
// Measured on an H100 (PERF.md §6, paged decode row): ~2.2x the bytes bound at granite's
// decode shape, and int8 pages (half the bytes) take nearly as long as bf16 ones, so what is
// left is the latency of the scattered 80-160-byte row fetches per block, not the HBM
// rate; the span (128-512) and the ring depth (1-3) barely move it
// (scripts/paged_kernel_ab.py --constant).
//
// Rounding. The plain version (and the Pallas kernel) rounds the normalised
// probabilities to T before P V. A split cannot normalise; here each probability
// exp(s - m_running) of a split is rounded to T before P V, and the denominator sums the
// unrounded fp32 values. With T = fp32 nothing is rounded (1e-5 against the plain
// version); bf16 stays within its 2e-2 tolerance.
//
// Page types: the query's own type, bf16 under an fp32 query, or int8 / fp8 e4m3 codes
// with [P, Hkv] fp32 scale pools: a code is dequantized as the Pallas kernel does it,
// float(code) * scale[page, kv head] rounded to T, before the dot or the P V sum.
// Head dims 16, 64, 80 and 128 are instantiated; the wrapper raises for others.
#include <type_traits>

#include "paged.cuh"

namespace {

using namespace dolo;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 64;   // positions per staged tile
constexpr int kSpan = 256;  // positions per key split
constexpr int kStages = 2;  // depth of the cp.async page ring
constexpr int kQueries = kWarps;  // query rows per block: one warp runs each row's softmax
constexpr float kLog2e = 1.4426950408889634f;

struct DecodeArgs {
  const void* q;          // [S, W, Hq, D]
  const void* k_pages;    // [P, page_size, Hkv, D]
  const void* v_pages;
  const float* k_scales;  // [P, Hkv] for a quantized pool, else null
  const float* v_scales;
  const int* table;    // [S, max_pages]
  const int* lengths;  // [S]
  void* out;           // [S, W, Hq, D]
  float* partial_o;    // [groups, max_splits, kQueries, D] unnormalised split outputs
  float* partial_ml;   // [groups, max_splits, kQueries, 2] split max (log2 units), denominator
  int* counters;       // [groups] splits finished, zero between launches
  int width, num_q_heads, num_kv_heads, page_size, max_pages, max_splits, query_groups;
  float scale;
};

template <typename T, typename P, int D>
struct Layout {
  static constexpr int kLdPage = kPageRowStride<P, D>;
  static constexpr int kVectors = D / 8;            // 8-feature vectors of a row
  static constexpr int kKeysPerPass = 32 / kVectors;  // value rows a warp reads at once
  static constexpr int kKeyLanes = kWarps * kKeysPerPass;
  static constexpr size_t ring_bytes = kStages * 2 * kTile * kLdPage * sizeof(P);
  static constexpr size_t reduce_bytes = kKeyLanes * kQueries * D * sizeof(float);  // aliases the ring
  static constexpr size_t stage_bytes = ring_bytes > reduce_bytes ? ring_bytes : reduce_bytes;
  static constexpr size_t scale_bytes = is_quantized<P>::value ? kStages * 2 * kTile * sizeof(float) : 0;
  // then q [kQueries][D], the two half-dot rows [2][kQueries][kTile], probabilities
  // [kQueries][kTile], the rescales, maxima and denominators [3][kQueries], the ticket,
  // and the page-table entries of the span's positions (one more than kSpan / page_size
  // when a span starts mid-page)
  static constexpr size_t bytes = stage_bytes + scale_bytes +
                                  (kQueries * D + 3 * kQueries * kTile + 3 * kQueries + 4) * sizeof(float);
  static size_t with_table(int page_size) {
    return bytes + static_cast<size_t>((kSpan - 1) / page_size + 2) * sizeof(int);
  }
};

// dequantize a staged code as the reference does, round_to<T>(code * scale); other page
// types are used as they are
template <typename T, typename P>
__device__ __forceinline__ void dequant8(float (&x)[8], const float* scale) {
  if constexpr (is_quantized<P>::value) {
    const float s = *scale;
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = round_to<T>(__fmul_rn(x[e], s));
  }
}

template <typename T, typename P, int D>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(DecodeArgs args) {
  using L = Layout<T, P, D>;
  constexpr int kLdPage = L::kLdPage;
  constexpr int kHalf = D / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  P* ring = reinterpret_cast<P*>(smem_raw);
  float* reduce = reinterpret_cast<float*>(smem_raw);  // after the walk
  float* scales = reinterpret_cast<float*>(smem_raw + L::stage_bytes);
  float* qs = scales + (L::scale_bytes / sizeof(float));  // [kQueries][D]
  float* half_dots = qs + kQueries * D;                   // [2][kQueries][kTile]
  float* probs = half_dots + 2 * kQueries * kTile;        // [kQueries][kTile]
  float* rescale = probs + kQueries * kTile;              // [kQueries]
  float* row_max = rescale + kQueries;
  float* row_sum = row_max + kQueries;
  int* ticket = reinterpret_cast<int*>(row_sum + kQueries);
  int* span_pages = ticket + 4;  // the page-table entries of the span's positions

  const int split = blockIdx.x;
  const int kv_head = blockIdx.y / args.query_groups;
  const int query_group = blockIdx.y - kv_head * args.query_groups;
  const int slot = blockIdx.z;
  const int group_size = args.num_q_heads / args.num_kv_heads;
  const int rows = group_size * args.width;  // query rows of the kv head's group
  const int u0 = query_group * kQueries;  // the block's first query row
  const int key0 = split * kSpan;
  const int first_page = key0 / args.page_size;
  // the span's page-table entries within the row (those past the slot's frontier are
  // read but never used) and the query rows do not depend on the slot's length: their
  // loads go out together with the length's, so the block waits on one load latency
  // before its first tile, not three; a tile's fetch then finds its pages in shared
  // memory
  const int* table_row = args.table + static_cast<int64_t>(slot) * args.max_pages;
  const int row_pages = min((key0 + kSpan - 1) / args.page_size + 1, args.max_pages) - first_page;
  const int entry = threadIdx.x < row_pages ? table_row[first_page + threadIdx.x] : 0;
  // query row u of the group is (query head kv_head * group_size + u / W, window row u % W)
  auto q_offset = [&](int u) {
    const int head = kv_head * group_size + u / args.width;
    return ((static_cast<int64_t>(slot) * args.width + u % args.width) * args.num_q_heads + head) * D;
  };
  constexpr int kQLoads = (kQueries * D + kThreads - 1) / kThreads;
  float q_values[kQLoads];
#pragma unroll
  for (int k = 0; k < kQLoads; ++k) {
    const int i = threadIdx.x + k * kThreads;
    const int qi = i / D;
    q_values[k] = i < kQueries * D && u0 + qi < rows
                      ? to_float(static_cast<const T*>(args.q)[q_offset(u0 + qi) + (i - qi * D)])
                      : 0.f;
  }
  const int length = args.lengths[slot];
  const int view_len = args.max_pages * args.page_size;
  const int num_keys = min(length + args.width, view_len);  // positions the last row may see
  const int num_splits = (num_keys + kSpan - 1) / kSpan;
  if (split >= num_splits) return;
  const int key_end = min(key0 + kSpan, num_keys);
  const int num_tiles = (key_end - key0 + kTile - 1) / kTile;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < row_pages) span_pages[threadIdx.x] = entry;
  for (int i = threadIdx.x + kThreads; i < row_pages; i += kThreads) span_pages[i] = table_row[first_page + i];
#pragma unroll
  for (int k = 0; k < kQLoads; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i < kQueries * D) qs[i] = q_values[k];
  }
  __syncthreads();

  const PagePool<P> pool{static_cast<const P*>(args.k_pages) + static_cast<int64_t>(kv_head) * D,
                         static_cast<const P*>(args.v_pages) + static_cast<int64_t>(kv_head) * D,
                         args.k_scales, args.v_scales, static_cast<int64_t>(args.num_kv_heads) * D,
                         args.page_size, args.num_kv_heads, kv_head};
  const int* span_table = span_pages - first_page;  // indexed by the row's page number
  auto fetch = [&](int t, int stage) {
    P* k_dst = ring + stage * 2 * kTile * kLdPage;
    float* sc = scales + stage * 2 * kTile;
    fetch_page_tile<kTile, D, kThreads>(k_dst, k_dst + kTile * kLdPage, sc, sc + kTile, pool, span_table,
                                        key0 + t * kTile, key_end);
    cp_async_commit();
  };

  // the softmax of query row `warp`: this warp's running max and denominator
  const int my_u = u0 + warp;
  const int my_frontier = my_u < rows ? length + my_u % args.width : -1;
  const float scale_log2 = args.scale * kLog2e;
  float m = -INFINITY;
  float l = 0.f;
  // P V: lane -> (key lane, 8-feature vector); fp32 partial outputs of every query row
  const int key_lane = warp * L::kKeysPerPass + lane / L::kVectors;
  const int vec = lane % L::kVectors;
  const bool pv_lane = lane < L::kKeysPerPass * L::kVectors;
  float acc[kQueries][8];
#pragma unroll
  for (int qi = 0; qi < kQueries; ++qi)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[qi][e] = 0.f;
  // Q K: thread -> (key of the tile, half of the features)
  const int qk_key = threadIdx.x % kTile;
  const int qk_half = threadIdx.x / kTile;

  // the ring: tile t lives in stage t % kStages and its cp.async group is the t-th;
  // kStages - 1 tiles are in flight while one computes (groups past the last tile are
  // empty, so the count of pending groups stays the same)
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < num_tiles) fetch(t, t);
    else cp_async_commit();
  }
  for (int t = 0; t < num_tiles; ++t) {
    const int ahead = t + kStages - 1;
    if (ahead < num_tiles) fetch(ahead, ahead % kStages);
    else cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const int stage = t % kStages;
    const P* ks = ring + stage * 2 * kTile * kLdPage;
    const P* vs = ks + kTile * kLdPage;
    const float* sc = scales + stage * 2 * kTile;  // K scales, then V scales
    const int k0 = key0 + t * kTile;

    {  // half dot products q . k over this thread's half of the features
      float dot[kQueries];
#pragma unroll
      for (int qi = 0; qi < kQueries; ++qi) dot[qi] = 0.f;
      const P* key = ks + qk_key * kLdPage + qk_half * kHalf;
#pragma unroll
      for (int v = 0; v < kHalf / 8; ++v) {
        float x[8];
        load8(key + v * 8, x);
        dequant8<T, P>(x, sc + qk_key);
#pragma unroll
        for (int qi = 0; qi < kQueries; ++qi) {
          if (u0 + qi >= rows) break;
          const float* qv = qs + qi * D + qk_half * kHalf + v * 8;
#pragma unroll
          for (int e = 0; e < 8; ++e) dot[qi] = fmaf(qv[e], x[e], dot[qi]);
        }
      }
#pragma unroll
      for (int qi = 0; qi < kQueries; ++qi) half_dots[(qk_half * kQueries + qi) * kTile + qk_key] = dot[qi];
    }
    __syncthreads();

    {  // online softmax of row `warp` over the tile's 64 keys, two a lane
      float s[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int kk = lane + 32 * i;
        const int pos = k0 + kk;
        const float dot = half_dots[warp * kTile + kk] + half_dots[(kQueries + warp) * kTile + kk];
        s[i] = pos <= my_frontier && pos < key_end ? dot * scale_log2 : -INFINITY;
      }
      const float m_new = fmaxf(m, warp_max(fmaxf(s[0], s[1])));
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // nothing visible yet
      const float alpha = exp2f(m - m_use);
      const float p0 = exp2f(s[0] - m_use);
      const float p1 = exp2f(s[1] - m_use);
      l = l * alpha + warp_sum(p0 + p1);
      m = m_new;
      probs[warp * kTile + lane] = round_to<T>(p0);
      probs[warp * kTile + lane + 32] = round_to<T>(p1);
      if (lane == 0) rescale[warp] = alpha;
    }
    __syncthreads();

#pragma unroll
    for (int qi = 0; qi < kQueries; ++qi) {
      const float alpha = rescale[qi];
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[qi][e] *= alpha;
    }
    if (pv_lane) {
      for (int kk = key_lane; kk < kTile; kk += L::kKeyLanes) {
        float x[8];
        load8(vs + kk * kLdPage + vec * 8, x);
        dequant8<T, P>(x, sc + kTile + kk);
#pragma unroll
        for (int qi = 0; qi < kQueries; ++qi) {
          if (u0 + qi >= rows) break;
          const float p = probs[qi * kTile + kk];
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[qi][e] = fmaf(p, x[e], acc[qi][e]);
        }
      }
    }
    __syncthreads();  // the stage is refilled next
  }

  // sum the key lanes' partial outputs (the ring is free now), in a fixed order
  if (pv_lane) {
#pragma unroll
    for (int qi = 0; qi < kQueries; ++qi)
#pragma unroll
      for (int e = 0; e < 8; ++e) reduce[(key_lane * kQueries + qi) * D + vec * 8 + e] = acc[qi][e];
  }
  if (lane == 0) {
    row_max[warp] = m;
    row_sum[warp] = l;
  }
  __syncthreads();
  const int group = (slot * args.num_kv_heads + kv_head) * args.query_groups + query_group;
  const int64_t part = static_cast<int64_t>(group) * args.max_splits + split;
  T* out = static_cast<T*>(args.out);
  for (int i = threadIdx.x; i < kQueries * D; i += kThreads) {
    const int qi = i / D;
    const int d = i - qi * D;
    if (u0 + qi >= rows) continue;
    float o = 0.f;
    for (int k = 0; k < L::kKeyLanes; ++k) o += reduce[(k * kQueries + qi) * D + d];
    if (num_splits == 1) {
      out[q_offset(u0 + qi) + d] = from_float<T>(o / row_sum[qi]);
    } else {
      args.partial_o[part * kQueries * D + i] = o;
    }
  }
  if (num_splits == 1) return;
  if (threadIdx.x < kQueries) {
    args.partial_ml[(part * kQueries + threadIdx.x) * 2] = row_max[threadIdx.x];
    args.partial_ml[(part * kQueries + threadIdx.x) * 2 + 1] = row_sum[threadIdx.x];
  }

  // the last split of the group to finish merges them all
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *ticket = atomicAdd(args.counters + group, 1);
  __syncthreads();
  if (*ticket != num_splits - 1) return;
  __threadfence();
  const int64_t first = static_cast<int64_t>(group) * args.max_splits;
  for (int i = threadIdx.x; i < kQueries * D; i += kThreads) {
    const int qi = i / D;
    if (u0 + qi >= rows) continue;
    float m_max = -INFINITY;
    for (int s = 0; s < num_splits; ++s) m_max = fmaxf(m_max, __ldcg(args.partial_ml + ((first + s) * kQueries + qi) * 2));
    float total = 0.f;
    float o = 0.f;
    for (int s = 0; s < num_splits; ++s) {
      const float m_split = __ldcg(args.partial_ml + ((first + s) * kQueries + qi) * 2);
      const float w = exp2f(m_split - m_max);
      total += w * __ldcg(args.partial_ml + ((first + s) * kQueries + qi) * 2 + 1);
      o += w * __ldcg(args.partial_o + (first + s) * kQueries * D + i);
    }
    out[q_offset(u0 + qi) + (i - qi * D)] = from_float<T>(o / total);
  }
  if (threadIdx.x == 0) args.counters[group] = 0;  // ready for the next launch
}

template <typename T, typename P, int D>
cudaError_t launch(const DecodeArgs& args, int num_slots, cudaStream_t stream) {
  if (is_quantized<P>::value && (args.k_scales == nullptr || args.v_scales == nullptr))
    return cudaErrorInvalidValue;
  const size_t smem = Layout<T, P, D>::with_table(args.page_size);
  auto kernel = paged_decode_kernel<T, P, D>;
  cudaError_t err = allow_shared_memory(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(args.max_splits, args.num_kv_heads * args.query_groups, num_slots);
  kernel<<<grid, kThreads, smem, stream>>>(args);
  return cudaGetLastError();
}

template <typename T, typename P>
cudaError_t dispatch_dim(const DecodeArgs& args, int num_slots, int head_dim, cudaStream_t stream) {
  switch (head_dim) {
    case 16:
      return launch<T, P, 16>(args, num_slots, stream);
    case 64:
      return launch<T, P, 64>(args, num_slots, stream);
    case 80:
      return launch<T, P, 80>(args, num_slots, stream);
    case 128:
      return launch<T, P, 128>(args, num_slots, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// the page types a T query reads: its own, bf16, int8 or fp8 e4m3 codes
template <typename T>
cudaError_t dispatch_pages(const DecodeArgs& args, int num_slots, int head_dim, int page_dtype,
                           cudaStream_t stream) {
  switch (page_dtype) {
    case dolo::kFloat32:
      if constexpr (std::is_same<T, float>::value) return dispatch_dim<T, float>(args, num_slots, head_dim, stream);
      return cudaErrorInvalidValue;  // fp32 pages under a bf16 query
    case dolo::kBFloat16:
      return dispatch_dim<T, __nv_bfloat16>(args, num_slots, head_dim, stream);
    case dolo::kInt8:
      return dispatch_dim<T, int8_t>(args, num_slots, head_dim, stream);
    case dolo::kFloat8E4M3:
      return dispatch_dim<T, __nv_fp8_e4m3>(args, num_slots, head_dim, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Scratch the wrapper allocates for one launch: query groups per kv head, the most key
// splits of a slot, and the floats a split's partial takes per group (outputs, then
// max / denominator pairs). kSpan and kQueries live here only.
extern "C" int dolo_paged_decode_plan(int num_q_heads, int num_kv_heads, int width, int view_len,
                                      int* plan) {
  plan[0] = (num_q_heads / num_kv_heads * width + kQueries - 1) / kQueries;
  plan[1] = (view_len + kSpan - 1) / kSpan;
  plan[2] = kQueries;
  return 0;
}

extern "C" int dolo_paged_decode(const void* q, const void* k_pages, const void* v_pages,
                                 const void* k_scales, const void* v_scales, const void* table,
                                 const void* lengths, void* out, void* partial_o, void* partial_ml,
                                 void* counters, int num_slots, int width, int num_q_heads,
                                 int num_kv_heads, int head_dim, int page_size, int max_pages,
                                 float scale, int dtype, int page_dtype, void* stream) {
  if (num_slots <= 0) return cudaSuccess;
  int plan[3];
  dolo_paged_decode_plan(num_q_heads, num_kv_heads, width, max_pages * page_size, plan);
  const DecodeArgs args{q, k_pages, v_pages, static_cast<const float*>(k_scales),
                        static_cast<const float*>(v_scales), static_cast<const int*>(table),
                        static_cast<const int*>(lengths), out, static_cast<float*>(partial_o),
                        static_cast<float*>(partial_ml), static_cast<int*>(counters), width,
                        num_q_heads, num_kv_heads, page_size, max_pages, plan[1], plan[0], scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case dolo::kFloat32:
      return dispatch_pages<float>(args, num_slots, head_dim, page_dtype, s);
    case dolo::kBFloat16:
      return dispatch_pages<__nv_bfloat16>(args, num_slots, head_dim, page_dtype, s);
    default:
      return cudaErrorInvalidValue;
  }
}
