// Flash attention with packed-document segment ids, forward and backward, in two forms.
//
// Replaces the attention kernels the JAX training path takes from jax's Pallas library:
// splash attention (`_tpu_splash_attention`, dolomite_engine_tpu/ops/attention.py:330)
// with a causal mask and `SegmentIds(q=s, kv=s)`, and jax's flash kernel
// (`_tpu_flash_attention`, :379) in the forms splash does not take: an additive bias
// (kBias: alibi) and no causal mask (kCausal false). Query i attends key j when
// seg[i] == seg[j] and, if causal, j <= i; pad tokens (segment 0) attend among
// themselves, so no row is empty. GQA: query head h reads kv head h / (Hq / Hkv).
//
// The bias is one fp32 row per (batch, query head) over the keys ([B, Hq, S], 256 B per
// key tile), never jax's [B, H, Sq, Sk] `ab` (1.07 GB per call at [2, 2048, 32 heads]).
// The score is q.k * scale + bias[k] (the JAX package's XLA function; jax's kernel adds
// `ab` before the scale), less the row's own-position bias bias[i]: softmax is
// invariant to a per-row constant, and the shift keeps the scores near the diagonal
// small, so fp32 keeps the digits of q.k beside alibi biases of ~1700 at 2048 tokens.
// Scores run in log2 units (exp2): the bias enters times log2(e), in the forward and in
// both backward recomputes of P, which must match the logsumexp the forward stored (of
// the shifted scores, natural log).
//
// Bound on the H100: operations for long documents — at [1, 4096, 32, 80] one causal
// document is 4 * S^2/2 * D * H ~ 86 GFLOP against ~84 MB of q/k/v/o — but packed
// documents cut the operations to the pairs inside each document, and at 6 documents in
// 4096 tokens the bytes bound it (0.025 ms of bytes against 0.015 ms of operations).
//
// Segment ranges: one pre-pass per call (a launch of its own in the forward, blocks of
// the delta launch in the backward; one block a batch row) reduces every 64-token tile's
// segment ids to a (min, max) range and finds the first and last tile whose range meets
// it: [B, S / 64] int4. The kernels walk only that window of tiles (at or below the
// diagonal when causal), and in it only the tiles whose range meets their own: a packed
// batch touches only the tiles near each document's diagonal, and the walk to a
// document's first tile costs nothing. A tile that lies inside one document on both
// sides (and off the diagonal) skips the mask.
//
// bf16 (namespace `wg`, every training shape): Hopper's TMA, mbarrier ring and `wgmma`
// (csrc/sm90.cuh). A CTA is two consumer warpgroups and a producer warpgroup, which hands
// them its registers (setmaxnreg). One thread of the producer keeps TMA loads in flight through a ring of kStages stages with full /
// empty mbarriers; each stage holds a 64-token tile of two operands (K and V, or Q and
// dO) and the tile's segment ids (plus its bias row, or its logsumexp, delta and query
// bias). Rows live in shared memory as 64-column panels with the 128-byte swizzle; q, k,
// v and dO are 4-D tensor maps {D, H, S, B} of the strided views, so a head dim of 80
// reads a second panel whose columns past 80 the copy engine zero-fills, and no product
// reads them (reductions over the head dim take five k16 steps, products whose columns
// are the head dim run N = 80). Each consumer warpgroup owns 64 rows and keeps its state
// in registers; P is exponentiated by `ex2.approx`. ptxas gives a CTA of 12 warps 168
// registers a thread and serializes `wgmma` products issued under control flow it cannot
// prove warpgroup-uniform, so every step issues the same products (a skipped tile's go
// unread or multiply zeros) under broadcast (`uniform`) conditions.
//   1. Forward: a CTA per (128 query rows, q head, batch row). The warpgroups take turns
//      at the tensor cores (named barriers); a turn issues S = Q K^T of this tile and
//      O += P V of the previous one (P the register A operand), so one warpgroup's
//      softmax runs while the other's products do. Writes O and the fp32 row logsumexp.
//   2. delta = rowsum(dO * O) per (row, q head), and the ranges.
//   3. dK/dV: a CTA per (64-key tile, kv head, batch row) holds K and V; the producer
//      streams the (q head of its GQA group, 64-query tile) items whose segments meet
//      the keys. Warpgroup 0 computes S^T = K Q^T, P^T under the masks and dV += P^T dO;
//      warpgroup 1 computes dP^T = V dO^T, takes P^T through shared memory (two
//      buffers), dS^T = P^T (dP^T - delta) and dK += dS^T Q.
//   4. dQ: a CTA per (128 query rows, q head, batch row) holds Q and dO and walks the
//      key tiles as the forward does, the warpgroups taking turns at S and dP; then dS
//      and dQ += dS K.
// No atomics: dQ / dK / dV are bit-identical from run to run. Rows past the sequence in
// a half-full last 128-row tile (S % 128 == 64) are zero-filled by the copy engine and
// never stored.
//
// fp32 (never on a training path): the same walk in 64 x 64 tiles of 4 warps, scalar
// FMA on the CUDA cores through a one-stage cp.async walk, P through shared memory.
#include <type_traits>

#include "mma.cuh"
#include "sm90.cuh"

namespace {

using namespace dolo;

constexpr int kTile = 64;  // tokens of a segment range; key and query tile of the fp32 path
constexpr float kLog2e = 1.4426950408889634f;

struct FlashArgs {
  const void* q;      // [B, S, Hq, D], tokens q_stride elements apart
  const void* k;      // [B, S, Hkv, D], tokens k_stride apart
  const void* v;      // [B, S, Hkv, D], tokens v_stride apart
  const int* seg;     // [B, S]
  const float* bias;  // [B, Hq, S] additive key bias (kBias), or null
  const void* out;    // [B, S, Hq, D] contiguous (backward: the forward's output)
  const void* dout;   // [B, S, Hq, D] contiguous
  float* lse;         // [B, Hq, S] natural-log row logsumexp of the scaled scores
  float* delta;       // [B, Hq, S] rowsum(dO * O)
  int4* ranges;       // [B, S / 64] per 64-token tile: (min, max) segment id, first and last tile it meets
  void* o_write;      // forward output
  void* dq;           // [B, S, Hq, D] contiguous
  void* dk;           // [B, S, Hkv, D] contiguous
  void* dv;
  int seq, num_q_heads, num_kv_heads;
  int q_stride, k_stride, v_stride;
  float scale;
};

// whether two tiles ((min, max) segment ids in .x, .y) can hold a pair of equal ids
template <typename A, typename B>
__device__ __forceinline__ bool meets(A a, B b) {
  return a.y >= b.x && a.x <= b.y;
}

// whether every pair of two tiles is in one segment (no segment mask needed)
__device__ __forceinline__ bool one_segment(int4 a, int4 b) { return a.x == a.y && b.x == b.y && a.x == b.x; }

// one past the last 64-key tile a query block whose last 64-token tile is qt may attend:
// that tile when causal
template <bool kCausal>
__device__ __forceinline__ int key_tile_end(int qt, int num_tiles) {
  return kCausal ? qt + 1 : num_tiles;
}

// the score term of the additive bias in log2 units: key k's bias less the query row's
// own-position bias
__device__ __forceinline__ float bias_log2(float key_bias, float row_bias) {
  return (key_bias - row_bias) * kLog2e;
}

// The dK/dV walk of key tile kt: work item p = (q head of the GQA group) * num_tiles +
// query tile, over the query tiles of kt's window (from kt up when causal: at or below
// the key tile's diagonal) whose range meets kt's. `next(p)` is the first item at or
// after p.
template <bool kCausal>
__device__ __forceinline__ auto item_walk(const int4* ranges, int4 k_range, int kt, int num_tiles, int end) {
  const int lo = kCausal ? max(kt, k_range.z) : k_range.z;
  const int hi = k_range.w;
  return [=](int p) {
    while (p < end) {
      const int qt = p % num_tiles;
      if (qt < lo) {
        p += lo - qt;
      } else if (qt > hi) {
        p += num_tiles - qt;  // the next q head's tiles
      } else if (!meets(ranges[qt], k_range)) {
        ++p;
      } else {
        break;
      }
    }
    return p;
  };
}

// The ranges of batch row b (one block): ranges[b, t] = (min, max) segment id of the
// 64-token tile t, then the first and last tile whose range meets it. `span` holds the
// row's (min, max) in shared memory.
__device__ void row_ranges(const FlashArgs& args, int b, int num_tiles, int2* span) {
  const int lane = threadIdx.x & 31;
  const int* seg = args.seg + static_cast<int64_t>(b) * args.seq;
  for (int t = threadIdx.x >> 5; t < num_tiles; t += blockDim.x >> 5) {
    const int x = seg[t * kTile + lane];
    const int y = seg[t * kTile + 32 + lane];
    const int lo = __reduce_min_sync(0xffffffffu, min(x, y));
    const int hi = __reduce_max_sync(0xffffffffu, max(x, y));
    if (lane == 0) span[t] = make_int2(lo, hi);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < num_tiles; t += blockDim.x) {
    const int2 r = span[t];
    int first = num_tiles, last = -1;
    for (int u = 0; u < num_tiles; ++u) {
      if (meets(span[u], r)) {
        first = min(first, u);
        last = u;
      }
    }
    args.ranges[static_cast<int64_t>(b) * num_tiles + t] = make_int4(r.x, r.y, first, last);
  }
}

__global__ void __launch_bounds__(256) flash_ranges_kernel(FlashArgs args, int num_tiles) {
  extern __shared__ int2 span[];
  row_ranges(args, blockIdx.x, num_tiles, span);
}

// delta[b, h, s] = sum_d dO[b, s, h, d] * O[b, s, h, d]: eight lanes per (token, head)
// row, 16-byte loads (a warp reads four consecutive rows); the blocks past
// `delta_blocks` compute the ranges, one a batch row
constexpr int kDeltaRows = 32;  // rows of a 256-thread block

template <typename T>
__global__ void __launch_bounds__(256)
    flash_delta_kernel(FlashArgs args, int head_dim, int64_t num_rows, int delta_blocks, int num_tiles) {
  extern __shared__ int2 span[];
  if (static_cast<int>(blockIdx.x) >= delta_blocks) {
    row_ranges(args, blockIdx.x - delta_blocks, num_tiles, span);
    return;
  }
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kDeltaRows + threadIdx.x / 8;
  const int sub = threadIdx.x % 8;
  constexpr int kVec = 16 / sizeof(T);
  float sum = 0.f;
  if (row < num_rows) {
    const uint4* o = reinterpret_cast<const uint4*>(static_cast<const T*>(args.out) + row * head_dim);
    const uint4* d = reinterpret_cast<const uint4*>(static_cast<const T*>(args.dout) + row * head_dim);
    for (int i = sub; i < head_dim / kVec; i += 8) {
      const uint4 a = o[i], b = d[i];
      const T* ta = reinterpret_cast<const T*>(&a);
      const T* tb = reinterpret_cast<const T*>(&b);
#pragma unroll
      for (int e = 0; e < kVec; ++e) sum += to_float(ta[e]) * to_float(tb[e]);
    }
  }
#pragma unroll
  for (int offset = 4; offset > 0; offset >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, offset);
  if (row < num_rows && sub == 0) {
    const int hq = args.num_q_heads;
    const int64_t token = row / hq;
    const int head = static_cast<int>(row - token * hq);
    const int64_t b = token / args.seq;
    args.delta[(b * hq + head) * args.seq + (token - b * args.seq)] = sum;
  }
}

// ------------------------------------------------------------------ fp32: scalar FMA tiles

namespace fp32 {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kLdP = kTile + 8;  // row stride of the P / dS tiles

template <int D>
constexpr size_t fwd_smem_bytes() {
  // Q, K, V, P, the key tile's segment ids and bias
  return (3 * kTile * (D + 8) + kTile * kLdP) * sizeof(float) + 2 * kTile * sizeof(int);
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return (4 * kTile * (D + 8) + kTile * kLdP) * sizeof(float) + 2 * kTile * sizeof(int);
}

template <int D>
constexpr size_t dkdv_smem_bytes() {
  // K, V, Q, dO, P^T and dS^T, the query tile's segment ids, logsumexp, delta and bias
  return (4 * kTile * (D + 8) + 2 * kTile * kLdP) * sizeof(float) + 4 * kTile * sizeof(int);
}

// Walk the work items in `next(first)` order: `fetch(item)` starts an item's loads,
// `compute(item)` uses them.
template <typename Next, typename Fetch, typename Compute>
__device__ __forceinline__ void walk(int item, int end, Next next, Fetch fetch, Compute compute) {
  while (item < end) {
    fetch(item);
    cp_async_wait<0>();
    __syncthreads();
    compute(item);
    __syncthreads();  // the buffers are refilled next
    item = next(item + 1);
  }
}

template <int D, bool kBias, bool kCausal>
__global__ void __launch_bounds__(kThreads) fwd_kernel(FlashArgs args) {
  constexpr int LD = D + 8;
  constexpr int NTD = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* ks = qs + kTile * LD;
  float* vs = ks + kTile * LD;
  float* ps = vs + kTile * LD;
  int* segk = reinterpret_cast<int*>(ps + kTile * kLdP);
  float* biask = reinterpret_cast<float*>(segk + kTile);

  const int seq = args.seq;
  const int num_tiles = seq / kTile;
  const int qt = num_tiles - 1 - blockIdx.x;  // the longest rows first
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kv_head = head / (args.num_q_heads / args.num_kv_heads);
  const int q0 = qt * kTile;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
  const int64_t tok0 = static_cast<int64_t>(b) * seq;
  const int* seg_row = args.seg + tok0;
  const int4* ranges = args.ranges + static_cast<int64_t>(b) * num_tiles;
  const int4 q_range = ranges[qt];
  const int end = min(key_tile_end<kCausal>(qt, num_tiles), q_range.w + 1);
  const float* k_base = static_cast<const float*>(args.k) + tok0 * args.k_stride + static_cast<int64_t>(kv_head) * D;
  const float* v_base = static_cast<const float*>(args.v) + tok0 * args.v_stride + static_cast<int64_t>(kv_head) * D;
  const float* bias_row = kBias ? args.bias + (static_cast<int64_t>(b) * args.num_q_heads + head) * seq : nullptr;

  cp_async_tile(qs, LD, static_cast<const float*>(args.q) + (tok0 + q0) * args.q_stride + static_cast<int64_t>(head) * D,
                args.q_stride, kTile, D);
  cp_async_commit();
  auto next = [&](int t) {
    while (t < end && !meets(ranges[t], q_range)) ++t;
    return t;
  };
  auto fetch = [&](int t) {
    cp_async_tile(ks, LD, k_base + static_cast<int64_t>(t) * kTile * args.k_stride, args.k_stride, kTile, D);
    cp_async_tile(vs, LD, v_base + static_cast<int64_t>(t) * kTile * args.v_stride, args.v_stride, kTile, D);
    cp_async_tile(segk, kTile, seg_row + t * kTile, 0, 1, kTile);
    if constexpr (kBias) cp_async_tile(biask, kTile, bias_row + t * kTile, 0, 1, kTile);
    cp_async_commit();
  };

  const int rows[2] = {warp * 16 + g, warp * 16 + g + 8};
  const int row_seg[2] = {seg_row[q0 + rows[0]], seg_row[q0 + rows[1]]};
  float row_bias[2] = {0.f, 0.f};
  if constexpr (kBias) {
    row_bias[0] = bias_row[q0 + rows[0]];
    row_bias[1] = bias_row[q0 + rows[1]];
  }
  const float scale_log2 = args.scale * kLog2e;
  float m[2] = {-INFINITY, -INFINITY};  // running max of the scaled scores (log2 units)
  float l[2] = {0.f, 0.f};              // this lane's share of the denominator
  float o[1][NTD][4];
  zero_acc(o);

  walk(next(q_range.z), end, next, fetch, [&](int kt) {
    const int k0 = kt * kTile;
    float s[1][8][4];
    zero_acc(s);
    warp_gemm<1, 8, true>(s, qs + warp * 16 * LD, LD, ks, LD, D);
    float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int h = i >> 1;
        const int col = nt * 8 + 2 * c + (i & 1);
        const bool ok = (!kCausal || k0 + col <= q0 + rows[h]) && segk[col] == row_seg[h];
        float score = s[0][nt][i] * scale_log2;
        if constexpr (kBias) score += bias_log2(biask[col], row_bias[h]);
        s[0][nt][i] = ok ? score : -INFINITY;
        tile_max[h] = fmaxf(tile_max[h], s[0][nt][i]);
      }
    float m_use[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m[h], quad_max(tile_max[h]));
      m_use[h] = m_new == -INFINITY ? 0.f : m_new;  // a row with nothing visible yet
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
        s[0][nt][i] = exp2f(s[0][nt][i] - m_use[i >> 1]);
        l[i >> 1] += s[0][nt][i];
      }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) store_pair(ps + rows[h] * kLdP + nt * 8 + 2 * c, s[0][nt][2 * h], s[0][nt][2 * h + 1]);
    __syncwarp();
    warp_gemm<1, NTD, false>(o, ps + warp * 16 * kLdP, kLdP, vs, LD, kTile);
  });

  float* out = static_cast<float*>(args.o_write);
  const int hq = args.num_q_heads;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float total = quad_sum(l[h]);
    const float inv = 1.f / total;
    float* dst = out + ((tok0 + q0 + rows[h]) * hq + head) * D;
#pragma unroll
    for (int nt = 0; nt < NTD; ++nt) store_pair(dst + nt * 8 + 2 * c, o[0][nt][2 * h] * inv, o[0][nt][2 * h + 1] * inv);
    if (c == 0)
      args.lse[(static_cast<int64_t>(b) * hq + head) * seq + q0 + rows[h]] = (m[h] + log2f(total)) / kLog2e;
  }
}

template <int D, bool kBias, bool kCausal>
__global__ void __launch_bounds__(kThreads) dkdv_kernel(FlashArgs args) {
  constexpr int LD = D + 8;
  constexpr int NTD = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);
  float* vs = ks + kTile * LD;
  float* qs = vs + kTile * LD;
  float* dos = qs + kTile * LD;
  float* ps = dos + kTile * LD;  // P^T, dS^T [kTile][kLdP] each
  float* dss = ps + kTile * kLdP;
  int* segq = reinterpret_cast<int*>(dss + kTile * kLdP);  // seg, lse, delta, query bias [kTile] each
  const float* lse = reinterpret_cast<const float*>(segq + kTile);
  const float* delta = lse + kTile;
  const float* qbias = delta + kTile;

  const int seq = args.seq;
  const int num_tiles = seq / kTile;
  const int kt = blockIdx.x;  // the longest column walks first
  const int kv_head = blockIdx.y;
  const int b = blockIdx.z;
  const int hq = args.num_q_heads;
  const int group = hq / args.num_kv_heads;
  const int k0 = kt * kTile;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
  const int64_t tok0 = static_cast<int64_t>(b) * seq;
  const int* seg_row = args.seg + tok0;
  const int4* ranges = args.ranges + static_cast<int64_t>(b) * num_tiles;
  const float* q = static_cast<const float*>(args.q);
  const float* dout = static_cast<const float*>(args.dout);

  cp_async_tile(ks, LD, static_cast<const float*>(args.k) + (tok0 + k0) * args.k_stride + static_cast<int64_t>(kv_head) * D,
                args.k_stride, kTile, D);
  cp_async_tile(vs, LD, static_cast<const float*>(args.v) + (tok0 + k0) * args.v_stride + static_cast<int64_t>(kv_head) * D,
                args.v_stride, kTile, D);
  cp_async_commit();
  const int4 k_range = ranges[kt];
  const int end = group * num_tiles;
  const auto next = item_walk<kCausal>(ranges, k_range, kt, num_tiles, end);
  auto fetch = [&](int p) {
    const int head = kv_head * group + p / num_tiles;
    const int q0 = (p % num_tiles) * kTile;
    const int64_t stat0 = (static_cast<int64_t>(b) * hq + head) * seq + q0;
    cp_async_tile(qs, LD, q + (tok0 + q0) * args.q_stride + static_cast<int64_t>(head) * D, args.q_stride, kTile, D);
    cp_async_tile(dos, LD, dout + ((tok0 + q0) * hq + head) * D, static_cast<int64_t>(hq) * D, kTile, D);
    cp_async_tile(segq, kTile, seg_row + q0, 0, 1, kTile);
    cp_async_tile(segq + kTile, kTile, reinterpret_cast<const int*>(args.lse + stat0), 0, 1, kTile);
    cp_async_tile(segq + 2 * kTile, kTile, reinterpret_cast<const int*>(args.delta + stat0), 0, 1, kTile);
    if constexpr (kBias)
      cp_async_tile(segq + 3 * kTile, kTile, reinterpret_cast<const int*>(args.bias + stat0), 0, 1, kTile);
    cp_async_commit();
  };

  const int rows[2] = {warp * 16 + g, warp * 16 + g + 8};  // this lane's key rows
  const int row_seg[2] = {seg_row[k0 + rows[0]], seg_row[k0 + rows[1]]};
  const float scale_log2 = args.scale * kLog2e;
  float dk[1][NTD][4], dv[1][NTD][4];
  zero_acc(dk);
  zero_acc(dv);

  walk(next(0), end, next, fetch, [&](int p) {
    const int q0 = (p % num_tiles) * kTile;
    float key_bias[2] = {0.f, 0.f};  // this lane's key rows' bias under the item's q head
    if constexpr (kBias) {
      const float* bias_row = args.bias + (static_cast<int64_t>(b) * hq + kv_head * group + p / num_tiles) * seq;
      key_bias[0] = bias_row[k0 + rows[0]];
      key_bias[1] = bias_row[k0 + rows[1]];
    }
    float st[1][8][4];  // S^T: rows = keys, cols = queries
    zero_acc(st);
    warp_gemm<1, 8, true>(st, ks + warp * 16 * LD, LD, qs, LD, D);
    float dpt[1][8][4];  // (dO V^T)^T
    zero_acc(dpt);
    warp_gemm<1, 8, true>(dpt, vs + warp * 16 * LD, LD, dos, LD, D);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = nt * 8 + 2 * c + (i & 1);
        const bool ok = (!kCausal || k0 + rows[i >> 1] <= q0 + col) && segq[col] == row_seg[i >> 1];
        float pt_score = st[0][nt][i] * scale_log2;
        if constexpr (kBias) pt_score += bias_log2(key_bias[i >> 1], qbias[col]);
        const float pt = ok ? exp2f(pt_score - lse[col] * kLog2e) : 0.f;
        st[0][nt][i] = pt;
        dpt[0][nt][i] = pt * (dpt[0][nt][i] - delta[col]);  // dS^T
      }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        store_pair(ps + rows[h] * kLdP + nt * 8 + 2 * c, st[0][nt][2 * h], st[0][nt][2 * h + 1]);
        store_pair(dss + rows[h] * kLdP + nt * 8 + 2 * c, dpt[0][nt][2 * h], dpt[0][nt][2 * h + 1]);
      }
    __syncwarp();
    warp_gemm<1, NTD, false>(dv, ps + warp * 16 * kLdP, kLdP, dos, LD, kTile);
    warp_gemm<1, NTD, false>(dk, dss + warp * 16 * kLdP, kLdP, qs, LD, kTile);
  });

  float* dk_out = static_cast<float*>(args.dk);
  float* dv_out = static_cast<float*>(args.dv);
  const int hkv = args.num_kv_heads;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t offset = ((tok0 + k0 + rows[h]) * hkv + kv_head) * D;
#pragma unroll
    for (int nt = 0; nt < NTD; ++nt) {
      store_pair(dk_out + offset + nt * 8 + 2 * c, dk[0][nt][2 * h] * args.scale, dk[0][nt][2 * h + 1] * args.scale);
      store_pair(dv_out + offset + nt * 8 + 2 * c, dv[0][nt][2 * h], dv[0][nt][2 * h + 1]);
    }
  }
}

template <int D, bool kBias, bool kCausal>
__global__ void __launch_bounds__(kThreads) dq_kernel(FlashArgs args) {
  constexpr int LD = D + 8;
  constexpr int NTD = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* dos = qs + kTile * LD;
  float* ks = dos + kTile * LD;
  float* vs = ks + kTile * LD;
  float* dss = vs + kTile * LD;  // dS [kTile][kLdP]
  int* segk = reinterpret_cast<int*>(dss + kTile * kLdP);
  float* biask = reinterpret_cast<float*>(segk + kTile);

  const int seq = args.seq;
  const int num_tiles = seq / kTile;
  const int qt = num_tiles - 1 - blockIdx.x;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int hq = args.num_q_heads;
  const int kv_head = head / (hq / args.num_kv_heads);
  const int q0 = qt * kTile;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
  const int64_t tok0 = static_cast<int64_t>(b) * seq;
  const int64_t stat0 = (static_cast<int64_t>(b) * hq + head) * seq + q0;
  const int* seg_row = args.seg + tok0;
  const int4* ranges = args.ranges + static_cast<int64_t>(b) * num_tiles;
  const int4 q_range = ranges[qt];
  const int end = min(key_tile_end<kCausal>(qt, num_tiles), q_range.w + 1);
  const float* k_base = static_cast<const float*>(args.k) + tok0 * args.k_stride + static_cast<int64_t>(kv_head) * D;
  const float* v_base = static_cast<const float*>(args.v) + tok0 * args.v_stride + static_cast<int64_t>(kv_head) * D;
  const float* bias_row = kBias ? args.bias + (static_cast<int64_t>(b) * hq + head) * seq : nullptr;

  cp_async_tile(qs, LD, static_cast<const float*>(args.q) + (tok0 + q0) * args.q_stride + static_cast<int64_t>(head) * D,
                args.q_stride, kTile, D);
  cp_async_tile(dos, LD, static_cast<const float*>(args.dout) + ((tok0 + q0) * hq + head) * D,
                static_cast<int64_t>(hq) * D, kTile, D);
  cp_async_commit();
  auto next = [&](int t) {
    while (t < end && !meets(ranges[t], q_range)) ++t;
    return t;
  };
  auto fetch = [&](int t) {
    cp_async_tile(ks, LD, k_base + static_cast<int64_t>(t) * kTile * args.k_stride, args.k_stride, kTile, D);
    cp_async_tile(vs, LD, v_base + static_cast<int64_t>(t) * kTile * args.v_stride, args.v_stride, kTile, D);
    cp_async_tile(segk, kTile, seg_row + t * kTile, 0, 1, kTile);
    if constexpr (kBias) cp_async_tile(biask, kTile, bias_row + t * kTile, 0, 1, kTile);
    cp_async_commit();
  };

  const int rows[2] = {warp * 16 + g, warp * 16 + g + 8};
  const int row_seg[2] = {seg_row[q0 + rows[0]], seg_row[q0 + rows[1]]};
  float row_bias[2] = {0.f, 0.f};
  if constexpr (kBias) {
    row_bias[0] = bias_row[q0 + rows[0]];
    row_bias[1] = bias_row[q0 + rows[1]];
  }
  const float row_lse[2] = {args.lse[stat0 + rows[0]] * kLog2e, args.lse[stat0 + rows[1]] * kLog2e};
  const float row_delta[2] = {args.delta[stat0 + rows[0]], args.delta[stat0 + rows[1]]};
  const float scale_log2 = args.scale * kLog2e;
  float dq[1][NTD][4];
  zero_acc(dq);

  walk(next(q_range.z), end, next, fetch, [&](int kt) {
    const int k0 = kt * kTile;
    float s[1][8][4];
    zero_acc(s);
    warp_gemm<1, 8, true>(s, qs + warp * 16 * LD, LD, ks, LD, D);
    float dp[1][8][4];
    zero_acc(dp);
    warp_gemm<1, 8, true>(dp, dos + warp * 16 * LD, LD, vs, LD, D);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int h = i >> 1;
        const int col = nt * 8 + 2 * c + (i & 1);
        const bool ok = (!kCausal || k0 + col <= q0 + rows[h]) && segk[col] == row_seg[h];
        float score = s[0][nt][i] * scale_log2;
        if constexpr (kBias) score += bias_log2(biask[col], row_bias[h]);
        const float p = ok ? exp2f(score - row_lse[h]) : 0.f;
        s[0][nt][i] = p * (dp[0][nt][i] - row_delta[h]);  // dS
      }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) store_pair(dss + rows[h] * kLdP + nt * 8 + 2 * c, s[0][nt][2 * h], s[0][nt][2 * h + 1]);
    __syncwarp();
    warp_gemm<1, NTD, false>(dq, dss + warp * 16 * kLdP, kLdP, ks, LD, kTile);
  });

  float* dq_out = static_cast<float*>(args.dq);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float* dst = dq_out + ((tok0 + q0 + rows[h]) * hq + head) * D;
#pragma unroll
    for (int nt = 0; nt < NTD; ++nt)
      store_pair(dst + nt * 8 + 2 * c, dq[0][nt][2 * h] * args.scale, dq[0][nt][2 * h + 1] * args.scale);
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream, const FlashArgs& args) {
  cudaError_t err = allow_shared_memory(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(args);
  return cudaGetLastError();
}

template <int D, bool kBias, bool kCausal>
cudaError_t launch_fwd(const FlashArgs& args, int batch, cudaStream_t stream) {
  return launch(fwd_kernel<D, kBias, kCausal>, dim3(args.seq / kTile, args.num_q_heads, batch), fwd_smem_bytes<D>(),
                stream, args);
}

template <int D, bool kBias, bool kCausal>
cudaError_t launch_bwd(const FlashArgs& args, int batch, cudaStream_t stream) {
  cudaError_t err = launch(dkdv_kernel<D, kBias, kCausal>, dim3(args.seq / kTile, args.num_kv_heads, batch),
                           dkdv_smem_bytes<D>(), stream, args);
  if (err != cudaSuccess) return err;
  return launch(dq_kernel<D, kBias, kCausal>, dim3(args.seq / kTile, args.num_q_heads, batch), dq_smem_bytes<D>(),
                stream, args);
}

}  // namespace fp32

// ------------------------------------------------------------------- bf16: wgmma and TMA

namespace wg {

constexpr int kRows = 128;                 // query rows of a forward / dQ CTA: 64 per consumer warpgroup
constexpr int kConsumers = 256;             // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup
// setmaxnreg moves registers from the producer to the consumers (2 x 128 x 240 + 128 x 24
// <= 65536); ptxas still reports 168 a thread, but without it the head-dim-128 forward
// and dQ pass spill and the dQ pass's products serialize
constexpr int kConsumerRegs = 240;
constexpr int kProducerRegs = 24;
constexpr int kTurn = 1;  // named barriers kTurn + wg: warpgroup wg's turn to issue its products
constexpr int kStages = 4;                 // ring depth
constexpr int kRowBytes = 128;             // one row of a 64-column panel (128-byte swizzle)
constexpr int kPanelBytes = kTile * kRowBytes;  // a 64-token panel (8 KB)

template <int D>
struct Head {
  static constexpr int kPanels = (D + 63) / 64;  // 64-column panels of a row (80: two, zero-filled past 80)
  static constexpr int kSteps = D / 16;           // k16 steps of a product over the head dim (80: five)
  static constexpr int kTileBytes = kPanels * kPanelBytes;  // a 64-token tile
};

// the first 1024-byte boundary at or after p, as an offset from p so that the compiler
// keeps the pointer in the shared space (shared loads, not generic ones)
__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return p + ((1024u - (sm90::smem_u32(p) & 1023u)) & 1023u);
}

// a value the compiler must treat as uniform across the warp (wgmma issued under a
// condition it cannot prove uniform is serialized); each warpgroup computes it alike
template <typename V>
__device__ __forceinline__ V uniform(V value) {
  return __shfl_sync(0xffffffffu, value, 0);
}

// Descriptor of k16 step kk over the head dim of the 64 rows from row0 of a K-major tile
// (`rows` tokens a panel): the panel of the step, then 32 bytes a step inside the row.
__device__ __forceinline__ uint64_t head_desc(const unsigned char* tile, int rows, int row0, int kk) {
  return sm90::smem_desc(tile + (kk / 4) * rows * kRowBytes + row0 * kRowBytes + (kk % 4) * 32, 16, 1024);
}

// Descriptor of k16 step kk over the 64 tokens of a tile read MN-major (the head dim as
// N, its panels a panel apart)
__device__ __forceinline__ uint64_t token_desc(const unsigned char* tile, int kk) {
  return sm90::smem_desc(tile + kk * 16 * kRowBytes, kPanelBytes, 1024);
}

// acc (64 x 64) = A B^T over the head dim (the first step ignores acc's old values): A
// the 64 rows from a_row0 of a tile of a_rows tokens, B a 64-token tile, both K-major.
// Issued as one batch: fence, products, commit (the caller waits).
template <int D>
__device__ __forceinline__ void product_over_head(float (&acc)[32], const unsigned char* a, int a_rows, int a_row0,
                                                  const unsigned char* b) {
  sm90::fence_operands(acc);
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < Head<D>::kSteps; ++kk)
    sm90::wgmma_m64n64k16<0, 0>(acc, head_desc(a, a_rows, a_row0, kk), head_desc(b, kTile, 0, kk), kk > 0);
  sm90::wgmma_commit();
  sm90::fence_operands(acc);
}

// acc (64 x D) += P B over 64 tokens: P the registers of a 64 x 64 tile, B a 64-token
// tile read MN-major. Issued as one batch: fence, products, commit (the caller waits).
template <int D>
__device__ __forceinline__ void product_over_tokens(float (&acc)[D / 2], uint32_t (&p)[4][4],
                                                    const unsigned char* b) {
  sm90::fence_operands(p);
  sm90::fence_operands(acc);
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if constexpr (D == 64)
      sm90::wgmma_m64n64k16_rs<1>(acc, p[kk], token_desc(b, kk));
    else if constexpr (D == 80)  // the first panel and 16 columns of the second
      sm90::wgmma_m64n80k16_rs<1>(acc, p[kk], token_desc(b, kk));
    else
      sm90::wgmma_m64n128k16_rs<1>(acc, p[kk], token_desc(b, kk));
  }
  sm90::wgmma_commit();
  sm90::fence_operands(acc);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// a 64 x 64 accumulator, rounded to bf16, as the register A operand of four k16 steps
__device__ __forceinline__ void to_a_operand(uint32_t (&a)[4][4], const float (&acc)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16(acc[8 * kk + 2 * r], acc[8 * kk + 2 * r + 1]);
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.f;
}

// wait for every product issued and hand acc back to ordinary instructions
template <int N>
__device__ __forceinline__ void finish(float (&acc)[N]) {
  sm90::wgmma_wait<0>();
  sm90::fence_operands(acc);
}

__device__ __forceinline__ void init_barriers(uint64_t* full, uint64_t* empty, uint64_t* once, int consumers) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], consumers);
    }
    sm90::mbar_init(once, 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();
}

// a producer waits until stage (i % kStages) is free for item i
__device__ __forceinline__ void wait_free(uint64_t* empty, int i) {
  if (i >= kStages) sm90::mbar_wait(&empty[i % kStages], (i / kStages - 1) & 1);
}

// load the head-dim panels of 64-token (or `rows`-token) boxes of a [B, S, H, D] map
template <int D>
__device__ __forceinline__ void load_rows(unsigned char* dst, const CUtensorMap* map, uint64_t* bar, int rows,
                                          int head, int token0, int b) {
#pragma unroll
  for (int p = 0; p < Head<D>::kPanels; ++p)
    sm90::tma_load_4d(dst + p * rows * kRowBytes, map, bar, 64 * p, head, token0, b);
}

// Store a warpgroup's 64 x D accumulator as the head-dim rows `tokens` (this thread's
// two) of a [B, S, H, D] output, times `scale`.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, const float (&acc)[D / 2], const int (&tokens)[2],
                                           int64_t tok0, int heads, int head, int c, const float (&scale)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    __nv_bfloat16* dst = out + ((tok0 + tokens[h]) * heads + head) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store_pair(dst + 8 * j + 2 * c, acc[4 * j + 2 * h] * scale[h], acc[4 * j + 2 * h + 1] * scale[h]);
  }
}

template <int D>
struct FwdLayout {
  static constexpr int kQBytes = kRows / kTile * Head<D>::kTileBytes;
  static constexpr int kStageBytes = 2 * Head<D>::kTileBytes;  // K, V
  static constexpr size_t kBytes = 1024 + kQBytes + kStages * kStageBytes + kStages * 2 * kTile * 4 + (2 * kStages + 1) * 8;
};

template <int D, bool kBias, bool kCausal>
__global__ void __launch_bounds__(kThreads, 1)
    fwd_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
               const __grid_constant__ CUtensorMap v_map, FlashArgs args) {
  using H = Head<D>;
  using L = FwdLayout<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* qs = align_1024(smem_raw);
  unsigned char* ring = qs + L::kQBytes;  // [stage][K, V]
  int* segk = reinterpret_cast<int*>(ring + kStages * L::kStageBytes);  // [stage][kTile]
  float* biask = reinterpret_cast<float*>(segk + kStages * kTile);       // [stage][kTile]
  uint64_t* full = reinterpret_cast<uint64_t*>(biask + kStages * kTile);
  uint64_t* empty = full + kStages;
  uint64_t* q_full = empty + kStages;

  const int seq = args.seq;
  const int num_tiles = seq / kTile;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // the longest rows first
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int hq = args.num_q_heads;
  const int kv_head = head / (hq / args.num_kv_heads);
  const int64_t tok0 = static_cast<int64_t>(b) * seq;
  const int* seg_row = args.seg + tok0;
  const float* bias_row = kBias ? args.bias + (static_cast<int64_t>(b) * hq + head) * seq : nullptr;
  const int4* ranges = args.ranges + static_cast<int64_t>(b) * num_tiles;
  const int first = q0 / kTile;
  const int last = min(first + 1, num_tiles - 1);  // the query block's last 64-token tile
  const int4 rf = ranges[first], rl = ranges[last];
  const int2 q_range = make_int2(min(rf.x, rl.x), max(rf.y, rl.y));
  const int window = min(rf.z, rl.z);  // the first key tile that meets the block
  const int end = min(key_tile_end<kCausal>(last, num_tiles), max(rf.w, rl.w) + 1);
  auto next = [&](int t) {
    while (t < end && !meets(ranges[t], q_range)) ++t;
    return t;
  };
  init_barriers(full, empty, q_full, 2);

  if (threadIdx.x >= kConsumers) {  // producer
    sm90::warpgroup_reg_dealloc<kProducerRegs>();
    if (threadIdx.x == kConsumers) {
      sm90::prefetch_tensor_map(&q_map);
      sm90::prefetch_tensor_map(&k_map);
      sm90::prefetch_tensor_map(&v_map);
      sm90::mbar_arrive_expect_tx(q_full, L::kQBytes);
      load_rows<D>(qs, &q_map, q_full, kRows, head, q0, b);
      int i = 0;
      for (int t = next(window); t < end; t = next(t + 1), ++i) {
        const int s = i % kStages;
        wait_free(empty, i);
        unsigned char* kv = ring + s * L::kStageBytes;
        sm90::mbar_arrive_expect_tx(&full[s], L::kStageBytes + (kBias ? 2 : 1) * kTile * 4);
        load_rows<D>(kv, &k_map, &full[s], kTile, kv_head, t * kTile, b);
        load_rows<D>(kv + H::kTileBytes, &v_map, &full[s], kTile, kv_head, t * kTile, b);
        sm90::bulk_load(segk + s * kTile, seg_row + t * kTile, kTile * 4, &full[s]);
        if constexpr (kBias) sm90::bulk_load(biask + s * kTile, bias_row + t * kTile, kTile * 4, &full[s]);
      }
    }
    return;
  }
  sm90::warpgroup_reg_alloc<kConsumerRegs>();

  // consumers: warpgroup wg owns rows [r0, r0 + 64); this thread rows[0] and rows[1]
  const int wg = uniform(static_cast<int>(threadIdx.x) / 128);
  const int lane = static_cast<int>(threadIdx.x) % 32;
  const int c = lane % 4;
  const int r0 = q0 + 64 * wg;
  const bool active = r0 < seq;  // the second half of a last block may lie past the sequence
  const int w_tile = active ? r0 / kTile : last;
  const int4 w_range = ranges[w_tile];
  const int w_end = key_tile_end<kCausal>(w_tile, num_tiles);
  const int row = r0 + 16 * static_cast<int>((threadIdx.x % 128) / 32) + lane / 4;
  const int rows[2] = {row, row + 8};
  int row_seg[2] = {0, 0};
  float row_bias[2] = {0.f, 0.f};
  if (active) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      row_seg[h] = seg_row[rows[h]];
      if constexpr (kBias) row_bias[h] = bias_row[rows[h]];
    }
  }
  // x = q.k, or with a bias the log2-unit score q.k * scale * log2(e) + bias term; the
  // exponent of P is (x - m) * xs
  const float scale_log2 = args.scale * kLog2e;
  const float xs = kBias ? 1.f : scale_log2;
  float m[2] = {-INFINITY, -INFINITY};  // running max of x
  float l[2] = {0.f, 0.f};              // this lane's share of the denominator
  float o[D / 2];
  zero(o);
  uint32_t p[4][4] = {};  // P of the last used tile (zeros if none), whose P V comes next
  const unsigned char* p_v = nullptr;  // the V tile of p
  const int t = static_cast<int>(threadIdx.x) % 128;
  sm90::mbar_wait_warp(q_full, 0);

  // The online softmax of tile kt (stage s) over its scores `cur`, in place: cur becomes
  // P (zeros for a tile this warpgroup skips), O waits for the new max in `alpha`.
  auto softmax = [&](float (&cur)[32], int kt, int s, float (&alpha)[2]) {
    const int4 k_range = ranges[kt];
    const bool use = uniform(active && kt < w_end && meets(k_range, w_range));
    alpha[0] = alpha[1] = 1.f;
    if (!use) {
#pragma unroll
      for (int e = 0; e < 32; ++e) cur[e] = 0.f;
      return;
    }
    const int* sk = segk + s * kTile;
    const float* bk = biask + s * kTile;
    float tile_max[2] = {-INFINITY, -INFINITY};
    // the scores (x) and their row maxima; the mask only where the tile needs it (a
    // compile-time branch each, so the common unmasked tile carries no mask code)
    auto scores = [&](auto masked) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col0 = 8 * j + 2 * c;  // this thread's two key columns
        float2 bk2 = make_float2(0.f, 0.f);
        if constexpr (kBias) bk2 = *reinterpret_cast<const float2*>(bk + col0);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const int col = col0 + (e & 1);
          float x = cur[4 * j + e];
          if constexpr (kBias) x = fmaf(x, scale_log2, bias_log2((e & 1) ? bk2.y : bk2.x, row_bias[h]));
          if constexpr (decltype(masked)::value)
            if (!((!kCausal || kt * kTile + col <= rows[h]) & (sk[col] == row_seg[h]))) x = -INFINITY;
          cur[4 * j + e] = x;
          tile_max[h] = fmaxf(tile_max[h], x);
        }
      }
    };
    if (uniform((kCausal && kt == w_tile) || !one_segment(k_range, w_range))) {
      scores(std::true_type{});
    } else {
      scores(std::false_type{});
    }
    float neg[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m[h], quad_max(tile_max[h]));
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // a row with nothing visible yet
      alpha[h] = sm90::fast_exp2((m[h] - m_use) * xs);
      m[h] = m_new;
      l[h] *= alpha[h];
      neg[h] = -m_use * xs;
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      cur[e] = sm90::fast_exp2(fmaf(cur[e], xs, neg[(e >> 1) & 1]));
      l[(e >> 1) & 1] += cur[e];
    }
  };
  // after the previous P V: O to the new max, P as the next A operand
  auto rescale = [&](float (&cur)[32], const float (&alpha)[2]) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[4 * j + e] *= alpha[e >> 1];
    to_a_operand(p, cur);
  };

  // Ping-pong: the warpgroups take turns at the tensor cores (named barriers kTurn + wg),
  // so one's softmax runs while the other's products do. Every turn issues the same
  // products (a skipped tile's S goes unread, a zero P adds nothing): ptxas overlaps
  // asynchronous products only in a fixed issue pattern. (Issuing the next tile's S
  // before this tile's softmax, FlashAttention-3's overlap inside a warpgroup, made ptxas
  // serialize the products here.)
  if (wg == 1) sm90::named_barrier_arrive(kTurn, kConsumers);  // warpgroup 0 goes first
  int i = 0;
  int kt = next(window);
  // Each turn issues this tile's S and the previous tile's P V; the softmax waits for S.
  float sc[32];
  for (; kt < end; kt = next(kt + 1), ++i) {
    const int s = i % kStages;
    sm90::mbar_wait_warp(&full[s], (i / kStages) & 1);
    const unsigned char* kv = ring + s * L::kStageBytes;
    if (i == 0) p_v = kv + H::kTileBytes;  // p is zero: any loaded V tile
    sm90::named_barrier_sync(kTurn + wg, kConsumers);
    product_over_head<D>(sc, qs, kRows, 64 * wg, kv);
    product_over_tokens<D>(o, p, p_v);
    sm90::named_barrier_arrive(kTurn + 1 - wg, kConsumers);
    sm90::wgmma_wait<1>();  // S is in; the previous P V may still run
    sm90::fence_operands(sc);
    float alpha[2];
    softmax(sc, kt, s, alpha);
    sm90::wgmma_wait<0>();  // the previous P V is done: its stage is free, O takes the new max
    sm90::fence_operands(o);
    rescale(sc, alpha);
    p_v = kv + H::kTileBytes;
    sm90::mbar_arrive_if(&empty[(i - 1 + kStages) % kStages], i > 0 && t == 0);
  }
  if (i > 0) {
    product_over_tokens<D>(o, p, p_v);
    finish(o);
    sm90::mbar_arrive_if(&empty[(i - 1) % kStages], t == 0);
  }
  if (wg == 0) sm90::named_barrier_sync(kTurn, kConsumers);  // warpgroup 1's last turn
  if (!active) return;

  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float total = quad_sum(l[h]);
    inv[h] = 1.f / total;
    if (c == 0) args.lse[(static_cast<int64_t>(b) * hq + head) * seq + rows[h]] = (m[h] * xs + log2f(total)) / kLog2e;
  }
  store_rows<D>(static_cast<__nv_bfloat16*>(args.o_write), o, rows, tok0, hq, head, c, inv);
}

template <int D>
struct DqLayout {
  static constexpr int kQBytes = kRows / kTile * Head<D>::kTileBytes;  // Q, and dO after it
  static constexpr int kStageBytes = 2 * Head<D>::kTileBytes;            // K, V
  static constexpr size_t kBytes =
      1024 + 2 * kQBytes + kStages * kStageBytes + kStages * 2 * kTile * 4 + (2 * kStages + 1) * 8;
};

template <int D, bool kBias, bool kCausal>
__global__ void __launch_bounds__(kThreads, 1)
    dq_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap do_map,
              const __grid_constant__ CUtensorMap k_map, const __grid_constant__ CUtensorMap v_map, FlashArgs args) {
  using H = Head<D>;
  using L = DqLayout<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* qs = align_1024(smem_raw);
  unsigned char* dos = qs + L::kQBytes;
  unsigned char* ring = dos + L::kQBytes;  // [stage][K, V]
  int* segk = reinterpret_cast<int*>(ring + kStages * L::kStageBytes);
  float* biask = reinterpret_cast<float*>(segk + kStages * kTile);
  uint64_t* full = reinterpret_cast<uint64_t*>(biask + kStages * kTile);
  uint64_t* empty = full + kStages;
  uint64_t* q_full = empty + kStages;

  const int seq = args.seq;
  const int num_tiles = seq / kTile;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int hq = args.num_q_heads;
  const int kv_head = head / (hq / args.num_kv_heads);
  const int64_t tok0 = static_cast<int64_t>(b) * seq;
  const int64_t stat0 = (static_cast<int64_t>(b) * hq + head) * seq;
  const int* seg_row = args.seg + tok0;
  const float* bias_row = kBias ? args.bias + stat0 : nullptr;
  const int4* ranges = args.ranges + static_cast<int64_t>(b) * num_tiles;
  const int first = q0 / kTile;
  const int last = min(first + 1, num_tiles - 1);
  const int4 rf = ranges[first], rl = ranges[last];
  const int2 q_range = make_int2(min(rf.x, rl.x), max(rf.y, rl.y));
  const int window = min(rf.z, rl.z);
  const int end = min(key_tile_end<kCausal>(last, num_tiles), max(rf.w, rl.w) + 1);
  auto next = [&](int t) {
    while (t < end && !meets(ranges[t], q_range)) ++t;
    return t;
  };
  init_barriers(full, empty, q_full, 2);

  if (threadIdx.x >= kConsumers) {  // producer
    sm90::warpgroup_reg_dealloc<kProducerRegs>();
    if (threadIdx.x == kConsumers) {
      sm90::prefetch_tensor_map(&q_map);
      sm90::prefetch_tensor_map(&do_map);
      sm90::prefetch_tensor_map(&k_map);
      sm90::prefetch_tensor_map(&v_map);
      sm90::mbar_arrive_expect_tx(q_full, 2 * L::kQBytes);
      load_rows<D>(qs, &q_map, q_full, kRows, head, q0, b);
      load_rows<D>(dos, &do_map, q_full, kRows, head, q0, b);
      int i = 0;
      for (int t = next(window); t < end; t = next(t + 1), ++i) {
        const int s = i % kStages;
        wait_free(empty, i);
        unsigned char* kv = ring + s * L::kStageBytes;
        sm90::mbar_arrive_expect_tx(&full[s], L::kStageBytes + (kBias ? 2 : 1) * kTile * 4);
        load_rows<D>(kv, &k_map, &full[s], kTile, kv_head, t * kTile, b);
        load_rows<D>(kv + H::kTileBytes, &v_map, &full[s], kTile, kv_head, t * kTile, b);
        sm90::bulk_load(segk + s * kTile, seg_row + t * kTile, kTile * 4, &full[s]);
        if constexpr (kBias) sm90::bulk_load(biask + s * kTile, bias_row + t * kTile, kTile * 4, &full[s]);
      }
    }
    return;
  }
  sm90::warpgroup_reg_alloc<kConsumerRegs>();

  const int wg = uniform(static_cast<int>(threadIdx.x) / 128);
  const int lane = static_cast<int>(threadIdx.x) % 32;
  const int c = lane % 4;
  const int r0 = q0 + 64 * wg;
  const bool active = r0 < seq;
  const int w_tile = active ? r0 / kTile : last;
  const int4 w_range = ranges[w_tile];
  const int w_end = key_tile_end<kCausal>(w_tile, num_tiles);
  const int row = r0 + 16 * static_cast<int>((threadIdx.x % 128) / 32) + lane / 4;
  const int rows[2] = {row, row + 8};
  int row_seg[2] = {0, 0};
  float row_bias[2] = {0.f, 0.f}, row_lse[2] = {0.f, 0.f}, row_delta[2] = {0.f, 0.f};
  if (active) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      row_seg[h] = seg_row[rows[h]];
      if constexpr (kBias) row_bias[h] = bias_row[rows[h]];
      row_lse[h] = args.lse[stat0 + rows[h]] * kLog2e;
      row_delta[h] = args.delta[stat0 + rows[h]];
    }
  }
  const float scale_log2 = args.scale * kLog2e;
  const int t = static_cast<int>(threadIdx.x) % 128;
  float dq[D / 2];
  zero(dq);
  sm90::mbar_wait_warp(q_full, 0);

  // the warpgroups take turns issuing S and dP (named barriers kTurn + wg), so one's
  // elementwise work runs while the other's products do
  if (wg == 1) sm90::named_barrier_arrive(kTurn, kConsumers);
  int i = 0;
  for (int kt = next(window); kt < end; kt = next(kt + 1), ++i) {
    const int s = i % kStages;
    sm90::mbar_wait_warp(&full[s], (i / kStages) & 1);
    const int4 k_range = ranges[kt];
    const bool use = uniform(active && kt < w_end && meets(k_range, w_range));
    const unsigned char* kv = ring + s * L::kStageBytes;
    float sc[32], dp[32];
    // every step issues the same products (a skipped tile's dS is zero): ptxas overlaps
    // asynchronous products only in a fixed issue pattern
    sm90::named_barrier_sync(kTurn + wg, kConsumers);
    product_over_head<D>(sc, qs, kRows, 64 * wg, kv);                   // S = Q K^T
    product_over_head<D>(dp, dos, kRows, 64 * wg, kv + H::kTileBytes);  // dP = dO V^T
    sm90::named_barrier_arrive(kTurn + 1 - wg, kConsumers);
    sm90::wgmma_wait<0>();
    sm90::fence_operands(sc);
    sm90::fence_operands(dp);
    uint32_t ds[4][4] = {};
    if (use) {
      const int* sk = segk + s * kTile;
      const float* bk = biask + s * kTile;
      auto grads = [&](auto masked) {  // dS = P (dP - delta), the mask only where needed
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e >> 1;
            const int col = 8 * j + 2 * c + (e & 1);
            float ds_exp = -row_lse[h];
            if constexpr (kBias) ds_exp += bias_log2(bk[col], row_bias[h]);  // the bias in dQ's P
            float p = sm90::fast_exp2(fmaf(sc[4 * j + e], scale_log2, ds_exp));
            if constexpr (decltype(masked)::value)
              if (!((!kCausal || kt * kTile + col <= rows[h]) & (sk[col] == row_seg[h]))) p = 0.f;
            sc[4 * j + e] = p * (dp[4 * j + e] - row_delta[h]);
          }
      };
      if (uniform((kCausal && kt == w_tile) || !one_segment(k_range, w_range))) {
        grads(std::true_type{});
      } else {
        grads(std::false_type{});
      }
      to_a_operand(ds, sc);
    }
    product_over_tokens<D>(dq, ds, kv);  // dQ += dS K
    finish(dq);
    sm90::mbar_arrive_if(&empty[s], t == 0);
  }
  if (wg == 0) sm90::named_barrier_sync(kTurn, kConsumers);  // warpgroup 1's last turn
  if (!active) return;
  const float scale[2] = {args.scale, args.scale};
  store_rows<D>(static_cast<__nv_bfloat16*>(args.dq), dq, rows, tok0, hq, head, c, scale);
}

template <int D>
struct DkdvLayout {
  static constexpr int kKvBytes = 2 * Head<D>::kTileBytes;     // K, V
  static constexpr int kStageBytes = 2 * Head<D>::kTileBytes;  // Q, dO
  static constexpr int kStats = 4 * kTile;                     // seg, lse, delta, query bias
  static constexpr int kPFloats = 32 * 128;                    // one item's P^T in the accumulator's thread order
  static constexpr size_t kBytes = 1024 + kKvBytes + kStages * kStageBytes + 2 * kPFloats * 4 +
                                   kStages * kStats * 4 + (2 * kStages + 5) * 8;
};

// The two consumer warpgroups split each item: warpgroup 0 computes S^T = K Q^T, P^T
// under the masks (handed over through shared memory, two buffers) and dV += P^T dO;
// warpgroup 1 computes dP^T = V dO^T, dS^T = P^T (dP^T - delta) and dK += dS^T Q. Each
// holds one 64 x D accumulator across the walk, so neither spills at 168 registers.
template <int D, bool kBias, bool kCausal>
__global__ void __launch_bounds__(kThreads, 1)
    dkdv_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap do_map,
                const __grid_constant__ CUtensorMap k_map, const __grid_constant__ CUtensorMap v_map, FlashArgs args) {
  using H = Head<D>;
  using L = DkdvLayout<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ks = align_1024(smem_raw);
  unsigned char* vs = ks + H::kTileBytes;
  unsigned char* ring = ks + L::kKvBytes;  // [stage][Q, dO]
  float* pshare = reinterpret_cast<float*>(ring + kStages * L::kStageBytes);  // [2][kPFloats]
  float* stats = pshare + 2 * L::kPFloats;  // [stage][seg, lse, delta, bias][kTile]
  uint64_t* full = reinterpret_cast<uint64_t*>(stats + kStages * L::kStats);
  uint64_t* empty = full + kStages;
  uint64_t* kv_full = empty + kStages;
  uint64_t* p_full = kv_full + 1;  // [2]: warpgroup 0 wrote P^T into the buffer
  uint64_t* p_empty = p_full + 2;  // [2]: warpgroup 1 read it

  const int seq = args.seq;
  const int num_tiles = seq / kTile;
  const int kt = blockIdx.x;  // the longest column walks first
  const int kv_head = blockIdx.y;
  const int b = blockIdx.z;
  const int hq = args.num_q_heads;
  const int group = hq / args.num_kv_heads;
  const int k0 = kt * kTile;
  const int64_t tok0 = static_cast<int64_t>(b) * seq;
  const int* seg_row = args.seg + tok0;
  const int4* ranges = args.ranges + static_cast<int64_t>(b) * num_tiles;
  const int4 k_range = ranges[kt];
  const int end = group * num_tiles;
  const auto next = item_walk<kCausal>(ranges, k_range, kt, num_tiles, end);
  const int start = next(0);
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      sm90::mbar_init(&p_full[s], 128);
      sm90::mbar_init(&p_empty[s], 128);
    }
  }
  init_barriers(full, empty, kv_full, 2);

  if (threadIdx.x >= kConsumers) {  // producer
    sm90::warpgroup_reg_dealloc<kProducerRegs>();
    if (threadIdx.x == kConsumers) {
      sm90::prefetch_tensor_map(&q_map);
      sm90::prefetch_tensor_map(&do_map);
      sm90::prefetch_tensor_map(&k_map);
      sm90::prefetch_tensor_map(&v_map);
      sm90::mbar_arrive_expect_tx(kv_full, L::kKvBytes);
      load_rows<D>(ks, &k_map, kv_full, kTile, kv_head, k0, b);
      load_rows<D>(vs, &v_map, kv_full, kTile, kv_head, k0, b);
      int i = 0;
      for (int p = start; p < end; p = next(p + 1), ++i) {
        const int s = i % kStages;
        wait_free(empty, i);
        const int head = kv_head * group + p / num_tiles;
        const int q0 = (p % num_tiles) * kTile;
        const int64_t stat0 = (static_cast<int64_t>(b) * hq + head) * seq + q0;
        unsigned char* qd = ring + s * L::kStageBytes;
        float* st = stats + s * L::kStats;
        sm90::mbar_arrive_expect_tx(&full[s], L::kStageBytes + (kBias ? 4 : 3) * kTile * 4);
        load_rows<D>(qd, &q_map, &full[s], kTile, head, q0, b);
        load_rows<D>(qd + H::kTileBytes, &do_map, &full[s], kTile, head, q0, b);
        sm90::bulk_load(st, seg_row + q0, kTile * 4, &full[s]);
        sm90::bulk_load(st + kTile, args.lse + stat0, kTile * 4, &full[s]);
        sm90::bulk_load(st + 2 * kTile, args.delta + stat0, kTile * 4, &full[s]);
        if constexpr (kBias) sm90::bulk_load(st + 3 * kTile, args.bias + stat0, kTile * 4, &full[s]);
      }
    }
    return;
  }
  sm90::warpgroup_reg_alloc<kConsumerRegs>();

  // consumers: the rows of S^T / dP^T are the 64 keys, the columns the item's queries
  const int wg = uniform(static_cast<int>(threadIdx.x) / 128);
  const int t = static_cast<int>(threadIdx.x) % 128;
  const int c = t % 4;
  const int krow = k0 + 16 * (t / 32) + (t % 32) / 4;
  const int krows[2] = {krow, krow + 8};
  sm90::mbar_wait_warp(kv_full, 0);

  if (wg == 0) {  // P^T and dV
    const int key_seg[2] = {seg_row[krows[0]], seg_row[krows[1]]};
    const float scale_log2 = args.scale * kLog2e;
    float dv[D / 2];
    zero(dv);
    int i = 0;
    for (int p = start; p < end; p = next(p + 1), ++i) {
      const int s = i % kStages;
      sm90::mbar_wait_warp(&full[s], (i / kStages) & 1);
      const int head = kv_head * group + p / num_tiles;
      const int qt = p % num_tiles;
      const int q0 = qt * kTile;
      const unsigned char* qd = ring + s * L::kStageBytes;
      const float* st = stats + s * L::kStats;
      const int* segq = reinterpret_cast<const int*>(st);
      const float* lse = st + kTile;
      const float* qbias = st + 3 * kTile;
      float key_bias[2] = {0.f, 0.f};  // this thread's keys' bias under the item's q head
      if constexpr (kBias) {
        const float* bias_row = args.bias + (static_cast<int64_t>(b) * hq + head) * seq;
        key_bias[0] = bias_row[krows[0]];
        key_bias[1] = bias_row[krows[1]];
      }
      float sc[32];
      product_over_head<D>(sc, ks, kTile, 0, qd);  // S^T = K Q^T
      finish(sc);
      auto probs = [&](auto masked) {  // P^T, the mask only where needed
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col0 = 8 * j + 2 * c;  // this thread's two query columns
          const float2 lse2 = *reinterpret_cast<const float2*>(lse + col0);
          float2 qb2 = make_float2(0.f, 0.f);
          if constexpr (kBias) qb2 = *reinterpret_cast<const float2*>(qbias + col0);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e >> 1;
            const int col = col0 + (e & 1);
            float pt_exp = -((e & 1) ? lse2.y : lse2.x) * kLog2e;
            if constexpr (kBias) pt_exp += bias_log2(key_bias[h], (e & 1) ? qb2.y : qb2.x);
            float pt = sm90::fast_exp2(fmaf(sc[4 * j + e], scale_log2, pt_exp));
            if constexpr (decltype(masked)::value)
              if (!((!kCausal || krows[h] <= q0 + col) & (segq[col] == key_seg[h]))) pt = 0.f;
            sc[4 * j + e] = pt;
          }
        }
      };
      if (uniform((kCausal && qt == kt) || !one_segment(ranges[qt], k_range))) {
        probs(std::true_type{});
      } else {
        probs(std::false_type{});
      }
      uint32_t pa[4][4];
      to_a_operand(pa, sc);
      product_over_tokens<D>(dv, pa, qd + H::kTileBytes);  // dV += P^T dO, while P^T is handed over
      float4* handoff = reinterpret_cast<float4*>(pshare + (i & 1) * L::kPFloats);  // [8][128] float4
      if (i >= 2) sm90::mbar_wait_warp(&p_empty[i & 1], ((i >> 1) - 1) & 1);  // item i - 2 was read
#pragma unroll
      for (int j = 0; j < 8; ++j) handoff[j * 128 + t] = make_float4(sc[4 * j], sc[4 * j + 1], sc[4 * j + 2], sc[4 * j + 3]);
      sm90::mbar_arrive(&p_full[i & 1]);
      finish(dv);
      sm90::mbar_arrive_if(&empty[s], t == 0);
    }
    const float one[2] = {1.f, 1.f};
    store_rows<D>(static_cast<__nv_bfloat16*>(args.dv), dv, krows, tok0, args.num_kv_heads, kv_head, c, one);
  } else {  // dS^T and dK
    float dk[D / 2];
    zero(dk);
    int i = 0;
    for (int p = start; p < end; p = next(p + 1), ++i) {
      const int s = i % kStages;
      sm90::mbar_wait_warp(&full[s], (i / kStages) & 1);
      const unsigned char* qd = ring + s * L::kStageBytes;
      const float* delta = stats + s * L::kStats + 2 * kTile;
      float dp[32];
      product_over_head<D>(dp, vs, kTile, 0, qd + H::kTileBytes);  // dP^T = V dO^T
      finish(dp);
      const float4* handoff = reinterpret_cast<const float4*>(pshare + (i & 1) * L::kPFloats);
      sm90::mbar_wait_warp(&p_full[i & 1], (i >> 1) & 1);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 pt = handoff[j * 128 + t];
        const float2 d2 = *reinterpret_cast<const float2*>(delta + 8 * j + 2 * c);
        dp[4 * j] = pt.x * (dp[4 * j] - d2.x);
        dp[4 * j + 1] = pt.y * (dp[4 * j + 1] - d2.y);
        dp[4 * j + 2] = pt.z * (dp[4 * j + 2] - d2.x);
        dp[4 * j + 3] = pt.w * (dp[4 * j + 3] - d2.y);
      }
      sm90::mbar_arrive(&p_empty[i & 1]);
      uint32_t dsa[4][4];
      to_a_operand(dsa, dp);
      product_over_tokens<D>(dk, dsa, qd);  // dK += dS^T Q
      finish(dk);
      sm90::mbar_arrive_if(&empty[s], t == 0);
    }
    const float scale[2] = {args.scale, args.scale};
    store_rows<D>(static_cast<__nv_bfloat16*>(args.dk), dk, krows, tok0, args.num_kv_heads, kv_head, c, scale);
  }
}

// A [B, S, H, D] bf16 tensor whose tokens are `stride` elements apart as a 4-D map
// {D, H, S, B}, read in boxes of 64 columns x 1 head x `rows` tokens: columns past D and
// tokens past S read as zeros.
cudaError_t head_map(CUtensorMap* map, const void* base, int batch, int seq, int heads, int head_dim, int stride,
                     int rows) {
  const uint64_t dims[4] = {static_cast<uint64_t>(head_dim), static_cast<uint64_t>(heads), static_cast<uint64_t>(seq),
                            static_cast<uint64_t>(batch)};
  const uint64_t strides[3] = {static_cast<uint64_t>(head_dim) * 2, static_cast<uint64_t>(stride) * 2,
                               static_cast<uint64_t>(seq) * stride * 2};
  const uint32_t box[4] = {64, 1, static_cast<uint32_t>(rows), 1};
  return sm90::bf16_tensor_map(map, base, 4, dims, strides, box);
}

template <int D, bool kBias, bool kCausal>
cudaError_t launch_fwd(const FlashArgs& args, int batch, cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map;
  const int hq = args.num_q_heads, hkv = args.num_kv_heads;
  cudaError_t err = head_map(&q_map, args.q, batch, args.seq, hq, D, args.q_stride, kRows);
  if (err == cudaSuccess) err = head_map(&k_map, args.k, batch, args.seq, hkv, D, args.k_stride, kTile);
  if (err == cudaSuccess) err = head_map(&v_map, args.v, batch, args.seq, hkv, D, args.v_stride, kTile);
  auto kernel = fwd_kernel<D, kBias, kCausal>;
  if (err == cudaSuccess) err = allow_shared_memory(kernel, FwdLayout<D>::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((args.seq + kRows - 1) / kRows, hq, batch);
  kernel<<<grid, kThreads, FwdLayout<D>::kBytes, stream>>>(q_map, k_map, v_map, args);
  return cudaGetLastError();
}

template <int D, bool kBias, bool kCausal>
cudaError_t launch_bwd(const FlashArgs& args, int batch, cudaStream_t stream) {
  CUtensorMap q_rows, do_rows, q_tile, do_tile, k_map, v_map;
  const int hq = args.num_q_heads, hkv = args.num_kv_heads, seq = args.seq;
  cudaError_t err = head_map(&q_rows, args.q, batch, seq, hq, D, args.q_stride, kRows);
  if (err == cudaSuccess) err = head_map(&do_rows, args.dout, batch, seq, hq, D, hq * D, kRows);
  if (err == cudaSuccess) err = head_map(&q_tile, args.q, batch, seq, hq, D, args.q_stride, kTile);
  if (err == cudaSuccess) err = head_map(&do_tile, args.dout, batch, seq, hq, D, hq * D, kTile);
  if (err == cudaSuccess) err = head_map(&k_map, args.k, batch, seq, hkv, D, args.k_stride, kTile);
  if (err == cudaSuccess) err = head_map(&v_map, args.v, batch, seq, hkv, D, args.v_stride, kTile);
  auto dkdv = dkdv_kernel<D, kBias, kCausal>;
  auto dq = dq_kernel<D, kBias, kCausal>;
  if (err == cudaSuccess) err = allow_shared_memory(dkdv, DkdvLayout<D>::kBytes);
  if (err == cudaSuccess) err = allow_shared_memory(dq, DqLayout<D>::kBytes);
  if (err != cudaSuccess) return err;
  dkdv<<<dim3(seq / kTile, hkv, batch), kThreads, DkdvLayout<D>::kBytes, stream>>>(q_tile, do_tile, k_map, v_map, args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq<<<dim3((seq + kRows - 1) / kRows, hq, batch), kThreads, DqLayout<D>::kBytes, stream>>>(q_rows, do_rows, k_map,
                                                                                             v_map, args);
  return cudaGetLastError();
}

}  // namespace wg

// The kernels of one (dtype, head dim, form): bf16 takes the wgmma path, fp32 the FMA
// tiles (a fixed dtype rule).
template <int D, bool kBias, bool kCausal, bool kBackward>
cudaError_t launch_form(const FlashArgs& args, int batch, bool bf16, cudaStream_t stream) {
  if (bf16)
    return kBackward ? wg::launch_bwd<D, kBias, kCausal>(args, batch, stream)
                     : wg::launch_fwd<D, kBias, kCausal>(args, batch, stream);
  return kBackward ? fp32::launch_bwd<D, kBias, kCausal>(args, batch, stream)
                   : fp32::launch_fwd<D, kBias, kCausal>(args, batch, stream);
}

template <int D, bool kBackward>
cudaError_t dispatch_form(const FlashArgs& args, int batch, bool causal, bool bf16, cudaStream_t stream) {
  const bool bias = args.bias != nullptr;
  if (bias && causal) return launch_form<D, true, true, kBackward>(args, batch, bf16, stream);
  if (bias) return launch_form<D, true, false, kBackward>(args, batch, bf16, stream);
  if (causal) return launch_form<D, false, true, kBackward>(args, batch, bf16, stream);
  return launch_form<D, false, false, kBackward>(args, batch, bf16, stream);
}

// The segment ranges (and in the backward delta), then the head dim's kernels.
template <bool kBackward>
int dispatch(const FlashArgs& args, int batch, int head_dim, bool causal, int dtype, void* stream) {
  if (batch <= 0 || args.seq <= 0) return cudaSuccess;
  if (args.seq % kTile || args.num_q_heads % args.num_kv_heads) return cudaErrorInvalidValue;
  if (head_dim != 64 && head_dim != 80 && head_dim != 128) return cudaErrorInvalidValue;
  if (dtype != dolo::kFloat32 && dtype != dolo::kBFloat16) return cudaErrorInvalidValue;
  const bool bf16 = dtype == dolo::kBFloat16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = args.seq / kTile;  // a batch row's
  const size_t span_bytes = static_cast<size_t>(tiles) * sizeof(int2);
  if (span_bytes > 48 * 1024) return cudaErrorInvalidValue;
  if (kBackward) {
    const int64_t rows = static_cast<int64_t>(batch) * args.seq * args.num_q_heads;
    const int delta_blocks = static_cast<int>((rows + kDeltaRows - 1) / kDeltaRows);
    if (bf16)
      flash_delta_kernel<__nv_bfloat16><<<delta_blocks + batch, 256, span_bytes, s>>>(args, head_dim, rows, delta_blocks, tiles);
    else
      flash_delta_kernel<float><<<delta_blocks + batch, 256, span_bytes, s>>>(args, head_dim, rows, delta_blocks, tiles);
  } else {
    flash_ranges_kernel<<<batch, 256, span_bytes, s>>>(args, tiles);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  switch (head_dim) {
    case 64:
      return dispatch_form<64, kBackward>(args, batch, causal, bf16, s);
    case 80:
      return dispatch_form<80, kBackward>(args, batch, causal, bf16, s);
    default:
      return dispatch_form<128, kBackward>(args, batch, causal, bf16, s);
  }
}

}  // namespace

// bias: [B, Hq, S] fp32 or null; ranges: [B, S / 64] int4 scratch; causal: 0 or 1
extern "C" int dolo_flash_fwd(const void* q, const void* k, const void* v, const void* seg, const void* bias,
                              void* out, void* lse, void* ranges, int batch, int seq, int num_q_heads,
                              int num_kv_heads, int head_dim, int q_stride, int k_stride, int v_stride, int causal,
                              float scale, int dtype, void* stream) {
  FlashArgs args{};
  args.q = q;
  args.k = k;
  args.v = v;
  args.seg = static_cast<const int*>(seg);
  args.bias = static_cast<const float*>(bias);
  args.o_write = out;
  args.lse = static_cast<float*>(lse);
  args.ranges = static_cast<int4*>(ranges);
  args.seq = seq;
  args.num_q_heads = num_q_heads;
  args.num_kv_heads = num_kv_heads;
  args.q_stride = q_stride;
  args.k_stride = k_stride;
  args.v_stride = v_stride;
  args.scale = scale;
  return dispatch<false>(args, batch, head_dim, causal != 0, dtype, stream);
}

extern "C" int dolo_flash_bwd(const void* q, const void* k, const void* v, const void* seg, const void* bias,
                              const void* out, const void* dout, const void* lse, void* delta, void* ranges, void* dq,
                              void* dk, void* dv, int batch, int seq, int num_q_heads, int num_kv_heads, int head_dim,
                              int q_stride, int k_stride, int v_stride, int causal, float scale, int dtype,
                              void* stream) {
  FlashArgs args{};
  args.q = q;
  args.k = k;
  args.v = v;
  args.seg = static_cast<const int*>(seg);
  args.bias = static_cast<const float*>(bias);
  args.out = out;
  args.dout = dout;
  args.lse = const_cast<float*>(static_cast<const float*>(lse));
  args.delta = static_cast<float*>(delta);
  args.ranges = static_cast<int4*>(ranges);
  args.dq = dq;
  args.dk = dk;
  args.dv = dv;
  args.seq = seq;
  args.num_q_heads = num_q_heads;
  args.num_kv_heads = num_kv_heads;
  args.q_stride = q_stride;
  args.k_stride = k_stride;
  args.v_stride = v_stride;
  args.scale = scale;
  return dispatch<true>(args, batch, head_dim, causal != 0, dtype, stream);
}
