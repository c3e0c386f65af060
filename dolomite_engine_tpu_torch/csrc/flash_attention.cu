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
// Scores run in log2 units (exp2f): the bias enters times log2(e), in the forward and in
// both backward recomputes of P, which must match the logsumexp the forward stored (of
// the shifted scores, natural log).
//
// Bound on the H100: operations for long documents — at [1, 4096, 32, 80] one causal
// document is 4 * S^2/2 * D * H ~ 86 GFLOP against ~84 MB of q/k/v/o — but packed
// documents cut the operations to the pairs inside each document, and at 6 documents in
// 4096 tokens the bytes bound it (0.025 ms of bytes against 0.015 ms of operations).
// Design (FlashAttention-2 on mma.sync): one block of 4 warps per (64-query tile, q
// head, batch row), each warp owning 16 query rows. The block first reduces every
// 64-token tile's segment ids to a (min, max) range, then walks only the key tiles (at
// or below the diagonal when causal) whose range meets the query tile's (a packed batch
// touches only the tiles near each document's diagonal). K/V tiles, with their segment
// ids and bias rows, stream through a two-stage cp.async ring, so the next tile loads
// while this one computes. Q K^T and P V run on
// the tensor cores (bf16 in, fp32 accumulate, `mma.sync.m16n8k16` via mma.cuh) with Q
// and P held in registers as mma fragments; the softmax recurrence (running max,
// denominator, rescaled fp32 output) stays in registers. fp32 inputs take the same
// tiles through scalar FMA on the CUDA cores, one stage deep, P through shared memory.
//
// The forward writes O (input type) and the fp32 row logsumexp for the backward. The
// backward is three launches and no atomics, so dQ/dK/dV are deterministic:
//   1. delta = rowsum(dO * O) per (row, q head);
//   2. dK/dV: one block per (64-key tile, kv head, batch row) walks the (q head of its
//      GQA group, query tile: at or below its diagonal when causal) pairs whose segments
//      meet its keys, recomputing P from the saved logsumexp: dV += P^T dO,
//      dS = P (dO V^T - delta), dK += dS^T Q;
//   3. dQ: one block per (query tile, q head, batch row) walks the key tiles as the
//      forward does: dQ += dS K.
#include <type_traits>

#include "mma.cuh"

namespace {

using namespace dolo;

constexpr int kBlock = 64;  // query and key tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kLdP = kBlock + 8;  // row stride of the P / dS tiles (16-byte rows, no bank clash)
constexpr float kLog2e = 1.4426950408889634f;

template <typename T>
constexpr bool kMma = std::is_same_v<T, __nv_bfloat16>;  // tensor cores, else scalar fp32
template <typename T>
constexpr int kStages = kMma<T> ? 2 : 1;  // depth of the cp.async ring

struct FlashArgs {
  const void* q;     // [B, S, Hq, D], tokens q_stride elements apart
  const void* k;     // [B, S, Hkv, D], tokens k_stride apart
  const void* v;     // [B, S, Hkv, D], tokens v_stride apart
  const int* seg;    // [B, S]
  const float* bias;  // [B, Hq, S] additive key bias (kBias), or null
  const void* out;   // [B, S, Hq, D] contiguous (backward: the forward's output)
  const void* dout;  // [B, S, Hq, D] contiguous
  float* lse;        // [B, Hq, S] natural-log row logsumexp of the scaled scores
  float* delta;      // [B, Hq, S] rowsum(dO * O)
  void* o_write;     // forward output
  void* dq;          // [B, S, Hq, D] contiguous
  void* dk;          // [B, S, Hkv, D] contiguous
  void* dv;
  int seq, num_q_heads, num_kv_heads;
  int q_stride, k_stride, v_stride;
  float scale;
};

// ranges[t] = (min, max) segment id of the 64-token tile t, for t in [t0, t1)
__device__ __forceinline__ void tile_ranges(int2* ranges, const int* seg_row, int t0, int t1) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int t = t0 + warp; t < t1; t += kWarps) {
    const int a = seg_row[t * kBlock + lane];
    const int b = seg_row[t * kBlock + 32 + lane];
    const int lo = __reduce_min_sync(0xffffffffu, min(a, b));
    const int hi = __reduce_max_sync(0xffffffffu, max(a, b));
    if (lane == 0) ranges[t] = make_int2(lo, hi);
  }
}

// whether two tiles can hold a pair of equal segment ids
__device__ __forceinline__ bool meets(int2 a, int2 b) { return a.y >= b.x && a.x <= b.y; }

// one past the last key tile query tile qt may attend: its diagonal tile when causal
template <bool kCausal>
__device__ __forceinline__ int key_tile_end(int qt, int num_tiles) {
  return kCausal ? qt + 1 : num_tiles;
}

// the score term of the additive bias in log2 units: key k's bias less the query row's
// own-position bias
__device__ __forceinline__ float bias_log2(float key_bias, float row_bias) {
  return (key_bias - row_bias) * kLog2e;
}

template <typename T, int D>
constexpr size_t fwd_smem_bytes(int num_tiles) {
  // Q, the K/V ring, P (scalar path), the key segment ids and bias of each stage, tile
  // ranges
  return (kBlock * (D + 8) + kStages<T> * 2 * kBlock * (D + 8) + (kMma<T> ? 0 : kBlock * kLdP)) *
             sizeof(T) +
         kStages<T> * 2 * kBlock * sizeof(int) + num_tiles * sizeof(int2);
}

template <typename T, int D>
constexpr size_t dq_smem_bytes(int num_tiles) {
  return (2 * kBlock * (D + 8) + kStages<T> * 2 * kBlock * (D + 8) + (kMma<T> ? 0 : kBlock * kLdP)) *
             sizeof(T) +
         kStages<T> * 2 * kBlock * sizeof(int) + num_tiles * sizeof(int2);
}

template <typename T, int D>
constexpr size_t dkdv_smem_bytes(int num_tiles) {
  // K, V, the Q/dO ring, P^T and dS^T (scalar path), each stage's segment ids, logsumexp,
  // delta and query bias, tile ranges
  return (2 * kBlock * (D + 8) + kStages<T> * 2 * kBlock * (D + 8) + (kMma<T> ? 0 : 2 * kBlock * kLdP)) *
             sizeof(T) +
         kStages<T> * 4 * kBlock * sizeof(int) + num_tiles * sizeof(int2);
}

// Walk the work items in `next(first)` order through a ring of kStages<T> buffers:
// `fetch(item, stage)` starts the async loads of an item, `compute(item, stage)` uses
// them. With two stages the next item loads while the current one computes.
template <typename T, typename Next, typename Fetch, typename Compute>
__device__ __forceinline__ void pipeline(int item, int end, Next next, Fetch fetch, Compute compute) {
  int stage = 0;
  if (item < end) fetch(item, 0);
  while (item < end) {
    const int following = next(item + 1);
    if (kStages<T> == 2 && following < end) {
      fetch(following, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    compute(item, stage);
    __syncthreads();  // the stage is refilled next
    if (kStages<T> == 2) {
      stage ^= 1;
    } else if (following < end) {
      fetch(following, 0);
    }
    item = following;
  }
}

template <typename T, int D, bool kBias, bool kCausal>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(FlashArgs args) {
  constexpr int LD = D + 8;
  constexpr int NTD = D / 8;
  constexpr int KTD = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* kvs = qs + kBlock * LD;                 // [stage][K, V][kBlock][LD]
  T* ps = kvs + kStages<T> * 2 * kBlock * LD;  // [kBlock][kLdP], scalar path only
  int* segk = reinterpret_cast<int*>(ps + (kMma<T> ? 0 : kBlock * kLdP));  // [stage][kBlock]
  float* biask = reinterpret_cast<float*>(segk + kStages<T> * kBlock);     // [stage][kBlock]
  int2* ranges = reinterpret_cast<int2*>(biask + kStages<T> * kBlock);

  const int seq = args.seq;
  const int num_tiles = seq / kBlock;
  const int qt = num_tiles - 1 - blockIdx.x;  // the longest rows first
  const int end = key_tile_end<kCausal>(qt, num_tiles);
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kv_head = head / (args.num_q_heads / args.num_kv_heads);
  const int q0 = qt * kBlock;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
  const int64_t tok0 = static_cast<int64_t>(b) * seq;
  const int* seg_row = args.seg + tok0;
  const T* k_base = static_cast<const T*>(args.k) + tok0 * args.k_stride + static_cast<int64_t>(kv_head) * D;
  const T* v_base = static_cast<const T*>(args.v) + tok0 * args.v_stride + static_cast<int64_t>(kv_head) * D;
  const float* bias_row = kBias ? args.bias + (static_cast<int64_t>(b) * args.num_q_heads + head) * seq : nullptr;

  cp_async_tile(qs, LD, static_cast<const T*>(args.q) + (tok0 + q0) * args.q_stride + static_cast<int64_t>(head) * D,
                args.q_stride, kBlock, D);
  cp_async_commit();
  tile_ranges(ranges, seg_row, 0, kCausal ? qt + 1 : num_tiles);
  __syncthreads();
  const int2 q_range = ranges[qt];
  auto next = [&](int t) {
    while (t < end && !meets(ranges[t], q_range)) ++t;
    return t;
  };
  auto fetch = [&](int t, int stage) {
    T* dst = kvs + stage * 2 * kBlock * LD;
    cp_async_tile(dst, LD, k_base + static_cast<int64_t>(t) * kBlock * args.k_stride, args.k_stride, kBlock, D);
    cp_async_tile(dst + kBlock * LD, LD, v_base + static_cast<int64_t>(t) * kBlock * args.v_stride, args.v_stride,
                  kBlock, D);
    cp_async_tile(segk + stage * kBlock, kBlock, seg_row + t * kBlock, 0, 1, kBlock);
    if constexpr (kBias) cp_async_tile(biask + stage * kBlock, kBlock, bias_row + t * kBlock, 0, 1, kBlock);
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
  uint32_t qf[KTD][4];  // Q as mma A fragments (tensor-core path)
  bool q_ready = false;

  pipeline<T>(next(0), end, next, fetch, [&](int kt, int stage) {
    const T* ks = kvs + stage * 2 * kBlock * LD;
    const T* vs = ks + kBlock * LD;
    const int* sk = segk + stage * kBlock;
    const float* bk = biask + stage * kBlock;
    const int k0 = kt * kBlock;
    float s[1][8][4];
    zero_acc(s);
    if constexpr (kMma<T>) {
      if (!q_ready) {  // the Q tile arrived with the first key tile's group
        load_a_frags<KTD>(qf, qs + warp * 16 * LD, LD);
        q_ready = true;
      }
      warp_gemm_frags<8, KTD, true>(s, qf, ks, LD);
    } else {
      warp_gemm<1, 8, true>(s, qs + warp * 16 * LD, LD, ks, LD, D);
    }

    float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int h = i >> 1;
        const int col = nt * 8 + 2 * c + (i & 1);
        const bool ok = (!kCausal || k0 + col <= q0 + rows[h]) && sk[col] == row_seg[h];
        float score = s[0][nt][i] * scale_log2;
        if constexpr (kBias) score += bias_log2(bk[col], row_bias[h]);
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
    if constexpr (kMma<T>) {
      uint32_t pf[4][4];
      acc_to_a_frags<8>(pf, s);
      warp_gemm_frags<NTD, 4, false>(o, pf, vs, LD);
    } else {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          store_pair(ps + rows[h] * kLdP + nt * 8 + 2 * c, s[0][nt][2 * h], s[0][nt][2 * h + 1]);
      __syncwarp();
      warp_gemm<1, NTD, false>(o, ps + warp * 16 * kLdP, kLdP, vs, LD, kBlock);
    }
  });

  T* out = static_cast<T*>(args.o_write);
  const int hq = args.num_q_heads;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float total = quad_sum(l[h]);
    const float inv = 1.f / total;
    const int64_t token = tok0 + q0 + rows[h];
    T* dst = out + (token * hq + head) * D;
#pragma unroll
    for (int nt = 0; nt < NTD; ++nt)
      store_pair(dst + nt * 8 + 2 * c, o[0][nt][2 * h] * inv, o[0][nt][2 * h + 1] * inv);
    if (c == 0)
      args.lse[(static_cast<int64_t>(b) * hq + head) * seq + q0 + rows[h]] = (m[h] + log2f(total)) / kLog2e;
  }
}

// delta[b, h, s] = sum_d dO[b, s, h, d] * O[b, s, h, d]; one warp per (token, head) row
template <typename T>
__global__ void __launch_bounds__(256) flash_delta_kernel(FlashArgs args, int head_dim, int64_t num_rows) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * 8 + (threadIdx.x >> 5);
  if (row >= num_rows) return;
  const int lane = threadIdx.x & 31;
  const T* o = static_cast<const T*>(args.out) + row * head_dim;
  const T* d = static_cast<const T*>(args.dout) + row * head_dim;
  float sum = 0.f;
  for (int i = lane; i < head_dim; i += 32) sum += to_float(o[i]) * to_float(d[i]);
  sum = warp_sum(sum);
  if (lane == 0) {
    const int hq = args.num_q_heads;
    const int64_t token = row / hq;
    const int head = static_cast<int>(row - token * hq);
    const int64_t b = token / args.seq;
    args.delta[(b * hq + head) * args.seq + (token - b * args.seq)] = sum;
  }
}

template <typename T, int D, bool kBias, bool kCausal>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(FlashArgs args) {
  constexpr int LD = D + 8;
  constexpr int NTD = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);
  T* vs = ks + kBlock * LD;
  T* qdo = vs + kBlock * LD;                   // [stage][Q, dO][kBlock][LD]
  T* ps = qdo + kStages<T> * 2 * kBlock * LD;  // P^T, dS^T [kBlock][kLdP] each, scalar path only
  T* dss = ps + kBlock * kLdP;
  // [stage][seg, lse, delta, query bias][kBlock]
  int* stats = reinterpret_cast<int*>(ps + (kMma<T> ? 0 : 2 * kBlock * kLdP));
  int2* ranges = reinterpret_cast<int2*>(stats + kStages<T> * 4 * kBlock);

  const int seq = args.seq;
  const int num_tiles = seq / kBlock;
  const int kt = blockIdx.x;  // the longest column walks first
  const int kv_head = blockIdx.y;
  const int b = blockIdx.z;
  const int hq = args.num_q_heads;
  const int group = hq / args.num_kv_heads;
  const int k0 = kt * kBlock;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
  const int64_t tok0 = static_cast<int64_t>(b) * seq;
  const int* seg_row = args.seg + tok0;
  const T* q = static_cast<const T*>(args.q);
  const T* dout = static_cast<const T*>(args.dout);

  cp_async_tile(ks, LD, static_cast<const T*>(args.k) + (tok0 + k0) * args.k_stride + static_cast<int64_t>(kv_head) * D,
                args.k_stride, kBlock, D);
  cp_async_tile(vs, LD, static_cast<const T*>(args.v) + (tok0 + k0) * args.v_stride + static_cast<int64_t>(kv_head) * D,
                args.v_stride, kBlock, D);
  cp_async_commit();
  tile_ranges(ranges, seg_row, kCausal ? kt : 0, num_tiles);
  __syncthreads();
  const int2 k_range = ranges[kt];
  // work item p = (q head of the group) * num_tiles + query tile; causal: query tiles
  // from kt up (at or below this key tile's diagonal)
  const int end = group * num_tiles;
  auto next = [&](int p) {
    while (p < end) {
      const int qt = p % num_tiles;
      if (kCausal && qt < kt) {
        p += kt - qt;
      } else if (!meets(ranges[qt], k_range)) {
        ++p;
      } else {
        break;
      }
    }
    return p;
  };
  auto fetch = [&](int p, int stage) {
    const int head = kv_head * group + p / num_tiles;
    const int q0 = (p % num_tiles) * kBlock;
    const int64_t stat0 = (static_cast<int64_t>(b) * hq + head) * seq + q0;
    T* dst = qdo + stage * 2 * kBlock * LD;
    cp_async_tile(dst, LD, q + (tok0 + q0) * args.q_stride + static_cast<int64_t>(head) * D, args.q_stride, kBlock, D);
    cp_async_tile(dst + kBlock * LD, LD, dout + ((tok0 + q0) * hq + head) * D, static_cast<int64_t>(hq) * D, kBlock, D);
    int* st = stats + stage * 4 * kBlock;
    cp_async_tile(st, kBlock, seg_row + q0, 0, 1, kBlock);
    cp_async_tile(st + kBlock, kBlock, reinterpret_cast<const int*>(args.lse + stat0), 0, 1, kBlock);
    cp_async_tile(st + 2 * kBlock, kBlock, reinterpret_cast<const int*>(args.delta + stat0), 0, 1, kBlock);
    if constexpr (kBias)
      cp_async_tile(st + 3 * kBlock, kBlock, reinterpret_cast<const int*>(args.bias + stat0), 0, 1, kBlock);
    cp_async_commit();
  };

  const int rows[2] = {warp * 16 + g, warp * 16 + g + 8};  // this lane's key rows
  const int row_seg[2] = {seg_row[k0 + rows[0]], seg_row[k0 + rows[1]]};
  const float scale_log2 = args.scale * kLog2e;
  float dk[1][NTD][4], dv[1][NTD][4];
  zero_acc(dk);
  zero_acc(dv);

  pipeline<T>(next(kCausal ? kt : 0), end, next, fetch, [&](int p, int stage) {
    const T* qs = qdo + stage * 2 * kBlock * LD;
    const T* dos = qs + kBlock * LD;
    const int* segq = stats + stage * 4 * kBlock;
    const float* lse = reinterpret_cast<const float*>(segq + kBlock);
    const float* delta = lse + kBlock;
    const float* qbias = delta + kBlock;
    const int q0 = (p % num_tiles) * kBlock;
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
    if constexpr (kMma<T>) {
      uint32_t af[4][4];
      acc_to_a_frags<8>(af, st);
      warp_gemm_frags<NTD, 4, false>(dv, af, dos, LD);
      acc_to_a_frags<8>(af, dpt);
      warp_gemm_frags<NTD, 4, false>(dk, af, qs, LD);
    } else {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          store_pair(ps + rows[h] * kLdP + nt * 8 + 2 * c, st[0][nt][2 * h], st[0][nt][2 * h + 1]);
          store_pair(dss + rows[h] * kLdP + nt * 8 + 2 * c, dpt[0][nt][2 * h], dpt[0][nt][2 * h + 1]);
        }
      __syncwarp();
      warp_gemm<1, NTD, false>(dv, ps + warp * 16 * kLdP, kLdP, dos, LD, kBlock);
      warp_gemm<1, NTD, false>(dk, dss + warp * 16 * kLdP, kLdP, qs, LD, kBlock);
    }
  });

  T* dk_out = static_cast<T*>(args.dk);
  T* dv_out = static_cast<T*>(args.dv);
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

template <typename T, int D, bool kBias, bool kCausal>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(FlashArgs args) {
  constexpr int LD = D + 8;
  constexpr int NTD = D / 8;
  constexpr int KTD = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* dos = qs + kBlock * LD;
  T* kvs = dos + kBlock * LD;                   // [stage][K, V][kBlock][LD]
  T* dss = kvs + kStages<T> * 2 * kBlock * LD;  // dS [kBlock][kLdP], scalar path only
  int* segk = reinterpret_cast<int*>(dss + (kMma<T> ? 0 : kBlock * kLdP));  // [stage][kBlock]
  float* biask = reinterpret_cast<float*>(segk + kStages<T> * kBlock);      // [stage][kBlock]
  int2* ranges = reinterpret_cast<int2*>(biask + kStages<T> * kBlock);

  const int seq = args.seq;
  const int num_tiles = seq / kBlock;
  const int qt = num_tiles - 1 - blockIdx.x;
  const int end = key_tile_end<kCausal>(qt, num_tiles);
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int hq = args.num_q_heads;
  const int kv_head = head / (hq / args.num_kv_heads);
  const int q0 = qt * kBlock;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
  const int64_t tok0 = static_cast<int64_t>(b) * seq;
  const int64_t stat0 = (static_cast<int64_t>(b) * hq + head) * seq + q0;
  const int* seg_row = args.seg + tok0;
  const T* k_base = static_cast<const T*>(args.k) + tok0 * args.k_stride + static_cast<int64_t>(kv_head) * D;
  const T* v_base = static_cast<const T*>(args.v) + tok0 * args.v_stride + static_cast<int64_t>(kv_head) * D;
  const float* bias_row = kBias ? args.bias + (static_cast<int64_t>(b) * hq + head) * seq : nullptr;

  cp_async_tile(qs, LD, static_cast<const T*>(args.q) + (tok0 + q0) * args.q_stride + static_cast<int64_t>(head) * D,
                args.q_stride, kBlock, D);
  cp_async_tile(dos, LD, static_cast<const T*>(args.dout) + ((tok0 + q0) * hq + head) * D,
                static_cast<int64_t>(hq) * D, kBlock, D);
  cp_async_commit();
  tile_ranges(ranges, seg_row, 0, kCausal ? qt + 1 : num_tiles);
  __syncthreads();
  const int2 q_range = ranges[qt];
  auto next = [&](int t) {
    while (t < end && !meets(ranges[t], q_range)) ++t;
    return t;
  };
  auto fetch = [&](int t, int stage) {
    T* dst = kvs + stage * 2 * kBlock * LD;
    cp_async_tile(dst, LD, k_base + static_cast<int64_t>(t) * kBlock * args.k_stride, args.k_stride, kBlock, D);
    cp_async_tile(dst + kBlock * LD, LD, v_base + static_cast<int64_t>(t) * kBlock * args.v_stride, args.v_stride,
                  kBlock, D);
    cp_async_tile(segk + stage * kBlock, kBlock, seg_row + t * kBlock, 0, 1, kBlock);
    if constexpr (kBias) cp_async_tile(biask + stage * kBlock, kBlock, bias_row + t * kBlock, 0, 1, kBlock);
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
  uint32_t qf[KTD][4];  // Q as mma A fragments (tensor-core path)
  bool q_ready = false;

  pipeline<T>(next(0), end, next, fetch, [&](int kt, int stage) {
    const T* ks = kvs + stage * 2 * kBlock * LD;
    const T* vs = ks + kBlock * LD;
    const int* sk = segk + stage * kBlock;
    const float* bk = biask + stage * kBlock;
    const int k0 = kt * kBlock;
    float s[1][8][4];
    zero_acc(s);
    if constexpr (kMma<T>) {
      if (!q_ready) {
        load_a_frags<KTD>(qf, qs + warp * 16 * LD, LD);
        q_ready = true;
      }
      warp_gemm_frags<8, KTD, true>(s, qf, ks, LD);
    } else {
      warp_gemm<1, 8, true>(s, qs + warp * 16 * LD, LD, ks, LD, D);
    }
    float dp[1][8][4];
    zero_acc(dp);
    warp_gemm<1, 8, true>(dp, dos + warp * 16 * LD, LD, vs, LD, D);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int h = i >> 1;
        const int col = nt * 8 + 2 * c + (i & 1);
        const bool ok = (!kCausal || k0 + col <= q0 + rows[h]) && sk[col] == row_seg[h];
        float dq_score = s[0][nt][i] * scale_log2;
        if constexpr (kBias) dq_score += bias_log2(bk[col], row_bias[h]);
        const float p = ok ? exp2f(dq_score - row_lse[h]) : 0.f;
        s[0][nt][i] = p * (dp[0][nt][i] - row_delta[h]);  // dS
      }
    if constexpr (kMma<T>) {
      uint32_t af[4][4];
      acc_to_a_frags<8>(af, s);
      warp_gemm_frags<NTD, 4, false>(dq, af, ks, LD);
    } else {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          store_pair(dss + rows[h] * kLdP + nt * 8 + 2 * c, s[0][nt][2 * h], s[0][nt][2 * h + 1]);
      __syncwarp();
      warp_gemm<1, NTD, false>(dq, dss + warp * 16 * kLdP, kLdP, ks, LD, kBlock);
    }
  });

  T* dq_out = static_cast<T*>(args.dq);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    T* dst = dq_out + ((tok0 + q0 + rows[h]) * hq + head) * D;
#pragma unroll
    for (int nt = 0; nt < NTD; ++nt)
      store_pair(dst + nt * 8 + 2 * c, dq[0][nt][2 * h] * args.scale, dq[0][nt][2 * h + 1] * args.scale);
  }
}

template <typename Kernel>
cudaError_t launch_kernel(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream, const FlashArgs& args) {
  cudaError_t err = allow_shared_memory(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(args);
  return cudaGetLastError();
}

template <typename T, int D, bool kBias, bool kCausal>
cudaError_t launch_fwd(const FlashArgs& args, int batch, cudaStream_t stream) {
  const int tiles = args.seq / kBlock;
  return launch_kernel(flash_fwd_kernel<T, D, kBias, kCausal>, dim3(tiles, args.num_q_heads, batch),
                       fwd_smem_bytes<T, D>(tiles), stream, args);
}

template <typename T, int D, bool kBias, bool kCausal>
cudaError_t launch_bwd(const FlashArgs& args, int batch, cudaStream_t stream) {
  const int tiles = args.seq / kBlock;
  const int64_t rows = static_cast<int64_t>(batch) * args.seq * args.num_q_heads;
  flash_delta_kernel<T><<<static_cast<unsigned>((rows + 7) / 8), 256, 0, stream>>>(args, D, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_kernel(flash_bwd_dkdv_kernel<T, D, kBias, kCausal>, dim3(tiles, args.num_kv_heads, batch),
                      dkdv_smem_bytes<T, D>(tiles), stream, args);
  if (err != cudaSuccess) return err;
  return launch_kernel(flash_bwd_dq_kernel<T, D, kBias, kCausal>, dim3(tiles, args.num_q_heads, batch),
                       dq_smem_bytes<T, D>(tiles), stream, args);
}

template <typename T, int D, bool kBackward>
cudaError_t dispatch_form(const FlashArgs& args, int batch, bool causal, cudaStream_t stream) {
  const bool bias = args.bias != nullptr;
  if (bias && causal)
    return kBackward ? launch_bwd<T, D, true, true>(args, batch, stream) : launch_fwd<T, D, true, true>(args, batch, stream);
  if (bias)
    return kBackward ? launch_bwd<T, D, true, false>(args, batch, stream) : launch_fwd<T, D, true, false>(args, batch, stream);
  if (causal)
    return kBackward ? launch_bwd<T, D, false, true>(args, batch, stream) : launch_fwd<T, D, false, true>(args, batch, stream);
  return kBackward ? launch_bwd<T, D, false, false>(args, batch, stream) : launch_fwd<T, D, false, false>(args, batch, stream);
}

template <typename T, bool kBackward>
cudaError_t dispatch_dim(const FlashArgs& args, int batch, int head_dim, bool causal, cudaStream_t stream) {
  switch (head_dim) {
    case 64:
      return dispatch_form<T, 64, kBackward>(args, batch, causal, stream);
    case 80:
      return dispatch_form<T, 80, kBackward>(args, batch, causal, stream);
    case 128:
      return dispatch_form<T, 128, kBackward>(args, batch, causal, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool kBackward>
int dispatch(const FlashArgs& args, int batch, int head_dim, bool causal, int dtype, void* stream) {
  if (batch <= 0 || args.seq <= 0) return cudaSuccess;
  if (args.seq % kBlock || args.num_q_heads % args.num_kv_heads) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case dolo::kFloat32:
      return dispatch_dim<float, kBackward>(args, batch, head_dim, causal, s);
    case dolo::kBFloat16:
      return dispatch_dim<__nv_bfloat16, kBackward>(args, batch, head_dim, causal, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// bias: [B, Hq, S] fp32 or null; causal: 0 or 1
extern "C" int dolo_flash_fwd(const void* q, const void* k, const void* v, const void* seg,
                              const void* bias, void* out, void* lse, int batch, int seq,
                              int num_q_heads, int num_kv_heads, int head_dim, int q_stride,
                              int k_stride, int v_stride, int causal, float scale, int dtype,
                              void* stream) {
  FlashArgs args{};
  args.q = q;
  args.k = k;
  args.v = v;
  args.seg = static_cast<const int*>(seg);
  args.bias = static_cast<const float*>(bias);
  args.o_write = out;
  args.lse = static_cast<float*>(lse);
  args.seq = seq;
  args.num_q_heads = num_q_heads;
  args.num_kv_heads = num_kv_heads;
  args.q_stride = q_stride;
  args.k_stride = k_stride;
  args.v_stride = v_stride;
  args.scale = scale;
  return dispatch<false>(args, batch, head_dim, causal != 0, dtype, stream);
}

extern "C" int dolo_flash_bwd(const void* q, const void* k, const void* v, const void* seg,
                              const void* bias, const void* out, const void* dout, const void* lse,
                              void* delta, void* dq, void* dk, void* dv, int batch, int seq,
                              int num_q_heads, int num_kv_heads, int head_dim, int q_stride,
                              int k_stride, int v_stride, int causal, float scale, int dtype,
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
