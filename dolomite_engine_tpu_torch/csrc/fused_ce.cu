// Fused LM-head cross-entropy for one loss chunk: per-row logsumexp and label logit of
// hidden @ table^T without writing the [rows, V] logits to device memory.
//
// Replaces the Pallas kernel `fused_ce_rowwise` (dolomite_engine_tpu/ops/pallas/fused_ce.py:104,
// `_fused_ce_kernel`), which the chunked fused loss (`ops/loss.fused_linear_cross_entropy`)
// runs once per chunk. Numerics are the TPU kernel's: the product accumulates in fp32,
// is rounded to the compute type when that is bf16, is scaled by `logit_scale` in the
// compute type, and is reduced in fp32 with the online max / sum; vocab columns >= V
// never enter the reduction; a label outside [0, V) (IGNORE_INDEX) hits nothing.
//
// What bounds it on an H100 (bf16, 3.35 TB/s, 989 TFLOP/s): one launch reads the whole
// [V, H] table for rows x 2 x V x H operations. The dense chunk, [256, 2560] x
// [49152, 2560], is bound by the table's 252 MB (0.075 ms; operations 0.065 ms); the MoE
// chunk, [512, 1024] x [49152, 1024], and the alibi chunk, [512, 4096] x [50432, 4096],
// by the operations (0.052 and 0.214 ms). So the table must come from device memory once
// a launch, and the tensor cores must be fed from shared memory without a stall.
//
// The bf16 design (namespace wg): a persistent grid of one CTA an SM. A CTA holds 128
// rows (two consumer warpgroups of 64) and walks a contiguous range of 256-column vocab
// tiles. One producer thread streams 64-wide H slices of the CTA's hidden rows and of the
// tile's table rows through a 4-stage mbarrier ring by TMA (128-byte swizzle; the copy
// engine zero-fills an H, row or vocab edge), and each warpgroup runs `wgmma` m64n256k16
// from shared memory into 128 fp32 accumulators a thread. After a tile's last slice the
// warpgroup rounds its logits to bf16, masks the columns >= V (the last tile only), picks
// the label's logit (only where a label of the warp's rows lies in the tile) and folds
// the tile into each row's running (max, sum of exp) in registers (ex2 of log2(e)-scaled
// values, in four interleaved partial chains), while the producer loads the next tile.
// The row blocks of one vocab range are neighbouring CTAs that walk the same tiles
// together, so a table tile comes from device memory once and its second reader finds it
// in L2; a 128 x 256 tile keeps the hidden rows' L2 reads at half the table's for each
// row block (at 256 rows, equal to the table's bytes). (A 256 x 256 tile's fp32
// accumulators would fill the register file; sharing each table tile between two row
// blocks by TMA multicast in a 2-CTA cluster ran slower on an H100, PERF.md.) Each CTA writes
// one (max, sum, label logit) partial per row and vocab range ([3, splits, rows]), and a
// small second launch combines them in a fixed order: no atomics, the same bits every run.
//
// fp32 inputs (off the training paths) keep the first design: one block per (128-row,
// 128-column) tile, the product by scalar FMA through a two-stage cp.async ring, a
// partial per vocab tile ([3, ceil(V / 128), rows]), the same combine.
#include <algorithm>

#include "mma.cuh"
#include "sm90.cuh"

namespace dolo {
namespace {

// ----------------------------------------------------------------- fp32: the scalar tiles

constexpr int kBM = 128;  // rows per block
constexpr int kBN = 128;  // vocab columns per block
constexpr int kBK = 32;   // hidden slice per pipeline stage
constexpr int kLd = kBK + 8;
constexpr int kThreads = 256;
constexpr size_t kPartialSmemBytes = 2 * (kBM + kBN) * kLd * sizeof(float) + 2 * kBM * 3 * sizeof(float);

__global__ void __launch_bounds__(kThreads) fused_ce_partial_kernel(
    const float* __restrict__ hidden,  // [rows, H]
    const float* __restrict__ table,   // [V, H]
    const int* __restrict__ labels,    // [rows]
    float* __restrict__ partial,       // [3, num_col_tiles, rows]: max, sum of exp, label logit
    int rows, int hidden_dim, int vocab, float scale, int has_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* as = reinterpret_cast<float*>(smem_raw);  // [2][kBM][kLd]
  float* bs = as + 2 * kBM * kLd;                  // [2][kBN][kLd]
  float* red = bs + 2 * kBN * kLd;                 // [2][kBM][3]

  const int row0 = blockIdx.x * kBM;
  const int col0 = blockIdx.y * kBN;
  const int num_col_tiles = gridDim.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
  const int warp_m = warp >> 1;  // 32 rows each
  const int warp_n = warp & 1;   // 64 columns each

  constexpr int kVec = 4;
  constexpr int kVecs = kBK / kVec;
  auto load_stage = [&](int stage, int k0) {
    float* a = as + stage * kBM * kLd;
    float* b = bs + stage * kBN * kLd;
    for (int i = threadIdx.x; i < kBM * kVecs; i += kThreads) {
      const int r = i / kVecs;
      const int v = i - r * kVecs;
      const bool ok = row0 + r < rows;
      const float* src = hidden + static_cast<int64_t>(ok ? row0 + r : 0) * hidden_dim + k0 + v * kVec;
      cp_async_16(a + r * kLd + v * kVec, src, ok);
    }
    for (int i = threadIdx.x; i < kBN * kVecs; i += kThreads) {
      const int r = i / kVecs;
      const int v = i - r * kVecs;
      const bool ok = col0 + r < vocab;
      const float* src = table + static_cast<int64_t>(ok ? col0 + r : 0) * hidden_dim + k0 + v * kVec;
      cp_async_16(b + r * kLd + v * kVec, src, ok);
    }
    cp_async_commit();
  };

  float acc[2][8][4];
  zero_acc(acc);
  const int num_k = hidden_dim / kBK;
  load_stage(0, 0);
  for (int kk = 0; kk < num_k; ++kk) {
    if (kk + 1 < num_k) {
      load_stage((kk + 1) & 1, (kk + 1) * kBK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int stage = kk & 1;
    warp_gemm<2, 8, true>(acc, as + stage * kBM * kLd + warp_m * 32 * kLd, kLd,
                          bs + stage * kBN * kLd + warp_n * 64 * kLd, kLd, kBK);
    __syncthreads();  // the stage is refilled next iteration
  }

  // per row of this lane: max, sum of exp and label logit over its warp's 64 columns
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp_m * 32 + mt * 16 + g + h * 8;
      const int label = row0 + r < rows ? labels[row0 + r] : -1;
      float x[16];
      float mx = -INFINITY;
      float lab = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = col0 + warp_n * 64 + nt * 8 + 2 * c + j;
          const float acc_value = acc[mt][nt][2 * h + j];
          const float value = has_scale ? acc_value * scale : acc_value;
          const bool valid = col < vocab;
          x[nt * 2 + j] = valid ? value : -INFINITY;
          mx = fmaxf(mx, x[nt * 2 + j]);
          if (valid && col == label) lab += value;
        }
      mx = quad_max(mx);
      float sum = 0.f;
      if (mx != -INFINITY) {
#pragma unroll
        for (int i = 0; i < 16; ++i) sum += expf(x[i] - mx);
      }
      sum = quad_sum(sum);
      lab = quad_sum(lab);
      if (c == 0) {
        float* slot = red + (warp_n * kBM + r) * 3;
        slot[0] = mx;
        slot[1] = sum;
        slot[2] = lab;
      }
    }
  __syncthreads();

  // the two column halves of each row -> this block's partial (column 0 is always < V)
  for (int r = threadIdx.x; r < kBM; r += kThreads) {
    if (row0 + r >= rows) continue;
    const float* a = red + r * 3;
    const float* b = red + (kBM + r) * 3;
    const float m = fmaxf(a[0], b[0]);
    const float s = a[1] * expf(a[0] - m) + (b[0] == -INFINITY ? 0.f : b[1] * expf(b[0] - m));
    const int64_t base = static_cast<int64_t>(blockIdx.y) * rows + row0 + r;
    const int64_t plane = static_cast<int64_t>(num_col_tiles) * rows;
    partial[base] = m;
    partial[plane + base] = s;
    partial[2 * plane + base] = a[2] + b[2];
  }
}

// lse = M + log(sum_t s_t exp(m_t - M)), label logit = sum_t lab_t over the `parts`
// partials of each row, in order; one warp per row
__global__ void __launch_bounds__(256) fused_ce_combine_kernel(
    const float* __restrict__ partial, float* __restrict__ lse, float* __restrict__ label_logit,
    int rows, int parts) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const int64_t plane = static_cast<int64_t>(parts) * rows;
  float m = -INFINITY;
  for (int t = lane; t < parts; t += 32) m = fmaxf(m, partial[static_cast<int64_t>(t) * rows + row]);
  m = warp_max(m);
  float s = 0.f, lab = 0.f;
  for (int t = lane; t < parts; t += 32) {
    const int64_t i = static_cast<int64_t>(t) * rows + row;
    s += partial[plane + i] * expf(partial[i] - m);
    lab += partial[2 * plane + i];
  }
  s = warp_sum(s);
  lab = warp_sum(lab);
  if (lane == 0) {
    lse[row] = m + logf(s);
    label_logit[row] = lab;
  }
}

cudaError_t launch_combine(const float* partial, float* lse, float* label_logit, int rows, int parts,
                           cudaStream_t stream) {
  fused_ce_combine_kernel<<<(rows + 7) / 8, 256, 0, stream>>>(partial, lse, label_logit, rows, parts);
  return cudaGetLastError();
}

cudaError_t launch_fp32(const void* hidden, const void* table, const int* labels, float* partial, float* lse,
                        float* label_logit, int rows, int hidden_dim, int vocab, float scale, int has_scale,
                        cudaStream_t stream) {
  cudaError_t err = allow_shared_memory(fused_ce_partial_kernel, kPartialSmemBytes);
  if (err != cudaSuccess) return err;
  const int col_tiles = (vocab + kBN - 1) / kBN;
  fused_ce_partial_kernel<<<dim3((rows + kBM - 1) / kBM, col_tiles), kThreads, kPartialSmemBytes, stream>>>(
      static_cast<const float*>(hidden), static_cast<const float*>(table), labels, partial, rows, hidden_dim,
      vocab, scale, has_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_combine(partial, lse, label_logit, rows, col_tiles, stream);
}

// ------------------------------------------------------------------- bf16: wgmma and TMA

namespace wg {

constexpr int kRows = 128;  // hidden rows of a CTA: 64 per consumer warpgroup
constexpr int kCols = 256;  // vocab columns of a tile
constexpr int kDepth = 64;  // H of a stage: 64 bf16, one 128-byte row
constexpr int kRowBytes = 128;
constexpr int kHiddenBytes = kRows * kRowBytes;  // 16 KB
constexpr int kTableBytes = kCols * kRowBytes;   // 32 KB
constexpr int kStageBytes = kHiddenBytes + kTableBytes;
constexpr int kStages = 4;
constexpr int kConsumers = 256;             // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup
// setmaxnreg moves registers from the producer to the consumers (2 x 128 x 232 + 128 x 40
// <= 65536): 128 accumulators a thread and the epilogue's
constexpr int kConsumerRegs = 232;
constexpr int kProducerRegs = 40;
constexpr size_t kSmemBytes = 1024 + static_cast<size_t>(kStages) * kStageBytes + 2 * kStages * 8;
constexpr float kLog2e = 1.4426950408889634f;

// grid: row_blocks x splits CTAs, the row blocks of a vocab range neighbours in launch
// order. h_map: hidden [rows, H], box {64, 128}; t_map: table [V, H], box {64, 256}.
// partial: [3, splits, rows].
template <bool kScale>
__global__ void __launch_bounds__(kThreads, 1)
    fused_ce_wgmma_kernel(const __grid_constant__ CUtensorMap h_map, const __grid_constant__ CUtensorMap t_map,
                          const int* __restrict__ labels, float* __restrict__ partial, int rows, int hidden_dim,
                          int vocab, int row_blocks, int splits, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = sm90::align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStageBytes);
  uint64_t* empty = full + kStages;

  const int row0 = static_cast<int>(blockIdx.x % row_blocks) * kRows;
  const int split = static_cast<int>(blockIdx.x / row_blocks);
  const int tiles = (vocab + kCols - 1) / kCols;
  const int tile_begin = static_cast<int>(static_cast<int64_t>(split) * tiles / splits);
  const int tile_end = static_cast<int>(static_cast<int64_t>(split + 1) * tiles / splits);
  const int num_k = (hidden_dim + kDepth - 1) / kDepth;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 2);  // each consumer warpgroup
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // producer
    sm90::warpgroup_reg_dealloc<kProducerRegs>();
    if (threadIdx.x == kConsumers) {
      sm90::prefetch_tensor_map(&h_map);
      sm90::prefetch_tensor_map(&t_map);
      int g = 0;  // stages issued so far, over all this CTA's tiles
      for (int tile = tile_begin; tile < tile_end; ++tile) {
        for (int kt = 0; kt < num_k; ++kt, ++g) {
          const int s = g % kStages;
          if (g >= kStages) sm90::mbar_wait(&empty[s], (g / kStages - 1) & 1);
          unsigned char* stage = ring + s * kStageBytes;
          const int k0 = kt * kDepth;
          sm90::mbar_arrive_expect_tx(&full[s], kStageBytes);
          sm90::tma_load_2d(stage, &h_map, &full[s], k0, row0);
          sm90::tma_load_2d(stage + kHiddenBytes, &t_map, &full[s], k0, tile * kCols);
        }
      }
    }
  } else {  // consumers: warpgroup w owns rows [row0 + 64 w, + 64); this thread two of them
    sm90::warpgroup_reg_alloc<kConsumerRegs>();
    const int wg = sm90::uniform(static_cast<int>(threadIdx.x) / 128);
    const int t = static_cast<int>(threadIdx.x) % 128;
    const int c = t % 4;
    const int row = row0 + 64 * wg + 16 * (t / 32) + (t % 32) / 4;  // and row + 8
    int label[2];
    float m[2] = {-INFINITY, -INFINITY};  // running max of this thread's columns
    float l[2] = {0.f, 0.f};              // and its sum of exp(x - m)
    float lab[2] = {0.f, 0.f};            // the label's logit, where this thread holds it
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int y = row + 8 * h < rows ? labels[row + 8 * h] : -1;
      label[h] = y >= 0 && y < vocab ? y : -1;  // -1 hits no column
    }
    const float scale_c = kScale ? round_to<__nv_bfloat16>(scale) : 1.f;
    float acc[kCols / 2];

    // one tile's logits into the running (max, sum) of each row, in place: x = the logit
    // rounded to bf16 (and scaled in bf16), -inf past the vocabulary. The max and the sum
    // run in kChains interleaved partials (a fixed order), so the dependent chains are short.
    auto fold = [&](int col0, auto masked) {
      constexpr int kChains = 4;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float part[kChains];
#pragma unroll
        for (int k = 0; k < kChains; ++k) part[k] = -INFINITY;
#pragma unroll
        for (int j = 0; j < kCols / 8; ++j) {
          const int i = 4 * j + 2 * h;
          const float2 pair = __bfloat1622float2(__floats2bfloat162_rn(acc[i], acc[i + 1]));
          float x[2] = {pair.x, pair.y};
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if constexpr (kScale) x[e] = round_to<__nv_bfloat16>(x[e] * scale_c);
            if constexpr (decltype(masked)::value)
              if (col0 + 8 * j + 2 * c + e >= vocab) x[e] = -INFINITY;
            acc[i + e] = x[e];
          }
          part[j % kChains] = fmaxf(part[j % kChains], fmaxf(x[0], x[1]));
        }
        // the label's place among this thread's columns; most tiles hold no label of the warp's rows
        const int off = label[h] - col0 - 2 * c;
        if (__any_sync(0xffffffffu, static_cast<unsigned>(off) < static_cast<unsigned>(kCols))) {
#pragma unroll
          for (int j = 0; j < kCols / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) lab[h] += 8 * j + e == off ? acc[4 * j + 2 * h + e] : 0.f;
        }
        const float m_new = fmaxf(m[h], fmaxf(fmaxf(part[0], part[1]), fmaxf(part[2], part[3])));
        const float neg = -(m_new == -INFINITY ? 0.f : m_new) * kLog2e;  // no column seen yet: any base
#pragma unroll
        for (int k = 0; k < kChains; ++k) part[k] = 0.f;
#pragma unroll
        for (int j = 0; j < kCols / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) part[j % kChains] += sm90::fast_exp2(fmaf(acc[4 * j + 2 * h + e], kLog2e, neg));
        l[h] = l[h] * sm90::fast_exp2(fmaf(m[h], kLog2e, neg)) + ((part[0] + part[1]) + (part[2] + part[3]));
        m[h] = m_new;
      }
    };

    int g = 0;  // stages consumed so far
    for (int tile = tile_begin; tile < tile_end; ++tile) {
#pragma unroll
      for (int i = 0; i < kCols / 2; ++i) acc[i] = 0.f;
      for (int kt = 0; kt < num_k; ++kt, ++g) {
        const int s = g % kStages;
        sm90::mbar_wait_warp(&full[s], (g / kStages) & 1);
        const unsigned char* stage = ring + s * kStageBytes;
        sm90::fence_operands(acc);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kDepth / 16; ++kk)  // A: this warpgroup's 64 hidden rows, B: the tile, both K-major
          sm90::wgmma_m64n256k16<0, 0>(acc, sm90::smem_desc(stage + 64 * wg * kRowBytes + 32 * kk, 16, 1024),
                                       sm90::smem_desc(stage + kHiddenBytes + 32 * kk, 16, 1024));
        sm90::wgmma_commit();
        sm90::wgmma_wait<1>();  // the previous stage's products are done: release it
        sm90::fence_operands(acc);
        if (kt > 0) sm90::mbar_arrive_if(&empty[(g - 1) % kStages], t == 0);
      }
      sm90::wgmma_wait<0>();
      sm90::fence_operands(acc);
      sm90::mbar_arrive_if(&empty[(g - 1) % kStages], t == 0);
      const int col0 = tile * kCols;
      const bool tail = sm90::uniform(col0 + kCols > vocab);  // only the last tile has columns past V
      if (tail) {
        fold(col0, std::true_type{});
      } else {
        fold(col0, std::false_type{});
      }
    }

    // the four threads of a row hold its columns between them: merge, then one writes
    const int64_t plane = static_cast<int64_t>(splits) * rows;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float row_max = quad_max(m[h]);
      const float neg = -(row_max == -INFINITY ? 0.f : row_max) * kLog2e;
      const float row_sum = quad_sum(l[h] * sm90::fast_exp2(fmaf(m[h], kLog2e, neg)));
      const float row_lab = quad_sum(lab[h]);
      if (c == 0 && row + 8 * h < rows) {
        const int64_t i = static_cast<int64_t>(split) * rows + row + 8 * h;
        partial[i] = row_max;
        partial[plane + i] = row_sum;
        partial[2 * plane + i] = row_lab;
      }
    }
  }
}

struct Plan {
  int row_blocks;  // CTAs along the rows
  int splits;      // vocab ranges
};

// One CTA an SM: the row blocks of a vocab range side by side, as many ranges as fit.
cudaError_t plan(int rows, int vocab, Plan* p) {
  int sms = 0;
  const cudaError_t err = sm90::sm_count(&sms);
  if (err != cudaSuccess) return err;
  p->row_blocks = (rows + kRows - 1) / kRows;
  const int tiles = (vocab + kCols - 1) / kCols;
  p->splits = std::max(1, std::min(tiles, sms / p->row_blocks));
  return cudaSuccess;
}

template <bool kScale>
cudaError_t launch_kernel(const CUtensorMap& h_map, const CUtensorMap& t_map, const int* labels, float* partial,
                          int rows, int hidden_dim, int vocab, const Plan& p, float scale, cudaStream_t stream) {
  auto kernel = fused_ce_wgmma_kernel<kScale>;
  const cudaError_t err = allow_shared_memory(kernel, kSmemBytes);
  if (err != cudaSuccess) return err;
  kernel<<<p.row_blocks * p.splits, kThreads, kSmemBytes, stream>>>(h_map, t_map, labels, partial, rows, hidden_dim,
                                                                     vocab, p.row_blocks, p.splits, scale);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const void* hidden, const void* table, const int* labels, float* partial, float* lse,
                        float* label_logit, int rows, int hidden_dim, int vocab, float scale, int has_scale,
                        cudaStream_t stream) {
  Plan p;
  cudaError_t err = plan(rows, vocab, &p);
  if (err != cudaSuccess) return err;
  CUtensorMap h_map, t_map;
  const uint64_t strides[1] = {static_cast<uint64_t>(hidden_dim) * 2};
  const uint64_t h_dims[2] = {static_cast<uint64_t>(hidden_dim), static_cast<uint64_t>(rows)};
  const uint32_t h_box[2] = {kDepth, kRows};
  err = sm90::bf16_tensor_map(&h_map, hidden, 2, h_dims, strides, h_box);
  if (err != cudaSuccess) return err;
  const uint64_t t_dims[2] = {static_cast<uint64_t>(hidden_dim), static_cast<uint64_t>(vocab)};
  const uint32_t t_box[2] = {kDepth, kCols};
  err = sm90::bf16_tensor_map(&t_map, table, 2, t_dims, strides, t_box);
  if (err != cudaSuccess) return err;
  err = has_scale ? launch_kernel<true>(h_map, t_map, labels, partial, rows, hidden_dim, vocab, p, scale, stream)
                  : launch_kernel<false>(h_map, t_map, labels, partial, rows, hidden_dim, vocab, p, scale, stream);
  if (err != cudaSuccess) return err;
  return launch_combine(partial, lse, label_logit, rows, p.splits, stream);
}

}  // namespace wg

}  // namespace
}  // namespace dolo

// (lse, label logit) of each of `rows` rows; `partial` holds dolo_fused_ce_scratch_floats
// floats. Returns the launches' cudaError_t.
extern "C" int dolo_fused_ce(const void* hidden, const void* table, const void* labels, void* partial, void* lse,
                             void* label_logit, int rows, int hidden_dim, int vocab, float scale, int has_scale,
                             int dtype, void* stream) {
  using namespace dolo;
  if (rows <= 0) return cudaSuccess;
  if (vocab <= 0 || hidden_dim % kBK) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* y = static_cast<const int*>(labels);
  float* p = static_cast<float*>(partial);
  float* out_lse = static_cast<float*>(lse);
  float* out_lab = static_cast<float*>(label_logit);
  switch (dtype) {
    case kFloat32:
      return launch_fp32(hidden, table, y, p, out_lse, out_lab, rows, hidden_dim, vocab, scale, has_scale, s);
    case kBFloat16:
      return wg::launch_bf16(hidden, table, y, p, out_lse, out_lab, rows, hidden_dim, vocab, scale, has_scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// Floats of scratch the wrapper allocates for the partials: 3 x (ceil(V / 128) fp32, or
// the bf16 grid's vocab ranges) x rows; minus the cudaError_t on an error.
extern "C" int dolo_fused_ce_scratch_floats(int rows, int vocab, int dtype) {
  using namespace dolo;
  if (dtype != kBFloat16) return 3 * ((vocab + kBN - 1) / kBN) * rows;
  wg::Plan p;
  const cudaError_t err = wg::plan(rows, vocab, &p);
  return err == cudaSuccess ? 3 * p.splits * rows : -static_cast<int>(err);
}
