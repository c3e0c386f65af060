// Fused LM-head cross-entropy for one loss chunk: per-row logsumexp and label logit of
// hidden @ table^T without writing the [rows, V] logits to device memory.
//
// Replaces the Pallas kernel `fused_ce_rowwise` (dolomite_engine_tpu/ops/pallas/fused_ce.py,
// `_fused_ce_kernel`), which the chunked fused loss (`ops/loss.fused_linear_cross_entropy`)
// runs once per chunk. Numerics are the TPU kernel's: the product accumulates in fp32,
// is rounded to the compute type when that is bf16, is scaled by `logit_scale` in the
// compute type, and is reduced in fp32 with the online max / sum; vocab columns >= V
// never enter the reduction; a label outside [0, V) (IGNORE_INDEX) hits nothing.
//
// Bound on the H100: bytes. One launch reads the whole [V, H] table (252 MB in bf16 at
// granite-3b's 49152 x 2560) for 256 rows, about 0.075 ms at 3.35 TB/s, against 0.065 ms
// of bf16 tensor-core arithmetic. Design: a 256-row chunk gives only two 128-row tiles,
// so the grid also splits the vocabulary: one block of 8 warps per (128-row tile,
// 128-column vocab tile) runs the tile's product on the tensor cores (mma.sync bf16,
// fp32 accumulate; fp32 inputs take scalar FMA), streaming H in 32-wide slices through a
// two-stage cp.async ring, and reduces its 128 x 128 logits to a partial (max, sum of
// exp, label logit) per row. The row tiles of one vocab tile are adjacent in launch
// order, so the second read of a table slice comes from L2. A second small launch
// combines the partials of every vocab tile per row.
#include "mma.cuh"

namespace {

using namespace dolo;

constexpr int kBM = 128;  // rows per block
constexpr int kBN = 128;  // vocab columns per block
constexpr int kBK = 32;   // hidden slice per pipeline stage
constexpr int kLd = kBK + 8;
constexpr int kThreads = 256;

template <typename T>
constexpr size_t partial_smem_bytes() {
  return 2 * (kBM + kBN) * kLd * sizeof(T) + 2 * kBM * 3 * sizeof(float);
}

// The logit the TPU kernel reduces: rounded to the compute type, scaled in it.
__device__ __forceinline__ float logit_value(float acc, float scale, bool has_scale, float) {
  return has_scale ? acc * scale : acc;
}
__device__ __forceinline__ float logit_value(float acc, float scale, bool has_scale,
                                             __nv_bfloat16) {
  const float x = round_to<__nv_bfloat16>(acc);
  return has_scale ? round_to<__nv_bfloat16>(x * round_to<__nv_bfloat16>(scale)) : x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) fused_ce_partial_kernel(
    const T* __restrict__ hidden,  // [rows, H]
    const T* __restrict__ table,   // [V, H]
    const int* __restrict__ labels,  // [rows]
    float* __restrict__ partial,   // [3, num_col_tiles, rows]: max, sum of exp, label logit
    int rows, int hidden_dim, int vocab, float scale, int has_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* as = reinterpret_cast<T*>(smem_raw);  // [2][kBM][kLd]
  T* bs = as + 2 * kBM * kLd;              // [2][kBN][kLd]
  float* red = reinterpret_cast<float*>(bs + 2 * kBN * kLd);  // [2][kBM][3]

  const int row0 = blockIdx.x * kBM;
  const int col0 = blockIdx.y * kBN;
  const int num_col_tiles = gridDim.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
  const int warp_m = warp >> 1;  // 32 rows each
  const int warp_n = warp & 1;   // 64 columns each

  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVecs = kBK / kVec;
  auto load_stage = [&](int stage, int k0) {
    T* a = as + stage * kBM * kLd;
    T* b = bs + stage * kBN * kLd;
    for (int i = threadIdx.x; i < kBM * kVecs; i += kThreads) {
      const int r = i / kVecs;
      const int v = i - r * kVecs;
      const bool ok = row0 + r < rows;
      const T* src = hidden + static_cast<int64_t>(ok ? row0 + r : 0) * hidden_dim + k0 + v * kVec;
      cp_async_16(a + r * kLd + v * kVec, src, ok);
    }
    for (int i = threadIdx.x; i < kBN * kVecs; i += kThreads) {
      const int r = i / kVecs;
      const int v = i - r * kVecs;
      const bool ok = col0 + r < vocab;
      const T* src = table + static_cast<int64_t>(ok ? col0 + r : 0) * hidden_dim + k0 + v * kVec;
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
          const float value = logit_value(acc[mt][nt][2 * h + j], scale, has_scale, T());
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

// lse = M + log(sum_t s_t exp(m_t - M)), label logit = sum_t lab_t; one warp per row
__global__ void __launch_bounds__(256) fused_ce_combine_kernel(
    const float* __restrict__ partial, float* __restrict__ lse, float* __restrict__ label_logit,
    int rows, int num_col_tiles) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const int64_t plane = static_cast<int64_t>(num_col_tiles) * rows;
  float m = -INFINITY;
  for (int t = lane; t < num_col_tiles; t += 32) m = fmaxf(m, partial[static_cast<int64_t>(t) * rows + row]);
  m = warp_max(m);
  float s = 0.f, lab = 0.f;
  for (int t = lane; t < num_col_tiles; t += 32) {
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

template <typename T>
cudaError_t launch(const void* hidden, const void* table, const int* labels, float* partial,
                   float* lse, float* label_logit, int rows, int hidden_dim, int vocab,
                   float scale, int has_scale, cudaStream_t stream) {
  const size_t smem = partial_smem_bytes<T>();
  auto kernel = fused_ce_partial_kernel<T>;
  cudaError_t err = allow_shared_memory(kernel, smem);
  if (err != cudaSuccess) return err;
  const int col_tiles = (vocab + kBN - 1) / kBN;
  kernel<<<dim3((rows + kBM - 1) / kBM, col_tiles), kThreads, smem, stream>>>(
      static_cast<const T*>(hidden), static_cast<const T*>(table), labels, partial, rows,
      hidden_dim, vocab, scale, has_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fused_ce_combine_kernel<<<(rows + 7) / 8, 256, 0, stream>>>(partial, lse, label_logit, rows,
                                                              col_tiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" int dolo_fused_ce(const void* hidden, const void* table, const void* labels,
                             void* partial, void* lse, void* label_logit, int rows,
                             int hidden_dim, int vocab, float scale, int has_scale, int dtype,
                             void* stream) {
  if (rows <= 0) return cudaSuccess;
  if (vocab <= 0 || hidden_dim % kBK) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* y = static_cast<const int*>(labels);
  float* p = static_cast<float*>(partial);
  float* out_lse = static_cast<float*>(lse);
  float* out_lab = static_cast<float*>(label_logit);
  switch (dtype) {
    case dolo::kFloat32:
      return launch<float>(hidden, table, y, p, out_lse, out_lab, rows, hidden_dim, vocab, scale,
                           has_scale, s);
    case dolo::kBFloat16:
      return launch<__nv_bfloat16>(hidden, table, y, p, out_lse, out_lab, rows, hidden_dim, vocab,
                                   scale, has_scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// Floats of scratch the wrapper allocates for the partials: 3 * ceil(V / 128) * rows.
extern "C" int dolo_fused_ce_scratch_floats(int rows, int vocab) {
  return 3 * ((vocab + kBN - 1) / kBN) * rows;
}
