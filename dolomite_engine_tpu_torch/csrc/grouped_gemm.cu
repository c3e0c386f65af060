// Grouped GEMMs of the MoE expert MLPs over the expert-sorted, block-padded layout.
//
// Replace the TPU kernels `_gmm_call` and `_tgmm_call` (dolomite_engine_tpu/ops/pallas/
// moe.py:78 and :100). The rows of every expert are padded to whole blocks of `bm` rows
// (bm in {8, 16, 32, 64, 128}, or the row count below 8), every expert owns at least one
// block, and `block_expert[b]` names block b's expert bank.
//
// - `gmm`: out[b*bm : (b+1)*bm] = xp[b*bm : (b+1)*bm] @ B_e with B_e = w[e] ([E, K, N])
//   or, for dX in the backward, B_e = w[e]^T read in place from w ([E, N, K]): no
//   transposed copy of the banks. One CTA per (row block, 128-column tile) reads its
//   block's expert from device memory (the counterpart of the scalar prefetch). Rows at
//   or past `block_valid[b]` are padding: they read as zero and are written as zero, and
//   a block with no real row writes its zeros without reading its bank, so a decode step
//   reads only the banks that tokens were routed to.
// - `tgmm`: dW[e] = sum over expert e's real rows of xp_r^T dy_r, in fp32. The Pallas
//   kernel carries the sum across its sequential grid (consecutive blocks of one expert
//   revisit one output block); Hopper blocks run in no order, so one CTA per (expert,
//   128 x 128 output tile) walks the expert's rows itself (start = the padded-layout
//   offset, count = the group size) and writes its tile once: no atomics, deterministic.
//   An expert with no rows writes zeros, as the Pallas kernel's zero-row block does.
//
// Bound on an H100: decode (32 rows) reads whole expert banks for a few rows each, so it
// is bound by the banks' bytes; prefill and training (2048-16384 rows over 32 experts)
// are bound by the tensor cores. Tiles are 128 columns wide and 32 deep, double-buffered
// through cp.async, with bf16 mma.sync m16n8k16 and fp32 accumulation; fp32 inputs (the
// tolerance cases) take the same tiles through scalar FMA, never TF32. K and N need not
// be multiples of the tile: edges are zero-filled on load and masked on store.
#include "common.cuh"
#include "mma.cuh"

namespace dolo {
namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kTileN = 128;    // output columns of a CTA
constexpr int kTileK = 32;     // reduction depth of one pipeline stage
constexpr int kTileM = 128;    // tgmm: output rows (the bank's K dim) of a CTA

template <typename T>
constexpr int pad() {
  return 16 / static_cast<int>(sizeof(T));  // one 16-byte vector: conflict-free ldmatrix rows
}

// Copy a [rows, cols] tile (cols a multiple of the 16-byte vector) from global memory
// (row stride `stride`) into shared memory (row pitch `ld`), asynchronously where a whole
// aligned vector is in bounds; elements outside [rows_valid, cols_valid) read as zero.
template <typename T>
__device__ __forceinline__ void load_tile_masked(T* dst, int ld, const T* src, int64_t stride, int rows,
                                          int cols, int rows_valid, int cols_valid, bool vec_ok) {
  constexpr int kVec = 16 / sizeof(T);
  const int vecs = cols / kVec;
  for (int i = threadIdx.x; i < rows * vecs; i += blockDim.x) {
    const int r = i / vecs;
    const int c = (i - r * vecs) * kVec;
    T* d = dst + r * ld + c;
    const bool row_in = r < rows_valid;
    if (vec_ok && (!row_in || c >= cols_valid || c + kVec <= cols_valid)) {
      const bool in = row_in && c < cols_valid;
      cp_async_16(d, in ? src + r * stride + c : src, in);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        d[j] = (row_in && c + j < cols_valid) ? src[r * stride + c + j] : from_float<T>(0.f);
    }
  }
}

// acc += A * B with A stored transposed in shared memory, A(m, k) = a[k * lda + m], and
// B(k, n) = b[k * ldb + n] (both tiles are row blocks of the token dimension).
template <int MT, int NT>
__device__ __forceinline__ void warp_gemm_at(float (&acc)[MT][NT][4], const __nv_bfloat16* a,
                                             int lda, const __nv_bfloat16* b, int ldb, int K) {
  const int lane = threadIdx.x & 31;
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t af[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int k = k0 + (lane & 7) + (lane >> 4) * 8;
      const int m = mt * 16 + ((lane >> 3) & 1) * 8;
      ldmatrix_x4_trans(af[mt], a + k * lda + m);
    }
#pragma unroll
    for (int nt = 0; nt < NT; nt += 2) {
      uint32_t bf[4];
      const int k = k0 + (lane & 7) + ((lane >> 3) & 1) * 8;
      const int n = nt * 8 + (lane >> 4) * 8;
      ldmatrix_x4_trans(bf, b + k * ldb + n);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16_16816(acc[mt][nt], af[mt], bf[0], bf[1]);
        mma_bf16_16816(acc[mt][nt + 1], af[mt], bf[2], bf[3]);
      }
    }
  }
}

template <int MT, int NT>
__device__ __forceinline__ void warp_gemm_at(float (&acc)[MT][NT][4], const float* a, int lda,
                                             const float* b, int ldb, int K) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    float av[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      av[mt][0] = a[k * lda + mt * 16 + g];
      av[mt][1] = a[k * lda + mt * 16 + g + 8];
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = nt * 8 + 2 * c;
      const float b0 = b[k * ldb + n];
      const float b1 = b[k * ldb + n + 1];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        acc[mt][nt][0] = fmaf(av[mt][0], b0, acc[mt][nt][0]);
        acc[mt][nt][1] = fmaf(av[mt][0], b1, acc[mt][nt][1]);
        acc[mt][nt][2] = fmaf(av[mt][1], b0, acc[mt][nt][2]);
        acc[mt][nt][3] = fmaf(av[mt][1], b1, acc[mt][nt][3]);
      }
    }
  }
}

// Store a warp's [16 MT, 8 NT] accumulator at (row0, col0) of a row-major [rows, cols]
// output with row stride `ld`, masking rows >= rows and cols >= cols.
template <typename T, int MT, int NT>
__device__ __forceinline__ void store_acc(T* out, int64_t ld, const float (&acc)[MT][NT][4],
                                          int row0, int col0, int rows, int cols) {
  const int lane = threadIdx.x & 31;
  const bool pairs = (ld % 2) == 0;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + mt * 16 + (lane >> 2) + half * 8;
      if (row >= rows) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = col0 + nt * 8 + 2 * (lane & 3);
        const float x = acc[mt][nt][2 * half];
        const float y = acc[mt][nt][2 * half + 1];
        T* p = out + row * ld + col;
        if (pairs && col + 1 < cols) {
          store_pair(p, x, y);
        } else {
          if (col < cols) p[0] = from_float<T>(x);
          if (col + 1 < cols) p[1] = from_float<T>(y);
        }
      }
    }
}

template <typename T, int BM, bool kTransB>
struct GmmShape {
  static constexpr int kWarpsM = BM >= 32 ? 2 : 1;
  static constexpr int kWarpsN = 4 / kWarpsM;
  static constexpr int kMT = BM / kWarpsM / 16;
  static constexpr int kNT = kTileN / kWarpsN / 8;
  static constexpr int kLdA = kTileK + pad<T>();
  // B(k, n) tile: [kTileK][kTileN] rows k (w[e] read as [K, N]) or [kTileN][kTileK] rows
  // n (w[e]^T read in place from [N, K])
  static constexpr int kLdB = kTransB ? kTileK + pad<T>() : kTileN + pad<T>();
  static constexpr int kElemsA = BM * kLdA;
  static constexpr int kElemsB = kTransB ? kTileN * kLdB : kTileK * kLdB;
  static constexpr int kStageElems = kElemsA + kElemsB;
  static constexpr size_t kSmemBytes = 2 * kStageElems * sizeof(T);
};

template <typename T, int BM, bool kTransB>
__global__ void __launch_bounds__(kThreads)
    gmm_kernel(const T* __restrict__ xp, const T* __restrict__ w, const int* __restrict__ block_expert,
               const int* __restrict__ block_valid, T* __restrict__ out, int bm, int K, int N) {
  using S = GmmShape<T, BM, kTransB>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int b = blockIdx.y;
  const int n0 = blockIdx.x * kTileN;
  const int valid = min(block_valid[b], bm);
  T* out_block = out + static_cast<int64_t>(b) * bm * N;
  if (valid <= 0) {  // all padding: zeros, and the bank is not read
    for (int i = threadIdx.x; i < bm * kTileN; i += blockDim.x) {
      const int col = n0 + i % kTileN;
      if (col < N) out_block[static_cast<int64_t>(i / kTileN) * N + col] = from_float<T>(0.f);
    }
    return;
  }
  const int e = block_expert[b];
  const T* a_src = xp + static_cast<int64_t>(b) * bm * K;
  const T* w_e = w + static_cast<int64_t>(e) * K * N;
  constexpr int kVec = 16 / sizeof(T);
  const bool a_vec = K % kVec == 0;
  const bool b_vec = (kTransB ? K : N) % kVec == 0;

  auto load_stage = [&](int stage, int k0) {
    T* sa = smem + stage * S::kStageElems;
    T* sb = sa + S::kElemsA;
    load_tile_masked(sa, S::kLdA, a_src + k0, K, BM, kTileK, valid, K - k0, a_vec);
    if constexpr (kTransB)
      load_tile_masked(sb, S::kLdB, w_e + static_cast<int64_t>(n0) * K + k0, K, kTileN, kTileK, N - n0,
                K - k0, b_vec);
    else
      load_tile_masked(sb, S::kLdB, w_e + static_cast<int64_t>(k0) * N + n0, N, kTileK, kTileN, K - k0,
                N - n0, b_vec);
  };

  const int warp = threadIdx.x >> 5;
  const int wm = warp / S::kWarpsN;
  const int wn = warp % S::kWarpsN;
  float acc[S::kMT][S::kNT][4];
  zero_acc(acc);

  const int num_k = (K + kTileK - 1) / kTileK;
  load_stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < num_k; ++kt) {
    if (kt + 1 < num_k) {
      load_stage((kt + 1) & 1, (kt + 1) * kTileK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* sa = smem + (kt & 1) * S::kStageElems;
    const T* sb = sa + S::kElemsA;
    const T* a = sa + wm * (BM / S::kWarpsM) * S::kLdA;
    const int n_off = wn * (kTileN / S::kWarpsN);
    const T* bw = kTransB ? sb + n_off * S::kLdB : sb + n_off;
    warp_gemm<S::kMT, S::kNT, kTransB>(acc, a, S::kLdA, bw, S::kLdB, kTileK);
    __syncthreads();
  }
  store_acc<T>(out_block, N, acc, wm * (BM / S::kWarpsM), n0 + wn * (kTileN / S::kWarpsN), bm, N);
}

template <typename T>
struct TgmmShape {
  static constexpr int kMT = kTileM / 2 / 16;  // 2 x 2 warps of 64 x 64
  static constexpr int kNT = kTileN / 2 / 8;
  static constexpr int kLd = kTileN + pad<T>();  // kTileM == kTileN
  static constexpr int kElems = kTileK * kLd;
  static constexpr int kStageElems = 2 * kElems;
  static constexpr size_t kSmemBytes = 2 * kStageElems * sizeof(T);
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    tgmm_kernel(const T* __restrict__ xp, const T* __restrict__ dy, const int* __restrict__ row_start,
                const int* __restrict__ group_rows, float* __restrict__ out, int K, int N) {
  using S = TgmmShape<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int e = blockIdx.z;
  const int m0 = blockIdx.y * kTileM;
  const int n0 = blockIdx.x * kTileN;
  const int rows = group_rows[e];
  const T* x_src = xp + static_cast<int64_t>(row_start[e]) * K + m0;
  const T* dy_src = dy + static_cast<int64_t>(row_start[e]) * N + n0;
  constexpr int kVec = 16 / sizeof(T);
  const bool x_vec = K % kVec == 0;
  const bool dy_vec = N % kVec == 0;

  auto load_stage = [&](int stage, int r0) {
    T* sx = smem + stage * S::kStageElems;
    T* sd = sx + S::kElems;
    load_tile_masked(sx, S::kLd, x_src + static_cast<int64_t>(r0) * K, K, kTileK, kTileM, rows - r0, K - m0, x_vec);
    load_tile_masked(sd, S::kLd, dy_src + static_cast<int64_t>(r0) * N, N, kTileK, kTileN, rows - r0, N - n0, dy_vec);
  };

  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 1;
  const int wn = warp & 1;
  float acc[S::kMT][S::kNT][4];
  zero_acc(acc);

  const int num_r = (rows + kTileK - 1) / kTileK;
  if (num_r > 0) {
    load_stage(0, 0);
    cp_async_commit();
  }
  for (int rt = 0; rt < num_r; ++rt) {
    if (rt + 1 < num_r) {
      load_stage((rt + 1) & 1, (rt + 1) * kTileK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* sx = smem + (rt & 1) * S::kStageElems;
    const T* sd = sx + S::kElems;
    warp_gemm_at<S::kMT, S::kNT>(acc, sx + wm * (kTileM / 2), S::kLd, sd + wn * (kTileN / 2), S::kLd, kTileK);
    __syncthreads();
  }
  float* out_e = out + static_cast<int64_t>(e) * K * N + static_cast<int64_t>(m0) * N;
  store_acc<float>(out_e, N, acc, wm * (kTileM / 2), n0 + wn * (kTileN / 2), K - m0, N);
}

template <typename T, int BM, bool kTransB>
cudaError_t launch_gmm(const void* xp, const void* w, const int* block_expert, const int* block_valid,
                       void* out, int num_blocks, int bm, int K, int N, cudaStream_t stream) {
  using S = GmmShape<T, BM, kTransB>;
  auto kernel = gmm_kernel<T, BM, kTransB>;
  cudaError_t err = allow_shared_memory(kernel, S::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kTileN - 1) / kTileN, num_blocks);
  kernel<<<grid, kThreads, S::kSmemBytes, stream>>>(
      static_cast<const T*>(xp), static_cast<const T*>(w), block_expert, block_valid,
      static_cast<T*>(out), bm, K, N);
  return cudaGetLastError();
}

template <typename T, bool kTransB>
cudaError_t dispatch_gmm(const void* xp, const void* w, const int* block_expert, const int* block_valid,
                         void* out, int num_blocks, int bm, int K, int N, cudaStream_t stream) {
  if (bm <= 16) return launch_gmm<T, 16, kTransB>(xp, w, block_expert, block_valid, out, num_blocks, bm, K, N, stream);
  if (bm <= 32) return launch_gmm<T, 32, kTransB>(xp, w, block_expert, block_valid, out, num_blocks, bm, K, N, stream);
  if (bm <= 64) return launch_gmm<T, 64, kTransB>(xp, w, block_expert, block_valid, out, num_blocks, bm, K, N, stream);
  return launch_gmm<T, 128, kTransB>(xp, w, block_expert, block_valid, out, num_blocks, bm, K, N, stream);
}

template <typename T>
cudaError_t launch_tgmm(const void* xp, const void* dy, const int* row_start, const int* group_rows,
                        float* out, int num_experts, int K, int N, cudaStream_t stream) {
  using S = TgmmShape<T>;
  auto kernel = tgmm_kernel<T>;
  cudaError_t err = allow_shared_memory(kernel, S::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kTileN - 1) / kTileN, (K + kTileM - 1) / kTileM, num_experts);
  kernel<<<grid, kThreads, S::kSmemBytes, stream>>>(
      static_cast<const T*>(xp), static_cast<const T*>(dy), row_start, group_rows, out, K, N);
  return cudaGetLastError();
}

}  // namespace
}  // namespace dolo

// out [num_blocks * bm, N] = per block xp_b [bm, K] @ w[block_expert[b]]: w is [E, K, N],
// or [E, N, K] read transposed when transpose_w. Returns the launch's cudaError_t.
extern "C" int dolo_gmm(const void* xp, const void* w, const int* block_expert, const int* block_valid,
                        void* out, int num_blocks, int bm, int K, int N, int transpose_w, int dtype,
                        cudaStream_t stream) {
  using namespace dolo;
  if (bm < 1 || bm > 128 || num_blocks > 65535) return cudaErrorInvalidValue;
  if (dtype == kBFloat16)
    return transpose_w ? dispatch_gmm<__nv_bfloat16, true>(xp, w, block_expert, block_valid, out, num_blocks, bm, K, N, stream)
                       : dispatch_gmm<__nv_bfloat16, false>(xp, w, block_expert, block_valid, out, num_blocks, bm, K, N, stream);
  if (dtype == kFloat32)
    return transpose_w ? dispatch_gmm<float, true>(xp, w, block_expert, block_valid, out, num_blocks, bm, K, N, stream)
                       : dispatch_gmm<float, false>(xp, w, block_expert, block_valid, out, num_blocks, bm, K, N, stream);
  return cudaErrorInvalidValue;
}

// out [E, K, N] fp32 = per expert e, xp[rows]^T @ dy[rows] over its real rows
// [row_start[e], row_start[e] + group_rows[e]). Returns the launch's cudaError_t.
extern "C" int dolo_tgmm(const void* xp, const void* dy, const int* row_start, const int* group_rows,
                         float* out, int num_experts, int K, int N, int dtype, cudaStream_t stream) {
  using namespace dolo;
  if (num_experts > 65535 || (K + kTileM - 1) / kTileM > 65535) return cudaErrorInvalidValue;
  if (dtype == kBFloat16)
    return launch_tgmm<__nv_bfloat16>(xp, dy, row_start, group_rows, out, num_experts, K, N, stream);
  if (dtype == kFloat32) return launch_tgmm<float>(xp, dy, row_start, group_rows, out, num_experts, K, N, stream);
  return cudaErrorInvalidValue;
}
