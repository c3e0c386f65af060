// Grouped GEMMs of the MoE expert MLPs over the expert-sorted, block-padded layout.
//
// Replace the TPU kernels `_gmm_call` and `_tgmm_call` (dolomite_engine_tpu/ops/pallas/
// moe.py:78 and :100). The rows of every expert are padded to whole blocks of `bm` rows
// (bm in {8, 16, 32, 64, 128}, or the row count below 8), every expert owns at least one
// block, and `block_expert[b]` names block b's expert bank.
//
// - `gmm`: out[b*bm : (b+1)*bm] = xp[b*bm : (b+1)*bm] @ B_e with B_e = w[e] ([E, K, N])
//   or, for dX in the backward, B_e = w[e]^T read in place from w ([E, N, K]): no
//   transposed copy of the banks. One CTA per (row block, column tile) reads its block's
//   expert from device memory (the counterpart of the scalar prefetch). Rows at or past
//   `block_valid[b]` are padding: whatever they hold, they are written as zero, and a
//   block with no real row writes its zeros without reading its bank, so a decode step
//   reads only the banks that tokens were routed to.
// - `tgmm`: dW[e] = sum over expert e's real rows of xp_r^T dy_r, summed in fp32 and
//   written in fp32 or, for the backward, rounded once to the bank's dtype (the JAX
//   VJP's `.astype(w.dtype)` fused: the same sum, the same rounding). The Pallas kernel
//   carries the sum across its sequential grid; Hopper blocks run in no order, so one CTA
//   per (expert, output tile) walks the expert's rows itself (start = the padded-layout
//   offset, count = the group size) and writes its tile once: no atomics, a fixed sum
//   order. An expert with no rows writes zeros, as the Pallas kernel's zero-row block does.
//
// Bound on an H100: decode (32 rows) reads whole expert banks for a few rows each, so it
// is bound by the banks' bytes; prefill and training (2048-16384 rows over 32 experts)
// are bound by the tensor cores, and tgmm's fp32 output ([E, K, N], 1 GB at c_fc) weighs
// on its bytes.
//
// Two paths, by a fixed shape rule (`route`, also exported to the wrapper):
// - wgmma (bf16 inputs whose rows are 16-byte multiples, 16-byte aligned bases: every
//   shape of the slice). Warp-specialised: one producer thread keeps TMA loads of
//   64-deep stages (128 bytes of bf16, 128-byte swizzle) in flight through a ring of 3-6
//   stages with full / empty mbarriers; two consumer warpgroups issue `wgmma.mma_async`
//   m64nNk16 with fp32 accumulators in registers and keep one stage's products in flight
//   while the next stage's are issued; at one CTA an SM, setmaxnreg moves registers from
//   the producer warpgroup to them. The epilogue stages each warpgroup's accumulator
//   through shared memory and stores 16-byte vectors along the rows.
//   gmm tiles (one CTA per tile): 128 x 256 for bm-128 blocks (one CTA an SM), 64 x 128
//   for blocks of 64 rows or fewer, two CTAs an SM (decode: bound by the banks' bytes,
//   so a second CTA's loads cover the first one's start and epilogue); a 64-row TMA box at a smaller block also reads the next block's
//   rows, which are not stored. xp is a 2-D map, the banks a 3-D one, so the copy engine
//   zero-fills a K or N edge per expert and never reads the next expert's bank; dX reads
//   w[e]^T as a K-major operand, the forward w[e] as an MN-major one.
//   tgmm is persistent (one CTA an SM walking 128 x kTgmmTileN tiles of the bank's [K, N]):
//   an expert has only ~8 stages of rows a tile at the slice's training shape, so the
//   producer runs on into the next tile's stages while the consumers store this one. A =
//   xp^T and B = dy are both MN-major; in the last stage the rows past the expert's count
//   (padding, or the next expert's rows) are zeroed in shared memory before the product.
// - the old tiles (fp32 inputs, the tolerance cases, through scalar FMA, never TF32; bf16
//   widths TMA cannot address through mma.sync m16n8k16): 128 columns by 32 deep,
//   double-buffered through cp.async, K and N edges zero-filled on load and masked on
//   store.
#include "common.cuh"
#include "mma.cuh"
#include "sm90.cuh"

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

template <typename T, typename TOut>
__global__ void __launch_bounds__(kThreads)
    tgmm_kernel(const T* __restrict__ xp, const T* __restrict__ dy, const int* __restrict__ row_start,
                const int* __restrict__ group_rows, TOut* __restrict__ out, int K, int N) {
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
  TOut* out_e = out + static_cast<int64_t>(e) * K * N + static_cast<int64_t>(m0) * N;
  store_acc<TOut>(out_e, N, acc, wm * (kTileM / 2), n0 + wn * (kTileN / 2), K - m0, N);
}

// ------------------------------------------------------------------ the wgmma path (bf16)

constexpr int kDepth = 64;                   // reduction depth of a stage: 64 bf16 = one 128-byte row
constexpr int kRowBytes = kDepth * 2;        // bytes of one staged row
constexpr int kPanelBytes = 64 * kRowBytes;  // a 64 x 64 bf16 box (8 KB)
constexpr int kConsumerThreads = 256;        // two consumer warpgroups (and a producer, below)
constexpr int kMaxStages = 6;
// tile choices (the A/B script's --constant sweeps them)
constexpr int kGmmSmallCtas = 2;        // CTAs an SM holds of the 64 x 128 gmm tiles (bm <= 64)
constexpr int kTgmmTileN = 256;         // tgmm output tile: 128 x kTgmmTileN of the bank's [K, N]
constexpr int kTgmmSmemBudget = 220 * 1024;  // tgmm's ring and staging (one persistent CTA an SM)

// What `kCtas` CTAs per SM leave each: the ring's shared memory, the threads and their
// registers. One CTA: a producer warpgroup, launched at 168 registers a thread, and
// setmaxnreg moves them to the consumers (2 x 128 x 232 + 128 x 40 <= 65536). Two CTAs: a
// producer warp, 288 threads at 112 registers each, no setmaxnreg (ptxas budgets a wgmma
// by the launch bound, whatever setmaxnreg grants: 2 x 384 threads would leave it 80).
template <int kCtas>
struct Occupancy {
  static_assert(kCtas == 1 || kCtas == 2, "one or two CTAs per SM");
  static constexpr int kStageBudget = kCtas == 1 ? 200 * 1024 : 100 * 1024;
  static constexpr int kThreads = kConsumerThreads + (kCtas == 1 ? 128 : 32);
  static constexpr int kConsumerRegs = 232;
  static constexpr int kProducerRegs = 40;
};

enum Route : int { kRouteFma = 0, kRouteMmaSync = 1, kRouteWgmma = 2 };

// The fixed shape rule: bf16 whose row strides (K, N elements) and bases TMA can address.
int route(int dtype, int K, int N, const void* a, const void* b, const void* out) {
  if (dtype != kBFloat16) return kRouteFma;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
                          reinterpret_cast<uintptr_t>(out);
  return (K % 8 == 0 && N % 8 == 0 && bases % 16 == 0) ? kRouteWgmma : kRouteMmaSync;
}

// The ring of a CTA: stages of `kStageBytes` (A then B), 1024-byte aligned for the swizzle
// atom, then the full / empty barriers. After the main loop the consumers stage their
// accumulators through it (`kStagingBytes`).
template <int kStageBytes, int kCtas, int kStagingBytes>
struct Ring {
  static constexpr int kStages =
      Occupancy<kCtas>::kStageBudget / kStageBytes < kMaxStages ? Occupancy<kCtas>::kStageBudget / kStageBytes
                                                                 : kMaxStages;
  static_assert(kStages >= 2, "a ring of one stage cannot overlap loads and products");
  static_assert(kStagingBytes <= kStages * kStageBytes, "the epilogue stages through the ring");
  static constexpr size_t kSmemBytes = 1024 + static_cast<size_t>(kStages) * kStageBytes + 2 * kStages * 8;
};

__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

template <int kStages>
__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kConsumerThreads);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();
}

// acc += A B over one 64-deep stage: four m64 x kN x 16 products
template <int kN, int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_stage(float (&acc)[kN / 2], const unsigned char* a, uint32_t a_step,
                                            uint32_t a_lbo, const unsigned char* b, uint32_t b_step, uint32_t b_lbo) {
  static_assert(kN == 64 || kN == 256, "the tiles use m64n64 and m64n256 products");
#pragma unroll
  for (int kk = 0; kk < kDepth / 16; ++kk) {
    const uint64_t da = sm90::smem_desc(a + kk * a_step, a_lbo, 1024);
    const uint64_t db = sm90::smem_desc(b + kk * b_step, b_lbo, 1024);
    if constexpr (kN == 256) sm90::wgmma_m64n256k16<kTransA, kTransB>(acc, da, db);
    else sm90::wgmma_m64n64k16<kTransA, kTransB>(acc, da, db);
  }
}

// Shared-memory bytes one warpgroup stages its 64 x kN accumulator through: rows padded by
// 8 elements, so a warp's fragment writes (bf16 pairs, or fp32 pairs by half-warp) hit
// distinct banks.
template <int kN, typename TOut>
__host__ __device__ constexpr int staging_bytes() {
  return 64 * (kN + 8) * static_cast<int>(sizeof(TOut));
}

// Store a warpgroup's 64 x kN accumulator at (row0, col0) of a row-major output with row
// stride `ld` (a multiple of 16 bytes): rows at or past `rows_stored` are skipped, rows at
// or past `rows_real` are written as zeros, columns at or past `cols` (a multiple of 8) are
// skipped. The accumulator goes through `staging` (staging_bytes<kN / kPasses>) in
// kPasses column slices and leaves in 16-byte vectors along the rows.
template <int kN, int kPasses, typename TOut>
__device__ __forceinline__ void store_wg_acc(TOut* out, int64_t ld, const float (&acc)[kN / 2],
                                             unsigned char* staging, int row0, int col0, int rows_stored,
                                             int rows_real, int cols) {
  constexpr int kW = kN / kPasses;  // columns staged in one pass
  constexpr int kVecElems = 16 / sizeof(TOut);
  constexpr int kLd = kW + 8;  // padded row pitch, in elements
  constexpr int kVecs = kW / kVecElems;
  TOut* st = reinterpret_cast<TOut*>(staging);
  const int t = threadIdx.x % 128;
  const int r = (t / 32) * 16 + (t % 32) / 4;
  const int c = 2 * (t % 4);
#pragma unroll
  for (int pass = 0; pass < kPasses; ++pass) {
    sm90::named_barrier_sync(2 + threadIdx.x / 128, 128);  // the warpgroup's last reads of `staging` are done
#pragma unroll
    for (int j = 0; j < kW / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 4 * (pass * kW / 8 + j) + 2 * h;
        store_pair(st + (r + 8 * h) * kLd + c + 8 * j, acc[i], acc[i + 1]);
      }
    sm90::named_barrier_sync(2 + threadIdx.x / 128, 128);
#pragma unroll 4
    for (int i = t; i < 64 * kVecs; i += 128) {
      const int rr = i / kVecs;
      const int v = i % kVecs;
      const int row = row0 + rr;
      const int col = col0 + pass * kW + v * kVecElems;
      if (row >= rows_stored || col >= cols) continue;
      const uint4 value = row < rows_real ? *reinterpret_cast<const uint4*>(st + rr * kLd + v * kVecElems)
                                          : make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(out + row * ld + col) = value;
    }
  }
}

// Zeros over a [rows, tile_cols] tile at column col0 of a row-major output (16-byte
// vectors; ld, col0 and cols multiples of 8 elements of T), by threads tid of nthreads.
template <typename T>
__device__ __forceinline__ void store_zero_tile(T* out, int64_t ld, int rows, int col0, int tile_cols, int cols,
                                                int tid, int nthreads) {
  constexpr int kVec = 16 / sizeof(T);
  const int vecs = tile_cols / kVec;
  for (int i = tid; i < rows * vecs; i += nthreads) {
    const int c = col0 + (i % vecs) * kVec;
    if (c < cols) *reinterpret_cast<uint4*>(out + (i / vecs) * ld + c) = make_uint4(0u, 0u, 0u, 0u);
  }
}

template <int BM, int BN, int kCtas>
struct GmmWgTile {
  static constexpr int kWgM = BM / 64;   // warpgroups along the rows: 1 or 2
  static constexpr int kWgN = 2 / kWgM;  // and along the columns
  static constexpr int kWN = BN / kWgN;  // columns of one warpgroup's product
  static constexpr int kABytes = BM * kRowBytes;
  using R = Ring<kABytes + BN * kRowBytes, kCtas, 2 * staging_bytes<kWN, __nv_bfloat16>()>;
};

// x_map: xp [rows, K], box {64, BM}. w_map: w [E, K, N] with box {64 (N), 64 (K), 1}, or
// for kTransB w [E, N, K] with box {64 (K), BN (N), 1}.
template <int BM, int BN, bool kTransB, int kCtas>
__global__ void __launch_bounds__(Occupancy<kCtas>::kThreads, kCtas)
    gmm_kernel_wgmma(const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap w_map,
                     const int* __restrict__ block_expert, const int* __restrict__ block_valid,
                     __nv_bfloat16* __restrict__ out, int bm, int K, int N) {
  using S = GmmWgTile<BM, BN, kCtas>;
  using R = typename S::R;
  using O = Occupancy<kCtas>;
  constexpr int kStageBytes = S::kABytes + BN * kRowBytes;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + R::kStages * kStageBytes);
  uint64_t* empty = full + R::kStages;

  const int b = blockIdx.y;
  const int n0 = blockIdx.x * BN;
  const int valid = min(block_valid[b], bm);
  __nv_bfloat16* out_block = out + static_cast<int64_t>(b) * bm * N;
  if (valid <= 0) {  // all padding: zeros, and the bank is not read
    store_zero_tile(out_block, N, bm, n0, BN, N, threadIdx.x, blockDim.x);
    return;
  }
  const int num_k = (K + kDepth - 1) / kDepth;
  init_ring<R::kStages>(full, empty);

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // producer
    if constexpr (kCtas == 1) sm90::warpgroup_reg_dealloc<O::kProducerRegs>();
    if (threadIdx.x == kConsumerThreads) {
      sm90::prefetch_tensor_map(&x_map);
      sm90::prefetch_tensor_map(&w_map);
      const int e = block_expert[b];
      const int row0 = b * bm;
      for (int kt = 0; kt < num_k; ++kt) {
        const int s = kt % R::kStages;
        if (kt >= R::kStages) sm90::mbar_wait(&empty[s], (kt / R::kStages - 1) & 1);
        unsigned char* sa = ring + s * kStageBytes;
        unsigned char* sb = sa + S::kABytes;
        sm90::mbar_arrive_expect_tx(&full[s], kStageBytes);
        sm90::tma_load_2d(sa, &x_map, &full[s], kt * kDepth, row0);
        if constexpr (kTransB) {
          sm90::tma_load_3d(sb, &w_map, &full[s], kt * kDepth, n0, e);
        } else {
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            sm90::tma_load_3d(sb + j * kPanelBytes, &w_map, &full[s], n0 + 64 * j, kt * kDepth, e);
        }
      }
    }
  } else {  // consumers
    if constexpr (kCtas == 1) sm90::warpgroup_reg_alloc<O::kConsumerRegs>();
    const int wm = S::kWgM == 2 ? wg : 0;
    const int wn = S::kWgM == 2 ? 0 : wg;
    float acc[S::kWN / 2];
#pragma unroll
    for (int i = 0; i < S::kWN / 2; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < num_k; ++kt) {
      const int s = kt % R::kStages;
      sm90::mbar_wait(&full[s], (kt / R::kStages) & 1);
      const unsigned char* sa = ring + s * kStageBytes + wm * 64 * kRowBytes;
      const unsigned char* sb = ring + s * kStageBytes + S::kABytes;
      sm90::fence_operands(acc);
      sm90::wgmma_fence();
      if constexpr (kTransB)  // B = w[e]^T, [n rows][64 k]: K-major like A
        wgmma_stage<S::kWN, 0, 0>(acc, sa, 32, 16, sb + wn * S::kWN * kRowBytes, 32, 16);
      else  // B = w[e], 64-column panels of [64 k][64 n]: MN-major
        wgmma_stage<S::kWN, 0, 1>(acc, sa, 32, 16, sb + (wn * S::kWN / 64) * kPanelBytes, 16 * kRowBytes,
                                  kPanelBytes);
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();  // the previous stage's products are done: release it
      sm90::fence_operands(acc);
      if (kt > 0) sm90::mbar_arrive(&empty[(kt - 1) % R::kStages]);
    }
    sm90::wgmma_wait<0>();
    sm90::fence_operands(acc);
    sm90::named_barrier_sync(1, kConsumerThreads);  // both warpgroups are done with the ring
    store_wg_acc<S::kWN, 1>(out_block, N, acc, ring + wg * staging_bytes<S::kWN, __nv_bfloat16>(), wm * 64,
                         n0 + wn * S::kWN, bm, valid, N);
  }
}

template <int BN, typename TOut>
struct TgmmWgTile {
  static constexpr int kABytes = 2 * kPanelBytes;  // xp rows: two 64-wide panels of the bank's K
  static constexpr int kStageBytes = kABytes + (BN / 64) * kPanelBytes;
  // the output leaves through a staging buffer per warpgroup (the ring is already filling
  // with the next tile's stages), fp32 in two column slices
  static constexpr int kPasses = sizeof(TOut) == 4 ? 2 : 1;
  static constexpr int kStagingBytes = 2 * staging_bytes<BN / kPasses, TOut>();
  static constexpr int kStages = (kTgmmSmemBudget - kStagingBytes) / kStageBytes < kMaxStages
                                     ? (kTgmmSmemBudget - kStagingBytes) / kStageBytes
                                     : kMaxStages;
  static_assert(kStages >= 2, "a ring of one stage cannot overlap loads and products");
  static constexpr size_t kSmemBytes =
      1024 + static_cast<size_t>(kStages) * kStageBytes + kStagingBytes + 2 * kStages * 8;
};

// Persistent: each CTA (one per SM) walks output tiles t = blockIdx.x, + gridDim.x, ...
// (the bank's row tiles fastest, so the CTAs running together share each dy tile through
// L2; then column tiles, then experts). The producer runs on into the next tile's stages
// while the consumers store this one. x_map: xp [rows, K],
// dy_map: dy [rows, N], both with box {64, 64}. Warpgroup w computes rows
// [m0 + 64 w, + 64) of the expert's [K, N] tile at (m0, n0).
template <int BN, typename TOut>
__global__ void __launch_bounds__(Occupancy<1>::kThreads, 1)
    tgmm_kernel_wgmma(const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap dy_map,
                      const int* __restrict__ row_start, const int* __restrict__ group_rows,
                      TOut* __restrict__ out, int num_experts, int K, int N) {
  using S = TgmmWgTile<BN, TOut>;
  using O = Occupancy<1>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = align_1024(smem_raw);
  unsigned char* staging = ring + S::kStages * S::kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + S::kStagingBytes);
  uint64_t* empty = full + S::kStages;

  const int n_tiles = (N + BN - 1) / BN;
  const int m_tiles = (K + 127) / 128;
  const int tiles = n_tiles * m_tiles * num_experts;
  init_ring<S::kStages>(full, empty);

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // producer
    sm90::warpgroup_reg_dealloc<O::kProducerRegs>();
    if (threadIdx.x == kConsumerThreads) {
      sm90::prefetch_tensor_map(&x_map);
      sm90::prefetch_tensor_map(&dy_map);
      int g = 0;  // stages issued so far, over all this CTA's tiles
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = t % m_tiles * 128;
        const int n0 = t / m_tiles % n_tiles * BN;
        const int e = t / n_tiles / m_tiles;
        const int rows = group_rows[e];
        const int start = row_start[e];
        for (int r0 = start; r0 < start + rows; r0 += kDepth, ++g) {
          const int s = g % S::kStages;
          if (g >= S::kStages) sm90::mbar_wait(&empty[s], (g / S::kStages - 1) & 1);
          unsigned char* sa = ring + s * S::kStageBytes;
          unsigned char* sb = sa + S::kABytes;
          sm90::mbar_arrive_expect_tx(&full[s], S::kStageBytes);
          sm90::tma_load_2d(sa, &x_map, &full[s], m0, r0);
          sm90::tma_load_2d(sa + kPanelBytes, &x_map, &full[s], m0 + 64, r0);
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            sm90::tma_load_2d(sb + j * kPanelBytes, &dy_map, &full[s], n0 + 64 * j, r0);
        }
      }
    }
  } else {  // consumers
    sm90::warpgroup_reg_alloc<O::kConsumerRegs>();
    int g = 0;  // stages consumed so far
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = t % m_tiles * 128;
      const int n0 = t / m_tiles % n_tiles * BN;
      const int e = t / n_tiles / m_tiles;
      const int rows = group_rows[e];
      const int m_rows = min(128, K - m0);
      TOut* out_e = out + static_cast<int64_t>(e) * K * N + static_cast<int64_t>(m0) * N;
      if (rows <= 0) {  // an expert with no rows: exact zeros
        store_zero_tile(out_e, N, m_rows, n0, BN, N, threadIdx.x, kConsumerThreads);
        continue;
      }
      float acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      const int num_s = (rows + kDepth - 1) / kDepth;
      const int tail = rows - (num_s - 1) * kDepth;  // real rows of the last stage, 1..64
      for (int st = 0; st < num_s; ++st, ++g) {
        const int s = g % S::kStages;
        sm90::mbar_wait(&full[s], (g / S::kStages) & 1);
        unsigned char* stage = ring + s * S::kStageBytes;
        if (st == num_s - 1 && tail < kDepth) {
          // rows past the expert's count are padding or the next expert's rows: zero them
          // in every panel (a row keeps its 128 bytes under the swizzle), then hand the
          // writes to the async proxy before either warpgroup's wgmma reads them
          constexpr int kPanels = S::kStageBytes / kPanelBytes;
          const int chunks = (kDepth - tail) * (kRowBytes / 16);
          for (int i = threadIdx.x; i < kPanels * chunks; i += kConsumerThreads) {
            const int panel = i / chunks;
            const int c = i % chunks;
            *reinterpret_cast<uint4*>(stage + panel * kPanelBytes + tail * kRowBytes + c * 16) =
                make_uint4(0u, 0u, 0u, 0u);
          }
          sm90::fence_proxy_async();
          sm90::named_barrier_sync(1, kConsumerThreads);
        }
        sm90::fence_operands(acc);
        sm90::wgmma_fence();
        // A = xp^T: this warpgroup's 64-wide panel of [64 rows][64 m], MN-major; B = dy,
        // BN / 64 panels of [64 rows][64 n], MN-major; a 16-row step is 2048 bytes
        wgmma_stage<BN, 1, 1>(acc, stage + wg * kPanelBytes, 16 * kRowBytes, kPanelBytes, stage + S::kABytes,
                              16 * kRowBytes, kPanelBytes);
        sm90::wgmma_commit();
        sm90::wgmma_wait<1>();
        sm90::fence_operands(acc);
        if (st > 0) sm90::mbar_arrive(&empty[(g - 1) % S::kStages]);
      }
      sm90::wgmma_wait<0>();
      sm90::fence_operands(acc);
      sm90::mbar_arrive(&empty[(g - 1) % S::kStages]);
      store_wg_acc<BN, S::kPasses>(out_e, N, acc, staging + wg * staging_bytes<BN / S::kPasses, TOut>(), wg * 64,
                                   n0, m_rows, m_rows, N);
    }
  }
}

// ----------------------------------------------------------------------------- launchers

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

template <int BM, int BN, bool kTransB, int kCtas>
cudaError_t launch_gmm_wgmma(const void* xp, const void* w, const int* block_expert, const int* block_valid,
                             void* out, int num_blocks, int bm, int K, int N, int num_experts,
                             cudaStream_t stream) {
  using R = typename GmmWgTile<BM, BN, kCtas>::R;
  CUtensorMap x_map, w_map;
  const uint64_t x_dims[2] = {static_cast<uint64_t>(K), static_cast<uint64_t>(num_blocks) * bm};
  const uint64_t x_strides[1] = {static_cast<uint64_t>(K) * 2};
  const uint32_t x_box[2] = {kDepth, BM};
  cudaError_t err = sm90::bf16_tensor_map(&x_map, xp, 2, x_dims, x_strides, x_box);
  if (err != cudaSuccess) return err;
  const uint64_t inner = kTransB ? K : N, outer = kTransB ? N : K;
  const uint64_t w_dims[3] = {inner, outer, static_cast<uint64_t>(num_experts)};
  const uint64_t w_strides[2] = {inner * 2, inner * outer * 2};
  const uint32_t w_box[3] = {64, kTransB ? static_cast<uint32_t>(BN) : 64u, 1};
  err = sm90::bf16_tensor_map(&w_map, w, 3, w_dims, w_strides, w_box);
  if (err != cudaSuccess) return err;
  auto kernel = gmm_kernel_wgmma<BM, BN, kTransB, kCtas>;
  err = allow_shared_memory(kernel, R::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BN - 1) / BN, num_blocks);
  kernel<<<grid, Occupancy<kCtas>::kThreads, R::kSmemBytes, stream>>>(x_map, w_map, block_expert, block_valid,
                                                      static_cast<__nv_bfloat16*>(out), bm, K, N);
  return cudaGetLastError();
}

// The gmm tile of a call: 64 x 128 for blocks of 64 rows or fewer, else 128 x 256.
template <bool kTransB>
cudaError_t dispatch_gmm_wgmma(const void* xp, const void* w, const int* block_expert, const int* block_valid,
                               void* out, int num_blocks, int bm, int K, int N, int num_experts,
                               cudaStream_t stream) {
  if (bm <= 64)
    return launch_gmm_wgmma<64, 128, kTransB, kGmmSmallCtas>(xp, w, block_expert, block_valid, out, num_blocks,
                                                              bm, K, N, num_experts, stream);
  return launch_gmm_wgmma<128, 256, kTransB, 1>(xp, w, block_expert, block_valid, out, num_blocks, bm, K, N,
                                                num_experts, stream);
}

template <typename T, typename TOut>
cudaError_t launch_tgmm(const void* xp, const void* dy, const int* row_start, const int* group_rows,
                        void* out, int num_experts, int K, int N, cudaStream_t stream) {
  using S = TgmmShape<T>;
  auto kernel = tgmm_kernel<T, TOut>;
  cudaError_t err = allow_shared_memory(kernel, S::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kTileN - 1) / kTileN, (K + kTileM - 1) / kTileM, num_experts);
  kernel<<<grid, kThreads, S::kSmemBytes, stream>>>(
      static_cast<const T*>(xp), static_cast<const T*>(dy), row_start, group_rows, static_cast<TOut*>(out), K, N);
  return cudaGetLastError();
}

template <typename TOut>
cudaError_t launch_tgmm_wgmma(const void* xp, const void* dy, const int* row_start, const int* group_rows,
                              void* out, int rows, int num_experts, int K, int N, cudaStream_t stream) {
  using S = TgmmWgTile<kTgmmTileN, TOut>;
  CUtensorMap x_map, dy_map;
  const uint32_t box[2] = {64, kDepth};
  const uint64_t x_dims[2] = {static_cast<uint64_t>(K), static_cast<uint64_t>(rows)};
  const uint64_t x_strides[1] = {static_cast<uint64_t>(K) * 2};
  cudaError_t err = sm90::bf16_tensor_map(&x_map, xp, 2, x_dims, x_strides, box);
  if (err != cudaSuccess) return err;
  const uint64_t dy_dims[2] = {static_cast<uint64_t>(N), static_cast<uint64_t>(rows)};
  const uint64_t dy_strides[1] = {static_cast<uint64_t>(N) * 2};
  err = sm90::bf16_tensor_map(&dy_map, dy, 2, dy_dims, dy_strides, box);
  if (err != cudaSuccess) return err;
  auto kernel = tgmm_kernel_wgmma<kTgmmTileN, TOut>;
  err = allow_shared_memory(kernel, S::kSmemBytes);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = sm90::sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int64_t tiles = static_cast<int64_t>((N + kTgmmTileN - 1) / kTgmmTileN) * ((K + 127) / 128) * num_experts;
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  kernel<<<grid, Occupancy<1>::kThreads, S::kSmemBytes, stream>>>(x_map, dy_map, row_start, group_rows,
                                                                  static_cast<TOut*>(out), num_experts, K, N);
  return cudaGetLastError();
}

}  // namespace
}  // namespace dolo

// The path a grouped GEMM of these inputs takes (0 scalar FMA, 1 mma.sync, 2 wgmma + TMA):
// `a` / `b` are xp and w (gmm) or xp and dy (tgmm), K / N the widths their rows hold.
extern "C" int dolo_grouped_gemm_route(int dtype, int K, int N, const void* a, const void* b, const void* out) {
  return dolo::route(dtype, K, N, a, b, out);
}

// out [num_blocks * bm, N] = per block xp_b [bm, K] @ w[block_expert[b]]: w is [E, K, N],
// or [E, N, K] read transposed when transpose_w. Returns the launch's cudaError_t.
extern "C" int dolo_gmm(const void* xp, const void* w, const int* block_expert, const int* block_valid,
                        void* out, int num_blocks, int bm, int K, int N, int num_experts, int transpose_w,
                        int dtype, cudaStream_t stream) {
  using namespace dolo;
  if (bm < 1 || bm > 128 || num_blocks > 65535 || num_experts < 1) return cudaErrorInvalidValue;
  switch (route(dtype, K, N, xp, w, out)) {
    case kRouteWgmma:
      return transpose_w ? dispatch_gmm_wgmma<true>(xp, w, block_expert, block_valid, out, num_blocks, bm, K, N, num_experts, stream)
                         : dispatch_gmm_wgmma<false>(xp, w, block_expert, block_valid, out, num_blocks, bm, K, N, num_experts, stream);
    case kRouteMmaSync:
      return transpose_w ? dispatch_gmm<__nv_bfloat16, true>(xp, w, block_expert, block_valid, out, num_blocks, bm, K, N, stream)
                         : dispatch_gmm<__nv_bfloat16, false>(xp, w, block_expert, block_valid, out, num_blocks, bm, K, N, stream);
    default:
      if (dtype != kFloat32) return cudaErrorInvalidValue;
      return transpose_w ? dispatch_gmm<float, true>(xp, w, block_expert, block_valid, out, num_blocks, bm, K, N, stream)
                         : dispatch_gmm<float, false>(xp, w, block_expert, block_valid, out, num_blocks, bm, K, N, stream);
  }
}

// out [E, K, N] = per expert e, xp[rows]^T @ dy[rows] over its real rows
// [row_start[e], row_start[e] + group_rows[e]) of the `rows` padded rows, summed in fp32
// and written as out_dtype (fp32, or bf16: one rounding of the same sum). Returns the
// launch's cudaError_t.
extern "C" int dolo_tgmm(const void* xp, const void* dy, const int* row_start, const int* group_rows, void* out,
                         int rows, int num_experts, int K, int N, int dtype, int out_dtype, cudaStream_t stream) {
  using namespace dolo;
  if (num_experts > 65535 || (K + kTileM - 1) / kTileM > 65535) return cudaErrorInvalidValue;
  if (out_dtype != kFloat32 && out_dtype != kBFloat16) return cudaErrorInvalidValue;
  const bool bf16_out = out_dtype == kBFloat16;
  switch (route(dtype, K, N, xp, dy, out)) {
    case kRouteWgmma:
      return bf16_out ? launch_tgmm_wgmma<__nv_bfloat16>(xp, dy, row_start, group_rows, out, rows, num_experts, K, N, stream)
                      : launch_tgmm_wgmma<float>(xp, dy, row_start, group_rows, out, rows, num_experts, K, N, stream);
    case kRouteMmaSync:
      return bf16_out ? launch_tgmm<__nv_bfloat16, __nv_bfloat16>(xp, dy, row_start, group_rows, out, num_experts, K, N, stream)
                      : launch_tgmm<__nv_bfloat16, float>(xp, dy, row_start, group_rows, out, num_experts, K, N, stream);
    default:
      if (dtype != kFloat32) return cudaErrorInvalidValue;
      return bf16_out ? launch_tgmm<float, __nv_bfloat16>(xp, dy, row_start, group_rows, out, num_experts, K, N, stream)
                      : launch_tgmm<float, float>(xp, dy, row_start, group_rows, out, num_experts, K, N, stream);
  }
}
