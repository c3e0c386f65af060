// Warp-level tile products and tile loads shared by the tensor-core kernels (sm_90a).
//
// `warp_gemm` accumulates one warp's [16*MT x 8*NT] fp32 tile of A * B from shared
// memory, in the register layout of the m16n8k16 `mma.sync` accumulator: lane l holds
// rows (l / 4) and (l / 4 + 8) of each 16-row tile, columns 2 * (l % 4) and
// 2 * (l % 4) + 1 of each 8-column tile, as acc[mt][nt][0..3] =
// (row, col), (row, col + 1), (row + 8, col), (row + 8, col + 1).
//
// - bf16 operands: `ldmatrix` + `mma.sync.m16n8k16` on the tensor cores, fp32 accumulate.
// - fp32 operands: the same accumulator elements by scalar FMA on the CUDA cores, in
//   full fp32 (no TF32), so fp32 callers agree with fp32 PyTorch to rounding.
//
// A(m, k) = a[m * lda + k]. B(k, n) = b[n * ldb + k] when kBRowsAreN (B is the transpose
// of a row-major [N, K] tile, e.g. K in Q K^T), else b[k * ldb + n] (a row-major [K, N]
// tile, e.g. V in P V). bf16 tiles need 16-byte aligned rows (ld a multiple of 8) and
// K a multiple of 16; NT is even.
#pragma once

#include <cmath>

#include "common.cuh"

namespace dolo {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int MT, int NT>
__device__ __forceinline__ void zero_acc(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
}

template <int MT, int NT, bool kBRowsAreN>
__device__ __forceinline__ void warp_gemm(float (&acc)[MT][NT][4], const __nv_bfloat16* a,
                                          int lda, const __nv_bfloat16* b, int ldb, int K) {
  static_assert(NT % 2 == 0, "B fragments are loaded two 8-column tiles at a time");
  const int lane = threadIdx.x & 31;
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t af[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int row = mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
      const int col = k0 + (lane >> 4) * 8;
      ldmatrix_x4(af[mt], a + row * lda + col);
    }
#pragma unroll
    for (int nt = 0; nt < NT; nt += 2) {
      uint32_t bf[4];
      if constexpr (kBRowsAreN) {
        const int n = nt * 8 + (lane & 7) + (lane >> 4) * 8;
        const int k = k0 + ((lane >> 3) & 1) * 8;
        ldmatrix_x4(bf, b + n * ldb + k);
      } else {
        const int k = k0 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int n = nt * 8 + (lane >> 4) * 8;
        ldmatrix_x4_trans(bf, b + k * ldb + n);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16_16816(acc[mt][nt], af[mt], bf[0], bf[1]);
        mma_bf16_16816(acc[mt][nt + 1], af[mt], bf[2], bf[3]);
      }
    }
  }
}

// The A fragments of this warp's 16 rows of a bf16 [16, 16 * KT] tile in shared memory,
// loaded once and reused across B tiles (e.g. a query tile against every key tile).
template <int KT>
__device__ __forceinline__ void load_a_frags(uint32_t (&af)[KT][4], const __nv_bfloat16* a,
                                             int lda) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kt = 0; kt < KT; ++kt)
    ldmatrix_x4(af[kt], a + ((lane & 7) + ((lane >> 3) & 1) * 8) * lda + kt * 16 + (lane >> 4) * 8);
}

// The A fragments of an fp32 accumulator tile [16, 8 * NT] held in registers (the C
// layout of mma.sync), rounded to bf16: a product's output feeds the next product
// without a trip through shared memory.
template <int NT>
__device__ __forceinline__ void acc_to_a_frags(uint32_t (&af)[NT / 2][4], const float (&c)[1][NT][4]) {
#pragma unroll
  for (int kt = 0; kt < NT / 2; ++kt) {
    const __nv_bfloat162 r0 = __floats2bfloat162_rn(c[0][2 * kt][0], c[0][2 * kt][1]);
    const __nv_bfloat162 r1 = __floats2bfloat162_rn(c[0][2 * kt][2], c[0][2 * kt][3]);
    const __nv_bfloat162 r2 = __floats2bfloat162_rn(c[0][2 * kt + 1][0], c[0][2 * kt + 1][1]);
    const __nv_bfloat162 r3 = __floats2bfloat162_rn(c[0][2 * kt + 1][2], c[0][2 * kt + 1][3]);
    af[kt][0] = *reinterpret_cast<const uint32_t*>(&r0);
    af[kt][1] = *reinterpret_cast<const uint32_t*>(&r1);
    af[kt][2] = *reinterpret_cast<const uint32_t*>(&r2);
    af[kt][3] = *reinterpret_cast<const uint32_t*>(&r3);
  }
}

// acc += A * B with A given as register fragments (K = 16 * KT), B from shared memory as
// in `warp_gemm`.
template <int NT, int KT, bool kBRowsAreN>
__device__ __forceinline__ void warp_gemm_frags(float (&acc)[1][NT][4], const uint32_t (&af)[KT][4],
                                                const __nv_bfloat16* b, int ldb) {
  static_assert(NT % 2 == 0, "B fragments are loaded two 8-column tiles at a time");
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    const int k0 = kt * 16;
#pragma unroll
    for (int nt = 0; nt < NT; nt += 2) {
      uint32_t bf[4];
      if constexpr (kBRowsAreN) {
        ldmatrix_x4(bf, b + (nt * 8 + (lane & 7) + (lane >> 4) * 8) * ldb + k0 + ((lane >> 3) & 1) * 8);
      } else {
        ldmatrix_x4_trans(bf, b + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ldb + nt * 8 + (lane >> 4) * 8);
      }
      mma_bf16_16816(acc[0][nt], af[kt], bf[0], bf[1]);
      mma_bf16_16816(acc[0][nt + 1], af[kt], bf[2], bf[3]);
    }
  }
}

template <int MT, int NT, bool kBRowsAreN>
__device__ __forceinline__ void warp_gemm(float (&acc)[MT][NT][4], const float* a, int lda,
                                          const float* b, int ldb, int K) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    float av[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      av[mt][0] = a[(mt * 16 + g) * lda + k];
      av[mt][1] = a[(mt * 16 + g + 8) * lda + k];
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = nt * 8 + 2 * c;
      const float b0 = kBRowsAreN ? b[n * ldb + k] : b[k * ldb + n];
      const float b1 = kBRowsAreN ? b[(n + 1) * ldb + k] : b[k * ldb + n + 1];
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

// Block-cooperative copy of a [rows, cols] tile from global memory (rows `stride`
// elements apart) into shared memory (rows `ld` elements apart) in 16-byte vectors;
// rows at or past `valid_rows` are zero-filled. cols * sizeof(T) is a multiple of 16.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src, int64_t stride, int rows,
                                          int cols, int valid_rows) {
  constexpr int kVec = 16 / sizeof(T);
  const int vecs = cols / kVec;
  for (int i = threadIdx.x; i < rows * vecs; i += blockDim.x) {
    const int r = i / vecs;
    const int v = i - r * vecs;
    uint4 value = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid_rows) value = *reinterpret_cast<const uint4*>(src + r * stride + v * kVec);
    *reinterpret_cast<uint4*>(dst + r * ld + v * kVec) = value;
  }
}

// Asynchronous 16-byte copy global -> shared (zero-filled when !valid); pair with
// cp_async_commit / cp_async_wait.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// Block-cooperative asynchronous copy of a [rows, cols] tile (cols * sizeof(T) a
// multiple of 16 bytes, every row 16-byte aligned); the caller commits the group.
template <typename T>
__device__ __forceinline__ void cp_async_tile(T* dst, int ld, const T* src, int64_t stride,
                                              int rows, int cols) {
  constexpr int kVec = 16 / sizeof(T);
  const int vecs = cols / kVec;
  for (int i = threadIdx.x; i < rows * vecs; i += blockDim.x) {
    const int r = i / vecs;
    const int v = i - r * vecs;
    cp_async_16(dst + r * ld + v * kVec, src + r * stride + v * kVec, true);
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A quad (the 4 lanes holding one accumulator row) reduces to every member.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Store a pair of adjacent values (one accumulator column pair) as T.
__device__ __forceinline__ void store_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

}  // namespace dolo
