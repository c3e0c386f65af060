// Fused RMSNorm (+ residual add), forward.
//
// Replaces the Pallas kernels `_rmsnorm_kernel` / `_rmsnorm_residual_kernel`
// (dolomite_engine_tpu/ops/pallas/rmsnorm.py, called from `_rmsnorm_fwd_call`).
// Bound on the H100: device-memory bytes (x, residual, weight in; normed, stream out),
// a few operations per byte. Design: one warp per row, the row in registers. Lane l
// holds chunks l, l + 32, ... of the row, each one access of kBytes (16 where the row
// allows: 8 bf16 or 4 fp32; else the widest power of two that divides the row's bytes
// and the bases' alignment, so every row starts aligned), and the last round of chunks
// is masked (the tail). A row's loads are all issued before its first use; every input
// byte is read once, every output byte written once, from the same registers; the sum
// of squares is a warp shuffle. The grid is at most kCtasPerSm CTAs an SM, each warp
// walking rows `gridDim.x * kWarps` apart with the weight, rounded to the element type
// once, in its registers.
// Limit (registers): kMaxChunks chunks a lane, i.e. 24 * 32 * 16 bytes of a row in
// 16-byte accesses (bf16 6144, fp32 3072), proportionally fewer in narrower ones.
//
// Numerics mirror `ops/normalization.rmsnorm`: s = x + r in the element type,
// normed = cast(s32 * rsqrt(mean(s32^2) + eps)), out = normed * cast(weight) in the
// element type.
#include "common.cuh"
#include "sm90.cuh"  // sm_count

namespace {

using namespace dolo;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kCtasPerSm = 4;  // the grid's cap: a warp's weight registers serve several rows
constexpr int kMaxChunks = 24;

// the unsigned word of one access
template <int kBytes>
struct Word;
template <>
struct Word<16> {
  using type = uint4;
};
template <>
struct Word<8> {
  using type = uint2;
};
template <>
struct Word<4> {
  using type = uint32_t;
};
template <>
struct Word<2> {
  using type = uint16_t;
};

template <typename T, int kElems, typename W>
__device__ __forceinline__ void unpack(const W& word, float (&f)[kElems]) {
  const T* p = reinterpret_cast<const T*>(&word);
#pragma unroll
  for (int e = 0; e < kElems; ++e) f[e] = to_float(p[e]);
}

template <typename T, int kElems, typename W>
__device__ __forceinline__ W pack(const float (&f)[kElems]) {
  W word;
  T* p = reinterpret_cast<T*>(&word);
#pragma unroll
  for (int e = 0; e < kElems; ++e) p[e] = from_float<T>(f[e]);
  return word;
}

// the weight's chunk `idx` (fp32 elements idx * kElems, ...), in 16-byte loads where
// they are aligned
template <int kElems>
__device__ __forceinline__ void load_weight(float (&f)[kElems], const float* weight, int idx, bool vec) {
  if constexpr (kElems % 4 == 0) {
    if (vec) {
#pragma unroll
      for (int q = 0; q < kElems / 4; ++q) {
        const float4 w4 = reinterpret_cast<const float4*>(weight + idx * kElems)[q];
        f[4 * q] = w4.x;
        f[4 * q + 1] = w4.y;
        f[4 * q + 2] = w4.z;
        f[4 * q + 3] = w4.w;
      }
      return;
    }
  }
#pragma unroll
  for (int e = 0; e < kElems; ++e) f[e] = weight[idx * kElems + e];
}

template <typename T, int kBytes, int kChunks, bool kResidual>
__global__ void __launch_bounds__(kThreads) rmsnorm_kernel(
    const T* __restrict__ x, const T* __restrict__ residual, const float* __restrict__ weight,
    T* __restrict__ out, T* __restrict__ stream_out, int rows, int dim, float eps) {
  constexpr int kElems = kBytes / sizeof(T);
  using W = typename Word<kBytes>::type;
  const int lane = threadIdx.x & 31;
  const int chunks = dim / kElems;
  const float inv_dim = 1.f / static_cast<float>(dim);
  const bool weight_vec = (reinterpret_cast<uintptr_t>(weight) & 15) == 0;

  W w[kChunks];  // the weight rounded to T, this lane's chunks
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int idx = lane + 32 * i;
    float f[kElems];
#pragma unroll
    for (int e = 0; e < kElems; ++e) f[e] = 0.f;
    if (idx < chunks) load_weight(f, weight, idx, weight_vec);
    w[i] = pack<T, kElems, W>(f);
  }

  for (int row = blockIdx.x * kWarps + (threadIdx.x >> 5); row < rows; row += gridDim.x * kWarps) {
    const int64_t base = static_cast<int64_t>(row) * dim;
    // every load of the row first, so they are all in flight together
    W v[kChunks], r[kResidual ? kChunks : 1];
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int idx = lane + 32 * i;
      if (idx < chunks) {
        v[i] = reinterpret_cast<const W*>(x + base)[idx];
        if constexpr (kResidual) r[i] = reinterpret_cast<const W*>(residual + base)[idx];
      }
    }
    float sum_sq = 0.f;
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int idx = lane + 32 * i;
      if (idx < chunks) {
        float a[kElems];
        unpack<T>(v[i], a);
        if constexpr (kResidual) {
          float b[kElems];
          unpack<T>(r[i], b);
#pragma unroll
          for (int e = 0; e < kElems; ++e) a[e] += b[e];
          v[i] = pack<T, kElems, W>(a);  // s = x + r, rounded to T
          reinterpret_cast<W*>(stream_out + base)[idx] = v[i];
          unpack<T>(v[i], a);
        }
#pragma unroll
        for (int e = 0; e < kElems; ++e) sum_sq += a[e] * a[e];
      }
    }
    const float inv = rsqrtf(warp_sum(sum_sq) * inv_dim + eps);
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int idx = lane + 32 * i;
      if (idx < chunks) {
        float a[kElems], g[kElems];
        unpack<T>(v[i], a);
        unpack<T>(w[i], g);
#pragma unroll
        for (int e = 0; e < kElems; ++e) a[e] = round_to<T>(a[e] * inv) * g[e];
        reinterpret_cast<W*>(out + base)[idx] = pack<T, kElems, W>(a);
      }
    }
  }
}

template <typename T, int kBytes, int kChunks>
cudaError_t launch(const void* x, const void* residual, const void* weight, void* out, void* stream_out, int rows,
                   int dim, float eps, cudaStream_t stream) {
  int sms = 0;
  const cudaError_t err = sm90::sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int needed = (rows + kWarps - 1) / kWarps;
  const int grid = needed < sms * kCtasPerSm ? needed : sms * kCtasPerSm;
  if (residual != nullptr) {
    rmsnorm_kernel<T, kBytes, kChunks, true><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(residual), static_cast<const float*>(weight),
        static_cast<T*>(out), static_cast<T*>(stream_out), rows, dim, eps);
  } else {
    rmsnorm_kernel<T, kBytes, kChunks, false><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), nullptr, static_cast<const float*>(weight), static_cast<T*>(out), nullptr, rows,
        dim, eps);
  }
  return cudaGetLastError();
}

// the smallest compiled chunk count that holds a lane's share of the row
template <typename T, int kBytes>
cudaError_t dispatch_chunks(const void* x, const void* residual, const void* weight, void* out, void* stream_out,
                            int rows, int dim, float eps, cudaStream_t stream) {
  const int per_lane = (dim / static_cast<int>(kBytes / sizeof(T)) + 31) / 32;
  if (per_lane <= 2) return launch<T, kBytes, 2>(x, residual, weight, out, stream_out, rows, dim, eps, stream);
  if (per_lane <= 4) return launch<T, kBytes, 4>(x, residual, weight, out, stream_out, rows, dim, eps, stream);
  if (per_lane <= 8) return launch<T, kBytes, 8>(x, residual, weight, out, stream_out, rows, dim, eps, stream);
  if (per_lane <= 10) return launch<T, kBytes, 10>(x, residual, weight, out, stream_out, rows, dim, eps, stream);
  if (per_lane <= 16) return launch<T, kBytes, 16>(x, residual, weight, out, stream_out, rows, dim, eps, stream);
  if (per_lane <= 20) return launch<T, kBytes, 20>(x, residual, weight, out, stream_out, rows, dim, eps, stream);
  if (per_lane <= kMaxChunks)
    return launch<T, kBytes, kMaxChunks>(x, residual, weight, out, stream_out, rows, dim, eps, stream);
  return cudaErrorInvalidValue;
}

// The access width: 16 bytes, or the widest power of two that divides a row's bytes and
// every base, at least one element.
int access_bytes(int dim, int elem, const void* x, const void* residual, const void* out, const void* stream_out) {
  const uintptr_t bases = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(residual) |
                          reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(stream_out);
  int bytes = 16;
  while (bytes > elem && ((static_cast<uintptr_t>(dim) * elem) % bytes || bases % bytes)) bytes /= 2;
  return bytes;
}

template <typename T>
cudaError_t dispatch(const void* x, const void* residual, const void* weight, void* out, void* stream_out, int rows,
                     int dim, float eps, cudaStream_t stream) {
  switch (access_bytes(dim, sizeof(T), x, residual, out, stream_out)) {
    case 16:
      return dispatch_chunks<T, 16>(x, residual, weight, out, stream_out, rows, dim, eps, stream);
    case 8:
      return dispatch_chunks<T, 8>(x, residual, weight, out, stream_out, rows, dim, eps, stream);
    case 4:
      return dispatch_chunks<T, 4>(x, residual, weight, out, stream_out, rows, dim, eps, stream);
    default:
      if constexpr (sizeof(T) == 2) return dispatch_chunks<T, 2>(x, residual, weight, out, stream_out, rows, dim, eps, stream);
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, residual (may be null), out, stream_out: [rows, dim] of `dtype`; weight: [dim] fp32.
extern "C" int dolo_rmsnorm(const void* x, const void* residual, const void* weight, void* out,
                            void* stream_out, int rows, int dim, float eps, int dtype,
                            void* stream) {
  if (rows <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case dolo::kFloat32:
      return dispatch<float>(x, residual, weight, out, stream_out, rows, dim, eps, s);
    case dolo::kBFloat16:
      return dispatch<__nv_bfloat16>(x, residual, weight, out, stream_out, rows, dim, eps, s);
    default:
      return cudaErrorInvalidValue;
  }
}
