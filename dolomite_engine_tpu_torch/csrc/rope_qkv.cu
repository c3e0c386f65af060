// Fused QKV rotary embedding: the flat form, and the paged form that writes K/V to the pool.
//
// Replaces the Pallas kernel `_rope_qkv_kernel` (dolomite_engine_tpu/ops/pallas/rope_qkv.py,
// called from `_rope_qkv_call`). Bound on the H100: device-memory bytes (the fused
// [rows, (Hq + 2 Hkv) * D] projection read once and written once, plus cos/sin).
//
// Design: one thread per rotation pair (d, d + D/2) of a Q or K head, over a vector of N
// consecutive d (16 bytes of the element type where the head's halves, the bases and the
// cos/sin strides allow; N = 1 otherwise), so each element is read once and written once;
// the V block is copied in vectors of the same width. cos/sin are read as [S, D] rows of
// their own dtype with a batch stride (0 when one table serves every row) and rounded to
// the element type in registers, as the plain version's cast does. The rotation keeps the
// arithmetic of the first version of this kernel: the fp32 value of x * cos + rotated *
// sin, rounded once to the element type (the plain version rounds after every bf16 op).
// `negate` flips sin for the backward (the rotation's transpose), so no -sin pass runs.
//
// The paged form (serving's decode and prefill kernel branches) sends each column where
// the attention kernels read it, in the same launch: the rotated query to a contiguous
// [B, S, Hq, D] tensor, the rotated K rows and the V rows either straight into the pool's
// pages through the page table (cast to the pool dtype: bf16 or fp32), or, for a
// quantized pool, to contiguous [B, S, Hkv, D] tensors that the fused scatter-quantize
// (csrc/kv_quant.cu) consumes. Writes the plain version sends to the trash page are
// dropped (csrc/paged_write.cuh).
#include "common.cuh"
#include "paged_write.cuh"

namespace {

using namespace dolo;

constexpr int kThreads = 256;

// N elements, accessed at once (16 bytes at most per access; wider vectors split)
template <typename T, int N>
struct alignas(sizeof(T) * N > 16 ? 16 : sizeof(T) * N) Vec {
  T v[N];
};

template <typename T, int N>
__device__ __forceinline__ Vec<T, N> load_vec(const T* p) {
  return *reinterpret_cast<const Vec<T, N>*>(p);
}

// store N fp32 values as U, each first rounded to T (the activation dtype), then to U
template <typename T, typename U, int N>
__device__ __forceinline__ void store_vec(U* p, const float (&x)[N]) {
  Vec<U, N> out;
#pragma unroll
  for (int k = 0; k < N; ++k) out.v[k] = from_float<U>(round_to<T>(x[k]));
  *reinterpret_cast<Vec<U, N>*>(p) = out;
}

// where the columns of a row go
enum Mode : int { kFlat = 0, kSplit = 1, kPool = 2 };

struct Args {
  const void* qkv;   // [B * S, (Hq + 2 Hkv) * D]
  const void* cos;   // [Bc, S, D] by the strides below (null: no rotation)
  const void* sin;
  void* out;         // kFlat: [B * S, width]; kSplit / kPool: the query [B * S, Hq * D]
  void* k_dst;       // kSplit: [B * S, Hkv * D]; kPool: the K pool [pages, page_size, Hkv, D]
  void* v_dst;
  PagedWindow window;  // kPool only
  int64_t rows;
  int seq, num_heads, num_kv_heads, head_dim;
  int cs_batch_stride, cs_seq_stride;  // elements
  int negate;
  int mode;
};

template <typename T, typename P, int N>
__device__ __forceinline__ void store_cols(const Args& a, int64_t row, int col, const float (&x)[N]) {
  const int width = (a.num_heads + 2 * a.num_kv_heads) * a.head_dim;
  if (a.mode == kFlat) {
    store_vec<T, T, N>(static_cast<T*>(a.out) + row * width + col, x);
    return;
  }
  const int q_cols = a.num_heads * a.head_dim;
  if (col < q_cols) {
    store_vec<T, T, N>(static_cast<T*>(a.out) + row * q_cols + col, x);
    return;
  }
  const int kv_cols = a.num_kv_heads * a.head_dim;
  const bool is_k = col < q_cols + kv_cols;
  const int kv_col = col - q_cols - (is_k ? 0 : kv_cols);
  void* dst = is_k ? a.k_dst : a.v_dst;
  if (a.mode == kSplit) {
    store_vec<T, T, N>(static_cast<T*>(dst) + row * kv_cols + kv_col, x);
    return;
  }
  const int b = static_cast<int>(row / a.seq);
  const int s = static_cast<int>(row - static_cast<int64_t>(b) * a.seq);
  const int64_t slot = a.window.pool_row(b, a.window.row_start(b) + s);
  if (slot < 0) return;
  store_vec<T, P, N>(static_cast<P*>(dst) + slot * kv_cols + kv_col, x);
}

template <typename T, typename C, typename P, int N>
__global__ void __launch_bounds__(kThreads) rope_qkv_kernel(const Args a) {
  const int half = a.head_dim >> 1;
  const int pairs_per_head = half / N;
  const int rope_heads = a.num_heads + a.num_kv_heads;
  const int total_heads = a.num_heads + 2 * a.num_kv_heads;
  const int pair_items = rope_heads * pairs_per_head;
  const int items_per_row = pair_items + (total_heads - rope_heads) * a.head_dim / N;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= a.rows * items_per_row) return;
  const int64_t row = i / items_per_row;
  const int item = static_cast<int>(i - row * items_per_row);
  const T* src = static_cast<const T*>(a.qkv) + row * (total_heads * a.head_dim);

  if (item >= pair_items) {  // the heads past the rotated ones (V): copied
    const int col = rope_heads * a.head_dim + (item - pair_items) * N;
    const Vec<T, N> x = load_vec<T, N>(src + col);
    float y[N];
#pragma unroll
    for (int k = 0; k < N; ++k) y[k] = to_float(x.v[k]);
    store_cols<T, P, N>(a, row, col, y);
    return;
  }
  const int h = item / pairs_per_head;
  const int d = (item - h * pairs_per_head) * N;
  const int col = h * a.head_dim + d;
  const Vec<T, N> x1 = load_vec<T, N>(src + col);
  const Vec<T, N> x2 = load_vec<T, N>(src + col + half);
  float y1[N], y2[N];
  if (a.cos == nullptr) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      y1[k] = to_float(x1.v[k]);
      y2[k] = to_float(x2.v[k]);
    }
  } else {
    const int b = static_cast<int>(row / a.seq);
    const int s = static_cast<int>(row - static_cast<int64_t>(b) * a.seq);
    const int64_t cs = static_cast<int64_t>(b) * a.cs_batch_stride + static_cast<int64_t>(s) * a.cs_seq_stride + d;
    const Vec<C, N> c1 = load_vec<C, N>(static_cast<const C*>(a.cos) + cs);
    const Vec<C, N> c2 = load_vec<C, N>(static_cast<const C*>(a.cos) + cs + half);
    const Vec<C, N> s1 = load_vec<C, N>(static_cast<const C*>(a.sin) + cs);
    const Vec<C, N> s2 = load_vec<C, N>(static_cast<const C*>(a.sin) + cs + half);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      // cos/sin cast to the element type first, as the TPU kernel and the plain version do
      const float ca = round_to<T>(to_float(c1.v[k]));
      const float cb = round_to<T>(to_float(c2.v[k]));
      float sa = round_to<T>(to_float(s1.v[k]));
      float sb = round_to<T>(to_float(s2.v[k]));
      if (a.negate) {
        sa = -sa;
        sb = -sb;
      }
      // x * c + rotate_half(x) * s: rotate_half gives -x2 in the first half, x1 in the second
      const float xa = to_float(x1.v[k]);
      const float xb = to_float(x2.v[k]);
      const float ra = -xb;
      y1[k] = xa * ca + ra * sa;
      y2[k] = xb * cb + xa * sb;
    }
  }
  store_cols<T, P, N>(a, row, col, y1);
  store_cols<T, P, N>(a, row, col + half, y2);
}

template <typename T, typename C, typename P, int N>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int half = a.head_dim >> 1;
  const int total_heads = a.num_heads + 2 * a.num_kv_heads;
  const int64_t items_per_row =
      (a.num_heads + a.num_kv_heads) * (half / N) + a.num_kv_heads * a.head_dim / N;
  const int64_t blocks = (a.rows * items_per_row + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff || total_heads <= 0) return cudaErrorInvalidValue;
  rope_qkv_kernel<T, C, P, N><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

// the vector width: 16 bytes of T where the wrapper found the layout aligned, else 1
template <typename T, typename C, typename P>
cudaError_t launch_width(const Args& a, int vec, cudaStream_t stream) {
  return vec ? launch<T, C, P, static_cast<int>(16 / sizeof(T))>(a, stream) : launch<T, C, P, 1>(a, stream);
}

template <typename T, typename C>
cudaError_t launch_pool(const Args& a, int pool_dtype, int vec, cudaStream_t stream) {
  switch (pool_dtype) {
    case kFloat32:
      return launch_width<T, C, float>(a, vec, stream);
    case kBFloat16:
      return launch_width<T, C, __nv_bfloat16>(a, vec, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_cos(const Args& a, int cs_dtype, int pool_dtype, int vec, cudaStream_t stream) {
  switch (cs_dtype) {
    case kFloat32:
      return launch_pool<T, float>(a, pool_dtype, vec, stream);
    case kBFloat16:
      return launch_pool<T, __nv_bfloat16>(a, pool_dtype, vec, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch(const Args& a, int dtype, int cs_dtype, int pool_dtype, int vec, void* stream) {
  if (a.rows <= 0) return cudaSuccess;
  if (a.head_dim % 2) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch_cos<float>(a, cs_dtype, pool_dtype, vec, s);
    case kBFloat16:
      return launch_cos<__nv_bfloat16>(a, cs_dtype, pool_dtype, vec, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// The flat form: qkv, out [B * S, (Hq + 2 Hkv) * D] of `dtype`; cos, sin [Bc, S, D] of
// `cs_dtype` at the given element strides of a batch row and a position; `negate` uses
// -sin (the backward). `vec` != 0: 16-byte vectors (the wrapper checked the alignment).
extern "C" int dolo_rope_qkv(const void* qkv, const void* cos, const void* sin, void* out, int batch,
                             int seq, int num_heads, int num_kv_heads, int head_dim,
                             int cs_batch_stride, int cs_seq_stride, int cs_dtype, int negate,
                             int vec, int dtype, void* stream) {
  Args a{};
  a.qkv = qkv;
  a.cos = cos;
  a.sin = sin;
  a.out = out;
  a.rows = static_cast<int64_t>(batch) * seq;
  a.seq = seq;
  a.num_heads = num_heads;
  a.num_kv_heads = num_kv_heads;
  a.head_dim = head_dim;
  a.cs_batch_stride = cs_batch_stride;
  a.cs_seq_stride = cs_seq_stride;
  a.negate = negate;
  a.mode = kFlat;
  if (cos == nullptr || sin == nullptr) return cudaErrorInvalidValue;
  return dispatch(a, dtype, cs_dtype, dtype, vec, stream);
}

// The paged form: the query to q_out [B, S, Hq, D]; with `pool` != 0 the K and V rows into
// the pools k_dst / v_dst [pages, page_size, Hkv, D] of `pool_dtype` through `table`
// [B, max_pages] at the window's positions (csrc/paged_write.cuh), else to k_dst / v_dst
// [B, S, Hkv, D] of `dtype`. cos == null: no rotation (a model without rope).
extern "C" int dolo_rope_qkv_paged(const void* qkv, const void* cos, const void* sin, void* q_out,
                                   void* k_dst, void* v_dst, const void* table, const void* index,
                                   const void* mask, int batch, int seq, int num_heads,
                                   int num_kv_heads, int head_dim, int cs_batch_stride,
                                   int cs_seq_stride, int cs_dtype, int pool, int page_size,
                                   int max_pages, int index_kind, int index_stride, int start,
                                   int mask_kind, int mask_stride, int vec, int dtype,
                                   int pool_dtype, void* stream) {
  Args a{};
  a.qkv = qkv;
  a.cos = cos;
  a.sin = sin;
  a.out = q_out;
  a.k_dst = k_dst;
  a.v_dst = v_dst;
  a.window = PagedWindow{static_cast<const int*>(table), index, mask, mask_stride, index_kind,
                         index_stride, start, mask_kind, page_size, max_pages};
  a.rows = static_cast<int64_t>(batch) * seq;
  a.seq = seq;
  a.num_heads = num_heads;
  a.num_kv_heads = num_kv_heads;
  a.head_dim = head_dim;
  a.cs_batch_stride = cs_batch_stride;
  a.cs_seq_stride = cs_seq_stride;
  a.mode = pool ? kPool : kSplit;
  if ((cos == nullptr) != (sin == nullptr)) return cudaErrorInvalidValue;
  if (pool && (page_size <= 0 || max_pages <= 0)) return cudaErrorInvalidValue;
  return dispatch(a, dtype, cos == nullptr ? dtype : cs_dtype, pool ? pool_dtype : dtype, vec, stream);
}
