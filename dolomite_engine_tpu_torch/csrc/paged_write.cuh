// The write window of a paged K/V write: which pool row a new token goes to, if any.
//
// The rules of the plain version (`ops/attention.write_positions` and `paged_scatter_kv`,
// after the JAX package's `_update_paged_kv_cache`): row b writes its S new tokens at the
// positions start_b + s, where start_b is the row's own frontier (a [B] cache index: a
// decode or verify step) or the chunk's shared offset (a scalar: a prefill chunk). A
// position past the view (max_pages * page_size) is out of range, and so is one the
// key-side mask marks 0 (a prefill chunk's pad tail); the plain version sends those writes
// to the trash page 0, and so does a table entry of 0 (an idle row). Page 0 is never read
// unmasked, so the kernels drop such writes instead: every other page ends byte-identical.
#pragma once

#include <cstdint>

namespace dolo {

struct PagedWindow {
  const int* table;   // [B, max_pages] physical page of each logical page
  const void* index;  // the start: [B] or 0-d, int32 or int64 (null: `start`)
  const void* mask;   // [B, >= view] key-side validity, nonzero = valid (null: none)
  int64_t mask_stride;
  int index_kind;     // 0: the scalar `start`; 1: int32 `index`; 2: int64 `index`
  int index_stride;   // 0 for a 0-d index
  int start;
  int mask_kind;      // 0: no mask; 1: int32; 2: one byte (bool); 3: int64
  int page_size;
  int max_pages;

  __device__ __forceinline__ int64_t view_len() const {
    return static_cast<int64_t>(max_pages) * page_size;
  }

  // start_b: the position of row b's first new token
  __device__ __forceinline__ int64_t row_start(int b) const {
    if (index_kind == 1) return static_cast<const int*>(index)[static_cast<int64_t>(b) * index_stride];
    if (index_kind == 2) return static_cast<const int64_t*>(index)[static_cast<int64_t>(b) * index_stride];
    return start;
  }

  // whether the key mask lets row b write position p (p inside the view)
  __device__ __forceinline__ bool unmasked(int b, int64_t p) const {
    if (mask_kind == 1) return static_cast<const int*>(mask)[b * mask_stride + p] != 0;
    if (mask_kind == 2) return static_cast<const uint8_t*>(mask)[b * mask_stride + p] != 0;
    if (mask_kind == 3) return static_cast<const int64_t*>(mask)[b * mask_stride + p] != 0;
    return true;
  }

  // the pool row (physical page * page_size + offset) that row b's token at position p
  // goes to, or -1 where the plain version writes the trash page
  __device__ __forceinline__ int64_t pool_row(int b, int64_t p) const {
    if (p < 0 || p >= view_len() || !unmasked(b, p)) return -1;
    const int phys = table[static_cast<int64_t>(b) * max_pages + p / page_size];
    if (phys == 0) return -1;
    return static_cast<int64_t>(phys) * page_size + p % page_size;
  }
};

}  // namespace dolo
