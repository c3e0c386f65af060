"""KV page quantization: the CUDA kernel's two wrappers.

Replaces the TPU kernel ``quantize_pages_pallas``
(`dolomite_engine_tpu/ops/pallas/kv_quant.py`). Bound on the H100 by device-memory bytes.
Two forms, both byte-identical to their plain versions (see
``dolomite_engine_tpu_torch/csrc/kv_quant.cu`` for the rounding traps):

- the encode, `quantize_pages_kernel`: fp32 pages in, codes and scales out, one block per
  (page, kv head); plain version `ops/kv_quant.quantize_pages_plain`, dispatch
  `ops/kv_quant.quantize_pages`;
- the fused scatter-quantize, `paged_scatter_kv_quantized_kernel`: a layer's new K and V
  rows quantized into their pools in place, in one launch (page walk, dequantize, insert,
  absmax, encode and write-back); plain version
  `ops/attention.paged_write_kv_quantized_plain`, dispatch
  `ops/attention.paged_scatter_kv_quantized`.

Both launch for CUDA tensors or raise; the dispatching functions take the plain versions
for CPU tensors.
"""

from __future__ import annotations

import torch

from ..kv_quant import kv_qmax
from ._build import (
    DTYPE_CODES,
    KernelSpec,
    check_cuda_tensor,
    check_launch,
    current_stream,
    load_library,
    ptr,
    window_args,
)

KERNEL = KernelSpec(
    name="kv_quant",
    source="dolomite_engine_tpu_torch/csrc/kv_quant.cu",
    replaces="dolomite_engine_tpu/ops/pallas/kv_quant.py:46",
)

MAX_PAGES = 65535  # pages of one launch: the grid's y extent


def quantize_pages_kernel(
    values: torch.Tensor, valid: torch.Tensor, qmax: float, out_dtype: torch.dtype
) -> tuple[torch.Tensor, torch.Tensor]:
    """Encode fp32 pages ``[N, page_size, H, D]`` (rows marked by ``valid`` ``[N,
    page_size]`` bool) to ``out_dtype`` codes and ``[N, H]`` fp32 scales on the card."""
    if values.device.type != "cuda":
        raise ValueError(f"the kv_quant kernel runs on CUDA tensors, got {values.device}")
    if values.ndim != 4 or valid.shape != values.shape[:2]:
        raise ValueError("values must be [N, page_size, H, D] and valid [N, page_size]")
    if out_dtype not in (torch.int8, torch.float8_e4m3fn):
        raise ValueError(f"kv_quant encodes to int8 or float8_e4m3fn, not {out_dtype}")
    device = values.device
    check_cuda_tensor(values, "values", device, dtypes=(torch.float32,))
    check_cuda_tensor(valid, "valid", device, dtypes=(torch.bool,))
    num_pages, page_size, num_heads, head_dim = values.shape
    if num_pages > MAX_PAGES:
        raise ValueError(f"{num_pages} pages exceed one launch's {MAX_PAGES}")
    codes = torch.empty(values.shape, dtype=out_dtype, device=device)
    scales = torch.empty((num_pages, num_heads), dtype=torch.float32, device=device)
    # ctypes rounds the double 1.0 / qmax to float32 once: the reference's constant
    code = load_library().dolo_kv_quant(
        ptr(values), ptr(valid), ptr(codes), ptr(scales), num_pages, page_size, num_heads,
        head_dim, float(qmax), 1.0 / float(qmax), DTYPE_CODES[out_dtype], current_stream(device),
    )
    check_launch(code, KERNEL.name)
    KERNEL.launched("encode")
    return codes, scales


MAX_PAGE_SIZE = 256  # rows a page: the kernel flags the written ones in shared memory


def paged_scatter_kv_quantized_kernel(
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    k_scales: torch.Tensor,
    v_scales: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    page_table: torch.Tensor,
    cache_index: torch.Tensor | int,
    key_mask: torch.Tensor | None = None,
) -> None:
    """Quantize a layer's new K and V ``[B, S, Hkv, D]`` (bf16 / fp32; rows may be strided,
    each row's ``Hkv * D`` values contiguous) into int8 / fp8 pools ``[num_pages,
    page_size, Hkv, D]`` with ``[num_pages, Hkv]`` fp32 scales, in place, in one launch.
    The window: ``page_table`` ``[B, max_pages]`` int32, `cache_index` a [B] or 0-d int32
    / int64 tensor or an int, `key_mask` None or ``[B, view]`` ints or bools."""
    if key.device.type != "cuda":
        raise ValueError(f"the fused scatter-quantize kernel runs on CUDA tensors, got {key.device}")
    device = key.device
    if k_pages.ndim != 4 or v_pages.shape != k_pages.shape or k_pages.dtype != v_pages.dtype:
        raise ValueError("k_pages and v_pages must be [num_pages, page_size, Hkv, D] of one dtype")
    if k_pages.dtype not in (torch.int8, torch.float8_e4m3fn):
        raise ValueError(f"the fused scatter-quantize writes int8 or float8_e4m3fn pools, not {k_pages.dtype}")
    num_pages, page_size, heads, head_dim = k_pages.shape
    batch, seq = key.shape[:2]
    if key.shape != (batch, seq, heads, head_dim) or value.shape != key.shape:
        raise ValueError(f"key / value {tuple(key.shape)} / {tuple(value.shape)} are not [B, S, {heads}, {head_dim}]")
    if key.stride() != value.stride() or key.stride(3) != 1 or key.stride(2) != head_dim:
        raise ValueError("key and value must share strides, each row's heads contiguous")
    if not 0 < page_size <= MAX_PAGE_SIZE:
        raise ValueError(f"page_size {page_size} is not in [1, {MAX_PAGE_SIZE}]")
    for name, tensor in (("k_pages", k_pages), ("v_pages", v_pages)):
        check_cuda_tensor(tensor, name, device, dtypes=(k_pages.dtype,))
    for name, tensor in (("k_scales", k_scales), ("v_scales", v_scales)):
        check_cuda_tensor(tensor, name, device, dtypes=(torch.float32,))
        if tensor.shape != (num_pages, heads):
            raise ValueError(f"{name} {tuple(tensor.shape)} is not [{num_pages}, {heads}]")
    if key.device != device or value.device != device or key.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"key / value must be fp32 or bf16 on {device}")
    if value.dtype != key.dtype:
        raise ValueError("key and value must share a dtype")
    check_cuda_tensor(page_table, "page_table", device, dtypes=(torch.int32,))
    if page_table.ndim != 2 or page_table.shape[0] != batch:
        raise ValueError(f"page_table {tuple(page_table.shape)} is not [{batch}, max_pages]")
    max_pages = page_table.shape[1]
    kind, index, stride, start, mask_kind, mask, mask_stride = window_args(
        cache_index, key_mask, batch, max_pages * page_size, device
    )
    qmax = kv_qmax(k_pages.dtype)
    code = load_library().dolo_kv_quant_scatter(
        ptr(k_pages), ptr(v_pages), ptr(k_scales), ptr(v_scales), ptr(key), ptr(value),
        ptr(page_table), ptr(index), ptr(mask), batch, seq, heads, head_dim, page_size, max_pages,
        key.stride(0), key.stride(1), kind, stride, start, mask_kind, mask_stride,
        qmax, 1.0 / qmax, DTYPE_CODES[k_pages.dtype], DTYPE_CODES[key.dtype], current_stream(device),
    )
    check_launch(code, KERNEL.name)
    KERNEL.launched("scatter")
