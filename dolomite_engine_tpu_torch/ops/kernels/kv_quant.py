"""KV page quantization: the CUDA kernel's wrapper.

Replaces the TPU kernel ``quantize_pages_pallas``
(`dolomite_engine_tpu/ops/pallas/kv_quant.py`). Bound on the H100 by device-memory bytes:
the fp32 window in, the codes out. One block per (page, kv head) reduces the absmax over
the page's valid rows and writes the codes; its output is byte-identical to the plain
version, `ops/kv_quant.quantize_pages_plain` (see
``dolomite_engine_tpu_torch/csrc/kv_quant.cu`` for the rounding traps).

`ops/kv_quant.quantize_pages` launches this kernel for CUDA tensors and takes the plain
version for CPU tensors.
"""

from __future__ import annotations

import torch

from ._build import (
    DTYPE_CODES,
    KernelSpec,
    check_cuda_tensor,
    check_launch,
    current_stream,
    load_library,
    ptr,
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
    KERNEL.launches += 1
    return codes, scales
