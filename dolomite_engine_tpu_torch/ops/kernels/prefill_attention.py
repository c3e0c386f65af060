"""Chunked-prefill flash attention through the page table: the CUDA kernel and its plain
version.

Replaces the TPU kernel ``paged_prefill_attention``
(`dolomite_engine_tpu/ops/pallas/prefill_attention.py`). Bound on the H100 by operations
for wide chunks and by bytes for narrow ones. The kernel is FlashAttention-2 on the
tensor cores (bf16 ``mma.sync``, fp32 accumulate; an fp32 query takes the same tiles by
scalar fp32 FMA): one block per (64-query tile, query head, chunk row), Q and the
online-softmax state in registers, 64-key tiles streamed through a cp.async ring
straight off the page-table row, masked per element only where a tile crosses the
query tile's frontier (see ``dolomite_engine_tpu_torch/csrc/prefill_attention.cu``).
Pages may be in the query's dtype, in bf16 under an fp32 query, or int8 / fp8 codes with
their ``[P, Hkv]`` fp32 scale pools: under a bf16 query the codes enter the products as
bf16 (exactly) and the K scale multiplies the scores, the V scale the probabilities
before they are rounded to bf16; under an fp32 query they are dequantized in fp32.

`paged_prefill_attention` launches the kernel for CUDA tensors (or raises) and takes the
plain version for CPU tensors.
"""

from __future__ import annotations

import torch

from ..attention import eager_attention, make_attention_mask
from ._build import (
    DTYPE_CODES,
    MAX_SHARED_BYTES,
    KernelSpec,
    check_cuda_tensor,
    check_launch,
    current_stream,
    load_library,
    ptr,
)
from .paged_attention import check_cuda_pages, check_head_dim, check_page_types, gather_pages

KERNEL = KernelSpec(
    name="paged_prefill_attention",
    source="dolomite_engine_tpu_torch/csrc/prefill_attention.cu",
    replaces="dolomite_engine_tpu/ops/pallas/prefill_attention.py:140",
)


def _check_shapes(q, k_pages, v_pages, page_table, starts, k_scales, v_scales):
    if q.ndim != 4 or k_pages.ndim != 4 or k_pages.shape != v_pages.shape:
        raise ValueError("q must be [B, chunk, Hq, D] and k/v pages [P, page_size, Hkv, D]")
    num_rows, _, num_q_heads, head_dim = q.shape
    num_kv_heads = k_pages.shape[2]
    if k_pages.shape[3] != head_dim or num_q_heads % num_kv_heads:
        raise ValueError(f"q {tuple(q.shape)} does not match pages {tuple(k_pages.shape)}")
    if page_table.shape[0] != num_rows or starts.shape != (num_rows,):
        raise ValueError("page_table must be [B, max_pages] and start [B]")
    check_page_types(k_pages, v_pages, k_scales, v_scales)


def paged_prefill_attention_plain(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_table: torch.Tensor,
    start: torch.Tensor,
    softmax_scale: float,
    k_scales: torch.Tensor | None = None,
    v_scales: torch.Tensor | None = None,
) -> torch.Tensor:
    """Gather each row's page view and run eager fp32-softmax attention under the per-row
    causal frontier (query i of row b sees positions <= start[b] + i). A quantized pool
    is dequantized in fp32 and attended in fp32, as the Pallas kernel computes it; the
    output is rounded to q's dtype once."""
    _check_shapes(q, k_pages, v_pages, page_table, start, k_scales, v_scales)
    view_len = page_table.shape[1] * k_pages.shape[1]
    mask = make_attention_mask(
        q.shape[0], q.shape[1], view_len, causal=True, query_offset=start
    )
    dtype = q.dtype if k_scales is None else torch.float32
    out = eager_attention(
        q.to(dtype), gather_pages(k_pages, k_scales, page_table, dtype),
        gather_pages(v_pages, v_scales, page_table, dtype), mask, softmax_scale,
    )
    return out.to(q.dtype)


def paged_prefill_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_table: torch.Tensor,
    start: torch.Tensor,
    softmax_scale: float,
    k_scales: torch.Tensor | None = None,
    v_scales: torch.Tensor | None = None,
) -> torch.Tensor:
    """Chunked-prefill attention straight off the page table.

    q ``[B, chunk, Hq, D]``; pages in q's dtype or bf16, or int8 / fp8 codes with
    ``k_scales`` / ``v_scales`` ``[P, Hkv]`` fp32; start ``[B]`` int32, each row's chunk
    write offset; page_table ``[B, max_pages]`` int32. Returns ``[B, chunk, Hq, D]``; rows
    of the chunk's right-pad tail hold finite garbage the caller never reads."""
    if q.device.type == "cpu":
        return paged_prefill_attention_plain(
            q, k_pages, v_pages, page_table, start, softmax_scale, k_scales, v_scales
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_prefill_attention runs on CUDA or CPU tensors, got {q.device}")
    _check_shapes(q, k_pages, v_pages, page_table, start, k_scales, v_scales)
    device = q.device
    check_cuda_tensor(q, "q", device)
    check_cuda_pages(q, k_pages, v_pages, k_scales, v_scales)
    check_cuda_tensor(page_table, "page_table", device, dtypes=(torch.int32,))
    check_cuda_tensor(start, "start", device, dtypes=(torch.int32,))
    num_rows, chunk, num_q_heads, head_dim = q.shape
    _, page_size, num_kv_heads, _ = k_pages.shape
    check_head_dim(head_dim, "prefill")
    lib = load_library()
    max_pages = page_table.shape[1]
    dtypes = (DTYPE_CODES[q.dtype], DTYPE_CODES[k_pages.dtype])
    if lib.dolo_paged_prefill_smem_bytes(head_dim, *dtypes, max_pages) > MAX_SHARED_BYTES:
        raise ValueError(f"a {max_pages}-page table row exceeds the prefill kernel's shared memory")
    out = torch.empty_like(q)
    code = lib.dolo_paged_prefill(
        ptr(q), ptr(k_pages), ptr(v_pages), ptr(k_scales), ptr(v_scales), ptr(page_table),
        ptr(start), ptr(out), num_rows, chunk, num_q_heads, num_kv_heads, head_dim, page_size,
        max_pages, float(softmax_scale), *dtypes, current_stream(device),
    )
    check_launch(code, KERNEL.name)
    KERNEL.launches += 1
    return out
