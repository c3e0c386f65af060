"""Ragged paged-attention decode: the CUDA kernel and its plain version.

Replaces the TPU kernel ``paged_decode_attention``
(`dolomite_engine_tpu/ops/pallas/paged_attention.py`). Bound on the H100 by
device-memory bytes: each slot's resident K/V is read once per step. The kernel splits
each slot's keys into spans of 256 positions, one block per (span, kv head, slot) for
all query rows of the kv head's GQA group (so K/V is read once per group), stages the
pages through a cp.async ring with 16-byte loads, keeps an online-softmax partial per
split and merges the splits in a fixed order in the same launch (the last split of a
group to finish merges; see ``dolomite_engine_tpu_torch/csrc/paged_attention.cu``).
Probabilities are rounded to the query's dtype per split, before they are normalised.
Pages may be in the query's dtype, in bf16 under an fp32 query, or int8 / fp8 codes with
their ``[P, Hkv]`` fp32 scale pools, dequantized in the page walk (a quantized pool,
`serving/kv_cache`).

`paged_decode_attention` launches the kernel for CUDA tensors (or raises) and takes the
plain version for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..attention import eager_attention, make_attention_mask, paged_gather_kv, paged_gather_kv_dequant
from ..kv_quant import is_quantized
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
    name="paged_decode_attention",
    source="dolomite_engine_tpu_torch/csrc/paged_attention.cu",
    replaces="dolomite_engine_tpu/ops/pallas/paged_attention.py:135",
)


def _check_shapes(q, k_pages, v_pages, page_table, lengths, k_scales, v_scales):
    if q.ndim != 4 or k_pages.ndim != 4 or k_pages.shape != v_pages.shape:
        raise ValueError("q must be [S, W, Hq, D] and k/v pages [P, page_size, Hkv, D]")
    num_slots, _, num_q_heads, head_dim = q.shape
    num_kv_heads = k_pages.shape[2]
    if k_pages.shape[3] != head_dim or num_q_heads % num_kv_heads:
        raise ValueError(f"q {tuple(q.shape)} does not match pages {tuple(k_pages.shape)}")
    if page_table.shape[0] != num_slots or lengths.shape != (num_slots,):
        raise ValueError("page_table must be [S, max_pages] and lengths [S]")
    check_page_types(k_pages, v_pages, k_scales, v_scales)


def check_page_types(k_pages, v_pages, k_scales, v_scales) -> None:
    """Quantized pages come with both ``[P, Hkv]`` scale pools, other pages with none."""
    if k_pages.dtype != v_pages.dtype:
        raise ValueError(f"k pages are {k_pages.dtype} and v pages {v_pages.dtype}")
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales come as a pair")
    if is_quantized(k_pages.dtype) != (k_scales is not None):
        raise ValueError(f"{k_pages.dtype} pages need scale pools exactly when they hold quantized codes")
    if k_scales is not None:
        shape = tuple(k_pages.shape[:1]) + tuple(k_pages.shape[2:3])
        if tuple(k_scales.shape) != shape or tuple(v_scales.shape) != shape:
            raise ValueError(f"scale pools must be {shape}")


def gather_pages(pages, scales, page_table, dtype) -> torch.Tensor:
    """Each row's ``[B, max_pages * page_size, H, D]`` page view in ``dtype``: dequantized
    with the scale pool for quantized pages, cast for others."""
    if scales is not None:
        return paged_gather_kv_dequant(pages, scales, page_table, dtype)
    return paged_gather_kv(pages, page_table).to(dtype)


def paged_decode_attention_plain(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    softmax_scale: float,
    k_scales: torch.Tensor | None = None,
    v_scales: torch.Tensor | None = None,
) -> torch.Tensor:
    """Gather each slot's page view (dequantized to the query's dtype for a quantized
    pool, as the Pallas kernel rounds it), mask the per-row frontier (query j of slot b
    sees positions <= lengths[b] + j) and run eager fp32-softmax attention."""
    _check_shapes(q, k_pages, v_pages, page_table, lengths, k_scales, v_scales)
    num_slots, width = q.shape[:2]
    view_len = page_table.shape[1] * k_pages.shape[1]
    positions = torch.arange(view_len, device=q.device)
    valid = positions[None, :] < (lengths.to(q.device)[:, None] + width)
    mask = make_attention_mask(
        num_slots, width, view_len, causal=True, attention_mask=valid, query_offset=lengths
    )
    return eager_attention(
        q, gather_pages(k_pages, k_scales, page_table, q.dtype),
        gather_pages(v_pages, v_scales, page_table, q.dtype), mask, softmax_scale,
    )


def check_cuda_pages(q, k_pages, v_pages, k_scales, v_scales) -> None:
    """The page types the attention kernels read under a query of q's dtype: its own,
    bf16, or int8 / fp8 codes together with both fp32 scale pools."""
    device = q.device
    page_dtypes = (q.dtype, torch.bfloat16, torch.int8, torch.float8_e4m3fn)
    for name, tensor in (("k_pages", k_pages), ("v_pages", v_pages)):
        check_cuda_tensor(tensor, name, device, dtypes=page_dtypes)
    for name, tensor in (("k_scales", k_scales), ("v_scales", v_scales)):
        if tensor is not None:
            check_cuda_tensor(tensor, name, device, dtypes=(torch.float32,))


# head dims the CUDA kernels (decode and prefill) are built for
HEAD_DIMS = (16, 64, 80, 128)


@functools.lru_cache(maxsize=64)
def _plan(num_q_heads: int, num_kv_heads: int, width: int, view_len: int) -> tuple[int, int, int]:
    """(query groups per kv head, most key splits of a slot, query rows per group) of one
    decode launch, as ``csrc/paged_attention.cu`` cuts it."""
    plan = (ctypes.c_int * 3)()
    load_library().dolo_paged_decode_plan(num_q_heads, num_kv_heads, width, view_len, plan)
    return tuple(plan)


# per device: the split-merge counters (zero between launches: the merging block resets
# its own) and the split partials' scratch, grown on demand
_SCRATCH: dict[torch.device, tuple[torch.Tensor, torch.Tensor]] = {}


def _scratch(device: torch.device, groups: int, floats: int) -> tuple[torch.Tensor, torch.Tensor]:
    counters, partials = _SCRATCH.get(device, (None, None))
    if counters is None or counters.numel() < groups:
        counters = torch.zeros(groups, dtype=torch.int32, device=device)
    if partials is None or partials.numel() < floats:
        partials = torch.empty(floats, dtype=torch.float32, device=device)
    _SCRATCH[device] = (counters, partials)
    return counters, partials


def check_head_dim(head_dim: int, kernel: str) -> None:
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"head_dim {head_dim} is not one of the {kernel} kernel's {HEAD_DIMS}")


def paged_decode_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    softmax_scale: float,
    k_scales: torch.Tensor | None = None,
    v_scales: torch.Tensor | None = None,
) -> torch.Tensor:
    """Attention for the paged decode/verify step straight off the page table.

    q ``[S, W, Hq, D]``; pages ``[P, page_size, Hkv, D]`` in q's dtype or bf16, or int8 /
    fp8 codes with ``k_scales`` / ``v_scales`` ``[P, Hkv]`` fp32; page_table ``[S,
    max_pages]`` int32; lengths ``[S]`` int32 (the pre-write frontier). Returns ``[S, W,
    Hq, D]``. On the card, launches on one device run on one stream at a time: they share
    that device's split counters and scratch."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, k_pages, v_pages, page_table, lengths, softmax_scale, k_scales, v_scales
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention runs on CUDA or CPU tensors, got {q.device}")
    _check_shapes(q, k_pages, v_pages, page_table, lengths, k_scales, v_scales)
    device = q.device
    check_cuda_tensor(q, "q", device)
    check_cuda_pages(q, k_pages, v_pages, k_scales, v_scales)
    check_cuda_tensor(page_table, "page_table", device, dtypes=(torch.int32,))
    check_cuda_tensor(lengths, "lengths", device, dtypes=(torch.int32,))
    num_slots, width, num_q_heads, head_dim = q.shape
    _, page_size, num_kv_heads, _ = k_pages.shape
    max_pages = page_table.shape[1]
    check_head_dim(head_dim, "decode")
    query_groups, max_splits, rows = _plan(num_q_heads, num_kv_heads, width, max_pages * page_size)
    groups = num_slots * num_kv_heads * query_groups
    outputs = groups * max_splits * rows * head_dim
    counters, partials = _scratch(device, groups, outputs + groups * max_splits * rows * 2)
    out = torch.empty_like(q)
    code = load_library().dolo_paged_decode(
        ptr(q), ptr(k_pages), ptr(v_pages), ptr(k_scales), ptr(v_scales), ptr(page_table),
        ptr(lengths), ptr(out), ptr(partials), ctypes.c_void_p(partials.data_ptr() + 4 * outputs),
        ptr(counters), num_slots, width, num_q_heads, num_kv_heads, head_dim, page_size,
        max_pages, float(softmax_scale), DTYPE_CODES[q.dtype], DTYPE_CODES[k_pages.dtype],
        current_stream(device),
    )
    check_launch(code, KERNEL.name)
    KERNEL.launches += 1
    return out
