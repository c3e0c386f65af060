"""Fused QKV rotary embedding: the CUDA kernel's two forms and their plain versions.

Replaces the TPU kernel ``_rope_qkv_call`` (`dolomite_engine_tpu/ops/pallas/rope_qkv.py`).
Bound on the H100 by device-memory bytes; the kernel reads the flat ``[Q | K | V]``
projection once, rotates the Q and K heads a pair of half-head vectors a thread, copies V
bit for bit and writes once (see ``dolomite_engine_tpu_torch/csrc/rope_qkv.cu``).

- `fused_rope_qkv`, the flat form: the rotated tensor in the projection's layout. It is
  differentiable: the rotation's transpose is the same rotation with ``-sin``, so the
  backward launches the same kernel with its sign flag set (the plain version with the
  sine negated on the CPU), as the JAX package's custom vjp does.
- `rope_qkv_paged`, the serving form: the rotated query as a contiguous ``[B, S, Hq, D]``
  tensor (the paged attention kernels' layout), and the rotated K rows and the V rows
  written straight into a bf16 / fp32 paged pool through the page table, in the same
  launch; for a quantized pool, K and V come back as contiguous ``[B, S, Hkv, D]`` tensors
  for the fused scatter-quantize (`ops/attention.paged_scatter_kv_quantized`). Not
  differentiable: serving only.

Each launches its kernel for a CUDA tensor (or raises) and takes its plain version for a
CPU tensor.
"""

from __future__ import annotations

import torch

from ..attention import paged_scatter_kv, write_positions
from ..rope import rotate_half
from ._build import (
    DTYPE_CODES,
    ELEMENT_DTYPES,
    KernelSpec,
    check_cuda_tensor,
    check_launch,
    current_stream,
    load_library,
    ptr,
    window_args,
)

KERNEL = KernelSpec(
    name="rope_qkv",
    source="dolomite_engine_tpu_torch/csrc/rope_qkv.cu",
    replaces="dolomite_engine_tpu/ops/pallas/rope_qkv.py:75",
)


def _check_shapes(qkv, num_heads, num_kv_heads, head_dim):
    if qkv.ndim != 3 or qkv.shape[-1] != (num_heads + 2 * num_kv_heads) * head_dim:
        raise ValueError(
            f"qkv {tuple(qkv.shape)} is not [B, S, (Hq + 2 Hkv) * D] for Hq={num_heads}, "
            f"Hkv={num_kv_heads}, D={head_dim}"
        )
    if head_dim % 2:
        raise ValueError(f"rotary embedding needs an even head_dim, got {head_dim}")


def fused_rope_qkv_plain(
    qkv: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    num_heads: int,
    num_kv_heads: int,
    head_dim: int,
) -> torch.Tensor:
    """``x * cos + rotate_half(x) * sin`` on the Q and K heads of the flat fused tensor,
    V untouched, in the activation dtype (cos/sin cast to it first)."""
    _check_shapes(qkv, num_heads, num_kv_heads, head_dim)
    batch, seq, _ = qkv.shape
    heads = qkv.reshape(batch, seq, -1, head_dim)
    rope_heads = num_heads + num_kv_heads
    cos = cos.to(qkv.dtype).expand(batch, seq, head_dim)[:, :, None, :]
    sin = sin.to(qkv.dtype).expand(batch, seq, head_dim)[:, :, None, :]
    x = heads[:, :, :rope_heads]
    roped = x * cos + rotate_half(x) * sin
    return torch.cat([roped, heads[:, :, rope_heads:]], dim=2).reshape(batch, seq, -1)


def _cos_sin_layout(cos, sin, qkv, head_dim) -> tuple[int, int, int]:
    """(dtype code, batch stride, position stride) in elements of cos/sin read as
    ``[B, S, D]`` rows without a copy: each broadcast to the projection's ``[B, S, D]``,
    the two of one dtype and layout, the last dimension contiguous."""
    batch, seq = qkv.shape[:2]
    device = qkv.device
    views = []
    for name, table in (("cos", cos), ("sin", sin)):
        if table.device != device or table.dtype not in ELEMENT_DTYPES:
            raise ValueError(f"{name} must be fp32 or bf16 on {device}, got {table.dtype} on {table.device}")
        views.append(table.expand(batch, seq, head_dim))
    cos, sin = views
    if cos.dtype != sin.dtype or cos.stride() != sin.stride() or cos.stride(2) != 1:
        raise ValueError("cos and sin must share a dtype and strides, each position's row contiguous")
    return DTYPE_CODES[cos.dtype], cos.stride(0), cos.stride(1)


def _vector_width(head_dim, tensors, strides) -> int:
    """1 where the kernel may use 16-byte vectors: each head half a multiple of 8
    elements, every base 16-byte aligned, the cos/sin strides multiples of 8 elements."""
    return int(
        head_dim % 16 == 0
        and all(t is None or t.data_ptr() % 16 == 0 for t in tensors)
        and all(stride % 8 == 0 for stride in strides)
    )


def _rope_forward(qkv, cos, sin, num_heads, num_kv_heads, head_dim, negate=False):
    """One rotation (with -sin where `negate`): the kernel for a CUDA tensor, the plain
    version for a CPU tensor."""
    if qkv.device.type == "cpu":
        return fused_rope_qkv_plain(qkv, cos, -sin if negate else sin, num_heads, num_kv_heads, head_dim)
    if qkv.device.type != "cuda":
        raise ValueError(f"fused_rope_qkv runs on CUDA or CPU tensors, got {qkv.device}")
    _check_shapes(qkv, num_heads, num_kv_heads, head_dim)
    device = qkv.device
    check_cuda_tensor(qkv, "qkv", device)
    batch, seq, _ = qkv.shape
    cs_dtype, cs_batch, cs_seq = _cos_sin_layout(cos, sin, qkv, head_dim)
    out = torch.empty_like(qkv)
    code = load_library().dolo_rope_qkv(
        ptr(qkv), ptr(cos), ptr(sin), ptr(out), batch, seq, num_heads, num_kv_heads, head_dim,
        cs_batch, cs_seq, cs_dtype, int(negate),
        _vector_width(head_dim, (qkv, out, cos, sin), (cs_batch, cs_seq)),
        DTYPE_CODES[qkv.dtype], current_stream(device),
    )
    check_launch(code, KERNEL.name)
    KERNEL.launched("flat")
    return out


class _FusedRopeQKV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, cos, sin, num_heads, num_kv_heads, head_dim):
        ctx.save_for_backward(cos, sin)
        ctx.heads = (num_heads, num_kv_heads, head_dim)
        return _rope_forward(qkv, cos, sin, num_heads, num_kv_heads, head_dim)

    @staticmethod
    def backward(ctx, grad):
        # R(x) = x cos + rot(x) sin with rot^T = -rot, so R^T(g) = g cos + rot(g) (-sin)
        cos, sin = ctx.saved_tensors
        dqkv = _rope_forward(grad.contiguous(), cos, sin, *ctx.heads, negate=True)
        return dqkv, None, None, None, None, None


def fused_rope_qkv(
    qkv: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    num_heads: int,
    num_kv_heads: int,
    head_dim: int,
) -> torch.Tensor:
    """Rotate the Q and K head blocks of ``qkv [B, S, (Hq + 2 Hkv) * D]`` in one kernel,
    differentiably in `qkv`.

    cos/sin broadcast to ``[B, S, D]`` (the `get_cos_sin` output, batch 1 or B). Returns
    a new tensor of the same shape and dtype."""
    return _FusedRopeQKV.apply(qkv, cos, sin, num_heads, num_kv_heads, head_dim)


def rope_qkv_paged_plain(
    qkv: torch.Tensor,
    cos: torch.Tensor | None,
    sin: torch.Tensor | None,
    num_heads: int,
    num_kv_heads: int,
    head_dim: int,
    k_pool: torch.Tensor | None,
    v_pool: torch.Tensor | None,
    page_table: torch.Tensor,
    cache_index: torch.Tensor | int,
    key_mask: torch.Tensor | None = None,
    rope=fused_rope_qkv_plain,
):
    """The plain version of `rope_qkv_paged`, on any device: `rope` (by default
    `fused_rope_qkv_plain`; none without cos/sin), the split, then the plain scatter of K
    and V (`ops/attention.write_positions` and `paged_scatter_kv`) into the pools."""
    batch, seq = qkv.shape[:2]
    if cos is not None:
        qkv = rope(qkv, cos, sin, num_heads, num_kv_heads, head_dim)
    query, key, value = torch.split(
        qkv, [num_heads * head_dim, num_kv_heads * head_dim, num_kv_heads * head_dim], dim=-1
    )
    query = query.reshape(batch, seq, num_heads, head_dim).contiguous()
    key = key.reshape(batch, seq, num_kv_heads, head_dim)
    value = value.reshape(batch, seq, num_kv_heads, head_dim)
    if k_pool is None:
        return query, key.contiguous(), value.contiguous()
    view_len = page_table.shape[1] * k_pool.shape[1]
    positions, write_valid = write_positions(cache_index, key_mask, view_len, batch, seq, qkv.device)
    paged_scatter_kv(k_pool, key, page_table, positions, write_valid)
    paged_scatter_kv(v_pool, value, page_table, positions, write_valid)
    return query, None, None


def rope_qkv_paged(
    qkv: torch.Tensor,
    cos: torch.Tensor | None,
    sin: torch.Tensor | None,
    num_heads: int,
    num_kv_heads: int,
    head_dim: int,
    k_pool: torch.Tensor | None,
    v_pool: torch.Tensor | None,
    page_table: torch.Tensor,
    cache_index: torch.Tensor | int,
    key_mask: torch.Tensor | None = None,
):
    """Rotate ``qkv [B, S, (Hq + 2 Hkv) * D]`` (no rotation without cos/sin) and send each
    part where serving's paged attention reads it, in one launch. Returns ``(query [B, S,
    Hq, D] contiguous, None, None)`` after writing the K and V rows into `k_pool` /
    `v_pool` ``[num_pages, page_size, Hkv, D]`` (bf16 / fp32, cast on store) at the write
    window of `cache_index` and `key_mask` (`ops/attention.write_positions`), or, with
    `k_pool` None, ``(query, key, value)`` with K and V contiguous ``[B, S, Hkv, D]``.
    The window: ``page_table`` ``[B, max_pages]`` int32, `cache_index` a [B] or 0-d int32
    / int64 tensor or an int, `key_mask` None or ``[B, view]`` ints or bools."""
    if qkv.device.type == "cpu":
        return rope_qkv_paged_plain(
            qkv, cos, sin, num_heads, num_kv_heads, head_dim, k_pool, v_pool, page_table,
            cache_index, key_mask,
        )
    if qkv.device.type != "cuda":
        raise ValueError(f"rope_qkv_paged runs on CUDA or CPU tensors, got {qkv.device}")
    _check_shapes(qkv, num_heads, num_kv_heads, head_dim)
    device = qkv.device
    check_cuda_tensor(qkv, "qkv", device)
    batch, seq, _ = qkv.shape
    cs_dtype, cs_batch, cs_seq = 0, 0, 0
    if cos is not None:
        cs_dtype, cs_batch, cs_seq = _cos_sin_layout(cos, sin, qkv, head_dim)
    check_cuda_tensor(page_table, "page_table", device, dtypes=(torch.int32,))
    if page_table.ndim != 2 or page_table.shape[0] != batch:
        raise ValueError(f"page_table {tuple(page_table.shape)} is not [{batch}, max_pages]")
    query = torch.empty((batch, seq, num_heads, head_dim), dtype=qkv.dtype, device=device)
    max_pages = page_table.shape[1]
    if k_pool is None:  # K and V out for the fused scatter-quantize: no window here
        key, value = (
            torch.empty((batch, seq, num_kv_heads, head_dim), dtype=qkv.dtype, device=device) for _ in range(2)
        )
        k_dst, v_dst, page_size, pool_dtype = key, value, 1, qkv.dtype
        kind, index, stride, start, mask_kind, mask, mask_stride = 0, None, 0, 0, 0, None, 0
    else:
        key = value = None
        if k_pool.ndim != 4 or k_pool.shape[2:] != (num_kv_heads, head_dim) or v_pool.shape != k_pool.shape:
            raise ValueError(
                f"the pools {tuple(k_pool.shape)} / {tuple(v_pool.shape)} are not "
                f"[pages, page_size, {num_kv_heads}, {head_dim}]"
            )
        for name, pool in (("k_pool", k_pool), ("v_pool", v_pool)):
            check_cuda_tensor(pool, name, device)
        if v_pool.dtype != k_pool.dtype:
            raise ValueError("the K and V pools must share a dtype")
        k_dst, v_dst, page_size, pool_dtype = k_pool, v_pool, k_pool.shape[1], k_pool.dtype
        kind, index, stride, start, mask_kind, mask, mask_stride = window_args(
            cache_index, key_mask, batch, max_pages * page_size, device
        )
    vec = _vector_width(head_dim, (qkv, query, k_dst, v_dst, cos, sin), (cs_batch, cs_seq))
    code = load_library().dolo_rope_qkv_paged(
        ptr(qkv), ptr(cos), ptr(sin), ptr(query), ptr(k_dst), ptr(v_dst), ptr(page_table),
        ptr(index), ptr(mask), batch, seq, num_heads, num_kv_heads, head_dim, cs_batch, cs_seq,
        cs_dtype, int(k_pool is not None), page_size, max_pages, kind, stride, start, mask_kind,
        mask_stride, vec, DTYPE_CODES[qkv.dtype], DTYPE_CODES[pool_dtype], current_stream(device),
    )
    check_launch(code, KERNEL.name)
    KERNEL.launched("paged")
    return query, key, value
