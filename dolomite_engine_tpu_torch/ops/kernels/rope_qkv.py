"""Fused QKV rotary embedding: the CUDA kernel and its plain version.

Replaces the TPU kernel ``_rope_qkv_call`` (`dolomite_engine_tpu/ops/pallas/rope_qkv.py`).
Bound on the H100 by device-memory bytes; the kernel reads the flat ``[Q | K | V]``
projection once, rotates the Q and K heads, copies V bit for bit and writes once (see
``dolomite_engine_tpu_torch/csrc/rope_qkv.cu``).

`fused_rope_qkv` launches the kernel for a CUDA tensor (or raises) and takes the plain
version for a CPU tensor. It is differentiable: the rotation's transpose is the same
rotation with ``-sin``, so the backward launches the same kernel (the plain version on
the CPU) with the sine negated, as the JAX package's custom vjp does.
"""

from __future__ import annotations

import torch

from ..rope import rotate_half
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


def _rope_forward(qkv, cos, sin, num_heads, num_kv_heads, head_dim):
    """One rotation: the kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if qkv.device.type == "cpu":
        return fused_rope_qkv_plain(qkv, cos, sin, num_heads, num_kv_heads, head_dim)
    if qkv.device.type != "cuda":
        raise ValueError(f"fused_rope_qkv runs on CUDA or CPU tensors, got {qkv.device}")
    _check_shapes(qkv, num_heads, num_kv_heads, head_dim)
    device = qkv.device
    check_cuda_tensor(qkv, "qkv", device)
    batch, seq, width = qkv.shape
    # the TPU kernel casts cos/sin to the activation dtype before use, then broadcasts
    cos = cos.to(qkv.dtype).expand(batch, seq, head_dim).contiguous()
    sin = sin.to(qkv.dtype).expand(batch, seq, head_dim).contiguous()
    check_cuda_tensor(cos, "cos", device)
    check_cuda_tensor(sin, "sin", device)
    out = torch.empty_like(qkv)
    code = load_library().dolo_rope_qkv(
        ptr(qkv), ptr(cos), ptr(sin), ptr(out),
        batch * seq, width, head_dim, (num_heads + num_kv_heads) * head_dim,
        DTYPE_CODES[qkv.dtype], current_stream(device),
    )
    check_launch(code, KERNEL.name)
    KERNEL.launches += 1
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
        dqkv = _rope_forward(grad.contiguous(), cos, -sin, *ctx.heads)
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
