"""Fused RMSNorm (+ residual add): the CUDA kernel and its plain version.

Replaces the TPU kernel ``_rmsnorm_fwd_call`` (`dolomite_engine_tpu/ops/pallas/rmsnorm.py`).
What bounds it on the H100 and how the kernel is laid out: see
``dolomite_engine_tpu_torch/csrc/rmsnorm.cu``. In short it is bound by device-memory
bytes, and one block per row keeps the summed row in shared memory so each byte moves
once.

`fused_rmsnorm` launches the kernel for a CUDA tensor (or raises) and takes the plain
version for a CPU tensor. It is differentiable: the backward is the plain PyTorch
transcription of the JAX package's `_rmsnorm_grads` (the TPU side has no backward kernel
either), plus the residual-stream rule of its residual form.
"""

from __future__ import annotations

import torch

from ..normalization import rmsnorm
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

KERNEL = KernelSpec(
    name="rmsnorm",
    source="dolomite_engine_tpu_torch/csrc/rmsnorm.cu",
    replaces="dolomite_engine_tpu/ops/pallas/rmsnorm.py:66",
)


def fused_rmsnorm_plain(
    x: torch.Tensor, weight: torch.Tensor, eps: float, residual: torch.Tensor | None = None
):
    """``rmsnorm(x + residual) * weight`` in plain PyTorch; returns ``(normed, x +
    residual)`` when `residual` is given, else the normed activations."""
    if residual is None:
        return rmsnorm(x, weight, eps)
    stream = x + residual
    return rmsnorm(stream, weight, eps), stream


def _rmsnorm_forward(
    x: torch.Tensor, weight: torch.Tensor, eps: float, residual: torch.Tensor | None = None
):
    """The forward pass alone: the kernel for a CUDA tensor, the plain version for a CPU
    tensor."""
    if weight.shape != x.shape[-1:]:
        raise ValueError(f"weight {tuple(weight.shape)} must match hidden dim {x.shape[-1]}")
    if residual is not None and (residual.shape != x.shape or residual.dtype != x.dtype):
        raise ValueError("residual must match x in shape and dtype")
    if x.device.type == "cpu":
        return fused_rmsnorm_plain(x, weight, eps, residual)
    if x.device.type != "cuda":
        raise ValueError(f"fused_rmsnorm runs on CUDA or CPU tensors, got {x.device}")

    device = x.device
    check_cuda_tensor(x, "x", device)
    check_cuda_tensor(weight, "weight", device, dtypes=(torch.float32,))
    if residual is not None:
        check_cuda_tensor(residual, "residual", device)
    dim = x.shape[-1]
    if (dim + 32) * 4 > MAX_SHARED_BYTES:
        raise ValueError(f"hidden dim {dim} exceeds the kernel's shared-memory row buffer")
    rows = x.numel() // dim
    out = torch.empty_like(x)
    stream_out = torch.empty_like(x) if residual is not None else None
    code = load_library().dolo_rmsnorm(
        ptr(x), ptr(residual), ptr(weight), ptr(out), ptr(stream_out),
        rows, dim, float(eps), DTYPE_CODES[x.dtype], current_stream(device),
    )
    check_launch(code, KERNEL.name)
    KERNEL.launches += 1
    return out if residual is None else (out, stream_out)


def rmsnorm_grads(s: torch.Tensor, weight: torch.Tensor, eps: float, dy: torch.Tensor):
    """(ds, dweight) of ``cast(s32 * rsqrt(mean(s32^2) + eps)) * weight`` for the
    cotangent `dy`, in fp32 (the cast passes gradients through as identity)."""
    s32 = s.float()
    inv = torch.rsqrt(s32.square().mean(dim=-1, keepdim=True) + eps)
    xhat = s32 * inv
    dy32 = dy.float()
    dxhat = dy32 * weight.float()
    dweight = (dy32 * xhat).sum(dim=tuple(range(s.ndim - 1))).to(weight.dtype)
    ds = inv * (dxhat - xhat * (dxhat * xhat).mean(dim=-1, keepdim=True))
    return ds.to(s.dtype), dweight


class _FusedRMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return _rmsnorm_forward(x, weight, eps)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dx, dweight = rmsnorm_grads(x, weight, ctx.eps, dy)
        return dx, dweight, None


class _FusedRMSNormResidual(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, residual, weight, eps):
        out, stream = _rmsnorm_forward(x, weight, eps, residual)
        ctx.save_for_backward(stream, weight)
        ctx.eps = eps
        return out, stream

    @staticmethod
    def backward(ctx, dy, dstream):
        stream, weight = ctx.saved_tensors
        ds, dweight = rmsnorm_grads(stream, weight, ctx.eps, dy)
        ds = ds + dstream.to(ds.dtype)  # the returned stream feeds the next residual add
        return ds, ds, dweight, None


def fused_rmsnorm(
    x: torch.Tensor, weight: torch.Tensor, eps: float, residual: torch.Tensor | None = None
):
    """``rmsnorm(x + residual) * weight`` in one kernel, differentiable.

    Without `residual`: the normalized activations. With it: ``(normed, x + residual)``
    — the block threads the second output on as its new residual stream. `weight` is the
    fp32 norm parameter ``[d]``; x (and residual) are ``[..., d]`` fp32 or bf16."""
    if residual is None:
        return _FusedRMSNorm.apply(x, weight, eps)
    return _FusedRMSNormResidual.apply(x, residual, weight, eps)
