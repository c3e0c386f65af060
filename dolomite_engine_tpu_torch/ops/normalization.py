"""LayerNorm / RMSNorm, functional, with fp32 statistics.

Counterpart of `dolomite_engine_tpu/ops/normalization.py`: the same cast order, so fp32
results agree with the JAX package to rounding and bf16 results round where it rounds.
"""

from __future__ import annotations

import torch

_NORM_FUNCTIONS = ("layernorm", "rmsnorm")


def check_normalization_function(name: str) -> None:
    if name not in _NORM_FUNCTIONS:
        raise ValueError(f"unexpected normalization function '{name}'")


def rmsnorm(x: torch.Tensor, weight: torch.Tensor | None, eps: float) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    variance = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(variance + eps)
    if weight is not None:
        x = x.to(dtype) * weight.to(dtype)
    return x.to(dtype)


def layernorm(
    x: torch.Tensor, weight: torch.Tensor | None, bias: torch.Tensor | None, eps: float
) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    x = (x - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        x = x * weight.float()
    if bias is not None:
        x = x + bias.float()
    return x.to(dtype)
