"""dtype names <-> torch dtypes (counterpart of `dolomite_engine_tpu/utils/mixed_precision.py`)."""

from __future__ import annotations

import torch

_STR_TO_DTYPE = {
    "fp32": torch.float32,
    "float32": torch.float32,
    "fp16": torch.float16,
    "float16": torch.float16,
    "bf16": torch.bfloat16,
    "bfloat16": torch.bfloat16,
    "fp8": torch.float8_e4m3fn,
}


def string_to_dtype(dtype: str | torch.dtype | None) -> torch.dtype | None:
    """A repo dtype name ("fp32", "bf16", ...) or a torch dtype as a torch dtype; "fp8" is
    e4m3, as in the JAX package (a model wrapper reads it as bf16 compute with fp8 dots)."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if dtype not in _STR_TO_DTYPE:
        raise ValueError(f"unexpected dtype '{dtype}'")
    return _STR_TO_DTYPE[dtype]


# the canonical name of each spelling, as `normalize_dtype_string` in the JAX package
_CANONICAL = {
    "fp32": "fp32", "float32": "fp32", "fp16": "fp16", "float16": "fp16",
    "bf16": "bf16", "bfloat16": "bf16", "fp8": "fp8",
}


def normalize_dtype_string(dtype: str) -> str:
    """"bfloat16" -> "bf16" and so on; "fp8" stays "fp8"."""
    if dtype not in _CANONICAL:
        raise ValueError(f"unexpected dtype '{dtype}'")
    return _CANONICAL[dtype]
