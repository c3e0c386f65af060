"""Rotary position embeddings with YaRN scaling, functional.

Counterpart of `dolomite_engine_tpu/ops/rope.py`: the non-interleaved rotate-half layout
(frequencies concatenated, not interleaved) and YaRN's interpolation/extrapolation blend
with its ``0.1 * ln(scale) + 1`` magnitude correction. The inverse frequencies are
computed once on the host in float32 exactly as the JAX package computes them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class RoPEParams:
    """Rotary parameters derived from the config."""

    inv_freq: np.ndarray  # [head_dim // 2], float32
    mscale: float

    @staticmethod
    def from_config(
        head_dim: int,
        base: float = 10000,
        rope_scaling: dict | None = None,
        max_position_embeddings: int = 2048,
    ) -> "RoPEParams":
        dim_range = np.arange(0, head_dim, 2, dtype=np.float32) / head_dim
        pos_freqs = base**dim_range

        if rope_scaling is None:
            return RoPEParams(inv_freq=1.0 / pos_freqs, mscale=1.0)

        scaling_type = rope_scaling.get("type", "yarn")
        if scaling_type != "yarn":
            raise ValueError(f"unexpected rope_scaling type '{scaling_type}'")

        scale = rope_scaling.get("factor", 1.0)
        original_max = rope_scaling.get(
            "original_max_position_embeddings", max_position_embeddings
        )
        extrapolation_factor = rope_scaling.get("extrapolation_factor", 1.0)
        attn_factor = rope_scaling.get("attn_factor", 1.0)
        beta_fast = rope_scaling.get("beta_fast", 32)
        beta_slow = rope_scaling.get("beta_slow", 1)

        inv_freq_extrapolation = 1.0 / pos_freqs
        inv_freq_interpolation = 1.0 / (scale * pos_freqs)

        low, high = _yarn_correction_range(beta_fast, beta_slow, head_dim, base, original_max)
        # ramp 0 -> 1 over [low, high]; mask = fraction of EXTRApolation per frequency dim
        inv_freq_mask = (1.0 - _linear_ramp(low, high, head_dim // 2)) * extrapolation_factor
        inv_freq = (
            inv_freq_interpolation * (1.0 - inv_freq_mask) + inv_freq_extrapolation * inv_freq_mask
        )

        mscale = _yarn_get_mscale(scale) * attn_factor
        return RoPEParams(inv_freq=inv_freq.astype(np.float32), mscale=float(mscale))


def get_cos_sin(
    rope: RoPEParams, position_ids: torch.Tensor, dtype: torch.dtype = torch.float32
) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin of shape [..., seq, head_dim] for the given position ids [..., seq]."""
    inv_freq = torch.from_numpy(np.asarray(rope.inv_freq, np.float32)).to(position_ids.device)
    freqs = position_ids[..., None].float() * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return (emb.cos() * rope.mscale).to(dtype), (emb.sin() * rope.mscale).to(dtype)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rotary_pos_emb(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; cos/sin: [..., seq, head_dim] (broadcast over heads)."""
    cos = cos[..., :, None, :]
    sin = sin[..., :, None, :]
    return (x * cos) + (rotate_half(x) * sin)


def split_qkv_apply_rope(
    qkv: torch.Tensor,
    num_heads: int,
    num_kv_heads: int,
    head_dim: int,
    rope_cos_sin: tuple[torch.Tensor, torch.Tensor] | None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Split the flat fused ``[Q | K | V]`` projection and rotate Q and K.

    The rope + QKV call site of every attention call but serving's two paged-kernel
    branches (which rotate and write K/V in one launch, `ops/kernels/rope_qkv.
    rope_qkv_paged`): the rotation runs through `ops/kernels/rope_qkv.fused_rope_qkv` (the
    CUDA kernel for a CUDA tensor, its plain version for a CPU tensor), then the split is
    a view.

    qkv: [B, S, (num_heads + 2 * num_kv_heads) * head_dim]; rope_cos_sin from
    `get_cos_sin` or None (split only). Returns (query [B, S, Hq, D], key [B, S, Hkv, D],
    value [B, S, Hkv, D]).
    """
    from .kernels.rope_qkv import fused_rope_qkv

    batch, seq = qkv.shape[:2]
    if rope_cos_sin is not None:
        qkv = fused_rope_qkv(
            qkv, rope_cos_sin[0], rope_cos_sin[1], num_heads, num_kv_heads, head_dim
        )
    query, key, value = torch.split(
        qkv, [num_heads * head_dim, num_kv_heads * head_dim, num_kv_heads * head_dim], dim=-1
    )
    query = query.reshape(batch, seq, num_heads, head_dim)
    key = key.reshape(batch, seq, num_kv_heads, head_dim)
    value = value.reshape(batch, seq, num_kv_heads, head_dim)
    return query, key, value


def _yarn_correction_dim(
    num_rotations: float, dim: int, base: float, max_position_embeddings: int
) -> float:
    return (dim * math.log(max_position_embeddings / (num_rotations * 2 * math.pi))) / (
        2 * math.log(base)
    )


def _yarn_correction_range(
    low_rot: float, high_rot: float, dim: int, base: float, max_position_embeddings: int
) -> tuple[int, int]:
    low = math.floor(_yarn_correction_dim(low_rot, dim, base, max_position_embeddings))
    high = math.ceil(_yarn_correction_dim(high_rot, dim, base, max_position_embeddings))
    return max(low, 0), min(high, dim - 1)


def _linear_ramp(low: float, high: float, dim: int) -> np.ndarray:
    if low == high:
        high += 0.001
    ramp = (np.arange(dim, dtype=np.float32) - low) / (high - low)
    return np.clip(ramp, 0.0, 1.0)


def _yarn_get_mscale(scale: float) -> float:
    if scale <= 1:
        return 1.0
    return 0.1 * math.log(scale) + 1.0
