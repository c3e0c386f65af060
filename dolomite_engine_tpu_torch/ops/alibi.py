"""ALiBi linear attention biases.

Counterpart of `dolomite_engine_tpu/ops/alibi.py`: the geometric slope schedule with the
non-power-of-2 head-count extension, and the bias ``slope * key position`` with key
positions from the attention mask's cumsum, so a left-padded row's first real token is
at position 0.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def get_alibi_slopes(num_heads: int) -> np.ndarray:
    """[num_heads] float32 slopes."""
    closest_power_of_2 = 2 ** math.floor(math.log2(num_heads))
    base = 2.0 ** (-(2.0 ** -(math.log2(closest_power_of_2) - 3)))
    powers = np.arange(1, 1 + closest_power_of_2, dtype=np.float32)
    slopes = np.power(base, powers)

    if closest_power_of_2 != num_heads:
        extra_base = 2.0 ** (-(2.0 ** -(math.log2(2 * closest_power_of_2) - 3)))
        num_remaining = min(closest_power_of_2, num_heads - closest_power_of_2)
        extra_powers = np.arange(1, 1 + 2 * num_remaining, 2, dtype=np.float32)
        slopes = np.concatenate([slopes, np.power(extra_base, extra_powers)])

    return slopes.astype(np.float32)


def get_alibi_bias(
    num_heads: int,
    attention_mask: torch.Tensor | None,
    batch_size: int,
    key_length: int,
    device: torch.device | str | None = None,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Bias ``[batch, num_heads, 1, key_length]`` added to the scaled attention scores,
    on `device` (the mask's device when a mask is given). With a ``[batch, keys]`` mask
    the key positions are its cumsum less one, and 0 at masked keys."""
    if attention_mask is not None:
        device = attention_mask.device
    slopes = torch.from_numpy(get_alibi_slopes(num_heads)).to(device)
    if attention_mask is None:
        key_positions = torch.arange(key_length, dtype=torch.float32, device=device)
        key_positions = key_positions[None, :].expand(batch_size, key_length)
    else:
        cumsum = torch.cumsum(attention_mask.to(torch.float32), dim=-1) - 1.0
        key_positions = torch.where(attention_mask == 0, torch.zeros_like(cumsum), cumsum)
    bias = slopes[None, :, None, None] * key_positions[:, None, None, :]
    return bias.to(dtype)
