"""T5-style bucketed relative attention bias (copy of `dolomite_engine_tpu/ops/relative_bias.py`).

The signed key-minus-query distance maps to one of ``num_buckets`` learned per-head scalars:
near distances get one bucket each, far ones share log-spaced buckets that saturate at
``max_distance``. A bidirectional stack (the encoder) splits the buckets between past and
future; a causal stack (the decoder) buckets only the past and sends every future distance
to bucket 0. The ``[num_buckets, num_heads]`` table is shared by every layer of a stack and
rides the attention's additive-bias slot, ``[1, heads, q_len, k_len]``: on the card a
flash call takes it as the kernel's query bias (`ops/kernels/flash_attention.py`), whose
gradient autograd carries back through the gather into the table.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def relative_position_bucket(
    relative_position: torch.Tensor, *, bidirectional: bool, num_buckets: int, max_distance: int
) -> torch.Tensor:
    """Map signed (key - query) distances to int64 bucket ids in [0, num_buckets)."""
    rp = relative_position
    if bidirectional:
        directional_buckets = num_buckets // 2
        offset = torch.where(rp > 0, directional_buckets, 0)
        distance = rp.abs()
    else:
        directional_buckets = num_buckets
        offset = torch.zeros_like(rp)
        distance = (-rp).clamp_min(0)  # future distances (the causal mask removes them) to 0

    exact = directional_buckets // 2
    # distances past `exact` share log-spaced buckets that saturate at max_distance
    log_scale = (directional_buckets - exact) / math.log(max_distance / exact)
    scaled = torch.log(distance.clamp_min(1).float() / exact) * log_scale
    log_bucket = (exact + scaled.to(torch.int32)).clamp_max(directional_buckets - 1)
    return (offset + torch.where(distance < exact, distance, log_bucket)).long()


class RelativePositionBias(nn.Module):
    """The learned ``[num_buckets, num_heads]`` fp32 table (flax name ``embedding``) and its
    gather into the additive bias ``[1, heads, q_len, k_len]`` in the compute `dtype`. One
    instance per stack."""

    def __init__(
        self,
        num_heads: int,
        num_buckets: int = 32,
        max_distance: int = 128,
        bidirectional: bool = True,
        std: float = 0.02,
        dtype: torch.dtype = torch.float32,
        device: torch.device | str = "cpu",
    ) -> None:
        super().__init__()
        self.dtype = dtype
        self.num_buckets = num_buckets
        self.max_distance = max_distance
        self.bidirectional = bidirectional
        self.std = std
        self.weight = nn.Parameter(torch.empty(num_buckets, num_heads, dtype=torch.float32, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.weight.normal_(0.0, self.std, generator=generator)

    def forward(self, q_len: int, k_len: int, query_offset: int | torch.Tensor = 0) -> torch.Tensor:
        device = self.weight.device
        q_pos = torch.as_tensor(query_offset, device=device) + torch.arange(q_len, device=device)[:, None]
        k_pos = torch.arange(k_len, device=device)[None, :]
        buckets = relative_position_bucket(
            k_pos - q_pos,
            bidirectional=self.bidirectional,
            num_buckets=self.num_buckets,
            max_distance=self.max_distance,
        )
        # the JAX module gathers from the table cast to the compute dtype: the same values
        # as casting after the gather, which keeps the gradient's scatter-add in fp32
        return self.weight[buckets].to(self.dtype).permute(2, 0, 1)[None]  # [1, heads, q, k]
