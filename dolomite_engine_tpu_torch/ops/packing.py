"""Packed-document bookkeeping: segment ids and reset positions from EOS tokens.

Counterpart of the traced `segment_ids_from_eos_jnp` (`dolomite_engine_tpu/model_wrapper/
pretraining.py`): a document segment starts after each EOS, segments count from 1, and
position ids restart at 0 at every segment start.
"""

from __future__ import annotations

import torch


def segment_ids_from_eos(tokens: torch.Tensor, eos_token_id: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(segment_ids, position_ids), both int32 ``[B, S]``, for ``tokens [B, S]``."""
    is_eos = tokens == eos_token_id
    starts = torch.cat([torch.zeros_like(is_eos[:, :1]), is_eos[:, :-1]], dim=1)
    segment_ids = torch.cumsum(starts.to(torch.int32), dim=1, dtype=torch.int32) + 1
    idx = torch.arange(tokens.shape[1], dtype=torch.int32, device=tokens.device)[None, :]
    start_idx = torch.cummax(torch.where(starts, idx, torch.zeros_like(idx)), dim=1).values
    return segment_ids, idx - start_idx
