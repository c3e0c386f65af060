"""Pretraining wrapper: the model's loss over ``seq_len + 1`` token windows.

Counterpart of `dolomite_engine_tpu/model_wrapper/pretraining.py`: a batch is ``text
[B, S + 1]``, split into inputs ``text[:, :-1]`` and labels ``text[:, 1:]``; with
`reset_attention_mask` the documents packed into a row (separated by EOS) get their own
segment ids, a label that crosses a document boundary is ignored, and with
`reset_position_ids` positions restart at each document. The wrapper owns the port's
model directly (no flax variables, no apply scope). The config's ``model_type`` picks the
model class through `models.config_from_dict` / `get_model_class`, as in the JAX
package; the model's loss already includes a family's auxiliary loss (MoE router
load balancing), so the wrapper adds nothing to it.
"""

from __future__ import annotations

import torch

from ..enums import AttentionImplementation
from ..models import CommonConfig, config_from_dict, get_model_class
from ..ops.loss import IGNORE_INDEX
from ..ops.packing import segment_ids_from_eos
from ..train_utils import resolve_checkpointing_args
from ..utils.mixed_precision import string_to_dtype


class ModelWrapperForPretraining:
    def __init__(
        self,
        pretrained_config: dict | CommonConfig,
        dtype: str | torch.dtype = "fp32",
        param_dtype: str | torch.dtype = "fp32",
        attention_implementation: AttentionImplementation | str | None = None,
        gradient_checkpointing_args: dict | None = None,
        reset_attention_mask: bool = False,
        reset_position_ids: bool = False,
        device: str | torch.device = "cuda",
        seed: int = 0,
    ) -> None:
        self.config = (
            pretrained_config
            if isinstance(pretrained_config, CommonConfig)
            else config_from_dict(pretrained_config)
        )
        self.dtype = string_to_dtype(dtype)
        self.tokenizer = None  # optional: pretraining reads token ids (`get_model` loads one)
        self.reset_attention_mask = reset_attention_mask
        self.reset_position_ids = reset_position_ids
        self.checkpoint_every, self.checkpoint_policy = resolve_checkpointing_args(
            None, gradient_checkpointing_args
        )
        self.model = get_model_class(self.config.model_type)(
            self.config,
            dtype=self.dtype,
            device=device,
            seed=seed,
            param_dtype=string_to_dtype(param_dtype),
            attention_implementation=attention_implementation or AttentionImplementation.sdpa,
            checkpoint_every=self.checkpoint_every,
            checkpoint_policy=self.checkpoint_policy,
        )

    def prepare_inputs_and_labels(self, text: torch.Tensor) -> dict:
        """text ``[B, S + 1]`` -> model inputs and shifted labels."""
        input_ids = text[:, :-1]
        labels = text[:, 1:]
        segment_ids = None
        position_ids = None
        eos = self.config.eos_token_id
        if self.reset_attention_mask:
            segment_ids, reset_positions = segment_ids_from_eos(input_ids, eos)
            if self.reset_position_ids:
                position_ids = reset_positions
            # a label that crosses a document boundary is invalid
            next_segment, _ = segment_ids_from_eos(text, eos)
            labels = torch.where(next_segment[:, 1:] == segment_ids, labels, IGNORE_INDEX)
        elif self.reset_position_ids:
            _, position_ids = segment_ids_from_eos(input_ids, eos)
        return {
            "input_ids": input_ids,
            "labels": labels,
            "position_ids": position_ids,
            "segment_ids": segment_ids,
        }

    def loss(self, text: torch.Tensor, train: bool = True) -> torch.Tensor:
        """The scalar LM loss of one micro-batch (dropout on when `train`)."""
        batch = self.prepare_inputs_and_labels(text.to(self.model.device))
        return self.model(**batch, deterministic=not train).loss
