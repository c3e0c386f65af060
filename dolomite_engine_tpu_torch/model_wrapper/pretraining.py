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

`ModelWrapperForFinetuning` is the finetuning wrapper: the loss of collated
instruction batches, padded or packed.
"""

from __future__ import annotations

import torch

from ..enums import Mode
from ..models import CommonConfig
from ..ops.loss import IGNORE_INDEX
from ..ops.packing import segment_ids_from_eos
from .base import ModelWrapper


class ModelWrapperForPretraining(ModelWrapper):
    """`ModelWrapper` for training by default (``mode`` training, fp32 master weights)."""

    def __init__(
        self,
        pretrained_config: dict | CommonConfig,
        reset_attention_mask: bool = False,
        reset_position_ids: bool = False,
        *,
        mode: Mode = Mode.training,
        param_dtype: str | torch.dtype = "fp32",
        **kwargs,
    ) -> None:
        self.reset_attention_mask = reset_attention_mask
        self.reset_position_ids = reset_position_ids
        super().__init__(pretrained_config, mode=mode, param_dtype=param_dtype, **kwargs)

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


class ModelWrapperForFinetuning(ModelWrapper):
    """The finetuning wrapper (the JAX package's): the loss of a collated finetuning
    batch, through the model's own labels path. A padded batch carries ``input_ids``,
    ``attention_mask`` and the shifted ``labels``; a packed (padding-free) one
    ``position_ids`` and ``segment_ids`` in place of the mask. Training by default, with
    fp32 master weights; another mode stores the weights in the compute dtype."""

    def __init__(
        self,
        pretrained_config: dict | CommonConfig | None,
        neft_alpha: float | None = None,
        *,
        mode: Mode = Mode.training,
        **kwargs,
    ) -> None:
        # NEFTune (noise on the input embeddings): the JAX package sets a "neft" rng that no
        # module draws from, so its finetuning runs without noise; the port does the same
        # (ROADMAP.md Queue C)
        self.neft_alpha = neft_alpha
        kwargs.setdefault("param_dtype", "fp32" if mode == Mode.training else None)
        super().__init__(pretrained_config, mode=mode, **kwargs)

    def prepare_inputs(self, batch: dict) -> dict:
        """The model's keyword arguments from a collated batch (numpy arrays or tensors) on
        the model's device; keys a batch does not carry are left out."""
        device = self.model.device
        inputs = {}
        for key in ("input_ids", "attention_mask", "labels", "position_ids", "segment_ids"):
            value = batch.get(key)
            if value is not None:
                inputs[key] = torch.as_tensor(value, device=device)
        return inputs

    def loss(self, batch: dict, train: bool = True) -> torch.Tensor:
        """The scalar loss of one micro-batch (dropout on when `train`); the model's loss
        includes a family's auxiliary loss."""
        self.model.train(train)
        return self.model(**self.prepare_inputs(batch), deterministic=not train).loss
