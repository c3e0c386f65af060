"""Prompt tuning: trainable virtual-token embeddings prepended to the sequence.

Counterpart of `dolomite_engine_tpu/peft/prompt_tuning.py`: `PromptTuningCausalLM` holds
the causal LM as ``base_model`` and fp32 ``prompt_embeddings`` ``[num_virtual_tokens,
n_embd]``, initialised RANDOM (normal, std 0.02) or TEXT (the embedding rows of the init
text's tokens, tiled to the count). Its forward embeds the ids, prepends the virtual
tokens in the compute dtype, ones to the attention mask and IGNORE_INDEX to the labels,
and runs the base model on those embeddings. Packed (padding-free) batches raise.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.loss import IGNORE_INDEX


class PromptTuningCausalLM(nn.Module):
    def __init__(
        self,
        base_model: nn.Module,
        num_virtual_tokens: int,
        init_text: str | None = None,
        tokenizer=None,
        seed: int = 0,
    ) -> None:
        super().__init__()
        self.base_model = base_model
        self.num_virtual_tokens = num_virtual_tokens
        wte = base_model.transformer.wte.weight
        self.prompt_embeddings = nn.Parameter(
            torch.empty(num_virtual_tokens, base_model.config.n_embd, dtype=torch.float32, device=wte.device)
        )
        self.init_ids = None
        if init_text is not None and tokenizer is not None:
            ids = tokenizer(init_text, add_special_tokens=False)["input_ids"]
            self.init_ids = (ids * (num_virtual_tokens // max(len(ids), 1) + 1))[:num_virtual_tokens]
        if wte.device.type != "meta":
            self.init_prompt(seed)

    @torch.no_grad()
    def init_prompt(self, seed: int) -> None:
        """RANDOM: normal(0.02) from `seed`; TEXT: the base embedding's rows of the init ids."""
        if self.init_ids is not None:
            rows = torch.as_tensor(self.init_ids, dtype=torch.long, device=self.device)
            self.prompt_embeddings.copy_(self.base_model.transformer.wte.weight[rows].float())
        else:
            generator = torch.Generator(device=self.device).manual_seed(seed)
            self.prompt_embeddings.normal_(0.0, 0.02, generator=generator)

    @property
    def config(self):
        return self.base_model.config

    @property
    def device(self) -> torch.device:
        return self.base_model.device

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: torch.Tensor | None = None,
        labels: torch.Tensor | None = None,
        position_ids: torch.Tensor | None = None,
        segment_ids: torch.Tensor | None = None,
        deterministic: bool = True,
        **kwargs,
    ):
        if position_ids is not None or segment_ids is not None:
            raise NotImplementedError("prompt tuning does not support padding-free batches")
        batch, seq = input_ids.shape
        v = self.num_virtual_tokens
        inputs_embeds = self.base_model.transformer.wte(input_ids)
        virtual = self.prompt_embeddings[None].to(inputs_embeds.dtype).expand(batch, v, -1)
        inputs_embeds = torch.cat([virtual, inputs_embeds], dim=1)
        if attention_mask is not None:
            ones = torch.ones((batch, v), dtype=attention_mask.dtype, device=attention_mask.device)
            attention_mask = torch.cat([ones, attention_mask], dim=1)
        if labels is not None:
            ignore = torch.full((batch, v), IGNORE_INDEX, dtype=labels.dtype, device=labels.device)
            labels = torch.cat([ignore, labels], dim=1)
        return self.base_model(
            torch.zeros((batch, seq + v), dtype=input_ids.dtype, device=input_ids.device),  # shape only
            inputs_embeds=inputs_embeds,
            attention_mask=attention_mask,
            labels=labels,
            deterministic=deterministic,
            **kwargs,
        )
