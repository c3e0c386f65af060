"""PEFT (LoRA and prompt tuning) of the port (mirrors `dolomite_engine_tpu/peft/`).

The adapters are parameters of the model (`lora.add_lora`, `prompt_tuning.PromptTuningCausalLM`);
`freeze_base_weights` freezes every other one with ``requires_grad_(False)``, so the base
gets no gradient and no optimizer state: what `dolomite_engine_tpu/peft/lora.py` states
("frozen by the optimizer mask") and what HF peft does.
"""

from __future__ import annotations

from torch import nn

from .lora import DEFAULT_TARGETS, LoRASpec, add_lora, lora_targets
from .prompt_tuning import PromptTuningCausalLM

TRAINABLE_LEAF_NAMES = ("lora_a", "lora_b", "prompt_embeddings")


def is_trainable(name: str) -> bool:
    """An adapter parameter (the JAX package's `peft_trainable_mask` over the name)."""
    return any(part in TRAINABLE_LEAF_NAMES for part in name.split("."))


def freeze_base_weights(model: nn.Module) -> None:
    """``requires_grad_(False)`` on every parameter but the adapters."""
    for name, param in model.named_parameters():
        param.requires_grad_(is_trainable(name))
