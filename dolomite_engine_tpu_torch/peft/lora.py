"""LoRA: low-rank adapters on the targeted linears.

Counterpart of `dolomite_engine_tpu/peft/lora.py` and of the LoRA hook of its
`ParameterizedLinear`: every `ParameterizedLinear` whose own module name (``c_attn``,
``c_proj``, ``c_fc``, ``gate``, ``lm_head``) contains one of the target substrings gets
fp32 adapters ``lora_a`` (normal, std ``in ** -0.5``) and ``lora_b`` (zeros) and adds
``(alpha / rank) * dropout(x) @ A @ B`` to its output (`models/modeling_utils.py`). The
adapters are stored in torch's ``[out, in]`` layout, ``lora_a`` ``[rank, in]`` and
``lora_b`` ``[out, rank]``: the flax ``[in, rank]`` / ``[rank, out]`` kernels transposed,
as `models.load_jax_params` carries them. The adapter product is plain ``F.linear``, as
JAX computes it outside any Pallas kernel. The base weights are frozen by
`peft.freeze_base_weights`.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..models.modeling_utils import ParameterizedLinear

DEFAULT_TARGETS = ("c_attn",)


@dataclass(frozen=True)
class LoRASpec:
    rank: int
    alpha: float
    dropout: float


def lora_targets(model: nn.Module, targets: tuple[str, ...] = DEFAULT_TARGETS) -> list[tuple[str, ParameterizedLinear]]:
    """(name, module) of every `ParameterizedLinear` whose own name contains a target."""
    return [
        (name, module)
        for name, module in model.named_modules()
        if isinstance(module, ParameterizedLinear) and any(t in name.rsplit(".", 1)[-1] for t in targets)
    ]


@torch.no_grad()
def add_lora(
    model: nn.Module,
    rank: int,
    alpha: float,
    dropout: float,
    targets: tuple[str, ...] = DEFAULT_TARGETS,
    seed: int = 0,
) -> list[str]:
    """Give the targeted linears of `model` their adapters (initialised from `seed`, on the
    model's device); returns the targeted module names. No target raises, where the JAX
    package's LoRA adapts nothing and trains nothing (a YAML typo, or the default
    ``c_attn`` on a cross-layer model, whose projections are ``q_attn`` / ``kv_attn``)."""
    found = lora_targets(model, tuple(targets))
    if not found:
        names = sorted({name.rsplit(".", 1)[-1] for name, _ in lora_targets(model, ("",))})
        raise ValueError(
            f"no linear of the model matches the LoRA targets {tuple(targets)} (its linears: "
            f"{', '.join(names)}): the JAX package's LoRA would adapt none and train nothing; "
            "set lora_target_modules"
        )
    spec = LoRASpec(int(rank), float(alpha), float(dropout))
    generator = None
    for name, module in found:
        out_features, in_features = module.weight.shape
        device = module.weight.device
        if generator is None and device.type != "meta":
            generator = torch.Generator(device=device).manual_seed(seed)
        module.lora_a = nn.Parameter(torch.empty(rank, in_features, dtype=torch.float32, device=device))
        module.lora_b = nn.Parameter(torch.zeros(out_features, rank, dtype=torch.float32, device=device))
        if device.type != "meta":
            module.lora_a.normal_(0.0, in_features**-0.5, generator=generator)
        module.lora = spec
    return [name for name, _ in found]
