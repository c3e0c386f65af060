"""Model wrappers of the port (mirrors `dolomite_engine_tpu/model_wrapper/`)."""

from __future__ import annotations

import logging

import torch

from ..enums import Mode, TuningMethod
from ..utils import log_rank_0
from .pretraining import ModelWrapperForPretraining


def _load_tokenizer(name: str | None):
    """The HF tokenizer `name`, or None: pretraining reads token ids, so a tokenizer that
    cannot load (no `transformers`, no network) is warned about and left out, as in the JAX
    package's `ModelWrapper._setup_tokenizer`."""
    if name is None:
        return None
    try:
        from transformers import AutoTokenizer

        return AutoTokenizer.from_pretrained(name)
    except Exception as error:  # the tokenizer is optional for pretraining on token bins
        log_rank_0(logging.WARNING, f"could not load tokenizer '{name}': {error}")
        return None


def get_model(args, mode: Mode = Mode.training, device: str | torch.device = "cuda") -> ModelWrapperForPretraining:
    """The pretraining wrapper from `TrainingArgs`: the compute dtype from
    `mixed_precision_args` over fp32 master weights, the attention implementation, remat
    when a gradient-checkpointing method is set, the reset masks, and the seed of
    `random_args`."""
    if mode != Mode.training or args.tuning_args.tuning_method != TuningMethod.pretraining:
        raise NotImplementedError(
            f"{mode.value} / {args.tuning_args.tuning_method.value} is not ported yet: "
            "ROADMAP.md Queue A, 'Finetune and PEFT'"
        )
    model_args = args.model_args
    config = dict(model_args.pretrained_config, **(model_args.config_extras or {}))
    dist = args.distributed_args
    wrapper = ModelWrapperForPretraining(
        config,
        dtype=args.mixed_precision_args.dtype,
        param_dtype="fp32",
        attention_implementation=model_args.attention_implementation,
        gradient_checkpointing_args=(
            dist.gradient_checkpointing_args if dist.gradient_checkpointing_method is not None else None
        ),
        reset_attention_mask=model_args.reset_attention_mask,
        reset_position_ids=model_args.reset_position_ids,
        device=device,
        seed=args.random_args.seed,
    )
    wrapper.tokenizer = _load_tokenizer(args.tokenizer_args.tokenizer_name)
    return wrapper


def log_model(model: ModelWrapperForPretraining) -> None:
    """Log the module tree and the parameter count."""
    log_rank_0(logging.INFO, f"model = {model.model}")
    log_rank_0(logging.INFO, f"num parameters = {sum(p.numel() for p in model.model.parameters()):,}")
