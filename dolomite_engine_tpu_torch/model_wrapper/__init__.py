"""Model wrappers of the port (mirrors `dolomite_engine_tpu/model_wrapper/`)."""

from __future__ import annotations

import logging

import torch

from ..enums import Mode, TuningMethod
from ..utils import log_rank_0
from .base import ModelWrapper
from .pretraining import ModelWrapperForFinetuning, ModelWrapperForPretraining


def get_model(args, mode: Mode = Mode.training, device: str | torch.device = "cuda") -> ModelWrapper:
    """The wrapper of `TrainingArgs`' tuning method: the config, the tokenizer, the
    attention implementation, the compute dtype of `mixed_precision_args` and the seed of
    `random_args`. For training (pretraining only) the weights are fp32 masters with remat
    when a gradient-checkpointing method is set and the reset masks; for inference (a
    pretraining or full-finetuning config) they are stored in the compute dtype."""
    tuning_method = args.tuning_args.tuning_method
    ported = [TuningMethod.pretraining] + ([] if mode == Mode.training else [TuningMethod.full_finetuning])
    if tuning_method not in ported:
        raise NotImplementedError(
            f"{mode.value} / {tuning_method.value} is not ported yet: "
            "ROADMAP.md Queue A, 'Finetune and PEFT'"
        )
    model_args = args.model_args
    common = dict(
        dtype=args.mixed_precision_args.dtype,
        attention_implementation=model_args.attention_implementation,
        model_name=model_args.model_name,
        tokenizer_name=args.tokenizer_args.tokenizer_name,
        additional_special_tokens=args.tokenizer_args.additional_special_tokens,
        config_extras=model_args.config_extras,
        device=device,
        seed=args.random_args.seed,
    )
    if mode != Mode.training:
        wrapper_class = (
            ModelWrapperForPretraining if tuning_method == TuningMethod.pretraining else ModelWrapperForFinetuning
        )
        return wrapper_class(model_args.pretrained_config, mode=mode, param_dtype=None, **common)
    dist = args.distributed_args
    return ModelWrapperForPretraining(
        model_args.pretrained_config,
        reset_attention_mask=model_args.reset_attention_mask,
        reset_position_ids=model_args.reset_position_ids,
        gradient_checkpointing_args=(
            dist.gradient_checkpointing_args if dist.gradient_checkpointing_method is not None else None
        ),
        **common,
    )


def log_model(model: ModelWrapper) -> None:
    """Log the module tree and the parameter count."""
    log_rank_0(logging.INFO, f"model = {model.model}")
    log_rank_0(logging.INFO, f"num parameters = {sum(p.numel() for p in model.model.parameters()):,}")
