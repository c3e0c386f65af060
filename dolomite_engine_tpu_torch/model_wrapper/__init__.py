"""Model wrappers of the port (mirrors `dolomite_engine_tpu/model_wrapper/`)."""

from __future__ import annotations

import logging

import torch

from ..enums import Mode, TuningMethod
from ..utils import log_rank_0
from .base import ModelWrapper
from .peft import ModelWrapperForPEFT
from .pretraining import ModelWrapperForFinetuning, ModelWrapperForPretraining


def get_model(args, mode: Mode = Mode.training, device: str | torch.device = "cuda") -> ModelWrapper:
    """The wrapper of `TrainingArgs`' tuning method (the JAX package's factory): the
    config (``pretrained_config``, or ``model_name``'s local directory), the tokenizer,
    the attention implementation, the compute dtype of `mixed_precision_args` and the
    seed of `random_args`. For training the weights are fp32 masters with remat when a
    gradient-checkpointing method is set (pretraining adds the reset masks; LoRA and
    prompt tuning freeze the base); for inference they are stored in the compute dtype."""
    tuning_method = args.tuning_args.tuning_method
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
        mode=mode,
        model_class=model_args.model_class,
        scan_layers=model_args.scan_layers,
    )
    if mode == Mode.training:
        dist = args.distributed_args
        common["gradient_checkpointing_args"] = (
            dist.gradient_checkpointing_args if dist.gradient_checkpointing_method is not None else None
        )
    else:
        common["param_dtype"] = None
    config = None if model_args.model_name is not None else model_args.pretrained_config
    if tuning_method == TuningMethod.pretraining:
        return ModelWrapperForPretraining(
            config,
            reset_attention_mask=mode == Mode.training and model_args.reset_attention_mask,
            reset_position_ids=mode == Mode.training and model_args.reset_position_ids,
            **common,
        )
    neft_alpha = args.research_args.neft_alpha
    if tuning_method == TuningMethod.full_finetuning:
        return ModelWrapperForFinetuning(config, neft_alpha=neft_alpha, **common)
    if tuning_method in (TuningMethod.prompt_tuning, TuningMethod.lora):
        return ModelWrapperForPEFT(config, neft_alpha=neft_alpha, tuning_args=args.tuning_args, **common)
    raise ValueError(f"unexpected tuning_method ({tuning_method})")


def log_model(model: ModelWrapper) -> None:
    """Log the module tree and the parameter count."""
    log_rank_0(logging.INFO, f"model = {model.model}")
    log_rank_0(logging.INFO, f"num parameters = {sum(p.numel() for p in model.model.parameters()):,}")
