"""PEFT wrapper (LoRA / prompt tuning).

Counterpart of `dolomite_engine_tpu/model_wrapper/peft.py`: the finetuning wrapper whose
model grows adapters. LoRA adds ``lora_a`` / ``lora_b`` to the targeted linears in place
(`lora_target_modules`, default ``("c_attn",)``, and for an encoder-decoder also the
cross-attention's ``c_q`` and ``c_kv``, as in JAX); prompt tuning wraps the causal LM in
`PromptTuningCausalLM` (its weights under ``base_model``). For training the base weights
are frozen (`peft.freeze_base_weights`): only the adapters get gradients and optimizer
state. The JAX package's `finetune.main` builds its optimizer over every parameter, so
there the base trains too (ROADMAP.md Queue C); the port follows what
`dolomite_engine_tpu/peft/lora.py` states and HF peft does.
"""

from __future__ import annotations

from ..arguments import PromptTuningInit
from ..enums import Mode, TuningMethod
from ..peft import DEFAULT_TARGETS, PromptTuningCausalLM, add_lora, freeze_base_weights

# LoRA's default targets for an encoder-decoder (JAX `model_wrapper/peft.py`): the fused
# self-attention projection and the cross-attention's query and key/value projections
ENCODER_DECODER_TARGETS = ("c_attn", "c_q", "c_kv")
from .pretraining import ModelWrapperForFinetuning


class ModelWrapperForPEFT(ModelWrapperForFinetuning):
    def __init__(self, *args, tuning_args=None, **kwargs) -> None:
        assert tuning_args is not None
        self.tuning_method = tuning_args.tuning_method
        self.lora_args = tuning_args.lora_args
        self.prompt_tuning_args = tuning_args.prompt_tuning_args
        super().__init__(*args, **kwargs)

    def _setup_model(self, seed: int) -> None:
        if self.tuning_method == TuningMethod.lora:
            args = self.lora_args
            if args.lora_target_modules is not None:
                targets = tuple(args.lora_target_modules)
            elif self.is_encoder_decoder:
                targets = ENCODER_DECODER_TARGETS
            else:
                targets = DEFAULT_TARGETS
            self.lora_modules = add_lora(
                self.model, args.lora_rank, args.lora_alpha, args.lora_dropout, targets, seed=seed
            )
        elif self.tuning_method == TuningMethod.prompt_tuning:
            if self.is_encoder_decoder:
                raise NotImplementedError(
                    "prompt tuning over an encoder-decoder model is not ported: the JAX package's "
                    "PromptTuningCausalLM reads base_model.transformer.wte, which its encoder-decoder "
                    "does not have, so it fails there too: ROADMAP.md Queue A, 'Other families and "
                    "parallel ops'"
                )
            args = self.prompt_tuning_args
            text_init = args.prompt_tuning_init == PromptTuningInit.TEXT
            self.model = PromptTuningCausalLM(
                self.model,
                args.num_virtual_tokens,
                init_text=args.prompt_tuning_init_text if text_init else None,
                tokenizer=self.tokenizer,
                seed=seed,
            )
        else:
            raise ValueError(f"unexpected tuning_method ({self.tuning_method}) for PEFT")
        self.model.train(self.mode == Mode.training)
        if self.mode == Mode.training:
            freeze_base_weights(self.model)
