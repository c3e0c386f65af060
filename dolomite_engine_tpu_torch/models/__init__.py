"""Models of the port (mirrors `dolomite_engine_tpu/models/`) and the model registry.

`config_from_dict` / `get_model_class` keep the JAX package's names and errors: a
`model_type` the port builds maps to its config and model classes, a family of the JAX
package that is not ported yet raises `NotImplementedError` naming its ROADMAP item, and
an unknown type raises `ValueError`.
"""

from .config import CommonConfig, EncDecDolomiteConfig, MoEConfig
from .enc_dec_dolomite import EncDecDolomiteForSeq2SeqLM, Seq2SeqOutput, unstack_enc_dec_params
from .gpt_dolomite import (
    CausalLMOutput,
    GPTDolomiteForCausalLM,
    GPTDolomiteModel,
    load_jax_params,
    load_jax_train_state,
)
from .moe_dolomite import MoEDolomiteForCausalLM, MoEDolomiteModel

_CONFIG_CLASSES: dict[str, type] = {
    "gpt_dolomite": CommonConfig,
    "moe_dolomite": MoEConfig,
    "enc_dec_dolomite": EncDecDolomiteConfig,
}

_MODEL_CLASSES: dict[str, type] = {
    "gpt_dolomite": GPTDolomiteForCausalLM,
    "moe_dolomite": MoEDolomiteForCausalLM,
    "enc_dec_dolomite": EncDecDolomiteForSeq2SeqLM,
}

# families of the JAX package's registry that the port does not build yet
_NOT_PORTED = ("gpt_crosslayer", "dense_moe", "rnn_dolomite")

# families driven through the seq2seq (AutoModelForSeq2SeqLM) surface
_ENCODER_DECODER_TYPES = ("enc_dec_dolomite",)


def is_encoder_decoder_model(model_type: str) -> bool:
    return model_type in _ENCODER_DECODER_TYPES


def _check_model_type(model_type: str, registry: dict[str, type]) -> type:
    if model_type in _NOT_PORTED:
        raise NotImplementedError(
            f"model_type '{model_type}' is not ported yet: ROADMAP.md Queue A, "
            "'Other families and parallel ops'"
        )
    if model_type not in registry:
        raise ValueError(f"unknown model_type '{model_type}'")
    return registry[model_type]


def get_config_class(model_type: str) -> type:
    return _check_model_type(model_type, _CONFIG_CLASSES)


def get_model_class(model_type: str) -> type:
    return _check_model_type(model_type, _MODEL_CLASSES)


def config_from_dict(d: dict) -> CommonConfig:
    model_type = d.get("model_type", "gpt_dolomite")
    return get_config_class(model_type).from_dict(d)
