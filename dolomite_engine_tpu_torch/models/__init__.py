"""Models of the port (mirrors `dolomite_engine_tpu/models/`) and the model registry.

`config_from_dict` / `get_model_class` keep the JAX package's names and errors: each of
the JAX package's six families maps to its config and model classes, and an unknown type
raises `ValueError`.
"""

from .config import (
    CommonConfig,
    DenseMoEConfig,
    EncDecDolomiteConfig,
    GPTCrossLayerConfig,
    MoEConfig,
    RNNDolomiteConfig,
)
from .dense_moe import DenseMoEForCausalLM
from .enc_dec_dolomite import EncDecDolomiteForSeq2SeqLM, Seq2SeqOutput, unstack_enc_dec_params
from .gpt_dolomite import (
    CausalLMOutput,
    GPTDolomiteForCausalLM,
    GPTDolomiteModel,
    load_jax_params,
    load_jax_train_state,
)
from .gpt_crosslayer import GPTCrossLayerForCausalLM, convert_gpt_dolomite_to_gpt_crosslayer
from .moe_dolomite import MoEDolomiteForCausalLM, MoEDolomiteModel
from .rnn_dolomite import RNNDolomiteForCausalLM

_CONFIG_CLASSES: dict[str, type] = {
    "gpt_dolomite": CommonConfig,
    "moe_dolomite": MoEConfig,
    "gpt_crosslayer": GPTCrossLayerConfig,
    "dense_moe": DenseMoEConfig,
    "rnn_dolomite": RNNDolomiteConfig,
    "enc_dec_dolomite": EncDecDolomiteConfig,
}

_MODEL_CLASSES: dict[str, type] = {
    "gpt_dolomite": GPTDolomiteForCausalLM,
    "moe_dolomite": MoEDolomiteForCausalLM,
    "gpt_crosslayer": GPTCrossLayerForCausalLM,
    "dense_moe": DenseMoEForCausalLM,
    "rnn_dolomite": RNNDolomiteForCausalLM,
    "enc_dec_dolomite": EncDecDolomiteForSeq2SeqLM,
}

# families driven through the seq2seq (AutoModelForSeq2SeqLM) surface
_ENCODER_DECODER_TYPES = ("enc_dec_dolomite",)


def is_encoder_decoder_model(model_type: str) -> bool:
    return model_type in _ENCODER_DECODER_TYPES


def _check_model_type(model_type: str, registry: dict[str, type]) -> type:
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
