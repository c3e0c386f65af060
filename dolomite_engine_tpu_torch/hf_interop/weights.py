"""Weight layouts: the port's module state <-> the HF "dolomite" state dict.

Counterpart of `dolomite_engine_tpu/hf_interop/weights.py`. The reference stores the fused
``c_attn`` per head type in an interleaved layout:
  - mha: per head ``[q_i | k_i | v_i]``
  - gqa: per KV group ``[q_group | k_i | v_i]``
  - mqa: flat ``[Q | k | v]``
and the port's ``c_attn`` is always flat ``[Q | K | V]`` along the output rows (torch's
``[out, in]``). MoE expert banks are ``[E, out, in]`` in the file and ``[E, in, out]`` in the
port (the grouped GEMM's layout, as in JAX); the file names them ``mlp.*`` where the port's
module is ``moe``. The encoder-decoder family has no foreign checkpoint to match: its file
layout is the JAX package's own (T5-style names, flat fused projections).

`params_to_state_dict` writes the file's dict from the port's ``model.state_dict()``, in the
JAX package's key order and each tensor in its own dtype; `state_dict_to_params` reads it
back to the port's names, each tensor in the file's dtype (the caller casts into the
model's parameters).

Of the other families the JAX functions know none: they walk every layer as a dense block.
A ``dense_moe`` model fits that walk and its two routing gates a block are left out, as the
JAX export leaves them out (so its directory does not load back, in either package). A
``gpt_crosslayer`` model, and an ``rnn_dolomite`` one with a DeltaNet layer, have no
``ln_1`` / ``c_attn`` where the walk reads them and the JAX export fails with a KeyError:
the port refuses such a state with a ValueError (`check_hf_layout`). Reading a file walks
it as JAX's does; the model's loader then refuses names that do not fit.
"""

from __future__ import annotations

from collections.abc import Callable, Mapping

import torch

from ..models.config import CommonConfig
from ..models.enums import AttentionHeadType, PositionEmbeddingType

_PEFT_NAMES = ("lora_a", "lora_b", "prompt_embeddings", "base_model")


# ---------------------------------------------------------------- qkv interleave
def interleave_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, config: CommonConfig) -> torch.Tensor:
    """``[*, in]``-layout q / k / v -> the interleaved fused tensor of the reference layout."""
    head_type = AttentionHeadType(config.attention_head_type)
    head_dim = config.head_dim
    if head_type == AttentionHeadType.mha:
        parts = []
        for i in range(config.n_head):
            s = i * head_dim
            parts += [q[s : s + head_dim], k[s : s + head_dim], v[s : s + head_dim]]
        return torch.cat(parts)
    if head_type == AttentionHeadType.gqa:
        g = config.n_head // config.num_key_value_heads
        parts = []
        for i in range(config.num_key_value_heads):
            parts += [
                q[i * g * head_dim : (i + 1) * g * head_dim],
                k[i * head_dim : (i + 1) * head_dim],
                v[i * head_dim : (i + 1) * head_dim],
            ]
        return torch.cat(parts)
    return torch.cat([q, k, v])  # mqa


def split_qkv(fused: torch.Tensor, config: CommonConfig) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Inverse of `interleave_qkv`."""
    head_type = AttentionHeadType(config.attention_head_type)
    head_dim = config.head_dim
    tail = fused.shape[1:]
    if head_type == AttentionHeadType.mha:
        w = fused.reshape(config.n_head, 3, head_dim, *tail)
        return tuple(w[:, j].reshape(-1, *tail) for j in range(3))
    if head_type == AttentionHeadType.gqa:
        g = config.n_head // config.num_key_value_heads
        w = fused.reshape(config.num_key_value_heads, g + 2, head_dim, *tail)
        return w[:, :g].reshape(-1, *tail), w[:, g].reshape(-1, *tail), w[:, g + 1].reshape(-1, *tail)
    nq = config.n_head * head_dim
    return fused[:nq], fused[nq : nq + head_dim], fused[nq + head_dim :]


def _flat_split(fused: torch.Tensor, config: CommonConfig) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    nq = config.n_head * config.head_dim
    nkv = config.num_key_value_heads * config.head_dim
    return fused[:nq], fused[nq : nq + nkv], fused[nq + nkv :]


def _check_not_peft(names) -> None:
    peft = [n for n in names if any(part in _PEFT_NAMES for part in n.split("."))]
    if peft:
        raise ValueError(
            f"a PEFT model's weights ({peft[0]}, ...) have no HF layout: the JAX package's "
            "params_to_state_dict reads the base model's tree alone and fails on a PEFT tree, "
            "so the port refuses it too; save the base model, or merge the adapters first"
        )


def check_hf_layout(config: CommonConfig, names) -> None:
    """Refuse a model whose state `names` lack a dense block's ``ln_1`` / ``attn.c_attn``
    in some layer: the reference layout reads every layer as one, and the JAX function
    fails on such a model with a KeyError."""
    for i in range(config.n_layer):
        for key in (f"transformer.h.{i}.ln_1.weight", f"transformer.h.{i}.attn.c_attn.weight"):
            if key not in names:
                raise ValueError(
                    f"a {config.model_type} model has no HF dolomite layout: the layout reads every layer "
                    f"as a dense block and this model has no {key}; the JAX package's params_to_state_dict "
                    "fails on it with a KeyError"
                )


# ---------------------------------------------------------------- module state -> file
def params_to_state_dict(config: CommonConfig, params: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The port's ``model.state_dict()`` -> the reference-layout state dict."""
    _check_not_peft(params)
    if config.model_type == "enc_dec_dolomite":
        return _enc_dec_params_to_state_dict(config, params)
    check_hf_layout(config, params)

    sd: dict[str, torch.Tensor] = {"transformer.wte.weight": params["transformer.wte.weight"]}
    if PositionEmbeddingType(config.position_embedding_type) == PositionEmbeddingType.learned_absolute:
        sd["transformer.wpe.weight"] = params["transformer.wpe.weight"]
    moe = config.model_type == "moe_dolomite"
    for i in range(config.n_layer):
        p = f"transformer.h.{i}."
        _copy(sd, params, p + "ln_1.")
        _copy(sd, params, p + "ln_2.")
        sd[p + "attn.c_attn.weight"] = interleave_qkv(*_flat_split(params[p + "attn.c_attn.weight"], config), config)
        if p + "attn.c_attn.bias" in params:
            sd[p + "attn.c_attn.bias"] = interleave_qkv(*_flat_split(params[p + "attn.c_attn.bias"], config), config)
        _copy(sd, params, p + "attn.c_proj.")
        if moe:  # the file's "mlp." names; banks [E, in, out] -> [E, out, in]
            sd[p + "mlp.gate.weight"] = params[p + "moe.gate.weight"]
            for name in ("c_fc", "c_proj"):
                sd[p + f"mlp.{name}.weight"] = params[p + f"moe.{name}.weight"].transpose(1, 2).contiguous()
                if p + f"moe.{name}.bias" in params:
                    sd[p + f"mlp.{name}.bias"] = params[p + f"moe.{name}.bias"]
        else:
            _copy(sd, params, p + "mlp.c_fc.")
            _copy(sd, params, p + "mlp.c_proj.")
    _copy(sd, params, "transformer.ln_f.")
    if not config.tie_word_embeddings:
        sd["lm_head.weight"] = params["lm_head.weight"]
    return sd


def _copy(sd: dict, params: Mapping, prefix: str, to: str | None = None) -> None:
    """``weight`` (and ``bias`` where the module has one) under `prefix` -> under `to`."""
    for leaf in ("weight", "bias"):
        if prefix + leaf in params:
            sd[(to or prefix) + leaf] = params[prefix + leaf]


# encoder-decoder: (the port's module prefix, the file's) of each block's modules
_ENCODER_MODULES = ("ln_1", "ln_2", "attn.c_attn", "attn.c_proj", "mlp.c_fc", "mlp.c_proj")
_DECODER_MODULES = (
    "ln_1", "ln_cross", "ln_2", "attn.c_attn", "attn.c_proj", "cross_attn.c_q", "cross_attn.c_kv",
    "cross_attn.c_proj", "mlp.c_fc", "mlp.c_proj",
)


def _enc_dec_params_to_state_dict(config: CommonConfig, params: Mapping) -> dict[str, torch.Tensor]:
    sd: dict[str, torch.Tensor] = {"shared.weight": params["wte.weight"]}
    if "lm_head.weight" in params:
        sd["lm_head.weight"] = params["lm_head.weight"]
    if "rel_bias_enc.weight" in params:
        sd["encoder.relative_bias.weight"] = params["rel_bias_enc.weight"]
        sd["decoder.relative_bias.weight"] = params["rel_bias_dec.weight"]
    for stack, layers, modules, final in (
        ("encoder", config.n_encoder_layer, _ENCODER_MODULES, "ln_enc"),
        ("decoder", config.n_layer, _DECODER_MODULES, "ln_dec"),
    ):
        for i in range(layers):
            for module in modules:
                _copy(sd, params, f"{stack}.{i}.{module}.", f"{stack}.block.{i}.{module}.")
        _copy(sd, params, f"{final}.", f"{stack}.final_layernorm.")
    return sd


# ---------------------------------------------------------------- file -> module state
def state_dict_to_params(config: CommonConfig, get_tensor: Callable[[str], torch.Tensor]) -> dict[str, torch.Tensor]:
    """The reference-layout state dict -> the port's module state (its ``state_dict()``
    names), each tensor in the file's dtype. `get_tensor` is a callable name -> tensor, or
    a `SafeTensorsWeightsManager`."""
    if hasattr(get_tensor, "get_tensor"):
        get_tensor = get_tensor.get_tensor
    if config.model_type == "enc_dec_dolomite":
        return _enc_dec_state_dict_to_params(config, get_tensor)

    bias = config.add_bias
    layernorm = config.normalization_function == "layernorm"
    params: dict[str, torch.Tensor] = {"transformer.wte.weight": get_tensor("transformer.wte.weight")}
    if PositionEmbeddingType(config.position_embedding_type) == PositionEmbeddingType.learned_absolute:
        params["transformer.wpe.weight"] = get_tensor("transformer.wpe.weight")

    def take(prefix: str, with_bias: bool, to: str | None = None) -> None:
        params[(to or prefix) + "weight"] = get_tensor(prefix + "weight")
        if with_bias:
            params[(to or prefix) + "bias"] = get_tensor(prefix + "bias")

    for i in range(config.n_layer):
        p = f"transformer.h.{i}."
        take(p + "ln_1.", layernorm)
        take(p + "ln_2.", layernorm)
        params[p + "attn.c_attn.weight"] = torch.cat(split_qkv(get_tensor(p + "attn.c_attn.weight"), config))
        if bias:
            params[p + "attn.c_attn.bias"] = torch.cat(split_qkv(get_tensor(p + "attn.c_attn.bias"), config))
        take(p + "attn.c_proj.", bias)
        if config.model_type == "moe_dolomite":
            params[p + "moe.gate.weight"] = get_tensor(p + "mlp.gate.weight")
            for name in ("c_fc", "c_proj"):
                params[p + f"moe.{name}.weight"] = get_tensor(p + f"mlp.{name}.weight").transpose(1, 2).contiguous()
                if bias:
                    params[p + f"moe.{name}.bias"] = get_tensor(p + f"mlp.{name}.bias")
        else:
            take(p + "mlp.c_fc.", bias)
            take(p + "mlp.c_proj.", bias)
    take("transformer.ln_f.", layernorm)
    if not config.tie_word_embeddings:
        params["lm_head.weight"] = get_tensor("lm_head.weight")
    return params


def _enc_dec_state_dict_to_params(config: CommonConfig, get_tensor) -> dict[str, torch.Tensor]:
    bias = config.add_bias
    layernorm = config.normalization_function == "layernorm"
    params: dict[str, torch.Tensor] = {"wte.weight": get_tensor("shared.weight")}
    if not config.tie_word_embeddings:
        params["lm_head.weight"] = get_tensor("lm_head.weight")
    if config.position_embedding_type == "relative_bucketed":
        params["rel_bias_enc.weight"] = get_tensor("encoder.relative_bias.weight")
        params["rel_bias_dec.weight"] = get_tensor("decoder.relative_bias.weight")
    for stack, layers, modules, final in (
        ("encoder", config.n_encoder_layer, _ENCODER_MODULES, "ln_enc"),
        ("decoder", config.n_layer, _DECODER_MODULES, "ln_dec"),
    ):
        for i in range(layers):
            for module in modules:
                src, dst = f"{stack}.block.{i}.{module}.", f"{stack}.{i}.{module}."
                params[dst + "weight"] = get_tensor(src + "weight")
                if layernorm if module.startswith("ln_") else bias:
                    params[dst + "bias"] = get_tensor(src + "bias")
        params[f"{final}.weight"] = get_tensor(f"{stack}.final_layernorm.weight")
        if layernorm:
            params[f"{final}.bias"] = get_tensor(f"{stack}.final_layernorm.bias")
    return params
