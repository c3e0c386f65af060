"""Bidirectional HF <-> dolomite checkpoint conversion over torch state dicts.

Counterpart of `dolomite_engine_tpu/hf_interop/conversion.py`, the same mappings and the
same files: `import_from_huggingface` / `export_to_huggingface` over six model types:
  - llama:       separate q/k/v -> interleaved fused c_attn; up/gate -> fused [up; gate]
                 c_fc; rmsnorm; rope
  - granite:     llama's mapping + the µP multipliers (embedding_multiplier -> m_emb,
                 residual_multiplier -> m_residual, logits_scaling -> m_width,
                 attention_multiplier)
  - granitemoe:  granite + MoE: router.layer -> mlp.gate, the fused input_linear
                 [E, [gate; up], H] halves swapped to dolomite's [up; gate],
                 output_linear -> mlp.c_proj
  - mixtral:     per-expert w1 (gate) / w3 (up) / w2 (down) -> stacked expert banks
  - gpt_bigcode: the weights are layout-identical; only the config is rewritten
  - t5:          t5 v1.0 and v1.1 / flan-t5 into enc_dec_dolomite
The state dicts are torch tensors from `utils.safetensors.SafeTensorsWeightsManager`, in
the file's dtype (bf16 included); `weights.py` maps the dolomite state dict to the port's
modules. Configs are read and written as json dicts, so conversion does not depend on the
installed transformers knowing the architecture. A directory shipping only
``pytorch_model*.bin`` is converted to safetensors in a staging directory first. A hub id
is not ported (`utils.hf_hub.resolve_model_path` raises, naming its ROADMAP item).
"""

from __future__ import annotations

import json
import math
import os
import shutil

import torch

from ..models.config import CommonConfig, MoEConfig
from ..models.enums import AttentionHeadType
from ..ops.activations import is_glu
from ..utils.safetensors import SafeTensorsWeightsManager
from .weights import interleave_qkv, split_qkv

# ---------------------------------------------------------------------------- helpers


def _read_config(path: str) -> dict:
    with open(os.path.join(path, "config.json")) as f:
        return json.load(f)


def _write_config(config: dict, path: str) -> None:
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f, indent=2, sort_keys=True)


def _copy_tokenizer_files(src: str, dst: str) -> None:
    for name in (
        "tokenizer.json",
        "tokenizer_config.json",
        "special_tokens_map.json",
        "vocab.json",
        "merges.txt",
        "tokenizer.model",
    ):
        p = os.path.join(src, name)
        if os.path.isfile(p):
            shutil.copy(p, os.path.join(dst, name))


def _head_type_from_counts(num_heads: int, num_kv_heads: int) -> str:
    if num_heads == num_kv_heads:
        return "mha"
    if num_kv_heads == 1:
        return "mqa"
    return "gqa"


def _swap_glu_halves(weight: torch.Tensor) -> torch.Tensor:
    """[gate; up] <-> [up; gate] on dim 1 of [E, 2I, H] (reference granitemoe.py:265-268);
    self-inverse."""
    x, y = weight.chunk(2, dim=1)
    return torch.cat([y, x], dim=1)


def _none_if(value, default):
    return None if value == default else value


# ---------------------------------------------------------------------------- llama / granite


def _llama_like_config_to_dolomite(hf: dict) -> dict:
    assert hf.get("hidden_act", "silu") == "silu"
    # dolomite has one add_bias knob (reference llama.py:49 asserts the same)
    assert hf.get("mlp_bias", False) == hf.get("attention_bias", False), (
        "dolomite config cannot represent mlp_bias != attention_bias"
    )
    num_heads = hf["num_attention_heads"]
    num_kv = hf.get("num_key_value_heads", num_heads)
    config = dict(
        model_type="gpt_dolomite",
        vocab_size=hf["vocab_size"],
        n_positions=hf.get("max_position_embeddings", 2048),
        n_embd=hf["hidden_size"],
        n_layer=hf["num_hidden_layers"],
        n_head=num_heads,
        num_key_value_heads=num_kv,
        attention_head_type=_head_type_from_counts(num_heads, num_kv),
        position_embedding_type="rope",
        n_inner=hf["intermediate_size"],
        activation_function="swiglu",
        normalization_function="rmsnorm",
        layer_norm_epsilon=hf.get("rms_norm_eps", 1e-6),
        use_cache=hf.get("use_cache", True),
        add_bias=hf.get("attention_bias", False),
        tie_word_embeddings=hf.get("tie_word_embeddings", False),
        initializer_range=hf.get("initializer_range", 0.02),
        rope_theta=hf.get("rope_theta", 10000.0),
        rope_scaling=hf.get("rope_scaling"),
        attn_pdrop=hf.get("attention_dropout", 0.0),
        resid_pdrop=0.0,
        embd_pdrop=0.0,
        bos_token_id=hf.get("bos_token_id"),
        eos_token_id=hf.get("eos_token_id"),
        pad_token_id=hf.get("pad_token_id"),
    )
    return config


def _dolomite_config_to_llama_like(config: CommonConfig) -> dict:
    assert config.activation_function == "swiglu"
    assert config.normalization_function == "rmsnorm"
    assert config.position_embedding_type == "rope"
    return dict(
        model_type="llama",
        architectures=["LlamaForCausalLM"],
        vocab_size=config.vocab_size,
        max_position_embeddings=config.n_positions,
        hidden_size=config.n_embd,
        num_hidden_layers=config.n_layer,
        num_attention_heads=config.n_head,
        num_key_value_heads=config.num_key_value_heads,
        intermediate_size=config.n_inner,
        hidden_act="silu",
        rms_norm_eps=config.layer_norm_epsilon,
        use_cache=config.use_cache,
        attention_bias=config.add_bias,
        mlp_bias=config.add_bias,
        tie_word_embeddings=config.tie_word_embeddings,
        initializer_range=config.initializer_range,
        rope_theta=config.rope_theta,
        rope_scaling=config.rope_scaling,
        attention_dropout=config.attn_pdrop,
        bos_token_id=config.bos_token_id,
        eos_token_id=config.eos_token_id,
        pad_token_id=config.pad_token_id,
    )


def _import_llama_like_attention(
    sd: dict, manager: SafeTensorsWeightsManager, i: int, config: CommonConfig
) -> None:
    p = f"model.layers.{i}.self_attn."
    q = manager.get_tensor(p + "q_proj.weight")
    k = manager.get_tensor(p + "k_proj.weight")
    v = manager.get_tensor(p + "v_proj.weight")
    sd[f"transformer.h.{i}.attn.c_attn.weight"] = interleave_qkv(q, k, v, config)
    if manager.has_tensor(p + "q_proj.bias"):
        sd[f"transformer.h.{i}.attn.c_attn.bias"] = interleave_qkv(
            manager.get_tensor(p + "q_proj.bias"),
            manager.get_tensor(p + "k_proj.bias"),
            manager.get_tensor(p + "v_proj.bias"),
            config,
        )
    sd[f"transformer.h.{i}.attn.c_proj.weight"] = manager.get_tensor(p + "o_proj.weight")
    if manager.has_tensor(p + "o_proj.bias"):
        sd[f"transformer.h.{i}.attn.c_proj.bias"] = manager.get_tensor(p + "o_proj.bias")


def _export_llama_like_attention(
    sd: dict, manager: SafeTensorsWeightsManager, i: int, config: CommonConfig
) -> None:
    p = f"transformer.h.{i}.attn."
    q, k, v = split_qkv(manager.get_tensor(p + "c_attn.weight"), config)
    out = f"model.layers.{i}.self_attn."
    sd[out + "q_proj.weight"] = q
    sd[out + "k_proj.weight"] = k
    sd[out + "v_proj.weight"] = v
    if manager.has_tensor(p + "c_attn.bias"):
        qb, kb, vb = split_qkv(manager.get_tensor(p + "c_attn.bias"), config)
        sd[out + "q_proj.bias"] = qb
        sd[out + "k_proj.bias"] = kb
        sd[out + "v_proj.bias"] = vb
    sd[out + "o_proj.weight"] = manager.get_tensor(p + "c_proj.weight")
    if manager.has_tensor(p + "c_proj.bias"):
        sd[out + "o_proj.bias"] = manager.get_tensor(p + "c_proj.bias")


def _import_backbone(manager: SafeTensorsWeightsManager, config, mlp_import_fn) -> dict:
    """Shared HF->dolomite scaffold (embeddings, final norm, lm_head, per-layer norms +
    attention); `mlp_import_fn(sd, manager, i)` fills the per-layer MLP/MoE weights."""
    sd = {
        "transformer.wte.weight": manager.get_tensor("model.embed_tokens.weight"),
        "transformer.ln_f.weight": manager.get_tensor("model.norm.weight"),
    }
    if manager.has_tensor("lm_head.weight"):
        sd["lm_head.weight"] = manager.get_tensor("lm_head.weight")
    for i in range(config.n_layer):
        hp = f"model.layers.{i}."
        dp = f"transformer.h.{i}."
        sd[dp + "ln_1.weight"] = manager.get_tensor(hp + "input_layernorm.weight")
        sd[dp + "ln_2.weight"] = manager.get_tensor(hp + "post_attention_layernorm.weight")
        mlp_import_fn(sd, manager, i)
        _import_llama_like_attention(sd, manager, i, config)
    return sd


def _export_backbone(manager: SafeTensorsWeightsManager, config, mlp_export_fn) -> dict:
    """Inverse of `_import_backbone`."""
    sd = {
        "model.embed_tokens.weight": manager.get_tensor("transformer.wte.weight"),
        "model.norm.weight": manager.get_tensor("transformer.ln_f.weight"),
    }
    if manager.has_tensor("lm_head.weight"):
        sd["lm_head.weight"] = manager.get_tensor("lm_head.weight")
    for i in range(config.n_layer):
        hp = f"model.layers.{i}."
        dp = f"transformer.h.{i}."
        sd[hp + "input_layernorm.weight"] = manager.get_tensor(dp + "ln_1.weight")
        sd[hp + "post_attention_layernorm.weight"] = manager.get_tensor(dp + "ln_2.weight")
        mlp_export_fn(sd, manager, i)
        _export_llama_like_attention(sd, manager, i, config)
    return sd


def _finish_conversion(sd: dict, config_dict: dict, src: str, dst: str) -> None:
    SafeTensorsWeightsManager.save_state_dict(sd, dst)
    _write_config(config_dict, dst)
    _copy_tokenizer_files(src, dst)


def import_from_huggingface_llama(path: str, save_path: str, hf_config: dict | None = None) -> None:
    """Reference `model_conversion/llama.py:13-34` (config mapping :37-75, weights :78-149)."""
    hf = hf_config or _read_config(path)
    config_dict = _llama_like_config_to_dolomite(hf)
    config = CommonConfig.from_dict(config_dict)

    manager = SafeTensorsWeightsManager(path)

    def mlp(sd, manager, i):
        hp = f"model.layers.{i}."
        dp = f"transformer.h.{i}."
        # fused GLU [up; gate] (reference mlp.py:53-58)
        sd[dp + "mlp.c_fc.weight"] = torch.cat(
            [manager.get_tensor(hp + "mlp.up_proj.weight"), manager.get_tensor(hp + "mlp.gate_proj.weight")]
        )
        sd[dp + "mlp.c_proj.weight"] = manager.get_tensor(hp + "mlp.down_proj.weight")
        if manager.has_tensor(hp + "mlp.up_proj.bias"):
            sd[dp + "mlp.c_fc.bias"] = torch.cat(
                [manager.get_tensor(hp + "mlp.up_proj.bias"), manager.get_tensor(hp + "mlp.gate_proj.bias")]
            )
            sd[dp + "mlp.c_proj.bias"] = manager.get_tensor(hp + "mlp.down_proj.bias")

    sd = _import_backbone(manager, config, mlp)
    _finish_conversion(sd, config_dict, path, save_path)


def export_to_huggingface_llama(path: str, save_path: str) -> None:
    """Reference `model_conversion/llama.py:152-180` + state dict export :215-282."""
    config = CommonConfig.from_pretrained(path)
    hf_config = _dolomite_config_to_llama_like(config)

    manager = SafeTensorsWeightsManager(path)

    def mlp(sd, manager, i):
        hp = f"model.layers.{i}."
        dp = f"transformer.h.{i}."
        up, gate = manager.get_tensor(dp + "mlp.c_fc.weight").chunk(2)
        sd[hp + "mlp.up_proj.weight"] = up
        sd[hp + "mlp.gate_proj.weight"] = gate
        sd[hp + "mlp.down_proj.weight"] = manager.get_tensor(dp + "mlp.c_proj.weight")
        if manager.has_tensor(dp + "mlp.c_fc.bias"):
            upb, gateb = manager.get_tensor(dp + "mlp.c_fc.bias").chunk(2)
            sd[hp + "mlp.up_proj.bias"] = upb
            sd[hp + "mlp.gate_proj.bias"] = gateb
            sd[hp + "mlp.down_proj.bias"] = manager.get_tensor(dp + "mlp.c_proj.bias")

    sd = _export_backbone(manager, config, mlp)
    _finish_conversion(sd, hf_config, path, save_path)


def import_from_huggingface_granite(path: str, save_path: str) -> None:
    """Reference `model_conversion/granite.py`: llama weights + µP multiplier knobs."""
    hf = _read_config(path)
    import_from_huggingface_llama(path, save_path, hf_config=hf)
    config_dict = _read_config(save_path)
    config_dict.update(
        m_emb=_none_if(hf.get("embedding_multiplier", 1), 1),
        m_residual=_none_if(hf.get("residual_multiplier", 1), 1),
        m_width=_none_if(hf.get("logits_scaling", 1), 1),
        attention_multiplier=hf.get("attention_multiplier"),
    )
    _write_config(config_dict, save_path)


def export_to_huggingface_granite(path: str, save_path: str) -> None:
    config = CommonConfig.from_pretrained(path)
    export_to_huggingface_llama(path, save_path)
    hf = _read_config(save_path)
    hf.update(
        model_type="granite",
        architectures=["GraniteForCausalLM"],
        embedding_multiplier=config.m_emb if config.m_emb is not None else 1,
        residual_multiplier=config.m_residual if config.m_residual is not None else 1,
        logits_scaling=config.m_width if config.m_width is not None else 1,
        attention_multiplier=(
            config.attention_multiplier
            if config.attention_multiplier is not None
            else (config.n_embd // config.n_head) ** -0.5
        ),
    )
    _write_config(hf, save_path)


# ---------------------------------------------------------------------------- MoE families


def import_from_huggingface_mixtral(path: str, save_path: str) -> None:
    """Reference `model_conversion/mixtral.py`: per-expert w1(gate)/w3(up)/w2(down) ->
    stacked [E, *, *] expert banks; gate -> mlp.gate."""
    hf = _read_config(path)
    config_dict = _llama_like_config_to_dolomite(hf)
    config_dict.update(
        model_type="moe_dolomite",
        num_experts=hf["num_local_experts"],
        num_experts_per_tok=hf.get("num_experts_per_tok", 2),
        router_aux_loss_coef=hf.get("router_aux_loss_coef", 0.001),
    )
    config = MoEConfig.from_dict(config_dict)

    manager = SafeTensorsWeightsManager(path)

    def mlp(sd, manager, i):
        hp = f"model.layers.{i}."
        dp = f"transformer.h.{i}."
        sd[dp + "mlp.gate.weight"] = manager.get_tensor(hp + "block_sparse_moe.gate.weight")
        sd[dp + "mlp.c_fc.weight"] = torch.stack(
            [
                torch.cat(
                    [
                        manager.get_tensor(hp + f"block_sparse_moe.experts.{e}.w3.weight"),
                        manager.get_tensor(hp + f"block_sparse_moe.experts.{e}.w1.weight"),
                    ]
                )
                for e in range(config.num_experts)
            ]
        )
        sd[dp + "mlp.c_proj.weight"] = torch.stack(
            [
                manager.get_tensor(hp + f"block_sparse_moe.experts.{e}.w2.weight")
                for e in range(config.num_experts)
            ]
        )

    sd = _import_backbone(manager, config, mlp)
    _finish_conversion(sd, config_dict, path, save_path)


def export_to_huggingface_mixtral(path: str, save_path: str) -> None:
    config = MoEConfig.from_pretrained(path)
    hf_config = _dolomite_config_to_llama_like(config)
    hf_config.update(
        model_type="mixtral",
        architectures=["MixtralForCausalLM"],
        num_local_experts=config.num_experts,
        num_experts_per_tok=config.num_experts_per_tok,
        router_aux_loss_coef=config.router_aux_loss_coef,
    )

    manager = SafeTensorsWeightsManager(path)

    def mlp(sd, manager, i):
        hp = f"model.layers.{i}."
        dp = f"transformer.h.{i}."
        sd[hp + "block_sparse_moe.gate.weight"] = manager.get_tensor(dp + "mlp.gate.weight")
        c_fc = manager.get_tensor(dp + "mlp.c_fc.weight")
        c_proj = manager.get_tensor(dp + "mlp.c_proj.weight")
        for e in range(config.num_experts):
            up, gate = c_fc[e].chunk(2)
            sd[hp + f"block_sparse_moe.experts.{e}.w3.weight"] = up
            sd[hp + f"block_sparse_moe.experts.{e}.w1.weight"] = gate
            sd[hp + f"block_sparse_moe.experts.{e}.w2.weight"] = c_proj[e]

    sd = _export_backbone(manager, config, mlp)
    _finish_conversion(sd, hf_config, path, save_path)


def import_from_huggingface_granitemoe(path: str, save_path: str) -> None:
    """Reference `model_conversion/granitemoe.py`: router.layer -> mlp.gate; fused
    input_linear [E, [gate; up], H] halves swapped to [up; gate]; + granite µP knobs."""
    hf = _read_config(path)
    config_dict = _llama_like_config_to_dolomite(hf)
    config_dict.update(
        model_type="moe_dolomite",
        num_experts=hf["num_local_experts"],
        num_experts_per_tok=hf.get("num_experts_per_tok", 2),
        router_aux_loss_coef=hf.get("router_aux_loss_coef", 0.001),
        m_emb=_none_if(hf.get("embedding_multiplier", 1), 1),
        m_residual=_none_if(hf.get("residual_multiplier", 1), 1),
        m_width=_none_if(hf.get("logits_scaling", 1), 1),
        attention_multiplier=hf.get("attention_multiplier"),
    )
    config = MoEConfig.from_dict(config_dict)

    manager = SafeTensorsWeightsManager(path)

    def mlp(sd, manager, i):
        hp = f"model.layers.{i}."
        dp = f"transformer.h.{i}."
        sd[dp + "mlp.gate.weight"] = manager.get_tensor(hp + "block_sparse_moe.router.layer.weight")
        sd[dp + "mlp.c_fc.weight"] = _swap_glu_halves(
            manager.get_tensor(hp + "block_sparse_moe.input_linear.weight")
        )
        sd[dp + "mlp.c_proj.weight"] = manager.get_tensor(hp + "block_sparse_moe.output_linear.weight")

    sd = _import_backbone(manager, config, mlp)
    _finish_conversion(sd, config_dict, path, save_path)


def export_to_huggingface_granitemoe(path: str, save_path: str) -> None:
    config = MoEConfig.from_pretrained(path)
    hf_config = _dolomite_config_to_llama_like(config)
    hf_config.update(
        model_type="granitemoe",
        architectures=["GraniteMoeForCausalLM"],
        num_local_experts=config.num_experts,
        num_experts_per_tok=config.num_experts_per_tok,
        router_aux_loss_coef=config.router_aux_loss_coef,
        embedding_multiplier=config.m_emb if config.m_emb is not None else 1,
        residual_multiplier=config.m_residual if config.m_residual is not None else 1,
        logits_scaling=config.m_width if config.m_width is not None else 1,
        attention_multiplier=(
            config.attention_multiplier
            if config.attention_multiplier is not None
            else (config.n_embd // config.n_head) ** -0.5
        ),
    )

    manager = SafeTensorsWeightsManager(path)

    def mlp(sd, manager, i):
        hp = f"model.layers.{i}."
        dp = f"transformer.h.{i}."
        sd[hp + "block_sparse_moe.router.layer.weight"] = manager.get_tensor(dp + "mlp.gate.weight")
        sd[hp + "block_sparse_moe.input_linear.weight"] = _swap_glu_halves(
            manager.get_tensor(dp + "mlp.c_fc.weight")
        )
        sd[hp + "block_sparse_moe.output_linear.weight"] = manager.get_tensor(dp + "mlp.c_proj.weight")

    sd = _export_backbone(manager, config, mlp)
    _finish_conversion(sd, hf_config, path, save_path)


# ---------------------------------------------------------------------------- bigcode


def import_from_huggingface_bigcode(path: str, save_path: str) -> None:
    """Reference `model_conversion/bigcode.py`: weights are layout-identical (fused mqa/mha
    c_attn, learned positions); only the config is rewritten."""
    hf = _read_config(path)
    assert hf.get("activation_function", "gelu_pytorch_tanh") in ("gelu_pytorch_tanh", "gelu")
    config_dict = dict(
        model_type="gpt_dolomite",
        vocab_size=hf["vocab_size"],
        n_positions=hf["n_positions"],
        n_embd=hf["n_embd"],
        n_layer=hf["n_layer"],
        n_head=hf["n_head"],
        attention_head_type="mqa" if hf.get("multi_query", True) else "mha",
        position_embedding_type="learned_absolute",
        n_inner=hf.get("n_inner"),
        activation_function=hf.get("activation_function", "gelu_pytorch_tanh"),
        normalization_function="layernorm",
        layer_norm_epsilon=hf.get("layer_norm_epsilon", 1e-5),
        use_cache=hf.get("use_cache", True),
        add_bias=True,
        tie_word_embeddings=hf.get("tie_word_embeddings", True),
        initializer_range=hf.get("initializer_range", 0.02),
        attn_pdrop=hf.get("attn_pdrop", 0.1),
        resid_pdrop=hf.get("resid_pdrop", 0.1),
        embd_pdrop=hf.get("embd_pdrop", 0.1),
        bos_token_id=hf.get("bos_token_id"),
        eos_token_id=hf.get("eos_token_id"),
        pad_token_id=hf.get("pad_token_id"),
    )
    CommonConfig.from_dict(config_dict)  # validate

    os.makedirs(save_path, exist_ok=True)
    manager = SafeTensorsWeightsManager(path)
    SafeTensorsWeightsManager.save_state_dict(manager.state_dict(), save_path)
    _write_config(config_dict, save_path)
    _copy_tokenizer_files(path, save_path)


def export_to_huggingface_bigcode(path: str, save_path: str) -> None:
    config = CommonConfig.from_pretrained(path)
    assert config.activation_function in ("gelu_pytorch_tanh", "gelu")
    assert config.normalization_function == "layernorm"
    assert config.position_embedding_type == "learned_absolute"
    assert AttentionHeadType(config.attention_head_type) in (
        AttentionHeadType.mqa,
        AttentionHeadType.mha,
    )
    hf_config = dict(
        model_type="gpt_bigcode",
        architectures=["GPTBigCodeForCausalLM"],
        vocab_size=config.vocab_size,
        n_positions=config.n_positions,
        n_embd=config.n_embd,
        n_layer=config.n_layer,
        n_head=config.n_head,
        multi_query=config.attention_head_type == "mqa",
        n_inner=config.n_inner,
        activation_function=config.activation_function,
        layer_norm_epsilon=config.layer_norm_epsilon,
        use_cache=config.use_cache,
        tie_word_embeddings=config.tie_word_embeddings,
        initializer_range=config.initializer_range,
        attn_pdrop=config.attn_pdrop,
        resid_pdrop=config.resid_pdrop,
        embd_pdrop=config.embd_pdrop,
        bos_token_id=config.bos_token_id,
        eos_token_id=config.eos_token_id,
        pad_token_id=config.pad_token_id,
    )

    os.makedirs(save_path, exist_ok=True)
    manager = SafeTensorsWeightsManager(path)
    SafeTensorsWeightsManager.save_state_dict(manager.state_dict(), save_path)
    _write_config(hf_config, save_path)
    _copy_tokenizer_files(path, save_path)


# ---------------------------------------------------------------------------- t5 / flan-t5


def _t5_act_name(hf: dict) -> str:
    """HF feed_forward_proj/dense_act_fn -> this framework's activation registry name."""
    proj = hf.get("feed_forward_proj", "relu")
    gated = proj.startswith("gated-") or hf.get("is_gated_act", False)
    base = hf.get("dense_act_fn") or (proj[len("gated-"):] if gated else proj)
    if base == "gelu" and proj == "gated-gelu":
        # T5Config backward-compat special case: old v1.1 configs say "gated-gelu" with no
        # dense_act_fn key, and HF resolves that to gelu_new (tanh), NOT exact gelu
        base = "gelu_new"
    base = {"gelu_new": "gelu_pytorch_tanh", "silu": "swish"}.get(base, base)
    if not gated:
        return base
    return {"gelu": "geglu", "relu": "reglu", "swish": "swiglu"}.get(base, base + "_glu")


def _t5_config_to_dolomite(hf: dict) -> dict:
    """HF T5Config -> EncDecDolomiteConfig dict. Weight-exact architecture map: bucketed
    relative bias (shared per stack), rmsnorm, no biases, unscaled attention (T5 folds the
    1/sqrt(d) into its init), and — tied only (t5 v1.0) — the d_model**-0.5 logit scale
    expressed as m_width = sqrt(d_model). v1.1/flan checkpoints untie the head and drop the
    scale, which maps to tie_word_embeddings=False / m_width=None."""
    num_heads = hf["num_heads"]
    d_kv = hf.get("d_kv", hf["d_model"] // num_heads)
    tied = hf.get("tie_word_embeddings", True)
    return dict(
        model_type="enc_dec_dolomite",
        vocab_size=hf["vocab_size"],
        # T5 has no absolute position table; n_positions only sizes caches/buffers here.
        # 512 is the family's training length (HF tokenizer model_max_length)
        n_positions=hf.get("n_positions", 512),
        n_embd=hf["d_model"],
        n_layer=hf.get("num_decoder_layers") or hf["num_layers"],
        n_encoder_layer=hf["num_layers"],
        n_head=num_heads,
        num_key_value_heads=num_heads,
        attention_head_type="mha",
        attention_head_dim=_none_if(d_kv, hf["d_model"] // num_heads),
        position_embedding_type="relative_bucketed",
        relative_attention_num_buckets=hf.get("relative_attention_num_buckets", 32),
        relative_attention_max_distance=hf.get("relative_attention_max_distance", 128),
        n_inner=hf["d_ff"],
        activation_function=_t5_act_name(hf),
        normalization_function="rmsnorm",
        layer_norm_epsilon=hf.get("layer_norm_epsilon", 1e-6),
        use_cache=hf.get("use_cache", True),
        add_bias=False,
        tie_word_embeddings=tied,
        attention_multiplier=1.0,
        m_width=math.sqrt(hf["d_model"]) if tied else None,
        initializer_range=hf.get("initializer_factor", 1.0) * 0.02,
        attn_pdrop=hf.get("dropout_rate", 0.1),
        resid_pdrop=hf.get("dropout_rate", 0.1),
        embd_pdrop=hf.get("dropout_rate", 0.1),
        bos_token_id=hf.get("bos_token_id"),
        eos_token_id=hf.get("eos_token_id", 1),
        pad_token_id=hf.get("pad_token_id", 0),
        decoder_start_token_id=hf.get("decoder_start_token_id", hf.get("pad_token_id", 0)),
    )


def import_from_huggingface_t5(path: str, save_path: str) -> None:
    """Import HF t5 / flan-t5 (`T5ForConditionalGeneration`) into enc_dec_dolomite.

    Closes the reference's last seq2seq user journey (`arguments.py:72-76` loads any
    `AutoModelForSeq2SeqLM`): `model_name: google/flan-t5-small` now finetunes natively.
    Per-stack mapping (all weight-exact; torch [out, in] layout kept by weights.py):
      layer.0.SelfAttention q|k|v -> flat-fused attn.c_attn, o -> attn.c_proj
      layer.1.EncDecAttention q -> cross_attn.c_q, k|v -> fused cross_attn.c_kv, o -> c_proj
      DenseReluDense wi -> mlp.c_fc (gated: [wi_1 (up) | wi_0 (gate)] matching the GLU
      up-first fused layout, ops/activations.py), wo -> mlp.c_proj
      block.0's relative_attention_bias -> the stack-level relative_bias table
      final_layer_norm -> final_layernorm; shared.weight / lm_head.weight as configured.
    """
    hf = _read_config(path)
    config_dict = _t5_config_to_dolomite(hf)
    from ..models import config_from_dict

    config = config_from_dict(config_dict)  # validate
    gated = is_glu(config.activation_function)

    manager = SafeTensorsWeightsManager(path)
    get = manager.get_tensor
    sd: dict[str, torch.Tensor] = {"shared.weight": get("shared.weight")}
    if not config.tie_word_embeddings:
        sd["lm_head.weight"] = get("lm_head.weight")

    for stack, n in (("encoder", config.n_encoder_layer), ("decoder", config.n_layer)):
        sd[f"{stack}.relative_bias.weight"] = get(
            f"{stack}.block.0.layer.0.SelfAttention.relative_attention_bias.weight"
        )
        sd[f"{stack}.final_layernorm.weight"] = get(f"{stack}.final_layer_norm.weight")
        for i in range(n):
            src = f"{stack}.block.{i}.layer."
            dst = f"{stack}.block.{i}."
            attn = src + "0.SelfAttention."
            sd[dst + "attn.c_attn.weight"] = torch.cat(
                [get(attn + "q.weight"), get(attn + "k.weight"), get(attn + "v.weight")], dim=0
            )
            sd[dst + "attn.c_proj.weight"] = get(attn + "o.weight")
            sd[dst + "ln_1.weight"] = get(src + "0.layer_norm.weight")

            mlp_idx = 1
            if stack == "decoder":
                cross = src + "1.EncDecAttention."
                sd[dst + "cross_attn.c_q.weight"] = get(cross + "q.weight")
                sd[dst + "cross_attn.c_kv.weight"] = torch.cat(
                    [get(cross + "k.weight"), get(cross + "v.weight")], dim=0
                )
                sd[dst + "cross_attn.c_proj.weight"] = get(cross + "o.weight")
                sd[dst + "ln_cross.weight"] = get(src + "1.layer_norm.weight")
                mlp_idx = 2

            mlp = src + f"{mlp_idx}.DenseReluDense."
            if gated:
                # T5 gated MLP: act(wi_0) * wi_1 -> fused [up | gate] = [wi_1 | wi_0]
                sd[dst + "mlp.c_fc.weight"] = torch.cat(
                    [get(mlp + "wi_1.weight"), get(mlp + "wi_0.weight")], dim=0
                )
            else:
                sd[dst + "mlp.c_fc.weight"] = get(mlp + "wi.weight")
            sd[dst + "mlp.c_proj.weight"] = get(mlp + "wo.weight")
            sd[dst + "ln_2.weight"] = get(src + f"{mlp_idx}.layer_norm.weight")

    _finish_conversion(sd, config_dict, path, save_path)


def export_to_huggingface_t5(path: str, save_path: str) -> None:
    """enc_dec_dolomite -> HF t5 layout (inverse of `import_from_huggingface_t5`; only
    configs the T5 architecture can express)."""
    from ..models import config_from_dict

    config = config_from_dict(_read_config(path))
    assert config.position_embedding_type == "relative_bucketed"
    assert config.normalization_function == "rmsnorm" and not config.add_bias
    assert AttentionHeadType(config.attention_head_type) == AttentionHeadType.mha
    # T5 math the HF class applies UNCONDITIONALLY: no softmax scale (folded into init),
    # and — tied only — the d_model**-0.5 logit rescale. A config with different values
    # would export bit-exact weights that compute different outputs.
    assert config.attention_multiplier == 1.0, (
        "T5 attention is unscaled; export requires attention_multiplier=1.0 "
        f"(got {config.attention_multiplier})"
    )
    if config.tie_word_embeddings:
        assert config.m_width is not None and abs(config.m_width - math.sqrt(config.n_embd)) < 1e-6, (
            "tied-head T5 rescales logits by d_model**-0.5; export requires "
            f"m_width=sqrt(n_embd) (got {config.m_width})"
        )
    else:
        assert config.m_width is None, (
            f"untied T5 applies no logit scale; export requires m_width=None (got {config.m_width})"
        )
    gated = is_glu(config.activation_function)
    base = {
        "geglu": "gelu",
        "reglu": "relu",
        "swiglu": "silu",
        "gelu_pytorch_tanh_glu": "gelu_new",
        "gelu_pytorch_tanh": "gelu_new",
    }.get(config.activation_function, config.activation_function)

    hf_config = dict(
        model_type="t5",
        architectures=["T5ForConditionalGeneration"],
        vocab_size=config.vocab_size,
        d_model=config.n_embd,
        d_kv=config.head_dim,
        d_ff=config.n_inner,
        num_layers=config.n_encoder_layer,
        num_decoder_layers=config.n_layer,
        num_heads=config.n_head,
        relative_attention_num_buckets=config.relative_attention_num_buckets,
        relative_attention_max_distance=config.relative_attention_max_distance,
        dropout_rate=config.resid_pdrop,
        layer_norm_epsilon=config.layer_norm_epsilon,
        feed_forward_proj=("gated-" + base) if gated else base,
        dense_act_fn=base,
        is_gated_act=gated,
        use_cache=config.use_cache,
        tie_word_embeddings=config.tie_word_embeddings,
        eos_token_id=config.eos_token_id,
        pad_token_id=config.pad_token_id,
        decoder_start_token_id=config.decoder_start_token_id,
    )

    manager = SafeTensorsWeightsManager(path)
    get = manager.get_tensor
    sd: dict[str, torch.Tensor] = {"shared.weight": get("shared.weight")}
    if not config.tie_word_embeddings:
        sd["lm_head.weight"] = get("lm_head.weight")

    q_dim = config.n_head * config.head_dim
    for stack, n in (("encoder", config.n_encoder_layer), ("decoder", config.n_layer)):
        sd[f"{stack}.block.0.layer.0.SelfAttention.relative_attention_bias.weight"] = get(
            f"{stack}.relative_bias.weight"
        )
        sd[f"{stack}.final_layer_norm.weight"] = get(f"{stack}.final_layernorm.weight")
        for i in range(n):
            src = f"{stack}.block.{i}."
            dst = f"{stack}.block.{i}.layer."
            attn = dst + "0.SelfAttention."
            qkv = get(src + "attn.c_attn.weight")
            sd[attn + "q.weight"] = qkv[:q_dim]
            sd[attn + "k.weight"] = qkv[q_dim : 2 * q_dim]
            sd[attn + "v.weight"] = qkv[2 * q_dim :]
            sd[attn + "o.weight"] = get(src + "attn.c_proj.weight")
            sd[dst + "0.layer_norm.weight"] = get(src + "ln_1.weight")

            mlp_idx = 1
            if stack == "decoder":
                cross = dst + "1.EncDecAttention."
                sd[cross + "q.weight"] = get(src + "cross_attn.c_q.weight")
                kv = get(src + "cross_attn.c_kv.weight")
                sd[cross + "k.weight"] = kv[:q_dim]
                sd[cross + "v.weight"] = kv[q_dim:]
                sd[cross + "o.weight"] = get(src + "cross_attn.c_proj.weight")
                sd[dst + "1.layer_norm.weight"] = get(src + "ln_cross.weight")
                mlp_idx = 2

            mlp = dst + f"{mlp_idx}.DenseReluDense."
            fc = get(src + "mlp.c_fc.weight")
            if gated:
                up, gate = fc.chunk(2, dim=0)
                sd[mlp + "wi_1.weight"] = up
                sd[mlp + "wi_0.weight"] = gate
            else:
                sd[mlp + "wi.weight"] = fc
            sd[mlp + "wo.weight"] = get(src + "mlp.c_proj.weight")
            sd[dst + f"{mlp_idx}.layer_norm.weight"] = get(src + "ln_2.weight")

    _finish_conversion(sd, hf_config, path, save_path)


# ---------------------------------------------------------------------------- dispatch

_MODEL_IMPORT_FUNCTIONS = {
    "gpt_bigcode": import_from_huggingface_bigcode,
    "granite": import_from_huggingface_granite,
    "granitemoe": import_from_huggingface_granitemoe,
    "llama": import_from_huggingface_llama,
    "mixtral": import_from_huggingface_mixtral,
    "t5": import_from_huggingface_t5,
}

_MODEL_EXPORT_FUNCTIONS = {
    "gpt_bigcode": export_to_huggingface_bigcode,
    "granite": export_to_huggingface_granite,
    "granitemoe": export_to_huggingface_granitemoe,
    "llama": export_to_huggingface_llama,
    "mixtral": export_to_huggingface_mixtral,
    "t5": export_to_huggingface_t5,
}


def import_from_huggingface(pretrained_model_name_or_path: str, save_path: str) -> None:
    """Convert the HF checkpoint directory `pretrained_model_name_or_path` into a dolomite
    one at `save_path` (the JAX package's function over a local directory). A directory
    shipping only torch-pickle weights (``pytorch_model*.bin``) is converted to safetensors
    in a staging directory first, removed afterwards."""
    import glob
    import tempfile

    from ..utils.hf_hub import resolve_model_path
    from ..utils.safetensors import torch_bin_to_safetensors

    path = resolve_model_path(pretrained_model_name_or_path)
    model_type = _read_config(path)["model_type"]
    if model_type not in _MODEL_IMPORT_FUNCTIONS:
        raise NotImplementedError(f"the current model_type ({model_type}) is not yet supported")

    has_safetensors = glob.glob(os.path.join(path, "*.safetensors"))
    if not has_safetensors and not glob.glob(os.path.join(path, "pytorch_model*.bin")):
        raise ValueError(
            f"no supported weight format found in '{path}' (expected *.safetensors or pytorch_model*.bin)"
        )
    staging = None
    try:
        if not has_safetensors:
            staging = tempfile.mkdtemp(prefix="dolomite-bin-convert-")
            torch_bin_to_safetensors(path, staging)
            path = staging
        _MODEL_IMPORT_FUNCTIONS[model_type](path, save_path)
    finally:
        if staging is not None:
            shutil.rmtree(staging, ignore_errors=True)


def export_to_huggingface(pretrained_model_name_or_path: str, save_path: str, model_type: str) -> None:
    """Convert the dolomite checkpoint directory `pretrained_model_name_or_path` into an HF
    `model_type` one at `save_path`."""
    if model_type not in _MODEL_EXPORT_FUNCTIONS:
        raise NotImplementedError(f"the current model_type ({model_type}) is not yet supported")
    _MODEL_EXPORT_FUNCTIONS[model_type](pretrained_model_name_or_path, save_path)
