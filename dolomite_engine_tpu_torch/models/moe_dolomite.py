"""MoEDolomite: the sparse mixture-of-experts decoder.

Counterpart of `dolomite_engine_tpu/models/moe_dolomite.py`: `ParameterizedExperts`
(banks ``[E, in, out]``, the JAX layout, so weights carry across without a transpose),
`SparseMoE` (router, top-k routing, the expert MLPs), `SparseMoEBlock` (the pre-norm
block with the residual-fused ``ln_2`` and µP's ``m_residual``), `MoEDolomiteModel` and
`MoEDolomiteForCausalLM` with the load-balancing auxiliary loss.

The expert MLPs always run the grouped-GEMM dispatch (`ops/kernels/moe.experts_grouped`),
as the JAX model does under ``moe_dispatch=pallas``: ``eager``, ``scatter`` and ``auto``
name the same dropless semantics, so they take the same path, and the tensor's device
decides between the CUDA kernels and their plain versions. `ops/moe.experts_eager` is the
plain every-expert reference the tests pin this path against. Expert parallelism (the
all_to_all path and its capacity factor) is not ported: ROADMAP.md Queue A,
'Distribution'.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..enums import AttentionImplementation, normalize_moe_implementation
from ..ops.activations import get_activation_function, is_glu
from ..ops.fp8 import fp8_qdq
from ..ops.kernels.moe import experts_grouped
from ..ops.moe import load_balancing_loss, route
from .config import MoEConfig
from .enums import InitMethod
from .gpt_dolomite import GPTDolomiteForCausalLM, GPTDolomiteModel
from .modeling_utils import Attention, KVCache, ParameterizedLinear, get_norm
from .remat import ATTENTION_OUT_CHECKPOINT_NAME, checkpoint_name


class ParameterizedExperts(nn.Module):
    """Per-expert linear bank: weight ``[E, in, out]`` and bias ``[E, out]`` stored in
    `param_dtype` (default `dtype`), handed to the grouped GEMM in the compute `dtype`."""

    def __init__(
        self,
        num_experts: int,
        in_features: int,
        out_features: int,
        bias: bool,
        std: float,
        dtype: torch.dtype,
        device: torch.device,
        param_dtype: torch.dtype | None = None,
    ) -> None:
        super().__init__()
        self.std = std
        self.dtype = dtype
        param_dtype = param_dtype or dtype
        self.weight = nn.Parameter(
            torch.empty(num_experts, in_features, out_features, dtype=param_dtype, device=device)
        )
        self.bias = (
            nn.Parameter(torch.zeros(num_experts, out_features, dtype=param_dtype, device=device))
            if bias
            else None
        )

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.weight.normal_(0.0, self.std, generator=generator)
        if self.bias is not None:
            self.bias.zero_()

    def banks(self) -> tuple[torch.Tensor, torch.Tensor | None]:
        """(weight, bias) in the compute dtype."""
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return self.weight.to(self.dtype), bias


def _expert_std(config: MoEConfig, depth_scaled: bool) -> float:
    """c_fc: initializer_range; c_proj: initializer_range / sqrt(2 n_layer); µP divides
    both by sqrt(m_width)."""
    std = config.initializer_range
    if depth_scaled:
        std /= math.sqrt(2 * config.n_layer)
    if InitMethod(config.init_method) == InitMethod.mup:
        std /= math.sqrt(config.m_width)
    return std


class SparseMoE(nn.Module):
    """Top-k routed expert MLP: router logits in the compute dtype, routing weights by a
    softmax over the selected logits, and the experts through the grouped GEMMs. In an fp8
    model the tokens and both banks are e4m3 quantize-dequantized after the router (the
    JAX model's `Fp8QDQ` points), and the grouped GEMMs take them in the compute dtype."""

    fp8_qdq_names = ("experts_in", "experts_fc_kernel", "experts_proj_kernel")

    def __init__(
        self,
        config: MoEConfig,
        dtype: torch.dtype,
        device: torch.device,
        param_dtype: torch.dtype | None = None,
        moe_implementation: str = "auto",
        ep_capacity_factor: float | None = None,
    ) -> None:
        super().__init__()
        if normalize_moe_implementation(moe_implementation) not in ("scatter", "eager", "auto"):
            raise ValueError(
                f"unknown moe_implementation '{moe_implementation}' "
                "(expected scatter/scattermoe, eager, or auto)"
            )
        if ep_capacity_factor is not None:
            raise NotImplementedError(
                "ep_capacity_factor belongs to the expert-parallel all_to_all path, which is "
                "not ported yet: ROADMAP.md Queue A, 'Distribution'"
            )
        self.config = config
        self.dtype = dtype
        intermediate = config.n_inner
        self.act = get_activation_function(config.activation_function)
        self.gate = ParameterizedLinear(
            config.n_embd, config.num_experts, False, config.initializer_range, dtype, device,
            param_dtype,
        )
        self.c_fc = ParameterizedExperts(
            config.num_experts, config.n_embd,
            2 * intermediate if is_glu(config.activation_function) else intermediate,
            config.add_bias, _expert_std(config, depth_scaled=False), dtype, device, param_dtype,
        )
        self.c_proj = ParameterizedExperts(
            config.num_experts, intermediate, config.n_embd, config.add_bias,
            _expert_std(config, depth_scaled=True), dtype, device, param_dtype,
        )
        self.fp8 = None

    def forward(
        self, hidden_states: torch.Tensor, deterministic: bool = True
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """(output ``[B, S, d]``, router logits ``[B * S, E]``)."""
        config = self.config
        batch, seq, hidden = hidden_states.shape
        x = hidden_states.reshape(-1, hidden).to(self.dtype)
        router_logits = self.gate(x)
        router_weights, selected_experts = route(router_logits, config.num_experts_per_tok)
        w_fc, b_fc = self.c_fc.banks()
        w_proj, b_proj = self.c_proj.banks()
        if self.fp8 is not None:
            x = fp8_qdq(x, self.fp8, "experts_in")
            w_fc = fp8_qdq(w_fc, self.fp8, "experts_fc_kernel")
            w_proj = fp8_qdq(w_proj, self.fp8, "experts_proj_kernel")
        out = experts_grouped(
            x, router_weights, selected_experts, w_fc, b_fc, w_proj, b_proj, self.act,
            config.num_experts,
        ).reshape(batch, seq, hidden)
        if not deterministic and config.resid_pdrop > 0.0:
            out = F.dropout(out, config.resid_pdrop)
        return out, router_logits


class SparseMoEBlock(nn.Module):
    """Pre-norm block: attention + SparseMoE; returns the router logits as its extra
    output, which the model loop collects for the auxiliary loss."""

    def __init__(
        self,
        config: MoEConfig,
        dtype: torch.dtype,
        device: torch.device,
        param_dtype: torch.dtype | None = None,
        attention_implementation: AttentionImplementation | str = AttentionImplementation.sdpa,
        moe_implementation: str = "auto",
        ep_capacity_factor: float | None = None,
    ) -> None:
        super().__init__()
        self.m_residual = config.m_residual
        self.ln_1 = get_norm(config, device)
        self.attn = Attention(
            config, dtype, device, param_dtype=param_dtype,
            attention_implementation=attention_implementation,
        )
        self.ln_2 = get_norm(config, device)
        self.moe = SparseMoE(config, dtype, device, param_dtype, moe_implementation, ep_capacity_factor)
        self.tag_attention_out = False  # set by the model for the save_attention_out policy

    def forward(
        self,
        hidden_states: torch.Tensor,
        attention_mask: torch.Tensor | None = None,
        rope_cos_sin: tuple[torch.Tensor, torch.Tensor] | None = None,
        alibi_bias: torch.Tensor | None = None,
        kv_cache: KVCache | None = None,
        cache_index: torch.Tensor | int | None = None,
        segment_ids: torch.Tensor | None = None,
        deterministic: bool = True,
    ) -> tuple[torch.Tensor, KVCache | None, torch.Tensor]:
        residual = hidden_states
        h = self.ln_1(hidden_states)
        attn_out, kv_cache = self.attn(
            h,
            attention_mask=attention_mask,
            rope_cos_sin=rope_cos_sin,
            alibi_bias=alibi_bias,
            kv_cache=kv_cache,
            cache_index=cache_index,
            segment_ids=segment_ids,
            deterministic=deterministic,
        )
        if self.m_residual is not None:
            attn_out = attn_out * self.m_residual
        if self.tag_attention_out:
            attn_out = checkpoint_name(attn_out, ATTENTION_OUT_CHECKPOINT_NAME)
        h, hidden_states = self.ln_2(attn_out, residual=residual)
        moe_out, router_logits = self.moe(h, deterministic=deterministic)
        if self.m_residual is not None:
            moe_out = moe_out * self.m_residual
        return hidden_states + moe_out, kv_cache, router_logits

    def jax_module_params(self, tree):
        """(flax subtree, module) pairs of this block's ``h_<i>`` params."""
        yield tree["ln_1"], self.ln_1
        yield tree["attn"]["c_attn"], self.attn.c_attn
        yield tree["attn"]["c_proj"], self.attn.c_proj
        yield tree["ln_2"], self.ln_2
        yield tree["moe"]["gate"], self.moe.gate
        yield tree["moe"]["c_fc"], self.moe.c_fc
        yield tree["moe"]["c_proj"], self.moe.c_proj


class MoEDolomiteModel(GPTDolomiteModel):
    """The decoder stack with SparseMoE blocks."""

    block_cls = SparseMoEBlock


class MoEDolomiteForCausalLM(GPTDolomiteForCausalLM):
    """Causal LM with the load-balancing auxiliary loss, scaled by
    ``router_aux_loss_coef`` and added to the LM loss. Takes `SparseMoEBlock`'s
    ``moe_implementation`` and ``ep_capacity_factor`` as keyword arguments."""

    model_type = "moe_dolomite"
    base_model_cls = MoEDolomiteModel

    def compute_aux_loss(
        self,
        extras: list[torch.Tensor],
        attention_mask: torch.Tensor | None,
        segment_ids: torch.Tensor | None,
    ) -> torch.Tensor | None:
        config = self.config
        if not extras or config.router_aux_loss_coef == 0:
            return None
        all_logits = torch.cat(extras, dim=0)  # [L * T, E]
        token_mask = None
        if attention_mask is not None:
            token_mask = attention_mask.reshape(-1).bool()
        elif segment_ids is not None:
            token_mask = (segment_ids != 0).reshape(-1)
        if token_mask is not None:
            token_mask = token_mask.repeat(len(extras))
        aux = load_balancing_loss(
            all_logits, config.num_experts, config.num_experts_per_tok, token_mask=token_mask,
            group=self.data_parallel_group,
        )
        return config.router_aux_loss_coef * aux
