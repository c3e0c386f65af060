"""DenseMoE: dense training, sparse inference.

Counterpart of `dolomite_engine_tpu/models/dense_moe.py`:

- `DenseMoEMLP`: one wide MLP (``c_fc`` of ``num_experts * n_inner``) whose activation
  is scaled by each expert's soft routing weight, repeated over that expert's
  ``n_inner`` columns;
- `DenseMoA`: mixture of attention, one KV head an expert, each expert's group of query
  heads scaled by its routing weight after attention;
- `mask_probability`: inference-time sparsification of the routing weights (a
  threshold, or the top k with the rest at zero, not renormalised).

Training is dense (every expert sees every token), so there is no auxiliary loss and no
grouped GEMM: the MLP is one dense product. ``inference_method`` (None, ``{"top_k": k}``
or ``{"threshold": t}``) is a constructor argument of `DenseMoEForCausalLM` that every
block takes. As in JAX, `DenseMoA` rotates with the plain `apply_rotary_pos_emb` and
attends through `ops/attention.attention` over `update_kv_cache`'s view (a paged pool:
the gather path), never through the paged decode / prefill kernels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..enums import AttentionImplementation
from ..ops.activations import get_activation_function, is_glu
from ..ops.attention import attention
from ..ops.rope import apply_rotary_pos_emb
from .config import DenseMoEConfig
from .gpt_dolomite import GPTDolomiteForCausalLM, GPTDolomiteModel
from .modeling_utils import (
    KVCache,
    ParameterizedLinear,
    _init_std,
    cache_attention_view,
    get_norm,
    get_softmax_scale,
)


def mask_probability(p: torch.Tensor, inference_method: dict | None) -> torch.Tensor:
    """Routing weights `p` ``[..., E]`` under `inference_method`: None keeps them, a
    ``threshold`` zeroes those below it, a ``top_k`` zeroes those below the k-th best."""
    if inference_method is None:
        return p
    top_k = inference_method.get("top_k")
    threshold = inference_method.get("threshold")
    zero = torch.zeros((), dtype=p.dtype, device=p.device)
    if threshold is not None:
        return torch.where(p < threshold, zero, p)
    if top_k is not None:
        kth_best = torch.topk(p, top_k, dim=-1).values[..., -1:]
        return torch.where(p < kth_best, zero, p)
    raise ValueError("unexpected inference_method")


def _gate(config, dtype, device, param_dtype) -> ParameterizedLinear:
    return ParameterizedLinear(
        config.n_embd, config.num_experts, False, config.initializer_range, dtype, device, param_dtype
    )


def soft_routing(gate: ParameterizedLinear, hidden_states: torch.Tensor, inference_method: dict | None) -> torch.Tensor:
    """The experts' weights ``[..., E]``: a softmax of the gate's logits in fp32, cast to
    the logits' dtype, then masked by `inference_method`."""
    logits = gate(hidden_states)
    weights = torch.softmax(logits.float(), dim=-1).to(logits.dtype)
    return mask_probability(weights, inference_method)


class DenseMoEMLP(nn.Module):
    def __init__(self, config: DenseMoEConfig, dtype, device, param_dtype=None, inference_method: dict | None = None):
        super().__init__()
        self.config = config
        self.inference_method = inference_method
        wide = config.num_experts * config.n_inner
        self.c_fc = ParameterizedLinear(
            config.n_embd, 2 * wide if is_glu(config.activation_function) else wide, config.add_bias,
            _init_std(config, depth_scaled=False), dtype, device, param_dtype,
        )
        self.c_proj = ParameterizedLinear(
            wide, config.n_embd, config.add_bias, _init_std(config, depth_scaled=True), dtype, device, param_dtype
        )
        self.gate = _gate(config, dtype, device, param_dtype)
        self.act = get_activation_function(config.activation_function)

    def forward(self, hidden_states: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        routing = soft_routing(self.gate, hidden_states, self.inference_method)  # [B, S, E]
        routing = routing.repeat_interleave(self.config.n_inner, dim=-1)  # [B, S, E * I]
        h = self.act(self.c_fc(hidden_states))
        h = self.c_proj(h * routing.to(h.dtype))
        if not deterministic and self.config.resid_pdrop > 0.0:
            h = F.dropout(h, self.config.resid_pdrop)
        return h


class DenseMoA(nn.Module):
    """Mixture of attention: ``c_attn`` emits ``[Q (H*D) | K (E*D) | V (E*D)]``."""

    def __init__(
        self,
        config: DenseMoEConfig,
        dtype,
        device,
        param_dtype=None,
        attention_implementation=AttentionImplementation.sdpa,
        inference_method: dict | None = None,
    ):
        super().__init__()
        self.config = config
        self.inference_method = inference_method
        self.attention_implementation = AttentionImplementation(attention_implementation)
        self.num_heads, self.num_experts, self.head_dim = config.n_head, config.num_experts, config.head_dim
        self.c_attn = ParameterizedLinear(
            config.n_embd, (self.num_heads + 2 * self.num_experts) * self.head_dim, config.add_bias,
            _init_std(config, depth_scaled=False), dtype, device, param_dtype,
        )
        self.c_proj = ParameterizedLinear(
            self.num_heads * self.head_dim, config.n_embd, config.add_bias,
            _init_std(config, depth_scaled=True), dtype, device, param_dtype,
        )
        self.gate = _gate(config, dtype, device, param_dtype)

    def forward(
        self, hidden_states, attention_mask=None, rope_cos_sin=None, alibi_bias=None, kv_cache=None,
        cache_index=None, segment_ids=None, deterministic=True,
    ):
        config = self.config
        batch, seq = hidden_states.shape[:2]
        heads, experts, head_dim = self.num_heads, self.num_experts, self.head_dim
        query, key, value = self.c_attn(hidden_states).split(
            [heads * head_dim, experts * head_dim, experts * head_dim], dim=-1
        )
        query = query.reshape(batch, seq, heads, head_dim)
        key = key.reshape(batch, seq, experts, head_dim)
        value = value.reshape(batch, seq, experts, head_dim)
        if rope_cos_sin is not None:
            query = apply_rotary_pos_emb(query, *rope_cos_sin)
            key = apply_rotary_pos_emb(key, *rope_cos_sin)
        query_offset = 0
        if kv_cache is not None:
            key, value, attention_mask, query_offset = cache_attention_view(
                key, value, kv_cache, cache_index, attention_mask
            )
        dropout = 0.0 if deterministic else config.attn_pdrop
        out = attention(
            query, key, value, causal=True, softmax_scale=get_softmax_scale(config, head_dim),
            attention_mask=attention_mask, softmax_in_fp32=config.attention_softmax_in_fp32,
            query_offset=query_offset, implementation=self.attention_implementation,
            segment_ids=segment_ids, dropout=dropout, alibi_bias=alibi_bias,
        )  # [B, S, H, D]
        routing = soft_routing(self.gate, hidden_states, self.inference_method)  # [B, S, E]
        out = out.reshape(batch, seq, experts, heads // experts, head_dim)
        out = (out * routing[..., None, None].to(out.dtype)).reshape(batch, seq, heads * head_dim)
        out = self.c_proj(out)
        if not deterministic and config.resid_pdrop > 0.0:
            out = F.dropout(out, config.resid_pdrop)
        return out, kv_cache


class DenseMoEBlock(nn.Module):
    """Pre-norm block: `DenseMoA`, then `DenseMoEMLP`. Takes `Block`'s arguments;
    `tag_attention_out` is carried for `set_remat` and unused, as the JAX block tags no
    attention output."""

    def __init__(
        self,
        config: DenseMoEConfig,
        dtype: torch.dtype,
        device: torch.device,
        param_dtype: torch.dtype | None = None,
        attention_implementation: AttentionImplementation | str = AttentionImplementation.sdpa,
        inference_method: dict | None = None,
    ):
        super().__init__()
        self.m_residual = config.m_residual
        self.ln_1 = get_norm(config, device)
        self.attn = DenseMoA(config, dtype, device, param_dtype, attention_implementation, inference_method)
        self.ln_2 = get_norm(config, device)
        self.mlp = DenseMoEMLP(config, dtype, device, param_dtype, inference_method)
        self.tag_attention_out = False

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
    ) -> tuple[torch.Tensor, KVCache | None]:
        residual = hidden_states
        attn_out, kv_cache = self.attn(
            self.ln_1(hidden_states), attention_mask, rope_cos_sin, alibi_bias, kv_cache, cache_index,
            segment_ids, deterministic,
        )
        if self.m_residual is not None:
            attn_out = attn_out * self.m_residual
        hidden_states = residual + attn_out
        residual = hidden_states
        mlp_out = self.mlp(self.ln_2(hidden_states), deterministic=deterministic)
        if self.m_residual is not None:
            mlp_out = mlp_out * self.m_residual
        return residual + mlp_out, kv_cache

    def jax_module_params(self, tree):
        """(flax subtree, module) pairs of this block's ``h_<i>`` params."""
        yield tree["ln_1"], self.ln_1
        for name in ("c_attn", "c_proj", "gate"):
            yield tree["attn"][name], getattr(self.attn, name)
        yield tree["ln_2"], self.ln_2
        for name in ("c_fc", "c_proj", "gate"):
            yield tree["mlp"][name], getattr(self.mlp, name)


class DenseMoEModel(GPTDolomiteModel):
    block_cls = DenseMoEBlock


class DenseMoEForCausalLM(GPTDolomiteForCausalLM):
    """The causal LM over DenseMoE blocks; ``inference_method=`` (a keyword argument, like
    every block option) reaches every block's attention and MLP routing."""

    model_type = "dense_moe"
    base_model_cls = DenseMoEModel
