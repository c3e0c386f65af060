"""GPTCrossLayer: cross-layer KV sharing (CLA).

Counterpart of `dolomite_engine_tpu/models/gpt_crosslayer.py`. ``sharing_pattern[i]`` is
the layer whose K/V layer i attends with; consecutive equal entries form one KV group.
A `CrossLayerGroup` is one block of the stack: its `KeyValueProjection` (own pre-norm,
``kv_attn`` laid out ``[k_i | v_i]`` a KV head) computes K/V once, rotates K and writes
the group's one cache, and each of its sub-layers runs query-only attention (``q_attn``,
rope on the query) and an MLP. The model has one block and one KV cache a group, which
is the memory CLA saves; `init_kv_caches` is the base class's, one cache a block.

As in JAX, the group attends through `ops/attention.attention` over `update_kv_cache`'s
view (a paged pool: the gather path), never through the paged decode / prefill kernels,
which JAX gates inside `modeling_utils.Attention` only; without a cache (training) that
dispatch runs the flash kernel. Rope is the plain `apply_rotary_pos_emb`, as in JAX.
`convert_gpt_dolomite_to_gpt_crosslayer` builds the cross-layer model of a dense one:
every layer keeps its query projection, MLP and norms, and a group's K/V projection
takes its parent layer's K/V rows of ``c_attn`` and the parent's ``ln_1``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..enums import AttentionImplementation
from ..ops.attention import attention
from ..ops.rope import apply_rotary_pos_emb
from .config import CommonConfig, GPTCrossLayerConfig
from .gpt_dolomite import GPTDolomiteForCausalLM, GPTDolomiteModel
from .modeling_utils import (
    MLP,
    KVCache,
    ParameterizedLinear,
    _init_std,
    cache_attention_view,
    get_norm,
    get_softmax_scale,
)


def group_layout(sharing_pattern: list[int]) -> list[int]:
    """The sub-layer count of each KV group: consecutive equal entries form one group."""
    sizes: list[int] = []
    for i, target in enumerate(sharing_pattern):
        if i == 0 or target != sharing_pattern[i - 1]:
            sizes.append(1)
        else:
            sizes[-1] += 1
    return sizes


class KeyValueProjection(nn.Module):
    """A group's pre-norm K/V projection; ``kv_attn`` emits ``[k_i (D) | v_i (D)]`` for
    each KV head i."""

    def __init__(self, config, dtype, device, param_dtype=None):
        super().__init__()
        self.num_kv_heads = config.num_key_value_heads
        self.head_dim = config.head_dim
        self.ln = get_norm(config, device)
        self.kv_attn = ParameterizedLinear(
            config.n_embd, 2 * self.num_kv_heads * self.head_dim, config.add_bias,
            config.initializer_range, dtype, device, param_dtype,
        )

    def forward(self, hidden_states: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        batch, seq = hidden_states.shape[:2]
        kv = self.kv_attn(self.ln(hidden_states)).reshape(batch, seq, self.num_kv_heads, 2 * self.head_dim)
        key, value = kv.chunk(2, dim=-1)
        # dense [H, D] rows: the flash kernel takes token-strided views of those only
        return key.contiguous(), value.contiguous()


class CrossLayerAttention(nn.Module):
    """Query-only attention against the group's K/V."""

    def __init__(self, config, dtype, device, param_dtype=None, attention_implementation=AttentionImplementation.sdpa):
        super().__init__()
        self.config = config
        self.attention_implementation = AttentionImplementation(attention_implementation)
        self.num_heads = config.n_head
        self.head_dim = config.head_dim
        self.q_attn = ParameterizedLinear(
            config.n_embd, self.num_heads * self.head_dim, config.add_bias,
            _init_std(config, depth_scaled=False), dtype, device, param_dtype,
        )
        self.c_proj = ParameterizedLinear(
            self.num_heads * self.head_dim, config.n_embd, config.add_bias,
            _init_std(config, depth_scaled=True), dtype, device, param_dtype,
        )

    def forward(self, hidden_states, key, value, attention_mask, segment_ids, rope_cos_sin, alibi_bias, query_offset, deterministic):
        config = self.config
        batch, seq = hidden_states.shape[:2]
        query = self.q_attn(hidden_states).reshape(batch, seq, self.num_heads, self.head_dim)
        if rope_cos_sin is not None:
            query = apply_rotary_pos_emb(query, *rope_cos_sin)
        dropout = 0.0 if deterministic else config.attn_pdrop
        out = attention(
            query, key, value, causal=True, softmax_scale=get_softmax_scale(config, self.head_dim),
            attention_mask=attention_mask, softmax_in_fp32=config.attention_softmax_in_fp32,
            query_offset=query_offset, implementation=self.attention_implementation,
            segment_ids=segment_ids, dropout=dropout, alibi_bias=alibi_bias,
        )
        out = self.c_proj(out.reshape(batch, seq, -1))
        if not deterministic and config.resid_pdrop > 0.0:
            out = F.dropout(out, config.resid_pdrop)
        return out


class CrossLayer(nn.Module):
    """One sub-layer of a group: pre-norm query-only attention, then the pre-norm MLP."""

    def __init__(self, config, dtype, device, param_dtype=None, attention_implementation=AttentionImplementation.sdpa):
        super().__init__()
        self.ln_1 = get_norm(config, device)
        self.attn = CrossLayerAttention(config, dtype, device, param_dtype, attention_implementation)
        self.ln_2 = get_norm(config, device)
        self.mlp = MLP(config, dtype, device, param_dtype)


class CrossLayerGroup(nn.Module):
    """One KV group: the shared `KeyValueProjection` and its sub-layers. Takes `Block`'s
    arguments; `kv_cache` is the group's one cache. `tag_attention_out` is carried for
    `set_remat` and unused: the JAX group tags no attention output."""

    def __init__(
        self,
        config: GPTCrossLayerConfig,
        dtype: torch.dtype,
        device: torch.device,
        param_dtype: torch.dtype | None = None,
        attention_implementation: AttentionImplementation | str = AttentionImplementation.sdpa,
        num_sublayers: int = 1,
    ):
        super().__init__()
        self.config = config
        self.kv_proj = KeyValueProjection(config, dtype, device, param_dtype)
        self.layers = nn.ModuleList(
            CrossLayer(config, dtype, device, param_dtype, attention_implementation) for _ in range(num_sublayers)
        )
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
        m_residual = self.config.m_residual
        joint_residual = hidden_states if self.config.joint_residual_stream else None
        key, value = self.kv_proj(hidden_states)
        if rope_cos_sin is not None:
            key = apply_rotary_pos_emb(key, *rope_cos_sin)
        query_offset = 0
        if kv_cache is not None:
            key, value, attention_mask, query_offset = cache_attention_view(
                key, value, kv_cache, cache_index, attention_mask
            )
        for layer in self.layers:
            residual = hidden_states
            attn_out = layer.attn(
                layer.ln_1(hidden_states), key, value, attention_mask, segment_ids, rope_cos_sin,
                alibi_bias, query_offset, deterministic,
            )
            if m_residual is not None:
                attn_out = attn_out * m_residual
            hidden_states = residual + attn_out
            if joint_residual is not None:
                hidden_states = hidden_states + joint_residual
            residual = hidden_states
            mlp_out = layer.mlp(layer.ln_2(hidden_states), deterministic=deterministic)
            if m_residual is not None:
                mlp_out = mlp_out * m_residual
            hidden_states = residual + mlp_out
        return hidden_states, kv_cache

    def jax_module_params(self, tree):
        """(flax subtree, module) pairs of this group's ``h_<g>`` params."""
        yield tree["kv_proj"]["ln"], self.kv_proj.ln
        yield tree["kv_proj"]["kv_attn"], self.kv_proj.kv_attn
        for i, layer in enumerate(self.layers):
            yield tree[f"layers_{i}_ln_1"], layer.ln_1
            yield tree[f"layers_{i}_attn"]["q_attn"], layer.attn.q_attn
            yield tree[f"layers_{i}_attn"]["c_proj"], layer.attn.c_proj
            yield tree[f"layers_{i}_ln_2"], layer.ln_2
            yield tree[f"layers_{i}_mlp"]["c_fc"], layer.mlp.c_fc
            yield tree[f"layers_{i}_mlp"]["c_proj"], layer.mlp.c_proj


class GPTCrossLayerModel(GPTDolomiteModel):
    """The decoder stack of KV groups: one block a group."""

    block_cls = CrossLayerGroup

    @property
    def num_blocks(self) -> int:
        return len(group_layout(self.config.sharing_pattern))

    def _make_block(self, i, dtype, device, param_dtype, attention_implementation, **block_kwargs):
        return CrossLayerGroup(
            self.config, dtype, device, param_dtype, attention_implementation,
            num_sublayers=group_layout(self.config.sharing_pattern)[i], **block_kwargs,
        )


class GPTCrossLayerForCausalLM(GPTDolomiteForCausalLM):
    """The causal LM over the cross-layer stack; `init_kv_caches` gives one cache a KV
    group."""

    model_type = "gpt_crosslayer"
    base_model_cls = GPTCrossLayerModel


@torch.no_grad()
def convert_gpt_dolomite_to_gpt_crosslayer(
    model: GPTDolomiteForCausalLM, sharing_pattern: list[int] | None = None
) -> GPTCrossLayerForCausalLM:
    """The cross-layer model of the dense `model` (the JAX package's converter on the port's
    modules), in its dtypes and on its device. Each layer keeps its query rows of
    ``c_attn``, its ``c_proj``, MLP and norms; a group's ``kv_proj`` takes the parent
    layer's (``sharing_pattern[j] == j``, which need not be the group's first layer) K/V
    rows of ``c_attn``, regrouped ``[k_i | v_i]`` a KV head, and its ``ln_1``. Under the
    identity pattern the result computes the dense model's logits."""
    config: CommonConfig = model.config
    cl_config = GPTCrossLayerConfig.from_dict(
        dict(config.to_dict(), model_type="gpt_crosslayer", sharing_pattern=sharing_pattern)
    )
    layer = model.transformer.h[0]
    out = GPTCrossLayerForCausalLM(
        cl_config, dtype=model.dtype, device="meta", param_dtype=layer.attn.c_attn.weight.dtype,
        attention_implementation=layer.attn.attention_implementation,
    ).to_empty(device=model.device)
    src, dst = model.transformer, out.transformer
    dst.wte.weight.copy_(src.wte.weight)
    if src.wpe is not None:
        dst.wpe.weight.copy_(src.wpe.weight)
    dst.ln_f.load_state_dict(src.ln_f.state_dict())
    if model.lm_head is not None:
        out.lm_head.load_state_dict(model.lm_head.state_dict())

    hkv, head_dim = config.num_key_value_heads, config.head_dim
    nq, nkv = config.n_head * head_dim, hkv * head_dim

    def regroup(rows):  # c_attn's [K | V] rows -> [k_0 | v_0 | k_1 | v_1 ...]
        k = rows[nq : nq + nkv].reshape(hkv, head_dim, *rows.shape[1:])
        v = rows[nq + nkv :].reshape(hkv, head_dim, *rows.shape[1:])
        return torch.cat([k, v], dim=1).reshape(2 * nkv, *rows.shape[1:])

    places = [(g, i) for g, size in enumerate(group_layout(cl_config.sharing_pattern)) for i in range(size)]
    for j, (g, i) in enumerate(places):
        block, group = src.h[j], dst.h[g]
        sub = group.layers[i]
        c_attn = block.attn.c_attn
        sub.attn.q_attn.weight.copy_(c_attn.weight[:nq])
        if c_attn.bias is not None:
            sub.attn.q_attn.bias.copy_(c_attn.bias[:nq])
        sub.attn.c_proj.load_state_dict(block.attn.c_proj.state_dict())
        sub.ln_1.load_state_dict(block.ln_1.state_dict())
        sub.ln_2.load_state_dict(block.ln_2.state_dict())
        sub.mlp.load_state_dict(block.mlp.state_dict())
        if cl_config.sharing_pattern[j] == j:  # the parent gives its group's K/V projection
            group.kv_proj.ln.load_state_dict(block.ln_1.state_dict())
            group.kv_proj.kv_attn.weight.copy_(regroup(c_attn.weight))
            if c_attn.bias is not None:
                group.kv_proj.kv_attn.bias.copy_(regroup(c_attn.bias))
    return out.train(model.training)

