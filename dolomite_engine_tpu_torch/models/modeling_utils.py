"""Shared modules: parameterized linear/embedding, norms, attention, MLP, block.

Counterpart of `dolomite_engine_tpu/models/modeling_utils.py` for serving and training.
The layouts are the JAX package's, so weights carry across unchanged apart from the
transpose of each linear kernel (flax ``[in, out]``, torch ``[out, in]``):

- the fused QKV projection is flat ``[Q (Hq*D) | K (Hkv*D) | V (Hkv*D)]`` for every head
  type;
- the GLU MLP's ``c_fc`` emits ``[up | gate]``;
- dense KV caches are ``[B, max_len, Hkv, D]``; paged KV pools are ``[num_pages,
  page_size, Hkv, D]`` with page 0 as the trash page.

Linear and embedding weights are stored in ``param_dtype`` and cast to the compute
``dtype`` at every use, as the JAX package's flax modules do (it always stores fp32).
Serving builds them directly in the compute dtype (the cast is then a no-op and rounds
identically); training keeps fp32 master weights. Norm weights are always fp32.

Attention dispatch keeps the JAX conditions exactly. The decode kernel runs for a paged
pool with a per-row ``[B]`` cache index and no incoming mask or alibi bias; the
chunked-prefill kernel for a paged pool with a scalar cache index, a 2-D key mask, no
alibi bias and more than one query; both only under ``attention_softmax_in_fp32``. On
those two branches one launch rotates the projection and writes K/V into the pool
(`_paged_write`: rope_qkv's paged form, then over a quantized pool the fused
scatter-quantize), with the same position clamping and write validity as the gather
path, so the pool state is the same whichever path ran. Every other paged call (an alibi
model's among them) rotates and splits first, scatters, gathers the page view and runs
masked attention. A quantized pool (``k_scale`` / ``v_scale`` in the cache) is written
by the quantizing scatter and read by the kernels' dequantizing page walk or by the
dequantizing gather; a low-bit unquantized pool (bf16 under an fp32 model) is cast to the
activation dtype. A dense cache is written in place (`update_kv_cache`): a multi-token
write at a python-int index 0 (a whole-prompt prefill) attends over its own K/V, which
keeps the flash kernel eligible, and every other call attends over the whole cache.
Without a cache (training), `ops/attention.attention` dispatches:
``flash_attention_2`` on a CUDA device runs the causal / segment-id flash kernel, or with
an additive bias (alibi's key row, T5's relative bias over the pairs) or ``causal=False``
its bias form. `CrossAttention` (the encoder-decoder family's) always takes masked
attention, as in JAX.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..enums import AttentionImplementation
from ..ops.activations import get_activation_function, is_glu
from ..ops.alibi import get_alibi_bias
from ..ops.fp8 import fp8_dot
from ..ops.attention import (
    attention,
    paged_gather_kv,
    paged_gather_kv_dequant,
    paged_scatter_kv,
    paged_scatter_kv_quantized,
    write_positions,
)
from ..ops.kernels.paged_attention import paged_decode_attention
from ..ops.kernels.prefill_attention import paged_prefill_attention
from ..ops.kernels.rmsnorm import fused_rmsnorm
from ..ops.kernels.rope_qkv import rope_qkv_paged
from ..ops.normalization import check_normalization_function, layernorm
from ..ops.rope import RoPEParams, get_cos_sin, split_qkv_apply_rope
from .config import CommonConfig
from .enums import InitMethod, PositionEmbeddingType
from .remat import ATTENTION_OUT_CHECKPOINT_NAME, checkpoint_name

# a dense cache {"k", "v": [B, max_len, Hkv, D]}, or a paged pool view {"k": pages, "v":
# pages, "page_table": [B, max_pages]} (+ "k_scale", "v_scale": [P, Hkv])
KVCache = dict[str, torch.Tensor]


def _as(tensor: torch.Tensor | None, dtype: torch.dtype) -> torch.Tensor | None:
    """`tensor` in the compute dtype (itself when it already is)."""
    return tensor if tensor is None or tensor.dtype == dtype else tensor.to(dtype)


class ParameterizedLinear(nn.Module):
    """``y = x @ W.T + b`` with the weight stored ``[out, in]`` in `param_dtype` (default
    `dtype`), computed in `dtype`, and its init std kept. In an fp8 model (`ops/fp8.py`
    `enable_fp8` sets `fp8`) the product is the delayed-scaling fp8 dot.

    A LoRA target (`peft/lora.add_lora` sets `lora` and the fp32 adapters ``lora_a``
    ``[rank, in]``, ``lora_b`` ``[out, rank]``) adds ``(alpha / rank) * dropout(x) @ A @ B``
    in the compute dtype, the JAX module's hook; the dropout only in training mode."""

    fp8_dot = True  # an fp8 model gives this module flax's fp8 dot variables

    def __init__(
        self,
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
            torch.empty(out_features, in_features, dtype=param_dtype, device=device)
        )
        self.bias = (
            nn.Parameter(torch.zeros(out_features, dtype=param_dtype, device=device))
            if bias
            else None
        )
        self.fp8 = None
        self.lora = None  # a LoRA target's (rank, alpha, dropout): `peft/lora.add_lora`

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.weight.normal_(0.0, self.std, generator=generator)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fp8 is None:
            y = F.linear(x.to(self.dtype), _as(self.weight, self.dtype), _as(self.bias, self.dtype))
        else:
            y = fp8_dot(x.to(self.dtype), _as(self.weight, self.dtype), self.fp8)
            y = y if self.bias is None else y + self.bias.to(self.dtype)
        if self.lora is not None:
            h = x.to(self.dtype)
            if self.training and self.lora.dropout > 0.0:
                h = F.dropout(h, self.lora.dropout)
            delta = F.linear(F.linear(h, self.lora_a.to(self.dtype)), self.lora_b.to(self.dtype))
            y = y + (self.lora.alpha / self.lora.rank) * delta
        return y


class ParameterizedEmbedding(nn.Module):
    def __init__(
        self,
        num_embeddings: int,
        features: int,
        std: float,
        dtype: torch.dtype,
        device: torch.device,
        param_dtype: torch.dtype | None = None,
    ) -> None:
        super().__init__()
        self.std = std
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(num_embeddings, features, dtype=param_dtype or dtype, device=device)
        )

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.weight.normal_(0.0, self.std, generator=generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        # the lookup then the cast: the same values as casting the table first, without
        # a compute-dtype copy of the whole table
        return _as(F.embedding(ids, self.weight), self.dtype)

    def table(self) -> torch.Tensor:
        """The ``[V, H]`` table in the compute dtype (the tied LM head's operand)."""
        return _as(self.weight, self.dtype)


class Norm(nn.Module):
    """layernorm / rmsnorm with fp32 statistics and fp32 parameters.

    Called with `residual`, computes ``norm(x + residual)`` and returns ``(normed, x +
    residual)``, the pre-norm block's new residual stream. rmsnorm goes through the fused
    RMSNorm(+residual) kernel (`ops/kernels/rmsnorm.py`) whenever the residual matches
    ``x`` in shape and dtype — the JAX package's condition for its Pallas kernel."""

    def __init__(self, normalization_function: str, dim: int, eps: float, device: torch.device):
        super().__init__()
        check_normalization_function(normalization_function)
        self.normalization_function = normalization_function
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, dtype=torch.float32, device=device))
        self.bias = (
            nn.Parameter(torch.zeros(dim, dtype=torch.float32, device=device))
            if normalization_function == "layernorm"
            else None
        )

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.weight.fill_(1.0)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor, residual: torch.Tensor | None = None):
        if self.normalization_function == "rmsnorm":
            if residual is None or (residual.shape == x.shape and residual.dtype == x.dtype):
                return fused_rmsnorm(x, self.weight, self.eps, residual=residual)
            x = x + residual
            return fused_rmsnorm(x, self.weight, self.eps), x
        if residual is not None:
            x = x + residual
            return layernorm(x, self.weight, self.bias, self.eps), x
        return layernorm(x, self.weight, self.bias, self.eps)


def get_norm(config: CommonConfig, device: torch.device) -> Norm:
    return Norm(config.normalization_function, config.n_embd, config.layer_norm_epsilon, device)


def depth_scaled_init_std(config: CommonConfig) -> float:
    """Residual-projection init std: initializer_range / sqrt(2 * n_layer)."""
    branches = getattr(config, "init_residual_branches", None) or 2 * config.n_layer
    return config.initializer_range / math.sqrt(branches)


def _init_std(config: CommonConfig, depth_scaled: bool) -> float:
    """c_attn / c_fc: initializer_range; c_proj: depth-scaled; mup divides both by
    sqrt(m_width)."""
    std = depth_scaled_init_std(config) if depth_scaled else config.initializer_range
    if InitMethod(config.init_method) == InitMethod.mup:
        std /= math.sqrt(config.m_width)
    return std


def get_softmax_scale(config: CommonConfig, head_dim: int) -> float:
    """attention_multiplier if set, else 1/sqrt(head_dim) when scale_attn_weights, else 1."""
    if config.attention_multiplier is not None:
        return config.attention_multiplier
    if config.scale_attn_weights:
        return head_dim**-0.5
    return 1.0


def _is_scalar_index(cache_index) -> bool:
    return isinstance(cache_index, int) or (
        isinstance(cache_index, torch.Tensor) and cache_index.ndim == 0
    )


def _paged_kernel_eligible(
    kv_cache, cache_index, attention_mask, segment_ids, alibi_bias, causal: bool, dropout: float
) -> bool:
    """The serving decode/verify step: paged pool, per-row [B] frontier vector, plain
    causal attention with no incoming mask, segments, alibi bias or dropout (the JAX
    condition)."""
    return (
        kv_cache is not None
        and "page_table" in kv_cache
        and isinstance(cache_index, torch.Tensor)
        and cache_index.ndim == 1
        and attention_mask is None
        and segment_ids is None
        and alibi_bias is None
        and causal
        and dropout == 0.0
    )


def _paged_prefill_eligible(
    kv_cache, cache_index, attention_mask, segment_ids, alibi_bias, causal: bool, dropout: float, seq: int
) -> bool:
    """The engine's chunked-prefill shape: paged pool, multi-token window, one scalar
    write offset, the chunk's 2-D key-side prefix mask over the page view, no segments,
    alibi bias or dropout (the JAX condition)."""
    return (
        kv_cache is not None
        and "page_table" in kv_cache
        and seq > 1
        and cache_index is not None
        and _is_scalar_index(cache_index)
        and attention_mask is not None
        and attention_mask.ndim == 2
        and segment_ids is None
        and alibi_bias is None
        and causal
        and dropout == 0.0
    )


def update_kv_cache(key, value, kv_cache, cache_index, attention_mask):
    """Write the new K/V ``[B, S, Hkv, D]`` into a dense cache ``{"k", "v": [B, max_len,
    Hkv, D]}`` IN PLACE and return ``(key view, value view, attention_mask)`` over the
    whole cache, the mask hiding the slots not written yet.

    A scalar `cache_index` (a python int or a 0-d tensor) writes ``[cache_index,
    cache_index + S)`` for every row, its start clamped into the cache as
    `jax.lax.dynamic_update_slice` clamps it. A per-row ``[B]`` index is the continuous
    batching case: row b writes at its own frontier ``cache_index[b]``, and positions
    ``>= max_len`` are dropped (the JAX package's ``mode="drop"``). The validity frontier
    is ``cache_index + S`` (per row for a [B] index). The JAX package returns a new cache;
    writing in place keeps one copy of it on the device."""
    k_cache, v_cache = kv_cache["k"], kv_cache["v"]
    batch, seq = key.shape[:2]
    max_len = k_cache.shape[1]
    device = key.device
    steps = torch.arange(seq, device=device)
    if isinstance(cache_index, torch.Tensor) and cache_index.ndim == 1:
        index = cache_index.to(device=device, dtype=torch.long)
        positions = index[:, None] + steps  # [B, S]
        keep = positions < max_len
        # a dropped position p >= max_len is sent to p - S instead, below the row's own
        # window and distinct per row, and writes back what it reads there: the writes
        # of one call never collide, and no host sync decides which survive
        positions = torch.where(keep, positions, positions - seq)
        rows = torch.arange(batch, device=device)[:, None].expand(batch, seq)
        for cache, new in ((k_cache, key), (v_cache, value)):
            new = torch.where(keep[:, :, None, None], new.to(cache.dtype), cache[rows, positions])
            cache[rows, positions] = new
        frontier = index[:, None] + seq
    elif isinstance(cache_index, int):
        start = min(max(cache_index, 0), max_len - seq)
        k_cache[:, start : start + seq] = key.to(k_cache.dtype)
        v_cache[:, start : start + seq] = value.to(v_cache.dtype)
        frontier = cache_index + seq
    else:
        index = cache_index.to(device=device, dtype=torch.long)
        positions = index.clamp(0, max_len - seq) + steps
        k_cache.index_copy_(1, positions, key.to(k_cache.dtype))
        v_cache.index_copy_(1, positions, value.to(v_cache.dtype))
        frontier = index + seq
    valid = (torch.arange(max_len, device=device)[None, :] < frontier).int()
    attention_mask = valid if attention_mask is None else attention_mask * valid
    # a low-bit cache (bf16 under an fp32 model) attends in the activation dtype
    return k_cache.to(key.dtype), v_cache.to(value.dtype), attention_mask


def _scatter_chunk(key, value, kv_cache, cache_index, attention_mask):
    """Write the new K/V into their pages at the write window (`write_positions`: positions
    past the view, and those the key mask marks invalid, go to the trash page). A
    quantized pool quantizes on scatter (`paged_scatter_kv_quantized`: the fused kernel
    for CUDA tensors)."""
    table = kv_cache["page_table"]
    if "k_scale" in kv_cache:  # quantize on scatter
        paged_scatter_kv_quantized(
            kv_cache["k"], kv_cache["v"], kv_cache["k_scale"], kv_cache["v_scale"], key, value,
            table, cache_index, attention_mask,
        )
        return
    batch, seq = key.shape[:2]
    view_len = table.shape[1] * kv_cache["k"].shape[1]
    positions, write_valid = write_positions(cache_index, attention_mask, view_len, batch, seq, key.device)
    paged_scatter_kv(kv_cache["k"], key, table, positions, write_valid)
    paged_scatter_kv(kv_cache["v"], value, table, positions, write_valid)


def _paged_write(qkv, rope_cos_sin, num_heads, num_kv_heads, head_dim, kv_cache, cache_index, key_mask):
    """The paged kernel branches' rope and K/V write: `rope_qkv_paged` rotates the fused
    projection and writes K and V into a bf16 / fp32 pool in one launch; over a quantized
    pool it hands K and V to the fused scatter-quantize (a second launch). Returns the
    rotated query ``[B, S, Hq, D]``, contiguous."""
    cos, sin = rope_cos_sin if rope_cos_sin is not None else (None, None)
    table = kv_cache["page_table"]
    if "k_scale" not in kv_cache:
        query, _, _ = rope_qkv_paged(
            qkv, cos, sin, num_heads, num_kv_heads, head_dim, kv_cache["k"], kv_cache["v"], table,
            cache_index, key_mask,
        )
        return query
    query, key, value = rope_qkv_paged(
        qkv, cos, sin, num_heads, num_kv_heads, head_dim, None, None, table, cache_index, key_mask
    )
    paged_scatter_kv_quantized(
        kv_cache["k"], kv_cache["v"], kv_cache["k_scale"], kv_cache["v_scale"], key, value, table,
        cache_index, key_mask,
    )
    return query


def _update_paged_kv_cache(key, value, kv_cache, cache_index, attention_mask):
    """Gather path: scatter the new tokens, gather each row's pages into a contiguous view
    for attention, and extend the key mask with the per-row validity frontier."""
    table = kv_cache["page_table"]
    page_size = kv_cache["k"].shape[1]
    seq = key.shape[1]
    view_len = table.shape[1] * page_size
    _scatter_chunk(key, value, kv_cache, cache_index, attention_mask)
    if "k_scale" in kv_cache:
        k_view = paged_gather_kv_dequant(kv_cache["k"], kv_cache["k_scale"], table, key.dtype)
        v_view = paged_gather_kv_dequant(kv_cache["v"], kv_cache["v_scale"], table, value.dtype)
    else:
        # a low-bit pool (bf16 under an fp32 model) attends in the activation dtype
        k_view = paged_gather_kv(kv_cache["k"], table).to(key.dtype)
        v_view = paged_gather_kv(kv_cache["v"], table).to(value.dtype)
    if isinstance(cache_index, torch.Tensor) and cache_index.ndim == 1:
        frontier = cache_index.to(key.device)[:, None] + seq
    else:
        frontier = torch.as_tensor(cache_index, device=key.device) + seq
    valid = torch.arange(view_len, device=key.device)[None, :] < frontier
    attention_mask = valid.int() if attention_mask is None else attention_mask * valid.int()
    return k_view, v_view, attention_mask


def cache_attention_view(key, value, kv_cache, cache_index, attention_mask):
    """Write the new K/V into a dense cache or a paged pool and return ``(key, value,
    attention_mask, query_offset)`` over the cache's whole view: the JAX package's
    `update_kv_cache`, with no prefill shortcut and no paged kernel (the cross-layer and
    dense-MoE families' attention)."""
    if cache_index is None:
        raise ValueError("a KV cache needs a cache_index")
    if "page_table" in kv_cache:
        key, value, attention_mask = _update_paged_kv_cache(key, value, kv_cache, cache_index, attention_mask)
    else:
        key, value, attention_mask = update_kv_cache(key, value, kv_cache, cache_index, attention_mask)
    return key, value, attention_mask, cache_index


class Attention(nn.Module):
    """Self-attention with the fused QKV projection, RoPE or an alibi bias, and a dense
    KV cache or a paged KV pool."""

    def __init__(
        self,
        config: CommonConfig,
        dtype: torch.dtype,
        device: torch.device,
        causal=True,
        param_dtype: torch.dtype | None = None,
        attention_implementation: AttentionImplementation | str = AttentionImplementation.sdpa,
    ):
        super().__init__()
        self.config = config
        self.causal = causal
        self.attention_implementation = AttentionImplementation(attention_implementation)
        self.num_heads = config.n_head
        self.num_kv_heads = config.num_key_value_heads
        self.head_dim = config.head_dim
        self.c_attn = ParameterizedLinear(
            config.n_embd,
            (self.num_heads + 2 * self.num_kv_heads) * self.head_dim,
            config.add_bias,
            _init_std(config, depth_scaled=False),
            dtype,
            device,
            param_dtype,
        )
        self.c_proj = ParameterizedLinear(
            self.num_heads * self.head_dim,
            config.n_embd,
            config.add_bias,
            _init_std(config, depth_scaled=True),
            dtype,
            device,
            param_dtype,
        )

    def _project_out(self, out: torch.Tensor, deterministic: bool) -> torch.Tensor:
        batch, seq = out.shape[:2]
        out = self.c_proj(out.reshape(batch, seq, -1))
        if not deterministic and self.config.resid_pdrop > 0.0:
            out = F.dropout(out, self.config.resid_pdrop)
        return out

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
        config = self.config
        batch, seq = hidden_states.shape[:2]
        qkv = self.c_attn(hidden_states)
        heads = (self.num_heads, self.num_kv_heads, self.head_dim)
        softmax_scale = get_softmax_scale(config, self.head_dim)
        dropout = 0.0 if deterministic else config.attn_pdrop

        query_offset = 0
        if kv_cache is not None:
            if cache_index is None:
                raise ValueError("a KV cache needs a cache_index")
            if "page_table" not in kv_cache:
                query, key, value = split_qkv_apply_rope(qkv, *heads, rope_cos_sin)
                if seq > 1 and isinstance(cache_index, int) and cache_index == 0:
                    # the prefill fast path, only for a write known on the host to start
                    # at 0 (the JAX package's static zero): the cache then holds exactly
                    # this call's K/V, so attention runs over them locally with q_len ==
                    # kv_len, which keeps the flash kernel eligible
                    update_kv_cache(key, value, kv_cache, cache_index, attention_mask)
                    if attention_mask is not None:
                        attention_mask = attention_mask[:, :seq]
                else:
                    key, value, attention_mask = update_kv_cache(
                        key, value, kv_cache, cache_index, attention_mask
                    )
                    query_offset = cache_index
            else:
                # the branch is chosen before the rotation: the two paged-kernel branches rotate
                # and write K/V in one launch (`_paged_write`), the rest split and rotate first
                table = kv_cache["page_table"]
                if config.attention_softmax_in_fp32 and _paged_kernel_eligible(
                    kv_cache, cache_index, attention_mask, segment_ids, alibi_bias, self.causal, dropout
                ):
                    query = _paged_write(qkv, rope_cos_sin, *heads, kv_cache, cache_index, None)
                    out = paged_decode_attention(
                        query, kv_cache["k"], kv_cache["v"], table,
                        cache_index.to(torch.int32), softmax_scale,
                        kv_cache.get("k_scale"), kv_cache.get("v_scale"),
                    )
                    return self._project_out(out, deterministic), kv_cache
                if config.attention_softmax_in_fp32 and _paged_prefill_eligible(
                    kv_cache, cache_index, attention_mask, segment_ids, alibi_bias, self.causal, dropout, seq
                ):
                    query = _paged_write(qkv, rope_cos_sin, *heads, kv_cache, cache_index, attention_mask)
                    start = torch.as_tensor(cache_index, dtype=torch.int32, device=query.device)
                    out = paged_prefill_attention(
                        query, kv_cache["k"], kv_cache["v"], table,
                        start.reshape(1).expand(batch).contiguous(), softmax_scale,
                        kv_cache.get("k_scale"), kv_cache.get("v_scale"),
                    )
                    return self._project_out(out, deterministic), kv_cache
                query, key, value = split_qkv_apply_rope(qkv, *heads, rope_cos_sin)
                key, value, attention_mask = _update_paged_kv_cache(
                    key, value, kv_cache, cache_index, attention_mask
                )
                query_offset = cache_index
        else:
            query, key, value = split_qkv_apply_rope(qkv, *heads, rope_cos_sin)

        out = attention(
            query,
            key,
            value,
            causal=self.causal,
            softmax_scale=softmax_scale,
            attention_mask=attention_mask,
            softmax_in_fp32=config.attention_softmax_in_fp32,
            query_offset=query_offset,
            implementation=self.attention_implementation,
            segment_ids=segment_ids,
            dropout=dropout,
            alibi_bias=alibi_bias,
        )
        return self._project_out(out, deterministic), kv_cache


class MLP(nn.Module):
    """Fused up+gate MLP: c_fc emits ``2 * n_inner`` laid out ``[up | gate]`` for GLU
    activations and the activation computes ``up * act(gate)``."""

    def __init__(
        self,
        config: CommonConfig,
        dtype: torch.dtype,
        device: torch.device,
        param_dtype: torch.dtype | None = None,
    ):
        super().__init__()
        glu = is_glu(config.activation_function)
        self.resid_pdrop = config.resid_pdrop
        self.c_fc = ParameterizedLinear(
            config.n_embd,
            2 * config.n_inner if glu else config.n_inner,
            config.add_bias,
            _init_std(config, depth_scaled=False),
            dtype,
            device,
            param_dtype,
        )
        self.c_proj = ParameterizedLinear(
            config.n_inner,
            config.n_embd,
            config.add_bias,
            _init_std(config, depth_scaled=True),
            dtype,
            device,
            param_dtype,
        )
        self.act = get_activation_function(config.activation_function)

    def forward(self, hidden_states: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        out = self.c_proj(self.act(self.c_fc(hidden_states)))
        if not deterministic and self.resid_pdrop > 0.0:
            out = F.dropout(out, self.resid_pdrop)
        return out


class CrossAttention(nn.Module):
    """Encoder-decoder cross-attention (the JAX module's): queries from the decoder stream
    (``c_q``), keys and values from the encoder output through one fused projection
    (``c_kv`` emits ``[K | V]``), no rope, not causal, the encoder's key padding mask, and
    always masked attention (`ops/attention.sdpa_attention`, or `eager_attention` with
    dropout): the query and key lengths differ. `project_kv` projects the encoder output
    once for generation, which passes the result back as `cross_kv` every step."""

    def __init__(
        self,
        config: CommonConfig,
        dtype: torch.dtype,
        device: torch.device,
        param_dtype: torch.dtype | None = None,
    ):
        super().__init__()
        self.config = config
        self.num_heads = config.n_head
        self.num_kv_heads = config.num_key_value_heads
        self.head_dim = config.head_dim
        std = _init_std(config, depth_scaled=False)
        self.c_q = ParameterizedLinear(
            config.n_embd, self.num_heads * self.head_dim, config.add_bias, std, dtype, device, param_dtype
        )
        self.c_kv = ParameterizedLinear(
            config.n_embd, 2 * self.num_kv_heads * self.head_dim, config.add_bias, std, dtype, device, param_dtype
        )
        self.c_proj = ParameterizedLinear(
            self.num_heads * self.head_dim, config.n_embd, config.add_bias,
            _init_std(config, depth_scaled=True), dtype, device, param_dtype,
        )

    def project_kv(self, encoder_hidden_states: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(key, value) ``[B, S_enc, Hkv, D]`` of the encoder output."""
        batch, kv_seq = encoder_hidden_states.shape[:2]
        key, value = self.c_kv(encoder_hidden_states).chunk(2, dim=-1)
        shape = (batch, kv_seq, self.num_kv_heads, self.head_dim)
        return key.reshape(shape), value.reshape(shape)

    def forward(
        self,
        hidden_states: torch.Tensor,
        encoder_hidden_states: torch.Tensor | None,
        encoder_attention_mask: torch.Tensor | None = None,
        deterministic: bool = True,
        cross_kv: tuple[torch.Tensor, torch.Tensor] | None = None,
    ) -> torch.Tensor:
        config = self.config
        key, value = self.project_kv(encoder_hidden_states) if cross_kv is None else cross_kv
        batch, q_seq = hidden_states.shape[:2]
        query = self.c_q(hidden_states).reshape(batch, q_seq, self.num_heads, self.head_dim)
        dropout = 0.0 if deterministic else config.attn_pdrop
        out = attention(
            query,
            key,
            value,
            causal=False,
            softmax_scale=get_softmax_scale(config, self.head_dim),
            attention_mask=encoder_attention_mask,
            softmax_in_fp32=config.attention_softmax_in_fp32,
            implementation=AttentionImplementation.sdpa,
            dropout=dropout,
        )
        out = self.c_proj(out.reshape(batch, q_seq, -1))
        if not deterministic and config.resid_pdrop > 0.0:
            out = F.dropout(out, config.resid_pdrop)
        return out


class Block(nn.Module):
    """Pre-norm transformer block with the µP residual multiplier; ``causal=False`` makes
    it a bidirectional (encoder) block, whose attention mask marks the valid keys."""

    def __init__(
        self,
        config: CommonConfig,
        dtype: torch.dtype,
        device: torch.device,
        param_dtype: torch.dtype | None = None,
        attention_implementation: AttentionImplementation | str = AttentionImplementation.sdpa,
        causal: bool = True,
    ):
        super().__init__()
        self.m_residual = config.m_residual
        self.ln_1 = get_norm(config, device)
        self.attn = Attention(
            config, dtype, device, causal=causal, param_dtype=param_dtype,
            attention_implementation=attention_implementation,
        )
        self.ln_2 = get_norm(config, device)
        self.mlp = MLP(config, dtype, device, param_dtype)
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
    ) -> tuple[torch.Tensor, KVCache | None]:
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
        mlp_out = self.mlp(h, deterministic=deterministic)
        if self.m_residual is not None:
            mlp_out = mlp_out * self.m_residual
        return hidden_states + mlp_out, kv_cache

    def jax_module_params(self, tree):
        """(flax subtree, module) pairs of this block's ``h_<i>`` params."""
        yield tree["ln_1"], self.ln_1
        yield tree["attn"]["c_attn"], self.attn.c_attn
        yield tree["attn"]["c_proj"], self.attn.c_proj
        yield tree["ln_2"], self.ln_2
        yield tree["mlp"]["c_fc"], self.mlp.c_fc
        yield tree["mlp"]["c_proj"], self.mlp.c_proj


def compute_position_stuff(
    config: CommonConfig,
    position_ids: torch.Tensor,
    rope_params: RoPEParams | None,
    num_heads: int,
    attention_mask: torch.Tensor | None,
    batch: int,
    key_length: int,
    dtype: torch.dtype,
):
    """(rope cos/sin, alibi bias ``[B, H, 1, key_length]`` fp32) shared by all layers; each
    None for the position types without it."""
    pe_type = PositionEmbeddingType(config.position_embedding_type)
    rope_cos_sin = None
    alibi_bias = None
    if pe_type == PositionEmbeddingType.rope:
        rope_cos_sin = get_cos_sin(rope_params, position_ids, dtype=dtype)
    elif pe_type == PositionEmbeddingType.alibi:
        alibi_bias = get_alibi_bias(
            num_heads, attention_mask, batch, key_length, device=position_ids.device
        )
    return rope_cos_sin, alibi_bias
