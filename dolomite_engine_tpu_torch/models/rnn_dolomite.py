"""RNNDolomite: the DeltaNet / softmax-attention hybrid decoder.

Counterpart of `dolomite_engine_tpu/models/rnn_dolomite.py`. ``attention_pattern`` gives
each layer's mixer: ``d`` is `DeltaNet` (q/k/v projections, short causal convolutions
with silu, l2-normalised q and k, a sigmoid ``b_proj`` gate, the delta rule of
`ops/deltanet.py`, an rmsnorm over each head's output at eps 1e-5, ``o_proj``), ``a`` is
`modeling_utils.Attention` with its kernels (the flat rope_qkv kernel, flash attention).
The delta rule takes the chunked form when the length is a positive multiple of 64, else
the recurrent one (decode steps, short or ragged prefills), as in JAX.

Caches (`init_kv_caches`): a ``d`` layer holds ``{"conv_q", "conv_k", "conv_v": [B,
n_embd, 4], "recurrent": [B, H, D, D]}``, replaced in the dict each call; an ``a`` layer
the dense ``{"k", "v"}``. The serving engine's pools hold K/V pages and slots only, so
`serving.ServingEngine` (and `generate.main`, which serves every decoder-only model
through it) refuse this family, where the JAX engine fails on the recurrent caches;
`generation_utils.generate_tokens` decodes it.
"""

from __future__ import annotations

import torch
from torch import nn

from ..enums import AttentionImplementation
from ..ops.deltanet import delta_rule_chunked, delta_rule_recurrent, l2_norm, short_convolution
from .config import RNNDolomiteConfig
from .gpt_dolomite import GPTDolomiteForCausalLM, GPTDolomiteModel
from .modeling_utils import MLP, Attention, KVCache, Norm, ParameterizedLinear, _init_std, get_norm


class ShortConvolution(nn.Module):
    """Causal depthwise convolution over time, then silu; ``weight`` ``[D, W]`` stored in
    fp32 and cast to the compute dtype at use."""

    def __init__(self, dim: int, width: int, std: float, dtype, device):
        super().__init__()
        self.std = std
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(dim, width, dtype=torch.float32, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.weight.normal_(0.0, self.std, generator=generator)

    def forward(self, x: torch.Tensor, conv_state: torch.Tensor | None = None):
        return short_convolution(x, self.weight.to(self.dtype), None, "silu", conv_state)


class DeltaNet(nn.Module):
    """The delta-rule token mixer as the JAX block builds it (its module's defaults): short
    convolutions of width 4 with silu on q, k and v, l2-normalised q and k, the sigmoid
    ``b_proj`` gate."""

    chunk_size = 64
    conv_size = 4

    def __init__(
        self,
        config: RNNDolomiteConfig,
        dtype: torch.dtype,
        device: torch.device,
        param_dtype: torch.dtype | None = None,
    ):
        super().__init__()
        hidden, heads = config.n_embd, config.n_head
        self.num_heads, self.head_dim = heads, hidden // heads
        std_in = _init_std(config, depth_scaled=False)

        def linear(out_features, std):
            return ParameterizedLinear(hidden, out_features, False, std, dtype, device, param_dtype)

        def conv():
            return ShortConvolution(hidden, self.conv_size, config.initializer_range, dtype, device)

        self.q_proj, self.k_proj, self.v_proj = linear(hidden, std_in), linear(hidden, std_in), linear(hidden, std_in)
        self.q_conv1d, self.k_conv1d, self.v_conv1d = conv(), conv(), conv()
        self.b_proj = linear(heads, std_in)
        # rmsnorm over each head's output whatever the config's norm, as in the reference
        self.o_norm = Norm("rmsnorm", self.head_dim, 1e-5, device)
        self.o_proj = linear(hidden, _init_std(config, depth_scaled=True))

    def forward(
        self,
        hidden_states: torch.Tensor,
        token_mask: torch.Tensor | None = None,
        cache: dict | None = None,
    ) -> torch.Tensor:
        """``[B, L, n_embd]`` out; a `cache` dict is read and its entries replaced."""
        batch, seq = hidden_states.shape[:2]
        mixed = []
        for proj, conv, key in (
            (self.q_proj, self.q_conv1d, "conv_q"), (self.k_proj, self.k_conv1d, "conv_k"),
            (self.v_proj, self.v_conv1d, "conv_v"),
        ):
            x, state = conv(proj(hidden_states), None if cache is None else cache[key])
            if cache is not None:
                cache[key] = state.to(cache[key].dtype)
            # [B, L, H * D] -> [B, H, L, D]
            mixed.append(x.reshape(batch, seq, self.num_heads, self.head_dim).transpose(1, 2))
        q, k, v = mixed
        q, k = l2_norm(q), l2_norm(k)
        beta = torch.sigmoid(self.b_proj(hidden_states)).transpose(1, 2)  # [B, H, L]
        if token_mask is not None:
            # a left-padded position: v and beta zeroed, an exact no-op on the state
            m = token_mask.to(v.dtype)
            v = v * m[:, None, :, None]
            beta = beta * m[:, None, :].to(beta.dtype)
        initial_state = None if cache is None else cache["recurrent"]
        if seq < self.chunk_size or seq % self.chunk_size != 0:
            o, final_state = delta_rule_recurrent(q, k, v, beta, initial_state)
        else:
            o, final_state = delta_rule_chunked(q, k, v, beta, self.chunk_size, initial_state)
        if cache is not None:
            cache["recurrent"] = final_state.to(cache["recurrent"].dtype)
        o = self.o_norm(o.transpose(1, 2).contiguous())  # [B, L, H, D]
        return self.o_proj(o.reshape(batch, seq, -1))


def _token_mask(attention_mask, segment_ids, cache_index, seq):
    """The DeltaNet layer's ``[B, seq]`` validity of the current tokens: the key-side mask's
    window at `cache_index` (its start clamped as `lax.dynamic_slice_in_dim` clamps it),
    else the non-padding segments, else None."""
    if attention_mask is not None:
        start = 0 if cache_index is None else int(cache_index)
        start = min(max(start, 0), attention_mask.shape[1] - seq)
        return attention_mask[:, start : start + seq]
    if segment_ids is not None:
        return (segment_ids != 0).to(torch.int32)
    return None


class RNNDolomiteBlock(nn.Module):
    """Pre-norm block whose mixer is `DeltaNet` (``mixer="d"``) or `Attention` (``"a"``).
    Takes `Block`'s arguments; a DeltaNet block's `kv_cache` is its recurrent cache dict.
    `tag_attention_out` is carried for `set_remat` and unused, as the JAX block tags no
    attention output."""

    def __init__(
        self,
        config: RNNDolomiteConfig,
        dtype: torch.dtype,
        device: torch.device,
        param_dtype: torch.dtype | None = None,
        attention_implementation: AttentionImplementation | str = AttentionImplementation.sdpa,
        mixer: str = "d",
    ):
        super().__init__()
        self.mixer = mixer
        self.m_residual = config.m_residual
        self.ln_1 = get_norm(config, device)
        if mixer == "d":
            self.attn = DeltaNet(config, dtype, device, param_dtype)
        else:
            self.attn = Attention(
                config, dtype, device, param_dtype=param_dtype, attention_implementation=attention_implementation
            )
        self.ln_2 = get_norm(config, device)
        self.mlp = MLP(config, dtype, device, param_dtype)
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
        h = self.ln_1(hidden_states)
        if self.mixer == "d":
            token_mask = _token_mask(attention_mask, segment_ids, cache_index, hidden_states.shape[1])
            attn_out = self.attn(h, token_mask=token_mask, cache=kv_cache)
        else:
            attn_out, kv_cache = self.attn(
                h, attention_mask=attention_mask, rope_cos_sin=rope_cos_sin, alibi_bias=alibi_bias,
                kv_cache=kv_cache, cache_index=cache_index, segment_ids=segment_ids, deterministic=deterministic,
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
        attn = tree["attn"]
        if self.mixer == "d":
            for name in ("q_proj", "k_proj", "v_proj", "b_proj", "o_proj", "o_norm", "q_conv1d", "k_conv1d", "v_conv1d"):
                yield attn[name], getattr(self.attn, name)
        else:
            yield attn["c_attn"], self.attn.c_attn
            yield attn["c_proj"], self.attn.c_proj
        yield tree["ln_2"], self.ln_2
        yield tree["mlp"]["c_fc"], self.mlp.c_fc
        yield tree["mlp"]["c_proj"], self.mlp.c_proj


class RNNDolomiteModel(GPTDolomiteModel):
    """The stack following ``attention_pattern``."""

    block_cls = RNNDolomiteBlock

    def _make_block(self, i, dtype, device, param_dtype, attention_implementation, **block_kwargs):
        return RNNDolomiteBlock(
            self.config, dtype, device, param_dtype, attention_implementation,
            mixer=self.config.attention_pattern[i], **block_kwargs,
        )


class RNNDolomiteForCausalLM(GPTDolomiteForCausalLM):
    model_type = "rnn_dolomite"
    base_model_cls = RNNDolomiteModel

    def init_kv_caches(self, batch_size: int, max_length: int, dtype: torch.dtype | None = None) -> list[dict]:
        """A recurrent cache of zeros for each ``d`` layer, a dense K/V cache for each ``a``."""
        config = self.config
        dtype = dtype or self.dtype
        heads, head_dim, width = config.n_head, config.head_dim, DeltaNet.conv_size
        caches = []
        for mixer in config.attention_pattern:
            if mixer == "d":
                conv = (batch_size, config.n_embd, width)
                caches.append({
                    "conv_q": torch.zeros(conv, dtype=dtype, device=self.device),
                    "conv_k": torch.zeros(conv, dtype=dtype, device=self.device),
                    "conv_v": torch.zeros(conv, dtype=dtype, device=self.device),
                    "recurrent": torch.zeros(batch_size, heads, head_dim, head_dim, dtype=dtype, device=self.device),
                })
            else:
                caches.append(self.dense_kv_cache(batch_size, max_length, dtype))
        return caches
