"""EncDecDolomite, the encoder-decoder (seq2seq) family: training and generation.

Counterpart of `dolomite_engine_tpu/models/enc_dec_dolomite.py`: a bidirectional pre-norm
encoder (`Block` with ``causal=False``), decoder blocks of causal self-attention,
cross-attention over the encoder output and the MLP (`EncDecBlock`), one shared token
embedding, a tied or untied LM head, and the µP multipliers. Positions are rope or T5's
bucketed relative bias (`ops/relative_bias.py`, one table a stack, fed to every layer's
self-attention as its additive bias; on the card the decoder's causal self-attention takes
the flash kernel's query-bias form whenever its length is a multiple of 128, as the JAX
dispatch takes jax's flash kernel there).

Training follows the HF seq2seq convention: `labels` are the decoder targets
(IGNORE_INDEX-padded) and the decoder inputs default to the labels shifted right behind
`decoder_start_token_id` (`shift_right`). Generation runs `encode` once, projects each
layer's cross-attention K/V once (`precompute_cross_kv`) and decodes over the dense
self-attention cache (`init_kv_caches`).

Module names follow the flax tree (``encoder.<i>`` for ``encoder_<i>``, ``decoder.<i>``,
``rel_bias_enc``, ``ln_enc``, ...), so `load_jax_params` maps the JAX package's unrolled
params one to one; a scanned tree (``scan_layers``) is unstacked first
(`unstack_enc_dec_params`). ``scan_layers`` is accepted and runs the unrolled loop, as for
GPTDolomite. Every k-th block of each stack is rematted under the policy with
``checkpoint_every`` k.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..enums import AttentionImplementation
from ..ops.loss import IGNORE_INDEX, causal_lm_loss
from ..ops.relative_bias import RelativePositionBias
from ..ops.rope import RoPEParams, get_cos_sin
from .config import EncDecDolomiteConfig
from .enums import PositionEmbeddingType
from .modeling_utils import (
    MLP,
    Attention,
    Block,
    CrossAttention,
    KVCache,
    ParameterizedEmbedding,
    ParameterizedLinear,
    get_norm,
)
from .remat import remat_call, resolve_remat_policy


@dataclass
class Seq2SeqOutput:
    logits: torch.Tensor | None = None
    loss: torch.Tensor | None = None
    encoder_hidden_states: torch.Tensor | None = None
    kv_caches: list[KVCache] | None = None


def shift_right(labels: torch.Tensor, start_token_id: int, pad_token_id: int) -> torch.Tensor:
    """Decoder inputs from targets (HF `shift_tokens_right`): the start token, then the
    targets but the last, IGNORE_INDEX replaced by the pad token."""
    inputs = torch.cat([torch.full_like(labels[:, :1], start_token_id), labels[:, :-1]], dim=1)
    return torch.where(inputs == IGNORE_INDEX, torch.full_like(inputs, pad_token_id), inputs)


class EncDecBlock(nn.Module):
    """Decoder block: causal self-attention (cacheable), cross-attention, MLP, each
    pre-normed, with the µP residual multiplier on each branch."""

    def __init__(
        self,
        config: EncDecDolomiteConfig,
        dtype: torch.dtype,
        device: torch.device,
        param_dtype: torch.dtype | None = None,
        attention_implementation: AttentionImplementation | str = AttentionImplementation.sdpa,
    ) -> None:
        super().__init__()
        self.m_residual = config.m_residual
        self.ln_1 = get_norm(config, device)
        self.attn = Attention(
            config, dtype, device, param_dtype=param_dtype, attention_implementation=attention_implementation
        )
        self.ln_cross = get_norm(config, device)
        self.cross_attn = CrossAttention(config, dtype, device, param_dtype)
        self.ln_2 = get_norm(config, device)
        self.mlp = MLP(config, dtype, device, param_dtype)

    def _residual(self, branch: torch.Tensor) -> torch.Tensor:
        return branch if self.m_residual is None else branch * self.m_residual

    def forward(
        self,
        hidden_states: torch.Tensor,
        encoder_hidden_states: torch.Tensor | None,
        encoder_attention_mask: torch.Tensor | None = None,
        rope_cos_sin: tuple[torch.Tensor, torch.Tensor] | None = None,
        self_attn_bias: torch.Tensor | None = None,
        cross_kv: tuple[torch.Tensor, torch.Tensor] | None = None,
        kv_cache: KVCache | None = None,
        cache_index: torch.Tensor | int | None = None,
        deterministic: bool = True,
    ) -> tuple[torch.Tensor, KVCache | None]:
        attn_out, kv_cache = self.attn(
            self.ln_1(hidden_states),
            rope_cos_sin=rope_cos_sin,
            alibi_bias=self_attn_bias,
            kv_cache=kv_cache,
            cache_index=cache_index,
            deterministic=deterministic,
        )
        hidden_states = hidden_states + self._residual(attn_out)
        cross_out = self.cross_attn(
            self.ln_cross(hidden_states), encoder_hidden_states, encoder_attention_mask, deterministic, cross_kv
        )
        hidden_states = hidden_states + self._residual(cross_out)
        mlp_out = self.mlp(self.ln_2(hidden_states), deterministic=deterministic)
        return hidden_states + self._residual(mlp_out), kv_cache

    def jax_module_params(self, tree):
        """(flax subtree, module) pairs of this block's ``decoder_<i>`` params."""
        yield tree["ln_1"], self.ln_1
        yield tree["attn"]["c_attn"], self.attn.c_attn
        yield tree["attn"]["c_proj"], self.attn.c_proj
        yield tree["ln_cross"], self.ln_cross
        for name in ("c_q", "c_kv", "c_proj"):
            yield tree["cross_attn"][name], getattr(self.cross_attn, name)
        yield tree["ln_2"], self.ln_2
        yield tree["mlp"]["c_fc"], self.mlp.c_fc
        yield tree["mlp"]["c_proj"], self.mlp.c_proj


class EncDecDolomiteForSeq2SeqLM(nn.Module):
    """The seq2seq LM. Built on `device` (default the GPU; raises without one unless
    ``device="cpu"``) with random weights from `seed` under the JAX init rules (each stack's
    residual projections depth-scaled by its own branch count: 2 a block in the encoder, 3
    in the decoder). `dtype` is the compute dtype, `param_dtype` (default `dtype`) the
    storage of the linear and embedding weights; the relative-bias tables and norms are
    fp32. `checkpoint_every` k reruns every k-th block of each stack in the backward under
    `checkpoint_policy`."""

    model_type: str = "enc_dec_dolomite"

    def __init__(
        self,
        config: EncDecDolomiteConfig,
        dtype: torch.dtype = torch.float32,
        device: str | torch.device = "cuda",
        seed: int = 0,
        param_dtype: torch.dtype | None = None,
        attention_implementation: AttentionImplementation | str = AttentionImplementation.sdpa,
        checkpoint_every: int = 0,
        checkpoint_policy: str | None = None,
    ) -> None:
        super().__init__()
        if config.model_type != self.model_type:
            raise ValueError(
                f"{type(self).__name__} builds model_type '{self.model_type}', not "
                f"'{config.model_type}': build it with models.get_model_class(config.model_type)"
            )
        device = resolve_device(device)
        self.config = config
        self.dtype = dtype
        self.wte = ParameterizedEmbedding(
            config.vocab_size, config.n_embd, config.initializer_range, dtype, device, param_dtype
        )
        enc_config = dataclasses.replace(config, init_residual_branches=2 * config.n_encoder_layer)
        dec_config = dataclasses.replace(config, init_residual_branches=3 * config.n_layer)
        self.encoder = nn.ModuleList(
            Block(enc_config, dtype, device, param_dtype, attention_implementation, causal=False)
            for _ in range(config.n_encoder_layer)
        )
        self.decoder = nn.ModuleList(
            EncDecBlock(dec_config, dtype, device, param_dtype, attention_implementation)
            for _ in range(config.n_layer)
        )
        self.ln_enc = get_norm(config, device)
        self.ln_dec = get_norm(config, device)
        self.lm_head = (
            None
            if config.tie_word_embeddings
            else ParameterizedLinear(
                config.n_embd, config.vocab_size, False, config.initializer_range, dtype, device, param_dtype
            )
        )
        pe_type = PositionEmbeddingType(config.position_embedding_type)
        self.rope_params = None
        self.rel_bias_enc = self.rel_bias_dec = None
        if pe_type == PositionEmbeddingType.rope:
            self.rope_params = RoPEParams.from_config(
                config.head_dim,
                base=config.rope_theta,
                rope_scaling=config.rope_scaling,
                max_position_embeddings=config.n_positions,
            )
        else:  # relative_bucketed: one learned table per stack, shared by its layers
            self.rel_bias_enc, self.rel_bias_dec = (
                RelativePositionBias(
                    config.n_head,
                    config.relative_attention_num_buckets,
                    config.relative_attention_max_distance,
                    bidirectional=bidirectional,
                    std=config.initializer_range,
                    dtype=dtype,
                    device=device,
                )
                for bidirectional in (True, False)
            )
        self.checkpoint_every = checkpoint_every
        self.remat_policy = resolve_remat_policy(checkpoint_policy, device)
        self.data_parallel_group = None  # the ranks the loss normalizes over (`ops/loss.py`)
        if device.type != "meta":  # on the meta device the weights come from a checkpoint
            self.init_weights(seed)

    @property
    def device(self) -> torch.device:
        return self.wte.weight.device

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        generator = torch.Generator(device=self.device).manual_seed(seed)
        for module in self.modules():
            if hasattr(module, "reset_parameters"):
                module.reset_parameters(generator)

    def _embed(self, ids: torch.Tensor, deterministic: bool) -> torch.Tensor:
        hidden_states = self.wte(ids)
        if self.config.m_emb is not None:
            hidden_states = hidden_states * self.config.m_emb
        if not deterministic and self.config.embd_pdrop > 0.0:
            hidden_states = F.dropout(hidden_states, self.config.embd_pdrop)
        return hidden_states

    def _rope(self, positions: torch.Tensor, dtype: torch.dtype):
        return None if self.rope_params is None else get_cos_sin(self.rope_params, positions[None, :], dtype=dtype)

    def _run(self, i: int, block: nn.Module, *args):
        if self.checkpoint_every and i % self.checkpoint_every == 0 and torch.is_grad_enabled():
            return remat_call(self.remat_policy, block, *args)
        return block(*args)

    def encode(
        self, input_ids: torch.Tensor, attention_mask: torch.Tensor | None = None, deterministic: bool = True
    ) -> torch.Tensor:
        """The bidirectional encoder pass: ``[B, S_enc, n_embd]`` after ``ln_enc``."""
        seq = input_ids.shape[1]
        hidden_states = self._embed(input_ids, deterministic)
        rope_cos_sin = self._rope(torch.arange(seq, device=input_ids.device), hidden_states.dtype)
        bias = None if self.rel_bias_enc is None else self.rel_bias_enc(seq, seq)
        for i, block in enumerate(self.encoder):
            hidden_states, _ = self._run(
                i, block, hidden_states, attention_mask, rope_cos_sin, bias, None, None, None, deterministic
            )
        return self.ln_enc(hidden_states)

    def forward(
        self,
        input_ids: torch.Tensor | None,
        attention_mask: torch.Tensor | None = None,
        decoder_input_ids: torch.Tensor | None = None,
        labels: torch.Tensor | None = None,
        encoder_hidden_states: torch.Tensor | None = None,
        kv_caches: list[KVCache] | None = None,
        cross_kv_caches: list[tuple[torch.Tensor, torch.Tensor]] | None = None,
        cache_index: torch.Tensor | int | None = None,
        deterministic: bool = True,
        compute_loss: bool = False,
    ) -> Seq2SeqOutput:
        """Logits ``[B, S_dec, V]`` and, with `labels` (unless decoding over caches without
        `compute_loss`), the mean token loss over the labels that are not IGNORE_INDEX."""
        config = self.config
        if encoder_hidden_states is None:
            encoder_hidden_states = self.encode(input_ids, attention_mask, deterministic)
        if decoder_input_ids is None:
            if labels is None:
                raise ValueError("the decoder needs decoder_input_ids or labels")
            pad = config.pad_token_id if config.pad_token_id is not None else 0
            decoder_input_ids = shift_right(labels, config.decoder_start_token_id, pad)

        seq = decoder_input_ids.shape[1]
        hidden_states = self._embed(decoder_input_ids, deterministic)
        offset = 0 if cache_index is None else cache_index
        key_length = seq if kv_caches is None else kv_caches[0]["k"].shape[1]
        positions = torch.arange(seq, device=hidden_states.device) + offset
        rope_cos_sin = self._rope(positions, hidden_states.dtype)
        bias = None if self.rel_bias_dec is None else self.rel_bias_dec(seq, key_length, query_offset=offset)

        new_caches = [] if kv_caches is not None else None
        for i, block in enumerate(self.decoder):
            hidden_states, cache = self._run(
                i, block, hidden_states, encoder_hidden_states, attention_mask, rope_cos_sin, bias,
                None if cross_kv_caches is None else cross_kv_caches[i],
                None if kv_caches is None else kv_caches[i], cache_index, deterministic,
            )
            if new_caches is not None:
                new_caches.append(cache)
        logits = self.compute_logits(self.ln_dec(hidden_states))

        loss = None
        if labels is not None and (compute_loss or kv_caches is None):
            # the targets as they are (the decoder's inputs are the shifted ones): the mean CE
            # over the labels that are not IGNORE_INDEX, over data-parallel ranks too
            loss = causal_lm_loss(
                logits, labels, upcast=config.upcast_logits_for_loss, labels=labels, group=self.data_parallel_group
            )
        return Seq2SeqOutput(
            logits=logits, loss=loss, encoder_hidden_states=encoder_hidden_states, kv_caches=new_caches
        )

    def compute_logits(self, hidden_states: torch.Tensor) -> torch.Tensor:
        if self.lm_head is None:
            logits = hidden_states.to(self.dtype) @ self.wte.table().T
        else:
            logits = self.lm_head(hidden_states)
        if self.config.m_width is not None:
            logits = logits / self.config.m_width
        return logits

    @torch.no_grad()
    def precompute_cross_kv(self, encoder_hidden_states: torch.Tensor) -> list[tuple[torch.Tensor, torch.Tensor]]:
        """Each decoder layer's cross-attention (K, V) of the encoder output, projected once
        for generation (passed back as `cross_kv_caches` at every step)."""
        return [block.cross_attn.project_kv(encoder_hidden_states) for block in self.decoder]

    def init_kv_caches(self, batch_size: int, max_length: int, dtype: torch.dtype | None = None) -> list[KVCache]:
        config = self.config
        shape = (batch_size, max_length, config.num_key_value_heads, config.head_dim)
        dtype = dtype or self.dtype
        return [
            {"k": torch.zeros(shape, dtype=dtype, device=self.device), "v": torch.zeros(shape, dtype=dtype, device=self.device)}
            for _ in range(config.n_layer)
        ]


def unstack_enc_dec_params(params: Mapping, n_encoder_layer: int, n_layer: int) -> dict:
    """A scanned tree (``encoder_scan`` / ``decoder_scan``, a leading layer axis on every
    leaf) as the unrolled ``encoder_<i>`` / ``decoder_<i>`` tree (the JAX function's, on
    numpy leaves)."""

    def index(tree, i):
        return {k: index(v, i) if isinstance(v, Mapping) else np.asarray(v)[i] for k, v in tree.items()}

    params = dict(params)
    enc = params.pop("encoder_scan")
    dec = params.pop("decoder_scan")
    for i in range(n_encoder_layer):
        params[f"encoder_{i}"] = index(enc, i)
    for i in range(n_layer):
        params[f"decoder_{i}"] = index(dec, i)
    return params


def jax_module_params(params: Mapping, model: EncDecDolomiteForSeq2SeqLM):
    """(flax subtree, torch module) pairs of the JAX package's enc-dec params tree,
    unrolled or scanned."""
    config = model.config
    if "encoder_scan" in params:
        params = unstack_enc_dec_params(params, config.n_encoder_layer, config.n_layer)
    yield params["wte"], model.wte
    for i, block in enumerate(model.encoder):
        yield from block.jax_module_params(params[f"encoder_{i}"])
    for i, block in enumerate(model.decoder):
        yield from block.jax_module_params(params[f"decoder_{i}"])
    yield params["ln_enc"], model.ln_enc
    yield params["ln_dec"], model.ln_dec
    if model.lm_head is not None:
        yield params["lm_head"], model.lm_head
    if model.rel_bias_enc is not None:
        yield params["rel_bias_enc"], model.rel_bias_enc
        yield params["rel_bias_dec"], model.rel_bias_dec
