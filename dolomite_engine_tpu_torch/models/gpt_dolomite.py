"""GPTDolomite, the dense decoder: serving and generation (paged or dense KV cache), and training.

Counterpart of `dolomite_engine_tpu/models/gpt_dolomite.py`: `GPTDolomiteModel` and
`GPTDolomiteForCausalLM` with learned-absolute, rope (+ YaRN), alibi and nope positions, µP
multipliers, a tied or untied LM head, packed documents through segment ids, the loss
path (the chunked fused LM-head loss or plain logits + CE) and every-k-th-block
activation checkpointing under the JAX remat policies (`models/remat.py`). Module names
follow the flax parameter tree (``transformer.wte``, ``transformer.h.<i>.attn.c_attn``,
...), so `load_jax_params` maps the JAX package's unrolled params one to one. No scan: torch runs the blocks in a
Python loop.

The hooks the JAX base class gives other families are kept: `GPTDolomiteModel.block_cls`,
`num_blocks` (one block a KV group in `models/gpt_crosslayer.py`) and `_make_block(i,
...)` (block i's options: the hybrid's mixer in `models/rnn_dolomite.py`) build the
blocks, `GPTDolomiteForCausalLM.init_kv_caches` gives one `dense_kv_cache` a block unless
a family overrides it, the loop collects each block's extra outputs (MoE router logits)
with and without remat, and `compute_aux_loss` turns them into a loss added once on
either loss path (`models/moe_dolomite.py`). Every block takes `Block.forward`'s
arguments in its order and carries `tag_attention_out`, which `set_remat` sets.
"""

from __future__ import annotations

from collections.abc import Mapping
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..enums import AttentionImplementation
from ..ops.fp8 import fp8_qdq
from ..ops.loss import causal_lm_loss, derive_causal_labels, fused_linear_cross_entropy
from ..ops.rope import RoPEParams
from .config import CommonConfig
from .enums import PositionEmbeddingType
from .modeling_utils import (
    Block,
    KVCache,
    ParameterizedEmbedding,
    ParameterizedLinear,
    compute_position_stuff,
    get_norm,
)
from .remat import REMAT_POLICY_NAMES, RematPolicy, remat_call, resolve_remat_policy  # noqa: F401

@dataclass
class CausalLMOutput:
    logits: torch.Tensor | None = None
    kv_caches: list[KVCache] | None = None
    loss: torch.Tensor | None = None
    aux_loss: torch.Tensor | None = None


class GPTDolomiteModel(nn.Module):
    block_cls: type = Block

    def __init__(
        self,
        config: CommonConfig,
        dtype: torch.dtype,
        device: torch.device,
        param_dtype: torch.dtype | None = None,
        attention_implementation: AttentionImplementation | str = AttentionImplementation.sdpa,
        checkpoint_every: int = 0,
        checkpoint_policy: str | None = None,
        **block_kwargs,
    ) -> None:
        super().__init__()
        self.config = config
        self.pe_type = PositionEmbeddingType(config.position_embedding_type)
        self.wte = ParameterizedEmbedding(
            config.vocab_size, config.n_embd, config.initializer_range, dtype, device, param_dtype
        )
        self.wpe = (
            ParameterizedEmbedding(
                config.n_positions, config.n_embd, config.initializer_range, dtype, device,
                param_dtype,
            )
            if self.pe_type == PositionEmbeddingType.learned_absolute
            else None
        )
        self.h = nn.ModuleList(
            self._make_block(i, dtype, device, param_dtype, attention_implementation, **block_kwargs)
            for i in range(self.num_blocks)
        )
        self.ln_f = get_norm(config, device)
        self.set_remat(checkpoint_every, checkpoint_policy)
        self.rope_params = (
            RoPEParams.from_config(
                config.head_dim,
                base=config.rope_theta,
                rope_scaling=config.rope_scaling,
                max_position_embeddings=config.n_positions,
            )
            if self.pe_type == PositionEmbeddingType.rope
            else None
        )

    @property
    def num_blocks(self) -> int:
        """The number of blocks (cross-layer KV sharing builds one a KV group)."""
        return self.config.n_layer

    def _make_block(
        self,
        i: int,
        dtype: torch.dtype,
        device: torch.device,
        param_dtype: torch.dtype | None,
        attention_implementation: AttentionImplementation | str,
        **block_kwargs,
    ) -> nn.Module:
        """Block `i` of the stack."""
        return self.block_cls(
            self.config, dtype, device, param_dtype, attention_implementation, **block_kwargs
        )

    def set_remat(self, checkpoint_every: int, policy: str | RematPolicy | None = None) -> None:
        """Remat every `checkpoint_every`-th block (0: none) under `policy`, a name of
        either vocabulary (`models/remat.py`); the blocks tag their attention output only
        when the policy keeps it."""
        self.checkpoint_every = checkpoint_every
        if not isinstance(policy, RematPolicy):
            policy = resolve_remat_policy(policy, self.wte.weight.device)
        self.remat_policy = policy
        for i, block in enumerate(self.h):
            rematted = bool(checkpoint_every) and i % checkpoint_every == 0
            block.tag_attention_out = rematted and bool(policy.save_names)

    def forward(
        self,
        input_ids: torch.Tensor,
        position_ids: torch.Tensor | None = None,
        attention_mask: torch.Tensor | None = None,
        kv_caches: list[KVCache] | None = None,
        cache_index: torch.Tensor | int | None = None,
        segment_ids: torch.Tensor | None = None,
        deterministic: bool = True,
        inputs_embeds: torch.Tensor | None = None,
    ) -> tuple[torch.Tensor, list[KVCache] | None, list[torch.Tensor]]:
        """(final hidden states, new caches, the blocks' extra outputs in layer order).
        `inputs_embeds` ``[B, S, n_embd]`` (prompt tuning's virtual tokens before the
        embedded ids) replaces the embedding lookup; `input_ids` then gives only the shape."""
        config = self.config
        batch, seq = input_ids.shape
        hidden_states = self.wte(input_ids) if inputs_embeds is None else inputs_embeds
        if position_ids is None:
            position_ids = torch.arange(seq, device=input_ids.device)[None, :]
            if isinstance(cache_index, torch.Tensor) and cache_index.ndim == 1:
                position_ids = position_ids + cache_index[:, None]
            elif cache_index is not None:
                position_ids = position_ids + cache_index
        if self.wpe is not None:
            hidden_states = hidden_states + self.wpe(position_ids)
        if config.m_emb is not None:
            hidden_states = hidden_states * config.m_emb
        if not deterministic and config.embd_pdrop > 0.0:
            hidden_states = F.dropout(hidden_states, config.embd_pdrop)

        # the first K/V cache gives the key length (the hybrid's DeltaNet layers hold
        # recurrent states); a paged cache gathers to max_pages * page_size keys
        key_length = seq
        cache = next((c for c in kv_caches or () if "k" in c), None)
        if cache is not None:
            key_length = (
                cache["page_table"].shape[1] * cache["k"].shape[1]
                if "page_table" in cache
                else cache["k"].shape[1]
            )
        rope_cos_sin, alibi_bias = compute_position_stuff(
            config, position_ids, self.rope_params, config.n_head, attention_mask, batch,
            key_length, hidden_states.dtype,
        )
        new_caches = [] if kv_caches is not None else None
        extras = []  # per-block extra outputs (MoE router logits)
        for i, block in enumerate(self.h):
            cache = None if kv_caches is None else kv_caches[i]
            if self.checkpoint_every and i % self.checkpoint_every == 0 and cache is None:
                # the block's input and what the policy keeps survive the forward; the
                # backward reruns the block (kernels included) to rebuild the rest
                out = remat_call(
                    self.remat_policy, block, hidden_states, attention_mask, rope_cos_sin,
                    alibi_bias, None, cache_index, segment_ids, deterministic,
                )
            else:
                out = block(
                    hidden_states, attention_mask, rope_cos_sin, alibi_bias, cache,
                    cache_index, segment_ids, deterministic,
                )
            hidden_states, cache = out[0], out[1]
            extras.extend(out[2:])
            if new_caches is not None:
                new_caches.append(cache)
        return self.ln_f(hidden_states), new_caches, extras


class GPTDolomiteForCausalLM(nn.Module):
    """The causal LM. Built on `device` (default the GPU; raises without one unless
    ``device="cpu"``) with random weights from `seed`, following the JAX init rules:
    std ``initializer_range`` for embeddings and input projections, depth-scaled
    ``c_proj``, µP's division by ``sqrt(m_width)``, norms at 1 and biases at 0.

    `dtype` is the compute dtype; `param_dtype` (default `dtype`) the storage of the
    linear and embedding weights — fp32 master weights for training, as the JAX
    package's modules keep them. `checkpoint_every` k reruns every k-th block in the
    backward under `checkpoint_policy` (`models/remat.py`; default ``full``). Further
    keyword arguments go to every block (a family's block options, e.g. MoE's ``moe_implementation``).

    The config's ``model_type`` must be this class's: a config of another family raises
    instead of building a dense model (`models.get_model_class` picks the class)."""

    model_type: str = "gpt_dolomite"
    base_model_cls: type = GPTDolomiteModel

    def __init__(
        self,
        config: CommonConfig,
        dtype: torch.dtype = torch.float32,
        device: str | torch.device = "cuda",
        seed: int = 0,
        param_dtype: torch.dtype | None = None,
        attention_implementation: AttentionImplementation | str = AttentionImplementation.sdpa,
        checkpoint_every: int = 0,
        checkpoint_policy: str | None = None,
        **block_kwargs,
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
        self.transformer = self.base_model_cls(
            config, dtype, device, param_dtype, attention_implementation, checkpoint_every,
            checkpoint_policy, **block_kwargs,
        )
        self.lm_head = (
            None
            if config.tie_word_embeddings
            else ParameterizedLinear(
                config.n_embd, config.vocab_size, False, config.initializer_range, dtype, device,
                param_dtype,
            )
        )
        self.fp8 = None  # an fp8 model's state slot (`ops/fp8.enable_fp8`)
        # the data-parallel ranks a wrapped model's losses normalize over (`ops/loss.py`)
        self.data_parallel_group = None
        if device.type != "meta":  # on the meta device the weights come from a checkpoint
            self.init_weights(seed)

    @property
    def fp8_qdq_names(self) -> tuple[str, ...]:
        """The tied head's e4m3 quantize-dequantize points (the hidden states and the
        table) in an fp8 model; an untied head is an fp8 dot of its own."""
        return ("lm_head_in", "lm_head_kernel") if self.lm_head is None else ()

    def _lm_head_operands(self, hidden_states: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(hidden, table) of the tied head in the compute dtype, e4m3 quantize-dequantized
        in an fp8 model."""
        hidden, table = hidden_states.to(self.dtype), self.transformer.wte.table()
        if self.fp8 is not None:
            return fp8_qdq(hidden, self.fp8, "lm_head_in"), fp8_qdq(table, self.fp8, "lm_head_kernel")
        return hidden, table

    @property
    def device(self) -> torch.device:
        return self.transformer.wte.weight.device

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        generator = torch.Generator(device=self.device).manual_seed(seed)
        for module in self.modules():
            if hasattr(module, "reset_parameters"):
                module.reset_parameters(generator)

    def forward(
        self,
        input_ids: torch.Tensor,
        position_ids: torch.Tensor | None = None,
        attention_mask: torch.Tensor | None = None,
        kv_caches: list[KVCache] | None = None,
        cache_index: torch.Tensor | int | None = None,
        segment_ids: torch.Tensor | None = None,
        labels: torch.Tensor | None = None,
        deterministic: bool = True,
        compute_loss: bool = False,
        inputs_embeds: torch.Tensor | None = None,
    ) -> CausalLMOutput:
        """Logits, or with `labels` / `compute_loss` the mean next-token loss: through the
        chunked fused LM-head loss (no logits) when the config asks for it, else plain
        logits + CE (labels derived from `input_ids` when not given). The family's
        auxiliary loss (`compute_aux_loss`) is added once to either."""
        config = self.config
        hidden_states, new_caches, extras = self.transformer(
            input_ids,
            position_ids=position_ids,
            attention_mask=attention_mask,
            kv_caches=kv_caches,
            cache_index=cache_index,
            segment_ids=segment_ids,
            deterministic=deterministic,
            inputs_embeds=inputs_embeds,
        )
        want_loss = compute_loss or labels is not None
        # CommonConfig only allows the fused loss with tied embeddings
        if want_loss and config.fused_lm_head_loss and kv_caches is None:
            if labels is None:
                labels = derive_causal_labels(input_ids, attention_mask, segment_ids)
            head_in, head_table = self._lm_head_operands(hidden_states)
            loss = fused_linear_cross_entropy(
                head_in,
                head_table,
                labels,
                chunk_size=config.loss_chunk_size,
                upcast=config.upcast_logits_for_loss,
                logit_scale=None if config.m_width is None else 1.0 / config.m_width,
                compute_dtype=self.dtype,
                z_loss_coef=config.z_loss_coef,
                group=self.data_parallel_group,
            )
            logits = None
        else:
            logits = self.compute_logits(hidden_states)
            loss = None
            if want_loss:
                loss = causal_lm_loss(
                    logits,
                    input_ids,
                    upcast=config.upcast_logits_for_loss,
                    attention_mask=attention_mask,
                    segment_ids=segment_ids,
                    labels=labels,
                    z_loss_coef=config.z_loss_coef,
                    group=self.data_parallel_group,
                )
        aux_loss = None
        if want_loss:
            aux_loss = self.compute_aux_loss(extras, attention_mask, segment_ids)
            if aux_loss is not None:
                loss = loss + aux_loss
        return CausalLMOutput(logits=logits, kv_caches=new_caches, loss=loss, aux_loss=aux_loss)

    def compute_aux_loss(
        self,
        extras: list[torch.Tensor],
        attention_mask: torch.Tensor | None,
        segment_ids: torch.Tensor | None,
    ) -> torch.Tensor | None:
        """Hook for MoE families: an auxiliary loss from the blocks' extra outputs."""
        return None

    def compute_logits(self, hidden_states: torch.Tensor) -> torch.Tensor:
        if self.lm_head is None:
            head_in, head_table = self._lm_head_operands(hidden_states)
            logits = head_in @ head_table.T
        else:
            logits = self.lm_head(hidden_states)
        if self.config.m_width is not None:
            logits = logits / self.config.m_width
        return logits

    def dense_kv_cache(
        self, batch_size: int, max_length: int, dtype: torch.dtype | None = None
    ) -> KVCache:
        """One block's K/V cache ``{"k", "v": [batch_size, max_length, Hkv, D]}`` of
        zeros (`dtype`, default the compute dtype)."""
        config = self.config
        shape = (batch_size, max_length, config.num_key_value_heads, config.head_dim)
        dtype = dtype or self.dtype
        return {
            "k": torch.zeros(shape, dtype=dtype, device=self.device),
            "v": torch.zeros(shape, dtype=dtype, device=self.device),
        }

    def init_kv_caches(
        self, batch_size: int, max_length: int, dtype: torch.dtype | None = None
    ) -> list[KVCache]:
        """One cache a block, in block order (the serving pools size themselves from it)."""
        return [
            self.dense_kv_cache(batch_size, max_length, dtype)
            for _ in range(self.transformer.num_blocks)
        ]


def _jax_module_params(params: Mapping, model: GPTDolomiteForCausalLM):
    """(flax subtree, torch module) pairs of the unrolled JAX params tree (an
    encoder-decoder model's: `enc_dec_dolomite.jax_module_params`)."""
    if model.model_type == "enc_dec_dolomite":
        from .enc_dec_dolomite import jax_module_params

        yield from jax_module_params(params, model)
        return
    t = params["transformer"]
    yield t["wte"], model.transformer.wte
    if model.transformer.wpe is not None:
        yield t["wpe"], model.transformer.wpe
    for i, block in enumerate(model.transformer.h):
        yield from block.jax_module_params(t[f"h_{i}"])
    yield t["ln_f"], model.transformer.ln_f
    if model.lm_head is not None:
        yield params["lm_head"], model.lm_head


def _jax_leaves(params: Mapping, model: GPTDolomiteForCausalLM):
    """(flax name, array in the torch layout, torch tensor) for every leaf of a tree shaped
    like the unrolled JAX params (the params, or optax's moments of them): flax ``[in,
    out]`` linear kernels and LoRA adapters transposed to torch's ``[out, in]``; expert
    banks (3-D ``[E, in, out]``, the grouped GEMM's layout) and their ``[E, out]`` biases
    as they are. A PEFT tree's base comes from its ``base_model`` key and its
    ``prompt_embeddings`` as they are. A shape that does not match raises."""
    if "params" in params:
        params = params["params"]
    if "base_model" in params:  # a PEFT model's tree: the base under "base_model"
        if "prompt_embeddings" in params:
            array = np.asarray(params["prompt_embeddings"]).astype(np.float32)
            if tuple(array.shape) != tuple(model.prompt_embeddings.shape):
                raise ValueError(f"prompt_embeddings: shape {array.shape} does not match {tuple(model.prompt_embeddings.shape)}")
            yield "prompt_embeddings", array, model.prompt_embeddings
        params = params["base_model"]
        model = getattr(model, "base_model", model)  # prompt tuning wraps; LoRA adapts in place
    names = {"kernel": "weight", "embedding": "weight", "weight": "weight", "bias": "bias"}
    for tree, module in _jax_module_params(params, model):
        for flax_name, value in tree.items():
            target = getattr(module, names.get(flax_name, flax_name), None)
            if target is None:
                raise KeyError(f"unexpected parameter {flax_name!r} for {type(module).__name__}")
            # float32 first: numpy cannot hand bfloat16 (optax's bf16 first moment) to torch
            array = np.asarray(value).astype(np.float32)
            if flax_name in ("kernel", "lora_a", "lora_b") and array.ndim == 2:
                array = array.T
            if tuple(array.shape) != tuple(target.shape):
                raise ValueError(
                    f"{flax_name} of {type(module).__name__}: shape {array.shape} does not "
                    f"match {tuple(target.shape)}"
                )
            yield flax_name, array, target


@torch.no_grad()
def load_jax_params(
    model: GPTDolomiteForCausalLM, params_np: Mapping, device: str | torch.device = "cuda"
) -> GPTDolomiteForCausalLM:
    """Move `model` to `device` and fill it from the JAX package's unrolled GPTDolomite
    params (nested dicts of numpy arrays under the flax names: ``transformer.wte``,
    ``h_<i>.attn.c_attn``, ..., with or without a top-level ``params`` key), or an
    EncDecDolomite's (``encoder_<i>``, ``decoder_<i>`` with ``cross_attn.{c_q, c_kv,
    c_proj}``, both ``rel_bias_*`` tables, ``ln_enc``, ``ln_dec``, ``lm_head``; a scanned
    tree is unstacked first). Flax
    ``[in, out]`` linear kernels become torch ``[out, in]`` weights in the parameter's
    dtype: a training model's fp32 master weights take the JAX fp32 params exactly.
    Expert banks (3-D ``[E, in, out]`` kernels, the grouped GEMM's layout) and their
    ``[E, out]`` biases are copied as they are; a bank in another layout fails the shape
    check. A PEFT model (LoRA adapters in place, or `PromptTuningCausalLM`) takes the
    JAX PEFT tree: the base under ``base_model``, the adapters beside their kernels. The
    caller converts JAX arrays with ``np.asarray``; this imports no JAX."""
    model.to(resolve_device(device))
    for _, array, target in _jax_leaves(params_np, model):
        target.copy_(torch.from_numpy(np.ascontiguousarray(array)))
    return model


@torch.no_grad()
def load_jax_train_state(state, jax_state) -> None:
    """Continue a JAX training run in the port: fill `state` (the port's `TrainState`: its
    model and `TorchAdamW`) from the JAX package's `TrainState` with numpy leaves
    (``jax.tree.map(np.asarray, state)``): the step, the params, and the optax AdamW
    state, found by its fields: the `ScaleByAdamState` (``count``, ``mu``, ``nu``: the
    bias correction's counter and the moments, the first in its `mu_dtype`) and the
    `ScaleByScheduleState` (``count``: the schedule's). The model stays on its device."""
    model = state.model
    index = {id(p): i for i, p in enumerate(state.optimizer.params)}
    adam = schedule = None
    for entry in jax_state.opt_state:
        fields = getattr(entry, "_fields", ())
        if {"count", "mu", "nu"} <= set(fields):
            adam = entry
        elif fields == ("count",):
            schedule = entry
    if adam is None or schedule is None:
        raise ValueError("the optimizer state holds no AdamW moments and schedule counter")
    for _, array, target in _jax_leaves(jax_state.params, model):
        target.copy_(torch.from_numpy(np.ascontiguousarray(array)))
    for moments, tree in ((state.optimizer.mu, adam.mu), (state.optimizer.nu, adam.nu)):
        for _, array, target in _jax_leaves(tree, model):
            moments[index[id(target)]].copy_(torch.from_numpy(np.ascontiguousarray(array)))
    state.step = int(jax_state.step)
    state.optimizer.count = int(adam.count)
    state.optimizer.schedule_count = int(schedule.count)
