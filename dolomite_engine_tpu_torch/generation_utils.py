"""Fixed-batch autoregressive decoding over a preallocated dense KV cache.

Counterpart of `dolomite_engine_tpu/generation_utils.py`: one prefill over the
left-padded prompts with ``cache_index=0`` as a python int (the attention layer's
prefill fast path, which keeps the flash kernel eligible), then one decode step per new
token writing into the ``[B, prompt + max_new_tokens]`` cache. The JAX package compiles
the decode loop as one `lax.scan`; here it is an eager Python loop with the write offset
a python int, and sampled tokens come from one explicit `torch.Generator`.

EOS semantics match HF: a row stops growing once it emits `eos_token_id`; later slots are
filled with `pad_token_id`; `num_generated` counts emitted tokens including the EOS.
`generate_seq2seq_tokens` is the encoder-decoder's: one encoder pass, cross K/V projected
once, then the decoder steps over the dense cache (JAX's `lax.scan` over them).
"""

from __future__ import annotations

from typing import Any

import torch

from .models.enums import PositionEmbeddingType
from .ops.sampling import sample_token

# the JAX function's shape fault with an alibi bias (ROADMAP.md Queue C)
ALIBI_REFUSAL = (
    "generate_tokens does not take an alibi model: the JAX reference builds the bias over "
    "prompt + max_new_tokens keys while its prefill fast path attends over the prompt's "
    "own K/V, and raises on the shapes ((1, H, S, S) against (1, H, 1, S + max_new_tokens)). "
    "Generate from an alibi model through serving.ServingEngine (paged or dense), as "
    "generate.py does"
)


@torch.no_grad()
def generate_tokens(
    model: Any,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    generator: torch.Generator | None,
    max_new_tokens: int,
    do_sample: bool = False,
    temperature: float | None = None,
    top_k: int | None = None,
    top_p: float | None = None,
    eos_token_id: int | None = None,
    pad_token_id: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Decode `max_new_tokens` from left-padded prompts ``[B, W]`` on the model's device.

    Returns (generated [B, max_new_tokens] int64, num_generated [B] int64)."""
    if PositionEmbeddingType(model.config.position_embedding_type) == PositionEmbeddingType.alibi:
        raise ValueError(ALIBI_REFUSAL)
    device = model.device
    input_ids = input_ids.to(device)
    attention_mask = attention_mask.to(device)
    batch, prompt_len = input_ids.shape
    total = prompt_len + max_new_tokens

    # left-padded prompts: position ids count real tokens; pad positions clamp to 0
    position_ids = (torch.cumsum(attention_mask, dim=1) - 1).clamp_min(0)
    num_real = attention_mask.sum(dim=1)
    # key-side mask over the whole cache: prompt padding stays masked, generated slots visible
    full_mask = torch.cat(
        [attention_mask, torch.ones((batch, max_new_tokens), dtype=attention_mask.dtype, device=device)], dim=1
    )
    caches = model.init_kv_caches(batch, total)
    sampling = dict(do_sample=do_sample, temperature=temperature, top_k=top_k, top_p=top_p)

    prefill = model(
        input_ids, position_ids=position_ids, attention_mask=full_mask, kv_caches=caches, cache_index=0
    )
    token = sample_token(prefill.logits[:, -1], generator, **sampling)
    finished = torch.zeros(batch, dtype=torch.bool, device=device)
    if eos_token_id is not None:
        finished = token == eos_token_id
    tokens = [token]
    for i in range(max_new_tokens - 1):
        # token i is written at cache slot prompt_len + i with position num_real + i; its
        # logits give token i + 1
        out = model(
            token[:, None], position_ids=(num_real + i)[:, None], attention_mask=full_mask,
            kv_caches=caches, cache_index=prompt_len + i,
        )
        token = sample_token(out.logits[:, -1], generator, **sampling)
        # rows already finished emit padding and stay finished
        token = torch.where(finished, torch.full_like(token, pad_token_id), token)
        if eos_token_id is not None:
            finished = finished | (token == eos_token_id)
        tokens.append(token)
    return _trim_after_eos(torch.stack(tokens, dim=1), max_new_tokens, eos_token_id, pad_token_id)


def _trim_after_eos(
    generated: torch.Tensor, max_new_tokens: int, eos_token_id: int | None, pad_token_id: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """HF stop semantics: count tokens through the first EOS, pad everything after."""
    batch = generated.shape[0]
    if eos_token_id is None:
        return generated, torch.full((batch,), max_new_tokens, dtype=torch.long, device=generated.device)
    is_eos = generated == eos_token_id
    first_eos = is_eos.int().argmax(dim=1)
    num_generated = torch.where(is_eos.any(dim=1), first_eos + 1, max_new_tokens)
    keep = torch.arange(max_new_tokens, device=generated.device)[None, :] < num_generated[:, None]
    return torch.where(keep, generated, torch.full_like(generated, pad_token_id)), num_generated


@torch.no_grad()
def generate_seq2seq_tokens(
    model: Any,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    generator: torch.Generator | None,
    max_new_tokens: int,
    do_sample: bool = False,
    temperature: float | None = None,
    top_k: int | None = None,
    top_p: float | None = None,
    eos_token_id: int | None = None,
    pad_token_id: int = 0,
    decoder_start_token_id: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Encoder-decoder decoding: the prompts ``[B, W]`` (left-padded) are the encoder's
    inputs, encoded once; each decoder layer's cross-attention K/V is projected once
    (`precompute_cross_kv`); then `max_new_tokens` decoder steps from
    `decoder_start_token_id`, each one token over the dense ``[B, max_new_tokens]``
    self-attention cache at a python-int write offset. Rows that emitted EOS emit padding.

    Returns (generated [B, max_new_tokens] int64, num_generated [B] int64)."""
    device = model.device
    input_ids = input_ids.to(device)
    attention_mask = attention_mask.to(device)
    batch = input_ids.shape[0]
    encoder_hidden_states = model.encode(input_ids, attention_mask)
    cross_kv_caches = model.precompute_cross_kv(encoder_hidden_states)
    caches = model.init_kv_caches(batch, max_new_tokens)
    sampling = dict(do_sample=do_sample, temperature=temperature, top_k=top_k, top_p=top_p)
    token = torch.full((batch,), decoder_start_token_id, dtype=torch.long, device=device)
    finished = torch.zeros(batch, dtype=torch.bool, device=device)
    tokens = []
    for i in range(max_new_tokens):
        out = model(
            None, attention_mask=attention_mask, decoder_input_ids=token[:, None],
            encoder_hidden_states=encoder_hidden_states, kv_caches=caches, cross_kv_caches=cross_kv_caches,
            cache_index=i,
        )
        token = sample_token(out.logits[:, -1], generator, **sampling)
        token = torch.where(finished, torch.full_like(token, pad_token_id), token)
        if eos_token_id is not None:
            finished = finished | (token == eos_token_id)
        tokens.append(token)
    return _trim_after_eos(torch.stack(tokens, dim=1), max_new_tokens, eos_token_id, pad_token_id)


def make_generate_fn(model: Any, is_encoder_decoder: bool = False, **static_kwargs):
    """A decode closure over a fixed model and generation settings: ``fn(input_ids,
    attention_mask, generator)``. Nothing is compiled; `ModelWrapper.generate` keeps one per
    settings as the JAX package keeps its jitted ones."""
    decode = generate_seq2seq_tokens if is_encoder_decoder else generate_tokens

    def fn(input_ids, attention_mask, generator=None):
        return decode(model, input_ids, attention_mask, generator, **static_kwargs)

    return fn
