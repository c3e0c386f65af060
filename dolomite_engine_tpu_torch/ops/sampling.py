"""Logits processors and token sampling for generation and the serving engine.

Counterpart of `dolomite_engine_tpu/ops/sampling.py`: the processors (`apply_temperature`,
`apply_top_k`, `apply_top_p`) and `sample_token` with one set of parameters for the batch
(`generation_utils.generate_tokens`), and the vectorized path with per-row parameters
(the engine), where the inert encodings mean "processor off". Greedy rows take the
argmax over fp32 logits (the first maximum wins, as in JAX). Sampled rows draw Gumbel
noise from an explicit `torch.Generator` (the engine's: one per request, seeded from
it), so a sampled stream is reproducible but differs from the JAX package's by design
(different generators).
"""

from __future__ import annotations

from collections.abc import Sequence

import numpy as np
import torch

NEG_INF = float(torch.finfo(torch.float32).min)

# encodings under which a processor is inert (x / 1.0 == x; k = 0 keeps every rank;
# p >= 1.0 keeps every token)
NO_TEMPERATURE = 1.0
NO_TOP_K = 0
NO_TOP_P = 1.0


def apply_temperature(logits: torch.Tensor, temperature: float) -> torch.Tensor:
    return logits / max(temperature, 1e-6)


def apply_top_k(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    """Keep the k highest logits of each row, mask the rest (HF TopKLogitsWarper)."""
    k = min(top_k, logits.shape[-1])
    kth_best = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth_best, torch.full_like(logits, NEG_INF), logits)


def apply_top_p(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Nucleus filtering (HF TopPLogitsWarper): keep the smallest set of tokens whose
    cumulative probability exceeds top_p; the most probable token always survives."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cumulative = torch.cumsum(probs, dim=-1)
    # keep tokens while the mass BEFORE them is < top_p
    keep = (cumulative - probs) < top_p
    keep[..., 0] = True
    threshold = torch.where(keep, sorted_logits, torch.full_like(sorted_logits, float("inf"))).amin(
        dim=-1, keepdim=True
    )
    return torch.where(logits < threshold, torch.full_like(logits, NEG_INF), logits)


def _gumbel_argmax(x: torch.Tensor, generator: torch.Generator | None) -> torch.Tensor:
    """A categorical draw per row of the logits `x`: argmax of x plus Gumbel noise."""
    uniform = torch.rand(
        x.shape, generator=generator, device=x.device, dtype=torch.float32
    ).clamp_min(torch.finfo(torch.float32).tiny)
    return (x - torch.log(-torch.log(uniform))).argmax(dim=-1)


def sample_token(
    logits: torch.Tensor,
    generator: torch.Generator | None = None,
    do_sample: bool = False,
    temperature: float | None = None,
    top_k: int | None = None,
    top_p: float | None = None,
) -> torch.Tensor:
    """Next tokens from [B, V] logits -> [B] int64: the argmax, or with `do_sample` a draw
    from `generator` after temperature -> top-k -> top-p."""
    logits = logits.float()
    if not do_sample:
        return logits.argmax(dim=-1)
    if temperature is not None:
        logits = apply_temperature(logits, temperature)
    if top_k is not None and top_k > 0:
        logits = apply_top_k(logits, top_k)
    if top_p is not None and top_p < 1.0:
        logits = apply_top_p(logits, top_p)
    return _gumbel_argmax(logits, generator)


def process_logits_vectorized(
    logits: torch.Tensor,
    temperature: torch.Tensor,
    top_k: torch.Tensor,
    top_p: torch.Tensor,
) -> torch.Tensor:
    """Temperature -> top-k -> top-p over [S, V] fp32 logits with per-row [S] params."""
    vocab = logits.shape[-1]
    x = logits / torch.clamp(temperature, min=1e-6)[:, None]

    # top-k as a per-row rank threshold: kth_best = the k-th largest logit
    k_eff = torch.where((top_k <= 0) | (top_k >= vocab), torch.full_like(top_k, vocab), top_k)
    sorted_x = torch.sort(x, dim=-1, descending=True).values
    kth_best = torch.gather(sorted_x, 1, (k_eff - 1).long()[:, None])
    x = torch.where(x < kth_best, torch.full_like(x, NEG_INF), x)

    # top-p over the top-k-filtered logits
    sorted_x = torch.sort(x, dim=-1, descending=True).values
    probs = torch.softmax(sorted_x, dim=-1)
    cumulative = torch.cumsum(probs, dim=-1)
    keep = (cumulative - probs) < top_p[:, None]
    keep[:, 0] = True
    keep = keep | (top_p >= 1.0)[:, None]
    threshold = torch.where(keep, sorted_x, torch.full_like(sorted_x, float("inf"))).amin(
        dim=-1, keepdim=True
    )
    return torch.where(x < threshold, torch.full_like(x, NEG_INF), x)


def sample_tokens_vectorized(
    logits: torch.Tensor,
    generators: Sequence[torch.Generator | None],
    do_sample: Sequence[bool] | np.ndarray,
    temperature: torch.Tensor,
    top_k: torch.Tensor,
    top_p: torch.Tensor,
) -> torch.Tensor:
    """Per-row next tokens from [S, V] logits -> [S] int64.

    `do_sample` is the host-side per-row flag and `generators[s]` row s's generator
    (unused for greedy rows); temperature/top_k/top_p are [S] tensors on the logits'
    device. An all-greedy batch pays one argmax."""
    logits = logits.float()
    greedy = logits.argmax(dim=-1)
    rows = [s for s, flag in enumerate(do_sample) if flag]
    if not rows:
        return greedy
    x = process_logits_vectorized(logits, temperature, top_k, top_p)
    tokens = greedy.clone()
    for s in rows:
        tokens[s] = _gumbel_argmax(x[s], generators[s])
    return tokens


def speculative_accept(
    logits: torch.Tensor,
    draft_tokens: torch.Tensor,
    num_drafts: torch.Tensor,
    generators: Sequence[torch.Generator | None],
    do_sample: Sequence[bool] | np.ndarray,
    temperature: torch.Tensor,
    top_k: torch.Tensor,
    top_p: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Speculative-decoding acceptance and bonus token of a verify step (the JAX
    package's `speculative_accept`, with the rng carry left to the generators).

    ``logits`` [S, K+1, V]: position i is the target's distribution for draft i+1, and
    position j gives the bonus token after j acceptances. The drafts ``draft_tokens`` [S,
    K] are deterministic proposals (a point-mass q), so the rejection rule is:

    - greedy rows accept draft i+1 iff it equals ``argmax(logits[i])``, so the accepted
      prefix plus the bonus is exactly what step-by-step greedy decode emits;
    - sampled rows accept draft i+1 with probability p(draft) under the processed
      (temperature -> top-k -> top-p) distribution; on a rejection the bonus is drawn
      from p with the rejected draft's mass removed, so emitted tokens follow p exactly.

    The first rejection ends a row's run; ``num_drafts`` [S] (<= K, 0 turns speculation
    off for the row) caps it. Each sampled row draws K uniforms and then V for the bonus's
    Gumbel noise, in one call on its own generator, in row order; greedy rows draw
    nothing. Returns ``(accepted [S], bonus [S])`` int64 on the logits' device."""
    rows, width, vocab = logits.shape
    k = width - 1
    device = logits.device
    logits = logits.float()
    greedy = logits.argmax(dim=-1)  # [S, K+1]
    draft_tokens = draft_tokens.to(device=device, dtype=torch.long)
    num_drafts = torch.as_tensor(num_drafts, device=device)
    positions = torch.arange(k, device=device)[None, :]
    sampled_rows = [s for s, flag in enumerate(do_sample) if flag]

    accept = draft_tokens == greedy[:, :k]
    if sampled_rows:
        flat = process_logits_vectorized(
            logits.reshape(rows * width, vocab),
            temperature.repeat_interleave(width),
            top_k.repeat_interleave(width),
            top_p.repeat_interleave(width),
        ).reshape(rows, width, vocab)
        probs = torch.softmax(flat, dim=-1)
        draws = torch.ones((rows, k + vocab), dtype=torch.float32, device=device)
        for s in sampled_rows:
            draws[s] = torch.rand(k + vocab, generator=generators[s], device=device)
        p_draft = torch.gather(probs[:, :k], 2, draft_tokens[:, :, None])[..., 0]
        sample_mask = torch.zeros(rows, dtype=torch.bool, device=device)
        sample_mask[sampled_rows] = True
        accept = torch.where(sample_mask[:, None], draws[:, :k] < p_draft, accept)
    accept = accept & (positions < num_drafts[:, None])
    # the leading run: draft i+1 conditions on draft i, so a rejection ends the run
    accepted = torch.cumprod(accept.long(), dim=1).sum(dim=1)

    bonus = torch.gather(greedy, 1, accepted[:, None])[:, 0]
    if sampled_rows:
        bonus_logits = torch.gather(flat, 1, accepted[:, None, None].expand(rows, 1, vocab))[:, 0]
        # on a rejection, remove the rejected draft's mass; with every draft accepted the
        # bonus samples the target distribution unmodified
        rejected = accepted < num_drafts
        rejected_token = torch.gather(draft_tokens, 1, accepted.clamp(max=k - 1)[:, None])
        residual = rejected[:, None] & (torch.arange(vocab, device=device)[None, :] == rejected_token)
        bonus_logits = torch.where(residual, torch.full_like(bonus_logits, NEG_INF), bonus_logits)
        uniform = draws[:, k:].clamp_min(torch.finfo(torch.float32).tiny)
        bonus_sampled = (bonus_logits - torch.log(-torch.log(uniform))).argmax(dim=-1)
        bonus = torch.where(sample_mask, bonus_sampled, bonus)
    return accepted, bonus


def encode_sampling_params(
    do_sample: bool,
    temperature: float | None,
    top_k: int | None,
    top_p: float | None,
) -> tuple[bool, float, int, float]:
    """One request's optional sampling params as the dense per-slot encoding:
    (do_sample, temperature, top_k, top_p)."""
    return (
        bool(do_sample),
        NO_TEMPERATURE if temperature is None else float(temperature),
        NO_TOP_K if top_k is None else int(top_k),
        NO_TOP_P if top_p is None else float(top_p),
    )
