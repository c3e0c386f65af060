"""Logits processors and per-slot token sampling for the serving engine.

Counterpart of `dolomite_engine_tpu/ops/sampling.py`'s vectorized path: temperature ->
top-k -> top-p over fp32 logits with per-row parameters, where the inert encodings mean
"processor off". Greedy rows take the argmax over fp32 logits (the first maximum wins,
as in JAX). Sampled rows draw Gumbel noise from their own `torch.Generator`, seeded from
the request, so a sampled stream is reproducible per request but differs from the JAX
package's by design (different generators).
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
    tiny = torch.finfo(torch.float32).tiny
    for s in rows:
        uniform = torch.rand(
            x.shape[-1], generator=generators[s], device=x.device, dtype=torch.float32
        ).clamp_min(tiny)
        gumbel = -torch.log(-torch.log(uniform))
        tokens[s] = (x[s] + gumbel).argmax()
    return tokens


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
