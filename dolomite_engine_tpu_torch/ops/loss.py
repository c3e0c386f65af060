"""Causal-LM losses: plain cross entropy and the chunked fused LM-head loss.

Counterpart of `dolomite_engine_tpu/ops/loss.py`. `fused_linear_cross_entropy` keeps the
JAX package's custom-vjp contract: the forward cuts the sequence into chunks and reduces
each chunk's logits to ``(loss_sum, z_sum, num_tokens)`` through the ``fused_ce`` kernel
(`ops/kernels/fused_ce.py`), so the ``[B, S, V]`` logits never exist; the backward saves
only ``(hidden, labels, table)``, recomputes each chunk through the plain
`_chunk_ce_terms` body under autograd, and accumulates the table gradient in fp32 (none
for a frozen table).

Over data-parallel ranks (`group` given) a loss divides its local sums by the valid-token
count of the global batch, all-reduced: each rank's loss is its share of the JAX
package's loss over the batch-sharded global batch, whatever each rank's own count, and
FSDP2 sums the ranks' gradients (`distributed.shard_module`), so the reduced gradient is
that of ``sum / global_count``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .kernels.fused_ce import IGNORE_INDEX, fused_ce_chunk


def cross_entropy_terms(
    logits: torch.Tensor,
    labels: torch.Tensor,
    upcast: bool = True,
    want_z: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Token-level CE reduced to fp32 ``(loss_sum, z_sum, num_tokens)``; ``z_sum`` is the
    sum over valid tokens of ``logsumexp(logits)^2``, computed only when `want_z`."""
    if upcast:
        logits = logits.float()
    mask = labels != IGNORE_INDEX
    safe_labels = torch.where(mask, labels, torch.zeros_like(labels)).long()
    logprobs = torch.log_softmax(logits, dim=-1)
    token_logprobs = logprobs.gather(-1, safe_labels[..., None])[..., 0].float()
    loss_sum = -torch.where(mask, token_logprobs, torch.zeros_like(token_logprobs)).sum()
    num_tokens = mask.float().sum()
    z_sum = torch.zeros((), dtype=torch.float32, device=logits.device)
    if want_z:
        lse = torch.logsumexp(logits, dim=-1).float()
        z_sum = torch.where(mask, lse.square(), torch.zeros_like(lse)).sum()
    return loss_sum, z_sum, num_tokens


def derive_causal_labels(
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor | None = None,
    segment_ids: torch.Tensor | None = None,
) -> torch.Tensor:
    """`input_ids` shifted left by one; IGNORE_INDEX at the last position, at padding
    (attention_mask 0 / segment 0) and across document boundaries."""
    ignore = torch.full_like(input_ids[:, :1], IGNORE_INDEX)
    labels = torch.cat([input_ids[:, 1:], ignore], dim=1)
    if attention_mask is not None:
        shifted = torch.cat([attention_mask[:, 1:], torch.zeros_like(attention_mask[:, :1])], dim=1)
        labels = torch.where(shifted.bool(), labels, IGNORE_INDEX)
    if segment_ids is not None:
        next_seg = torch.cat([segment_ids[:, 1:], torch.zeros_like(segment_ids[:, :1])], dim=1)
        valid = (next_seg == segment_ids) & (segment_ids != 0)
        labels = torch.where(valid, labels, IGNORE_INDEX)
    return labels


def causal_lm_loss(
    logits: torch.Tensor,
    input_ids: torch.Tensor,
    upcast: bool = True,
    attention_mask: torch.Tensor | None = None,
    segment_ids: torch.Tensor | None = None,
    labels: torch.Tensor | None = None,
    z_loss_coef: float = 0.0,
    group=None,
) -> torch.Tensor:
    """Mean next-token CE over valid positions, plus ``z_loss_coef * mean(lse^2)``;
    `group`: the data-parallel ranks (`loss_denominator`)."""
    if labels is None:
        labels = derive_causal_labels(input_ids, attention_mask, segment_ids)
    loss_sum, z_sum, num_tokens = cross_entropy_terms(
        logits, labels, upcast=upcast, want_z=z_loss_coef != 0.0
    )
    denom = loss_denominator(num_tokens, group)
    loss = loss_sum / denom
    if z_loss_coef != 0.0:
        loss = loss + z_loss_coef * (z_sum / denom)
    return loss


def loss_denominator(num_tokens: torch.Tensor, group=None) -> torch.Tensor:
    """The divisor of a loss's token sums: this batch's valid-token count, or with `group`
    the global batch's (see the module docstring)."""
    if group is None:
        return num_tokens.clamp_min(1.0)
    total = num_tokens.detach().clone()
    dist.all_reduce(total, group=group)
    return total.clamp_min(1.0)


def _chunk_ce_terms(h, table, y, logit_scale, upcast, compute_dtype, want_z):
    """One chunk's LM-head product and CE reduction in plain PyTorch (the backward's
    recompute body; its ``[B, chunk, V]`` logits live only inside this call)."""
    logits = h.to(compute_dtype) @ table.T
    if logit_scale is not None:
        logits = logits * torch.tensor(logit_scale, dtype=logits.dtype, device=logits.device)
    return cross_entropy_terms(logits, y, upcast=upcast, want_z=want_z)


class _ChunkedCETerms(torch.autograd.Function):
    """(loss_sum, z_sum, num_tokens) over chunks; at most one chunk's logits live."""

    @staticmethod
    def forward(ctx, hidden_c, labels_c, table, logit_scale, upcast, compute_dtype, want_z):
        zero = torch.zeros((), dtype=torch.float32, device=hidden_c.device)
        loss_sum, z_sum, num_tokens = zero, zero, zero
        for h, y in zip(hidden_c, labels_c):
            chunk_loss, chunk_z, chunk_num = fused_ce_chunk(h, table, y, logit_scale=logit_scale)
            loss_sum = loss_sum + chunk_loss
            z_sum = z_sum + chunk_z
            num_tokens = num_tokens + chunk_num
        # the residuals are exactly the inputs: nothing logits-sized is saved
        ctx.save_for_backward(hidden_c, labels_c, table)
        ctx.options = (logit_scale, upcast, compute_dtype, want_z)
        ctx.mark_non_differentiable(num_tokens)
        return loss_sum, z_sum, num_tokens

    @staticmethod
    def backward(ctx, d_loss_sum, d_z_sum, _):
        hidden_c, labels_c, table = ctx.saved_tensors
        logit_scale, upcast, compute_dtype, want_z = ctx.options
        # a frozen table (a PEFT run's tied embedding) gets no gradient: no fp32 buffer, no adds
        want_table = ctx.needs_input_grad[2]
        dtable = torch.zeros(table.shape, dtype=torch.float32, device=table.device) if want_table else None
        dhidden = torch.empty_like(hidden_c)
        for i, (h, y) in enumerate(zip(hidden_c, labels_c)):
            with torch.enable_grad():
                h = h.detach().requires_grad_(True)
                t = table.detach().requires_grad_(want_table)
                loss_sum, z_sum, _ = _chunk_ce_terms(h, t, y, logit_scale, upcast, compute_dtype, want_z)
                outputs, cotangents = [loss_sum], [d_loss_sum]
                if want_z:
                    outputs.append(z_sum)
                    cotangents.append(d_z_sum)
                grads = torch.autograd.grad(outputs, (h, t) if want_table else (h,), cotangents)
            dhidden[i] = grads[0]
            if want_table:
                # fp32 accumulation across chunks whatever the table's compute dtype
                dtable += grads[1].float()
        return dhidden, None, None if dtable is None else dtable.to(table.dtype), None, None, None, None


def fused_linear_cross_entropy(
    hidden: torch.Tensor,
    embedding: torch.Tensor,
    labels: torch.Tensor,
    *,
    chunk_size: int = 256,
    upcast: bool = True,
    logit_scale: float | None = None,
    compute_dtype: torch.dtype = torch.bfloat16,
    z_loss_coef: float = 0.0,
    group=None,
) -> torch.Tensor:
    """LM-head product + CE without materializing the ``[B, S, V]`` logits, in either
    direction. hidden ``[B, S, H]``; embedding ``[V, H]`` (the tied table); labels
    ``[B, S]`` with IGNORE_INDEX. The sequence is padded up to a chunk multiple with
    ignored labels. `group`: the data-parallel ranks (`loss_denominator`)."""
    batch, seq, hidden_dim = hidden.shape
    chunk_size = min(chunk_size, seq)
    if seq % chunk_size:
        pad = chunk_size - seq % chunk_size
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=IGNORE_INDEX)
        seq += pad
    n_chunks = seq // chunk_size
    hidden_c = hidden.reshape(batch, n_chunks, chunk_size, hidden_dim).transpose(0, 1).contiguous()
    labels_c = labels.reshape(batch, n_chunks, chunk_size).transpose(0, 1).contiguous()
    loss_sum, z_sum, num_tokens = _ChunkedCETerms.apply(
        hidden_c, labels_c, embedding.to(compute_dtype), logit_scale, upcast, compute_dtype,
        z_loss_coef != 0.0,
    )
    denom = loss_denominator(num_tokens, group)
    loss = loss_sum / denom
    if z_loss_coef != 0.0:
        loss = loss + z_loss_coef * (z_sum / denom)
    return loss
