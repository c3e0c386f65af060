"""MoE ops: routing, the load-balancing loss and the dense all-experts reference.

Counterpart of `dolomite_engine_tpu/ops/moe.py`:

- `route`: top-k of the router logits, then a softmax over the selected logits in fp32,
  cast back to the logits' dtype. Ties break toward the lower expert index, as XLA's
  `top_k` does: a stable descending sort, whose first k columns are taken
  (`torch.topk` on CUDA promises no order among equal values, and bf16 logits over 32
  experts do tie).
- `load_balancing_loss`: the Switch / Mixtral auxiliary loss over all layers' logits,
  with an optional token mask; its top-k breaks ties the same way.
- `combine_weights` and `experts_eager`: the dense ``[T, E]`` combine matrix and the
  every-expert-on-every-token compute, the plain reference the grouped path
  (`ops/kernels/moe.py`) is pinned against; it keeps the JAX package's layout asserts
  (banks ``[E, d, f]`` / ``[E, f, d]``).

The expert-parallel all_to_all path (`experts_ep_a2a`) is not ported: it needs a mesh
(ROADMAP.md Queue A, 'Distribution').
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F


def top_k_stable(values: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(top values, their indices) along the last dim, ties to the lower index."""
    sorted_values, order = torch.sort(values, dim=-1, descending=True, stable=True)
    return sorted_values[..., :k], order[..., :k]


def route(router_logits: torch.Tensor, top_k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(router_weights [T, k] in the logits' dtype, selected_experts [T, k] int32)."""
    top_logits, selected = top_k_stable(router_logits, top_k)
    weights = torch.softmax(top_logits.float(), dim=-1)
    return weights.to(router_logits.dtype), selected.to(torch.int32)


def load_balancing_loss(
    router_logits: torch.Tensor,
    num_experts: int,
    top_k: int,
    token_mask: torch.Tensor | None = None,
    group=None,
) -> torch.Tensor:
    """``E * sum(tokens_per_expert * router_prob_per_expert)`` over
    `router_logits` ``[num_layers * tokens, E]``; `token_mask` ``[num_layers * tokens]``
    drops padded tokens from both statistics. With `group` (data-parallel ranks) both
    statistics are means over every rank's tokens, as over the JAX package's global
    batch: their sums and the token count are all-reduced, the router probabilities'
    through autograd, and each rank returns its share, the loss over the world (the
    ranks' losses and gradients are summed, `ops/loss.py`)."""
    routing_weights = torch.softmax(router_logits.float(), dim=-1)
    _, selected = top_k_stable(routing_weights, top_k)
    expert_mask = F.one_hot(selected, num_experts).float()  # [T, k, E]
    if group is not None:
        import torch.distributed as dist
        from torch.distributed.nn.functional import all_reduce

        m = torch.ones(routing_weights.shape[0], device=routing_weights.device) if token_mask is None else token_mask.float()
        counts = torch.cat([(expert_mask * m[:, None, None]).sum(0).reshape(-1), m.sum().reshape(1)])
        dist.all_reduce(counts, group=group)
        denom = counts[-1].clamp_min(1.0)
        tokens_per_expert = counts[:-1].reshape(top_k, num_experts) / denom
        router_prob_per_expert = all_reduce((routing_weights * m[:, None]).sum(0), group=group) / denom
        share = (tokens_per_expert * router_prob_per_expert[None, :]).sum() * num_experts
        return share / dist.get_world_size(group)
    if token_mask is None:
        tokens_per_expert = expert_mask.mean(0)  # [k, E]
        router_prob_per_expert = routing_weights.mean(0)  # [E]
    else:
        m = token_mask.float()
        denom = m.sum().clamp_min(1.0)
        tokens_per_expert = (expert_mask * m[:, None, None]).sum(0) / denom
        router_prob_per_expert = (routing_weights * m[:, None]).sum(0) / denom
    return (tokens_per_expert * router_prob_per_expert[None, :]).sum() * num_experts


def combine_weights(
    router_weights: torch.Tensor, selected_experts: torch.Tensor, num_experts: int
) -> torch.Tensor:
    """Dense ``[T, E]`` combine matrix from the top-k (weights, indices)."""
    one_hot = F.one_hot(selected_experts.long(), num_experts).to(router_weights.dtype)
    return torch.einsum("tk,tke->te", router_weights, one_hot)


def experts_eager(
    x: torch.Tensor,
    combine: torch.Tensor,
    w_fc: torch.Tensor,
    b_fc: torch.Tensor | None,
    w_proj: torch.Tensor,
    b_proj: torch.Tensor | None,
    act: Callable[[torch.Tensor], torch.Tensor],
) -> torch.Tensor:
    """Every expert on every token, weighted by `combine` ``[T, E]``. x ``[T, d]``;
    w_fc ``[E, d, f]`` (``[E, d, 2f]`` for GLU); w_proj ``[E, f, d]``."""
    assert w_fc.ndim == 3 and w_proj.ndim == 3, (w_fc.shape, w_proj.shape)
    num_experts, hidden, fc_out = w_fc.shape
    intermediate = w_proj.shape[1]
    assert tuple(w_proj.shape) == (num_experts, intermediate, hidden) and fc_out in (
        intermediate,
        2 * intermediate,
    ), (
        f"w_proj {tuple(w_proj.shape)} must be the [E, f, d] partner of w_fc "
        f"{tuple(w_fc.shape)} ([E, d, f] or [E, d, 2f] for GLU)"
    )
    assert x.shape[-1] == hidden and tuple(combine.shape) == (x.shape[0], num_experts), (
        x.shape,
        combine.shape,
        w_fc.shape,
    )
    assert x.dtype == w_fc.dtype == w_proj.dtype, (x.dtype, w_fc.dtype, w_proj.dtype)
    h = torch.einsum("td,edf->etf", x, w_fc)
    if b_fc is not None:
        h = h + b_fc[:, None, :]
    h = act(h)
    y = torch.einsum("etf,efd->etd", h, w_proj)
    if b_proj is not None:
        y = y + b_proj[:, None, :]
    return torch.einsum("etd,te->td", y, combine.to(y.dtype))
