"""Delta-rule linear attention (DeltaNet) and its short causal convolution.

Counterpart of `dolomite_engine_tpu/ops/deltanet.py`, which is plain `lax` (no Pallas
kernel), so these are plain PyTorch too:

- `delta_rule_recurrent`: the step-by-step recurrence, a Python loop over time (JAX's
  `lax.scan`); the model takes it for decode steps and for lengths that do not divide
  into chunks.
- `delta_rule_chunked`: the chunkwise WY form. Everything that does not depend on the
  carried state (the triangular solve, ``w``, ``u``, the causal ``q k^T``) is computed
  for all chunks at once; only the state's recurrence over the chunks is a Python loop
  (JAX's `lax.scan` runs the whole chunk body in order), the same products in the same
  order a chunk.

The chunk's unit-lower-triangular solve runs in fp32 and is cast back: torch's
`linalg.solve_triangular` (and cuBLAS's trsm behind it) has no bf16 form, where JAX
solves in the inputs' dtype. For fp32 inputs the two are the same computation.

Recurrence (state ``S`` ``[dk, dv]`` a head)::

    S_t = (I - beta_t k_t k_t^T) S_{t-1} + beta_t k_t v_t^T
    o_t = S_t^T q_t

Shapes are head-major ``[B, H, L, D]``; beta ``[B, H, L]``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def delta_rule_recurrent(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    beta: torch.Tensor,
    initial_state: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Step-by-step delta rule. Returns (o ``[B, H, L, dv]``, final state ``[B, H, dk, dv]``)."""
    batch, heads, length, dk = q.shape
    dv = v.shape[-1]
    state = initial_state
    if state is None:
        state = torch.zeros(batch, heads, dk, dv, dtype=q.dtype, device=q.device)
    outputs = []
    for t in range(length):
        k_t = k[:, :, t]
        # error-correcting write: S += beta * k (v - S^T k)^T
        pred = torch.einsum("bhkv,bhk->bhv", state, k_t)
        delta = (v[:, :, t] - pred) * beta[:, :, t, None]
        state = state + torch.einsum("bhk,bhv->bhkv", k_t, delta)
        outputs.append(torch.einsum("bhkv,bhk->bhv", state, q[:, :, t]))
    return torch.stack(outputs, dim=2), state


def delta_rule_chunked(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    beta: torch.Tensor,
    chunk_size: int = 64,
    initial_state: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunkwise delta rule (WY representation). The length must divide into chunks
    (padded positions with beta 0 are no-ops on the state). Returns (o ``[B, H, L, dv]``,
    final state ``[B, H, dk, dv]``)."""
    batch, heads, length, dk = q.shape
    dv = v.shape[-1]
    if length % chunk_size != 0:
        raise ValueError(f"length {length} not a multiple of chunk {chunk_size}")
    n_chunks, c = length // chunk_size, chunk_size
    qc = q.reshape(batch, heads, n_chunks, c, dk)
    kc = k.reshape(batch, heads, n_chunks, c, dk)
    vc = v.reshape(batch, heads, n_chunks, c, dv)
    bc = beta.reshape(batch, heads, n_chunks, c)

    ones = torch.ones(c, c, dtype=torch.bool, device=q.device)
    zero = torch.zeros((), dtype=q.dtype, device=q.device)
    # T = (I + tril(diag(beta) K K^T, -1))^{-1} diag(beta): I + A is unit lower
    # triangular, and its solve against I is the exact inverse
    bk = kc * bc[..., None]
    a = torch.where(ones.tril(-1), bk @ kc.transpose(-1, -2), zero)
    eye = torch.eye(c, dtype=q.dtype, device=q.device)
    inv = torch.linalg.solve_triangular(
        (eye + a).float(), eye.float().expand(a.shape), upper=False, unitriangular=True
    ).to(q.dtype)
    t_mat = inv * bc[..., None, :]  # right-multiplied by diag(beta)
    w = t_mat @ kc  # [B, H, N, C, dk]
    u = t_mat @ vc  # [B, H, N, C, dv]
    scores = torch.where(ones.tril(), qc @ kc.transpose(-1, -2), zero)

    state = initial_state
    if state is None:
        state = torch.zeros(batch, heads, dk, dv, dtype=q.dtype, device=q.device)
    outputs = []
    for i in range(n_chunks):
        # pseudo-values corrected by the incoming state; outputs through the state plus
        # the chunk's causal attention on them
        u_prime = u[:, :, i] - w[:, :, i] @ state
        outputs.append(qc[:, :, i] @ state + scores[:, :, i] @ u_prime)
        state = state + kc[:, :, i].transpose(-1, -2) @ u_prime
    return torch.stack(outputs, dim=2).reshape(batch, heads, length, dv), state


def l2_norm(x: torch.Tensor) -> torch.Tensor:
    """``x / max(||x||, 1e-12)`` over the last axis (F.normalize)."""
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / norm.clamp_min(1e-12)


def sum_norm(x: torch.Tensor) -> torch.Tensor:
    return x / x.sum(dim=-1, keepdim=True)


def elu_p1(x: torch.Tensor) -> torch.Tensor:
    return F.elu(x) + 1.0


def short_convolution(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor | None = None,
    activation: str | None = "silu",
    conv_state: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Causal depthwise convolution over time: ``y[t] = sum_w weight[:, w] * padded[t + w]``
    where `padded` is the last ``W - 1`` inputs of the rolling `conv_state` ``[B, D, W]``
    followed by `x` ``[B, L, D]``; `weight` is ``[D, W]``. The window's products are
    summed in fp32 and rounded once. Returns (y ``[B, L, D]``, the new state: the last W
    inputs)."""
    batch, length, dim = x.shape
    width = weight.shape[-1]
    if conv_state is None:
        conv_state = torch.zeros(batch, dim, width, dtype=x.dtype, device=x.device)
    history = conv_state[..., -(width - 1):].transpose(1, 2).to(x.dtype)  # [B, W-1, D]
    padded = torch.cat([history, x], dim=1)  # [B, W-1+L, D]
    y = sum(padded[:, i : i + length].float() * weight[:, i].float() for i in range(width))
    y = y.to(x.dtype)
    if bias is not None:
        y = y + bias
    if activation == "silu":
        y = F.silu(y)
    return y, padded[:, -width:].transpose(1, 2)
