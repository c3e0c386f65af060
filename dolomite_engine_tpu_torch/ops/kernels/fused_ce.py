"""Fused LM-head cross-entropy chunk: the CUDA kernel and its plain version.

Replaces the TPU kernel ``fused_ce_rowwise`` (`dolomite_engine_tpu/ops/pallas/fused_ce.py`):
per token row, ``logsumexp(h @ T^T * scale)`` and the label's logit, without writing the
``[rows, V]`` logits to device memory. Bound on the H100 by the bytes of the table each
call reads (the dense chunk) or by its operations (the MoE and alibi chunks). For bf16 a
persistent grid of `wgmma` CTAs, fed by TMA, walks vocab ranges so that each launch reads
the table from device memory once, and folds each row's logits into per-range partials
that a second launch combines (see ``dolomite_engine_tpu_torch/csrc/fused_ce.cu``).

`fused_ce_rowwise` launches the kernel for CUDA tensors (or raises) and takes the plain
version for CPU tensors. `fused_ce_chunk` reduces one loss chunk to
``(loss_sum, z_sum, num_tokens)`` through it, as the JAX package's does.
"""

from __future__ import annotations

import torch

from ._build import DTYPE_CODES, KernelSpec, check_cuda_tensor, check_launch, current_stream, load_library, ptr

KERNEL = KernelSpec(
    name="fused_ce",
    source="dolomite_engine_tpu_torch/csrc/fused_ce.cu",
    replaces="dolomite_engine_tpu/ops/pallas/fused_ce.py:104",
)

IGNORE_INDEX = -100  # ops/loss.IGNORE_INDEX (kept here so the kernel module stands alone)
HIDDEN_MULTIPLE = 32  # fp32 streams H in 32-wide slices; bf16 in 64-wide TMA boxes, zero-filled past H


def _check_shapes(hidden, table, labels):
    if hidden.ndim != 2 or table.ndim != 2 or hidden.shape[1] != table.shape[1]:
        raise ValueError(f"hidden {tuple(hidden.shape)} and table {tuple(table.shape)} must be [rows, H] and [V, H]")
    if labels.shape != hidden.shape[:1]:
        raise ValueError(f"labels {tuple(labels.shape)} must be [rows] = {tuple(hidden.shape[:1])}")
    if hidden.dtype != table.dtype:
        raise ValueError(f"hidden ({hidden.dtype}) and table ({table.dtype}) must share the compute dtype")


def fused_ce_rowwise_plain(hidden, table, labels, logit_scale=None):
    """Per-row (logsumexp, label logit) in fp32 from logits computed in the compute dtype
    and scaled in it; a label outside ``[0, V)`` gives a label logit of 0."""
    _check_shapes(hidden, table, labels)
    vocab = table.shape[0]
    logits = hidden @ table.T
    if logit_scale is not None:
        logits = logits * torch.tensor(logit_scale, dtype=logits.dtype, device=logits.device)
    logits = logits.float()
    hit = (labels >= 0) & (labels < vocab)
    picked = logits.gather(1, labels.clamp(0, vocab - 1).long()[:, None])[:, 0]
    return torch.logsumexp(logits, dim=-1), torch.where(hit, picked, torch.zeros_like(picked))


def fused_ce_rowwise(
    hidden: torch.Tensor,
    table: torch.Tensor,
    labels: torch.Tensor,
    logit_scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(lse, label_logit)``, both fp32 ``[rows]``, of ``hidden [rows, H] @ table [V, H]^T``
    in their shared compute dtype (fp32 or bf16). IGNORE_INDEX rows return a label logit
    of 0 for the caller to mask."""
    if hidden.device.type == "cpu":
        return fused_ce_rowwise_plain(hidden, table, labels, logit_scale)
    if hidden.device.type != "cuda":
        raise ValueError(f"fused_ce_rowwise runs on CUDA or CPU tensors, got {hidden.device}")
    _check_shapes(hidden, table, labels)
    device = hidden.device
    check_cuda_tensor(hidden, "hidden", device)
    check_cuda_tensor(table, "table", device, dtypes=(hidden.dtype,))
    if hidden.data_ptr() % 16 or table.data_ptr() % 16:
        raise ValueError("hidden and table must be 16-byte aligned")
    rows, hidden_dim = hidden.shape
    vocab = table.shape[0]
    if hidden_dim % HIDDEN_MULTIPLE:
        raise ValueError(f"hidden dim {hidden_dim} is not a multiple of {HIDDEN_MULTIPLE}")
    labels = labels.to(device=device, dtype=torch.int32).contiguous()
    lib = load_library()
    dtype_code = DTYPE_CODES[hidden.dtype]
    floats = lib.dolo_fused_ce_scratch_floats(rows, vocab, dtype_code)
    check_launch(max(-floats, 0), KERNEL.name)
    partial = torch.empty(floats, dtype=torch.float32, device=device)
    lse = torch.empty(rows, dtype=torch.float32, device=device)
    label_logit = torch.empty(rows, dtype=torch.float32, device=device)
    code = lib.dolo_fused_ce(
        ptr(hidden), ptr(table), ptr(labels), ptr(partial), ptr(lse), ptr(label_logit),
        rows, hidden_dim, vocab, float(1.0 if logit_scale is None else logit_scale),
        int(logit_scale is not None), dtype_code, current_stream(device),
    )
    check_launch(code, KERNEL.name)
    KERNEL.launches += 1
    return lse, label_logit


def fused_ce_chunk(
    h: torch.Tensor,
    table: torch.Tensor,
    y: torch.Tensor,
    logit_scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One chunk's fp32 ``(loss_sum, z_sum, num_tokens)``: h ``[B, chunk, H]`` and table
    ``[V, H]`` in the compute dtype, labels y ``[B, chunk]`` with IGNORE_INDEX. The
    reduction is always fp32, as the TPU kernel's is."""
    rows = h.shape[0] * h.shape[1]
    lse, label_logit = fused_ce_rowwise(
        h.reshape(rows, h.shape[-1]).contiguous(), table, y.reshape(rows), logit_scale
    )
    mask = y.reshape(rows) != IGNORE_INDEX
    zero = torch.zeros_like(lse)
    loss_sum = torch.where(mask, lse - label_logit, zero).sum()
    z_sum = torch.where(mask, lse.square(), zero).sum()
    return loss_sum, z_sum, mask.float().sum()
