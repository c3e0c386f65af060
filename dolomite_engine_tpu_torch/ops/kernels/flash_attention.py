"""Causal flash attention with segment ids: the CUDA kernels, their plain versions and the
autograd function that joins the forward and the backward.

Replaces the attention kernel the JAX training path takes from jax's Pallas library
(splash attention, ``_tpu_splash_attention`` in `dolomite_engine_tpu/ops/attention.py`,
causal with ``SegmentIds(q=s, kv=s)``). Query i attends key j when ``j <= i`` and
``seg[i] == seg[j]``; pad tokens (segment 0) attend among themselves. Bound on the H100
by operations for long documents and by bytes for a packed batch of short ones; the
kernels run both products on the tensor cores and skip key tiles whose segments cannot
meet the query tile's (see
``dolomite_engine_tpu_torch/csrc/flash_attention.cu``).

`flash_attention_fwd` / `flash_attention_bwd` launch the kernels for CUDA tensors (or
raise) and take the plain versions for CPU tensors. `flash_attention` is the
differentiable entry point: its backward saves q, k, v, the output, the row logsumexp
and the segment ids, and recomputes the probabilities tile by tile.
"""

from __future__ import annotations

import torch

from ._build import (
    DTYPE_CODES,
    ELEMENT_DTYPES,
    KernelSpec,
    check_cuda_tensor,
    check_launch,
    current_stream,
    load_library,
    ptr,
)

FWD_KERNEL = KernelSpec(
    name="flash_attn_fwd",
    source="dolomite_engine_tpu_torch/csrc/flash_attention.cu",
    replaces="dolomite_engine_tpu/ops/attention.py:330",
)
BWD_KERNEL = KernelSpec(
    name="flash_attn_bwd",
    source="dolomite_engine_tpu_torch/csrc/flash_attention.cu",
    replaces="dolomite_engine_tpu/ops/attention.py:330",
)

HEAD_DIMS = (64, 80, 128)  # the kernels' compiled head widths
SEQ_MULTIPLE = 64  # query and key tile


def _check_shapes(q, k, v, segment_ids):
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError("q must be [B, S, Hq, D] and k, v [B, S, Hkv, D]")
    batch, seq, num_q_heads, head_dim = q.shape
    if k.shape[0] != batch or k.shape[1] != seq or k.shape[3] != head_dim:
        raise ValueError(f"q {tuple(q.shape)} does not match k/v {tuple(k.shape)}")
    if num_q_heads % k.shape[2]:
        raise ValueError(f"{num_q_heads} query heads do not group over {k.shape[2]} kv heads")
    if segment_ids is not None and tuple(segment_ids.shape) != (batch, seq):
        raise ValueError(f"segment_ids {tuple(segment_ids.shape)} must be [B, S] = {(batch, seq)}")


def _segments(segment_ids: torch.Tensor | None, q: torch.Tensor) -> torch.Tensor:
    """int32 [B, S] segment ids; None means one document per row."""
    if segment_ids is None:
        return torch.ones(q.shape[:2], dtype=torch.int32, device=q.device)
    return segment_ids.to(device=q.device, dtype=torch.int32).contiguous()


def _probabilities(q, k, segment_ids, softmax_scale, lse=None):
    """fp32 softmax probabilities [B, Hq, S, S] under the causal + segment mask (and the
    row logsumexp when `lse` is not given)."""
    seq = q.shape[1]
    group = q.shape[2] // k.shape[2]
    scores = torch.einsum(
        "bqhd,bkhd->bhqk", q.float(), k.float().repeat_interleave(group, dim=2)
    ) * softmax_scale
    seg = _segments(segment_ids, q)
    positions = torch.arange(seq, device=q.device)
    mask = (positions[None, :] <= positions[:, None])[None] & (seg[:, :, None] == seg[:, None, :])
    scores = scores.masked_fill(~mask[:, None], float("-inf"))
    if lse is None:
        lse = torch.logsumexp(scores, dim=-1)
    return torch.exp(scores - lse[..., None]), lse


def flash_attention_fwd_plain(q, k, v, segment_ids, softmax_scale):
    """(out in q's dtype [B, S, Hq, D], fp32 row logsumexp [B, Hq, S]), computed in fp32."""
    _check_shapes(q, k, v, segment_ids)
    group = q.shape[2] // k.shape[2]
    probs, lse = _probabilities(q, k, segment_ids, softmax_scale)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float().repeat_interleave(group, dim=2))
    return out.to(q.dtype), lse


def flash_attention_bwd_plain(q, k, v, segment_ids, out, lse, dout, softmax_scale):
    """(dq, dk, dv) of `flash_attention_fwd_plain` for the output cotangent `dout`, in
    fp32 from the saved logsumexp: dV = P^T dO, dS = P (dO V^T - rowsum(dO O)),
    dQ = scale dS K, dK = scale dS^T Q, summed over each GQA group."""
    _check_shapes(q, k, v, segment_ids)
    batch, seq, num_kv_heads, head_dim = k.shape
    group = q.shape[2] // num_kv_heads
    probs, _ = _probabilities(q, k, segment_ids, softmax_scale, lse=lse.float())
    do = dout.float()
    delta = (do * out.float()).sum(-1).transpose(1, 2)  # [B, Hq, S]
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v.float().repeat_interleave(group, dim=2))
    ds = probs * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float().repeat_interleave(group, dim=2))
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", probs, do)
    per_group = (batch, seq, num_kv_heads, group, head_dim)
    dk = dk.reshape(per_group).sum(3) * softmax_scale
    dv = dv.reshape(per_group).sum(3)
    return (dq * softmax_scale).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _token_stride(t: torch.Tensor, name: str, device: torch.device, dtype: torch.dtype) -> int:
    """Elements between consecutive tokens of a [B, S, H, D] tensor whose heads and
    features are dense (a view of the fused QKV projection qualifies)."""
    if t.device != device or t.dtype != dtype:
        raise ValueError(f"{name} is {t.dtype} on {t.device}, expected {dtype} on {device}")
    batch, seq, heads, head_dim = t.shape
    if t.stride(3) != 1 or t.stride(2) != head_dim or (batch > 1 and t.stride(0) != seq * t.stride(1)):
        raise ValueError(f"{name} must have dense [H, D] rows and batch rows S tokens apart")
    if t.data_ptr() % 16 or (t.stride(1) * t.element_size()) % 16:
        raise ValueError(f"{name} rows must be 16-byte aligned")
    return t.stride(1)


def _check_kernel_shapes(q):
    seq, head_dim = q.shape[1], q.shape[3]
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"head_dim {head_dim} is not one of the kernel's {HEAD_DIMS}")
    if seq % SEQ_MULTIPLE:
        raise ValueError(f"sequence length {seq} is not a multiple of {SEQ_MULTIPLE}")


def flash_attention_fwd(q, k, v, segment_ids, softmax_scale):
    """Forward: (out [B, S, Hq, D] in q's dtype, fp32 logsumexp [B, Hq, S])."""
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, segment_ids, softmax_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, got {q.device}")
    _check_shapes(q, k, v, segment_ids)
    _check_kernel_shapes(q)
    device, dtype = q.device, q.dtype
    if dtype not in ELEMENT_DTYPES:
        raise ValueError(f"q has dtype {dtype}, expected one of {ELEMENT_DTYPES}")
    strides = [_token_stride(t, n, device, dtype) for t, n in ((q, "q"), (k, "k"), (v, "v"))]
    seg = _segments(segment_ids, q)
    batch, seq, num_q_heads, head_dim = q.shape
    out = torch.empty(q.shape, dtype=dtype, device=device)
    lse = torch.empty((batch, num_q_heads, seq), dtype=torch.float32, device=device)
    code = load_library().dolo_flash_fwd(
        ptr(q), ptr(k), ptr(v), ptr(seg), ptr(out), ptr(lse),
        batch, seq, num_q_heads, k.shape[2], head_dim, *strides,
        float(softmax_scale), DTYPE_CODES[dtype], current_stream(device),
    )
    check_launch(code, FWD_KERNEL.name)
    FWD_KERNEL.launches += 1
    return out, lse


def flash_attention_bwd(q, k, v, segment_ids, out, lse, dout, softmax_scale):
    """Backward: (dq, dk, dv) shaped and typed like q, k, v (dense)."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, segment_ids, out, lse, dout, softmax_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, got {q.device}")
    _check_shapes(q, k, v, segment_ids)
    _check_kernel_shapes(q)
    device, dtype = q.device, q.dtype
    if dtype not in ELEMENT_DTYPES:
        raise ValueError(f"q has dtype {dtype}, expected one of {ELEMENT_DTYPES}")
    strides = [_token_stride(t, n, device, dtype) for t, n in ((q, "q"), (k, "k"), (v, "v"))]
    seg = _segments(segment_ids, q)
    dout = dout.contiguous()
    for name, tensor, dtypes in (("out", out, (dtype,)), ("dout", dout, (dtype,)), ("lse", lse, (torch.float32,))):
        check_cuda_tensor(tensor, name, device, dtypes=dtypes)
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError("out and dout must be shaped like q")
    batch, seq, num_q_heads, head_dim = q.shape
    delta = torch.empty((batch, num_q_heads, seq), dtype=torch.float32, device=device)
    dq = torch.empty(q.shape, dtype=dtype, device=device)
    dk = torch.empty(k.shape, dtype=dtype, device=device)
    dv = torch.empty(v.shape, dtype=dtype, device=device)
    code = load_library().dolo_flash_bwd(
        ptr(q), ptr(k), ptr(v), ptr(seg), ptr(out), ptr(dout), ptr(lse), ptr(delta),
        ptr(dq), ptr(dk), ptr(dv), batch, seq, num_q_heads, k.shape[2], head_dim, *strides,
        float(softmax_scale), DTYPE_CODES[dtype], current_stream(device),
    )
    check_launch(code, BWD_KERNEL.name)
    BWD_KERNEL.launches += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, segment_ids, softmax_scale):
        out, lse = flash_attention_fwd(q, k, v, segment_ids, softmax_scale)
        ctx.save_for_backward(q, k, v, segment_ids, out, lse)
        ctx.softmax_scale = softmax_scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, segment_ids, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, segment_ids, out, lse, dout, ctx.softmax_scale)
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    segment_ids: torch.Tensor | None,
    softmax_scale: float,
) -> torch.Tensor:
    """Causal attention with packed-document segment ids, differentiable in q, k and v.

    q ``[B, S, Hq, D]``; k, v ``[B, S, Hkv, D]`` (token-strided views of the fused QKV
    projection are taken as they are); segment_ids ``[B, S]`` or None. Returns
    ``[B, S, Hq, D]`` in q's dtype."""
    _check_shapes(q, k, v, segment_ids)
    return _FlashAttention.apply(q, k, v, _segments(segment_ids, q), softmax_scale)
