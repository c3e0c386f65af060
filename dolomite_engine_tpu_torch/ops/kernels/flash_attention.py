"""Flash attention with segment ids, an optional additive key bias and an optional causal
mask: the CUDA kernels, their plain versions and the autograd function that joins the
forward and the backward.

Replaces the two attention kernels the JAX training path takes from jax's Pallas library:

- splash attention (``_tpu_splash_attention``, `dolomite_engine_tpu/ops/attention.py:330`),
  causal with ``SegmentIds(q=s, kv=s)``: the `FWD_KERNEL` / `BWD_KERNEL` form;
- jax's flash kernel (``_tpu_flash_attention``, `:379`) in the forms splash does not
  take, an additive bias and ``causal=False``: the `BIAS_FWD_KERNEL` / `BIAS_BWD_KERNEL`
  form, launched as ``key_row`` (an alibi row, or no bias) or ``query_bias`` (T5's).

Query i attends key j when ``seg[i] == seg[j]`` and, if causal, ``j <= i``; pad tokens
(segment 0) attend among themselves. The bias takes two forms, each fp32, each added to
the scaled scores (the function of the JAX package's XLA paths; jax's flash kernel itself
adds its ``ab`` before the scale, a divergence of the reference ROADMAP.md Queue C
records):

- a key row per (batch, query head), ``[B, Hq, S]`` (alibi: ``slope * key position``):
  the score is ``q.k * scale + bias[k]``. Kernels and plain versions shift each query row
  by its own position's bias, ``bias[k] - bias[i]``: softmax does not change, and fp32
  keeps the digits of ``q.k`` beside biases that reach ~1700 at 2048 tokens. The
  logsumexp they return is of those shifted scores;
- a query bias ``[Bb, Hq, S, S]`` with ``Bb`` 1 (shared over the batch) or B (T5's
  learned relative bias, jax's ``ab``): the score is ``q.k * scale + bias[i, j]``,
  unshifted, and the backward also returns its gradient ``dBias = P (dP - delta)`` in
  fp32 (jax's ``ds``), summed over the batch for a shared bias.

Bound on the H100 by operations for long documents
and by bytes for a packed batch of short ones. bf16 runs warp-specialised `wgmma`
kernels fed by TMA through an mbarrier ring (128 query rows a CTA in the forward and
the dQ pass, 64 keys in the dK/dV pass), fp32 scalar-FMA tiles; both skip the 64-token
tiles whose segments cannot meet their own, from ranges a pre-pass computes once per
call (see ``dolomite_engine_tpu_torch/csrc/flash_attention.cu``).

`flash_attention_fwd` / `flash_attention_bwd` launch the kernels for CUDA tensors (or
raise) and take the plain versions for CPU tensors. `flash_attention` is the
differentiable entry point: its backward saves q, k, v, the output, the row logsumexp,
the segment ids and the bias, recomputes the probabilities tile by tile, and returns the
query bias's gradient when the bias requires one (a key row that requires one is sent as
the query bias ``bias[k] - bias[i]``, whose gradient autograd carries back to the row).
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
# the additive-bias / non-causal form: the same source, other template instances
BIAS_FWD_KERNEL = KernelSpec(
    name="flash_attn_bias_fwd",
    source="dolomite_engine_tpu_torch/csrc/flash_attention.cu",
    replaces="dolomite_engine_tpu/ops/attention.py:379",
)
BIAS_BWD_KERNEL = KernelSpec(
    name="flash_attn_bias_bwd",
    source="dolomite_engine_tpu_torch/csrc/flash_attention.cu",
    replaces="dolomite_engine_tpu/ops/attention.py:379",
)

HEAD_DIMS = (64, 80, 128)  # the kernels' compiled head widths
SEQ_MULTIPLE = 64  # key tile, and the tiles of the segment ranges


def _check_shapes(q, k, v, segment_ids, bias=None):
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError("q must be [B, S, Hq, D] and k, v [B, S, Hkv, D]")
    batch, seq, num_q_heads, head_dim = q.shape
    if k.shape[0] != batch or k.shape[1] != seq or k.shape[3] != head_dim:
        raise ValueError(f"q {tuple(q.shape)} does not match k/v {tuple(k.shape)}")
    if num_q_heads % k.shape[2]:
        raise ValueError(f"{num_q_heads} query heads do not group over {k.shape[2]} kv heads")
    if segment_ids is not None and tuple(segment_ids.shape) != (batch, seq):
        raise ValueError(f"segment_ids {tuple(segment_ids.shape)} must be [B, S] = {(batch, seq)}")
    if bias is not None and tuple(bias.shape) not in (
        (batch, num_q_heads, seq), (1, num_q_heads, seq, seq), (batch, num_q_heads, seq, seq)
    ):
        raise ValueError(
            f"bias {tuple(bias.shape)} must be a key row [B, Hq, S] = {(batch, num_q_heads, seq)} or a "
            f"query bias [1 or B, Hq, S, S] = [1 or {batch}, {num_q_heads}, {seq}, {seq}]"
        )


def _segments(segment_ids: torch.Tensor | None, q: torch.Tensor) -> torch.Tensor:
    """int32 [B, S] segment ids; None means one document per row."""
    if segment_ids is None:
        return torch.ones(q.shape[:2], dtype=torch.int32, device=q.device)
    seg = segment_ids.to(device=q.device, dtype=torch.int32).contiguous()
    return seg.clone() if seg.data_ptr() % 16 else seg  # the kernels copy 64-id rows in bulk


def is_query_bias(bias: torch.Tensor | None) -> bool:
    """Whether `bias` is the query-bias form ``[Bb, Hq, S, S]`` (else a key row, or None)."""
    return bias is not None and bias.ndim == 4


def _bias_scores(bias: torch.Tensor) -> torch.Tensor:
    """The bias's fp32 term of the scores, broadcast over [B, Hq, S, S]: a key row less
    each query row's own-position bias, or a query bias as it is."""
    bias = bias.float()
    if is_query_bias(bias):
        return bias
    return bias[:, :, None, :] - bias[:, :, :, None]


def _score_grads(probs, dp, delta):
    """dS = P (dP - delta) [B, Hq, S, S]: the gradient of the scores, and so of a query bias
    before its batch sum."""
    return probs * (dp - delta[..., None])


def _query_bias_grad(ds, bias):
    """dBias of a query bias from dS: summed over the batch when the bias is shared
    (``Bb == 1``)."""
    return ds.sum(0, keepdim=True) if bias.shape[0] == 1 else ds


def _probabilities(q, k, segment_ids, softmax_scale, lse=None, bias=None, causal=True):
    """fp32 softmax probabilities [B, Hq, S, S] under the segment (and causal) mask, with
    the bias's term added to the scores (`_bias_scores`), and the row logsumexp of those
    scores when `lse` is not given."""
    seq = q.shape[1]
    group = q.shape[2] // k.shape[2]
    scores = torch.einsum(
        "bqhd,bkhd->bhqk", q.float(), k.float().repeat_interleave(group, dim=2)
    ) * softmax_scale
    if bias is not None:
        scores = scores + _bias_scores(bias)
    seg = _segments(segment_ids, q)
    mask = seg[:, :, None] == seg[:, None, :]
    if causal:
        positions = torch.arange(seq, device=q.device)
        mask = mask & (positions[None, :] <= positions[:, None])[None]
    scores = scores.masked_fill(~mask[:, None], float("-inf"))
    if lse is None:
        lse = torch.logsumexp(scores, dim=-1)
    return torch.exp(scores - lse[..., None]), lse


def flash_attention_fwd_plain(q, k, v, segment_ids, softmax_scale, bias=None, causal=True):
    """(out in q's dtype [B, S, Hq, D], fp32 row logsumexp [B, Hq, S]), computed in fp32."""
    _check_shapes(q, k, v, segment_ids, bias)
    group = q.shape[2] // k.shape[2]
    probs, lse = _probabilities(q, k, segment_ids, softmax_scale, bias=bias, causal=causal)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float().repeat_interleave(group, dim=2))
    return out.to(q.dtype), lse


def flash_attention_bwd_plain(
    q, k, v, segment_ids, out, lse, dout, softmax_scale, bias=None, causal=True, bias_grad=True
):
    """(dq, dk, dv) of `flash_attention_fwd_plain` for the output cotangent `dout`, in
    fp32 from the saved logsumexp: dV = P^T dO, dS = P (dO V^T - rowsum(dO O)),
    dQ = scale dS K, dK = scale dS^T Q, summed over each GQA group. With a query bias and
    `bias_grad`, (dq, dk, dv, dbias): dbias = dS in fp32, shaped like the bias
    (`_query_bias_grad`)."""
    _check_shapes(q, k, v, segment_ids, bias)
    batch, seq, num_kv_heads, head_dim = k.shape
    group = q.shape[2] // num_kv_heads
    probs, _ = _probabilities(q, k, segment_ids, softmax_scale, lse.float(), bias, causal)
    do = dout.float()
    delta = (do * out.float()).sum(-1).transpose(1, 2)  # [B, Hq, S]
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v.float().repeat_interleave(group, dim=2))
    ds = _score_grads(probs, dp, delta)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float().repeat_interleave(group, dim=2))
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", probs, do)
    per_group = (batch, seq, num_kv_heads, group, head_dim)
    dk = dk.reshape(per_group).sum(3) * softmax_scale
    dv = dv.reshape(per_group).sum(3)
    grads = (dq * softmax_scale).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
    if bias_grad and is_query_bias(bias):
        return grads + (_query_bias_grad(ds, bias),)
    return grads


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


def kernel_specs(bias, causal) -> tuple[KernelSpec, KernelSpec]:
    """The (forward, backward) specs whose counts a launch of this form adds to."""
    if bias is None and causal:
        return FWD_KERNEL, BWD_KERNEL
    return BIAS_FWD_KERNEL, BIAS_BWD_KERNEL


def kernel_form(bias) -> str:
    """The form of the additive-bias kernels a launch counts under: ``query_bias`` for a
    query bias, ``key_row`` for a key row or no bias."""
    return "query_bias" if is_query_bias(bias) else "key_row"


def _count(spec: KernelSpec, bias) -> None:
    """Count one launch: the bias form's launches by form, the splash form's as they are."""
    if spec in (BIAS_FWD_KERNEL, BIAS_BWD_KERNEL):
        spec.launched(kernel_form(bias))
    else:
        spec.launches += 1


def _bias_mode(bias) -> tuple[int, int]:
    """(the kernels' bias_mode: 0 none, 1 key row, 2 query bias; whether a query bias is
    shared over the batch)."""
    if bias is None:
        return 0, 0
    if is_query_bias(bias):
        return 2, int(bias.shape[0] == 1)
    return 1, 0


def _check_aligned(tensor, name):
    if tensor.data_ptr() % 16:
        raise ValueError(f"{name} must start 16-byte aligned")


def _ranges(q):
    """Scratch for each 64-token tile's (min, max) segment id and the first and last tile
    it meets, [B, S / 64, 4] int32."""
    return torch.empty((q.shape[0], q.shape[1] // SEQ_MULTIPLE, 4), dtype=torch.int32, device=q.device)


def _kernel_inputs(q, k, v, segment_ids, bias):
    """Check what the kernels take; returns (token strides of q, k, v, int32 segment
    ids)."""
    _check_shapes(q, k, v, segment_ids, bias)
    _check_kernel_shapes(q)
    device, dtype = q.device, q.dtype
    if dtype not in ELEMENT_DTYPES:
        raise ValueError(f"q has dtype {dtype}, expected one of {ELEMENT_DTYPES}")
    strides = [_token_stride(t, n, device, dtype) for t, n in ((q, "q"), (k, "k"), (v, "v"))]
    if bias is not None:
        check_cuda_tensor(bias, "bias", device, dtypes=(torch.float32,))
        _check_aligned(bias, "bias")
    return strides, _segments(segment_ids, q)


def flash_attention_fwd(q, k, v, segment_ids, softmax_scale, bias=None, causal=True):
    """Forward: (out [B, S, Hq, D] in q's dtype, fp32 logsumexp [B, Hq, S])."""
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, segment_ids, softmax_scale, bias, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, got {q.device}")
    strides, seg = _kernel_inputs(q, k, v, segment_ids, bias)
    batch, seq, num_q_heads, head_dim = q.shape
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((batch, num_q_heads, seq), dtype=torch.float32, device=q.device)
    spec = kernel_specs(bias, causal)[0]
    code = load_library().dolo_flash_fwd(
        ptr(q), ptr(k), ptr(v), ptr(seg), ptr(bias), ptr(out), ptr(lse), ptr(_ranges(q)),
        batch, seq, num_q_heads, k.shape[2], head_dim, *strides, int(causal), *_bias_mode(bias),
        float(softmax_scale), DTYPE_CODES[q.dtype], current_stream(q.device),
    )
    check_launch(code, spec.name)
    _count(spec, bias)
    return out, lse


def flash_attention_bwd(q, k, v, segment_ids, out, lse, dout, softmax_scale, bias=None, causal=True, bias_grad=True):
    """Backward: (dq, dk, dv) shaped and typed like q, k, v (dense); with a query bias and
    `bias_grad` also dbias, fp32 and shaped like the bias. The kernels write dS into
    [B, Hq, S, S] rows zeroed here (pairs a mask or the tile walk skips stay 0); a shared
    bias's rows are summed over the batch in a fixed order by a last launch of the same
    call. Without `bias_grad` (a frozen bias) the kernels write no dS rows."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, segment_ids, out, lse, dout, softmax_scale, bias, causal, bias_grad)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, got {q.device}")
    strides, seg = _kernel_inputs(q, k, v, segment_ids, bias)
    device, dtype = q.device, q.dtype
    dout = dout.contiguous()
    if dout.data_ptr() % 16:  # the kernels read dO through tensor maps
        dout = dout.clone()
    for name, tensor, dtypes in (("out", out, (dtype,)), ("dout", dout, (dtype,)), ("lse", lse, (torch.float32,))):
        check_cuda_tensor(tensor, name, device, dtypes=dtypes)
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError("out and dout must be shaped like q")
    _check_aligned(lse, "lse")
    _check_aligned(out, "out")
    batch, seq, num_q_heads, head_dim = q.shape
    delta = torch.empty((batch, num_q_heads, seq), dtype=torch.float32, device=device)
    dq = torch.empty(q.shape, dtype=dtype, device=device)
    dk = torch.empty(k.shape, dtype=dtype, device=device)
    dv = torch.empty(v.shape, dtype=dtype, device=device)
    dbias_rows = dbias = None
    if bias_grad and is_query_bias(bias):
        dbias_rows = torch.zeros((batch,) + tuple(bias.shape[1:]), dtype=torch.float32, device=device)
        dbias = dbias_rows if bias.shape[0] == batch else torch.empty(bias.shape, dtype=torch.float32, device=device)
    spec = kernel_specs(bias, causal)[1]
    code = load_library().dolo_flash_bwd(
        ptr(q), ptr(k), ptr(v), ptr(seg), ptr(bias), ptr(out), ptr(dout), ptr(lse), ptr(delta),
        ptr(_ranges(q)), ptr(dq), ptr(dk), ptr(dv), ptr(dbias_rows), ptr(dbias), batch, seq, num_q_heads,
        k.shape[2], head_dim, *strides, int(causal), *_bias_mode(bias), float(softmax_scale), DTYPE_CODES[dtype],
        current_stream(device),
    )
    check_launch(code, spec.name)
    _count(spec, bias)
    return (dq, dk, dv) if dbias is None else (dq, dk, dv, dbias)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, segment_ids, softmax_scale, bias, causal):
        out, lse = flash_attention_fwd(q, k, v, segment_ids, softmax_scale, bias, causal)
        ctx.save_for_backward(q, k, v, segment_ids, out, lse, bias)
        ctx.softmax_scale = softmax_scale
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, segment_ids, out, lse, bias = ctx.saved_tensors
        grads = flash_attention_bwd(
            q, k, v, segment_ids, out, lse, dout, ctx.softmax_scale, bias, ctx.causal, ctx.needs_input_grad[5]
        )
        dbias = grads[3] if len(grads) == 4 else None
        return grads[0], grads[1], grads[2], None, None, dbias, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    segment_ids: torch.Tensor | None,
    softmax_scale: float,
    bias: torch.Tensor | None = None,
    causal: bool = True,
) -> torch.Tensor:
    """Attention with packed-document segment ids, differentiable in q, k and v.

    q ``[B, S, Hq, D]``; k, v ``[B, S, Hkv, D]`` (token-strided views of the fused QKV
    projection are taken as they are); segment_ids ``[B, S]`` or None; bias a key row
    ``[B, Hq, S]``, a query bias ``[1 or B, Hq, S, S]``, or None, taken in fp32; a query
    bias is differentiable. Returns ``[B, S, Hq, D]`` in q's dtype."""
    _check_shapes(q, k, v, segment_ids, bias)
    if bias is not None:
        if bias.requires_grad and not is_query_bias(bias):
            raise NotImplementedError(
                "the gradient of a key-row bias [B, Hq, S] is not ported (no model trains one): "
                "pass it as a query bias [1 or B, Hq, S, S] to get its gradient"
            )
        bias = bias.to(device=q.device, dtype=torch.float32).contiguous()
    return _FlashAttention.apply(q, k, v, _segments(segment_ids, q), softmax_scale, bias, causal)
