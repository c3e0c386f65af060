#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (`dolomite_engine_tpu_torch`) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA device:

    python3 chip_smoke.py [--seed N]

Phases (any failure raises and exits non-zero; nothing is caught):

1. build the CUDA kernel library from `dolomite_engine_tpu_torch/csrc/` (set-up time);
2. each kernel of the serving and training paths against its plain PyTorch version on
   the card, at the slices' shapes, in bf16 and fp32 (forward and backward for the
   training kernels), with kernel, plain and library timings;
3. the serving slice: granite-3b-code at full width and depth (32 layers, bf16, random
   weights from the seed) behind `ServingEngine`, serving 8 requests of 300-1500 prompt
   tokens and 64 greedy new tokens, two of them sharing a 512-token prefix. Launch
   counts are zeroed just before and read just after; the model's logits on the kernel
   path (chunked prefill into the paged pool, then decode steps) are held against a
   plain full-sequence forward of the same model;
4. the same requests once more under `torch.profiler`: device time by kernel and the
   device's busy share;
5. the training kernel path against the plain path at full width and 2 layers: loss
   and every parameter's gradient, bf16, with an fp32 plain reference;
6. the training slice: the dense GPTDolomite train step on granite-3b-code (32 layers,
   fp32 master weights, bf16 compute, flash attention over packed documents, the fused
   LM-head loss with z-loss, AdamW with a bf16 first moment, cosine schedule, clipping,
   remat of every block) for 1 warm-up and 4 timed steps of accumulation 2 x [1, 4096];
   launch counts zeroed before and read after; then one step under `torch.profiler`;
7. the MoE serving slice: the MoEDolomite of `pretrain-moe-ep.yml` (24 layers, 32
   experts, top-4, bf16, random weights) behind `ServingEngine` with the requests of
   phase 3, its logits check against a plain forward (router + every-expert
   `experts_eager`), the requests once more under `torch.profiler`, and once more
   unprofiled with the host syncs counted by call site;
8. the MoE training kernel path against the plain path at full width and 2 layers
   (loss with the router's auxiliary loss, every gradient and every expert's slice of a
   bank against an fp32 reference, the share of routings that differ), then the MoE train step at 8 of the 24 layers, accumulation 2 x [2, 2048],
   and one profiled step;
9. the quantized KV pool (``quantized_serving``): phase 3's model and requests behind
   `ServingEngine(kv_dtype="int8")` and again with ``"fp8"`` (right after phase 4), and
   phase 7's MoE model with ``"int8"`` (right after its profile), each with launch counts
   zeroed just before and read just after, the bytes per cached token, launches per
   forward against the bf16 pool, and the greedy tokens' agreement with the bf16 pool's;
10. ``quantized_check`` (after the dense quantized runs): phase 3's model chunk-prefills
   request 2's prompt and decodes 4 tokens into a fresh int8 pool once through the kernel
   path and once through the plain versions of its three kernels (kv_quant, paged decode
   and prefill, patched in here on the same CUDA tensors): layer 0's pool bytes must be
   identical, layer 0's attention and the last position's logits must agree, and a page
   whose quotients fall on halves must encode to the plain version's bytes;
11. the alibi slice (MPT-7B, ``position_embedding_type: alibi``): ``alibi_training_check``,
   the training kernel path against the plain path at full width and 2 layers as in
   phase 5 (every attention call through the additive-bias flash form); then
   ``alibi_training``, the train step at 16 of MPT-7B's 32 layers over packed documents
   at its sequence 2048, micro batch 2 x accumulation 2, with launch counts zeroed just
   before and read just after; then ``alibi_training_profile``, one profiled step.

The grouped-GEMM kernel cases (the decode, prefill-chunk and training shapes, the
transposed-bank dX form, tgmm with fp32 and with the bank's bf16 output, and a case with
most experts empty; padding rows nonzero; each case names its kernel path) and the quantized
pool's cases (kv_quant at both models' decode and prefill windows, the decode and prefill
kernels over int8 / fp8 pages beside the same cases over bf16 pages at the MoE shape and
at start 1536, an fp32 query over a bf16 pool) and the additive-bias / non-causal flash
form's cases (causal alibi over packed documents at the alibi slice's layer shape, the
causal form without a bias on the same inputs, non-causal with and without the bias,
alibi over a left-padded batch) run in phase 2. Each case reports ``kernel_ms`` (CUDA
events around back-to-back calls, host enqueue included) and ``device_ms`` (the same
calls queued behind a sleep kernel, so the card runs them without waiting for the host).

Prints the card's name and power limit, a ``kernel_cases`` line (every case of phase 2),
``serving``, ``profile``, ``quantized_check``, ``training_check``, ``training``,
``training_profile``, ``moe_serving``, ``moe_profile``, ``quantized_serving``,
``moe_training_check``, ``moe_training``, ``moe_training_profile``,
``alibi_training_check``, ``alibi_training`` and ``alibi_training_profile`` lines
(``moe_training_profile`` also gives the grouped GEMMs' and the casts' shares), the
``kernels`` line, the card again, and last
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import time

# granite-3b-code (configs/pretraining-examples/pretrain-v5e-256-granite-3b.yml)
GRANITE_3B_CODE = dict(
    vocab_size=49152, n_positions=4096, n_embd=2560, n_layer=32, n_head=32,
    attention_head_type="mha", n_inner=10240, activation_function="swiglu",
    normalization_function="rmsnorm", position_embedding_type="rope", rope_theta=10000,
    add_bias=False, resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0,
    tie_word_embeddings=True, bos_token_id=0, eos_token_id=0, pad_token_id=0,
)

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # fp32 outside the tensor cores

NUM_SLOTS, MAX_LEN, PAGE, CHUNK = 8, 2048, 16, 512
MAX_NEW = 64

# the training slice (configs/pretraining-examples/pretrain-v5e-256-granite-3b.yml), cut to
# micro batch 1 x accumulation 2 on one card, remat of every block under the full policy
TRAIN_CONFIG = dict(GRANITE_3B_CODE, fused_lm_head_loss=True, loss_chunk_size=256, z_loss_coef=1e-4)
TRAIN_SEQ, TRAIN_ACCUM, TRAIN_STEPS = 4096, 2, 5
TRAIN_OPTIMIZER = dict(betas=(0.9, 0.95), eps=1e-10, weight_decay=0.1, mu_dtype="bf16")
TRAIN_LR = 3e-4
TRAIN_REMAT = {"checkpoint_every": 1, "policy": "full"}

# the MoE model of configs/pretraining-examples/pretrain-moe-ep.yml (model_args) at full
# width; token ids 0 as in the dense phases (the yml's tokenizer is not part of it)
MOE_EP = dict(
    model_type="moe_dolomite", vocab_size=49152, n_positions=2048, n_embd=1024, n_layer=24,
    n_head=16, num_key_value_heads=8, attention_head_type="gqa", activation_function="swiglu",
    normalization_function="rmsnorm", position_embedding_type="rope", add_bias=False,
    num_experts=32, num_experts_per_tok=4, router_aux_loss_coef=0.01, resid_pdrop=0.0,
    embd_pdrop=0.0, attn_pdrop=0.0, fused_lm_head_loss=True, bos_token_id=0, eos_token_id=0,
    pad_token_id=0,
)
# MoE training: 8 of the 24 layers (fp32 master weights, gradients and AdamW state of all
# 24 need ~137 GB), sequence 2048 as in the yml, micro batch 2 x accumulation 2
MOE_TRAIN_LAYERS, MOE_TRAIN_SEQ, MOE_TRAIN_MICRO = 8, 2048, 2

# MPT-7B (mosaicml/mpt-7b config.json): d_model 4096, 32 heads of 128 (MHA), 32 layers,
# expansion ratio 4, exact gelu, layernorm, no_bias, tied embeddings, vocab 50432,
# max_seq_len 2048, alibi with alibi_bias_max 8 (slopes 2^(-8h/32) = get_alibi_slopes(32)).
# Cuts: dropout 0 and token ids 0 as in the dense phases (the tokenizer's ids are not part
# of the model); GPTDolomite's layernorm keeps a bias (zero at init), MPT's has none
MPT_7B = dict(
    vocab_size=50432, n_positions=2048, n_embd=4096, n_layer=32, n_head=32,
    attention_head_type="mha", n_inner=16384, activation_function="gelu",
    normalization_function="layernorm", position_embedding_type="alibi", add_bias=False,
    resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0, tie_word_embeddings=True,
    bos_token_id=0, eos_token_id=0, pad_token_id=0,
)
# alibi training: 16 of the 32 layers (fp32 master weights, fp32 gradients and AdamW state
# of all 32 need ~93 GB; 16 layers are 3.43 B parameters), MPT's max_seq_len 2048, micro
# batch 2 x accumulation 2, the fused LM-head loss; the dense cell's AdamW, schedule and
# clipping (MPT trained with LionW: ROADMAP.md Queue A, 'Other optimizers')
ALIBI_TRAIN_CONFIG = dict(MPT_7B, fused_lm_head_loss=True, loss_chunk_size=256)
ALIBI_TRAIN_LAYERS, ALIBI_TRAIN_SEQ, ALIBI_TRAIN_MICRO = 16, 2048, 2


def _time_ms(fn, iters=20, warmup=3):
    """Mean device time of one call, by CUDA events around `iters` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(fn, iters=20, warmup=3, sleep_cycles=20_000_000):
    """Mean device time of one call with the host out of the way: the `iters` calls are
    queued behind a sleep kernel (~10 ms), so the card runs them back to back however
    long the host takes to enqueue them. `_time_ms` of a call whose enqueue outlasts its
    kernel measures the host."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(sleep_cycles)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bf16_ulp(x):
    import torch

    _, exponent = torch.frexp(x.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny))
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), exponent - 8)


def _bound(nbytes, flops, dtype_name):
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def _record(
    cases, kernel, shape, dtype, err, ok, tol, run, plain, library, nbytes, flops, plain_iters=20,
    op_dtype=None, path=None, extra=None,
):
    """Time one kernel case (kernel, plain version, library call), append it to `cases`
    with its bound (and the kernel `path` it took, where a kernel has several, and any
    `extra` figures), and raise if the kernel disagreed with its plain version. The
    operations bound is taken at the peak rate of `op_dtype` (default `dtype`)."""
    dtype_name = str(dtype).replace("torch.", "")
    bound_ms, bound_by = _bound(nbytes, flops, str(op_dtype or dtype).replace("torch.", ""))
    case = {
        "kernel": kernel, "shape": shape, "dtype": dtype_name,
        "max_abs_err": err, "tolerance": tol, "within_tolerance": bool(ok),
        "kernel_ms": _time_ms(run), "device_ms": _device_ms(run),
        "plain_ms": _time_ms(plain, iters=plain_iters, warmup=min(3, plain_iters)),
        "library_ms": None if library is None else _time_ms(library),
        "library_device_ms": None if library is None else _device_ms(library),
        "bound_ms": bound_ms, "bound_by": bound_by,
        **({} if path is None else {"path": path}),
        **(extra or {}),
    }
    cases.append(case)
    if not ok:
        raise AssertionError(f"{kernel} {shape} {dtype_name} disagrees with its plain version: {case}")


def _paged_case(gen, lengths, width, heads, head_dim, max_pages, dtype):
    """Pages, a shuffled page table covering each slot's frontier (length 0 = idle slot
    on the all-trash row) and the lengths, on the card."""
    import numpy as np
    import torch

    num_pages = 1 + len(lengths) * max_pages
    k = torch.randn((num_pages, PAGE, heads, head_dim), generator=gen, device="cuda").to(dtype)
    v = torch.randn((num_pages, PAGE, heads, head_dim), generator=gen, device="cuda").to(dtype)
    order = list(np.random.RandomState(0).permutation(np.arange(1, num_pages)))
    table = np.zeros((len(lengths), max_pages), np.int32)
    for row, length in enumerate(lengths):
        if length > 0:
            used = min(-(-(length + width) // PAGE), max_pages)
            table[row, :used] = [order.pop() for _ in range(used)]
    return k, v, torch.as_tensor(table, device="cuda"), torch.as_tensor(
        np.asarray(lengths, np.int32), device="cuda"
    )


def rmsnorm_kernel_cases(seed):
    """Phase 2, rmsnorm: the ln_1 / ln_f form (no residual) and the ln_2 form (residual)
    at granite's rows [4096, 2560] and the MoE slice's width [4096, 1024], bf16 and fp32,
    against its plain version, with `F.rms_norm` as the library call of the plain form."""
    import torch
    import torch.nn.functional as F

    from dolomite_engine_tpu_torch.ops.kernels import rmsnorm

    cases = []
    rows = 8 * 512
    for dtype in (torch.bfloat16, torch.float32):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        es = torch.tensor([], dtype=dtype).element_size()
        fp32 = dtype == torch.float32
        for d in (GRANITE_3B_CODE["n_embd"], MOE_EP["n_embd"]):
            x = torch.randn((rows, d), generator=gen, device="cuda").to(dtype)
            r = torch.randn((rows, d), generator=gen, device="cuda").to(dtype)
            w = torch.randn((d,), generator=gen, device="cuda") * 0.1 + 1.0
            for residual in (None, r):
                got = rmsnorm.fused_rmsnorm(x, w, 1e-5, residual=residual)
                want = rmsnorm.fused_rmsnorm_plain(x, w, 1e-5, residual=residual)
                if residual is not None:
                    assert torch.equal(got[1], want[1]), "rmsnorm residual stream differs"
                    got, want = got[0], want[0]
                diff = (got.float() - want.float()).abs()
                ok = bool((diff <= 1e-5 + 1e-5 * want.float().abs()).all()) if fp32 else bool(
                    (diff <= 2 * _bf16_ulp(want)).all()
                )
                n_io = 2 if residual is None else 4
                _record(
                    cases, "rmsnorm", f"[{rows},{d}]" + ("+residual" if residual is not None else ""), dtype,
                    diff.max().item(), ok, "1e-5" if fp32 else "2 bf16 ulp",
                    lambda res=residual: rmsnorm.fused_rmsnorm(x, w, 1e-5, residual=res),
                    lambda res=residual: rmsnorm.fused_rmsnorm_plain(x, w, 1e-5, residual=res),
                    (lambda: F.rms_norm(x, (d,), w.to(dtype), 1e-5)) if residual is None else None,
                    n_io * rows * d * es + d * 4, 4 * rows * d,
                )
            del x, r
    return cases


def kernel_cases(seed):
    """Phase 2: every kernel against its plain version at the slice's shapes."""
    import torch

    from dolomite_engine_tpu_torch.ops.kernels import rope_qkv

    heads, head_dim = 32, 80
    cases = rmsnorm_kernel_cases(seed)

    def record(kernel, shape, dtype, got, want, tol_ok, *rest):
        _record(cases, kernel, shape, dtype, (got.float() - want.float()).abs().max().item(), tol_ok, *rest)

    for dtype in (torch.bfloat16, torch.float32):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        es = torch.tensor([], dtype=dtype).element_size()
        fp32 = dtype == torch.float32

        # rope over the fused [Q | K | V] projection: a prefill chunk and a decode step
        for batch, seq in ((1, 512), (8, 1)):
            width = 3 * heads * head_dim
            qkv = torch.randn((batch, seq, width), generator=gen, device="cuda").to(dtype)
            angles = torch.rand((batch, seq, head_dim), generator=gen, device="cuda") * 6.0
            cos, sin = angles.cos().to(dtype), angles.sin().to(dtype)
            got = rope_qkv.fused_rope_qkv(qkv, cos, sin, heads, heads, head_dim)
            want = rope_qkv.fused_rope_qkv_plain(qkv, cos, sin, heads, heads, head_dim)
            v_cols = 2 * heads * head_dim
            assert torch.equal(got[..., v_cols:], qkv[..., v_cols:]), "rope changed V"
            diff = (got.float() - want.float()).abs()
            if fp32:
                ok = bool((diff <= 1e-5 + 1e-5 * want.abs()).all())
            else:
                xs = qkv.float().reshape(batch, seq, -1, head_dim)
                scale = (xs.abs() + xs.roll(head_dim // 2, -1).abs()).reshape(qkv.shape)
                ok = bool((diff <= 2 * _bf16_ulp(scale)).all())
            record(
                "rope_qkv", f"[{batch},{seq},{width}]", dtype, got, want, ok,
                "1e-5" if fp32 else "2 bf16 ulp of the larger term",
                lambda: rope_qkv.fused_rope_qkv(qkv, cos, sin, heads, heads, head_dim),
                lambda: rope_qkv.fused_rope_qkv_plain(qkv, cos, sin, heads, heads, head_dim),
                None,
                2 * batch * seq * width * es + 2 * batch * seq * head_dim * es,
                6 * batch * seq * 2 * heads * head_dim,
            )

    torch.cuda.synchronize()
    return cases + paged_kernel_cases(seed)


def paged_kernel_cases(seed):
    """Phase 2, the serving path's attention: the paged decode kernel (8 slots, ragged
    frontiers up to 2048, one idle slot) and the prefill kernel (a 512-token chunk at
    start 0 and over a 1024-token prefix) against their plain versions at granite's
    shape, bf16 and fp32, with SDPA over the gathered page view as the library call."""
    import torch
    import torch.nn.functional as F

    from dolomite_engine_tpu_torch.ops.attention import paged_gather_kv
    from dolomite_engine_tpu_torch.ops.kernels import paged_attention, prefill_attention

    heads, head_dim = 32, 80
    cases = []

    def record(kernel, shape, dtype, got, want, tol_ok, *rest):
        _record(cases, kernel, shape, dtype, (got.float() - want.float()).abs().max().item(), tol_ok, *rest)

    for dtype in (torch.bfloat16, torch.float32):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        es = torch.tensor([], dtype=dtype).element_size()
        fp32 = dtype == torch.float32
        # paged decode: 8 slots, ragged frontiers up to 2048, one idle slot
        lengths = [2047, 1900, 1536, 1024, 777, 300, 64, 0]
        max_pages = MAX_LEN // PAGE
        k, v, table, lens = _paged_case(gen, lengths, 1, heads, head_dim, max_pages, dtype)
        q = torch.randn((8, 1, heads, head_dim), generator=gen, device="cuda").to(dtype)
        scale = head_dim**-0.5
        got = paged_attention.paged_decode_attention(q, k, v, table, lens, scale)
        want = paged_attention.paged_decode_attention_plain(q, k, v, table, lens, scale)
        tol = 1e-5 if fp32 else 2e-2
        ok = bool(((got.float() - want.float()).abs() <= tol + (1e-5 if fp32 else 0) * want.float().abs()).all())
        k_view = paged_gather_kv(k, table).transpose(1, 2)
        v_view = paged_gather_kv(v, table).transpose(1, 2)
        positions = torch.arange(max_pages * PAGE, device="cuda")
        mask = (positions[None, :] <= lens[:, None])[:, None, None, :]
        keys = sum(length + 1 for length in lengths)
        record(
            "paged_decode_attention", "q[8,1,32,80] pages[1025,16,32,80] max_len 2048",
            dtype, got, want, ok, "1e-5" if fp32 else "2e-2 abs",
            lambda: paged_attention.paged_decode_attention(q, k, v, table, lens, scale),
            lambda: paged_attention.paged_decode_attention_plain(q, k, v, table, lens, scale),
            lambda: F.scaled_dot_product_attention(q.transpose(1, 2), k_view, v_view, attn_mask=mask, scale=scale),
            2 * q.numel() * es + 2 * keys * heads * head_dim * es + table.numel() * 4 + 8 * 4,
            4 * keys * heads * head_dim,
        )

        # paged prefill: one 512-token chunk at start 0 and over a 1024-token prefix
        for start in (0, 1024):
            k, v, table, _ = _paged_case(gen, [start + CHUNK - 1], 1, heads, head_dim, max_pages, dtype)
            q = torch.randn((1, CHUNK, heads, head_dim), generator=gen, device="cuda").to(dtype)
            starts = torch.tensor([start], dtype=torch.int32, device="cuda")
            got = prefill_attention.paged_prefill_attention(q, k, v, table, starts, scale)
            want = prefill_attention.paged_prefill_attention_plain(q, k, v, table, starts, scale)
            ok = bool(((got.float() - want.float()).abs() <= tol + (1e-5 if fp32 else 0) * want.float().abs()).all())
            k_view = paged_gather_kv(k, table).transpose(1, 2)
            v_view = paged_gather_kv(v, table).transpose(1, 2)
            q_pos = start + torch.arange(CHUNK, device="cuda")
            mask = (positions[None, :] <= q_pos[:, None])[None, None]
            pairs = sum(start + i + 1 for i in range(CHUNK))
            record(
                "paged_prefill_attention", f"q[1,{CHUNK},32,80] start {start} max_len 2048",
                dtype, got, want, ok, "1e-5" if fp32 else "2e-2 abs",
                lambda: prefill_attention.paged_prefill_attention(q, k, v, table, starts, scale),
                lambda: prefill_attention.paged_prefill_attention_plain(q, k, v, table, starts, scale),
                lambda: F.scaled_dot_product_attention(q.transpose(1, 2), k_view, v_view, attn_mask=mask, scale=scale),
                2 * q.numel() * es + 2 * (start + CHUNK) * heads * head_dim * es + table.numel() * 4 + 4,
                4 * pairs * heads * head_dim,
            )
    torch.cuda.synchronize()
    return cases


# (query heads, kv heads, head_dim) of the two served models
ATTENTION_SHAPES = {"granite-3b-code": (32, 32, 80), "moe": (16, 8, 64)}


def tie_page(heads, head_dim, qmax, gen):
    """One fp32 page [1, PAGE, heads, head_dim] whose every head has amax qmax (scale
    exactly 1.0) and whose other values are halves (k + 0.5): each quotient is a rounding
    tie, which half-to-even and half-away-from-zero rounding encode differently."""
    import torch

    shape = (1, PAGE, heads, head_dim)
    values = torch.randint(-int(qmax), int(qmax) - 1, shape, generator=gen, device=gen.device) + 0.5
    values[0, 0, :, 0] = qmax
    return values.float()


def quant_kernel_cases(seed):
    """Phase 2, the quantized pool: kv_quant at the decode (8 slots x 2 pages) and
    prefill-chunk (33 pages) windows of both models, int8 and fp8, whose codes and scales
    must be byte-identical to the plain version's; the decode and prefill kernels over
    int8 and fp8 pages with a bf16 query at both models' shapes (frontiers up to 2047,
    within 2e-2 of the plain version), beside the same cases over bf16 pages (the
    MoE shape's decode, both shapes' prefill at start 1536); an fp32 query over a bf16
    pool (within 1e-5)."""
    import torch
    import torch.nn.functional as F

    from dolomite_engine_tpu_torch.ops.attention import paged_gather_kv
    from dolomite_engine_tpu_torch.ops.kernels import paged_attention, prefill_attention
    from dolomite_engine_tpu_torch.ops.kv_quant import KV_QUANT_DTYPES, as_bytes, quantize_pages, quantize_pages_plain

    cases = []
    max_pages = MAX_LEN // PAGE
    lengths = [2047, 1900, 1536, 1024, 777, 300, 64, 0]
    decode_keys = sum(length + 1 for length in lengths)
    decode_pages = sum(-(-(length + 1) // PAGE) for length in lengths)
    start = MAX_LEN - CHUNK  # the chunk's last query sees 2047 earlier positions
    pairs = sum(start + i + 1 for i in range(CHUNK))
    for model_name, (hq, hkv, hd) in ATTENTION_SHAPES.items():
        gen = torch.Generator(device="cuda").manual_seed(seed)
        scale = hd**-0.5
        # the same cases over a bf16 pool, beside the quantized ones: decode at the MoE
        # shape (granite's is `paged_kernel_cases`') and prefill at start 1536 for both,
        # with SDPA over the gathered page view (GQA heads grouped) as the library call
        k, v, table, lens = _paged_case(gen, lengths, 1, hkv, hd, max_pages, torch.bfloat16)
        k_view, v_view = (paged_gather_kv(x, table).transpose(1, 2) for x in (k, v))
        positions = torch.arange(MAX_LEN, device="cuda")
        if model_name == "moe":
            q = torch.randn((NUM_SLOTS, 1, hq, hd), generator=gen, device="cuda").to(torch.bfloat16)
            got = paged_attention.paged_decode_attention(q, k, v, table, lens, scale)
            want = paged_attention.paged_decode_attention_plain(q, k, v, table, lens, scale)
            mask = (positions[None, :] <= lens[:, None])[:, None, None, :]
            _record(
                cases, "paged_decode_attention", f"{model_name} q[8,1,{hq},{hd}] pages[1025,16,{hkv},{hd}] max_len 2048",
                torch.bfloat16, (got.float() - want.float()).abs().max().item(),
                bool(((got.float() - want.float()).abs() <= 2e-2).all()), "2e-2 abs",
                lambda: paged_attention.paged_decode_attention(q, k, v, table, lens, scale),
                lambda: paged_attention.paged_decode_attention_plain(q, k, v, table, lens, scale),
                lambda: F.scaled_dot_product_attention(
                    q.transpose(1, 2), k_view, v_view, attn_mask=mask, scale=scale, enable_gqa=True
                ),
                2 * q.numel() * 2 + 2 * decode_keys * hkv * hd * 2 + table.numel() * 4 + 8 * 4,
                4 * decode_keys * hq * hd,
            )
        q = torch.randn((1, CHUNK, hq, hd), generator=gen, device="cuda").to(torch.bfloat16)
        prefill_table = table[:1].contiguous()  # row 0 maps 2048 positions
        starts = torch.tensor([start], dtype=torch.int32, device="cuda")
        got = prefill_attention.paged_prefill_attention(q, k, v, prefill_table, starts, scale)
        want = prefill_attention.paged_prefill_attention_plain(q, k, v, prefill_table, starts, scale)
        mask = (positions[None, :] <= (start + torch.arange(CHUNK, device="cuda"))[:, None])[None, None]
        _record(
            cases, "paged_prefill_attention", f"{model_name} q[1,{CHUNK},{hq},{hd}] start {start} bf16 pages, max_len 2048",
            torch.bfloat16, (got.float() - want.float()).abs().max().item(),
            bool(((got.float() - want.float()).abs() <= 2e-2).all()), "2e-2 abs",
            lambda: prefill_attention.paged_prefill_attention(q, k, v, prefill_table, starts, scale),
            lambda: prefill_attention.paged_prefill_attention_plain(q, k, v, prefill_table, starts, scale),
            lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), k_view[:1], v_view[:1], attn_mask=mask, scale=scale, enable_gqa=True
            ),
            2 * q.numel() * 2 + 2 * MAX_LEN * hkv * hd * 2 + max_pages * 4 + 4, 4 * pairs * hq * hd,
        )
        del k, v, k_view, v_view
        for kv_dtype, (storage, qmax) in KV_QUANT_DTYPES.items():
            # the encode at the scatter's window shapes: stale rows past random frontiers
            # (10x the live values), an all-invalid page, and a page of rounding ties
            for label, num_pages in (
                ("decode: 8 slots x 2 pages", 2 * NUM_SLOTS), ("prefill chunk: 33 pages", (CHUNK - 1) // PAGE + 2)
            ):
                values = torch.randn((num_pages, PAGE, hkv, hd), generator=gen, device="cuda") * 2.0
                frontier = torch.randint(0, PAGE + 1, (num_pages, 1), generator=gen, device="cuda")
                valid = torch.arange(PAGE, device="cuda")[None, :] < frontier
                values = torch.where(valid[:, :, None, None], values, values * 10.0)
                valid[0] = True
                values[:1] = tie_page(hkv, hd, qmax, gen)
                valid[1] = False
                got, want = quantize_pages(values, valid, qmax, storage), quantize_pages_plain(values, valid, qmax, storage)
                same = torch.equal(as_bytes(got[0]), as_bytes(want[0])) and torch.equal(
                    got[1].view(torch.int32), want[1].view(torch.int32)
                )
                err = max((got[0].float() - want[0].float()).abs().max().item(), (got[1] - want[1]).abs().max().item())
                _record(
                    cases, "kv_quant", f"{model_name} {label} [{num_pages},{PAGE},{hkv},{hd}] fp32 -> {kv_dtype}",
                    storage, err, same, "byte-identical codes and scales",
                    lambda v=values, m=valid: quantize_pages(v, m, qmax, storage),
                    lambda v=values, m=valid: quantize_pages_plain(v, m, qmax, storage),
                    None, values.numel() * (4 + 1) + valid.numel() + num_pages * hkv * 4,
                    3 * values.numel(), op_dtype=torch.float32,  # |x| and max, divide, round / clip
                )

            # the attention kernels over a quantized pool (bf16 query), scales from an
            # encode of random K / V pages (all rows valid)
            k, v, table, lens = _paged_case(gen, lengths, 1, hkv, hd, max_pages, torch.float32)
            all_valid = torch.ones(k.shape[:2], dtype=torch.bool, device="cuda")
            (kq, ks), (vq, vs) = (quantize_pages_plain(x, all_valid, qmax, storage) for x in (k, v))
            del k, v
            q = torch.randn((NUM_SLOTS, 1, hq, hd), generator=gen, device="cuda").to(torch.bfloat16)
            got = paged_attention.paged_decode_attention(q, kq, vq, table, lens, scale, ks, vs)
            want = paged_attention.paged_decode_attention_plain(q, kq, vq, table, lens, scale, ks, vs)
            _record(
                cases, "paged_decode_attention",
                f"{model_name} q[8,1,{hq},{hd}] {kv_dtype} pages[1025,16,{hkv},{hd}] + scales, max_len 2048",
                torch.bfloat16, (got.float() - want.float()).abs().max().item(),
                bool(((got.float() - want.float()).abs() <= 2e-2).all()), "2e-2 abs",
                lambda: paged_attention.paged_decode_attention(q, kq, vq, table, lens, scale, ks, vs),
                lambda: paged_attention.paged_decode_attention_plain(q, kq, vq, table, lens, scale, ks, vs),
                None,  # no single PyTorch call reads quantized pages
                2 * q.numel() * 2 + 2 * decode_keys * hkv * hd + 2 * decode_pages * hkv * 4 + table.numel() * 4 + 8 * 4,
                4 * decode_keys * hq * hd,
            )
            q = torch.randn((1, CHUNK, hq, hd), generator=gen, device="cuda").to(torch.bfloat16)
            prefill_table = table[:1].contiguous()  # row 0 maps 2048 positions
            starts = torch.tensor([start], dtype=torch.int32, device="cuda")
            got = prefill_attention.paged_prefill_attention(q, kq, vq, prefill_table, starts, scale, ks, vs)
            want = prefill_attention.paged_prefill_attention_plain(q, kq, vq, prefill_table, starts, scale, ks, vs)
            _record(
                cases, "paged_prefill_attention",
                f"{model_name} q[1,{CHUNK},{hq},{hd}] start {start} {kv_dtype} pages + scales, max_len 2048",
                torch.bfloat16, (got.float() - want.float()).abs().max().item(),
                bool(((got.float() - want.float()).abs() <= 2e-2).all()), "2e-2 abs",
                lambda: prefill_attention.paged_prefill_attention(q, kq, vq, prefill_table, starts, scale, ks, vs),
                lambda: prefill_attention.paged_prefill_attention_plain(q, kq, vq, prefill_table, starts, scale, ks, vs),
                None,
                2 * q.numel() * 2 + 2 * MAX_LEN * hkv * hd + 2 * max_pages * hkv * 4 + max_pages * 4 + 4,
                4 * pairs * hq * hd,
            )
            del kq, vq, ks, vs

    # an fp32 query over a bf16 pool (kv_dtype="bf16" under an fp32 model), granite's shape
    hq, hkv, hd = ATTENTION_SHAPES["granite-3b-code"]
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    k, v, table, lens = _paged_case(gen, lengths, 1, hkv, hd, max_pages, torch.bfloat16)
    q = torch.randn((NUM_SLOTS, 1, hq, hd), generator=gen, device="cuda")
    scale = hd**-0.5
    got = paged_attention.paged_decode_attention(q, k, v, table, lens, scale)
    want = paged_attention.paged_decode_attention_plain(q, k, v, table, lens, scale)
    diff = (got - want).abs()
    _record(
        cases, "paged_decode_attention", "q[8,1,32,80] fp32 over bf16 pages[1025,16,32,80], max_len 2048",
        torch.float32, diff.max().item(), bool((diff <= 1e-5 + 1e-5 * want.abs()).all()), "1e-5",
        lambda: paged_attention.paged_decode_attention(q, k, v, table, lens, scale),
        lambda: paged_attention.paged_decode_attention_plain(q, k, v, table, lens, scale),
        None, 2 * q.numel() * 4 + 2 * decode_keys * hkv * hd * 2 + table.numel() * 4 + 8 * 4,
        4 * decode_keys * hq * hd,
    )
    q = torch.randn((1, CHUNK, hq, hd), generator=gen, device="cuda")
    prefill_table = table[:1].contiguous()
    starts = torch.tensor([start], dtype=torch.int32, device="cuda")
    got = prefill_attention.paged_prefill_attention(q, k, v, prefill_table, starts, scale)
    want = prefill_attention.paged_prefill_attention_plain(q, k, v, prefill_table, starts, scale)
    diff = (got - want).abs()
    _record(
        cases, "paged_prefill_attention", f"q[1,{CHUNK},32,80] fp32 start {start} over bf16 pages, max_len 2048",
        torch.float32, diff.max().item(), bool((diff <= 1e-5 + 1e-5 * want.abs()).all()), "1e-5",
        lambda: prefill_attention.paged_prefill_attention(q, k, v, prefill_table, starts, scale),
        lambda: prefill_attention.paged_prefill_attention_plain(q, k, v, prefill_table, starts, scale),
        None, 2 * q.numel() * 4 + 2 * MAX_LEN * hkv * hd * 2 + max_pages * 4 + 4, 4 * pairs * hq * hd,
        plain_iters=5,
    )
    del k, v
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return cases


def _linear(x, module, dtype):
    """A linear layer of the model with its weight cast to `dtype` at use."""
    import torch.nn.functional as F

    return F.linear(x, module.weight.to(dtype), None if module.bias is None else module.bias.to(dtype))


def _plain_ffn(block, x, dtype, router_logits=None):
    """A block's MLP in plain PyTorch in `dtype`: the dense MLP or, for an MoE block, the
    router, `route` and `experts_eager` (every expert on every token, the reference the
    grouped path is pinned against). An MoE block appends its router logits to
    `router_logits`."""
    from dolomite_engine_tpu_torch.ops.moe import combine_weights, experts_eager, route

    if not hasattr(block, "moe"):
        return _linear(block.mlp.act(_linear(x, block.mlp.c_fc, dtype)), block.mlp.c_proj, dtype)
    moe, config = block.moe, block.moe.config
    flat = x.reshape(-1, x.shape[-1])
    logits = _linear(flat, moe.gate, dtype)
    weights, selected = route(logits, config.num_experts_per_tok)
    out = experts_eager(
        flat, combine_weights(weights, selected, config.num_experts),
        moe.c_fc.weight.to(dtype), None if moe.c_fc.bias is None else moe.c_fc.bias.to(dtype),
        moe.c_proj.weight.to(dtype), None if moe.c_proj.bias is None else moe.c_proj.bias.to(dtype),
        moe.act,
    )
    if router_logits is not None:
        router_logits.append(logits)
    return out.reshape(x.shape)


def _plain_norm(norm, x, residual=None):
    """A block's norm in plain PyTorch: rmsnorm's plain version or layernorm; with
    `residual`, ``(norm(x + residual), x + residual)``."""
    from dolomite_engine_tpu_torch.ops.kernels.rmsnorm import fused_rmsnorm_plain
    from dolomite_engine_tpu_torch.ops.normalization import layernorm

    if norm.normalization_function == "rmsnorm":
        return fused_rmsnorm_plain(x, norm.weight, norm.eps, residual=residual)
    if residual is None:
        return layernorm(x, norm.weight, norm.bias, norm.eps)
    x = x + residual
    return layernorm(x, norm.weight, norm.bias, norm.eps), x


def _plain_layers(model, h, position_ids, dtype, segment_ids=None, router_logits=None):
    """The blocks and the final norm with every kernel's plain version called explicitly,
    the weights cast to `dtype` at use, the positions the model computes (rope cos/sin or
    the alibi bias). Attention is masked eager attention; with an alibi bias it is the
    flash form's plain version, which computes its scores in fp32 (in bf16 the eager
    scores would round an alibi bias of ~1700 to 8)."""
    from dolomite_engine_tpu_torch.models.modeling_utils import compute_position_stuff, get_softmax_scale
    from dolomite_engine_tpu_torch.ops.attention import attention
    from dolomite_engine_tpu_torch.ops.kernels.flash_attention import flash_attention_fwd_plain
    from dolomite_engine_tpu_torch.ops.kernels.rope_qkv import fused_rope_qkv_plain

    config, t = model.config, model.transformer
    assert config.m_residual is None and config.m_width is None and model.lm_head is None
    hq, hkv, hd = config.n_head, config.num_key_value_heads, config.head_dim
    batch, seq = h.shape[:2]
    scale = get_softmax_scale(config, hd)
    rope, alibi_bias = compute_position_stuff(config, position_ids, t.rope_params, hq, None, batch, seq, dtype)
    for block in t.h:
        residual = h
        qkv = _linear(_plain_norm(block.ln_1, h), block.attn.c_attn, dtype)
        if rope is not None:
            qkv = fused_rope_qkv_plain(qkv, *rope, hq, hkv, hd)
        q, k, v = qkv.split([hq * hd, hkv * hd, hkv * hd], dim=-1)
        q, k, v = q.reshape(batch, seq, hq, hd), k.reshape(batch, seq, hkv, hd), v.reshape(batch, seq, hkv, hd)
        if alibi_bias is None:
            a = attention(q, k, v, causal=True, softmax_scale=scale, implementation="eager", segment_ids=segment_ids)
        else:
            a = flash_attention_fwd_plain(q, k, v, segment_ids, scale, alibi_bias[:, :, 0])[0]
        x, h = _plain_norm(block.ln_2, _linear(a.reshape(batch, seq, -1), block.attn.c_proj, dtype), residual)
        h = h + _plain_ffn(block, x, dtype, router_logits)
    return _plain_norm(t.ln_f, h)


def plain_forward(model, ids, dtype=None, router_logits=None):
    """The model's full-sequence forward with every kernel's plain version called
    explicitly (no cache), the weights cast to `dtype` (default the model's compute
    dtype) at use: the reference for the kernel path's logits. An MoE block appends its
    router logits to `router_logits`."""
    import torch

    t = model.transformer
    dtype = dtype or model.dtype
    h = torch.nn.functional.embedding(ids, t.wte.weight).to(dtype)
    positions = torch.arange(ids.shape[1], device=ids.device)[None]
    return _plain_layers(model, h, positions, dtype, router_logits=router_logits) @ t.wte.weight.to(dtype).T


def kernel_path_logits(model, tokens, prompt_len, caches=None):
    """Logits at every position of `tokens` through the kernel path: the prompt in
    512-token chunks into a fresh paged pool (`caches`: the model's dtype by default),
    then one decode step per further token."""
    import torch

    device = model.device
    num_pages = -(-MAX_LEN // PAGE)
    if caches is None:
        caches = model.init_kv_caches(1 + num_pages, PAGE)
    table = torch.arange(1, num_pages + 1, dtype=torch.int32, device=device)[None]
    kv = [{**c, "page_table": table} for c in caches]
    logits = []
    for start in range(0, prompt_len, CHUNK):
        take = min(CHUNK, prompt_len - start)
        width = -(-take // 64) * 64
        ids = torch.zeros((1, width), dtype=torch.long, device=device)
        ids[0, :take] = torch.as_tensor(tokens[start : start + take], device=device)
        mask = torch.zeros((1, MAX_LEN), dtype=torch.int32, device=device)
        mask[0, : start + take] = 1
        out = model(
            ids, position_ids=torch.arange(start, start + width, device=device)[None],
            attention_mask=mask, kv_caches=kv,
            cache_index=torch.tensor(start, dtype=torch.int32, device=device),
        )
        logits.append(out.logits[0, :take])
    for pos in range(prompt_len, len(tokens)):
        index = torch.tensor([pos], dtype=torch.int32, device=device)
        out = model(
            torch.tensor([[tokens[pos]]], device=device), position_ids=index[:, None],
            kv_caches=kv, cache_index=index,
        )
        logits.append(out.logits[0])
    return torch.cat(logits)


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(seed, config_kwargs=GRANITE_3B_CODE, device="cuda", kv_dtype=None, model=None):
    """Phase 3 (granite-3b-code) and phase 7 (the MoE model of `pretrain-moe-ep.yml`)
    behind the serving engine, and phase 9 with a quantized pool (`kv_dtype`, over the
    `model` an earlier phase built; its logits are held by `quantized_check` instead);
    another config and the CPU only to rehearse this script's control flow at a tiny size.
    Returns the serving record, the launch counts, the model, the request specs and each
    request's greedy tokens."""
    import numpy as np
    import torch

    from dolomite_engine_tpu_torch.models import config_from_dict, get_model_class
    from dolomite_engine_tpu_torch.ops.kernels import KERNELS, reset_launch_counts
    from dolomite_engine_tpu_torch.ops.moe import route
    from dolomite_engine_tpu_torch.serving import RequestStatus, ServingEngine, serve_batch

    config = config_from_dict(config_kwargs) if model is None else model.config
    moe = config.model_type == "moe_dolomite"
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if model is None:
        model = get_model_class(config.model_type)(config, dtype=torch.bfloat16, device=device, seed=seed)
    device = model.device
    _sync(device)
    build_s = time.perf_counter() - t0

    rs = np.random.RandomState(seed)
    vocab = config.vocab_size
    shared = rs.randint(1, vocab, 512).tolist()
    lengths = rs.randint(300, 1501, 8).tolist()
    prompts = [rs.randint(1, vocab, n).tolist() for n in lengths]
    for i in (0, 7):  # same length range, first 512 tokens shared
        prompts[i] = shared + prompts[i][: max(lengths[i] - 512, 16)]
    specs = [dict(prompt_ids=p, max_new_tokens=MAX_NEW) for p in prompts]

    # warm-up on a small engine (cuBLAS handles, allocator), launches not counted
    warm = ServingEngine(model, None, num_slots=1, max_len=256, eos_token_id=None, device=device, kv_dtype=kv_dtype)
    serve_batch(warm, [dict(prompt_ids=prompts[1][:100], max_new_tokens=2)])
    del warm

    engine = ServingEngine(
        model, None, num_slots=NUM_SLOTS, max_len=MAX_LEN, page_size=PAGE,
        prefill_chunk_tokens=CHUNK, eos_token_id=None, pad_token_id=config.pad_token_id,
        device=device, kv_dtype=kv_dtype,
    )
    _sync(device)
    reset_launch_counts()
    t0 = time.perf_counter()
    # the request that shares request 0's prefix arrives after the first seven finished,
    # so the prefix index holds request 0's pages when it is admitted
    states = serve_batch(engine, specs[:7]) + serve_batch(engine, specs[7:])
    _sync(device)
    wall_s = time.perf_counter() - t0
    launches = {k.name: k.launches for k in KERNELS}

    stats = engine.stats
    for state in states:
        assert state.status == RequestStatus.completed, state.status
        assert len(state.tokens) == MAX_NEW and all(0 <= t < vocab for t in state.tokens)
    assert stats.prefix_hit_tokens > 0, "the shared prefix did not hit"
    assert engine.pool.num_free == NUM_SLOTS
    forwards = stats.decode_steps + stats.prefill_chunks
    layers = config.n_layer
    expected = {
        "rmsnorm": (2 * layers + 1) * forwards,
        "rope_qkv": layers * forwards,
        "paged_decode_attention": layers * stats.decode_steps,
        "paged_prefill_attention": layers * stats.prefill_chunks,
        "flash_attn_fwd": 0,
        "flash_attn_bwd": 0,
        "fused_ce": 0,
        "grouped_gemm": 2 * layers * forwards if moe else 0,  # c_fc and c_proj of every layer
        "grouped_gemm_tgmm": 0,
        "kv_quant": 2 * layers * forwards if engine.pool.quantized else 0,  # K and V of every layer
        "flash_attn_bias_fwd": 0,
        "flash_attn_bias_bwd": 0,
    }
    if device.type == "cuda":  # on the CPU (a rehearsal) the plain versions run
        assert launches == expected, (launches, expected)
    greedy = [state.tokens for state in states]
    if kv_dtype is not None:
        serving = {
            "model": {"model_type": config.model_type, "n_layer": config.n_layer, "n_embd": config.n_embd},
            "kv_dtype": kv_dtype, "kv_bytes_per_token": engine.pool.kv_bytes_per_token,
            "requests": len(states), "wall_s": wall_s,
            "ttft_mean_s": stats.mean_ttft_s(), "prefill_tok_s": stats.prefill_tok_s(),
            "decode_tok_s": stats.decode_tok_s(), "prefill_tokens": stats.prefill_tokens,
            "prefix_hit_tokens": stats.prefix_hit_tokens, "decode_steps": stats.decode_steps,
            "prefill_chunks": stats.prefill_chunks, "launches": launches,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9 if device.type == "cuda" else None,
        }
        return serving, launches, model, specs, greedy

    # the kernel path's logits against a plain full-sequence forward, request 2
    probe = states[2]
    tokens = probe.request.prompt_ids + probe.tokens[:4]
    prompt_len = len(probe.request.prompt_ids)
    ids = torch.tensor([tokens], device=device)
    # an MoE layer's router logits on each path: forward-major, layer-minor on the kernel path
    kernel_routing, plain_routing, exact_routing = [], [], []
    hooks = [
        block.moe.register_forward_hook(lambda module, args, out: kernel_routing.append(out[1]))
        for block in model.transformer.h
        if moe
    ]
    with torch.no_grad():
        got = kernel_path_logits(model, tokens, prompt_len).float()
        want = plain_forward(model, ids, router_logits=plain_routing)[0].float()
        # the same (bf16-rounded) weights in fp32: how far each bf16 path is from exact
        exact = plain_forward(model, ids, torch.float32, exact_routing)[0].float()
    for hook in hooks:
        hook.remove()
    assert bool(torch.isfinite(got).all())
    diff = (got - want).abs()
    kernel_err = (got - exact).abs().mean().item()
    plain_err = (want - exact).abs().mean().item()
    logit_std = want.std().item()
    # an MoE token whose bf16 router logits tie or cross picks other experts on the two
    # paths (spiky per-token errors): the ratio criterion of the training checks
    ratio = 1.5 if moe else 1.25
    routing = {}
    if moe:
        # the kernel path's rows per forward: each prefill chunk's real tokens, then one per decode
        rows = [min(CHUNK, prompt_len - start) for start in range(0, prompt_len, CHUNK)]
        rows += [1] * (len(tokens) - prompt_len)
        layers = config.n_layer
        top_k = config.num_experts_per_tok

        def experts(logits):
            return route(logits, top_k)[1].sort(-1).values

        differ, plain_differ = [], []
        for layer in range(layers):
            kernel = torch.cat([kernel_routing[f * layers + layer][:n] for f, n in enumerate(rows)])
            plain = experts(plain_routing[layer])
            differ.append((experts(kernel) != plain).any(-1).float().mean().item())
            plain_differ.append((plain != experts(exact_routing[layer])).any(-1).float().mean().item())
        routing = {
            "routing_differs_share": sum(differ) / layers, "routing_differs_share_by_layer": differ,
            "plain_bf16_vs_fp32_routing_differs_share": sum(plain_differ) / layers,
        }
    logits_check = {
        "positions": len(tokens), "max_abs_err": diff.max().item(),
        "mean_abs_err": diff.mean().item(), "logit_std": logit_std,
        "argmax_agreement": (got.argmax(-1) == want.argmax(-1)).float().mean().item(),
        "kernel_path_mean_abs_err_vs_fp32": kernel_err,
        "plain_bf16_mean_abs_err_vs_fp32": plain_err,
        **routing,
        "tolerance": (
            ("" if moe else "kernel path vs plain bf16: mean abs err <= 0.1 logit std; and ")
            + f"against the fp32 forward the kernel path errs at most {ratio}x the plain bf16 forward"
        ),
    }
    # bf16 rounding differs between the two paths at every op of every layer (the plain
    # attention rounds scores and probabilities to bf16, the kernels keep fp32), so the
    # paths differ by bf16 noise; a wrong kernel would put the error at the logits' scale.
    # Routing flips put the MoE paths apart by more than the dense bound: the ratio judges it
    if not moe:
        assert diff.mean().item() <= 0.1 * logit_std, logits_check
    assert kernel_err <= ratio * plain_err, logits_check

    serving = {
        "model": {
            "model_type": config.model_type, "n_layer": config.n_layer, "n_embd": config.n_embd,
            "n_head": config.n_head, "num_key_value_heads": config.num_key_value_heads,
            "vocab_size": config.vocab_size, "dtype": "bfloat16", "weights": "random",
            "params": sum(p.numel() for p in model.parameters()),
            **({"num_experts": config.num_experts, "top_k": config.num_experts_per_tok} if moe else {}),
        },
        "seed": seed, "requests": len(states), "prompt_tokens": [len(p) for p in prompts],
        "max_new_tokens": MAX_NEW, "wall_s": wall_s, "model_init_s": build_s,
        "ttft_mean_s": stats.mean_ttft_s(), "prefill_tok_s": stats.prefill_tok_s(),
        "decode_tok_s": stats.decode_tok_s(), "prefill_tokens": stats.prefill_tokens,
        "prefix_hit_tokens": stats.prefix_hit_tokens, "decode_steps": stats.decode_steps,
        "prefill_chunks": stats.prefill_chunks, "launches": launches,
        "logits_check": logits_check,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9 if device.type == "cuda" else None,
    }
    return serving, launches, model, specs, greedy


def _profiled(fn, host=False):
    """(torch.profiler events, wall seconds) of `fn()` run to completion on the card;
    kernel activity only unless `host` (less profiler cost on the host)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host else [ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    return prof.key_averages(), wall_s


def _device_time(events, wall_s, top):
    """Device time by kernel name and the device's busy share of the window (the
    profiler's own host cost lowers that share)."""
    from torch.autograd import DeviceType

    kernels = [
        (e.key, e.count, e.self_device_time_total / 1e3)
        for e in events
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
    ]
    busy_ms = sum(ms for _, _, ms in kernels)
    assert busy_ms > 0, "the profiler saw no device time"
    families = {}
    for name, count, ms in kernels:
        family = _kernel_family(name)
        total = families.setdefault(family, {"launches": 0, "ms": 0.0})
        total["launches"] += count
        total["ms"] += ms
    return {
        "wall_s": wall_s, "device_busy_s": busy_ms / 1e3, "device_busy_share": busy_ms / 1e3 / wall_s,
        "launches": sum(count for _, count, _ in kernels),
        "families": {
            family: dict(total, share=total["ms"] / busy_ms)
            for family, total in sorted(families.items(), key=lambda item: -item[1]["ms"])
        },
        "top_kernels": [
            {"name": name[:96], "launches": count, "ms": ms, "share": ms / busy_ms}
            for name, count, ms in sorted(kernels, key=lambda k: -k[2])[:top]
        ],
    }


# device-kernel name fragments -> family (the port's kernels, then PyTorch's and cuBLAS's)
_FAMILIES = (
    ("tgmm_kernel", "grouped_gemm_tgmm"),
    ("gmm_kernel", "grouped_gemm"),
    ("flash", "flash_attention"),
    ("paged_decode", "paged_decode_attention"),
    ("paged_prefill", "paged_prefill_attention"),
    ("rmsnorm", "rmsnorm"),
    ("rope", "rope_qkv"),
    ("fused_ce", "fused_ce"),
    ("multi_tensor_apply", "optimizer_foreach"),
    ("gemm", "cublas_gemm"),
    ("nvjet", "cublas_gemm"),
    ("cutlass", "cublas_gemm"),
    ("sort", "sort"),
    ("radix", "sort"),
    ("index", "index_gather_scatter"),
    ("scatter", "index_gather_scatter"),
    ("gather", "index_gather_scatter"),
    ("reduce", "reduction"),
    ("memcpy", "memcpy"),
    ("memset", "memset"),
    ("copy", "casts_and_copies"),
    ("elementwise", "elementwise"),
)


def _kernel_family(name):
    lower = name.lower()
    return next((family for fragment, family in _FAMILIES if fragment in lower), "other")


def _count_host_syncs(fn):
    """Run `fn()` with PyTorch's sync debug mode on and count the synchronising calls
    it reports (tensor-to-host copies, ``.item()``, ...) by Python call site."""
    import warnings

    import torch

    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fn()
    torch.cuda.set_sync_debug_mode("default")
    sites = {}
    for warning in caught:
        if "synchroniz" in str(warning.message):
            site = f"{os.path.relpath(warning.filename)}:{warning.lineno}"
            sites[site] = sites.get(site, 0) + 1
    return sites


def profile_serving(model, specs):
    """Phase 4 (and 7): where the device time goes. The slice's requests are served
    again on a fresh engine under torch.profiler; then once more on another fresh engine,
    unprofiled, with the host syncs counted by call site (an explicit
    ``torch.cuda.synchronize`` is not counted)."""
    from dolomite_engine_tpu_torch.serving import ServingEngine, serve_batch

    def fresh_engine():
        return ServingEngine(
            model, None, num_slots=NUM_SLOTS, max_len=MAX_LEN, page_size=PAGE,
            prefill_chunk_tokens=CHUNK, eos_token_id=None, pad_token_id=model.config.pad_token_id,
        )

    def replay(engine):
        serve_batch(engine, specs[:7])
        serve_batch(engine, specs[7:])

    engine = fresh_engine()
    profile = _device_time(*_profiled(lambda: replay(engine)), top=15)
    counted = fresh_engine()
    syncs = _count_host_syncs(lambda: replay(counted))
    forwards = counted.stats.decode_steps + counted.stats.prefill_chunks
    # the MoE dispatch keeps its layout on the device: no sync of its own
    in_moe = {site: n for site, n in syncs.items() if "moe" in site}
    assert not in_moe, f"the MoE layers synchronise with the host: {in_moe}"
    return dict(
        profile, decode_steps=engine.stats.decode_steps, prefill_chunks=engine.stats.prefill_chunks,
        host_syncs=syncs, host_syncs_per_forward=sum(syncs.values()) / forwards,
    )


def bf16_kv_bytes(config):
    """K/V bytes per cached token of a bf16 pool: 2 bytes for K and V of every layer."""
    return 2 * 2 * config.n_layer * config.num_key_value_heads * config.head_dim


def launches_per_forward(model, kv_dtype=None):
    """Device launches (kernels and copies, by torch.profiler) of one prefill chunk and
    of one decode step of the phase-3 engine over a pool of `kv_dtype`: a 300-token
    request's first step (its one chunk and a decode step), then four decode steps. Also
    a decode step's device busy time and, for a quantized pool, kv_quant's device time
    per launch there (8 slots' windows of 2 pages; the idle slots' land in the trash page)."""
    from torch.autograd import DeviceType

    from dolomite_engine_tpu_torch.serving import ServingEngine

    engine = ServingEngine(
        model, None, num_slots=NUM_SLOTS, max_len=MAX_LEN, page_size=PAGE, prefill_chunk_tokens=CHUNK,
        eos_token_id=None, pad_token_id=model.config.pad_token_id, kv_dtype=kv_dtype,
    )
    engine.submit(list(range(1, 301)), max_new_tokens=8)

    def kernels(fn):
        events, _ = _profiled(fn)
        return [e for e in events if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]

    first = sum(e.count for e in kernels(engine.step))
    decode = kernels(lambda: [engine.step() for _ in range(4)])
    engine.drain()
    per_step = sum(e.count for e in decode) / 4
    quant = [e for e in decode if "kv_quant" in e.key]
    return {
        "prefill_chunk": first - per_step, "decode_step": per_step,
        "decode_step_device_ms": sum(e.self_device_time_total for e in decode) / 4 / 1e3,
        "kv_quant_device_us": (
            sum(e.self_device_time_total for e in quant) / sum(e.count for e in quant) if quant else None
        ),
    }


@contextlib.contextmanager
def _plain_quantized_path():
    """The quantized path with the plain versions of its three kernels on the same CUDA
    tensors: the encode the scatter calls and the two attention functions the model calls
    are swapped here, and put back as they were afterwards."""
    from dolomite_engine_tpu_torch.models import modeling_utils
    from dolomite_engine_tpu_torch.ops import attention
    from dolomite_engine_tpu_torch.ops.kernels.paged_attention import paged_decode_attention_plain
    from dolomite_engine_tpu_torch.ops.kernels.prefill_attention import paged_prefill_attention_plain
    from dolomite_engine_tpu_torch.ops.kv_quant import quantize_pages_plain

    swaps = [
        (modeling_utils, "paged_decode_attention", paged_decode_attention_plain),
        (modeling_utils, "paged_prefill_attention", paged_prefill_attention_plain),
        (attention, "quantize_pages", quantize_pages_plain),
    ]
    saved = [getattr(module, name) for module, name, _ in swaps]
    try:
        for module, name, plain in swaps:
            setattr(module, name, plain)
        yield
    finally:
        for (module, name, _), value in zip(swaps, saved):
            setattr(module, name, value)


def quantized_check(model, tokens, prompt_len, kv_dtype="int8"):
    """Phase 10: `tokens` (a prompt of `prompt_len` and the tokens after it) chunk-prefilled
    and decoded into a fresh `kv_dtype` pool through the kernel path, and again through the
    plain versions of kv_quant and the paged decode / prefill attention. Layer 0's K / V
    come from the embeddings alone, so its pool must hold the same bytes on both paths,
    and its attention must agree as the kernels' own cases do; the last position's logits
    are held to the serving check's bound. A page of rounding ties must encode to the
    plain bytes. Reports both paths' logit error against an fp32 plain forward, beside the
    bf16 pool's."""
    import torch

    from dolomite_engine_tpu_torch.ops.kv_quant import KV_QUANT_DTYPES, as_bytes, quantize_pages, quantize_pages_plain
    from dolomite_engine_tpu_torch.serving import PagedKVCachePool

    storage, qmax = KV_QUANT_DTYPES[kv_dtype]
    config = model.config
    rows = [min(CHUNK, prompt_len - start) for start in range(0, prompt_len, CHUNK)]
    rows += [1] * (len(tokens) - prompt_len)
    layer0 = []
    hook = model.transformer.h[0].attn.register_forward_hook(lambda module, args, out: layer0.append(out[0]))

    def run(caches):
        layer0.clear()
        logits = kernel_path_logits(model, tokens, prompt_len, caches).float()
        attn = torch.cat([out[0, :n].float() for out, n in zip(layer0, rows)])
        return logits, attn

    def fresh_pool():
        return PagedKVCachePool(model, 1, MAX_LEN, PAGE, kv_dtype=kv_dtype).caches

    with torch.no_grad():
        kernel_caches, plain_caches = fresh_pool(), fresh_pool()
        got, got_attn = run(kernel_caches)
        with _plain_quantized_path():
            want, want_attn = run(plain_caches)
        bf16_pool, _ = run(None)
        exact = plain_forward(model, torch.tensor([tokens], device=model.device), torch.float32)[0].float()
        gen = torch.Generator(device=model.device).manual_seed(0)
        ties = tie_page(config.num_key_value_heads, config.head_dim, qmax, gen)
        all_valid = torch.ones(ties.shape[:2], dtype=torch.bool, device=model.device)
        tie_codes, tie_want = quantize_pages(ties, all_valid, qmax, storage)[0], quantize_pages_plain(ties, all_valid, qmax, storage)[0]
    hook.remove()

    def same_bytes(a, b):
        return torch.equal(as_bytes(a)[1:], as_bytes(b)[1:]) if a.element_size() == 1 else torch.equal(
            a[1:].view(torch.int32), b[1:].view(torch.int32)
        )

    pool_identical = {name: same_bytes(kernel_caches[0][name], plain_caches[0][name]) for name in ("k", "v", "k_scale", "v_scale")}
    attn_err = ((got_attn - want_attn).norm() / want_attn.norm()).item()
    last = (got[-1] - want[-1]).abs()
    check = {
        "kv_dtype": kv_dtype, "n_layer": config.n_layer, "positions": len(tokens), "prompt_tokens": prompt_len,
        "layer0_pool_bytes_identical": pool_identical,
        "layer0_attention_rel_l2_err": attn_err,
        "tie_page_codes_identical": torch.equal(as_bytes(tie_codes), as_bytes(tie_want)),
        "last_position": {"mean_abs_err": last.mean().item(), "max_abs_err": last.max().item(), "logit_std": want[-1].std().item()},
        "mean_abs_err_all_positions": (got - want).abs().mean().item(),
        "argmax_agreement": (got.argmax(-1) == want.argmax(-1)).float().mean().item(),
        "kernel_path_mean_abs_err_vs_fp32": (got - exact).abs().mean().item(),
        "plain_path_mean_abs_err_vs_fp32": (want - exact).abs().mean().item(),
        "bf16_pool_kernel_path_mean_abs_err_vs_fp32": (bf16_pool - exact).abs().mean().item(),
        "tolerance": (
            "layer 0's pool codes and scales byte-identical (trash page 0 aside); layer 0's attention "
            "output within 2e-2 relative L2 error (bf16 rounding of scores and outputs); last "
            "position's logits: mean abs err <= 0.1 logit std (the serving check's bound); the tie "
            "page's codes byte-identical"
        ),
    }
    assert check["tie_page_codes_identical"], f"kv_quant rounds a tie otherwise than the plain version: {check}"
    assert all(pool_identical.values()), f"layer 0's pool bytes differ between the paths: {check}"
    assert attn_err <= 2e-2, f"layer 0's attention differs between the paths: {check}"
    assert check["last_position"]["mean_abs_err"] <= 0.1 * check["last_position"]["logit_std"], check
    return check


def _doc_ids(rs, seq, num_docs):
    """[seq] int32 segment ids (1..num_docs) of documents cut at random points."""
    import numpy as np

    ids = np.ones(seq, np.int32)
    for cut in np.sort(rs.choice(np.arange(1, seq), num_docs - 1, replace=False)):
        ids[cut:] += 1
    return ids


def _visible_pairs(seg):
    """(query, key) pairs the causal segment mask lets through: sum of L (L + 1) / 2 over
    the documents (runs of one segment id) of each row."""
    import torch

    lengths = [torch.unique_consecutive(row, return_counts=True)[1] for row in seg]
    return int(sum((n * (n + 1) // 2).sum().item() for n in lengths))


def bias_slack(bias, causal, dtype):
    """The flash form's tolerance beyond the usual one, relative to the largest value: 0,
    and with a bias but no causal mask, in fp32 16 fp32 ulps of the largest bias, in bf16
    2^-8. Each row's scores are shifted by the row's own-position bias, so causal scores
    that carry probability stay small; without the causal mask the scores past the
    diagonal reach the largest bias (alibi: ~1720 at 2048 tokens, ulp 1.2e-4), where the
    kernel (log2 units) and the plain version (natural units) round them apart. And
    there each row puts nearly all its probability on its document's last keys, so a
    key's dK / dV sums hundreds of P values the bf16 kernel rounded to bf16 (2^-9 each)."""
    import torch

    if bias is None or causal:
        return 0.0
    if dtype != torch.float32:
        return 2.0**-8
    largest = bias.abs().max().item()
    return 16 * 2.0 ** (math.floor(math.log2(largest)) - 23) if largest > 0 else 0.0


def _close(got, want, fp32, slack=0.0):
    """(within tolerance, max abs error): fp32 within 1e-5 abs + 1e-5 rel, bf16 within
    2e-2 abs plus one bf16 ulp of the value (both sides round their fp32 results); each
    plus `slack` times the largest |value|."""
    diff = (got.float() - want.float()).abs()
    want = want.float()
    bound = 1e-5 + 1e-5 * want.abs() if fp32 else 2e-2 + _bf16_ulp(want)
    return bool((diff <= bound + slack * want.abs().max()).all()), diff.max().item()


def _computed_pairs(seg, causal=True):
    """(query, key) pairs the flash kernels compute: 64 x 64 for every pair of a 64-row
    query block (one consumer warpgroup's) and a 64-key tile (at or below its diagonal
    when causal) whose segment ranges meet; the rest are skipped."""
    import torch

    tiles = seg.reshape(seg.shape[0], -1, 64)
    lo, hi = tiles.min(-1).values, tiles.max(-1).values  # [B, S / 64]
    meets = (hi[:, :, None] >= lo[:, None, :]) & (lo[:, :, None] <= hi[:, None, :])  # [B, query, key]
    if causal:
        meets = meets & torch.ones(meets.shape[1:], dtype=torch.bool, device=seg.device).tril()
    return int(meets.sum().item()) * 64 * 64


def _varlen_library(q, k, v, seg, scale):
    """`torch.nn.attention.varlen.varlen_attn` over the packed rows, each run of one
    segment id (padding included) one causal sequence: the kernel's function. Returns
    (forward call, inputs that take gradients, note); the call is None, with the reason in
    the note, where the card's torch lacks it or it does not take these inputs."""
    import inspect

    import torch

    try:
        from torch.nn.attention.varlen import varlen_attn
    except ImportError as e:
        return None, None, f"torch {torch.__version__} has no varlen_attn ({e})"
    params = inspect.signature(varlen_attn).parameters
    batch, seq, hq, hd = q.shape
    hkv = k.shape[2]
    lengths = torch.cat([torch.unique_consecutive(row, return_counts=True)[1] for row in seg])
    cu = torch.zeros(len(lengths) + 1, dtype=torch.int32, device=q.device)
    cu[1:] = lengths.cumsum(0)
    longest = int(lengths.max().item())
    kwargs = {"scale": scale}
    if "window_size" in params:
        kwargs["window_size"] = (-1, 0)
    elif "is_causal" in params:
        kwargs["is_causal"] = True
    else:
        return None, None, "varlen_attn takes no causal mask"
    flat = [t.reshape(batch * seq, t.shape[2], hd).detach().clone().requires_grad_() for t in (q, k, v)]
    note = "varlen_attn, one causal sequence per document"
    if hq != hkv:
        if "enable_gqa" not in params:
            return None, None, "varlen_attn takes no GQA (enable_gqa) in this torch"
        kwargs["enable_gqa"] = True

    def call(tensors=flat):
        return varlen_attn(*tensors, cu, cu, longest, longest, **kwargs)

    try:
        call()
    except Exception as e:  # the library yardstick only: a refusal is recorded, not fatal
        return None, None, f"varlen_attn refused these inputs: {type(e).__name__}: {str(e)[:200]}"
    return call, flat, note


def training_kernel_cases(seed):
    """Phase 2, training kernels: flash attention forward and backward and fused_ce
    against their plain versions, with kernel, plain and library timings. The flash
    library call is `varlen_attn` over the documents (the same function); SDPA, causal
    over whole rows without segments (a different function, ~3-6x the pairs), is kept as
    `sdpa_ms`."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from dolomite_engine_tpu_torch.ops.kernels import flash_attention as fa
    from dolomite_engine_tpu_torch.ops.kernels import fused_ce

    cases = []

    def record(*args, **kwargs):
        _record(cases, *args, plain_iters=5, **kwargs)  # the plain attention is slow at S = 4096

    rs = np.random.RandomState(seed)
    moe_heads, moe_kv = MOE_EP["n_head"], MOE_EP["num_key_value_heads"]
    moe_hd = MOE_EP["n_embd"] // moe_heads
    for dtype in (torch.bfloat16, torch.float32):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        es = torch.tensor([], dtype=dtype).element_size()
        fp32 = dtype == torch.float32
        tol = "1e-5 abs + 1e-5 rel" if fp32 else "2e-2 abs + 1 bf16 ulp"
        # the slice's layer (packed documents), a GQA case at head_dim 128, and the MoE
        # training slice's layer
        for batch, seq, hq, hkv, hd, docs in (
            (1, TRAIN_SEQ, 32, 32, 80, 6), (2, 1024, 8, 2, 128, 3),
            (MOE_TRAIN_MICRO, MOE_TRAIN_SEQ, moe_heads, moe_kv, moe_hd, 3),
        ):
            qkv = torch.randn((batch, seq, (hq + 2 * hkv) * hd), generator=gen, device="cuda").to(dtype)
            q, k, v = qkv.split([hq * hd, hkv * hd, hkv * hd], dim=-1)
            q, k, v = q.reshape(batch, seq, hq, hd), k.reshape(batch, seq, hkv, hd), v.reshape(batch, seq, hkv, hd)
            seg = torch.as_tensor(np.stack([_doc_ids(rs, seq, docs) for _ in range(batch)]), device="cuda")
            pairs = _visible_pairs(seg)
            scale = hd**-0.5
            shape = f"[{batch},{seq},{hq}/{hkv},{hd}] {docs} docs"
            out, lse = fa.flash_attention_fwd(q, k, v, seg, scale)
            want, want_lse = fa.flash_attention_fwd_plain(q, k, v, seg, scale)
            ok, err = _close(out, want, fp32)
            ok = ok and bool(torch.allclose(lse, want_lse, atol=1e-5, rtol=1e-5))
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            gqa = dict(enable_gqa=True) if hq != hkv else {}
            io = (2 * q.numel() + 2 * k.numel()) * es
            varlen, flat, note = _varlen_library(q, k, v, seg, scale) if not fp32 else (None, None, "bf16 only")
            figures = {"visible_pairs": pairs, "computed_pairs": _computed_pairs(seg), "library": note}
            varlen_fwd = None
            if varlen is not None:  # the yardstick computes the same function

                def varlen_fwd(call=varlen):
                    with torch.no_grad():
                        return call()

                figures["library_max_abs_err"] = (
                    (varlen_fwd().float() - want.reshape(batch * seq, hq, hd).float()).abs().max().item()
                )
            sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, scale=scale, **gqa)
            record(
                "flash_attn_fwd", shape, dtype, err, ok, tol,
                lambda: fa.flash_attention_fwd(q, k, v, seg, scale),
                lambda: fa.flash_attention_fwd_plain(q, k, v, seg, scale),
                varlen_fwd,
                io + q.numel() // hd * 4 + seg.numel() * 4, 4 * pairs * hd * hq,
                extra=dict(figures, sdpa_ms=_time_ms(sdpa), sdpa="SDPA causal over whole rows, no segments"),
            )
            dout = torch.randn(out.shape, generator=gen, device="cuda").to(dtype)
            grads = fa.flash_attention_bwd(q, k, v, seg, out, lse, dout, scale)
            want_grads = fa.flash_attention_bwd_plain(q, k, v, seg, out, lse, dout, scale)
            checks = [_close(g, w, fp32) for g, w in zip(grads, want_grads)]
            ql, kl, vl = (t.detach().requires_grad_() for t in (qt, kt, vt))
            lib_out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True, scale=scale, **gqa)
            lib_dout = dout.transpose(1, 2).contiguous()
            varlen_bwd = None
            if varlen is not None:
                varlen_out = varlen()
                flat_dout = dout.reshape(batch * seq, hq, hd)
                varlen_bwd = lambda: torch.autograd.grad(varlen_out, flat, flat_dout, retain_graph=True)
            sdpa_bwd = lambda: torch.autograd.grad(lib_out, (ql, kl, vl), lib_dout, retain_graph=True)
            record(
                "flash_attn_bwd", shape, dtype, max(e for _, e in checks), all(c for c, _ in checks), tol,
                lambda: fa.flash_attention_bwd(q, k, v, seg, out, lse, dout, scale),
                lambda: fa.flash_attention_bwd_plain(q, k, v, seg, out, lse, dout, scale),
                varlen_bwd,
                (4 * q.numel() + 4 * k.numel()) * es + q.numel() // hd * 4 + seg.numel() * 4,
                10 * pairs * hd * hq,
                extra=dict(figures, sdpa_ms=_time_ms(sdpa_bwd), sdpa="SDPA causal over whole rows, no segments"),
            )
            del qkv, q, k, v, out, want, grads, want_grads, ql, kl, vl, lib_out, varlen, varlen_fwd, flat, varlen_bwd
            torch.cuda.empty_cache()

        # one loss chunk of the slice (256 rows against the whole table), and a vocabulary
        # that is not a multiple of the kernel's 128-column tile
        rows, hidden = 256, GRANITE_3B_CODE["n_embd"]
        for vocab in (GRANITE_3B_CODE["vocab_size"], GRANITE_3B_CODE["vocab_size"] - 83):
            # logits of std ~0.5, the scale of an LM head's at init (the embedding std 0.02)
            h = (torch.randn((rows, hidden), generator=gen, device="cuda") * 4 / hidden**0.5).to(dtype)
            table = (torch.randn((vocab, hidden), generator=gen, device="cuda") / 8).to(dtype)
            labels = torch.randint(0, vocab, (rows,), generator=gen, device="cuda")
            labels[::7] = fused_ce.IGNORE_INDEX
            got = fused_ce.fused_ce_rowwise(h, table, labels)
            want = fused_ce.fused_ce_rowwise_plain(h, table, labels)
            if fp32:
                ok = all(bool(torch.allclose(a, b, rtol=1e-5, atol=0)) for a, b in zip(got, want))
            else:
                ok = all(bool(((a - b).abs() <= 2e-2).all()) for a, b in zip(got, want))
            err = max((a - b).abs().max().item() for a, b in zip(got, want))
            record(
                "fused_ce", f"[{rows},{hidden}]x[{vocab},{hidden}]", dtype, err, ok,
                "1e-5 rel" if fp32 else "2e-2 abs",
                lambda: fused_ce.fused_ce_rowwise(h, table, labels),
                lambda: fused_ce.fused_ce_rowwise_plain(h, table, labels),
                None,
                (rows + vocab) * hidden * es + rows * 4 + 2 * rows * 4, 2 * rows * vocab * hidden,
            )
            del h, table
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return cases


def _segment_pairs(seg, causal):
    """(query, key) pairs the segment (and causal) mask lets through: over the runs of one
    segment id of each row, L (L + 1) / 2 causal or L^2 not."""
    import torch

    if causal:
        return _visible_pairs(seg)
    lengths = [torch.unique_consecutive(row, return_counts=True)[1] for row in seg]
    return int(sum((n * n).sum().item() for n in lengths))


def alibi_kernel_cases(seed):
    """Phase 2, the additive-bias / non-causal flash form at the alibi slice's layer
    ([2, 2048] rows, 32 heads of 128): causal alibi over 4 packed documents per row (the
    path's case, first), the causal form without a bias on the same inputs (the
    splash-form kernel, for comparison), non-causal without and with the bias, and
    causal alibi over a left-padded batch (segment ids and the bias from the mask's
    cumsum), forward and backward against the plain version, with kernel, plain and
    library timings. The
    library call is `F.scaled_dot_product_attention` with the additive float mask
    materialised, ``bias[k] - bias[i]`` and -inf where masked ([B, H, S, S] in the
    inputs' dtype); the bound counts the bias rows' bytes once."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from dolomite_engine_tpu_torch.ops.alibi import get_alibi_bias
    from dolomite_engine_tpu_torch.ops.kernels import flash_attention as fa

    batch, seq, heads, hd = ALIBI_TRAIN_MICRO, ALIBI_TRAIN_SEQ, MPT_7B["n_head"], MPT_7B["n_embd"] // MPT_7B["n_head"]
    scale = hd**-0.5
    rs = np.random.RandomState(seed)
    packed = torch.as_tensor(np.stack([_doc_ids(rs, seq, 4) for _ in range(batch)]), device="cuda")
    padded = torch.ones((batch, seq), dtype=torch.int32, device="cuda")
    padded[1, :300] = 0  # row 1 left-padded by 300 tokens
    alibi = get_alibi_bias(heads, None, batch, seq, device="cuda")[:, :, 0].contiguous()
    forms = [  # (label, segment ids, bias, causal)
        ("causal alibi, 4 docs", packed, alibi, True),
        ("causal, 4 docs, no bias", packed, None, True),
        ("non-causal, 4 docs", packed, None, False),
        ("non-causal alibi, 4 docs", packed, alibi, False),
        ("causal alibi, left-padded 300", padded, get_alibi_bias(heads, padded, batch, seq)[:, :, 0].contiguous(), True),
    ]
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        es = torch.tensor([], dtype=dtype).element_size()
        fp32 = dtype == torch.float32
        for label, seg, bias, causal in forms:
            qkv = torch.randn((batch, seq, 3 * heads * hd), generator=gen, device="cuda").to(dtype)
            q, k, v = (t.reshape(batch, seq, heads, hd) for t in qkv.split(heads * hd, dim=-1))
            pairs = _segment_pairs(seg, causal)
            slack = bias_slack(bias, causal, dtype)
            tol = ("1e-5 abs + 1e-5 rel" if fp32 else "2e-2 abs + 1 bf16 ulp") + (
                f" + {slack:.3g} x max |value|" if slack else ""
            )
            shape = f"[{batch},{seq},{heads},{hd}] {label}"
            out, lse = fa.flash_attention_fwd(q, k, v, seg, scale, bias, causal)
            want, want_lse = fa.flash_attention_fwd_plain(q, k, v, seg, scale, bias, causal)
            ok, err = _close(out, want, fp32, slack)
            ok = ok and bool(torch.allclose(lse, want_lse, atol=1e-5, rtol=1e-5))
            # the library's mask: the same function as an additive float mask
            visible = seg[:, None, :, None] == seg[:, None, None, :]
            if causal:
                visible = visible & torch.ones((seq, seq), dtype=torch.bool, device="cuda").tril()
            shift = 0.0 if bias is None else bias[:, :, None, :] - bias[:, :, :, None]
            mask = torch.where(visible, shift, float("-inf")).to(dtype)
            del visible
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            side = q.numel() // hd * 4 + seg.numel() * 4 + (0 if bias is None else bias.numel() * 4)
            fwd_spec, bwd_spec = fa.kernel_specs(bias, causal)
            _record(
                cases, fwd_spec.name, shape, dtype, err, ok, tol,
                lambda: fa.flash_attention_fwd(q, k, v, seg, scale, bias, causal),
                lambda: fa.flash_attention_fwd_plain(q, k, v, seg, scale, bias, causal),
                lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, scale=scale),
                (2 * q.numel() + 2 * k.numel()) * es + side, 4 * pairs * hd * heads, plain_iters=5,
            )
            dout = torch.randn(out.shape, generator=gen, device="cuda").to(dtype)
            grads = fa.flash_attention_bwd(q, k, v, seg, out, lse, dout, scale, bias, causal)
            want_grads = fa.flash_attention_bwd_plain(q, k, v, seg, out, lse, dout, scale, bias, causal)
            checks = [_close(g, w, fp32, slack) for g, w in zip(grads, want_grads)]
            ql, kl, vl = (t.detach().requires_grad_() for t in (qt, kt, vt))
            lib_out = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask, scale=scale)
            lib_dout = dout.transpose(1, 2).contiguous()
            _record(
                cases, bwd_spec.name, shape, dtype, max(e for _, e in checks), all(c for c, _ in checks), tol,
                lambda: fa.flash_attention_bwd(q, k, v, seg, out, lse, dout, scale, bias, causal),
                lambda: fa.flash_attention_bwd_plain(q, k, v, seg, out, lse, dout, scale, bias, causal),
                lambda: torch.autograd.grad(lib_out, (ql, kl, vl), lib_dout, retain_graph=True),
                (4 * q.numel() + 4 * k.numel()) * es + side, 10 * pairs * hd * heads, plain_iters=5,
            )
            del qkv, q, k, v, out, want, grads, want_grads, ql, kl, vl, lib_out, lib_dout, mask, shift, qt, kt, vt
            torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return cases


def moe_kernel_cases(seed):
    """Phase 2, MoE: the grouped GEMMs against their plain versions at the MoE slice's
    shapes (32 experts, d 1024, swiglu c_fc banks [32, 1024, 8192], c_proj [32, 4096,
    1024]; each bank at the decode, prefill-chunk and training row counts, the training
    one also as dX and dW), with kernel, plain and library timings. Rows are spread over
    the experts as a router at init spreads them (uniformly at random). Padding rows hold
    nonzero values (with expert biases c_proj's are act(b_fc)), which kernel and plain
    version must treat as zero. The bound counts the real rows in and out and each bank
    with a routed row once. Each case names its kernel path (`wgmma`, `mma.sync`, `fma`);
    tgmm runs with the fp32 output of `_tgmm_call` and with the bank's bf16 output of the
    backward (the main path's form), which must be bit-identical to the fp32 output
    rounded to bf16."""
    import numpy as np
    import torch

    from dolomite_engine_tpu_torch.ops.kernels import moe as kmoe

    experts, d, k = MOE_EP["num_experts"], MOE_EP["n_embd"], MOE_EP["num_experts_per_tok"]
    f = 4 * d
    rs = np.random.RandomState(seed)
    # (label, rows A, K, N, experts with rows, forms)
    shapes = [
        ("decode: 8 slots x top-4, c_fc", NUM_SLOTS * k, d, 2 * f, experts, ("gmm",)),
        ("prefill chunk: 512 tokens x top-4, c_fc", CHUNK * k, d, 2 * f, experts, ("gmm",)),
        (
            "training micro-batch: 2 x 2048 tokens x top-4, c_fc",
            MOE_TRAIN_MICRO * MOE_TRAIN_SEQ * k, d, 2 * f, experts, ("gmm", "dx", "tgmm"),
        ),
        ("most experts empty: 96 rows on 3 of 32, c_proj", 96, f, d, 3, ("gmm", "dx", "tgmm")),
        ("decode: 8 slots x top-4, c_proj", NUM_SLOTS * k, f, d, experts, ("gmm",)),
        ("prefill chunk: 512 tokens x top-4, c_proj", CHUNK * k, f, d, experts, ("gmm",)),
        (
            "training micro-batch: 2 x 2048 tokens x top-4, c_proj",
            MOE_TRAIN_MICRO * MOE_TRAIN_SEQ * k, f, d, experts, ("gmm", "dx", "tgmm"),
        ),
    ]
    sizes = []
    for _, rows, *_rest, used, _forms in shapes:
        group = np.zeros(experts, np.int64)
        group[rs.permutation(experts)[:used]] = rs.multinomial(rows, np.full(used, 1.0 / used))
        sizes.append(group)
    # the library yardstick: one PyTorch grouped GEMM over the unpadded rows (bf16 only)
    grouped_mm = getattr(torch, "_grouped_mm", None)
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        es = torch.tensor([], dtype=dtype).element_size()
        fp32 = dtype == torch.float32
        # fp32 sums of K terms taken in two orders drift apart by ~2^-24 sqrt(K) of the
        # output's scale; a bf16 output may also round one ulp apart
        tol = ("1e-5 rel" if fp32 else "1 bf16 ulp") + " + 8 * 2^-24 * sqrt(K) * rms(output)"
        for (label, rows, k_dim, n_dim, _, forms), group in zip(shapes, sizes):
            plan, _ = kmoe.block_plan(torch.as_tensor(group, device="cuda"), rows)
            mask = kmoe._row_mask(plan.block_valid, plan.block_rows)
            starts = plan.group_block_start.cpu().numpy()
            real = torch.as_tensor(
                np.concatenate([s + np.arange(n) for s, n in zip(starts, group)]), device="cuda"
            )
            offs = torch.as_tensor(np.cumsum(group), dtype=torch.int32, device="cuda")
            banks = int((group > 0).sum())
            xp = torch.randn((plan.padded_rows, k_dim), generator=gen, device="cuda")
            dy = torch.randn((plan.padded_rows, n_dim), generator=gen, device="cuda")
            xp = torch.where(mask, xp, 4 * xp + 1).to(dtype)
            dy = torch.where(mask, dy, 4 * dy + 1).to(dtype)
            w = (torch.randn((experts, k_dim, n_dim), generator=gen, device="cuda") / k_dim**0.5).to(dtype)
            xs, dys = xp[real], dy[real]
            shape = f"{label}: A {rows}, [{k_dim}]x[{experts},{k_dim},{n_dim}], bm {plan.block_rows}, {plan.num_blocks} blocks"
            library = grouped_mm if grouped_mm is not None and not fp32 else None
            io = rows * (k_dim + n_dim) * es
            flops = 2 * rows * k_dim * n_dim

            def check(got, want, depth):
                want = want.float()
                diff = (got.float() - want).abs()
                bound = (1e-5 * want.abs() if fp32 else _bf16_ulp(want)) + 8 * 2**-24 * depth**0.5 * want.square().mean().sqrt()
                return diff.max().item(), bool((diff <= bound).all())

            if "gmm" in forms:
                got = kmoe.gmm(xp, w, plan)
                want = kmoe.gmm_plain(xp, w, plan.block_expert, plan.block_rows, plan.block_valid)
                _record(
                    cases, "grouped_gemm", shape, dtype, *check(got, want, k_dim), tol,
                    lambda: kmoe.gmm(xp, w, plan),
                    lambda: kmoe.gmm_plain(xp, w, plan.block_expert, plan.block_rows, plan.block_valid),
                    None if library is None else (lambda: library(xs, w, offs=offs)),
                    io + banks * k_dim * n_dim * es, flops, path=kmoe.gmm_path(xp, w),
                )
            if "dx" in forms:  # the backward's dX: dy against the banks read transposed
                got = kmoe.gmm(dy, w, plan, transpose_w=True)
                want = kmoe.gmm_plain(dy, w, plan.block_expert, plan.block_rows, plan.block_valid, True)
                _record(
                    cases, "grouped_gemm", "dX, banks read transposed, " + shape, dtype,
                    *check(got, want, n_dim), tol,
                    lambda: kmoe.gmm(dy, w, plan, transpose_w=True),
                    lambda: kmoe.gmm_plain(dy, w, plan.block_expert, plan.block_rows, plan.block_valid, True),
                    None if library is None else (lambda: library(dys, w.transpose(1, 2), offs=offs)),
                    io + banks * k_dim * n_dim * es, flops, path=kmoe.gmm_path(dy, w, True),
                )
            if "tgmm" in forms:  # dW of the same rows [E, K, N]: the bank's dtype (the
                # backward's form, first), then fp32 (`_tgmm_call`'s own output)
                dy_w = (dy.float() / float(group.max()) ** 0.5).to(dtype)
                dys_w = dy_w[real]
                got = kmoe.tgmm(xp, dy_w, plan, experts)
                want = kmoe.tgmm_plain(xp, dy_w, plan.block_expert, plan.block_rows, experts, plan.block_valid)
                # fp32 products of bf16 inputs are exact: both dtypes differ only by sum order
                diff = (got - want).abs()
                empty = torch.as_tensor(group == 0, device="cuda")
                bound = 1e-5 * want.abs() + 8 * 2**-24 * float(group.max()) ** 0.5 * want.square().mean().sqrt()
                ok = bool((diff <= bound).all()) and not got[empty].any()
                out_forms = [(torch.float32, diff.max().item(), ok)]
                if not fp32:
                    got_w = kmoe.tgmm(xp, dy_w, plan, experts, out_dtype=dtype)
                    # one rounding of the same fp32 sum: bit-identical to the cast fp32 output
                    same = torch.equal(got_w, got.to(dtype))
                    err = (got_w.float() - want).abs().max().item()
                    out_forms.insert(0, (dtype, err, ok and same))
                    del got_w
                for out_dtype, err, case_ok in out_forms:
                    out_name = "bf16 out" if out_dtype == torch.bfloat16 else "fp32 out"
                    _record(
                        cases, "grouped_gemm_tgmm", f"dW, {out_name}, " + shape, dtype, err, case_ok,
                        "1e-5 rel + 8 * 2^-24 * sqrt(rows) * rms(output) of the fp32 sum; empty experts"
                        " exactly 0; bf16 out bit-identical to the fp32 output rounded to bf16",
                        lambda: kmoe.tgmm(xp, dy_w, plan, experts, out_dtype=out_dtype),
                        lambda: kmoe.tgmm_plain(
                            xp, dy_w, plan.block_expert, plan.block_rows, experts, plan.block_valid, out_dtype
                        ),
                        None if library is None else (lambda: library(xs.t(), dys_w, offs=offs)),
                        rows * (k_dim + n_dim) * es + experts * k_dim * n_dim * out_dtype.itemsize, flops,
                        path=kmoe.tgmm_path(xp, dy_w),
                    )
                del got, want, dy_w, dys_w
            del xp, dy, w, xs, dys
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return cases


def _packed_text(rs, rows, seq, vocab, eos):
    """[rows, seq + 1] tokens: documents of 200-2000 tokens, each closed by EOS."""
    import numpy as np

    text = np.empty((rows, seq + 1), np.int64)
    for row in text:
        filled = 0
        while filled < seq + 1:
            doc = rs.randint(1, vocab, rs.randint(200, 2001))
            doc[-1] = eos
            take = min(len(doc), seq + 1 - filled)
            row[filled : filled + take] = doc[:take]
            filled += take
    return text


def plain_train_loss(model, inputs, compute_dtype, router_logits=None):
    """The training loss of `model` with every kernel's plain version called explicitly
    and the plain (unfused) LM-head loss, in `compute_dtype`, plus an MoE model's
    auxiliary loss: the reference of the kernel path's loss and gradients. An MoE block
    appends its router logits to `router_logits`."""
    import torch.nn.functional as F

    from dolomite_engine_tpu_torch.ops.loss import causal_lm_loss

    config, t = model.config, model.transformer
    ids, seg = inputs["input_ids"], inputs["segment_ids"]
    routing = [] if router_logits is None else router_logits
    h = F.embedding(ids, t.wte.weight).to(compute_dtype)
    h = _plain_layers(model, h, inputs["position_ids"], compute_dtype, seg, routing)
    logits = h @ t.wte.weight.to(compute_dtype).T
    loss = causal_lm_loss(
        logits, ids, upcast=config.upcast_logits_for_loss, labels=inputs["labels"],
        z_loss_coef=config.z_loss_coef,
    )
    aux = model.compute_aux_loss(routing, None, seg)  # the port's plain load-balancing loss
    return loss if aux is None else loss + aux


def training_paths_check(seed, n_layer=2, config_kwargs=TRAIN_CONFIG, shape=(1, TRAIN_SEQ)):
    """Phase 5 (granite-3b-code) and phase 8 (the MoE model): the kernel path against the
    plain path at full width, `n_layer` layers, the same fp32 master weights and packed
    batch of `shape`, bf16 compute; and both against an fp32 plain reference of the same
    weights. For MoE, the reference also judges each parameter's gradient and each
    expert's slice of a bank on its own, and the check reports the share of (token,
    layer) routings the kernel path and the plain bf16 path pick differently."""
    import numpy as np
    import torch

    from dolomite_engine_tpu_torch.model_wrapper import ModelWrapperForPretraining
    from dolomite_engine_tpu_torch.ops.moe import route

    config = dict(config_kwargs, n_layer=n_layer)
    moe = config.get("model_type") == "moe_dolomite"
    torch.cuda.reset_peak_memory_stats()
    wrapper = ModelWrapperForPretraining(
        config, dtype="bf16", param_dtype="fp32", attention_implementation="flash_attention_2",
        gradient_checkpointing_args=TRAIN_REMAT, reset_attention_mask=True, reset_position_ids=True,
        device="cuda", seed=seed,
    )
    model = wrapper.model
    rs = np.random.RandomState(seed + 1)
    text = torch.as_tensor(
        _packed_text(rs, shape[0], shape[1], config["vocab_size"], config["eos_token_id"]), device=model.device
    )
    inputs = wrapper.prepare_inputs_and_labels(text)
    names, params = zip(*model.named_parameters())

    def grads(loss):
        return [g.float() for g in torch.autograd.grad(loss, params)]

    # the kernel path's router logits, from the forward (the remat rerun fires the hooks again)
    kernel_routing = []
    hooks = [
        block.moe.register_forward_hook(lambda module, args, out: kernel_routing.append(out[1].detach()))
        for block in model.transformer.h
        if moe
    ]
    kernel_loss = wrapper.loss(text)
    kernel_routing = kernel_routing[:n_layer]
    kernel_grads = grads(kernel_loss)
    for hook in hooks:
        hook.remove()
    plain_routing = []
    plain_loss = plain_train_loss(model, inputs, torch.bfloat16, plain_routing)
    plain_grads = grads(plain_loss)
    exact_loss = plain_train_loss(model, inputs, torch.float32)
    exact_grads = grads(exact_loss)

    def rel(a, b):
        return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()

    def total_rel(gs):
        num = sum(((g - e) ** 2).sum() for g, e in zip(gs, exact_grads))
        return (num / sum((e**2).sum() for e in exact_grads)).sqrt().item()

    per_param = {n: rel(g, p) for n, g, p in zip(names, kernel_grads, plain_grads)}
    worst = max(per_param, key=per_param.get)
    # for MoE, each parameter's gradient and each expert's slice of a bank against the fp32
    # reference on both paths: the pooled norm is dominated by the largest leaves and would
    # not see one wrong leaf or expert
    vs_fp32 = {}
    if moe:
        for n, g, p, e in zip(names, kernel_grads, plain_grads, exact_grads):
            experts = range(e.shape[0]) if e.ndim == 3 else ()
            for part, index in [(n, slice(None))] + [(f"{n}[{x}]", x) for x in experts]:
                vs_fp32[part] = {"kernel": rel(g[index], e[index]), "plain_bf16": rel(p[index], e[index])}
    check = {
        "n_layer": n_layer, "batch": shape[0], "seq": shape[1],
        "documents": int(inputs["segment_ids"].max(-1).values.sum()),
        "kernel_loss": kernel_loss.item(), "plain_bf16_loss": plain_loss.item(), "fp32_loss": exact_loss.item(),
        "max_param_grad_rel_l2_err": per_param[worst], "worst_param": worst,
        "kernel_grad_rel_l2_err_vs_fp32": total_rel(kernel_grads),
        "plain_bf16_grad_rel_l2_err_vs_fp32": total_rel(plain_grads),
        "tolerance": (
            "loss within 2e-2 abs of the plain bf16 path; "
            + ("" if moe else "each parameter's gradient within 3e-2 relative L2 error; ")
            + "against the fp32 plain reference the kernel path's gradients err at most "
            "1.5x the plain bf16 path's"
            + (", pooled, for each parameter and for each expert of a bank" if moe else "")
        ),
    }
    if moe:
        top_k = config["num_experts_per_tok"]
        differ = [
            (route(a, top_k)[1].sort(-1).values != route(b, top_k)[1].sort(-1).values).any(-1).float().mean().item()
            for a, b in zip(kernel_routing, plain_routing)
        ]
        check["routing_differs_share_by_layer"] = differ
        check["param_grad_rel_l2_err"] = per_param
        check["param_grad_rel_l2_err_vs_fp32"] = {n: e for n, e in vs_fp32.items() if "[" not in n}
        check["max_grad_err_ratio_vs_fp32"] = max(e["kernel"] / max(e["plain_bf16"], 1e-30) for e in vs_fp32.values())
        check["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    assert all(np.isfinite(v) for v in (check["kernel_loss"], check["plain_bf16_loss"])), check
    assert abs(check["kernel_loss"] - check["plain_bf16_loss"]) <= 2e-2, check
    if not moe:
        # an MoE token whose bf16 router logits cross picks other experts on the two paths,
        # which moves whole rows of an expert's gradient: the ratios below judge MoE
        assert check["max_param_grad_rel_l2_err"] <= 3e-2, check
    off = {n: e for n, e in vs_fp32.items() if e["kernel"] > 1.5 * e["plain_bf16"]}
    assert not off, f"gradients off against the fp32 reference: {off}; {check}"
    assert check["kernel_grad_rel_l2_err_vs_fp32"] <= 1.5 * check["plain_bf16_grad_rel_l2_err_vs_fp32"], check
    del wrapper, model, params, kernel_grads, plain_grads, exact_grads, kernel_routing, plain_routing
    torch.cuda.empty_cache()
    return check


def train_slice(seed, config_kwargs=TRAIN_CONFIG, device="cuda", seq=TRAIN_SEQ, micro_batch=1):
    """Phase 6: the dense GPTDolomite train step on granite-3b-code, phase 8: the MoE
    train step, and phase 11: the alibi train step on MPT-7B (another config and the CPU
    only to rehearse this script's control flow at a tiny size). Each step takes
    accumulation 2 x [micro_batch, seq]."""
    import numpy as np
    import torch

    from dolomite_engine_tpu_torch.model_wrapper import ModelWrapperForPretraining
    from dolomite_engine_tpu_torch.ops.kernels import KERNELS, reset_launch_counts
    from dolomite_engine_tpu_torch.optimization import get_optimizer, get_scheduler
    from dolomite_engine_tpu_torch.train_utils import TrainState, get_model_tflops, make_train_step

    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    wrapper = ModelWrapperForPretraining(
        config_kwargs, dtype="bf16", param_dtype="fp32", attention_implementation="flash_attention_2",
        gradient_checkpointing_args=TRAIN_REMAT, reset_attention_mask=True, reset_position_ids=True,
        device=device, seed=seed,
    )
    config = wrapper.config
    schedule = get_scheduler(2, 0, None, 10, "cosine", 0.1, base_lr=TRAIN_LR)
    optimizer = get_optimizer("TorchAdamW", TRAIN_OPTIMIZER, schedule, wrapper.model.named_parameters())
    state = TrainState(wrapper.model, optimizer)
    train_step = make_train_step(
        lambda micro: wrapper.loss(micro["text"]), optimizer, gradient_accumulation_steps=TRAIN_ACCUM,
        gradient_clipping=1.0, skip_nonfinite=True,
    )
    rs = np.random.RandomState(seed + 2)
    text = _packed_text(rs, TRAIN_ACCUM * micro_batch, seq, config.vocab_size, config.eos_token_id)
    batch = {"text": torch.as_tensor(text, device=wrapper.model.device).reshape(TRAIN_ACCUM, micro_batch, seq + 1)}
    _sync(wrapper.model.device)
    build_s = time.perf_counter() - t0

    reset_launch_counts()
    metrics, times = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        metrics.append(train_step(state, batch))
        _sync(wrapper.model.device)
        times.append(time.perf_counter() - t0)
    launches = {k.name: k.launches for k in KERNELS}

    losses = [m["loss"] for m in metrics]
    assert all(np.isfinite(losses)) and not any(m["skipped"] for m in metrics), metrics
    assert losses[4] < losses[1], f"the loss did not fall over the repeated batch: {losses}"
    layers, micro_batches = config.n_layer, TRAIN_ACCUM * TRAIN_STEPS
    # per micro-batch, every block rerun in the backward (checkpoint_every 1): rmsnorm
    # 2L + 1 forward + 2L recompute (its backward is plain PyTorch; layernorm is plain
    # PyTorch); rope L forward + L recompute + L backward (none with alibi); flash forward
    # L + L recompute, backward L, in the additive-bias form with alibi; fused_ce one per
    # 256-token loss chunk (its backward recomputes through cuBLAS); an MoE layer's grouped
    # GEMMs c_fc and c_proj run in the forward, again in the rerun, and once more each as
    # dX in the backward (6 gmm), and its 2 dW are tgmm
    moe = config.model_type == "moe_dolomite"
    rms = config.normalization_function == "rmsnorm"
    rope = config.position_embedding_type == "rope"
    alibi = config.position_embedding_type == "alibi"
    expected = {
        "rmsnorm": (4 * layers + 1) * micro_batches if rms else 0,
        "rope_qkv": 3 * layers * micro_batches if rope else 0,
        "paged_decode_attention": 0,
        "paged_prefill_attention": 0,
        "flash_attn_fwd": 0 if alibi else 2 * layers * micro_batches,
        "flash_attn_bwd": 0 if alibi else layers * micro_batches,
        "fused_ce": -(-seq // config.loss_chunk_size) * micro_batches,
        "grouped_gemm": 6 * layers * micro_batches if moe else 0,
        "grouped_gemm_tgmm": 2 * layers * micro_batches if moe else 0,
        "kv_quant": 0,
        "flash_attn_bias_fwd": 2 * layers * micro_batches if alibi else 0,
        "flash_attn_bias_bwd": layers * micro_batches if alibi else 0,
    }
    if on_card:  # on the CPU (a rehearsal) the plain versions run
        assert launches == expected, (launches, expected)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
    if on_card:
        assert peak_gb < 70, f"peak device memory {peak_gb:.1f} GB"
    step_s = sum(times[1:]) / len(times[1:])  # the first step is the warm-up
    tflops = get_model_tflops(config, TRAIN_ACCUM * micro_batch, seq, None, TRAIN_REMAT)
    training = {
        "model": {
            "model_type": config.model_type, "n_layer": config.n_layer, "n_embd": config.n_embd,
            "n_head": config.n_head, "num_key_value_heads": config.num_key_value_heads,
            "position_embedding_type": config.position_embedding_type,
            "vocab_size": config.vocab_size, "params": sum(p.numel() for p in wrapper.model.parameters()),
            "param_dtype": "float32", "compute_dtype": "bfloat16", "weights": "random",
            **({"num_experts": config.num_experts, "top_k": config.num_experts_per_tok} if moe else {}),
        },
        "seed": seed, "micro_batch": micro_batch, "accumulation": TRAIN_ACCUM, "seq": seq,
        "documents_per_row": [int((row[:-1] == config.eos_token_id).sum()) + 1 for row in text],
        "steps": TRAIN_STEPS, "losses": losses, "grad_norms": [m["grad_norm"] for m in metrics],
        "step_s": times, "mean_step_s_after_warmup": step_s,
        "tokens_per_s": TRAIN_ACCUM * micro_batch * seq / step_s,
        "model_tflops_per_step": tflops, "mfu": tflops / step_s / (PEAK_FLOPS["bfloat16"] / 1e12),
        "peak_memory_gb": peak_gb, "model_init_s": build_s, "launches": launches,
    }
    return training, launches, (state, train_step, batch)


def profile_training(state, train_step, batch):
    """Phase 6, profiled: one more train step with kernel activity only (device time by
    kernel, the device's busy share), then one with host activity too (host time by
    PyTorch op; the rest of the step's host time is Python)."""
    from torch.autograd import DeviceType

    profile = _device_time(*_profiled(lambda: train_step(state, batch)), top=20)
    events, host_wall_s = _profiled(lambda: train_step(state, batch), host=True)
    host_ops = [
        (e.key, e.count, e.self_cpu_time_total / 1e3)
        for e in events
        if e.device_type == DeviceType.CPU and e.self_cpu_time_total > 0
    ]
    return dict(
        profile,
        host_profiled_wall_s=host_wall_s,
        host_op_self_s=sum(ms for _, _, ms in host_ops) / 1e3,
        top_host_ops=[
            {"name": name[:64], "calls": count, "ms": ms}
            for name, count, ms in sorted(host_ops, key=lambda k: -k[2])[:15]
        ],
    )


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from dolomite_engine_tpu_torch.ops.kernels import KERNELS
    from dolomite_engine_tpu_torch.ops.kernels._build import load_library

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)

    t0 = time.perf_counter()
    load_library()
    print(json.dumps({"phase": "build", "seconds": time.perf_counter() - t0}), flush=True)

    cases = (
        kernel_cases(args.seed) + quant_kernel_cases(args.seed) + training_kernel_cases(args.seed)
        + moe_kernel_cases(args.seed) + alibi_kernel_cases(args.seed)
    )
    print(json.dumps({"kernel_cases": cases, "card": card}), flush=True)

    serving, serving_launches, model, specs, tokens = serve(args.seed)
    print(json.dumps({"serving": serving, "card": card}), flush=True)
    print(json.dumps({"profile": profile_serving(model, specs), "card": card}), flush=True)

    # phase 9: the quantized pool on phase 3's model and requests; launches summed over its runs
    quantized, quantized_launches = {}, {spec.name: 0 for spec in KERNELS}

    def serve_quantized(name, kv_dtype, bf16_tokens, bf16_serving):
        record, launches, model_, _, got = serve(args.seed, kv_dtype=kv_dtype, model=model)
        for kernel, n in launches.items():
            quantized_launches[kernel] += n
        pairs = [(a, b) for want, have in zip(bf16_tokens, got) for a, b in zip(want, have)]
        record["greedy_token_agreement_with_bf16_pool"] = sum(a == b for a, b in pairs) / len(pairs)
        record["requests_identical_to_bf16_pool"] = sum(want == have for want, have in zip(bf16_tokens, got))
        record["bf16_pool"] = {
            key: bf16_serving[key] for key in ("ttft_mean_s", "prefill_tok_s", "decode_tok_s", "peak_memory_gb")
        }
        record["bf16_pool"]["kv_bytes_per_token"] = bf16_kv_bytes(model_.config)
        # the pools' own bytes (1025 pages): the peaks differ in scope, as the bf16 phase's
        # also covers its logits check
        pool_tokens = (1 + NUM_SLOTS * (MAX_LEN // PAGE)) * PAGE
        record["pool_gb"] = record["kv_bytes_per_token"] * pool_tokens / 1e9
        record["bf16_pool"]["pool_gb"] = bf16_kv_bytes(model_.config) * pool_tokens / 1e9
        record["launches_per_forward"] = launches_per_forward(model_, kv_dtype)
        record["bf16_pool"]["launches_per_forward"] = launches_per_forward(model_)
        quantized[name] = record

    for kv_dtype in ("int8", "fp8"):
        serve_quantized(f"granite-3b-code {kv_dtype}", kv_dtype, tokens, serving)
    probe = specs[2]["prompt_ids"]
    check = quantized_check(model, probe + tokens[2][:4], len(probe))
    print(json.dumps({"quantized_check": check, "card": card}), flush=True)
    del model
    torch.cuda.empty_cache()

    print(json.dumps({"training_check": training_paths_check(args.seed), "card": card}), flush=True)
    training, training_launches, (state, train_step, batch) = train_slice(args.seed)
    print(json.dumps({"training": training, "card": card}), flush=True)
    print(json.dumps({"training_profile": profile_training(state, train_step, batch), "card": card}), flush=True)
    del state, train_step, batch
    gc.collect()
    torch.cuda.empty_cache()

    moe_serving, moe_serving_launches, model, specs, tokens = serve(args.seed, MOE_EP)
    print(json.dumps({"moe_serving": moe_serving, "card": card}), flush=True)
    print(json.dumps({"moe_profile": profile_serving(model, specs), "card": card}), flush=True)
    serve_quantized("moe int8", "int8", tokens, moe_serving)
    print(json.dumps({"quantized_serving": quantized, "card": card}), flush=True)
    del model
    gc.collect()
    torch.cuda.empty_cache()

    moe_check = training_paths_check(args.seed, 2, MOE_EP, (1, MOE_TRAIN_SEQ))
    print(json.dumps({"moe_training_check": moe_check, "card": card}), flush=True)
    moe_training, moe_training_launches, (state, train_step, batch) = train_slice(
        args.seed, dict(MOE_EP, n_layer=MOE_TRAIN_LAYERS), seq=MOE_TRAIN_SEQ, micro_batch=MOE_TRAIN_MICRO
    )
    print(json.dumps({"moe_training": moe_training, "card": card}), flush=True)
    moe_profile = profile_training(state, train_step, batch)
    # the grouped GEMMs' and the casts' shares of the step's device time
    moe_profile["shares"] = {
        family: moe_profile["families"].get(family, {}).get("share", 0.0)
        for family in ("grouped_gemm", "grouped_gemm_tgmm", "casts_and_copies")
    }
    print(json.dumps({"moe_training_profile": moe_profile, "card": card}), flush=True)
    del state, train_step, batch
    gc.collect()
    torch.cuda.empty_cache()

    alibi_check = training_paths_check(args.seed, 2, ALIBI_TRAIN_CONFIG, (ALIBI_TRAIN_MICRO, ALIBI_TRAIN_SEQ))
    print(json.dumps({"alibi_training_check": alibi_check, "card": card}), flush=True)
    alibi_training, alibi_training_launches, (state, train_step, batch) = train_slice(
        args.seed, dict(ALIBI_TRAIN_CONFIG, n_layer=ALIBI_TRAIN_LAYERS), seq=ALIBI_TRAIN_SEQ,
        micro_batch=ALIBI_TRAIN_MICRO,
    )
    print(json.dumps({"alibi_training": alibi_training, "card": card}), flush=True)
    alibi_profile = profile_training(state, train_step, batch)
    print(json.dumps({"alibi_training_profile": alibi_profile, "card": card}), flush=True)
    del state, train_step, batch

    kernels = []
    for spec in KERNELS:
        # the case type the main path runs: bf16, or kv_quant's int8 codes
        main_dtype = "int8" if spec.name == "kv_quant" else "bfloat16"
        bf16 = [c for c in cases if c["kernel"] == spec.name and c["dtype"] == main_dtype]
        main_case = bf16[0]
        by_path = {
            "serving": serving_launches[spec.name], "training": training_launches[spec.name],
            "moe_serving": moe_serving_launches[spec.name], "moe_training": moe_training_launches[spec.name],
            "quantized_serving": quantized_launches[spec.name], "alibi_training": alibi_training_launches[spec.name],
        }
        launches = sum(by_path.values())
        assert launches > 0, f"{spec.name} was never launched on the main path"
        kernels.append({
            "name": spec.name, "route": "cuda", "source": spec.source, "replaces": spec.replaces,
            "launches": launches, "launches_by_path": by_path,
            "max_abs_err": max(c["max_abs_err"] for c in bf16),
            "ms": main_case["kernel_ms"], "kernel_ms": main_case["kernel_ms"], "device_ms": main_case["device_ms"],
            "plain_ms": main_case["plain_ms"], "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"], "library_ms": main_case["library_ms"],
            "shape": main_case["shape"], "tolerance": main_case["tolerance"],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
