"""The port's CUDA kernels against their plain PyTorch versions, on the GPU.

CUDA kernels have no interpret mode, so these tests run only where a CUDA device is
present and skip elsewhere. This file imports no JAX, so it also runs on a GPU machine
without JAX:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda_kernels.py

Shapes cover small odd cases and the serving slice's own shapes (granite-3b-code: 32
heads of 80, d=2560, 16-token pages). Tolerances: fp32 within 1e-5 (the JAX package's
own kernel-parity tolerance; only summation order differs); bf16 attention within 2e-2
absolute (the plain version rounds scores and probabilities to bf16, the kernels keep
fp32 scores); bf16 rmsnorm and rope within 2 bf16 ulp of the largest term (the plain
version rounds after every bf16 op, the kernel rounds once).
"""

import numpy as np
import pytest
import torch

from dolomite_engine_tpu_torch.ops.kernels import (
    paged_attention,
    prefill_attention,
    rmsnorm,
    rope_qkv,
)

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    _, exponent = torch.frexp(x.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny))
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), exponent - 8)


def _rand(generator, shape, dtype, scale=1.0):
    return (torch.randn(shape, generator=generator, device="cuda") * scale).to(dtype)


@pytest.mark.parametrize("rows,dim", [(21, 32), (8 * 512, 2560)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_residual", [False, True])
def test_rmsnorm_kernel_matches_plain(rows, dim, dtype, with_residual):
    g = torch.Generator(device="cuda").manual_seed(0)
    x = _rand(g, (rows, dim), dtype)
    r = _rand(g, (rows, dim), dtype) if with_residual else None
    w = _rand(g, (dim,), torch.float32, 0.1) + 1.0
    got = rmsnorm.fused_rmsnorm(x, w, 1e-5, residual=r)
    want = rmsnorm.fused_rmsnorm_plain(x, w, 1e-5, residual=r)
    torch.cuda.synchronize()
    if with_residual:
        torch.testing.assert_close(got[1], want[1], atol=0, rtol=0)  # the add is one rounding
        got, want = got[0], want[0]
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    else:
        assert bool(((got.float() - want.float()).abs() <= 2 * _bf16_ulp(want)).all())


@pytest.mark.parametrize(
    "batch,seq,hq,hkv,head_dim", [(2, 9, 4, 2, 16), (1, 512, 32, 32, 80), (8, 1, 32, 32, 80)]
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rope_qkv_kernel_matches_plain(batch, seq, hq, hkv, head_dim, dtype):
    g = torch.Generator(device="cuda").manual_seed(1)
    qkv = _rand(g, (batch, seq, (hq + 2 * hkv) * head_dim), dtype)
    angles = torch.rand((batch, seq, head_dim), generator=g, device="cuda") * 6.0
    cos, sin = angles.cos(), angles.sin()
    got = rope_qkv.fused_rope_qkv(qkv, cos, sin, hq, hkv, head_dim)
    want = rope_qkv.fused_rope_qkv_plain(qkv, cos, sin, hq, hkv, head_dim)
    torch.cuda.synchronize()
    v_cols = (hq + hkv) * head_dim
    torch.testing.assert_close(got[..., v_cols:], qkv[..., v_cols:], atol=0, rtol=0)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    else:
        x = qkv.float().reshape(batch, seq, -1, head_dim)
        scale = (x.abs() + x.roll(head_dim // 2, -1).abs()).reshape(qkv.shape)
        assert bool(((got.float() - want.float()).abs() <= 2 * _bf16_ulp(scale)).all())


def _decode_case(seed, num_slots, width, hq, hkv, head_dim, page_size, max_pages, lengths, dtype):
    g = torch.Generator(device="cuda").manual_seed(seed)
    rs = np.random.RandomState(seed)
    num_pages = 1 + num_slots * max_pages
    q = _rand(g, (num_slots, width, hq, head_dim), dtype)
    k_pages = _rand(g, (num_pages, page_size, hkv, head_dim), dtype)
    v_pages = _rand(g, (num_pages, page_size, hkv, head_dim), dtype)
    table = np.zeros((num_slots, max_pages), np.int32)
    free = list(rs.permutation(np.arange(1, num_pages)))
    for slot, length in enumerate(lengths):
        if length > 0:  # length 0 is an idle slot: all-trash table row
            used = min(-(-(length + width) // page_size), max_pages)
            table[slot, :used] = [free.pop() for _ in range(used)]
    return (
        q, k_pages, v_pages,
        torch.as_tensor(table, device="cuda"),
        torch.as_tensor(np.asarray(lengths, np.int32), device="cuda"),
    )


@pytest.mark.parametrize(
    "num_slots,width,hq,hkv,head_dim,page_size,max_pages,lengths",
    [
        (4, 1, 8, 2, 16, 16, 4, [10, 0, 3 * 16 + 7, 3]),  # gqa, idle slot, mid-page frontier
        (4, 4, 8, 1, 16, 16, 4, [10, 0, 3 * 16 + 7, 3]),  # mqa, the W=4 verify window
        (8, 1, 32, 32, 80, 16, 128, [2047, 1, 300, 1024, 0, 1500, 17, 640]),  # the slice
        # head_dim 128, 32-token pages, a W=4 window over a 4096-token view: more than
        # 48 KB of shared memory per block
        (2, 4, 8, 2, 128, 32, 128, [4000, 7]),
    ],
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_kernel_matches_plain(
    num_slots, width, hq, hkv, head_dim, page_size, max_pages, lengths, dtype
):
    q, k, v, table, lens = _decode_case(
        3, num_slots, width, hq, hkv, head_dim, page_size, max_pages, lengths, dtype
    )
    scale = head_dim**-0.5
    got = paged_attention.paged_decode_attention(q, k, v, table, lens, scale)
    want = paged_attention.paged_decode_attention_plain(q, k, v, table, lens, scale)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()  # idle slots read the trash page, finite
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got, want, atol=tol, rtol=1e-5 if tol == 1e-5 else 0)


@pytest.mark.parametrize(
    "chunk,hq,hkv,head_dim,page_size,max_pages,starts",
    [
        (24, 8, 2, 16, 16, 4, [10, 0]),  # mid-page start, multi-block chunk, gqa
        (8, 4, 4, 16, 16, 4, [0]),
        (512, 32, 32, 80, 16, 128, [0]),  # the slice's first chunk
        (512, 32, 32, 80, 16, 128, [1024]),  # a later chunk over a resident prefix
        (40, 4, 1, 128, 32, 8, [33, 0]),  # head_dim 128 (> 48 KB of tiles), 32-token pages
    ],
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_prefill_kernel_matches_plain(
    chunk, hq, hkv, head_dim, page_size, max_pages, starts, dtype
):
    lengths = [s + chunk - 1 for s in starts]
    q, k, v, table, _ = _decode_case(
        4, len(starts), 1, hq, hkv, head_dim, page_size, max_pages, lengths, dtype
    )
    q = _rand(torch.Generator(device="cuda").manual_seed(5), (len(starts), chunk, hq, head_dim), dtype)
    start = torch.as_tensor(np.asarray(starts, np.int32), device="cuda")
    scale = head_dim**-0.5
    got = prefill_attention.paged_prefill_attention(q, k, v, table, start, scale)
    want = prefill_attention.paged_prefill_attention_plain(q, k, v, table, start, scale)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got, want, atol=tol, rtol=1e-5 if tol == 1e-5 else 0)


def test_wrappers_raise_on_what_the_kernels_do_not_take():
    q = torch.zeros((2, 1, 4, 16), device="cuda", dtype=torch.float16)
    pages = torch.zeros((3, 16, 4, 16), device="cuda", dtype=torch.float16)
    table = torch.zeros((2, 1), device="cuda", dtype=torch.int32)
    lengths = torch.zeros((2,), device="cuda", dtype=torch.int32)
    with pytest.raises(ValueError):
        paged_attention.paged_decode_attention(q, pages, pages, table, lengths, 0.25)
    x = torch.zeros((4, 64), device="cuda").t()  # strided view
    with pytest.raises(ValueError):
        rmsnorm.fused_rmsnorm(x, torch.ones(4, device="cuda"), 1e-5)
    huge = torch.zeros((1, 8, 4, 16), device="cuda")
    with pytest.raises(ValueError):  # a score row that cannot fit shared memory
        paged_attention.paged_decode_attention(
            huge, torch.zeros((2, 16, 4, 16), device="cuda"),
            torch.zeros((2, 16, 4, 16), device="cuda"),
            torch.zeros((1, 4096), device="cuda", dtype=torch.int32),
            torch.zeros((1,), device="cuda", dtype=torch.int32), 0.25,
        )
