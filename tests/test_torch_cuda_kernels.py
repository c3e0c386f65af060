"""The port's CUDA kernels against their plain PyTorch versions, on the GPU.

CUDA kernels have no interpret mode, so these tests run only where a CUDA device is
present and skip elsewhere. This file imports no JAX, so it also runs on a GPU machine
without JAX:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda_kernels.py

Shapes cover small odd cases and the slices' own shapes (granite-3b-code: 32 heads of
80, d=2560, 16-token pages, 4096-token packed training rows, a 49152-word vocabulary;
the MoE slice's grouped GEMMs: 32 experts, d 1024, swiglu c_fc banks 8192 wide; the
alibi slice's flash form: MPT-7B's 32 heads of 128 over [2, 2048] packed rows).
The paged K/V write (rope_qkv's paged form, kv_quant's fused scatter-quantize) is held to
the flat rope kernel followed by the plain scatter: one launch a call, pages 1.. and
scales byte-identical (page 0 is the trash page), the query bit-identical, also for the
speculative verify step's K+1 window over the previous window's rejected tail. The paged
decode kernel is also held at that window (W = 5, granite's MHA and GQA). The
generation paths' forms (`chip_smoke.PADDED_FLASH_FORMS`: padding masks as segment ids,
right- and left-padded; the flat rope kernel at a decode step with per-row positions) are
held to the same tolerances, every flash output row finite. The flash kernel's query-bias
form (T5's relative bias, shared over the batch or one a row, with its fp32 gradient) is
held as the bias form is, and its dBias within 1e-4 abs + 1e-4 rel (fp32 1e-5).
Tolerances: fp32 within 1e-5 (the JAX package's own kernel-parity tolerance; only
summation order differs; the non-causal flash form with a bias adds 16 fp32 ulps of the
largest bias relative to the largest value, the rounding of scores that size, and in
bf16 2^-8 of the largest value, as dK / dV sum hundreds of bf16-rounded probabilities); bf16 attention within 2e-2 absolute (the plain version rounds
scores and probabilities to bf16, the kernels keep fp32 scores), plus one bf16 ulp of the
value for the training flash kernels, whose plain version computes in fp32 and rounds
its outputs once (the two sides may round a value one ulp apart); bf16 rmsnorm and rope
within 2 bf16 ulp of the largest term (the plain version rounds after every bf16 op, the
kernel rounds once); bf16 fused_ce within 2e-2 absolute (the kernel and cuBLAS may round
a logit to bf16 one ulp apart), and bit-identical from launch to launch; bf16 grouped GEMMs within one bf16 ulp plus 1e-4 (both
sides sum in fp32 and round once), and tgmm, whose output is fp32, within 1e-5 in both
types (products of bf16 inputs are exact in fp32), its bf16 output bit-identical to its
fp32 output rounded to bf16 (one rounding of the same sum); their padding rows hold
nonzero values, which both versions must treat as zero, and each grouped-GEMM case waits
at most 120 s for its kernels. kv_quant's codes and scales must be
byte-identical to its plain version's, and the attention kernels over int8 / fp8 pages
agree with their plain versions as over unquantized pages (the plain version dequantizes
with the same fp32 product and rounding).
"""

import numpy as np
import pytest
import torch

from chip_smoke import PADDED_FLASH_FORMS, padding_segments, same_pages, tie_page
from dolomite_engine_tpu_torch.ops.kernels import (
    kv_quant,
    paged_attention,
    prefill_attention,
    rmsnorm,
    rope_qkv,
)
from dolomite_engine_tpu_torch.ops.kv_quant import (
    KV_QUANT_DTYPES,
    as_bytes,
    quantize_pages,
    quantize_pages_plain,
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


@pytest.mark.parametrize(
    "rows,dim",
    [
        (21, 32),  # one 16-byte access a row: lanes 4-31 idle (the tail)
        (8 * 512, 2560),  # granite's rows
        (1, 2560),
        (8, 2560),  # a decode step
        (8 * 512, 1024),  # the MoE slice's width
        (8, 1004),  # not a multiple of 8: 8-byte (bf16) / 16-byte (fp32) accesses, a partial last round
        (7, 601),  # odd: one-element accesses
    ],
)
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
        # the verify step at W = K+1 = 5: granite's MHA at head dim 80, 16 slots (the
        # second 4-row block of each head holds one real row), one idle; and under GQA
        (16, 5, 32, 32, 80, 16, 101, [1595, 300, 0, 1024, 17, 1, 640, 250, 1200, 64, 511, 512, 900, 33, 1500, 15]),
        (4, 5, 8, 2, 80, 16, 8, [10, 0, 3 * 16 + 11, 100]),
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


# The split decode kernel cuts a slot's keys into spans of 256 positions (SPAN) and
# merges the spans' partials; the prefill kernel walks 64-key tiles and masks the ones
# that cross a 64-query tile's frontier.
SPAN = 256


@pytest.mark.parametrize(
    "num_slots,width,hq,hkv,head_dim,max_pages,lengths",
    [
        # the last row's frontier exactly on a split boundary (256 keys: one split), one
        # past it (257: a second split of one key), and the same at 512 / 513
        (4, 1, 8, 2, 80, 64, [SPAN - 1, SPAN, 2 * SPAN - 1, 2 * SPAN]),
        # the W=4 window: row 0 sees 256 keys and row 3 259, so row 0 sees nothing of
        # the second split; a slot shorter than one split; an idle slot
        (4, 4, 8, 2, 80, 64, [SPAN - 4, SPAN - 3, 10, 0]),
        # the MoE model: 16 query heads over 8 kv heads of 64
        (8, 1, 16, 8, 64, 128, [2047, 1, 300, 1024, 0, 1500, 17, 640]),
    ],
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_split_boundaries_match_plain(
    num_slots, width, hq, hkv, head_dim, max_pages, lengths, dtype
):
    q, k, v, table, lens = _decode_case(
        13, num_slots, width, hq, hkv, head_dim, 16, max_pages, lengths, dtype
    )
    scale = head_dim**-0.5
    got = paged_attention.paged_decode_attention(q, k, v, table, lens, scale)
    again = paged_attention.paged_decode_attention(q, k, v, table, lens, scale)
    want = paged_attention.paged_decode_attention_plain(q, k, v, table, lens, scale)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    assert torch.equal(got, again)  # the merge order is fixed: bitwise reproducible
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got, want, atol=tol, rtol=1e-5 if tol == 1e-5 else 0)


@pytest.mark.parametrize(
    "chunk,hq,hkv,head_dim,page_size,max_pages,starts",
    [
        (24, 8, 2, 80, 16, 16, [50, 37]),  # a 24-token tail crossing a 64-key tile
        (40, 8, 2, 80, 16, 16, [30, 100]),
        (512, 32, 32, 80, 16, 128, [33]),  # granite: a start that is not a multiple of 64
        (512, 32, 32, 80, 16, 128, [1000]),
        (512, 16, 8, 64, 16, 128, [0]),  # the MoE model
        (512, 16, 8, 64, 16, 128, [1100]),
    ],
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_prefill_tile_crossings_match_plain(
    chunk, hq, hkv, head_dim, page_size, max_pages, starts, dtype
):
    lengths = [s + chunk - 1 for s in starts]
    q, k, v, table, _ = _decode_case(
        14, len(starts), 1, hq, hkv, head_dim, page_size, max_pages, lengths, dtype
    )
    q = _rand(torch.Generator(device="cuda").manual_seed(15), (len(starts), chunk, hq, head_dim), dtype)
    start = torch.as_tensor(np.asarray(starts, np.int32), device="cuda")
    scale = head_dim**-0.5
    got = prefill_attention.paged_prefill_attention(q, k, v, table, start, scale)
    want = prefill_attention.paged_prefill_attention_plain(q, k, v, table, start, scale)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got, want, atol=tol, rtol=1e-5 if tol == 1e-5 else 0)


@pytest.mark.parametrize("kernel", ["decode", "prefill"])
@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_moe_shape_over_quantized_pages_matches_plain(kernel, kv_dtype):
    """The MoE model's attention (16 query heads over 8 kv heads of 64), bf16 query over
    a quantized pool, at split and tile boundaries."""
    lengths = [SPAN - 1, SPAN, 2047, 0] if kernel == "decode" else [1100 + 511]
    q, _, _, table, lens = _decode_case(16, len(lengths), 1, 16, 8, 64, 16, 128, lengths, torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(17)
    k, v, ks, vs = _quantized_pool(g, 1 + len(lengths) * 128, 16, 8, 64, kv_dtype)
    scale = 64**-0.5
    if kernel == "decode":
        got = paged_attention.paged_decode_attention(q, k, v, table, lens, scale, ks, vs)
        want = paged_attention.paged_decode_attention_plain(q, k, v, table, lens, scale, ks, vs)
    else:
        q = _rand(g, (1, 512, 16, 64), torch.bfloat16)
        start = torch.tensor([1100], dtype=torch.int32, device="cuda")
        got = prefill_attention.paged_prefill_attention(q, k, v, table, start, scale, ks, vs)
        want = prefill_attention.paged_prefill_attention_plain(q, k, v, table, start, scale, ks, vs)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got, want, atol=2e-2, rtol=0)


@pytest.mark.parametrize(
    "num_pages,heads,head_dim",
    [(5, 2, 16), (16, 32, 80), (33, 32, 80), (16, 8, 64), (33, 8, 64)],  # odd, then the slices' windows
)
@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_kv_quant_kernel_is_byte_identical_to_plain(num_pages, heads, head_dim, kv_dtype):
    storage, qmax = KV_QUANT_DTYPES[kv_dtype]
    g = torch.Generator(device="cuda").manual_seed(num_pages)
    values = _rand(g, (num_pages, 16, heads, head_dim), torch.float32, 2.0)
    frontier = torch.randint(0, 17, (num_pages, 1), generator=g, device="cuda")
    valid = torch.arange(16, device="cuda")[None, :] < frontier
    values = torch.where(valid[:, :, None, None], values, values * 100.0)  # stale rows
    values[1] = 0.0  # amax 0: scale 1
    valid[1] = True
    values[2:3] = tie_page(heads, head_dim, qmax, g)  # every quotient a rounding tie
    valid[2] = True
    values[3, :, :, :4] = 1e-6  # fp8 subnormals, int8 zeros
    before = kv_quant.KERNEL.launches
    codes, scales = quantize_pages(values, valid, qmax, storage)
    assert kv_quant.KERNEL.launches == before + 1
    want_codes, want_scales = quantize_pages_plain(values, valid, qmax, storage)
    torch.cuda.synchronize()
    assert codes.dtype == storage and torch.equal(as_bytes(codes), as_bytes(want_codes))
    assert torch.equal(scales.view(torch.int32), want_scales.view(torch.int32))
    assert bool((scales[1] == 1.0).all()) and bool((scales[2] == 1.0).all())


def _quantized_pool(g, num_pages, page_size, hkv, head_dim, kv_dtype):
    """Codes and scales of unit-normal K and V pages: the scale of the unquantized cases'
    pages, whose scores the 2e-2 bf16 tolerance is stated for (the plain version rounds
    scores to bf16, so larger scores err more)."""
    storage, qmax = KV_QUANT_DTYPES[kv_dtype]
    valid = torch.ones((num_pages, page_size), dtype=torch.bool, device="cuda")
    pages = []
    for _ in range(2):  # K, V
        values = _rand(g, (num_pages, page_size, hkv, head_dim), torch.float32)
        pages.append(quantize_pages_plain(values, valid, qmax, storage))
    (k, ks), (v, vs) = pages
    return k, v, ks, vs


@pytest.mark.parametrize(
    "num_slots,width,hq,hkv,head_dim,max_pages,lengths",
    [
        (4, 1, 8, 2, 16, 4, [10, 0, 3 * 16 + 7, 3]),
        (4, 4, 8, 1, 16, 4, [10, 0, 3 * 16 + 7, 3]),  # the W=4 verify window
        (8, 1, 32, 32, 80, 128, [2047, 1, 300, 1024, 0, 1500, 17, 640]),  # granite-3b-code
        (8, 1, 16, 8, 64, 128, [2047, 1, 300, 1024, 0, 1500, 17, 640]),  # the MoE model
    ],
)
@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_kernel_over_quantized_pages_matches_plain(
    num_slots, width, hq, hkv, head_dim, max_pages, lengths, kv_dtype, dtype
):
    q, _, _, table, lens = _decode_case(6, num_slots, width, hq, hkv, head_dim, 16, max_pages, lengths, dtype)
    g = torch.Generator(device="cuda").manual_seed(7)
    k, v, ks, vs = _quantized_pool(g, 1 + num_slots * max_pages, 16, hkv, head_dim, kv_dtype)
    scale = head_dim**-0.5
    got = paged_attention.paged_decode_attention(q, k, v, table, lens, scale, ks, vs)
    want = paged_attention.paged_decode_attention_plain(q, k, v, table, lens, scale, ks, vs)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got, want, atol=tol, rtol=1e-5 if tol == 1e-5 else 0)


@pytest.mark.parametrize(
    "chunk,hq,hkv,head_dim,max_pages,starts",
    [
        (24, 8, 2, 16, 4, [10, 0]),
        (512, 32, 32, 80, 128, [1535]),  # granite-3b-code: frontier 2046
        (512, 16, 8, 64, 128, [1024]),  # the MoE model
    ],
)
@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_prefill_kernel_over_quantized_pages_matches_plain(
    chunk, hq, hkv, head_dim, max_pages, starts, kv_dtype, dtype
):
    lengths = [s + chunk - 1 for s in starts]
    _, _, _, table, _ = _decode_case(8, len(starts), 1, hq, hkv, head_dim, 16, max_pages, lengths, dtype)
    g = torch.Generator(device="cuda").manual_seed(9)
    k, v, ks, vs = _quantized_pool(g, 1 + len(starts) * max_pages, 16, hkv, head_dim, kv_dtype)
    q = _rand(g, (len(starts), chunk, hq, head_dim), dtype)
    start = torch.as_tensor(np.asarray(starts, np.int32), device="cuda")
    scale = head_dim**-0.5
    got = prefill_attention.paged_prefill_attention(q, k, v, table, start, scale, ks, vs)
    want = prefill_attention.paged_prefill_attention_plain(q, k, v, table, start, scale, ks, vs)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got, want, atol=tol, rtol=1e-5 if tol == 1e-5 else 0)


@pytest.mark.parametrize("kernel", ["decode", "prefill"])
def test_fp32_query_over_a_bf16_pool_matches_plain(kernel):
    q, k, v, table, lens = _decode_case(10, 2, 1, 8, 2, 80, 16, 16, [200, 37], torch.bfloat16)
    scale = 80**-0.5
    if kernel == "decode":
        q = q.float()
        got = paged_attention.paged_decode_attention(q, k, v, table, lens, scale)
        want = paged_attention.paged_decode_attention_plain(q, k, v, table, lens, scale)
    else:
        q = _rand(torch.Generator(device="cuda").manual_seed(11), (2, 40, 8, 80), torch.float32)
        got = prefill_attention.paged_prefill_attention(q, k, v, table, lens, scale)
        want = prefill_attention.paged_prefill_attention_plain(q, k, v, table, lens, scale)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_quantized_wrappers_raise_on_what_the_kernels_do_not_take():
    g = torch.Generator(device="cuda").manual_seed(12)
    q, _, _, table, lens = _decode_case(12, 2, 1, 4, 2, 16, 16, 2, [5, 9], torch.bfloat16)
    k, v, ks, vs = _quantized_pool(g, 5, 16, 2, 16, "int8")
    with pytest.raises(ValueError, match="scale pools"):  # codes without their scales
        paged_attention.paged_decode_attention(q, k, v, table, lens, 0.25)
    with pytest.raises(ValueError, match="pair"):
        prefill_attention.paged_prefill_attention(q, k, v, table, lens, 0.25, ks, None)
    with pytest.raises(ValueError):  # fp32 pages under a bf16 query
        paged_attention.paged_decode_attention(q, k.float(), v.float(), table, lens, 0.25)
    with pytest.raises(ValueError):  # kv_quant encodes fp32 pages only
        kv_quant.quantize_pages_kernel(k.float().to(torch.bfloat16), torch.ones(5, 16, dtype=torch.bool, device="cuda"), 127.0, torch.int8)


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
    wide = torch.zeros((2, 8192), device="cuda")  # an fp32 row past the kernel's registers
    with pytest.raises(ValueError, match="registers"):
        rmsnorm.fused_rmsnorm(wide, torch.ones(8192, device="cuda"), 1e-5)
    odd = torch.zeros((1, 8, 4, 32), device="cuda")  # head_dim 32: no kernel is built for it
    odd_pages = torch.zeros((2, 16, 4, 32), device="cuda")
    one_row = torch.zeros((1, 2), device="cuda", dtype=torch.int32)
    zero = torch.zeros((1,), device="cuda", dtype=torch.int32)
    with pytest.raises(ValueError, match="head_dim"):
        paged_attention.paged_decode_attention(odd, odd_pages, odd_pages, one_row, zero, 0.25)
    with pytest.raises(ValueError, match="head_dim"):
        prefill_attention.paged_prefill_attention(odd, odd_pages, odd_pages, one_row, zero, 0.25)
    q16 = torch.zeros((1, 8, 4, 16), device="cuda")
    pages16 = torch.zeros((2, 16, 4, 16), device="cuda")
    with pytest.raises(ValueError, match="shared memory"):  # a table row that cannot fit
        prefill_attention.paged_prefill_attention(
            q16, pages16, pages16, torch.zeros((1, 60000), device="cuda", dtype=torch.int32), zero, 0.25
        )


def _segment_ids(batch, seq, num_segments, seed, pad_tail=0):
    """[B, S] int32 ids of `num_segments` packed documents of random lengths per row,
    the last `pad_tail` tokens padding (segment 0)."""
    rs = np.random.RandomState(seed)
    rows = []
    for _ in range(batch):
        real = seq - pad_tail
        cuts = np.sort(rs.choice(np.arange(1, real), num_segments - 1, replace=False)) if num_segments > 1 else []
        ids = np.zeros(seq, np.int32)
        for boundary in cuts:
            ids[boundary:real] += 1
        ids[:real] += 1
        rows.append(ids)
    return torch.as_tensor(np.stack(rows), device="cuda")


def _close_bf16(got, want, atol=2e-2):
    """2e-2 absolute plus one bf16 ulp of the value: both sides round their fp32 results
    to bf16 on their own, so a value near a rounding boundary may land one ulp apart."""
    bound = atol + _bf16_ulp(want)
    return bool(((got.float() - want.float()).abs() <= bound).all())


@pytest.mark.parametrize(
    "batch,seq,hq,hkv,head_dim,num_segments,pad_tail",
    [
        (1, 128, 2, 2, 64, 1, 0),  # one causal document
        (2, 256, 4, 1, 80, 3, 0),  # mqa, three documents per row
        (1, 512, 8, 2, 128, 8, 40),  # gqa, eight documents and a padded tail
        (2, 1024, 8, 2, 128, 5, 0),  # the smoke's GQA case
        (1, 4096, 32, 32, 80, 6, 0),  # the training slice: granite-3b-code, packed documents
        (1, 64, 2, 2, 64, 1, 0),  # one 64-token tile: half of the first 128-row block
        (2, 192, 4, 2, 80, 3, 0),  # a half-full last 128-row block, head_dim 80
        (1, 192, 8, 2, 128, 2, 0),  # the same at head_dim 128, gqa 4
        (1, 128, 2, 1, 128, 100, 0),  # one-token documents, boundaries inside every tile
        (1, 256, 4, 4, 64, 2, 100),  # an all-pad tail: the last tile is padding only
        (2, 2048, 16, 8, 64, 5, 0),  # the MoE training slice's layer: gqa 2 at head_dim 64
    ],
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernels_match_plain(batch, seq, hq, hkv, head_dim, num_segments, pad_tail, dtype):
    from dolomite_engine_tpu_torch.ops.kernels import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(7)
    # q/k/v as token-strided views of one fused [B, S, (Hq + 2 Hkv) * D] projection, as
    # the model hands them over
    qkv = _rand(g, (batch, seq, (hq + 2 * hkv) * head_dim), dtype)
    q, k, v = qkv.split([hq * head_dim, hkv * head_dim, hkv * head_dim], dim=-1)
    q = q.reshape(batch, seq, hq, head_dim)
    k = k.reshape(batch, seq, hkv, head_dim)
    v = v.reshape(batch, seq, hkv, head_dim)
    seg = _segment_ids(batch, seq, num_segments, seed=seq + num_segments, pad_tail=pad_tail)
    scale = head_dim**-0.5
    out, lse = fa.flash_attention_fwd(q, k, v, seg, scale)
    want_out, want_lse = fa.flash_attention_fwd_plain(q, k, v, seg, scale)
    dout = _rand(g, out.shape, dtype)
    grads = fa.flash_attention_bwd(q, k, v, seg, out, lse, dout, scale)
    want_grads = fa.flash_attention_bwd_plain(q, k, v, seg, out, lse, dout, scale)
    torch.cuda.synchronize()
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-5)
    for name, got, want in zip(("out", "dq", "dk", "dv"), (out, *grads), (want_out, *want_grads)):
        assert torch.isfinite(got.float()).all(), name
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5, msg=name)
        else:
            assert _close_bf16(got, want), (name, (got.float() - want.float()).abs().max().item())


@pytest.mark.parametrize("head_dim,causal,with_bias", [(80, True, False), (128, False, True), (64, True, True)])
def test_flash_backward_is_bit_identical_run_to_run(head_dim, causal, with_bias):
    """No atomics: two backward passes over the same inputs give the same bits."""
    from dolomite_engine_tpu_torch.ops.alibi import get_alibi_bias
    from dolomite_engine_tpu_torch.ops.kernels import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(13)
    batch, seq, hq, hkv = 2, 1024, 8, 2
    q, k, v = (_rand(g, (batch, seq, h, head_dim), torch.bfloat16) for h in (hq, hkv, hkv))
    seg = _segment_ids(batch, seq, 4, seed=2)
    bias = get_alibi_bias(hq, None, batch, seq, device="cuda")[:, :, 0].contiguous() if with_bias else None
    out, lse = fa.flash_attention_fwd(q, k, v, seg, head_dim**-0.5, bias, causal)
    dout = _rand(g, out.shape, torch.bfloat16)
    first = fa.flash_attention_bwd(q, k, v, seg, out, lse, dout, head_dim**-0.5, bias, causal)
    again_out, again_lse = fa.flash_attention_fwd(q, k, v, seg, head_dim**-0.5, bias, causal)
    second = fa.flash_attention_bwd(q, k, v, seg, out, lse, dout, head_dim**-0.5, bias, causal)
    torch.cuda.synchronize()
    assert torch.equal(out, again_out) and torch.equal(lse, again_lse)
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


def test_flash_attention_autograd_matches_plain_autograd():
    """gradcheck-style: the autograd function's grads equal autograd through the plain
    forward in fp32."""
    from dolomite_engine_tpu_torch.ops.kernels import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(3)
    q = _rand(g, (2, 192, 4, 64), torch.float32).requires_grad_()
    k = _rand(g, (2, 192, 2, 64), torch.float32).requires_grad_()
    v = _rand(g, (2, 192, 2, 64), torch.float32).requires_grad_()
    seg = _segment_ids(2, 192, 4, seed=1)
    dout = _rand(g, (2, 192, 4, 64), torch.float32)
    fa.flash_attention(q, k, v, seg, 0.125).backward(dout)
    got = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    fa.flash_attention_fwd_plain(q, k, v, seg, 0.125)[0].backward(dout)
    for got_grad, t in zip(got, (q, k, v)):
        torch.testing.assert_close(got_grad, t.grad, atol=1e-5, rtol=1e-5)


# (batch, seq, q heads, kv heads, head_dim, documents, pad tail, causal, bias)
BIAS_FORMS = [
    (1, 128, 2, 2, 64, 1, 0, True, "alibi"),  # one causal document
    (2, 256, 4, 1, 80, 3, 0, False, None),  # mqa, non-causal, no bias
    (1, 512, 8, 2, 128, 8, 40, False, "alibi"),  # gqa, non-causal, eight documents and a padded tail
    (2, 512, 4, 4, 64, 0, 0, True, "left_padded"),  # the padded form: segments and bias from the mask
    (2, 2048, 32, 32, 128, 4, 0, True, "alibi"),  # the alibi slice: MPT-7B's layer, packed documents
    (2, 192, 4, 2, 80, 3, 0, True, "alibi"),  # a half-full last 128-row block, causal alibi
    (1, 192, 4, 1, 64, 2, 60, False, "alibi"),  # the same, non-causal, padded tail
]


@pytest.mark.parametrize("batch,seq,hq,hkv,head_dim,num_segments,pad_tail,causal,bias_kind", BIAS_FORMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bias_flash_attention_kernels_match_plain(
    batch, seq, hq, hkv, head_dim, num_segments, pad_tail, causal, bias_kind, dtype
):
    """The additive-bias / non-causal form, within the training flash cases' tolerance;
    with a non-causal bias also `chip_smoke.bias_slack` relative to the largest value
    (fp32: 16 ulps of the largest bias, where the scores that carry the probability sit;
    bf16: 2^-8, as a key's dK / dV sums hundreds of P values rounded to bf16)."""
    from chip_smoke import _close, bias_slack
    from dolomite_engine_tpu_torch.ops.alibi import get_alibi_bias
    from dolomite_engine_tpu_torch.ops.kernels import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(11)
    qkv = _rand(g, (batch, seq, (hq + 2 * hkv) * head_dim), dtype)
    q, k, v = qkv.split([hq * head_dim, hkv * head_dim, hkv * head_dim], dim=-1)
    q = q.reshape(batch, seq, hq, head_dim)
    k = k.reshape(batch, seq, hkv, head_dim)
    v = v.reshape(batch, seq, hkv, head_dim)
    if bias_kind == "left_padded":
        mask = torch.ones((batch, seq), dtype=torch.int32, device="cuda")
        mask[1, :77] = 0
        seg = mask
        bias = get_alibi_bias(hq, mask, batch, seq)[:, :, 0].contiguous()
    else:
        seg = _segment_ids(batch, seq, num_segments, seed=seq + num_segments, pad_tail=pad_tail)
        bias = get_alibi_bias(hq, None, batch, seq, device="cuda")[:, :, 0].contiguous() if bias_kind else None
    scale = head_dim**-0.5
    out, lse = fa.flash_attention_fwd(q, k, v, seg, scale, bias, causal)
    want_out, want_lse = fa.flash_attention_fwd_plain(q, k, v, seg, scale, bias, causal)
    dout = _rand(g, out.shape, dtype)
    grads = fa.flash_attention_bwd(q, k, v, seg, out, lse, dout, scale, bias, causal)
    want_grads = fa.flash_attention_bwd_plain(q, k, v, seg, out, lse, dout, scale, bias, causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-5)
    slack = bias_slack(bias, causal, dtype)
    for name, got, want in zip(("out", "dq", "dk", "dv"), (out, *grads), (want_out, *want_grads)):
        assert torch.isfinite(got.float()).all(), name
        within, err = _close(got, want, dtype == torch.float32, slack)
        assert within, (name, err, slack)


# the query-bias form (T5's relative bias): (batch, seq, q heads, kv heads, head_dim,
# documents, pad tail, causal, the bias's batch: 1 shared, else one a row)
QUERY_BIAS_FORMS = [
    (8, 512, 12, 12, 64, 1, 0, True, 1),  # flan-t5-base's decoder self-attention, a shared bias
    (2, 256, 4, 2, 64, 3, 0, True, 2),  # gqa, a per-row bias over packed documents
    (2, 192, 4, 1, 80, 2, 40, False, 1),  # mqa, non-causal, a half-full last 128-row block, padded tail
    (1, 384, 8, 4, 128, 1, 0, False, 1),  # gqa, head dim 128, non-causal
    (3, 128, 2, 2, 64, 2, 0, True, 1),  # a shared bias summed over an odd batch
]


@pytest.mark.parametrize("batch,seq,hq,hkv,head_dim,num_segments,pad_tail,causal,bias_batch", QUERY_BIAS_FORMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_query_bias_flash_kernels_match_plain(batch, seq, hq, hkv, head_dim, num_segments, pad_tail, causal, bias_batch, dtype):
    """The query-bias form against its plain version: out, dq, dk, dv within the training
    flash cases' tolerance; dBias (fp32 on both sides, from the same bf16 inputs) within
    1e-4 abs + 1e-4 rel, in fp32 2e-5 abs + 1e-5 rel (a row with one visible key has P = 1
    and dS = dP - delta, two fp32 sums of ~8 summed in other orders); the pairs the masks
    hide (in every batch row, for a shared bias) hold exact zeros. Two backward passes give
    the same bits (the batch sum runs in a fixed order), and a pass for a frozen bias (no
    dBias) the same dq, dk, dv bits."""
    from chip_smoke import _close
    from dolomite_engine_tpu_torch.ops.kernels import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(17)
    q, k, v = (_rand(g, (batch, seq, h, head_dim), dtype) for h in (hq, hkv, hkv))
    seg = _segment_ids(batch, seq, num_segments, seed=seq + hq, pad_tail=pad_tail)
    bias = torch.randn((bias_batch, hq, seq, seq), generator=g, device="cuda")
    scale = head_dim**-0.5
    out, lse = fa.flash_attention_fwd(q, k, v, seg, scale, bias, causal)
    want_out, want_lse = fa.flash_attention_fwd_plain(q, k, v, seg, scale, bias, causal)
    dout = _rand(g, out.shape, dtype)
    grads = fa.flash_attention_bwd(q, k, v, seg, out, lse, dout, scale, bias, causal)
    again = fa.flash_attention_bwd(q, k, v, seg, out, lse, dout, scale, bias, causal)
    frozen = fa.flash_attention_bwd(q, k, v, seg, out, lse, dout, scale, bias, causal, bias_grad=False)
    want_grads = fa.flash_attention_bwd_plain(q, k, v, seg, out, lse, dout, scale, bias, causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-5)
    for name, got, want in zip(("out", "dq", "dk", "dv"), (out, *grads[:3]), (want_out, *want_grads[:3])):
        assert torch.isfinite(got.float()).all(), name
        within, err = _close(got, want, dtype == torch.float32)
        assert within, (name, err)
    dbias, want_dbias = grads[3], want_grads[3]
    assert dbias.shape == bias.shape and dbias.dtype == torch.float32
    atol, rtol = (2e-5, 1e-5) if dtype == torch.float32 else (1e-4, 1e-4)
    assert bool(((dbias - want_dbias).abs() <= atol + rtol * want_dbias.abs()).all()), (dbias - want_dbias).abs().max().item()
    visible = seg[:, None, :, None] == seg[:, None, None, :]  # [B, 1, S, S]
    if causal:
        visible = visible & torch.ones((seq, seq), dtype=torch.bool, device="cuda").tril()
    if bias_batch == 1:
        visible = visible.any(0, keepdim=True)
    hidden = ~visible.expand(dbias.shape)
    assert bool((dbias[hidden] == 0).all()) and bool((want_dbias[hidden] == 0).all())
    for a, b in zip(grads, again):
        assert torch.equal(a, b)
    assert len(frozen) == 3 and all(torch.equal(a, b) for a, b in zip(frozen, grads[:3]))


def test_query_bias_gradient_reaches_the_relative_bias_table():
    """A T5 decoder's bias table gets its gradient through the flash kernel (the bias form's
    backward) as through the plain version, within the bf16 flash tolerance of the
    table's largest gradient."""
    from dolomite_engine_tpu_torch.ops.kernels import flash_attention as fa
    from dolomite_engine_tpu_torch.ops.relative_bias import RelativePositionBias

    g = torch.Generator(device="cuda").manual_seed(19)
    q, k, v = (_rand(g, (2, 256, 4, 64), torch.bfloat16) for _ in range(3))
    grads = []
    for device in ("cuda", "cpu"):
        table = RelativePositionBias(4, 32, 128, bidirectional=False, std=1.0, device="cuda")
        with torch.no_grad():
            table.reset_parameters(torch.Generator(device="cuda").manual_seed(3))
        table = table.to(device)
        inputs = [t.to(device) for t in (q, k, v)]
        fa.flash_attention(*inputs, None, 0.125, table(256, 256)).float().square().sum().backward()
        grads.append(table.weight.grad.cpu())
    err = (grads[0] - grads[1]).abs().max().item()
    assert err <= 2e-2 * grads[1].abs().max().item(), err


@pytest.mark.parametrize("form", range(len(PADDED_FLASH_FORMS)), ids=[f[0].split(",")[0] + f" {f[3]} {len(f[1])}x{f[2]}" for f in PADDED_FLASH_FORMS])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_forward_over_padding_masks_matches_plain(form, dtype):
    """The generation paths' padding masks as segment ids: falling (the dense engine's
    right-padded prefill), rising (`generate_tokens`' left-padded rows), a pad boundary
    inside a 64-token tile, a bucket of one real token, and the alibi bias form; every
    row (pad queries attend among the pads) finite."""
    from chip_smoke import _close
    from dolomite_engine_tpu_torch.ops.alibi import get_alibi_bias
    from dolomite_engine_tpu_torch.ops.kernels import flash_attention as fa

    _, lengths, seq, side, alibi = PADDED_FLASH_FORMS[form]
    heads, head_dim = (32, 128) if alibi else (32, 80)
    batch = len(lengths)
    g = torch.Generator(device="cuda").manual_seed(13)
    q, k, v = (_rand(g, (batch, seq, heads, head_dim), dtype) for _ in range(3))
    seg = padding_segments(lengths, seq, side)
    bias = get_alibi_bias(heads, seg, batch, seq)[:, :, 0].contiguous() if alibi else None
    out, lse = fa.flash_attention_fwd(q, k, v, seg, head_dim**-0.5, bias)
    want, want_lse = fa.flash_attention_fwd_plain(q, k, v, seg, head_dim**-0.5, bias)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out.float()).all()) and bool(torch.isfinite(lse).all())
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-5)
    within, err = _close(out, want, dtype == torch.float32)
    assert within, err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rope_kernel_with_per_row_decode_positions(dtype):
    """A dense decode step: 16 slots, each row's cos / sin at its own position, as
    `get_cos_sin` gives them for ``position_ids = lengths[:, None]``."""
    from dolomite_engine_tpu_torch.ops.rope import RoPEParams, get_cos_sin

    g = torch.Generator(device="cuda").manual_seed(3)
    positions = torch.as_tensor(np.random.RandomState(3).randint(0, 2048, (16, 1)), device="cuda")
    cos, sin = get_cos_sin(RoPEParams.from_config(80), positions, dtype=dtype)
    qkv = _rand(g, (16, 1, 3 * 32 * 80), dtype)
    got = rope_qkv.fused_rope_qkv(qkv, cos, sin, 32, 32, 80)
    want = rope_qkv.fused_rope_qkv_plain(qkv, cos, sin, 32, 32, 80)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[..., 2 * 32 * 80 :], qkv[..., 2 * 32 * 80 :], atol=0, rtol=0)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    else:
        x = qkv.float().reshape(16, 1, -1, 80)
        scale = (x.abs() + x.roll(40, -1).abs()).reshape(qkv.shape)
        assert bool(((got.float() - want.float()).abs() <= 2 * _bf16_ulp(scale)).all())


def test_bias_flash_launches_count_on_their_own_spec():
    from dolomite_engine_tpu_torch.ops.attention import attention
    from dolomite_engine_tpu_torch.ops.kernels import flash_attention as fa
    from dolomite_engine_tpu_torch.ops.kernels import reset_launch_counts

    g = torch.Generator(device="cuda").manual_seed(5)
    q, k, v = (_rand(g, (1, 128, 2, 64), torch.bfloat16).requires_grad_() for _ in range(3))
    bias = torch.arange(128, device="cuda", dtype=torch.float32).expand(1, 2, 128).contiguous()
    reset_launch_counts()
    fa.flash_attention(q, k, v, None, 0.125).sum().backward()
    fa.flash_attention(q, k, v, None, 0.125, bias).sum().backward()
    fa.flash_attention(q, k, v, None, 0.125, causal=False).sum().backward()
    assert (fa.FWD_KERNEL.launches, fa.BWD_KERNEL.launches) == (1, 1)
    assert (fa.BIAS_FWD_KERNEL.launches, fa.BIAS_BWD_KERNEL.launches) == (2, 2)
    with pytest.raises(ValueError):  # a bf16 bias
        fa.flash_attention_fwd(q.detach(), k.detach(), v.detach(), None, 0.125, bias.bfloat16())
    # a bias that varies along the queries: the query-bias form, counted as its own form
    query_bias = torch.zeros(1, 2, 128, 128, device="cuda", requires_grad=True)
    attention(q, k, v, implementation="flash_attention_2", alibi_bias=query_bias).sum().backward()
    assert fa.BIAS_FWD_KERNEL.forms == {"key_row": 2, "query_bias": 1}
    assert fa.BIAS_BWD_KERNEL.forms == {"key_row": 2, "query_bias": 1}
    assert query_bias.grad is not None and query_bias.grad.shape == query_bias.shape


_FUSED_CE_SHAPES = [
    (256, 2560, 49152, None),  # one loss chunk of the training slice
    (37, 64, 1000, 0.5),  # a ragged row tile, V not a multiple of a vocab tile
    (300, 128, 513, None),  # three 128-row tiles, a one-column last vocab tile
]


@pytest.mark.parametrize(
    "rows,hidden,vocab,logit_scale,dtype",
    [shape + (dtype,) for dtype in (torch.float32, torch.bfloat16) for shape in _FUSED_CE_SHAPES]
    + [
        (512, 1024, 49152, None, torch.bfloat16),  # a loss chunk of the MoE training path (micro batch 2)
        (512, 4096, 50432, None, torch.bfloat16),  # and of the alibi path (MPT-7B widths)
        (1, 64, 300, None, torch.bfloat16),  # a single row
        (700, 96, 1000, 0.5, torch.bfloat16),  # six 128-row blocks (the last ragged), H not a multiple of 64
        (256, 160, 513, None, torch.bfloat16),  # H not a multiple of 64, a one-column last vocab tile
    ],
)
def test_fused_ce_kernel_matches_plain(rows, hidden, vocab, logit_scale, dtype):
    from dolomite_engine_tpu_torch.ops.kernels import fused_ce

    g = torch.Generator(device="cuda").manual_seed(11)
    # logits of std ~0.5, the scale of a trained LM head's
    h = _rand(g, (rows, hidden), dtype, 4.0 / hidden**0.5)
    table = _rand(g, (vocab, hidden), dtype, 1.0 / 8)
    labels = torch.randint(0, vocab, (rows,), generator=g, device="cuda")
    labels[::5] = fused_ce.IGNORE_INDEX  # ignored rows hit no column
    got = fused_ce.fused_ce_rowwise(h, table, labels, logit_scale)
    want = fused_ce.fused_ce_rowwise_plain(h, table, labels, logit_scale)
    torch.cuda.synchronize()
    assert torch.equal(got[1][::5], torch.zeros_like(got[1][::5]))
    for a, b in zip(got, want):
        if dtype == torch.float32:
            torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
        else:
            torch.testing.assert_close(a, b, atol=2e-2, rtol=0)


def test_fused_ce_kernel_is_deterministic():
    """Two launches at the dense loss chunk give the same bits: the partials are combined
    in a fixed order, with no atomics."""
    from dolomite_engine_tpu_torch.ops.kernels import fused_ce

    g = torch.Generator(device="cuda").manual_seed(12)
    h = _rand(g, (256, 2560), torch.bfloat16, 4.0 / 2560**0.5)
    table = _rand(g, (49152, 2560), torch.bfloat16, 1.0 / 8)
    labels = torch.randint(0, 49152, (256,), generator=g, device="cuda")
    first = fused_ce.fused_ce_rowwise(h, table, labels)
    second = fused_ce.fused_ce_rowwise(h, table, labels)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_fused_ce_all_ignored_rows_and_chunk_sums():
    from dolomite_engine_tpu_torch.ops.kernels import fused_ce

    g = torch.Generator(device="cuda").manual_seed(5)
    h = _rand(g, (2, 64, 96), torch.float32, 0.3)
    table = _rand(g, (700, 96), torch.float32, 0.3)
    y = torch.full((2, 64), fused_ce.IGNORE_INDEX, device="cuda")
    y[1, :10] = torch.arange(10, device="cuda")
    loss_sum, z_sum, num = fused_ce.fused_ce_chunk(h, table, y)
    lse, lab = fused_ce.fused_ce_rowwise_plain(h.reshape(128, 96), table, y.reshape(128))
    mask = y.reshape(128) != fused_ce.IGNORE_INDEX
    torch.testing.assert_close(loss_sum, (lse - lab)[mask].sum(), atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(z_sum, lse[mask].square().sum(), atol=1e-5, rtol=1e-5)
    assert num.item() == 10.0


def _moe_plan(seed, group_sizes, block_rows=None):
    from dolomite_engine_tpu_torch.ops.kernels import moe as kmoe

    sizes = torch.as_tensor(np.asarray(group_sizes, np.int64), device="cuda")
    plan, _ = kmoe.block_plan(sizes, int(sum(group_sizes)), block_rows)
    return plan


def _group_sizes(seed, assignments, num_experts, empty=0):
    """Random expert group sizes summing to `assignments`, `empty` experts with none."""
    rs = np.random.RandomState(seed)
    share = rs.dirichlet(np.ones(num_experts - empty))
    sizes = np.floor(share * assignments).astype(np.int64)
    sizes[: assignments - sizes.sum()] += 1
    return [0] * empty + sizes.tolist()


def _padded_rows(gen, plan, cols, dtype, scale):
    """Padded-layout rows: random where real and larger random values where padding. With
    expert biases the dispatch's padding rows are not zero (c_proj's are act(b_fc)), and
    the kernels' contract treats padding as zero whatever it holds, so a kernel that drops
    a row mask fails these cases."""
    from dolomite_engine_tpu_torch.ops.kernels import moe as kmoe

    mask = kmoe._row_mask(plan.block_valid, plan.block_rows)
    rows = torch.randn((plan.padded_rows, cols), generator=gen, device="cuda") * scale
    return torch.where(mask, rows, 4 * rows + scale).to(dtype)


def _synchronize(seconds=120.0):
    """torch.cuda.synchronize with a time limit: a kernel that hangs (a lost mbarrier
    arrival) fails its own case here instead of stalling the suite."""
    import time

    done = torch.cuda.Event()
    done.record()
    deadline = time.monotonic() + seconds
    while not done.query():
        if time.monotonic() > deadline:
            pytest.fail(f"the kernel did not finish within {seconds} s")
        time.sleep(1e-3)


def _close_gmm(got, want, fp32):
    """fp32: 1e-5 abs + 1e-5 rel (only the summation order differs). bf16: one bf16 ulp
    of the value plus 1e-4 abs (both sides sum in fp32 and round the sum once, so a sum
    near a rounding boundary may land one ulp apart)."""
    diff = (got.float() - want.float()).abs()
    bound = 1e-5 + 1e-5 * want.float().abs() if fp32 else 1e-4 + _bf16_ulp(want)
    return bool((diff <= bound).all()), diff.max().item()


@pytest.mark.parametrize(
    "group_sizes,k_dim,n_dim,block_rows",
    [
        ([5, 0, 12, 3], 16, 24, 8),  # empty expert, K and N not multiples of the tiles
        ([0, 0, 7, 0], 40, 136, None),  # A < 8: one block of 7 rows
        ([9, 30, 0, 1, 24], 72, 200, 16),
        ([70, 1, 0, 129, 64], 136, 200, 64),  # blocks of 64: the 64 x 128 wgmma tiles
        ([70, 1, 0, 129, 64], 136, 200, 128),  # 128-row blocks, K and N edges per expert
        ([70, 1, 0, 129, 64], 136, 4104, 128),  # 128 x 256 tiles, an N edge inside a tile
        ([300, 5, 0, 260], 136, 520, 128),  # experts of three 128-row blocks, the last partly filled
        ([6, 11, 0, 3], 20, 36, 8),  # bf16 rows of 40 bytes: TMA cannot address them (mma.sync)
        ("decode", 1024, 8192, None),  # 8 slots x top-4 over 32 experts: bm 32, 33 blocks
        ("prefill", 1024, 8192, None),  # one 512-token chunk x top-4: bm 128
        ("sparse", 4096, 1024, None),  # the proj GEMM with most experts empty
    ],
)
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_gemm_kernel_matches_plain(group_sizes, k_dim, n_dim, block_rows, transpose, dtype):
    from dolomite_engine_tpu_torch.ops.kernels import moe as kmoe

    if isinstance(group_sizes, str):
        assignments, empty = {"decode": (32, 0), "prefill": (2048, 0), "sparse": (96, 28)}[group_sizes]
        group_sizes = _group_sizes(3, assignments, 32, empty)
    plan = _moe_plan(0, group_sizes, block_rows)
    gen = torch.Generator(device="cuda").manual_seed(13)
    num_experts = len(group_sizes)
    xp = _padded_rows(gen, plan, k_dim, dtype, 1.0)
    shape = (num_experts, n_dim, k_dim) if transpose else (num_experts, k_dim, n_dim)
    w = (torch.randn(shape, generator=gen, device="cuda") / k_dim**0.5).to(dtype)
    got = kmoe.gmm(xp, w, plan, transpose_w=transpose)
    _synchronize()
    want = kmoe.gmm_plain(xp, w, plan.block_expert, plan.block_rows, plan.block_valid, transpose)
    torch.cuda.synchronize()
    # the fixed shape rule: fp32 by scalar FMA, bf16 by wgmma where TMA can address the rows
    aligned = k_dim % 8 == 0 and n_dim % 8 == 0
    assert kmoe.gmm_path(xp, w, transpose) == ("fma" if dtype == torch.float32 else "wgmma" if aligned else "mma.sync")
    assert got.dtype == dtype and got.shape == want.shape
    ok, err = _close_gmm(got, want, dtype == torch.float32)
    assert ok, err
    padding = ~kmoe._row_mask(plan.block_valid, plan.block_rows)[:, 0]
    assert not got[padding].any()  # padding rows are written as zeros


@pytest.mark.parametrize(
    "group_sizes,k_dim,n_dim",
    [
        ([9, 0, 4, 20, 0], 16, 24),  # empty experts write zeros
        ([33, 0, 0, 33], 136, 72),
        ([65, 130, 63, 1, 200, 0], 136, 200),  # 64-row stages crossed, a 1-row expert
        ([0, 300, 0, 0], 200, 136),  # every row on one expert
        ([6, 11, 0, 3], 20, 36),  # bf16 rows of 40 bytes: TMA cannot address them (mma.sync)
        ("train", 1024, 4096),  # the training micro-batch's c_proj input x dy shape, 4 of 32 experts
        ("sparse", 256, 384),
    ],
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_gemm_tgmm_kernel_matches_plain(group_sizes, k_dim, n_dim, dtype):
    _check_tgmm(group_sizes, k_dim, n_dim, dtype, None)


@pytest.mark.parametrize("block_rows", [8, 16, 32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_gemm_tgmm_block_rows_match_plain(block_rows, dtype):
    """Every block size: at bm < 64 a 64-row stage of one expert reaches into the next
    expert's rows, which the kernel must zero; 1-row and empty experts, K and N edges."""
    _check_tgmm([70, 1, 0, 129, 64, 5], 136, 200, dtype, block_rows)


def _check_tgmm(group_sizes, k_dim, n_dim, dtype, block_rows):
    """tgmm against its plain version (fp32 out), empty experts exactly zero, and the
    bf16-out form bit-identical to the same kernel's fp32 output rounded to bf16."""
    from dolomite_engine_tpu_torch.ops.kernels import moe as kmoe

    if isinstance(group_sizes, str):
        assignments, experts, empty = {"train": (2048, 4, 0), "sparse": (300, 32, 29)}[group_sizes]
        group_sizes = _group_sizes(5, assignments, experts, empty)
    plan = _moe_plan(0, group_sizes, block_rows)
    gen = torch.Generator(device="cuda").manual_seed(17)
    rows = max(group_sizes)
    xp = _padded_rows(gen, plan, k_dim, dtype, 1.0)
    dy = _padded_rows(gen, plan, n_dim, dtype, 1.0 / rows**0.5)
    got = kmoe.tgmm(xp, dy, plan, len(group_sizes))
    got_bf16 = kmoe.tgmm(xp, dy, plan, len(group_sizes), out_dtype=torch.bfloat16)
    _synchronize()
    want = kmoe.tgmm_plain(xp, dy, plan.block_expert, plan.block_rows, len(group_sizes), plan.block_valid)
    torch.cuda.synchronize()
    aligned = k_dim % 8 == 0 and n_dim % 8 == 0
    assert kmoe.tgmm_path(xp, dy) == ("fma" if dtype == torch.float32 else "wgmma" if aligned else "mma.sync")
    assert got.dtype == torch.float32 and got_bf16.dtype == torch.bfloat16
    # fp32 products of bf16 inputs are exact, so both dtypes differ only by the sum order
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    # one rounding of the same fp32 sum: the fused cast changes no bit
    assert torch.equal(got_bf16, got.to(torch.bfloat16))
    for e, size in enumerate(group_sizes):
        if size == 0:
            assert not got[e].any() and not got_bf16[e].any()


def test_grouped_gemm_autograd_matches_plain_autograd():
    """fp32: the autograd function's dX (gmm over the banks read transposed in place) and
    dW (tgmm) equal autograd through the plain forward."""
    from dolomite_engine_tpu_torch.ops.kernels import moe as kmoe

    plan = _moe_plan(0, [40, 0, 17, 71])
    gen = torch.Generator(device="cuda").manual_seed(19)
    xp = _padded_rows(gen, plan, 96, torch.float32, 1.0).requires_grad_()
    w = (torch.randn((4, 96, 160), generator=gen, device="cuda") * 0.1).requires_grad_()
    dy = torch.randn((plan.padded_rows, 160), generator=gen, device="cuda")
    kmoe.grouped_gemm(xp, w, plan).backward(dy)
    got = (xp.grad.clone(), w.grad.clone())
    xp.grad = w.grad = None
    mask = kmoe._row_mask(plan.block_valid, plan.block_rows)
    kmoe.gmm_plain(xp, w, plan.block_expert, plan.block_rows, plan.block_valid).backward(dy)
    torch.testing.assert_close(got[0], xp.grad * mask, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(got[1], w.grad, atol=1e-5, rtol=1e-5)


def test_experts_grouped_on_the_card_matches_the_cpu_plain_path():
    """The whole dispatch (layout, gather, two kernels, combine) on the card against the
    same function on CPU tensors (plain versions), fp32 with swiglu banks."""
    from dolomite_engine_tpu_torch.ops.activations import get_activation_function
    from dolomite_engine_tpu_torch.ops.kernels import moe as kmoe
    from dolomite_engine_tpu_torch.ops.moe import route

    gen = torch.Generator().manual_seed(23)
    tokens, d, f, experts, k = 200, 64, 96, 8, 4
    x = torch.randn((tokens, d), generator=gen)
    weights, selected = route(torch.randn((tokens, experts), generator=gen), k)
    w_fc = torch.randn((experts, d, 2 * f), generator=gen) * 0.1
    w_proj = torch.randn((experts, f, d), generator=gen) * 0.1
    act = get_activation_function("swiglu")
    args = (x, weights, selected, w_fc, None, w_proj, None, act, experts)
    want = kmoe.experts_grouped(*args)
    got = kmoe.experts_grouped(*(a.cuda() if isinstance(a, torch.Tensor) else a for a in args))
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------------- the paged K/V write


def _paged_write_case(g, batch, seq, hq, hkv, head_dim, dtype, index, real=None, max_pages=4, page=16):
    """qkv, cos / sin (one shared table: batch stride 0), a shuffled table (row 1 idle
    when batch > 1), the index and a key mask (`real` rows of a chunk) on the card."""
    qkv = _rand(g, (batch, seq, (hq + 2 * hkv) * head_dim), dtype)
    angles = torch.rand((1, seq, head_dim), generator=g, device="cuda") * 6.0
    pages = 1 + batch * max_pages
    table = (1 + torch.randperm(pages - 1, generator=g, device="cuda")).reshape(batch, max_pages).to(torch.int32)
    if batch > 1:
        table[1] = 0
    mask = None
    if real is not None:
        mask = torch.zeros((batch, max_pages * page), dtype=torch.int32, device="cuda")
        mask[:, : int(index) + real] = 1
    return qkv, angles.cos(), angles.sin(), table.contiguous(), index, mask, pages


def _pools(g, pages, page, hkv, head_dim, kv_dtype):
    """K and V pools of `kv_dtype` (bf16 / fp32 values, or int8 / fp8 codes with scales)
    whose pages' second halves hold their largest values."""
    values = [_rand(g, (pages, page, hkv, head_dim), torch.float32) for _ in range(2)]
    for v in values:
        v[:, page // 2 :] *= 10.0
    if kv_dtype in ("bf16", "fp32"):
        dtype = torch.bfloat16 if kv_dtype == "bf16" else torch.float32
        return [v.to(dtype) for v in values] + [None, None]
    storage, qmax = KV_QUANT_DTYPES[kv_dtype]
    valid = torch.ones((pages, page), dtype=torch.bool, device="cuda")
    (k, ks), (v, vs) = (quantize_pages_plain(x, valid, qmax, storage) for x in values)
    return [k, v, ks, vs]


# (batch, seq, hq, hkv, head_dim, index, real rows of the chunk): decode rows at their own
# frontiers (one mid-page, one idle, one on a page boundary), a verify window past the
# view, prefill chunks at a scalar start (a pad tail; one running past the view), and a
# head dim (24) whose halves take the scalar path
PAGED_WRITE_SHAPES = [
    (4, 1, 4, 2, 16, [21, 0, 32, 63], None),
    (2, 5, 4, 4, 80, [14, 61], None),
    (1, 24, 4, 2, 64, 10, 20),
    (1, 24, 2, 2, 80, 48, 16),
    (3, 3, 6, 2, 24, [7, 0, 40], None),
]


@pytest.mark.parametrize("batch,seq,hq,hkv,head_dim,index,real", PAGED_WRITE_SHAPES)
@pytest.mark.parametrize("pool", ["bf16", "fp32"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rope_qkv_paged_writes_what_the_flat_kernel_and_plain_scatter_write(
    batch, seq, hq, hkv, head_dim, index, real, pool, dtype
):
    """The paged form over a bf16 / fp32 pool (an fp32 model casts on store): exactly one
    launch, pages 1.. and the query byte-identical to the flat kernel followed by the plain
    scatter, the query within rope's tolerance of the plain version."""
    from functools import partial

    g = torch.Generator(device="cuda").manual_seed(31)
    qkv, cos, sin, table, index, mask, pages = _paged_write_case(g, batch, seq, hq, hkv, head_dim, dtype, index, real)
    index_t = torch.tensor(index, dtype=torch.int32, device="cuda")
    k, v, _, _ = _pools(g, pages, 16, hkv, head_dim, pool)
    got_k, got_v, ref_k, ref_v, plain_k, plain_v = (t.clone() for t in (k, v) * 3)
    before = rope_qkv.KERNEL.launches
    query, none_k, none_v = rope_qkv.rope_qkv_paged(qkv, cos, sin, hq, hkv, head_dim, got_k, got_v, table, index_t, mask)
    assert rope_qkv.KERNEL.launches == before + 1 and none_k is None and none_v is None
    flat = partial(rope_qkv.rope_qkv_paged_plain, rope=rope_qkv.fused_rope_qkv)
    ref_q, _, _ = flat(qkv, cos, sin, hq, hkv, head_dim, ref_k, ref_v, table, index_t, mask)
    plain_q, _, _ = rope_qkv.rope_qkv_paged_plain(qkv, cos, sin, hq, hkv, head_dim, plain_k, plain_v, table, index_t, mask)
    torch.cuda.synchronize()
    assert query.shape == (batch, seq, hq, head_dim) and query.is_contiguous()
    assert torch.equal(query, ref_q) and same_pages(got_k, ref_k) and same_pages(got_v, ref_v)
    assert same_pages(got_v, plain_v)  # V is copied (cast on store): no arithmetic
    assert not same_pages(got_k, k)  # the window wrote something
    x = qkv.float().reshape(batch, seq, -1, head_dim)[:, :, :hq]
    scale = x.abs() + x.roll(head_dim // 2, -1).abs()
    diff = (query.float() - plain_q.float()).abs()
    tol = 2 * scale * 2**-23 if dtype == torch.float32 else 2 * _bf16_ulp(scale)
    assert bool((diff <= tol).all())


@pytest.mark.parametrize("batch,seq,hq,hkv,head_dim,index,real", PAGED_WRITE_SHAPES)
@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantized_paged_write_is_byte_identical_to_plain(batch, seq, hq, hkv, head_dim, index, real, kv_dtype, dtype):
    """Over a quantized pool: the paged form's query, K and V are the flat kernel's, one
    launch; the fused scatter-quantize writes pages 1.. and scales byte-identical to its
    plain version, one launch, from contiguous rows and from the split's strided views,
    with the start as a tensor or an int."""
    from dolomite_engine_tpu_torch.ops.attention import paged_write_kv_quantized_plain

    g = torch.Generator(device="cuda").manual_seed(32)
    qkv, cos, sin, table, index, mask, pages = _paged_write_case(g, batch, seq, hq, hkv, head_dim, dtype, index, real)
    index_t = torch.tensor(index, dtype=torch.int32, device="cuda")
    before = rope_qkv.KERNEL.launches
    query, key, value = rope_qkv.rope_qkv_paged(qkv, cos, sin, hq, hkv, head_dim, None, None, table, index_t, mask)
    assert rope_qkv.KERNEL.launches == before + 1
    flat = rope_qkv.fused_rope_qkv(qkv, cos, sin, hq, hkv, head_dim)
    fq, fk, fv = (p.reshape(batch, seq, -1, head_dim) for p in torch.split(flat, [hq * head_dim, hkv * head_dim, hkv * head_dim], -1))
    torch.cuda.synchronize()
    assert torch.equal(query, fq) and torch.equal(key, fk) and torch.equal(value, fv)
    pools = _pools(g, pages, 16, hkv, head_dim, kv_dtype)
    for rows, start in ((key, value), index_t), ((fk, fv), index if isinstance(index, int) else index_t):
        got, want = [t.clone() for t in pools], [t.clone() for t in pools]
        before = kv_quant.KERNEL.launches
        kv_quant.paged_scatter_kv_quantized_kernel(*got, *rows, table, start, mask)
        assert kv_quant.KERNEL.launches == before + 1
        paged_write_kv_quantized_plain(*want, *rows, table, start, mask)
        torch.cuda.synchronize()
        assert all(same_pages(a, b) for a, b in zip(got, want))
        assert not same_pages(got[0], pools[0])


@pytest.mark.parametrize("pool", ["bf16", "int8", "fp8"])
def test_verify_windows_over_rejected_tails_match_plain(pool):
    """Two verify steps at W = K+1 = 5 with a [S] index, as the engine runs them: the
    second window starts where the first one's accepted drafts end, over the first
    window's rejected tail and over pool rows past the frontier that hold stale values
    (the pages' second halves hold the largest). Windows cross page boundaries; row 2's
    overhangs its mapped pages (its last table entry is 0: the trash page) and row 3 is
    idle. rope_qkv's paged form (bf16 pool) and the fused scatter-quantize (int8 / fp8)
    write pages 1.. and scales byte-identical to the flat kernel and the plain scatter, one
    launch each, and leave every page outside the rows' tables as it was."""
    from functools import partial

    from dolomite_engine_tpu_torch.ops.attention import paged_write_kv_quantized_plain

    g = torch.Generator(device="cuda").manual_seed(33)
    batch, width, hq, hkv, head_dim, page, max_pages = 4, 5, 32, 32, 80, 16, 4
    pages = 1 + batch * max_pages
    table = (1 + torch.randperm(pages - 1, generator=g, device="cuda")).reshape(batch, max_pages).to(torch.int32)
    table[3] = 0  # an idle row
    table[2, 3] = 0  # positions 48.. of row 2 are past its mapped pages
    table = table.contiguous()
    frontiers = torch.tensor([13, 30, 45, 0], dtype=torch.int32, device="cuda")
    accepted = torch.tensor([1, 3, 0, 0], dtype=torch.int32, device="cuda")
    angles = torch.rand((1, width, head_dim), generator=g, device="cuda") * 6.0
    cos, sin = angles.cos(), angles.sin()
    start = _pools(g, pages, page, hkv, head_dim, pool)
    got = [None if t is None else t.clone() for t in start]
    want = [None if t is None else t.clone() for t in start]
    flat = partial(rope_qkv.rope_qkv_paged_plain, rope=rope_qkv.fused_rope_qkv)
    for index in (frontiers, frontiers + 1 + accepted):
        qkv = _rand(g, (batch, width, (hq + 2 * hkv) * head_dim), torch.bfloat16)
        before = (rope_qkv.KERNEL.launches, kv_quant.KERNEL.launches)
        if pool == "bf16":
            rope_qkv.rope_qkv_paged(qkv, cos, sin, hq, hkv, head_dim, got[0], got[1], table, index)
            launched = (rope_qkv.KERNEL.launches - before[0], kv_quant.KERNEL.launches - before[1])
            flat(qkv, cos, sin, hq, hkv, head_dim, want[0], want[1], table, index)
        else:
            _, key, value = rope_qkv.rope_qkv_paged(qkv, cos, sin, hq, hkv, head_dim, None, None, table, index)
            kv_quant.paged_scatter_kv_quantized_kernel(*got, key, value, table, index)
            launched = (rope_qkv.KERNEL.launches - before[0], kv_quant.KERNEL.launches - before[1])
            paged_write_kv_quantized_plain(*want, key, value, table, index)
        torch.cuda.synchronize()
        assert launched == (1, 0 if pool == "bf16" else 1)
        assert all(same_pages(a, b) for a, b in zip(got, want) if a is not None)
    assert not same_pages(got[0], start[0])  # the windows wrote something
    outside = sorted(set(range(1, pages)) - set(table.flatten().tolist()))
    assert outside  # row 2's unmapped page and the idle row's
    for a, b in zip(got, start):
        if a is not None:
            assert torch.equal(as_bytes(a)[outside], as_bytes(b)[outside])


def test_paged_write_wrappers_raise_on_what_the_kernels_do_not_take():
    g = torch.Generator(device="cuda").manual_seed(33)
    qkv, cos, sin, table, index, _, pages = _paged_write_case(g, 2, 1, 4, 2, 16, torch.bfloat16, [3, 0])
    index_t = torch.tensor(index, dtype=torch.int32, device="cuda")
    k, v, ks, vs = _pools(g, pages, 16, 2, 16, "int8")
    key = torch.zeros((2, 1, 2, 16), device="cuda")
    with pytest.raises(ValueError):  # quantized pools take the split form
        rope_qkv.rope_qkv_paged(qkv, cos, sin, 4, 2, 16, k, v, table, index_t)
    with pytest.raises(ValueError, match="page_table"):
        rope_qkv.rope_qkv_paged(qkv, cos, sin, 4, 2, 16, None, None, table.long(), index_t)
    with pytest.raises(ValueError, match="cache index"):
        kv_quant.paged_scatter_kv_quantized_kernel(k, v, ks, vs, key, key, table, index_t.float())
    with pytest.raises(ValueError, match="key mask"):
        kv_quant.paged_scatter_kv_quantized_kernel(k, v, ks, vs, key, key, table, index_t, torch.ones((2, 8), device="cuda", dtype=torch.int32))
    with pytest.raises(ValueError):  # a bf16 pool is not a quantized one
        kv_quant.paged_scatter_kv_quantized_kernel(k.bfloat16(), v.bfloat16(), ks, vs, key, key, table, index_t)
    with pytest.raises(ValueError, match="strides"):  # each row's heads not contiguous
        strided = key.transpose(2, 3).contiguous().transpose(2, 3)
        kv_quant.paged_scatter_kv_quantized_kernel(k, v, ks, vs, key, strided, table, index_t)


@pytest.mark.parametrize("cos_batch", [1, 3])
@pytest.mark.parametrize("cos_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("head_dim", [80, 24])
def test_rope_qkv_reads_cos_sin_in_place(cos_batch, cos_dtype, dtype, head_dim):
    """The flat form reads cos / sin of either dtype, shared over the batch or per row, in
    place (no cast or copy on the host): bit-identical to the same call on tables already
    cast and expanded, and its backward (the -sin flag) to the forward with -sin."""
    g = torch.Generator(device="cuda").manual_seed(34)
    qkv = _rand(g, (3, 7, 8 * head_dim), dtype)
    angles = torch.rand((cos_batch, 7, head_dim), generator=g, device="cuda") * 6.0
    cos, sin = angles.cos().to(cos_dtype), angles.sin().to(cos_dtype)
    got = rope_qkv.fused_rope_qkv(qkv, cos, sin, 4, 2, head_dim)
    full_cos, full_sin = (t.to(dtype).expand(3, 7, head_dim).contiguous() for t in (cos, sin))
    torch.cuda.synchronize()
    assert torch.equal(got, rope_qkv.fused_rope_qkv(qkv, full_cos, full_sin, 4, 2, head_dim))
    grad = _rand(g, qkv.shape, dtype)
    x = qkv.clone().requires_grad_(True)
    rope_qkv.fused_rope_qkv(x, cos, sin, 4, 2, head_dim).backward(grad)
    assert torch.equal(x.grad, rope_qkv.fused_rope_qkv(grad, full_cos, -full_sin, 4, 2, head_dim))


def test_paged_write_kernel_cases_of_the_smoke():
    """chip_smoke's cases at both served models' decode and prefill windows over bf16,
    int8 and fp8 pools (each raises if a form disagrees with its plain version)."""
    import chip_smoke

    cases = chip_smoke.paged_write_kernel_cases(0)
    assert {c["form"] for c in cases} == {"paged", "scatter"} and all(c["within_tolerance"] for c in cases)
