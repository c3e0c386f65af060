"""The port's quantized KV pieces against the JAX package's, on the CPU.

- `quantize_pages` (the plain version, which the kernel must match byte for byte on the
  card) against `quantize_pages_xla` and the Pallas kernel in interpret mode: the codes'
  bytes and the scales must be identical, for int8 and fp8;
- `paged_scatter_kv_quantized_plain` (the JAX function's counterpart, one pool a call)
  after a decode window (S=1), a K+1 window (S=5) and a prefill chunk that straddles
  pages, with invalid writes and trash redirects: pool codes and scales bit-identical to
  the JAX function's outside the trash page 0;
- `paged_gather_kv_dequant`, bit-identical;
- the plain decode and prefill attention over quantized pages, and over a bf16 pool under
  an fp32 query, against the JAX Pallas kernels (interpret mode): atol = rtol = 1e-5 in
  fp32 (only summation order differs).

Inputs come from numpy seeds at small sizes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dolomite_engine_tpu.ops import attention as jax_attention
from dolomite_engine_tpu.ops.kv_quant import KV_QUANT_DTYPES as JAX_KV_QUANT_DTYPES
from dolomite_engine_tpu.ops.kv_quant import quantize_pages_xla
from dolomite_engine_tpu.ops.pallas import kernel_overrides
from dolomite_engine_tpu.ops.pallas.kv_quant import quantize_pages_pallas
from dolomite_engine_tpu.ops.pallas.paged_attention import paged_decode_attention as jax_decode
from dolomite_engine_tpu.ops.pallas.prefill_attention import paged_prefill_attention as jax_prefill
from dolomite_engine_tpu_torch.ops.attention import (
    paged_gather_kv_dequant,
    paged_scatter_kv_quantized_plain,
)
from dolomite_engine_tpu_torch.ops.kernels.paged_attention import paged_decode_attention
from dolomite_engine_tpu_torch.ops.kernels.prefill_attention import paged_prefill_attention
from dolomite_engine_tpu_torch.ops.kv_quant import (
    KV_QUANT_DTYPES,
    dequantize_values,
    kv_qmax,
    quantize_pages,
)

PAGE = 16
KV_DTYPES = ["int8", "fp8"]


def _bytes(array) -> np.ndarray:
    """The raw bytes of a torch or numpy array of codes (or the fp32 scales)."""
    if isinstance(array, torch.Tensor):
        array = array.contiguous()
        return (array.view(torch.uint8) if array.element_size() == 1 else array.view(torch.int32)).numpy()
    array = np.asarray(array)
    return array.view(np.uint8) if array.itemsize == 1 else array.view(np.int32)


def _torch_codes(codes: np.ndarray, kv_dtype: str) -> torch.Tensor:
    storage = KV_QUANT_DTYPES[kv_dtype][0]
    return torch.from_numpy(np.ascontiguousarray(codes).view(np.uint8).copy()).view(storage)


def test_dtype_table_matches_jax():
    for name, (storage, qmax) in KV_QUANT_DTYPES.items():
        jax_storage, jax_qmax = JAX_KV_QUANT_DTYPES[name]
        assert qmax == jax_qmax and kv_qmax(storage) == qmax
        assert torch.tensor([], dtype=storage).element_size() == jnp.dtype(jax_storage).itemsize
    with pytest.raises(ValueError):
        kv_qmax(torch.bfloat16)


def _values(case: str, rs: np.random.RandomState):
    """(values [N, PAGE, H, D] fp32, valid [N, PAGE]) of one input family."""
    n, heads, head_dim = 7, 3, 16
    values = rs.randn(n, PAGE, heads, head_dim).astype(np.float32) * 2.0
    valid = rs.rand(n, PAGE) > 0.3
    if case == "stale_rows":
        # garbage past each page's frontier (invalid rows), an all-invalid page, a page of
        # valid zeros (amax 0 -> scale 1), and a page with one valid row
        frontier = rs.randint(1, PAGE, n)
        valid = np.arange(PAGE)[None, :] < frontier[:, None]
        values = np.where(valid[:, :, None, None], values, values * 1e3)
        valid[2] = False
        values[3] = 0.0
        valid[3] = True
        valid[4] = False
        valid[4, 5] = True
    elif case == "bf16_values":
        # bf16-rounded K/V, as the model writes them: quotients land on halves (int8 ties)
        values = np.asarray(jnp.asarray(values).astype(jnp.bfloat16).astype(jnp.float32))
    elif case == "tiny_and_signed_zeros":
        # fp8 subnormals and signed zeros after division
        values = values * 1e-3
        values[0, :, :, :2] = -0.0
    return values, valid


@pytest.mark.parametrize("case", ["random", "stale_rows", "bf16_values", "tiny_and_signed_zeros"])
@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_quantize_pages_bytes_match_jax(kv_dtype, case):
    values, valid = _values(case, np.random.RandomState(11))
    storage, qmax = KV_QUANT_DTYPES[kv_dtype]
    jax_storage = JAX_KV_QUANT_DTYPES[kv_dtype][0]
    codes, scales = quantize_pages(torch.tensor(values), torch.tensor(valid), qmax, storage)
    assert codes.dtype == storage and scales.dtype == torch.float32
    for reference in (quantize_pages_xla, lambda *a: quantize_pages_pallas(*a, interpret=True)):
        ref_codes, ref_scales = reference(jnp.asarray(values), jnp.asarray(valid), qmax, jax_storage)
        np.testing.assert_array_equal(_bytes(codes), _bytes(ref_codes))
        np.testing.assert_array_equal(_bytes(scales), _bytes(ref_scales))
    if case == "stale_rows":
        assert float(scales[3].max()) == 1.0 and float(scales[2].max()) == 1.0
        np.testing.assert_allclose(
            scales[1].numpy(), np.abs(values[1, valid[1]]).max(axis=(0, 2)) * np.float32(1 / qmax)
        )


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_round_trip_keeps_the_codes(kv_dtype):
    """Decode then re-encode with the same valid rows gives the same codes back: committed
    tokens do not drift under repeated writes. The scale is recomputed from the decoded
    absmax (qmax times the scale), which may land an ulp away: an int8 re-encode keeps its
    bytes, an fp8 one its codes with the scale within 1e-6."""
    storage, qmax = KV_QUANT_DTYPES[kv_dtype]
    values, valid = _values("random", np.random.RandomState(3))
    codes, scales = quantize_pages(torch.from_numpy(values), torch.from_numpy(valid), qmax, storage)
    again, again_scales = quantize_pages(
        dequantize_values(codes, scales[:, None, :, None], torch.float32), torch.from_numpy(valid),
        qmax, storage,
    )
    np.testing.assert_array_equal(_bytes(again), _bytes(codes))
    if kv_dtype == "int8":
        np.testing.assert_array_equal(_bytes(again_scales), _bytes(scales))
    np.testing.assert_allclose(again_scales.numpy(), scales.numpy(), rtol=1e-6, atol=0)


def _pool(kv_dtype, rs, num_pages=10, heads=2, head_dim=8):
    """A pool of encoded random pages (codes as numpy, scales fp32)."""
    storage, qmax = KV_QUANT_DTYPES[kv_dtype]
    values = rs.randn(num_pages, PAGE, heads, head_dim).astype(np.float32)
    codes, scales = quantize_pages_xla(
        jnp.asarray(values), jnp.ones((num_pages, PAGE), bool), qmax, JAX_KV_QUANT_DTYPES[kv_dtype][0]
    )
    return np.asarray(codes), np.asarray(scales)


# (name, page table [B, max_pages], write positions [B, S], write_valid [B, S])
_WINDOWS = {
    # decode: three slots at their frontiers (one mid-page, one at a page start), one idle
    # slot whose all-zero row writes into the trash page
    "decode": (
        [[3, 5, 0, 0], [7, 0, 0, 0], [0, 0, 0, 0], [1, 2, 4, 0]],
        [[21], [0], [0], [47]],
        [[True], [True], [True], [True]],
    ),
    # a K+1 verify window (S=5) straddling a page boundary, and one at the view's end whose
    # overhang is clamped to position 0 and marked invalid
    "verify": (
        [[3, 5, 6, 0], [1, 2, 4, 8]],
        [[14, 15, 16, 17, 18], [62, 63, 0, 0, 0]],
        [[True] * 5, [True, True, False, False, False]],
    ),
    # a 24-wide prefill chunk starting mid-page over a resident prefix: 20 real tokens and
    # a 4-token pad tail (invalid writes)
    "prefill": (
        [[3, 5, 6, 0]],
        [list(range(10, 34))],
        [[True] * 20 + [False] * 4],
    ),
}


def _scatter_inputs(window, kv_dtype, seed):
    table, positions, write_valid = (np.asarray(a) for a in _WINDOWS[window])
    rs = np.random.RandomState(seed)
    codes, scales = _pool(kv_dtype, rs)
    new = rs.randn(*positions.shape, 2, 8).astype(np.float32) * 1.5
    return codes, scales, new, table.astype(np.int32), positions.astype(np.int32), write_valid


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("window", list(_WINDOWS))
@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_quantized_scatter_matches_jax(kv_dtype, window, backend):
    codes, scales, new, table, positions, write_valid = _scatter_inputs(window, kv_dtype, 5)
    with kernel_overrides(paged_kv_quant=backend):
        ref_codes, ref_scales = jax_attention.paged_scatter_kv_quantized(
            jnp.asarray(codes), jnp.asarray(scales), jnp.asarray(new), jnp.asarray(table),
            jnp.asarray(positions), jnp.asarray(write_valid),
        )
    pages = _torch_codes(codes, kv_dtype)
    pool_scales = torch.from_numpy(scales.copy())
    out_pages, out_scales = paged_scatter_kv_quantized_plain(
        pages, pool_scales, torch.from_numpy(new), torch.from_numpy(table),
        torch.from_numpy(positions), torch.from_numpy(write_valid),
    )
    assert out_pages is pages and out_scales is pool_scales  # updated in place
    # page 0 is the trash page: colliding garbage writes may land in any order
    np.testing.assert_array_equal(_bytes(pages)[1:], _bytes(ref_codes)[1:])
    np.testing.assert_array_equal(_bytes(pool_scales)[1:], _bytes(ref_scales)[1:])
    # the pages written really changed, the others did not
    touched = {int(p) for p in np.unique(table[write_valid.any(1)]) if p}
    changed = {p for p in range(1, codes.shape[0]) if not np.array_equal(_bytes(pages)[p], _bytes(codes)[p])}
    assert changed and changed <= touched


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_gather_dequant_matches_jax(kv_dtype):
    codes, scales = _pool(kv_dtype, np.random.RandomState(8))
    table = np.array([[3, 5, 0], [9, 1, 2]], np.int32)
    for dtype, jax_dtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = paged_gather_kv_dequant(
            _torch_codes(codes, kv_dtype), torch.from_numpy(scales), torch.from_numpy(table), dtype
        )
        want = jax_attention.paged_gather_kv_dequant(
            jnp.asarray(codes), jnp.asarray(scales), jnp.asarray(table), jax_dtype
        )
        assert got.dtype == dtype and got.shape == want.shape
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def _attention_inputs(pool, seed, num_rows, width, max_pages=4, q_heads=4, kv_heads=2, head_dim=16):
    """q, pages (codes + scales, or bf16 pages), a table mapping each row's pages."""
    rs = np.random.RandomState(seed)
    num_pages = 1 + num_rows * max_pages
    q = rs.randn(num_rows, width, q_heads, head_dim).astype(np.float32)
    k = rs.randn(num_pages, PAGE, kv_heads, head_dim).astype(np.float32) * 3.0
    v = rs.randn(num_pages, PAGE, kv_heads, head_dim).astype(np.float32) * 0.5
    table = 1 + np.arange(num_rows * max_pages, dtype=np.int32).reshape(num_rows, max_pages)
    rs.shuffle(table.reshape(-1))
    if pool == "bf16":
        return q, [jnp.asarray(k).astype(jnp.bfloat16), jnp.asarray(v).astype(jnp.bfloat16)], None, table
    valid = jnp.ones((num_pages, PAGE), bool)
    storage, qmax = JAX_KV_QUANT_DTYPES[pool]
    (k_q, k_s), (v_q, v_s) = (quantize_pages_xla(jnp.asarray(x), valid, qmax, storage) for x in (k, v))
    return q, [k_q, v_q], [k_s, v_s], table


def _to_torch_pages(pages, pool):
    if pool == "bf16":
        return [torch.from_numpy(np.asarray(p.astype(jnp.float32))).to(torch.bfloat16) for p in pages]
    return [_torch_codes(np.asarray(p), pool) for p in pages]


@pytest.mark.parametrize("pool", ["int8", "fp8", "bf16"])
@pytest.mark.parametrize("width", [1, 4])
def test_plain_decode_over_quantized_pages_matches_jax(pool, width):
    q, pages, scales, table = _attention_inputs(pool, 21, 3, width)
    lengths = np.array([20, 0, 47], np.int32)  # mid-page, an idle row, a later page
    table[1] = 0
    scale = 16**-0.5
    want = jax_decode(
        jnp.asarray(q), *pages, jnp.asarray(table), jnp.asarray(lengths), scale,
        k_scales=None if scales is None else scales[0], v_scales=None if scales is None else scales[1],
        interpret=True,
    )
    k, v = _to_torch_pages(pages, pool)
    ks, vs = (None, None) if scales is None else (torch.from_numpy(np.asarray(s)) for s in scales)
    got = paged_decode_attention(
        torch.from_numpy(q), k, v, torch.from_numpy(table), torch.from_numpy(lengths), scale, ks, vs
    )
    live = [0, 2]  # the idle row's output is garbage on both sides
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("pool", ["int8", "fp8", "bf16"])
def test_plain_prefill_over_quantized_pages_matches_jax(pool):
    q, pages, scales, table = _attention_inputs(pool, 22, 2, 24)
    starts = np.array([10, 0], np.int32)
    scale = 16**-0.5
    want = jax_prefill(
        jnp.asarray(q), *pages, jnp.asarray(table), jnp.asarray(starts), scale,
        k_scales=None if scales is None else scales[0], v_scales=None if scales is None else scales[1],
        interpret=True,
    )
    k, v = _to_torch_pages(pages, pool)
    ks, vs = (None, None) if scales is None else (torch.from_numpy(np.asarray(s)) for s in scales)
    got = paged_prefill_attention(
        torch.from_numpy(q), k, v, torch.from_numpy(table), torch.from_numpy(starts), scale, ks, vs
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_attention_refuses_unpaired_or_missing_scales():
    q, pages, scales, table = _attention_inputs("int8", 23, 1, 1)
    k, v = _to_torch_pages(pages, "int8")
    ks = torch.from_numpy(np.asarray(scales[0]))
    args = (torch.from_numpy(q), k, v, torch.from_numpy(table), torch.tensor([3], dtype=torch.int32), 0.25)
    with pytest.raises(ValueError, match="pair"):
        paged_decode_attention(*args, ks, None)
    with pytest.raises(ValueError, match="scale pools"):
        paged_decode_attention(*args)
    with pytest.raises(ValueError, match="scale pools"):
        paged_prefill_attention(*args)
