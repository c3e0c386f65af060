"""The port's four kernel modules against the JAX package's Pallas kernels, on the CPU.

Same inputs (numpy, from a seed) go to both sides. The JAX side runs its Pallas kernels
in interpret mode, as `tests/ops/test_pallas_kernels.py` does off-TPU; the port's
wrappers take their plain PyTorch versions because the tensors lie on the CPU (the CUDA
kernels themselves are held against those plain versions on the GPU by
`tests/test_torch_cuda_kernels.py` and `chip_smoke.py`).

Tolerances: attention atol = rtol = 1e-5 (the JAX kernel tests' own); rope within 2
fp32 ulp of the larger product, V bitwise; rmsnorm rtol 1e-6, the residual stream
bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dolomite_engine_tpu.models.modeling_utils import (
    _paged_pallas_attention,
    _paged_prefill_pallas_attention,
)
from dolomite_engine_tpu.ops.pallas.paged_attention import paged_decode_attention as jax_decode
from dolomite_engine_tpu.ops.pallas.prefill_attention import paged_prefill_attention as jax_prefill
from dolomite_engine_tpu.ops.pallas.rmsnorm import fused_rmsnorm as jax_rmsnorm
from dolomite_engine_tpu.ops.pallas.rope_qkv import fused_rope_qkv as jax_rope_qkv
from dolomite_engine_tpu.ops.rope import RoPEParams as JaxRoPEParams, get_cos_sin as jax_cos_sin
from dolomite_engine_tpu_torch.models.modeling_utils import _scatter_chunk
from dolomite_engine_tpu_torch.ops.kernels.paged_attention import paged_decode_attention
from dolomite_engine_tpu_torch.ops.kernels.prefill_attention import paged_prefill_attention
from dolomite_engine_tpu_torch.ops.kernels.rmsnorm import fused_rmsnorm
from dolomite_engine_tpu_torch.ops.kernels.rope_qkv import fused_rope_qkv

PAGE = 16
HEAD_TYPES = [("mha", 4, 4), ("gqa", 8, 2), ("mqa", 4, 1)]


def _t(x):
    return torch.from_numpy(np.array(x))


# ------------------------------------------------------------------- rmsnorm


@pytest.mark.parametrize("shape", [(3, 7, 64), (21, 32)])
@pytest.mark.parametrize("with_residual", [False, True])
def test_rmsnorm_matches_pallas(shape, with_residual):
    rs = np.random.RandomState(0)
    x = rs.randn(*shape).astype(np.float32)
    r = rs.randn(*shape).astype(np.float32) if with_residual else None
    w = (rs.randn(shape[-1]) * 0.1 + 1.0).astype(np.float32)
    ref = jax_rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-5, residual=None if r is None else jnp.asarray(r))
    got = fused_rmsnorm(_t(x), _t(w), 1e-5, residual=None if r is None else _t(r))
    if with_residual:
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
        ref, got = ref[0], got[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------------- rope + qkv


def _rope_inputs(hq, hkv, head_dim, yarn, seed=0, batch=2, seq=9):
    scaling = (
        {"type": "yarn", "factor": 4.0, "original_max_position_embeddings": 8} if yarn else None
    )
    rope = JaxRoPEParams.from_config(head_dim, rope_scaling=scaling)
    # per-row offsets: the serving decode/verify shape (every slot at its own position)
    pos = np.arange(seq)[None, :] + np.array([[0], [3]])[:batch]
    cos, sin = jax_cos_sin(rope, jnp.asarray(pos))
    qkv = np.random.RandomState(seed).randn(batch, seq, (hq + 2 * hkv) * head_dim)
    return qkv.astype(np.float32), np.asarray(cos), np.asarray(sin)


@pytest.mark.parametrize("head_type,hq,hkv", HEAD_TYPES)
@pytest.mark.parametrize("yarn", [False, True])
@pytest.mark.parametrize("head_dim", [16, 80])
def test_rope_qkv_matches_pallas(head_type, hq, hkv, yarn, head_dim):
    qkv, cos, sin = _rope_inputs(hq, hkv, head_dim, yarn)
    ref = np.asarray(jax_rope_qkv(jnp.asarray(qkv), jnp.asarray(cos), jnp.asarray(sin), hq, hkv, head_dim))
    got = fused_rope_qkv(_t(qkv), _t(cos), _t(sin), hq, hkv, head_dim).numpy()
    v_cols = (hq + hkv) * head_dim
    np.testing.assert_array_equal(got[..., v_cols:], qkv[..., v_cols:])
    # 2 fp32 ulp of the larger of the two products (the lowerings contract differently)
    x = qkv.reshape(2, 9, -1, head_dim)
    scale = (np.abs(x) + np.abs(np.roll(x, head_dim // 2, axis=-1))).reshape(qkv.shape)
    assert np.all(np.abs(got - ref) <= 2 * np.spacing(scale.astype(np.float32)))


# ------------------------------------------------------------------- paged decode


def _paged_fixtures(seed=0, num_slots=4, width=1, q_heads=8, kv_heads=2, head_dim=16):
    """`tests/ops/test_pallas_kernels._paged_fixtures` in numpy: ragged frontiers, slot 1
    IDLE (all-trash table, length 0), slot 2's frontier mid-page."""
    rs = np.random.RandomState(seed)
    num_pages, max_pages = 16, 4
    q = rs.randn(num_slots, width, q_heads, head_dim).astype(np.float32)
    k_pages = rs.randn(num_pages, PAGE, kv_heads, head_dim).astype(np.float32)
    v_pages = rs.randn(num_pages, PAGE, kv_heads, head_dim).astype(np.float32)
    table = np.zeros((num_slots, max_pages), np.int32)
    lengths = np.array([10, 0, 3 * PAGE + 7, 3], np.int32)[:num_slots]
    table[0, :2] = [1, 2]
    table[2, :4] = [3, 4, 5, 6]
    table[3, :1] = [7]
    return q, k_pages, v_pages, table, lengths


@pytest.mark.parametrize(
    "head_type,hq,hkv,head_dim,width",
    [(name, hq, hkv, d, 1) for name, hq, hkv in HEAD_TYPES for d in (16, 80)]
    + [("gqa", 8, 2, 16, 4), ("gqa", 8, 2, 80, 4)],  # the speculative W=4 window
)
def test_paged_decode_matches_pallas(head_type, hq, hkv, head_dim, width):
    q, k, v, table, lengths = _paged_fixtures(
        seed=1, width=width, q_heads=hq, kv_heads=hkv, head_dim=head_dim
    )
    scale = head_dim**-0.5
    ref = jax_decode(*(jnp.asarray(a) for a in (q, k, v, table, lengths)), scale)
    got = paged_decode_attention(*(_t(a) for a in (q, k, v, table, lengths)), scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------------- paged prefill


def _prefill_fixtures(seed=0, num_rows=2, width=24, q_heads=8, kv_heads=2, head_dim=16):
    """`tests/ops/test_pallas_kernels._prefill_fixtures` in numpy: row 0 continues a
    resident prefix mid-page (start 10), row 1 starts cold; unmapped pages are trash."""
    rs = np.random.RandomState(seed)
    num_pages, max_pages = 16, 4
    q = rs.randn(num_rows, width, q_heads, head_dim).astype(np.float32)
    k_pages = rs.randn(num_pages, PAGE, kv_heads, head_dim).astype(np.float32)
    v_pages = rs.randn(num_pages, PAGE, kv_heads, head_dim).astype(np.float32)
    table = np.zeros((num_rows, max_pages), np.int32)
    table[0, :3] = [1, 2, 3]
    if num_rows > 1:
        table[1, :2] = [4, 5]
    starts = np.array([10, 0], np.int32)[:num_rows]
    return q, k_pages, v_pages, table, starts


@pytest.mark.parametrize(
    "head_type,hq,hkv,head_dim,width",
    [(name, hq, hkv, 16, w) for name, hq, hkv in HEAD_TYPES for w in (8, 24)]
    + [("gqa", 8, 2, 80, 24)],
)
def test_paged_prefill_matches_pallas(head_type, hq, hkv, head_dim, width):
    q, k, v, table, starts = _prefill_fixtures(
        seed=2, width=width, q_heads=hq, kv_heads=hkv, head_dim=head_dim
    )
    scale = head_dim**-0.5
    ref = jax_prefill(*(jnp.asarray(a) for a in (q, k, v, table, starts)), scale)
    got = paged_prefill_attention(*(_t(a) for a in (q, k, v, table, starts)), scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------------- scatter, then attend


def test_decode_step_pool_matches_jax_pool():
    """The scatter before the decode kernel leaves the port's pool bit-identical to the
    JAX pool after `_paged_pallas_attention`, and the outputs agree."""
    q, k_pages, v_pages, table, lengths = _paged_fixtures(seed=3, width=2)
    rs = np.random.RandomState(9)
    new_k = rs.randn(4, 2, 2, 16).astype(np.float32)
    new_v = rs.randn(4, 2, 2, 16).astype(np.float32)
    cache = {"k": jnp.asarray(k_pages), "v": jnp.asarray(v_pages), "page_table": jnp.asarray(table)}
    ref_out, ref_cache = _paged_pallas_attention(
        jnp.asarray(q), jnp.asarray(new_k), jnp.asarray(new_v), cache, jnp.asarray(lengths), 0.25
    )
    kv = {"k": _t(k_pages), "v": _t(v_pages), "page_table": _t(table)}
    _scatter_chunk(_t(new_k), _t(new_v), kv, _t(lengths), None)
    out = paged_decode_attention(_t(q), kv["k"], kv["v"], kv["page_table"], _t(lengths), 0.25)
    np.testing.assert_array_equal(kv["k"].numpy(), np.asarray(ref_cache["k"]))
    np.testing.assert_array_equal(kv["v"].numpy(), np.asarray(ref_cache["v"]))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=1e-5, rtol=1e-5)


def test_prefill_step_pool_matches_jax_pool():
    """The chunk scatter (clamped positions, mask-derived pad-to-trash redirect) leaves
    the port's pool bit-identical to the JAX pool after `_paged_prefill_pallas_attention`."""
    q, k_pages, v_pages, table, starts = _prefill_fixtures(seed=4, num_rows=1, width=24)
    rs = np.random.RandomState(10)
    new_k = rs.randn(1, 24, 2, 16).astype(np.float32)
    new_v = rs.randn(1, 24, 2, 16).astype(np.float32)
    # the chunk's key-side mask: resident prefix + 20 real tokens, a 4-token pad tail
    mask = np.zeros((1, table.shape[1] * PAGE), np.int32)
    mask[0, : int(starts[0]) + 20] = 1
    cache = {"k": jnp.asarray(k_pages), "v": jnp.asarray(v_pages), "page_table": jnp.asarray(table[:1])}
    ref_out, ref_cache = _paged_prefill_pallas_attention(
        jnp.asarray(q), jnp.asarray(new_k), jnp.asarray(new_v), cache,
        jnp.asarray(int(starts[0]), jnp.int32), jnp.asarray(mask), 0.25,
    )
    kv = {"k": _t(k_pages), "v": _t(v_pages), "page_table": _t(table[:1])}
    start = torch.tensor(int(starts[0]), dtype=torch.int32)
    _scatter_chunk(_t(new_k), _t(new_v), kv, start, _t(mask))
    out = paged_prefill_attention(_t(q), kv["k"], kv["v"], kv["page_table"], start.reshape(1), 0.25)
    # the 4 pad-tail writes all land at flat index 0 of the trash page, where which one
    # wins is unspecified on either side; every other page must be bit-identical
    np.testing.assert_array_equal(kv["k"].numpy()[1:], np.asarray(ref_cache["k"])[1:])
    np.testing.assert_array_equal(kv["v"].numpy()[1:], np.asarray(ref_cache["v"])[1:])
    real = slice(0, 20)  # pad-tail rows attend garbage on both sides and are never read
    np.testing.assert_allclose(out.numpy()[:, real], np.asarray(ref_out)[:, real], atol=1e-5, rtol=1e-5)
