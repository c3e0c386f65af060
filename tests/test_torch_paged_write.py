"""The serving K/V write of the paged kernel branches against the JAX package, on the CPU.

On the decode and prefill kernel branches the port rotates the fused projection and
writes K/V into the paged pool in one call, `ops/kernels/rope_qkv.rope_qkv_paged` (over a
quantized pool followed by `ops/attention.paged_scatter_kv_quantized`, the fused
scatter-quantize); on the CPU both take their plain versions. Held here, from numpy inputs
made from seeds, against the JAX package's `fused_rope_qkv` (the Pallas kernel in
interpret mode) and `_update_paged_kv_cache` (its `paged_scatter_kv`, and
`paged_scatter_kv_quantized` under ``kernel_overrides(paged_kv_quant="xla")`` and
``"pallas"``):

- the rotated query and K within 2 fp32 ulp of the larger of the two products (the
  lowerings contract the multiply-add chain differently), V bit for bit;
- the pool after the write: pages 1.. and their scales bit for bit (page 0 is the trash
  page, never compared), the JAX scatter fed the port's rotated K and V;

over decode windows with [B] frontiers (mid-page, on a page boundary, an idle row with an
all-0 table, a row at the view's last page), a K+1 verify window straddling a page and
one running past the view, a prefill chunk at a scalar start with a masked pad tail and a
chunk running past the view; GQA at head dim 64 and MHA at 80; fp32 rows into fp32, bf16
(cast on store), int8 and fp8 pools whose stale rows are their pages' largest. Also: the
model's paged branches compute what the split, the rotation and the plain scatter compute,
and `chip_smoke.paged_write_check` runs at a tiny size.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dolomite_engine_tpu.models.modeling_utils import _update_paged_kv_cache as jax_update_paged
from dolomite_engine_tpu.ops.kv_quant import KV_QUANT_DTYPES as JAX_KV_QUANT_DTYPES
from dolomite_engine_tpu.ops.kv_quant import quantize_pages_xla
from dolomite_engine_tpu.ops.pallas import kernel_overrides
from dolomite_engine_tpu.ops.pallas.rope_qkv import fused_rope_qkv as jax_rope_qkv
from dolomite_engine_tpu.ops.rope import RoPEParams as JaxRoPEParams
from dolomite_engine_tpu.ops.rope import get_cos_sin as jax_cos_sin
from dolomite_engine_tpu_torch.models import CommonConfig, GPTDolomiteForCausalLM, modeling_utils
from dolomite_engine_tpu_torch.ops.attention import (
    paged_gather_kv,
    paged_scatter_kv,
    paged_write_kv_quantized_plain,
    write_positions,
)
from dolomite_engine_tpu_torch.ops.kernels import KERNELS, reset_launch_counts
from dolomite_engine_tpu_torch.ops.kernels._build import window_args
from dolomite_engine_tpu_torch.ops.kernels.paged_attention import paged_decode_attention
from dolomite_engine_tpu_torch.ops.kernels.prefill_attention import paged_prefill_attention
from dolomite_engine_tpu_torch.ops.kernels.rope_qkv import rope_qkv_paged
from dolomite_engine_tpu_torch.ops.kv_quant import KV_QUANT_DTYPES
from dolomite_engine_tpu_torch.ops.rope import split_qkv_apply_rope

PAGE = 16
MAX_PAGES = 4  # a 64-position view
NUM_PAGES = 12

# name -> (page table [B, MAX_PAGES], cache index: a [B] list or a scalar start, S, the
# chunk's real rows for its key mask or None)
WINDOWS = {
    # row 0 mid-page, row 1's frontier on a page boundary, row 2 idle (all-0 table), row 3
    # on the view's last page (its window's second page is past the table)
    "decode": ([[3, 5, 0, 0], [7, 9, 0, 0], [0, 0, 0, 0], [1, 2, 4, 6]], [21, 16, 0, 60], 1, None),
    # K+1 windows: one straddling a page boundary, one running 3 positions past the view
    "verify": ([[3, 5, 6, 0], [1, 2, 4, 8]], [14, 61], 5, None),
    # a chunk at a scalar start mid-page over a resident prefix: 20 real rows, 4 pad rows
    "prefill": ([[3, 5, 6, 0]], 10, 24, 20),
    # a chunk whose last 8 positions fall past the view
    "past_view": ([[3, 5, 6, 8]], 48, 24, 24),
}
HEADS = {"gqa_64": (4, 2, 64), "mha_80": (2, 2, 80)}
POOLS = ["fp32", "bf16", "int8", "fp8"]


def _t(x):
    return torch.from_numpy(np.array(x))


def _bytes(array) -> np.ndarray:
    """The raw bytes of a torch or numpy pool (codes, bf16 or fp32 values, scales)."""
    if isinstance(array, torch.Tensor):
        array = array.contiguous()
        size = array.element_size()
        return array.view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[size]).numpy()
    array = np.asarray(array)
    return array.view({1: np.uint8, 2: np.int16, 4: np.int32}[array.itemsize])


def _window(name, hq, hkv, head_dim, seed=0):
    """qkv [B, S, (Hq + 2 Hkv) D] fp32, cos / sin [B or 1, S, D] of the JAX package's
    rope at the window's positions, the table, the cache index and the key mask (numpy)."""
    table, index, seq, real = WINDOWS[name]
    table = np.asarray(table, np.int32)
    batch = table.shape[0]
    rs = np.random.RandomState(seed)
    qkv = rs.randn(batch, seq, (hq + 2 * hkv) * head_dim).astype(np.float32)
    index = np.asarray(index, np.int32)
    positions = index.reshape(-1, 1) + np.arange(seq)[None, :]
    cos, sin = (np.asarray(a) for a in jax_cos_sin(JaxRoPEParams.from_config(head_dim), jnp.asarray(positions)))
    mask = None
    if real is not None:
        mask = np.zeros((batch, MAX_PAGES * PAGE), np.int32)
        mask[:, : min(int(index) + real, MAX_PAGES * PAGE)] = 1
    return qkv, cos, sin, table, index, mask


def _pool(pool, hkv, head_dim, seed):
    """K and V pools (numpy; codes with fp32 scales for a quantized pool) of random pages
    whose second half is 10x the first: stale rows past a frontier are their pages'
    largest, so an absmax over them would set another scale."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(2):
        values = rs.randn(NUM_PAGES, PAGE, hkv, head_dim).astype(np.float32)
        values[:, PAGE // 2 :] *= 10.0
        if pool == "fp32":
            out.append((values, None))
        elif pool == "bf16":
            out.append((np.asarray(jnp.asarray(values).astype(jnp.bfloat16)), None))
        else:
            storage, qmax = JAX_KV_QUANT_DTYPES[pool]
            codes, scales = quantize_pages_xla(jnp.asarray(values), jnp.ones(values.shape[:2], bool), qmax, storage)
            out.append((np.asarray(codes), np.asarray(scales)))
    return out


def _torch_pages(pages, pool):
    if pool == "bf16":
        return torch.from_numpy(np.array(jnp.asarray(pages).astype(jnp.float32))).to(torch.bfloat16)
    if pool in KV_QUANT_DTYPES:
        return torch.from_numpy(np.ascontiguousarray(pages).view(np.uint8).copy()).view(KV_QUANT_DTYPES[pool][0])
    return torch.from_numpy(pages.copy())


def _ulp_close(got, want, qkv, heads, head_dim):
    """|got - want| within 2 fp32 ulp of the larger of the two products of each rotated
    element (|x| + |x's partner|)."""
    x = qkv[..., : heads * head_dim].reshape(qkv.shape[:2] + (heads, head_dim))
    scale = (np.abs(x) + np.abs(np.roll(x, head_dim // 2, axis=-1))).astype(np.float32).reshape(np.shape(want))
    return np.all(np.abs(np.asarray(got) - np.asarray(want)) <= 2 * np.spacing(scale))


@pytest.mark.parametrize("pool", POOLS)
@pytest.mark.parametrize("heads", list(HEADS))
@pytest.mark.parametrize("window", list(WINDOWS))
def test_paged_write_matches_jax(window, heads, pool):
    hq, hkv, head_dim = HEADS[heads]
    qkv, cos, sin, table, index, mask = _window(window, hq, hkv, head_dim)
    batch, seq = qkv.shape[:2]
    mask_t = None if mask is None else _t(mask)

    # the rotation: the split form the fused scatter-quantize consumes, against jax's kernel
    ref = np.asarray(jax_rope_qkv(jnp.asarray(qkv), jnp.asarray(cos), jnp.asarray(sin), hq, hkv, head_dim, interpret=True))
    query, key, value = rope_qkv_paged(_t(qkv), _t(cos), _t(sin), hq, hkv, head_dim, None, None, _t(table), _t(index), mask_t)
    ref_q, ref_k, ref_v = np.split(ref, [hq * head_dim, (hq + hkv) * head_dim], axis=-1)
    assert query.is_contiguous() and key.is_contiguous() and value.is_contiguous()
    assert _ulp_close(query.reshape(batch, seq, -1).numpy(), ref_q, qkv, hq, head_dim)
    assert _ulp_close(key.reshape(batch, seq, -1).numpy(), ref_k, qkv[..., hq * head_dim :], hkv, head_dim)
    np.testing.assert_array_equal(value.reshape(batch, seq, -1).numpy(), ref_v)

    # the write through the model's paged branch, against jax's fed the port's rotated K / V
    (k_pages, k_scales), (v_pages, v_scales) = _pool(pool, hkv, head_dim, seed=1)
    kv = {"k": _torch_pages(k_pages, pool), "v": _torch_pages(v_pages, pool), "page_table": _t(table)}
    jax_cache = {"k": jnp.asarray(k_pages), "v": jnp.asarray(v_pages), "page_table": jnp.asarray(table)}
    if k_scales is not None:
        kv.update(k_scale=_t(k_scales), v_scale=_t(v_scales))
        jax_cache.update(k_scale=jnp.asarray(k_scales), v_scale=jnp.asarray(v_scales))
    before = {name: _bytes(tensor).copy() for name, tensor in kv.items()}
    got_query = modeling_utils._paged_write(_t(qkv), (_t(cos), _t(sin)), hq, hkv, head_dim, kv, _t(index), mask_t)
    assert torch.equal(got_query, query)
    for backend in (["xla", "pallas"] if k_scales is not None else ["xla"]):
        with kernel_overrides(paged_kv_quant=backend):
            _, _, ref_cache, _, _ = jax_update_paged(
                jnp.asarray(key.numpy()), jnp.asarray(value.numpy()), jax_cache, jnp.asarray(index),
                None if mask is None else jnp.asarray(mask),
            )
        for name in ("k", "v", "k_scale", "v_scale"):
            if name in kv:
                np.testing.assert_array_equal(_bytes(kv[name])[1:], _bytes(ref_cache[name])[1:], err_msg=f"{name} {backend}")
    # the pages the window writes changed; no other page did
    written = {int(p) for p in np.unique(table) if p}
    changed = {p for p in range(1, NUM_PAGES) if not np.array_equal(_bytes(kv["k"])[p], before["k"][p])}
    assert changed and changed <= written


def _tiny_model(kv_heads, dtype=torch.float32):
    config = CommonConfig(
        vocab_size=64, n_positions=256, n_embd=32, n_layer=1, n_head=4, num_key_value_heads=kv_heads,
        attention_head_type="gqa" if kv_heads < 4 else "mha", position_embedding_type="rope",
        add_bias=False, activation_function="swiglu", normalization_function="rmsnorm",
        resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0, initializer_range=0.3,
    )
    return GPTDolomiteForCausalLM(config, dtype=dtype, device="cpu", seed=3)


@pytest.mark.parametrize("pool", ["model", "bf16", "int8", "fp8"])
@pytest.mark.parametrize("branch", ["decode", "prefill"])
def test_paged_branches_compute_the_split_rotation_and_scatter(branch, pool):
    """Attention.forward on the decode / prefill kernel branch against the same layer
    through the split, the rotation and the plain scatter, then the attention function:
    the output and the pool bit for bit (the CPU path takes today's operations)."""
    model = _tiny_model(kv_heads=2)
    attn = model.transformer.h[0].attn
    hq, hkv, head_dim = attn.num_heads, attn.num_kv_heads, attn.head_dim
    rs = np.random.RandomState(4)
    if branch == "decode":
        table, index, seq, real = WINDOWS["decode"]
        index_t = _t(np.asarray(index, np.int32))
        mask = None
    else:
        table, index, seq, real = WINDOWS["prefill"]
        index_t = torch.tensor(index, dtype=torch.int32)
        mask = torch.zeros((1, MAX_PAGES * PAGE), dtype=torch.int32)
        mask[0, : index + real] = 1
    table = _t(np.asarray(table, np.int32))
    batch = table.shape[0]
    hidden = torch.from_numpy(rs.randn(batch, seq, 32).astype(np.float32))
    positions = index_t.reshape(-1, 1) + torch.arange(seq)[None]
    rope = modeling_utils.get_cos_sin(model.transformer.rope_params, positions, torch.float32)
    kv_dtype = {"model": torch.float32, "bf16": torch.bfloat16}.get(pool)
    pools = _pool("fp32" if pool == "model" else pool, hkv, head_dim, seed=5)
    caches = []
    for _ in range(2):
        cache = {
            "k": _torch_pages(pools[0][0], pool if pool != "model" else "fp32"),
            "v": _torch_pages(pools[1][0], pool if pool != "model" else "fp32"),
            "page_table": table,
        }
        if kv_dtype is not None:
            cache["k"], cache["v"] = cache["k"].to(kv_dtype), cache["v"].to(kv_dtype)
        if pools[0][1] is not None:
            cache.update(k_scale=_t(pools[0][1]), v_scale=_t(pools[1][1]))
        caches.append(cache)
    got_cache, want_cache = caches
    with torch.no_grad():
        got, _ = attn(hidden, mask, rope, None, got_cache, index_t)
        qkv = attn.c_attn(hidden)
        query, key, value = split_qkv_apply_rope(qkv, hq, hkv, head_dim, rope)
        if "k_scale" in want_cache:
            paged_write_kv_quantized_plain(
                want_cache["k"], want_cache["v"], want_cache["k_scale"], want_cache["v_scale"], key, value,
                table, index_t, mask,
            )
        else:
            positions_, valid = write_positions(index_t, mask, MAX_PAGES * PAGE, batch, seq, hidden.device)
            paged_scatter_kv(want_cache["k"], key, table, positions_, valid)
            paged_scatter_kv(want_cache["v"], value, table, positions_, valid)
        scale = modeling_utils.get_softmax_scale(model.config, head_dim)
        scales = (want_cache.get("k_scale"), want_cache.get("v_scale"))
        if branch == "decode":
            out = paged_decode_attention(query.contiguous(), want_cache["k"], want_cache["v"], table, index_t, scale, *scales)
        else:
            out = paged_prefill_attention(
                query.contiguous(), want_cache["k"], want_cache["v"], table, index_t.reshape(1), scale, *scales
            )
        want = attn._project_out(out, True)
    assert torch.equal(got, want)
    for name in got_cache:
        assert torch.equal(_t(_bytes(got_cache[name])), _t(_bytes(want_cache[name]))), name


def test_paged_write_without_rope_splits_and_scatters():
    """No cos/sin (a learned-position model): the query is the projection's Q block and the
    pool gets the unrotated K / V rows."""
    hq, hkv, head_dim = HEADS["gqa_64"]
    qkv, _, _, table, index, _ = _window("decode", hq, hkv, head_dim)
    pools = [torch.zeros((NUM_PAGES, PAGE, hkv, head_dim)) for _ in range(2)]
    query, _, _ = rope_qkv_paged(_t(qkv), None, None, hq, hkv, head_dim, *pools, _t(table), _t(index))
    np.testing.assert_array_equal(query.reshape(qkv.shape[0], 1, -1).numpy(), qkv[..., : hq * head_dim])
    view = paged_gather_kv(pools[0], _t(table))
    np.testing.assert_array_equal(view[0, 21].reshape(-1).numpy(), qkv[0, 0, hq * head_dim : (hq + hkv) * head_dim])


def test_launch_forms_count_and_reset():
    from dolomite_engine_tpu_torch.ops.kernels import kv_quant, rope_qkv

    reset_launch_counts()
    rope_qkv.KERNEL.launched("paged")
    rope_qkv.KERNEL.launched("paged")
    kv_quant.KERNEL.launched("scatter")
    assert rope_qkv.KERNEL.launches == 2 and rope_qkv.KERNEL.forms == {"paged": 2}
    assert kv_quant.KERNEL.forms == {"scatter": 1}
    reset_launch_counts()
    assert all(spec.launches == 0 and not spec.forms for spec in KERNELS)


def test_window_args_name_the_window_and_refuse_what_the_kernels_do_not_take():
    cpu = torch.device("cpu")
    lengths = torch.tensor([3, 7], dtype=torch.int32)
    assert window_args(lengths, None, 2, 64, cpu)[:5] == (1, lengths, 1, 0, 0)
    assert window_args(5, None, 1, 64, cpu)[:4] == (0, None, 0, 5)
    start = torch.tensor(9, dtype=torch.int64)
    mask = torch.ones((1, 64), dtype=torch.bool)
    assert window_args(start, mask, 1, 64, cpu) == (2, start, 0, 0, 2, mask, 64)
    with pytest.raises(ValueError, match="cache index"):
        window_args(lengths.float(), None, 2, 64, cpu)
    with pytest.raises(ValueError, match=r"\[3\] or 0-d"):
        window_args(lengths, None, 3, 64, cpu)
    with pytest.raises(ValueError, match="key mask"):
        window_args(start, torch.ones((1, 32), dtype=torch.int32), 1, 64, cpu)
    with pytest.raises(ValueError, match="key mask"):
        window_args(start, torch.ones((1, 64)), 1, 64, cpu)


def test_chip_smoke_paged_write_check_runs_at_a_tiny_size_on_the_cpu():
    """`chip_smoke.paged_write_check`'s control flow (the paged form swapped for the flat
    rope + plain scatter) on the CPU, where both sides take the plain versions."""
    import chip_smoke

    tiny = dict(chip_smoke.GRANITE_3B_CODE, vocab_size=256, n_embd=32, n_layer=1, n_head=2, n_inner=64)
    model = GPTDolomiteForCausalLM(CommonConfig(**tiny), dtype=torch.bfloat16, device="cpu")
    tokens = np.random.RandomState(0).randint(1, 256, 70).tolist()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        check = chip_smoke.paged_write_check(model, tokens, 66)
    finally:
        torch.set_num_threads(threads)
    assert check["layer0_pool_bytes_identical"] and check["layers_with_identical_pool_bytes"] == 1
    assert check["logits_max_abs_diff"] == 0.0 and check["pool_dtype"] == "bfloat16"
