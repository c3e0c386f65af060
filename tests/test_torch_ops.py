"""The port's plain ops against the JAX package's, in fp32 on the CPU.

Normalization, activations, rotary tables (with and without YaRN), the attention mask
with a per-row ``[B]`` offset, eager attention, the paged scatter and gather, and the
vectorized logits processors. Inputs come from `np.random.RandomState` and go to both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dolomite_engine_tpu.ops import activations as jax_act
from dolomite_engine_tpu.ops import attention as jax_attn
from dolomite_engine_tpu.ops import normalization as jax_norm
from dolomite_engine_tpu.ops import rope as jax_rope
from dolomite_engine_tpu.ops import sampling as jax_sampling
from dolomite_engine_tpu_torch.ops import activations, attention, normalization, rope, sampling


def _t(x):
    return torch.from_numpy(np.array(x))


def test_rmsnorm_and_layernorm_match_jax():
    rs = np.random.RandomState(0)
    x = rs.randn(3, 5, 48).astype(np.float32) * 3.0
    w = rs.randn(48).astype(np.float32)
    b = rs.randn(48).astype(np.float32)
    np.testing.assert_allclose(
        normalization.rmsnorm(_t(x), _t(w), 1e-5).numpy(),
        np.asarray(jax_norm.rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-5)),
        rtol=1e-6, atol=1e-6,
    )
    np.testing.assert_allclose(
        normalization.layernorm(_t(x), _t(w), _t(b), 1e-5).numpy(),
        np.asarray(jax_norm.layernorm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 1e-5)),
        rtol=1e-5, atol=1e-5,
    )
    with pytest.raises(ValueError):
        normalization.check_normalization_function("batchnorm")


@pytest.mark.parametrize(
    "name",
    sorted(jax_act._BASE_ACTIVATIONS) + ["swiglu", "geglu", "reglu", "glu", "silu_glu"],
)
def test_activations_match_jax(name):
    x = (np.random.RandomState(1).randn(4, 64) * 3.0).astype(np.float32)
    got = activations.get_activation_function(name)(_t(x)).numpy()
    ref = np.asarray(jax_act.get_activation_function(name)(jnp.asarray(x)))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize(
    "scaling",
    [None, {"type": "yarn", "factor": 4.0, "original_max_position_embeddings": 8}],
)
def test_cos_sin_match_jax(scaling):
    ref_params = jax_rope.RoPEParams.from_config(80, base=10000, rope_scaling=scaling, max_position_embeddings=64)
    params = rope.RoPEParams.from_config(80, base=10000, rope_scaling=scaling, max_position_embeddings=64)
    np.testing.assert_array_equal(params.inv_freq, ref_params.inv_freq)
    assert params.mscale == ref_params.mscale
    pos = np.arange(40)[None, :] + np.array([[0], [7]])
    ref_cos, ref_sin = jax_rope.get_cos_sin(ref_params, jnp.asarray(pos))
    cos, sin = rope.get_cos_sin(params, _t(pos))
    # cos/sin of the same fp32 angles; the two libraries' libm differ by an ulp
    np.testing.assert_allclose(cos.numpy(), np.asarray(ref_cos), rtol=0, atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(ref_sin), rtol=0, atol=1e-6)


def test_split_qkv_apply_rope_matches_jax():
    hq, hkv, d = 4, 2, 16
    rs = np.random.RandomState(2)
    qkv = rs.randn(2, 6, (hq + 2 * hkv) * d).astype(np.float32)
    params = jax_rope.RoPEParams.from_config(d)
    cos, sin = jax_rope.get_cos_sin(params, jnp.arange(6)[None])
    ref = jax_rope.split_qkv_apply_rope(jnp.asarray(qkv), hq, hkv, d, (cos, sin))
    got = rope.split_qkv_apply_rope(_t(qkv), hq, hkv, d, (_t(cos), _t(sin)))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)
    # without rope the split alone, bit for bit
    for a, b in zip(
        rope.split_qkv_apply_rope(_t(qkv), hq, hkv, d, None),
        jax_rope.split_qkv_apply_rope(jnp.asarray(qkv), hq, hkv, d, None),
    ):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("with_pad", [False, True])
def test_attention_mask_with_row_offsets_matches_jax(with_pad):
    offsets = np.array([0, 5, 17], np.int32)
    pad = (np.random.RandomState(3).rand(3, 24) > 0.2).astype(np.int32) if with_pad else None
    ref = jax_attn.make_attention_mask(
        3, 4, 24, causal=True, attention_mask=None if pad is None else jnp.asarray(pad),
        query_offset=jnp.asarray(offsets),
    )
    got = attention.make_attention_mask(
        3, 4, 24, causal=True, attention_mask=None if pad is None else _t(pad),
        query_offset=_t(offsets),
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # a scalar offset broadcasts the same frontier to every row
    np.testing.assert_array_equal(
        attention.make_attention_mask(2, 3, 8, query_offset=2).numpy(),
        np.asarray(jax_attn.make_attention_mask(2, 3, 8, query_offset=2)),
    )


@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (4, 1)])
def test_eager_attention_matches_jax(hq, hkv):
    rs = np.random.RandomState(4)
    q = rs.randn(2, 5, hq, 16).astype(np.float32)
    k = rs.randn(2, 9, hkv, 16).astype(np.float32)
    v = rs.randn(2, 9, hkv, 16).astype(np.float32)
    offsets = np.array([2, 4], np.int32)
    jmask = jax_attn.make_attention_mask(2, 5, 9, query_offset=jnp.asarray(offsets))
    ref = jax_attn.eager_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jmask, None, 0.25)
    mask = attention.make_attention_mask(2, 5, 9, query_offset=_t(offsets))
    got = attention.eager_attention(_t(q), _t(k), _t(v), mask, 0.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_paged_scatter_and_gather_match_jax():
    rs = np.random.RandomState(5)
    pages = rs.randn(8, 16, 2, 4).astype(np.float32)
    table = np.array([[1, 2, 0], [3, 0, 0], [0, 0, 0]], np.int32)  # row 2 idle: all trash
    positions = np.array([[14, 15, 16], [0, 1, 2], [0, 1, 2]], np.int32)
    valid = np.array([[True, True, True], [True, True, False], [True, True, True]])
    new = rs.randn(3, 3, 2, 4).astype(np.float32)
    ref = jax_attn.paged_scatter_kv(
        jnp.asarray(pages), jnp.asarray(new), jnp.asarray(table), jnp.asarray(positions), jnp.asarray(valid)
    )
    got = attention.paged_scatter_kv(_t(pages), _t(new), _t(table), _t(positions), _t(valid))
    # every page but the trash page is exact; trash (page 0) takes colliding garbage
    np.testing.assert_array_equal(got.numpy()[1:], np.asarray(ref)[1:])
    np.testing.assert_array_equal(
        attention.paged_gather_kv(got, _t(table)).numpy(),
        np.asarray(jax_attn.paged_gather_kv(jnp.asarray(got.numpy()), jnp.asarray(table))),
    )


def test_logits_processors_match_jax():
    rs = np.random.RandomState(6)
    logits = rs.randn(4, 50).astype(np.float32) * 2.0
    temperature = np.array([1.0, 0.7, 1.3, 0.5], np.float32)
    top_k = np.array([0, 5, 0, 50], np.int32)
    top_p = np.array([1.0, 1.0, 0.8, 0.6], np.float32)
    ref = jax_sampling.process_logits_vectorized(
        jnp.asarray(logits), jnp.asarray(temperature), jnp.asarray(top_k), jnp.asarray(top_p)
    )
    got = sampling.process_logits_vectorized(_t(logits), _t(temperature), _t(top_k), _t(top_p))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    assert sampling.encode_sampling_params(True, None, 5, None) == jax_sampling.encode_sampling_params(
        True, None, 5, None
    )


def test_sampling_greedy_rows_take_the_first_maximum_and_sampled_rows_follow_their_generator():
    logits = torch.tensor([[0.0, 3.0, 3.0, 1.0], [5.0, 1.0, 0.0, 5.0], [0.0, 0.0, 9.0, 0.0]])
    ones, zeros = torch.ones(3), torch.zeros(3, dtype=torch.int32)
    greedy = sampling.sample_tokens_vectorized(logits, [None] * 3, [False] * 3, ones, zeros, ones)
    assert greedy.tolist() == [1, 0, 2]
    assert greedy.tolist() == np.asarray(jnp.argmax(jnp.asarray(logits.numpy()), -1)).tolist()

    def draw(seed):
        gens = [None, torch.Generator().manual_seed(seed), None]
        return sampling.sample_tokens_vectorized(
            torch.randn(3, 1000, generator=torch.Generator().manual_seed(0)),
            gens, [False, True, False], ones, zeros, ones,
        )

    assert draw(7).tolist() == draw(7).tolist()  # reproducible per request seed
    assert len({draw(s)[1].item() for s in range(8)}) > 1  # and actually random
    # top-k 1 leaves one candidate (ties aside): sampling collapses onto the argmax
    distinct = torch.tensor([[0.0, 3.0, 2.0, 1.0], [5.0, 1.0, 0.0, 4.0], [0.0, 0.0, 9.0, 0.0]])
    top1 = sampling.sample_tokens_vectorized(
        distinct, [torch.Generator().manual_seed(3)] * 3, [True] * 3, ones,
        torch.ones(3, dtype=torch.int32), ones,
    )
    assert top1.tolist() == [1, 0, 2]
