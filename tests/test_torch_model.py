"""The port's GPTDolomite against the JAX package's, with weights carried across.

A tiny JAX `GPTDolomiteForCausalLM` (2 layers, n_embd 32, 4 heads, gqa, rope, swiglu,
rmsnorm, no bias — `tests/ops/test_pallas_kernels._make_model`) and a learned-position /
layernorm / mha variant are initialised by flax, converted with ``np.asarray`` and loaded
into the port with `load_jax_params`. Logits must agree at fp32 atol = rtol = 1e-5 on a
full forward, and on a chunked-prefill step followed by a paged decode step (the JAX side
with all four Pallas kernel families on, in interpret mode).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from dolomite_engine_tpu.models.config import CommonConfig as JaxConfig
from dolomite_engine_tpu.models.gpt_dolomite import GPTDolomiteForCausalLM as JaxModel
from dolomite_engine_tpu.ops.pallas import kernel_overrides
from dolomite_engine_tpu_torch.models import CommonConfig, GPTDolomiteForCausalLM, load_jax_params

PAGE = 16
ALL_KERNELS = dict(rmsnorm="pallas", fused_rope_qkv="pallas", paged_attention="pallas", prefill_attention="pallas")

ROPE_GQA = dict(
    vocab_size=96, n_positions=512, n_embd=32, n_layer=2, n_head=4,
    num_key_value_heads=2, attention_head_type="gqa", position_embedding_type="rope",
    add_bias=False, activation_function="swiglu", normalization_function="rmsnorm",
    resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0,
    bos_token_id=0, eos_token_id=1, pad_token_id=2,
)
LEARNED_LAYERNORM = dict(
    ROPE_GQA, attention_head_type="mha", num_key_value_heads=None,
    position_embedding_type="learned_absolute", normalization_function="layernorm",
    activation_function="gelu_pytorch_tanh", add_bias=True, tie_word_embeddings=False,
)


def make_models(config_kwargs=ROPE_GQA, seed=0):
    """(jax model, jax params, port model with the same weights) on the CPU."""
    jax_model = JaxModel(config=JaxConfig(**config_kwargs))
    params = jax_model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    params_np = jax.tree.map(np.asarray, nn.unbox(params))
    model = GPTDolomiteForCausalLM(CommonConfig(**config_kwargs), device="cpu")
    load_jax_params(model, params_np, device="cpu")
    return jax_model, params, model


@pytest.mark.parametrize("config_kwargs", [ROPE_GQA, LEARNED_LAYERNORM], ids=["rope_gqa", "learned_layernorm"])
def test_full_forward_logits_match_jax(config_kwargs):
    jax_model, params, model = make_models(config_kwargs)
    ids = np.random.RandomState(0).randint(3, 96, (2, 12))
    ref = np.asarray(jax_model.apply({"params": params}, jnp.asarray(ids)).logits)
    with torch.no_grad():
        got = model(torch.from_numpy(ids)).logits.numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


def test_chunked_prefill_then_decode_logits_match_jax():
    """One 24-wide chunk (20 real tokens + pad tail, starting mid-page at 8 over a
    resident prefix) and then a decode step over two slots, one of them idle."""
    jax_model, params, model = make_models()
    config = model.config
    rs = np.random.RandomState(1)
    num_pages, max_pages = 12, 4
    k_pool = [rs.randn(num_pages, PAGE, 2, 8).astype(np.float32) for _ in range(2)]
    v_pool = [rs.randn(num_pages, PAGE, 2, 8).astype(np.float32) for _ in range(2)]
    table = np.array([[3, 5, 0, 0]], np.int32)
    start, real, width = 8, 20, 24
    ids = np.full((1, width), config.pad_token_id, np.int64)
    ids[0, :real] = rs.randint(3, 96, real)
    mask = np.zeros((1, max_pages * PAGE), np.int32)
    mask[0, : start + real] = 1
    positions = (start + np.arange(width))[None]

    with kernel_overrides(**ALL_KERNELS):
        jax_caches = [
            {"k": jnp.asarray(k), "v": jnp.asarray(v), "page_table": jnp.asarray(table)}
            for k, v in zip(k_pool, v_pool)
        ]
        ref = jax_model.apply(
            {"params": params}, jnp.asarray(ids), position_ids=jnp.asarray(positions),
            attention_mask=jnp.asarray(mask), kv_caches=jax_caches,
            cache_index=jnp.asarray(start, jnp.int32),
        )
    caches = [
        {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy()), "page_table": torch.from_numpy(table)}
        for k, v in zip(k_pool, v_pool)
    ]
    with torch.no_grad():
        out = model(
            torch.from_numpy(ids), position_ids=torch.from_numpy(positions),
            attention_mask=torch.from_numpy(mask), kv_caches=caches,
            cache_index=torch.tensor(start, dtype=torch.int32),
        )
    np.testing.assert_allclose(
        out.logits.numpy()[:, :real], np.asarray(ref.logits)[:, :real], atol=1e-5, rtol=1e-5
    )
    # the written K/V come out of each framework's projection + rope (ulp apart); the
    # scatter itself is bit-identical on identical inputs (tests/test_torch_kernels.py).
    # Page 0 (trash) takes the pad tail's colliding writes and is not compared.
    for layer, (a, b) in enumerate(zip(out.kv_caches, ref.kv_caches)):
        for name in ("k", "v"):
            np.testing.assert_allclose(
                a[name].numpy()[1:], np.asarray(b[name])[1:], atol=1e-6, rtol=1e-6,
                err_msg=f"layer {layer} {name}",
            )

    # decode: slot 0 continues at its frontier, slot 1 is idle (zeroed row, length 0)
    frontier = start + real
    dec_table = np.array([[3, 5, 7, 0], [0, 0, 0, 0]], np.int32)
    lengths = np.array([frontier, 0], np.int32)
    tokens = np.array([[int(np.argmax(out.logits.numpy()[0, real - 1]))], [2]], np.int64)
    with kernel_overrides(**ALL_KERNELS):
        jax_dec = [{**{k: v for k, v in c.items() if k != "page_table"}, "page_table": jnp.asarray(dec_table)} for c in ref.kv_caches]
        ref_dec = jax_model.apply(
            {"params": params}, jnp.asarray(tokens), position_ids=jnp.asarray(lengths)[:, None],
            kv_caches=jax_dec, cache_index=jnp.asarray(lengths),
        )
    dec = [{"k": c["k"], "v": c["v"], "page_table": torch.from_numpy(dec_table)} for c in out.kv_caches]
    with torch.no_grad():
        got_dec = model(
            torch.from_numpy(tokens), position_ids=torch.from_numpy(lengths)[:, None],
            kv_caches=dec, cache_index=torch.from_numpy(lengths),
        )
    np.testing.assert_allclose(
        got_dec.logits.numpy()[0], np.asarray(ref_dec.logits)[0], atol=1e-5, rtol=1e-5
    )


def test_seeded_init_follows_the_jax_rules():
    config = CommonConfig(**dict(ROPE_GQA, n_embd=64, n_head=4, n_layer=4, initializer_range=0.05))
    a = GPTDolomiteForCausalLM(config, device="cpu", seed=3)
    b = GPTDolomiteForCausalLM(config, device="cpu", seed=3)
    c = GPTDolomiteForCausalLM(config, device="cpu", seed=4)
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(), c.parameters()):
        assert torch.equal(pa, pb), name  # the seed fixes every weight
        if pa.ndim == 2:
            assert not torch.equal(pa, pc), name
    block = a.transformer.h[0]
    depth_scaled = 0.05 / math.sqrt(2 * config.n_layer)
    assert block.attn.c_attn.std == 0.05 and block.mlp.c_fc.std == 0.05
    assert block.attn.c_proj.std == depth_scaled and block.mlp.c_proj.std == depth_scaled
    assert abs(a.transformer.wte.weight.std().item() - 0.05) < 0.005
    assert abs(block.mlp.c_proj.weight.std().item() - depth_scaled) < 0.1 * depth_scaled
    assert torch.equal(block.ln_1.weight, torch.ones(64))  # norms start at 1
    mup = CommonConfig(**dict(ROPE_GQA, init_method="mup", m_width=4.0))
    mup_block = GPTDolomiteForCausalLM(mup, device="cpu").transformer.h[0]
    assert mup_block.attn.c_attn.std == mup.initializer_range / 2.0


def test_unported_position_type_raises():
    """No position type is left unported over a paged KV cache: an alibi model's prefill
    chunk and decode step no longer raise. The kernel gates carry the JAX term
    ``alibi_bias is None``, so both take the gathered path with the bias, and the logits
    are the JAX model's (its gates send alibi to the same path)."""
    jax_model, params, model = make_models(dict(ROPE_GQA, position_embedding_type="alibi"))
    rs = np.random.RandomState(4)
    pools = [[rs.randn(4, PAGE, 2, 8).astype(np.float32) for _ in range(2)] for _ in range(2)]
    table = np.array([[1, 2]], np.int32)
    mask = np.zeros((1, 2 * PAGE), np.int32)
    mask[0, :8] = 1
    steps = (
        (rs.randint(3, 96, (1, 8)), np.arange(8)[None], mask, np.int32(0)),  # a prefill chunk
        (rs.randint(3, 96, (1, 1)), np.array([[8]]), None, np.array([8], np.int32)),  # a decode step
    )
    caches = [{"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy()), "page_table": torch.from_numpy(table)} for k, v in pools]
    jax_caches = [{"k": jnp.asarray(k), "v": jnp.asarray(v), "page_table": jnp.asarray(table)} for k, v in pools]
    for ids, positions, step_mask, index in steps:
        with kernel_overrides(**ALL_KERNELS):
            ref = jax_model.apply(
                {"params": params}, jnp.asarray(ids), position_ids=jnp.asarray(positions),
                attention_mask=None if step_mask is None else jnp.asarray(step_mask), kv_caches=jax_caches,
                cache_index=jnp.asarray(index),
            )
        jax_caches = [{**c, "page_table": jnp.asarray(table)} for c in ref.kv_caches]
        with torch.no_grad():
            got = model(
                torch.from_numpy(ids), position_ids=torch.from_numpy(positions),
                attention_mask=None if step_mask is None else torch.from_numpy(step_mask), kv_caches=caches,
                cache_index=torch.as_tensor(index),
            ).logits
        np.testing.assert_allclose(got.numpy(), np.asarray(ref.logits), atol=1e-5, rtol=1e-5)


# the paged gates' JAX terms: a paged step with segment ids, or with attention dropout,
# leaves the kernels for the gather path (chunked prefill: scalar index and a 2-D prefix
# mask; decode: a [B] frontier vector)
GATE_STEPS = {
    "decode": ("paged_decode_attention", 1),
    "chunked_prefill": ("paged_prefill_attention", 8),
}


def _paged_step_inputs(step, seed=3):
    """Inputs of one paged step on fresh pools: ids, position ids, mask, caches and the
    cache index, as numpy arrays (cache_index [8] for decode, 8 for a chunk)."""
    rs = np.random.RandomState(seed)
    width = GATE_STEPS[step][1]
    pools = [[rs.randn(12, PAGE, 2, 8).astype(np.float32) for _ in range(2)] for _ in range(2)]
    table = np.array([[3, 5, 0, 0]], np.int32)
    ids = rs.randint(3, 96, (1, width))
    positions = (8 + np.arange(width))[None]
    if step == "decode":
        return ids, positions, None, pools, table, np.array([8], np.int32)
    mask = np.zeros((1, 4 * PAGE), np.int32)
    mask[0, : 8 + width] = 1
    return ids, positions, mask, pools, table, np.int32(8)


def _port_paged_step(model, step, **kwargs):
    ids, positions, mask, pools, table, index = _paged_step_inputs(step)
    caches = [
        {"k": torch.from_numpy(k), "v": torch.from_numpy(v), "page_table": torch.from_numpy(table)}
        for k, v in pools
    ]
    with torch.no_grad():
        return model(
            torch.from_numpy(ids), position_ids=torch.from_numpy(positions),
            attention_mask=None if mask is None else torch.from_numpy(mask), kv_caches=caches,
            cache_index=torch.as_tensor(index), **kwargs,
        ).logits


def _count_calls(monkeypatch, step):
    """Count the calls of the step's kernel wrapper as the model's attention calls it."""
    from dolomite_engine_tpu_torch.models import modeling_utils

    name = GATE_STEPS[step][0]
    wrapper = getattr(modeling_utils, name)
    calls = []

    def counted(*args, **kwargs):
        calls.append(name)
        return wrapper(*args, **kwargs)

    monkeypatch.setattr(modeling_utils, name, counted)
    return calls


@pytest.mark.parametrize("step", list(GATE_STEPS))
def test_paged_step_with_segment_ids_raises_as_jax_does(step):
    jax_model, params, model = make_models()
    ids, positions, mask, pools, table, index = _paged_step_inputs(step)
    segments = np.ones(ids.shape, np.int32)
    match = "packed segment attention with KV cache is not supported"
    with kernel_overrides(**ALL_KERNELS), pytest.raises(NotImplementedError, match=match):
        jax_model.apply(
            {"params": params}, jnp.asarray(ids), position_ids=jnp.asarray(positions),
            attention_mask=None if mask is None else jnp.asarray(mask),
            kv_caches=[{"k": jnp.asarray(k), "v": jnp.asarray(v), "page_table": jnp.asarray(table)} for k, v in pools],
            cache_index=jnp.asarray(index), segment_ids=jnp.asarray(segments),
        )
    with pytest.raises(NotImplementedError, match=match):
        _port_paged_step(model, step, segment_ids=torch.from_numpy(segments))


@pytest.mark.parametrize("step", list(GATE_STEPS))
def test_paged_step_with_attention_dropout_takes_the_gather_path(step, monkeypatch):
    _, _, model = make_models(dict(ROPE_GQA, attn_pdrop=0.9))
    calls = _count_calls(monkeypatch, step)
    torch.manual_seed(0)
    dropped = _port_paged_step(model, step, deterministic=False)
    assert calls == []
    kept = _port_paged_step(model, step)
    assert len(calls) == model.config.n_layer  # deterministic: the kernel's wrapper
    assert torch.isfinite(dropped).all()
    assert not torch.equal(dropped, kept)


@pytest.mark.parametrize("step", list(GATE_STEPS))
def test_paged_step_without_attention_dropout_is_deterministic(step, monkeypatch):
    _, _, model = make_models(dict(ROPE_GQA, attn_pdrop=0.0))
    calls = _count_calls(monkeypatch, step)
    stochastic = _port_paged_step(model, step, deterministic=False)
    assert len(calls) == model.config.n_layer  # a 0.0 rate keeps the kernel
    assert torch.equal(stochastic, _port_paged_step(model, step))


def test_load_jax_params_rejects_a_mismatched_tree():
    _, params, model = make_models()
    params_np = jax.tree.map(np.asarray, nn.unbox(params))
    params_np["transformer"]["h_0"]["attn"]["c_attn"]["kernel"] = np.zeros((32, 8), np.float32)
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(model, params_np, device="cpu")
