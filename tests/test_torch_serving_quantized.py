"""The port's `ServingEngine` over a quantized paged pool (``kv_dtype="int8"|"fp8"``),
against the JAX engine, on the CPU.

Greedy tokens must equal the JAX engine's token for token, for GPTDolomite and
MoEDolomite, with the prefix cache, chunked prefill and 2 slots for 3 requests active (the
prompts of `tests/test_torch_serving.py`). The JAX engine runs with every Pallas kernel
family on, the page encode included (interpret mode). The pool's contract under
quantization follows `tests/test_serving_quantized.py`: validation, the bytes per token,
COW tail pages whose scale rows stay with their codes, and prefix-chain reuse that gives
the cold path's tokens.
"""

import jax
import numpy as np
import pytest
import torch

from dolomite_engine_tpu.ops.pallas import kernel_overrides
from dolomite_engine_tpu.serving import ServingEngine as JaxServingEngine
from dolomite_engine_tpu_torch.models import CommonConfig, GPTDolomiteForCausalLM
from dolomite_engine_tpu_torch.serving import PagedKVCachePool, RequestStatus, ServingEngine, serve_batch
from tests.test_torch_model import ALL_KERNELS, ROPE_GQA, make_models
from tests.test_torch_moe_model import MOE, MOE_KERNELS, make_moe_models
from tests.test_torch_serving import ENGINE_ARGS, PAGE, _prompts

QUANT_KERNELS = dict(ALL_KERNELS, paged_kv_quant="pallas")


@pytest.fixture(scope="module")
def dense():
    return make_models(dict(ROPE_GQA, initializer_range=0.3))


def _jax_tokens(jax_model, params, prompts, max_new, kernels, **engine_args):
    with kernel_overrides(**kernels):
        engine = JaxServingEngine(jax_model, params, **dict(ENGINE_ARGS, **engine_args))
        states = [
            engine.submit(prompt_ids=p, max_new_tokens=max_new, rng=jax.random.PRNGKey(300 + i))
            for i, p in enumerate(prompts)
        ]
        engine.drain()
    return engine, [s.tokens for s in states]


def _check_against_jax(jax_model, params, model, kernels, kv_dtype):
    prompts = _prompts(model.config.vocab_size)
    max_new = 12
    jax_engine, want = _jax_tokens(jax_model, params, prompts, max_new, kernels, kv_dtype=kv_dtype)
    engine = ServingEngine(model, None, device="cpu", kv_dtype=kv_dtype, **ENGINE_ARGS)
    assert engine.pool.quantized and "k_scale" in engine.pool.caches[0]
    states = serve_batch(engine, [dict(prompt_ids=p, max_new_tokens=max_new) for p in prompts])
    for i, (state, tokens) in enumerate(zip(states, want)):
        assert state.status == RequestStatus.completed
        assert state.tokens == tokens, f"request {i} diverged"
        assert len(set(state.tokens)) > 3  # a varied stream, not one repeated token
    assert engine.stats.prefix_hit_tokens == jax_engine.stats.prefix_hit_tokens > 0
    assert engine.stats.prefill_chunks > len(prompts)
    assert engine.pool.num_free == engine.pool.num_slots


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_greedy_tokens_match_the_jax_engine(dense, kv_dtype):
    _check_against_jax(*dense, QUANT_KERNELS, kv_dtype)


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_moe_greedy_tokens_match_the_jax_engine(kv_dtype):
    _check_against_jax(
        *make_moe_models(dict(MOE, initializer_range=0.3)), dict(MOE_KERNELS, paged_kv_quant="pallas"), kv_dtype
    )


def test_bf16_pool_under_an_fp32_model_matches_the_jax_engine(dense):
    jax_model, params, model = dense
    prompts = _prompts(model.config.vocab_size)
    _, want = _jax_tokens(jax_model, params, prompts, 8, ALL_KERNELS, kv_dtype="bf16")
    engine = ServingEngine(model, None, device="cpu", kv_dtype="bf16", **ENGINE_ARGS)
    assert model.dtype == torch.float32 and engine.pool.caches[0]["k"].dtype == torch.bfloat16
    states = serve_batch(engine, [dict(prompt_ids=p, max_new_tokens=8) for p in prompts])
    assert [s.tokens for s in states] == want


def test_pool_validation_and_layout(dense):
    model = dense[2]
    with pytest.raises(ValueError, match="kv_dtype"):
        PagedKVCachePool(model, 2, 64, PAGE, kv_dtype="int4")
    pool = PagedKVCachePool(model, 2, 64, PAGE, kv_dtype="int8")
    cache = pool.caches[0]
    assert cache["k"].dtype == torch.int8 and cache["v"].dtype == torch.int8
    assert cache["k_scale"].shape == (pool.num_pages, cache["k"].shape[2])
    assert cache["k_scale"].dtype == torch.float32 and bool((cache["v_scale"] == 1).all())
    assert pool.quantized and pool.kv_dtype == "int8"
    fp8 = PagedKVCachePool(model, 2, 64, PAGE, kv_dtype="fp8")
    assert fp8.caches[0]["k"].dtype == torch.float8_e4m3fn
    bf16 = PagedKVCachePool(model, 2, 64, PAGE, kv_dtype="bf16")
    assert bf16.caches[0]["k"].dtype == torch.bfloat16 and not bf16.quantized
    assert "k_scale" not in bf16.caches[0]
    with pytest.raises(ValueError, match="paged"):
        ServingEngine(model, None, device="cpu", **dict(ENGINE_ARGS, paged=False, kv_dtype="int8"))


def test_kv_bytes_per_token_halves_twice(dense):
    """fp32 -> bf16 halves the page bytes; bf16 -> int8 (codes plus the scale rows
    amortised over the page) about halves them again."""
    model = dense[2]
    fp32 = PagedKVCachePool(model, 2, 64, PAGE)
    bf16 = PagedKVCachePool(model, 2, 64, PAGE, kv_dtype="bf16")
    int8 = PagedKVCachePool(model, 2, 64, PAGE, kv_dtype="int8")
    assert bf16.kv_bytes_per_token == fp32.kv_bytes_per_token / 2
    ratio = bf16.kv_bytes_per_token / int8.kv_bytes_per_token
    assert 1.8 <= ratio <= 2.0
    # 2 layers x K and V x 2 heads x (8 one-byte codes + 4 scale bytes / 16 tokens)
    assert int8.kv_bytes_per_token == 2 * 2 * 2 * (8 + 4 / PAGE)
    assert int8.page_bytes == int8.kv_bytes_per_token * PAGE


def _engine(model, **overrides):
    return ServingEngine(model, None, device="cpu", **dict(ENGINE_ARGS, kv_dtype="int8", **overrides))


def test_cow_tail_page_keeps_the_donors_codes_and_scales(dense):
    """The donor's page codes and its scale rows are both unchanged after a sharer
    decodes over its private copy (a scale-only change would decode the donor's codes
    differently)."""
    model = dense[2]
    rs = np.random.RandomState(21)
    vocab = model.config.vocab_size
    engine = _engine(model, max_len=64)
    shared = list(map(int, rs.randint(3, vocab, PAGE + 6)))
    prompt_a = shared + list(map(int, rs.randint(3, vocab, 3)))
    prompt_b = shared + list(map(int, rs.randint(3, vocab, 5)))

    serve_batch(engine, [dict(prompt_ids=prompt_a, max_new_tokens=12)])
    match = engine.prefix.match(prompt_b)
    assert len(match.nodes) == 1 and match.cow is not None
    donor = match.cow.page
    before = {
        name: engine.pool.caches[0][name][donor].view(torch.uint8 if name in "kv" else torch.int32).clone()
        for name in ("k", "v", "k_scale", "v_scale")
    }
    serve_batch(engine, [dict(prompt_ids=prompt_b, max_new_tokens=3)])
    for name, value in before.items():
        after = engine.pool.caches[0][name][donor]
        assert torch.equal(value, after.view(value.dtype)), name
    assert engine.stats.prefix_hit_tokens > 0


def test_copy_page_moves_the_scale_rows(dense):
    pool = PagedKVCachePool(dense[2], 2, 64, PAGE, kv_dtype="fp8")
    cache = pool.caches[1]
    cache["k"][3] = torch.full_like(cache["k"][3], 1.5, dtype=torch.float32).to(torch.float8_e4m3fn)
    cache["v_scale"][3] = 0.25
    pool.copy_page(3, 5)
    assert bool((cache["k"][5].float() == 1.5).all()) and bool((cache["v_scale"][5] == 0.25).all())


def test_prefix_chain_reuse_matches_the_cold_path(dense):
    """A prefix-cache hit over quantized pages gives the cold path's tokens: the resident
    (codes, scale) pairs decode to the K/V a full prefill would have written."""
    model = dense[2]
    rs = np.random.RandomState(13)
    vocab = model.config.vocab_size
    shared = list(map(int, rs.randint(3, vocab, 2 * PAGE)))
    tail = list(map(int, rs.randint(3, vocab, 5)))

    cold = _engine(model)
    cold_tokens = serve_batch(cold, [dict(prompt_ids=shared + tail, max_new_tokens=8)])[0].tokens
    assert cold.stats.prefix_hit_tokens == 0

    warm = _engine(model)
    serve_batch(warm, [dict(prompt_ids=shared + list(map(int, rs.randint(3, vocab, 4))), max_new_tokens=4)])
    state = serve_batch(warm, [dict(prompt_ids=shared + tail, max_new_tokens=8)])[0]
    assert warm.stats.prefix_hit_tokens >= 2 * PAGE
    assert state.tokens == cold_tokens


def test_bf16_model_over_an_int8_pool_serves():
    """A bf16 model over a quantized pool: the dequantized pages are rounded to bf16, as
    the decode kernel rounds them."""
    model = GPTDolomiteForCausalLM(CommonConfig(**dict(ROPE_GQA, initializer_range=0.3)), dtype=torch.bfloat16, device="cpu")
    engine = ServingEngine(model, None, device="cpu", kv_dtype="int8", **ENGINE_ARGS)
    states = serve_batch(engine, [dict(prompt_ids=p, max_new_tokens=6) for p in _prompts(ROPE_GQA["vocab_size"])])
    assert all(s.status == RequestStatus.completed and len(s.tokens) == 6 for s in states)
    assert engine.pool.num_free == engine.pool.num_slots
