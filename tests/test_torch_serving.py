"""The serving slice as a whole: the port's `ServingEngine` against the JAX engine.

The prompts of `tests/ops/test_pallas_kernels.test_engine_prefill_kernel_parity_and_compile_once`:
a shared 2-page prefix so the prefix cache hits, a 41-token prompt across several
16-token chunks, 2 slots for 3 requests. The JAX engine runs with all four Pallas kernel
families on (interpret mode); the port runs on the CPU. Greedy tokens must be equal token
for token. The tiny model is initialised with ``initializer_range=0.3`` so its greedy
streams vary from token to token (at the default 0.02 they repeat one token, which would
make the comparison weak).
"""

import jax
import numpy as np
import pytest
import torch
from flax import linen as nn

from dolomite_engine_tpu.ops.pallas import kernel_overrides
from dolomite_engine_tpu.serving import ServingEngine as JaxServingEngine
from dolomite_engine_tpu_torch.models import CommonConfig, GPTDolomiteForCausalLM
from dolomite_engine_tpu_torch.serving import (
    QueueFullError,
    RequestStatus,
    SamplingParams,
    ServingEngine,
    serve_batch,
)
from tests.test_torch_model import ALL_KERNELS, ROPE_GQA, make_models

PAGE = 16
ENGINE_ARGS = dict(
    num_slots=2, max_len=128, prefill_bucket_multiple=8, eos_token_id=None,
    pad_token_id=ROPE_GQA["pad_token_id"], page_size=PAGE, prefill_chunk_tokens=16,
)


def _prompts(vocab):
    rs = np.random.RandomState(7)
    shared = list(map(int, rs.randint(3, vocab, 2 * PAGE)))
    return [
        shared + list(map(int, rs.randint(3, vocab, 5))),
        list(map(int, rs.randint(3, vocab, 41))),
        shared + list(map(int, rs.randint(3, vocab, 9))),
    ]


@pytest.fixture(scope="module")
def models():
    return make_models(dict(ROPE_GQA, initializer_range=0.3))


def test_greedy_tokens_match_the_jax_engine(models):
    jax_model, params, model = models
    prompts = _prompts(ROPE_GQA["vocab_size"])
    max_new = 12
    with kernel_overrides(**ALL_KERNELS):
        jax_engine = JaxServingEngine(jax_model, params, **ENGINE_ARGS)
        jax_states = [
            jax_engine.submit(prompt_ids=p, max_new_tokens=max_new, rng=jax.random.PRNGKey(300 + i))
            for i, p in enumerate(prompts)
        ]
        jax_engine.drain()

    engine = ServingEngine(model, None, device="cpu", **ENGINE_ARGS)
    states = serve_batch(engine, [dict(prompt_ids=p, max_new_tokens=max_new) for p in prompts])

    for i, (ref, got) in enumerate(zip(jax_states, states)):
        assert got.status == RequestStatus.completed
        assert got.tokens == ref.tokens, f"request {i} diverged"
        assert len(set(got.tokens)) > 3  # a varied stream, not one repeated token
    assert jax_engine.stats.prefix_hit_tokens > 0
    assert engine.stats.prefix_hit_tokens == jax_engine.stats.prefix_hit_tokens
    assert engine.stats.prefill_tokens == jax_engine.stats.prefill_tokens
    assert engine.stats.decode_tokens == jax_engine.stats.decode_tokens
    assert engine.pool.num_free == engine.pool.num_slots  # every slot free after drain
    assert jax_engine.pool.num_free == jax_engine.pool.num_slots
    assert engine.stats.prefill_chunks > len(prompts)  # the 41-token prompt took several chunks
    assert engine.stats.prefill_tok_s() > 0 and engine.stats.decode_tok_s() > 0
    assert engine.stats.mean_ttft_s() is not None


def test_jax_params_load_through_the_engine(models):
    """`ServingEngine(model, params)` with the JAX params tree loads them into the model."""
    jax_model, params, model = models
    fresh = GPTDolomiteForCausalLM(CommonConfig(**dict(ROPE_GQA, initializer_range=0.3)), device="cpu", seed=9)
    params_np = jax.tree.map(np.asarray, nn.unbox(params))
    ServingEngine(fresh, params_np, device="cpu", **ENGINE_ARGS)
    for a, b in zip(fresh.parameters(), model.parameters()):
        assert torch.equal(a, b)


def test_sampled_request_finishes_in_vocabulary(models):
    _, _, model = models
    engine = ServingEngine(model, None, device="cpu", **ENGINE_ARGS)
    sampling = SamplingParams(do_sample=True, temperature=0.8, top_k=20, top_p=0.9)
    prompt = _prompts(ROPE_GQA["vocab_size"])[1]
    specs = [dict(prompt_ids=prompt, max_new_tokens=10, sampling=sampling, seed=11)] * 2
    first, second = serve_batch(engine, specs)
    for state in (first, second):
        assert state.status == RequestStatus.completed
        assert len(state.tokens) == 10 and all(0 <= t < ROPE_GQA["vocab_size"] for t in state.tokens)
    assert first.tokens == second.tokens  # one seed, one stream
    assert engine.pool.num_free == engine.pool.num_slots


def test_bf16_model_with_a_bf16_pool(models):
    _, params, _ = models
    config = CommonConfig(**dict(ROPE_GQA, initializer_range=0.3))
    model = GPTDolomiteForCausalLM(config, dtype=torch.bfloat16, device="cpu")
    engine = ServingEngine(
        model, jax.tree.map(np.asarray, nn.unbox(params)), device="cpu", kv_dtype="bf16", **ENGINE_ARGS
    )
    assert engine.pool.caches[0]["k"].dtype == torch.bfloat16
    states = serve_batch(engine, [dict(prompt_ids=p, max_new_tokens=8) for p in _prompts(config.vocab_size)])
    assert all(s.status == RequestStatus.completed and len(s.tokens) == 8 for s in states)
    # a pool in another dtype than the model: the fp32 model over bf16 pages
    fp32_engine = ServingEngine(models[2], None, device="cpu", kv_dtype="bf16", **ENGINE_ARGS)
    assert fp32_engine.pool.caches[0]["k"].dtype == torch.bfloat16
    states = serve_batch(fp32_engine, [dict(prompt_ids=p, max_new_tokens=8) for p in _prompts(config.vocab_size)])
    assert all(s.status == RequestStatus.completed and len(s.tokens) == 8 for s in states)


def test_eos_and_queue_bound(models):
    _, _, model = models
    prompt = _prompts(ROPE_GQA["vocab_size"])[1]
    probe = serve_batch(ServingEngine(model, None, device="cpu", **ENGINE_ARGS), [dict(prompt_ids=prompt, max_new_tokens=6)])[0]
    engine = ServingEngine(model, None, device="cpu", **dict(ENGINE_ARGS, max_waiting=1))
    state = engine.submit(prompt, max_new_tokens=6, eos_token_id=probe.tokens[2])
    with pytest.raises(QueueFullError):
        engine.submit(prompt, max_new_tokens=6)
    engine.drain()
    assert state.tokens == probe.tokens[:3]  # EOS counts as an emitted token
    with pytest.raises(ValueError):
        engine.submit(prompt, max_new_tokens=200)  # beyond max_len


@pytest.mark.parametrize(
    "option",
    [
        dict(mesh=object()),
        dict(sharding_rules=object()),
        dict(signature_records=True),
    ],
    ids=lambda option: "-".join(
        f"{k}={v}" if isinstance(v, (bool, int, float, str)) else k for k, v in option.items()
    ),
)
def test_unported_options_name_their_roadmap_item(models, option):
    _, _, model = models
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue A"):
        ServingEngine(model, None, device="cpu", **dict(ENGINE_ARGS, **option))


def test_chip_smoke_serving_phase_runs_at_a_tiny_size_on_the_cpu():
    """`chip_smoke.serve`'s control flow — two request waves, the prefix hit, every
    request's 64 tokens, the kernel-path vs full-forward logits check — at a tiny width,
    on the CPU where the plain versions run (its launch-count check needs the card)."""
    import chip_smoke

    tiny = dict(chip_smoke.GRANITE_3B_CODE, vocab_size=256, n_embd=32, n_layer=1, n_head=2, n_inner=64)
    # one intra-op thread: ~1 s alone, and no spin-waiting thread pool when the suite's
    # other workers hold every core
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        serving, launches, _, _, tokens = chip_smoke.serve(0, tiny, device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert serving["requests"] == 8 and serving["prefix_hit_tokens"] >= 512
    assert serving["logits_check"]["positions"] == serving["prompt_tokens"][2] + 4
    assert set(launches.values()) == {0}
    assert [len(t) for t in tokens] == [chip_smoke.MAX_NEW] * 8


def test_chip_smoke_quantized_phases_run_at_a_tiny_size_on_the_cpu():
    """`chip_smoke.serve` over an int8 pool (the model an earlier phase built) and
    `chip_smoke.quantized_check` on one of its requests, at a tiny width on the CPU."""
    import chip_smoke

    tiny = dict(chip_smoke.GRANITE_3B_CODE, vocab_size=256, n_embd=32, n_layer=1, n_head=2, n_inner=64)
    model = GPTDolomiteForCausalLM(CommonConfig(**tiny), dtype=torch.bfloat16, device="cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        serving, launches, _, specs, tokens = chip_smoke.serve(0, device="cpu", kv_dtype="int8", model=model)
        prompt = specs[2]["prompt_ids"]
        check = chip_smoke.quantized_check(model, prompt + tokens[2][:4], len(prompt))
    finally:
        torch.set_num_threads(threads)
    assert serving["kv_dtype"] == "int8" and serving["requests"] == 8
    # 1 layer x K and V x 2 heads x (16 one-byte codes + a 4-byte scale over 16 tokens)
    assert serving["kv_bytes_per_token"] == 2 * 2 * (16 + 4 / 16) == chip_smoke.bf16_kv_bytes(model.config) / 2 + 1
    assert set(launches.values()) == {0}
    assert check["positions"] == len(prompt) + 4 and all(check["layer0_pool_bytes_identical"].values())
    assert check["layer0_attention_rel_l2_err"] == 0.0 and check["tie_page_codes_identical"]
