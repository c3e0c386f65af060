"""The dense slot pool and the repaired alibi-over-paged path, against the JAX engine.

- `SlotKVCachePool`: the invariants of `tests/test_serving.py`'s pool tests (lowest-first
  allocation, exhaustion, reclamation, double free, the static cache layout, writes only
  into an allocated slot) and the prefill copy;
- `ServingEngine(paged=False)` against the JAX engine with ``paged=False``: greedy tokens
  identical per request for a dense rope, an alibi (GQA) and an MoE model, 2 slots
  for 4 requests; an EOS frees its slot for the next request, admitted in FCFS order;
- an alibi model over the paged pool (the gathered path, now that the kernel gates carry
  the JAX `alibi_bias is None` term) against the JAX paged engine, with prefill chunks
  smaller than the prompts.

The JAX side runs its Pallas kernel families in interpret mode where they apply.
"""

import jax
import numpy as np
import pytest
import torch

from dolomite_engine_tpu.ops.pallas import kernel_overrides
from dolomite_engine_tpu.serving import ServingEngine as JaxServingEngine
from dolomite_engine_tpu_torch.serving import RequestStatus, SamplingParams, ServingEngine, SlotKVCachePool, serve_batch
from tests.test_torch_alibi_model import ALIBI_GQA
from tests.test_torch_model import ALL_KERNELS, ROPE_GQA, make_models
from tests.test_torch_moe_model import MOE, MOE_KERNELS, make_moe_models

ENGINE_ARGS = dict(
    num_slots=2, max_len=96, prefill_bucket_multiple=8, eos_token_id=None, pad_token_id=2,
    page_size=16, prefill_chunk_tokens=16,
)
MAX_NEW = 10


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the engines run many small steps, and under the suite's
    parallel workers an oversubscribed thread pool runs them many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _prompts(vocab):
    rs = np.random.RandomState(7)
    return [list(map(int, rs.randint(3, vocab, n))) for n in (5, 41, 17, 30)]


def _serve_both(jax_model, params, model, kernels, **engine_args):
    """Greedy tokens of the JAX engine and of the port's for `_prompts`; the port's engine."""
    args = dict(ENGINE_ARGS, **engine_args)
    prompts = _prompts(model.config.vocab_size)
    with kernel_overrides(**kernels):
        jax_engine = JaxServingEngine(jax_model, params, **args)
        jax_states = [
            jax_engine.submit(prompt_ids=p, max_new_tokens=MAX_NEW, rng=jax.random.PRNGKey(i))
            for i, p in enumerate(prompts)
        ]
        jax_engine.drain()
    engine = ServingEngine(model, None, device="cpu", **args)
    states = serve_batch(engine, [dict(prompt_ids=p, max_new_tokens=MAX_NEW) for p in prompts])
    for i, (ref, got) in enumerate(zip(jax_states, states)):
        assert got.status == RequestStatus.completed
        assert got.tokens == ref.tokens, f"request {i} diverged"
    assert len({t for state in states for t in state.tokens}) > 6  # varied streams, not one repeated token
    assert engine.stats.prefill_tokens == jax_engine.stats.prefill_tokens
    assert engine.stats.decode_tokens == jax_engine.stats.decode_tokens
    assert engine.pool.num_free == engine.pool.num_slots
    return engine


@pytest.mark.parametrize(
    "family", ["rope", "alibi", "moe"],
)
def test_dense_engine_matches_the_jax_dense_engine(family):
    if family == "moe":
        models, kernels = make_moe_models(dict(MOE, initializer_range=0.3)), MOE_KERNELS
    else:
        config = dict(ROPE_GQA if family == "rope" else ALIBI_GQA, initializer_range=0.3)
        models, kernels = make_models(config), ALL_KERNELS
    engine = _serve_both(*models, kernels, paged=False)
    assert isinstance(engine.pool, SlotKVCachePool) and engine.prefix is None
    assert engine.stats.prefill_chunks == 4  # one whole-prompt forward a request


def test_alibi_over_the_paged_pool_matches_the_jax_paged_engine():
    engine = _serve_both(*make_models(dict(ALIBI_GQA, initializer_range=0.3)), ALL_KERNELS)
    assert engine.stats.prefill_chunks > 4  # the 41- and 30-token prompts took several chunks


def test_dense_engine_eos_frees_a_slot_in_fcfs_order():
    _, _, model = make_models(dict(ROPE_GQA, initializer_range=0.3))
    prompts = _prompts(model.config.vocab_size)
    args = dict(ENGINE_ARGS, paged=False)
    probe = serve_batch(ServingEngine(model, None, device="cpu", **args), [dict(prompt_ids=prompts[0], max_new_tokens=MAX_NEW)])[0]
    eos = probe.tokens[2]
    engine = ServingEngine(model, None, device="cpu", **args)
    admitted = []
    states = [engine.submit(p, MAX_NEW, eos_token_id=eos if i == 0 else None) for i, p in enumerate(prompts)]
    while engine.step():
        admitted.extend(s for s in states if s.slot is not None and s not in admitted)
    assert states[0].tokens == probe.tokens[:3]  # EOS counts as an emitted token
    assert [s.request.request_id for s in admitted] == [s.request.request_id for s in states]  # FCFS
    assert states[2].slot == states[0].slot == 0  # request 0's EOS freed slot 0 first
    assert all(s.status == RequestStatus.completed for s in states)
    assert engine.pool.num_free == 2 and not engine.pool.lengths.any()


def test_dense_engine_sampled_requests_and_validation():
    _, _, model = make_models(dict(ROPE_GQA, initializer_range=0.3))
    prompt = _prompts(model.config.vocab_size)[1]
    engine = ServingEngine(model, None, device="cpu", **dict(ENGINE_ARGS, paged=False))
    sampling = SamplingParams(do_sample=True, temperature=0.8, top_k=20, top_p=0.9)
    first, second = serve_batch(engine, [dict(prompt_ids=prompt, max_new_tokens=8, sampling=sampling, seed=11)] * 2)
    assert first.tokens == second.tokens and len(first.tokens) == 8
    assert all(0 <= t < model.config.vocab_size for t in first.tokens)
    # the JAX engine's order: these are ValueErrors with the dense pool
    for option in (dict(kv_dtype="int8"), dict(preemption="swap")):
        with pytest.raises(ValueError, match="paged"):
            ServingEngine(model, None, device="cpu", **dict(ENGINE_ARGS, paged=False, **option))


def test_slot_pool_invariants():
    _, _, model = make_models()
    config = model.config
    pool = SlotKVCachePool(model, num_slots=3, max_len=16)
    assert [pool.allocate() for _ in range(3)] == [0, 1, 2]  # lowest first
    assert pool.allocate() is None  # an exhausted pool signals, never grows
    assert pool.num_free == 0 and pool.num_active == 3 and pool.occupancy == 1.0
    pool.lengths[1] = 7
    pool.free(1)
    assert pool.num_free == 1 and pool.lengths[1] == 0  # reclamation resets the frontier
    with pytest.raises(ValueError):
        pool.free(1)  # double free
    assert pool.allocate() == 1
    assert pool.caches[0]["k"].shape == (3, 16, config.num_key_value_heads, config.head_dim)
    assert len(pool.caches) == config.n_layer
    assert pool.kv_bytes_per_token == config.n_layer * 2 * config.num_key_value_heads * config.head_dim * 4
    with pytest.raises(NotImplementedError, match="'Distribution'"):
        SlotKVCachePool(model, 2, 16, mesh=object())


def test_slot_pool_write_prefill():
    _, _, model = make_models()
    pool = SlotKVCachePool(model, num_slots=2, max_len=16)
    prefill = model.init_kv_caches(1, 8)
    for cache in prefill:
        cache["k"].normal_()
        cache["v"].normal_()
    with pytest.raises(ValueError):
        pool.write_prefill(0, prefill, 5)  # slot 0 was never allocated
    slot = pool.allocate()
    pool.write_prefill(slot, prefill, 5)
    assert pool.lengths[slot] == 5
    for cache, new in zip(pool.caches, prefill):
        assert torch.equal(cache["k"][slot, :8], new["k"][0]) and torch.equal(cache["v"][slot, :8], new["v"][0])
        assert not cache["k"][1 - slot].any() and not cache["k"][slot, 8:].any()
