"""Preemption and oversubscription in the port against the JAX package, on the CPU.

The cases of `tests/test_serving_contention.py`, at its sizes: a high-tier arrival evicts
a low-tier request (swap or drop-and-recompute) and both finish with the JAX engine's
greedy tokens, which are those of an unpreempted run; a same-tier arrival waits; the
same under n-gram speculation over an int8 pool; an oversubscribed pool that runs
physically dry reclaims by preemption and every request keeps the JAX engine's tokens.
Also: swapped pages and scale rows come back byte-identical (bf16, int8 and fp8 pools),
the pool's oversubscribed accounting equals the JAX pool's, a request preempted mid-
prefill restarts it, the validation errors, and a sampled request resumed after
preemption continues the stream the port's unpreempted run draws for its seed.

Not held here: the compile-count checks (the port compiles nothing); the serving
telemetry record and the router's session affinity are held by
`tests/test_torch_serving_{observability,faults}.py`. The scheduler's tier order and the session pins are the
port's copies of the JAX modules, held by `tests/test_torch_serving*.py`.
"""

import jax
import numpy as np
import pytest
import torch

from dolomite_engine_tpu.serving import PagedKVCachePool as JaxPagedKVCachePool
from dolomite_engine_tpu.serving import ServingEngine as JaxServingEngine
from dolomite_engine_tpu_torch.arguments import GenerationParameters
from dolomite_engine_tpu_torch.serving import (
    PagedKVCachePool,
    RequestStatus,
    SamplingParams,
    ServingEngine,
    serve_batch,
)
from dolomite_engine_tpu_torch.serving.kv_cache import HostSwapPool
from tests.test_torch_model import make_models

PAGE = 8
# `tests/test_commons.get_dense_test_config("gqa", "rope", normalization_function="rmsnorm")`
CONTENTION_MODEL = dict(
    vocab_size=2048, n_positions=512, n_embd=32, n_layer=4, n_head=4, num_key_value_heads=2,
    attention_head_type="gqa", position_embedding_type="rope", add_bias=True,
    activation_function="gelu_pytorch_tanh", normalization_function="rmsnorm", resid_pdrop=0.0,
    embd_pdrop=0.0, attn_pdrop=0.0, bos_token_id=0, eos_token_id=1, pad_token_id=2,
)


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models():
    return make_models(CONTENTION_MODEL)


def _prompt(rs, length):
    return list(map(int, rs.randint(3, CONTENTION_MODEL["vocab_size"], length)))


def _contended_args(preemption, **overrides):
    """A pool where one low-tier hog fits but a second worst-case request does not:
    admitting a high-tier request needs preemption."""
    args = dict(
        num_slots=2, max_len=32, prefill_bucket_multiple=8, eos_token_id=None,
        pad_token_id=CONTENTION_MODEL["pad_token_id"], page_size=PAGE,
        num_pages=3 + 1 + 1,  # one hog's worst case, a spare, the trash page
        preemption=preemption,
    )
    return {**args, **overrides}


def _engines(models, args):
    jax_model, params, model = models
    return JaxServingEngine(jax_model, params, **args), ServingEngine(model, None, device="cpu", **args)


def _submit(engine, i, prompt, max_new, **kwargs):
    if isinstance(engine, JaxServingEngine):
        kwargs["rng"] = jax.random.PRNGKey(300 + i)
    return engine.submit(prompt_ids=prompt, max_new_tokens=max_new, **kwargs)


def _low_then_high(engine, low_prompt, hi_prompt, steps=4):
    low = _submit(engine, 0, low_prompt, 12, priority=2)
    for _ in range(steps):
        engine.step()
    hi = _submit(engine, 1, hi_prompt, 8, priority=0)
    engine.drain()
    return low, hi


@pytest.mark.parametrize("mode", ["recompute", "swap"])
def test_preempt_resume_matches_the_jax_engine(models, mode):
    """A high-tier arrival evicts the low-tier hog mid-decode; the hog resumes, and both
    finish with the JAX engine's tokens, which equal an unpreempted run's."""
    rs = np.random.RandomState(0)
    low_prompt, hi_prompt = _prompt(rs, 10), _prompt(rs, 12)
    (ref_low, ref_hi), (low, hi) = [
        _low_then_high(engine, low_prompt, hi_prompt) for engine in _engines(models, _contended_args(mode))
    ]
    assert low.preemptions == ref_low.preemptions >= 1 and low.status == RequestStatus.completed
    assert hi.preemptions == 0 and hi.status == RequestStatus.completed
    assert low.tokens == ref_low.tokens and hi.tokens == ref_hi.tokens
    alone = ServingEngine(models[2], None, device="cpu", **_contended_args("off", num_pages=12))
    unpreempted = serve_batch(alone, [dict(prompt_ids=low_prompt, max_new_tokens=12), dict(prompt_ids=hi_prompt, max_new_tokens=8)])
    assert [low.tokens, hi.tokens] == [s.tokens for s in unpreempted]


def _run_contended(models, mode, **overrides):
    """`_low_then_high` on both engines: (jax engine, port engine, jax states, port states)."""
    rs = np.random.RandomState(0)
    low_prompt, hi_prompt = _prompt(rs, 10), _prompt(rs, 12)
    jax_engine, engine = _engines(models, _contended_args(mode, **overrides))
    return jax_engine, engine, _low_then_high(jax_engine, low_prompt, hi_prompt), _low_then_high(engine, low_prompt, hi_prompt)


@pytest.mark.parametrize("mode", ["recompute", "swap"])
def test_preemption_counters_match_the_jax_engine(models, mode):
    jax_engine, engine, _, _ = _run_contended(models, mode)
    stats, ref = engine.stats, jax_engine.stats
    assert stats.preemptions == ref.preemptions >= 1
    assert stats.preempted_by_tier == ref.preempted_by_tier == {2: stats.preemptions}
    assert (stats.pages_swapped_out, stats.pages_swapped_in) == (ref.pages_swapped_out, ref.pages_swapped_in)
    if mode == "swap":
        assert stats.pages_swapped_in == stats.pages_swapped_out > 0
        assert engine._swap.bytes_in == engine._swap.bytes_out == stats.pages_swapped_out * engine.pool.page_bytes
    assert stats.prefix_hit_tokens == ref.prefix_hit_tokens
    assert stats.prefill_tokens == ref.prefill_tokens and stats.decode_tokens == ref.decode_tokens
    assert engine.pool.num_free == engine.pool.num_slots and engine.pool._total_reserved == 0
    assert not (engine._swap and engine._swap._parked)  # no payload left in the host pool


def test_admission_preemption_only_evicts_strictly_lower_tiers(models):
    """A same-tier arrival waits (FCFS within the tier) instead of evicting."""
    rs = np.random.RandomState(3)
    engine = ServingEngine(models[2], None, device="cpu", **_contended_args("swap"))
    first = engine.submit(prompt_ids=_prompt(rs, 10), max_new_tokens=12, priority=1)
    for _ in range(4):
        engine.step()
    assert first.status == RequestStatus.running
    peer = engine.submit(prompt_ids=_prompt(rs, 12), max_new_tokens=8, priority=1)
    engine.step()
    assert first.status == RequestStatus.running and first.preemptions == 0
    assert peer.status == RequestStatus.waiting
    engine.drain()
    assert engine.stats.preemptions == 0
    assert first.status == peer.status == RequestStatus.completed


def test_preempt_resume_with_speculation_and_quantized_kv(models):
    """Preemption under n-gram speculation over an int8 pool: for each mode, the port's
    tokens equal the JAX engine's, and the preempted runs equal the unpreempted one."""
    rs = np.random.RandomState(5)
    phrase = _prompt(rs, 5)
    low_prompt, hi_prompt = (phrase * 3)[:12], _prompt(rs, 12)
    kwargs = dict(speculate_ngram=True, draft_k=3, kv_dtype="int8")
    runs = {}
    for mode in ("off", "recompute", "swap"):
        args = _contended_args(mode, **kwargs, **({"num_pages": 12} if mode == "off" else {}))
        (ref_low, ref_hi), (low, hi) = [_low_then_high(engine, low_prompt, hi_prompt) for engine in _engines(models, args)]
        assert [low.tokens, hi.tokens] == [ref_low.tokens, ref_hi.tokens], mode
        assert low.preemptions == ref_low.preemptions and (low.preemptions >= 1) == (mode != "off"), mode
        runs[mode] = [low.tokens, hi.tokens]
    assert runs["recompute"] == runs["swap"] == runs["off"]


@pytest.mark.parametrize("kv_dtype", [None, "int8", "fp8"], ids=["model-dtype", "int8", "fp8"])
def test_swap_round_trip_restores_pages_and_scales_byte_for_byte(models, kv_dtype):
    """Swap-out then swap-in gives back the page bytes and a quantized pool's scale rows
    exactly: against a snapshot of the device pages taken before the preemption."""
    rs = np.random.RandomState(7)
    engine = ServingEngine(models[2], None, device="cpu", **_contended_args("swap", kv_dtype=kv_dtype))
    state = engine.submit(prompt_ids=_prompt(rs, 10), max_new_tokens=12, priority=2)
    for _ in range(5):
        engine.step()
    assert state.status == RequestStatus.running
    slot = state.slot
    resident = int(engine.pool.lengths[slot])
    used = -(-resident // PAGE)
    old_pages = torch.as_tensor(engine.pool.page_table[slot, :used].astype(np.int64))

    def snapshot(pages):
        return [{name: a.view(torch.uint8)[pages].clone() if a.element_size() == 1 else a[pages].clone() for name, a in c.items()} for c in engine.pool.caches]

    before = snapshot(old_pages)
    engine._preempt(state)
    assert state.status == RequestStatus.waiting and state.resume.swapped and state.resume.resident == resident
    payload, parked = engine._swap._parked[state.request.request_id]
    assert parked == used
    for chunk, reference in zip(payload, before):
        assert set(chunk) == set(reference) == ({"k", "v"} | ({"k_scale", "v_scale"} if kv_dtype else set()))
        assert all(torch.equal(chunk[name], reference[name]) for name in reference)
    # dirty the freed pages, as a neighbour's writes would, then resume through admission
    for cache in engine.pool.caches:
        for array in cache.values():
            array.view(torch.uint8)[old_pages] = 77
    assert engine.scheduler.pop_next() is state and engine._try_admit(state)
    new_pages = torch.as_tensor(engine.pool.page_table[state.slot, :used].astype(np.int64))
    assert (new_pages != 0).all()
    assert all(torch.equal(a, b[name]) for c, b in zip(snapshot(new_pages), before) for name, a in c.items())
    engine.drain()
    assert state.status == RequestStatus.completed and engine.stats.pages_swapped_in == used


def test_host_swap_pool_moves_raw_bytes():
    """`HostSwapPool` alone: pages out to host memory and back onto other pages, the bytes
    kept; a dropped payload is gone."""

    class Model:
        config = None

        def init_kv_caches(self, pages, page_size, dtype):
            gen = torch.Generator().manual_seed(0)
            return [{name: torch.randn((pages, page_size, 2, 16), generator=gen).to(dtype) for name in ("k", "v")} for _ in range(3)]

    pool = PagedKVCachePool(Model(), 2, 64, PAGE, 12, dtype=torch.bfloat16)
    swap = HostSwapPool(pool)
    want = [{name: a[[3, 5, 1]].clone() for name, a in c.items()} for c in pool.caches]
    assert swap.swap_out(9, [3, 5, 1]) == 3 and list(swap._parked) == [9]
    parked = sum(array.nbytes for chunk in swap._parked[9][0] for array in chunk.values())
    assert parked == 3 * pool.page_bytes == swap.bytes_out
    assert swap.swap_in(9, [7, 2, 10]) == 3 and not swap._parked
    assert all(torch.equal(c[name][[7, 2, 10]], w[name]) for c, w in zip(pool.caches, want) for name in w)
    swap.swap_out(4, [6])
    swap.drop(4)
    assert not swap._parked


def test_oversubscribed_admission_and_reclamation_matches_the_jax_engine(models):
    """Ratio 2.0 admits beyond the physical pages; reclamation at decode (prefix eviction,
    preemption) keeps every request's tokens the JAX engine's and the accounting clean."""
    rs = np.random.RandomState(13)
    args = dict(
        num_slots=5, max_len=24, prefill_bucket_multiple=8, eos_token_id=None,
        pad_token_id=CONTENTION_MODEL["pad_token_id"], page_size=PAGE, num_pages=8,
        preemption="swap", oversubscribe_ratio=2.0,
    )
    prompts = [_prompt(rs, 6 + 2 * (i % 2)) for i in range(8)]
    results = []
    for engine in _engines(models, args):
        states = [_submit(engine, i, p, 8, priority=i % 2) for i, p in enumerate(prompts[:5])]
        for i, p in enumerate(prompts[5:], 5):
            engine.step()
            states.append(_submit(engine, i, p, 8, priority=i % 2))
        engine.drain()
        results.append((engine, states))
    (jax_engine, ref), (engine, got) = results
    assert [s.tokens for s in got] == [s.tokens for s in ref]
    assert all(s.status == RequestStatus.completed for s in got)
    assert engine.stats.peak_active > 2  # more requests in flight than physically reservable
    assert engine.stats.preemptions == jax_engine.stats.preemptions > 0  # the pool ran dry
    assert engine.pool.num_free == engine.pool.num_slots and engine.pool._total_reserved == 0


@pytest.mark.parametrize("mode", ["recompute", "swap"])
def test_preemption_churn_matches_the_jax_engine(models, mode):
    """`test_compile_counts_survive_preemption_churn`'s workload (three tiers, ratio 2.0,
    two waves) without the compile counts: every request's tokens are the JAX engine's."""
    results = []
    for engine in _engines(models, _contended_args(mode, num_slots=3, oversubscribe_ratio=2.0)):
        rs = np.random.RandomState(9)
        states = []
        for wave in range(2):
            specs = [dict(prompt_ids=_prompt(rs, 8 + 2 * (i % 3)), max_new_tokens=10, priority=i % 3) for i in range(6)]
            if isinstance(engine, JaxServingEngine):
                specs = [dict(s, rng=jax.random.PRNGKey(500 + 6 * wave + i)) for i, s in enumerate(specs)]
            states += serve_batch(engine, specs)
        results.append((engine, states))
    (jax_engine, ref), (engine, got) = results
    assert [s.tokens for s in got] == [s.tokens for s in ref]
    assert engine.stats.preemptions == jax_engine.stats.preemptions > 0
    assert engine.stats.completed == 12 and engine.pool.num_free == engine.pool.num_slots


def test_preemption_mid_prefill_restarts_the_prefill(models):
    """A low-tier request still prefilling in chunks when a high-tier one arrives gives its
    slot up, keeps the pages its chunks filled in the prefix cache, and restarts: both
    requests give the JAX engine's tokens."""
    rs = np.random.RandomState(21)
    low_prompt, hi_prompt = _prompt(rs, 40), _prompt(rs, 10)
    args = _contended_args(
        "recompute", max_len=64, num_pages=9, prefill_chunk_tokens=16, oversubscribe_ratio=1.0
    )
    results = []
    for engine in _engines(models, args):
        low = _submit(engine, 0, low_prompt, 8, priority=1)
        engine.step()  # the first 16-token chunk
        assert low.status == RequestStatus.running and low.num_generated == 0
        hi = _submit(engine, 1, hi_prompt, 8, priority=0)
        engine.drain()
        results.append((engine, low, hi))
    (jax_engine, ref_low, ref_hi), (engine, low, hi) = results
    assert low.preemptions == ref_low.preemptions >= 1
    assert [low.tokens, hi.tokens] == [ref_low.tokens, ref_hi.tokens]
    assert engine.stats.prefix_hit_tokens == jax_engine.stats.prefix_hit_tokens > 0  # the chunks were kept


# prompt lengths under which the JAX engine's admission cycles (ROADMAP.md Queue C)
CYCLE_LENGTHS = [256, 244, 247, 253, 200, 203, 203, 239, 209, 219, 221, 250, 236, 223, 206, 224, 224]


def test_admission_copy_on_write_pages_do_not_preempt_in_a_cycle(monkeypatch):
    """Recompute preemption over a dry oversubscribed pool, 17 prompts whose tokens follow
    a Zipf law (so page starts often match another prompt's and admissions copy a partial
    page): the JAX engine's admissions preempt each other without end inside one
    admission pass (stopped here after 100 preemptions in a pass), where the port, whose
    copy-on-write page may be reclaimed only from requests ranked after the one admitted,
    finishes every request with the tokens of an unpreempted run."""
    from dolomite_engine_tpu.serving import engine as jax_engine_module

    class Cycle(Exception):
        pass

    admit, preempt = JaxServingEngine._admit_paged, JaxServingEngine._preempt

    def counted_admit(self):
        self._preempted_in_pass = 0
        return admit(self)

    def counted_preempt(self, state):
        self._preempted_in_pass = getattr(self, "_preempted_in_pass", 0) + 1
        if self._preempted_in_pass > 100:
            raise Cycle()
        return preempt(self, state)

    monkeypatch.setattr(jax_engine_module.ServingEngine, "_admit_paged", counted_admit)
    monkeypatch.setattr(jax_engine_module.ServingEngine, "_preempt", counted_preempt)
    config = dict(
        CONTENTION_MODEL, vocab_size=512, n_layer=1, add_bias=False, activation_function="swiglu",
    )
    jax_model, params, model = make_models(config)
    rs = np.random.RandomState(0)
    ids = np.arange(3, 512)
    p = 1.0 / ids
    prompts = [rs.choice(ids, size=n, p=p / p.sum()).tolist() for n in CYCLE_LENGTHS]
    args = dict(
        num_slots=16, max_len=264, prefill_bucket_multiple=64, max_waiting=32, eos_token_id=None,
        pad_token_id=2, page_size=16, num_pages=96, preemption="recompute", oversubscribe_ratio=2.0,
    )
    engine = JaxServingEngine(jax_model, params, **args)
    for prompt in prompts:
        engine.submit(prompt_ids=prompt, max_new_tokens=8)
    with pytest.raises(Cycle):
        engine.drain()
    specs = [dict(prompt_ids=prompt, max_new_tokens=8) for prompt in prompts]
    engine = ServingEngine(model, None, device="cpu", **args)
    states = serve_batch(engine, specs)
    unpreempted = serve_batch(ServingEngine(model, None, device="cpu", **dict(args, num_pages=None, preemption="off", oversubscribe_ratio=1.0)), specs)
    assert engine.stats.preemptions > 0 and engine.stats.completed == len(prompts)
    assert [s.tokens for s in states] == [s.tokens for s in unpreempted]
    assert engine.pool.num_free == engine.pool.num_slots and engine.pool._total_reserved == 0


@pytest.mark.parametrize("mode", ["recompute", "swap"])
def test_sampled_resume_continues_the_stream(models, mode):
    """A sampled request preempted mid-decode resumes with its generator's state, so it
    emits what the port's unpreempted run emits for the same seed."""
    rs = np.random.RandomState(0)
    low_prompt, hi_prompt = _prompt(rs, 10), _prompt(rs, 12)
    sampling = SamplingParams(do_sample=True, temperature=0.9, top_k=50, top_p=0.95)
    engine = ServingEngine(models[2], None, device="cpu", **_contended_args(mode))
    low = engine.submit(prompt_ids=low_prompt, max_new_tokens=12, sampling=sampling, seed=77, priority=2)
    for _ in range(4):
        engine.step()
    engine.submit(prompt_ids=hi_prompt, max_new_tokens=8, sampling=sampling, seed=78, priority=0)
    engine.drain()
    alone = ServingEngine(models[2], None, device="cpu", **_contended_args("off", num_pages=12))
    (want,) = serve_batch(alone, [dict(prompt_ids=low_prompt, max_new_tokens=12, sampling=sampling, seed=77)])
    assert low.preemptions >= 1 and low.tokens == want.tokens
    assert len(set(want.tokens)) > 3  # a varied stream


def test_oversubscribed_pool_accounting_matches_jax(models):
    """The pool's promise and page counts under ratio 1.5 follow the JAX pool's through
    the same reserve / allocate / free sequence, and mapping past the physical pages
    raises."""
    jax_model, _, model = models
    pools = [
        JaxPagedKVCachePool(jax_model, 3, 32, PAGE, 7, oversubscribe_ratio=1.5),
        PagedKVCachePool(model, 3, 32, PAGE, 7, oversubscribe_ratio=1.5),
    ]

    def figures(pool):
        return (pool.available_pages, pool.physical_free, pool.pages_in_use, pool.page_fragmentation, pool.num_active)

    trace = [[] for _ in pools]
    for pool, log in zip(pools, trace):
        a, b = pool.allocate(), pool.allocate()
        pool.reserve(a, 4)
        pool.reserve(b, 4)
        log.append(figures(pool))
        for i in range(4):
            pool.alloc_page(a, i)
        pool.lengths[a] = 27
        pool.alloc_page(b, 0)
        pool.alloc_page(b, 1)
        pool.lengths[b] = 9
        log.append(figures(pool))
        with pytest.raises(RuntimeError, match="physically exhausted"):
            pool.alloc_page(b, 2)
        pool.free(a)
        log.append(figures(pool))
    assert trace[0] == trace[1]
    with pytest.raises(ValueError, match="oversubscribe_ratio"):
        PagedKVCachePool(model, 1, 16, PAGE, oversubscribe_ratio=0.5)


def test_preemption_and_oversubscription_validation(models):
    model = models[2]
    base = dict(num_slots=1, max_len=16, device="cpu")
    with pytest.raises(ValueError, match="preemption must be"):
        ServingEngine(model, None, preemption="sideways", **base)
    with pytest.raises(ValueError, match="requires the paged KV pool"):
        ServingEngine(model, None, paged=False, preemption="swap", **base)
    with pytest.raises(ValueError, match="only safe with preemption"):
        ServingEngine(model, None, oversubscribe_ratio=1.5, **base)
    with pytest.raises(ValueError, match=">= 1.0"):
        ServingEngine(model, None, oversubscribe_ratio=0.5, **base)
    with pytest.raises(ValueError, match="prefill_only workers"):
        ServingEngine(model, None, prefill_only=True, preemption="swap", **base)
    engine = ServingEngine(model, None, prefill_bucket_multiple=8, **base)
    with pytest.raises(ValueError):
        engine.submit(prompt_ids=[1, 2], max_new_tokens=2, priority=-1)
    for bad in (dict(preemption="both"), dict(oversubscribe_ratio=1.5), dict(paged_kv_cache=False, preemption="swap")):
        with pytest.raises(ValueError):
            GenerationParameters(batch_size=1, max_new_tokens=2, **bad)
    ok = GenerationParameters(batch_size=1, max_new_tokens=2, preemption="recompute", oversubscribe_ratio=1.5)
    assert ok.oversubscribe_ratio == 1.5
