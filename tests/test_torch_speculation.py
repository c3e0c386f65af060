"""Speculative decoding in the port against the JAX package, on the CPU.

The cases of `tests/test_serving_spec.py`, at its sizes: the n-gram drafter's proposals
and `speculative_accept`'s greedy rule equal the JAX functions'; the rejection-sampling
distribution holds with the port's generators; and the port's `ServingEngine` with
n-gram or draft-model speculation, paged and dense, emits the JAX engine's greedy tokens
token for token (the JAX engine on its XLA path), with the same accepted-draft counts,
also with EOS inside a window, with one slot speculating beside one that is not, and
while a long prompt prefills in chunks. Sampled speculation follows the distribution of
plain sampling.

Not ported from that file: the compile-count checks (the port runs eagerly and compiles
nothing), the serving telemetry record and the router (ROADMAP.md Queue A, 'Serving
fleet and observability').
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dolomite_engine_tpu.ops.sampling import speculative_accept as jax_speculative_accept
from dolomite_engine_tpu.serving import NgramDrafter as JaxNgramDrafter
from dolomite_engine_tpu.serving import ServingEngine as JaxServingEngine
from dolomite_engine_tpu_torch.arguments import GenerationParameters
from dolomite_engine_tpu_torch.ops.sampling import NO_TEMPERATURE, NO_TOP_K, NO_TOP_P, speculative_accept
from dolomite_engine_tpu_torch.serving import RequestStatus, SamplingParams, ServingEngine, serve_batch
from dolomite_engine_tpu_torch.serving.speculation import NgramDrafter
from tests.test_torch_model import make_models

PAGE = 16
# `tests/test_serving_spec.py::_make_model`'s model
SPEC_MODEL = dict(
    vocab_size=256, n_positions=512, n_embd=32, n_layer=2, n_head=4, num_key_value_heads=2,
    attention_head_type="gqa", position_embedding_type="rope", add_bias=False,
    activation_function="swiglu", normalization_function="rmsnorm", resid_pdrop=0.0,
    embd_pdrop=0.0, attn_pdrop=0.0, bos_token_id=0, eos_token_id=1, pad_token_id=2,
)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Many small eager steps: one intra-op thread keeps them fast beside the suite's other
    workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models():
    return make_models(SPEC_MODEL)


@pytest.fixture(scope="module")
def draft_models():
    """A 1-layer draft of another seed (rejections most steps)."""
    return make_models(dict(SPEC_MODEL, n_layer=1), seed=9)


def _prompt(rs, length, vocab=256):
    return list(map(int, rs.randint(3, vocab, length)))


def _run_both(models, engine_args, specs, draft=None, steps_between=None):
    """The same requests through the JAX engine and the port's: (jax states, port states,
    jax engine, port engine). ``specs`` are (prompt, max_new) pairs; ``steps_between``
    (n, k) submits the first n, steps k times, then submits the rest."""
    jax_model, params, model = models
    jax_args, port_args = dict(engine_args), dict(engine_args)
    if draft is not None:
        jax_args.update(draft_model=draft[0], draft_params=draft[1])
        port_args.update(draft_model=draft[2])
    engines = (JaxServingEngine(jax_model, params, **jax_args), ServingEngine(model, None, device="cpu", **port_args))
    results = []
    for engine in engines:
        jax_side = isinstance(engine, JaxServingEngine)
        first, waits = steps_between or (len(specs), 0)
        states = []
        for i, (prompt, max_new) in enumerate(specs):
            if i == first:
                for _ in range(waits):
                    engine.step()
            key = dict(rng=jax.random.PRNGKey(100 + i)) if jax_side else {}
            states.append(engine.submit(prompt_ids=prompt, max_new_tokens=max_new, **key))
        engine.drain()
        results.append(states)
    return results[0], results[1], engines[0], engines[1]


# ------------------------------------------------------------------- the drafter


def test_ngram_drafter_proposals_match_jax():
    rs = np.random.RandomState(0)
    histories = [
        [5, 6, 7, 8, 9, 5, 6, 7],  # the suffix's earlier occurrence continues 8, 9, 5, 6
        [3, 4] + [9] * 10,  # a period-1 loop: a full K from far enough back
        [7],  # shorter than every n-gram
        (_prompt(rs, 6) * 5)[:27],
        _prompt(rs, 40, vocab=8),  # small alphabet: many short matches
    ]
    for k in (1, 4):
        port, ref = NgramDrafter(draft_k=k, ngram_max=3), JaxNgramDrafter(draft_k=k, ngram_max=3)
        for slot, history in enumerate(histories):
            port.start(slot, history)
            ref.start(slot, history)
            assert port.propose(slot) == ref.propose(slot), (k, history)
            for token in (42, history[0], history[-1]):
                port.extend(slot, token)
                ref.extend(slot, token)
                assert port.propose(slot) == ref.propose(slot), (k, history, token)
    port.stop(0)
    assert port.propose(0) == []


# ------------------------------------------------------------------- accept / resample


def _accept_case(drafts, num_drafts):
    vocab, k = 8, 2
    rs = np.random.RandomState(0)
    logits = rs.randn(1, k + 1, vocab).astype(np.float32) * 1.5
    greedy = np.argmax(logits[0], axis=-1)
    drafts = [int(greedy[i] + shift) % vocab for i, shift in enumerate(drafts)]
    return logits, drafts, num_drafts


@pytest.mark.parametrize(
    "shifts, num_drafts, want",
    [((0, 0), 2, 2), ((0, 1), 2, 1), ((1, 0), 2, 0), ((0, 0), 1, 1), ((0, 0), 0, 0)],
    ids=["all-accepted", "second-rejected", "first-rejection-ends-the-run", "capped-by-num-drafts", "no-drafts"],
)
def test_speculative_accept_greedy_rule_matches_jax(shifts, num_drafts, want):
    logits, drafts, num_drafts = _accept_case(shifts, num_drafts)
    ref_accepted, ref_bonus, _ = jax_speculative_accept(
        jnp.asarray(logits), jnp.asarray([drafts], jnp.int32), jnp.asarray([num_drafts], jnp.int32),
        jnp.asarray([jax.random.PRNGKey(0)]), jnp.asarray([False]), jnp.asarray([NO_TEMPERATURE]),
        jnp.asarray([NO_TOP_K], jnp.int32), jnp.asarray([NO_TOP_P]),
    )
    accepted, bonus = speculative_accept(
        torch.from_numpy(logits), torch.tensor([drafts]), torch.tensor([num_drafts]), [None], [False],
        torch.tensor([NO_TEMPERATURE]), torch.tensor([NO_TOP_K]), torch.tensor([NO_TOP_P]),
    )
    assert int(accepted[0]) == int(ref_accepted[0]) == want
    # the bonus is the greedy token at the first unverified position
    assert int(bonus[0]) == int(ref_bonus[0]) == int(np.argmax(logits[0, want]))


def test_speculative_accept_rejection_sampling_distribution():
    """The first emitted token (an accepted draft or the resampled bonus) follows the
    target distribution: 20000 rows drawn from one generator, fixed logits, a plausible
    draft that is not the argmax. Tolerance: total variation < 0.02 against the softmax,
    as the JAX test holds its own (the noise floor at this count is ~0.008)."""
    vocab, k, n = 8, 2, 20000
    rs = np.random.RandomState(0)
    logits = torch.from_numpy(rs.randn(1, k + 1, vocab).astype(np.float32) * 1.5)
    probs = torch.softmax(logits[0, 0], dim=-1).numpy()
    draft0 = int(np.argsort(probs)[-2])
    generator = torch.Generator().manual_seed(42)
    accepted, bonus = speculative_accept(
        logits.expand(n, k + 1, vocab), torch.tensor([[draft0, 0]]).expand(n, k), torch.ones(n, dtype=torch.long),
        [generator] * n, [True] * n, torch.full((n,), NO_TEMPERATURE), torch.full((n,), NO_TOP_K),
        torch.full((n,), NO_TOP_P),
    )
    tokens = torch.where(accepted >= 1, draft0, bonus).numpy()
    hist = np.bincount(tokens, minlength=vocab) / n
    tv = 0.5 * np.abs(hist - probs).sum()
    assert tv < 0.02, (tv, hist, probs)
    assert 0.05 < (tokens == draft0).mean() < 0.95  # both the accept and the reject path ran
    assert not (bonus[accepted == 0] == draft0).any()  # a rejected draft is never resampled


def test_speculative_accept_draws_only_for_sampled_rows():
    """Greedy rows draw nothing, so a sampled row's stream does not depend on its
    neighbours; a row draws K + V uniforms a step from its own generator."""
    rs = np.random.RandomState(1)
    logits = torch.from_numpy(rs.randn(3, 4, 16).astype(np.float32))
    drafts = torch.from_numpy(rs.randint(0, 16, (3, 3)))
    params = (torch.full((3,), 0.9), torch.full((3,), NO_TOP_K), torch.full((3,), 0.95))

    def run(do_sample):
        generators = [torch.Generator().manual_seed(7 + s) for s in range(3)]
        out = speculative_accept(logits, drafts, torch.tensor([3, 3, 3]), generators, do_sample, *params)
        return out, generators

    (accepted, bonus), generators = run([False, True, False])
    (accepted2, bonus2), _ = run([True, True, True])
    assert accepted[1] == accepted2[1] and bonus[1] == bonus2[1]
    assert torch.equal(generators[0].get_state(), torch.Generator().manual_seed(7).get_state())
    fresh = torch.Generator().manual_seed(8)
    torch.rand(3 + 16, generator=fresh)
    assert torch.equal(generators[1].get_state(), fresh.get_state())


# ------------------------------------------------------------------- the engine


def _engine_args(**extra):
    args = dict(
        num_slots=2, max_len=128, prefill_bucket_multiple=8, eos_token_id=None,
        pad_token_id=SPEC_MODEL["pad_token_id"], page_size=PAGE,
    )
    return {**args, **extra}


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_ngram_speculation_matches_the_jax_engine(models, paged):
    """`test_greedy_bitexact_parity_ngram_speculation`'s workload: a shared 2-page prefix,
    a 41-token prompt over several chunks, a repetitive prompt, and a late arrival that
    hits the finished requests' pages."""
    rs = np.random.RandomState(3)
    shared = _prompt(rs, 2 * PAGE)
    prompts = [
        shared + _prompt(rs, 5),
        shared + _prompt(rs, 9),
        _prompt(rs, 41),
        (_prompt(rs, 6) * 6)[:30],
        shared + _prompt(rs, 2),
    ]
    args = _engine_args(paged=paged, speculate_ngram=True, draft_k=4)
    if paged:
        args.update(prefill_chunk_tokens=16)
    ref, got, jax_engine, engine = _run_both(models, args, [(p, 24) for p in prompts], steps_between=(3, 4))
    for i, (a, b) in enumerate(zip(ref, got)):
        assert b.status == RequestStatus.completed
        assert b.tokens == a.tokens, f"request {i} diverged"
    stats, ref_stats = engine.stats, jax_engine.stats
    assert stats.draft_tokens_accepted == ref_stats.draft_tokens_accepted > 0  # speculation fired
    assert stats.draft_tokens_proposed == ref_stats.draft_tokens_proposed
    assert stats.decode_steps == ref_stats.decode_steps
    assert stats.decode_tokens > stats.decode_steps  # more than one token a step
    assert stats.accept_rate() == pytest.approx(ref_stats.accept_rate())
    assert stats.accepted_tokens_per_step() == pytest.approx(ref_stats.accepted_tokens_per_step())
    if paged:
        assert stats.prefix_hit_tokens == ref_stats.prefix_hit_tokens > 0
    assert engine.pool.num_free == engine.pool.num_slots


@pytest.mark.parametrize("draft", ["garbage", "self"])
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_draft_model_speculation_matches_the_jax_engine(models, draft_models, paged, draft):
    """A draft of another seed (rejections most steps) and the target as its own draft
    (near-total acceptance): draft quality moves throughput, never the tokens."""
    rs = np.random.RandomState(5)
    prompts = [_prompt(rs, n) for n in (21, 9)]
    source = draft_models if draft == "garbage" else models
    ref, got, jax_engine, engine = _run_both(
        models, _engine_args(max_len=96, paged=paged, draft_k=3), [(p, 16) for p in prompts],
        draft=(source[0], source[1], source[2]),
    )
    for i, (a, b) in enumerate(zip(ref, got)):
        assert b.tokens == a.tokens, f"request {i} diverged"
    assert engine.stats.draft_tokens_accepted == jax_engine.stats.draft_tokens_accepted
    assert engine.stats.draft_tokens_proposed == jax_engine.stats.draft_tokens_proposed
    if draft == "self":
        assert engine.stats.accept_rate() > 0.9
    assert engine.pool.num_free == engine.pool.num_slots


@pytest.fixture(scope="module")
def varied_models():
    """`SPEC_MODEL` at initializer_range 0.3: its greedy streams vary from token to token
    (at the default 0.02 they repeat one token)."""
    return make_models(dict(SPEC_MODEL, initializer_range=0.3))


@pytest.mark.parametrize("stop", ["eos", "budget"])
def test_a_request_ends_inside_a_verify_window(models, varied_models, stop):
    """A request that ends inside a verify step's emission ends there: the window's later
    tokens are discarded and `num_generated` counts through the last one delivered. EOS:
    the target drafts for itself over varied streams, and the EOS is the first token of
    the stream that a step emits before others of the same step. The token budget: n-gram
    drafting on the tiny model's loop, the budget ending after a step's first token."""
    rs = np.random.RandomState(11)
    prompt = _prompt(rs, 12)
    if stop == "eos":
        args, draft = _engine_args(max_len=96, draft_k=4), varied_models
        models = varied_models
        probe_args = dict(args, draft_model=models[2])
    else:
        args, draft = _engine_args(max_len=96, speculate_ngram=True, draft_k=4), None
        probe_args = args
    probe_engine = ServingEngine(models[2], None, device="cpu", **probe_args)
    emitted = []  # (verify steps so far, token)
    probe = probe_engine.submit(
        prompt_ids=prompt, max_new_tokens=24, on_token=lambda t: emitted.append((probe_engine.stats.decode_steps, t))
    )
    probe_engine.drain()
    tokens = probe.tokens
    # the last token delivered: one a step emits before another of the same step
    cut = next(
        i for i in range(1, len(tokens) - 1)
        if emitted[i][0] == emitted[i + 1][0] and (stop == "budget" or tokens.index(tokens[i]) == i)
    )
    max_new = 24
    if stop == "eos":
        args["eos_token_id"] = tokens[cut]
    else:
        max_new = cut + 1
    ref, got, _, engine = _run_both(models, args, [(prompt, max_new)], draft=draft)
    assert got[0].tokens == ref[0].tokens == tokens[: cut + 1]
    assert got[0].num_generated == cut + 1 < 24 and engine.stats.draft_tokens_accepted > 0
    assert engine.pool.num_free == engine.pool.num_slots


def test_one_slot_speculating_beside_one_that_is_not(models):
    """One slot with a repetitive prompt accepts drafts, its neighbour proposes little: the
    neighbour's stream is that of the same request without speculation, and both equal the
    JAX engine's."""
    rs = np.random.RandomState(17)
    repetitive = (_prompt(rs, 5) * 8)[:38]
    novel = _prompt(rs, 23)
    specs = [(repetitive, 20), (novel, 20)]
    ref, got, _, engine = _run_both(models, _engine_args(speculate_ngram=True, draft_k=4), specs)
    plain = serve_batch(
        ServingEngine(models[2], None, device="cpu", **_engine_args()), [dict(prompt_ids=p, max_new_tokens=n) for p, n in specs]
    )
    assert [s.tokens for s in got] == [s.tokens for s in ref]
    assert got[1].tokens == plain[1].tokens and got[0].tokens == plain[0].tokens
    assert engine.stats.draft_tokens_accepted > 0


def test_chunked_prefill_keeps_a_speculating_slot_emitting(models):
    """While a long prompt prefills in chunks, the running speculating slot emits at least
    one token every step, and both requests give the JAX engine's tokens."""
    rs = np.random.RandomState(9)
    args = _engine_args(prefill_chunk_tokens=48, speculate_ngram=True, draft_k=4)
    short_prompt = (_prompt(rs, 4) * 3)[:10]
    long_prompt = _prompt(rs, 40)
    engine = ServingEngine(models[2], None, device="cpu", **args)
    short = engine.submit(prompt_ids=short_prompt, max_new_tokens=40)
    engine.step()
    long_state = engine.submit(prompt_ids=long_prompt, max_new_tokens=2)
    progress = []
    while long_state.num_generated == 0 and not short.done:
        before = short.num_generated
        engine.step()
        progress.append(short.num_generated - before)
    assert progress and all(p >= 1 for p in progress), progress
    engine.drain()
    ref, _, _, _ = _run_both(models, args, [(short_prompt, 40), (long_prompt, 2)], steps_between=(1, 1))
    assert [short.tokens, long_state.tokens] == [s.tokens for s in ref]


def test_sampled_speculation_follows_plain_sampling(models):
    """`test_sampled_distribution_correctness_e2e` with the port's generators: the token
    histogram of speculative sampling against plain engine sampling on the same prompt,
    a 1-layer vocab-32 model at temperature 1.5. Tolerance: total variation < 0.15 (the
    JAX test's; plain against plain sits near 0.09 at these counts, an always-accept rule
    above 0.3)."""
    config = dict(SPEC_MODEL, vocab_size=32, n_layer=1)
    _, _, model = make_models(config)
    rs = np.random.RandomState(29)
    prompt = (_prompt(rs, 6, vocab=32) * 5)[:24]
    sampling = SamplingParams(do_sample=True, temperature=1.5)

    def histogram(speculate, seed_base):
        counts = np.zeros(32, np.int64)
        engine = ServingEngine(model, None, device="cpu", **_engine_args(speculate_ngram=speculate, draft_k=4))
        specs = [dict(prompt_ids=list(prompt), max_new_tokens=80, sampling=sampling, seed=seed_base + i) for i in range(16)]
        for state in serve_batch(engine, specs):
            assert state.status == RequestStatus.completed and len(state.tokens) == 80
            np.add.at(counts, state.tokens, 1)
        return counts / counts.sum(), engine

    spec_hist, engine = histogram(True, 1000)
    plain_hist, _ = histogram(False, 2000)
    tv = 0.5 * np.abs(spec_hist - plain_hist).sum()
    assert tv < 0.15, tv
    assert 0 < engine.stats.draft_tokens_accepted < engine.stats.draft_tokens_proposed


def test_speculation_validation(models):
    _, _, model = models
    base = dict(num_slots=1, max_len=32, device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        ServingEngine(model, None, speculate_ngram=True, draft_model=model, **base)
    # a model of the port holds its weights: no draft_params needed
    assert ServingEngine(model, None, draft_model=model, **base).speculating
    with pytest.raises(ValueError, match="draft_k must be >= 1"):
        ServingEngine(model, None, speculate_ngram=True, draft_k=0, **base)
    with pytest.raises(ValueError):
        GenerationParameters(batch_size=1, max_new_tokens=4, draft_k=0)
    with pytest.raises(ValueError):
        GenerationParameters(batch_size=1, max_new_tokens=4, speculate_ngram=True, draft_model="x")
    assert GenerationParameters(batch_size=1, max_new_tokens=4, speculate_ngram=True).draft_k == 4
