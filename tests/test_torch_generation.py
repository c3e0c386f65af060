"""The port's fixed-batch generation against the JAX package's, on the CPU.

- `generation_utils.generate_tokens`: greedy tokens and `num_generated` identical for
  MHA / GQA / MQA rope models (weights carried by `load_jax_params`), with left-padded
  rows, without EOS and with an EOS a row emits mid-way; an alibi model makes both
  raise (the JAX function on the shapes, the port with its `ValueError`);
- `ops.sampling`'s processors: the same filtered logits as JAX's (atol 1e-6);
- the dense `update_kv_cache`: scalar and per-row write offsets, a per-row write past the
  end dropped and a scalar one clamped, the cache bit for bit and the mask exactly;
- the `sdpa` attention: a bf16 query with no visible key (a pad query under a padding
  mask rewritten to segment ids) gives JAX's finite row, not NaN.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dolomite_engine_tpu.enums import AttentionImplementation as JaxImpl
from dolomite_engine_tpu.generation_utils import generate_tokens as jax_generate_tokens
from dolomite_engine_tpu.models.modeling_utils import update_kv_cache as jax_update_kv_cache
from dolomite_engine_tpu.ops import sampling as jax_sampling
from dolomite_engine_tpu.ops.attention import attention as jax_attention
from dolomite_engine_tpu_torch.generation_utils import generate_tokens, make_generate_fn
from dolomite_engine_tpu_torch.models.modeling_utils import update_kv_cache
from dolomite_engine_tpu_torch.ops import sampling
from dolomite_engine_tpu_torch.ops.attention import attention
from tests.test_torch_model import ROPE_GQA, make_models

HEADS = {"mha": None, "gqa": 2, "mqa": 1}
MAX_NEW = 8


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the decode loops are many small steps, and under the suite's
    parallel workers an oversubscribed thread pool runs them many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _left_padded_prompts(vocab, pad):
    rs = np.random.RandomState(0)
    ids = rs.randint(3, vocab, (3, 10))
    mask = np.ones((3, 10), np.int32)
    for row, pads in ((1, 4), (2, 7)):
        ids[row, :pads] = pad
        mask[row, :pads] = 0
    return ids, mask


@pytest.mark.parametrize("head_type", list(HEADS))
def test_generate_tokens_match_jax(head_type):
    config = dict(
        ROPE_GQA, initializer_range=0.3, attention_head_type=head_type, num_key_value_heads=HEADS[head_type]
    )
    jax_model, params, model = make_models(config)
    ids, mask = _left_padded_prompts(config["vocab_size"], config["pad_token_id"])

    def both(eos):
        ref, ref_n = jax_generate_tokens(
            jax_model, params, jnp.asarray(ids), jnp.asarray(mask), jax.random.PRNGKey(0), MAX_NEW,
            eos_token_id=eos, pad_token_id=config["pad_token_id"],
        )
        got, got_n = generate_tokens(
            model, torch.from_numpy(ids), torch.from_numpy(mask), None, MAX_NEW,
            eos_token_id=eos, pad_token_id=config["pad_token_id"],
        )
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        np.testing.assert_array_equal(got_n.numpy(), np.asarray(ref_n))
        return got, got_n

    free, counts = both(None)
    assert counts.tolist() == [MAX_NEW] * 3 and len(set(free[0].tolist())) > 3
    eos = int(free[0, 3])  # row 0 emits it at its fourth token
    _, counts = both(eos)
    assert counts[0] == 4


def test_generate_fn_closure_and_seq2seq_refusal():
    _, _, model = make_models(dict(ROPE_GQA, initializer_range=0.3))
    ids, mask = _left_padded_prompts(ROPE_GQA["vocab_size"], ROPE_GQA["pad_token_id"])
    fn = make_generate_fn(model, max_new_tokens=4, pad_token_id=2)
    tokens, counts = fn(torch.from_numpy(ids), torch.from_numpy(mask))
    direct, _ = generate_tokens(model, torch.from_numpy(ids), torch.from_numpy(mask), None, 4, pad_token_id=2)
    assert torch.equal(tokens, direct) and counts.tolist() == [4, 4, 4]
    sampled = make_generate_fn(model, max_new_tokens=4, do_sample=True, temperature=0.9, top_p=0.9)
    a, _ = sampled(torch.from_numpy(ids), torch.from_numpy(mask), torch.Generator().manual_seed(5))
    b, _ = sampled(torch.from_numpy(ids), torch.from_numpy(mask), torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and bool(((a >= 0) & (a < ROPE_GQA["vocab_size"])).all())
    # named when encoder-decoder generation was refused: the closure now routes an
    # encoder-decoder to `generate_seq2seq_tokens` (held to JAX in tests/test_torch_seq2seq.py)
    from dolomite_engine_tpu_torch.generation_utils import generate_seq2seq_tokens
    from dolomite_engine_tpu_torch.models import EncDecDolomiteConfig, EncDecDolomiteForSeq2SeqLM
    from tests.test_torch_enc_dec import T5_MHA

    seq2seq = EncDecDolomiteForSeq2SeqLM(EncDecDolomiteConfig(**T5_MHA), device="cpu", seed=1)
    ids = ids % T5_MHA["vocab_size"]
    static = dict(max_new_tokens=4, pad_token_id=2, decoder_start_token_id=0)
    tokens, counts = make_generate_fn(seq2seq, is_encoder_decoder=True, **static)(torch.from_numpy(ids), torch.from_numpy(mask))
    direct, _ = generate_seq2seq_tokens(seq2seq, torch.from_numpy(ids), torch.from_numpy(mask), None, **static)
    assert torch.equal(tokens, direct) and counts.tolist() == [4, 4, 4]


def test_alibi_generate_tokens_raises_as_jax_does():
    """The JAX function builds the bias over prompt + max_new_tokens keys while its prefill
    attends over the prompt's own K/V (ROADMAP.md Queue C); the port refuses up front."""
    config = dict(ROPE_GQA, position_embedding_type="alibi")
    jax_model, params, model = make_models(config)
    ids, mask = _left_padded_prompts(config["vocab_size"], config["pad_token_id"])
    with pytest.raises(TypeError, match="incompatible shapes"):
        jax_generate_tokens(jax_model, params, jnp.asarray(ids), jnp.asarray(mask), jax.random.PRNGKey(0), 4)
    with pytest.raises(ValueError, match="ServingEngine"):
        generate_tokens(model, torch.from_numpy(ids), torch.from_numpy(mask), None, 4)


def _logits(seed=0, rows=4, vocab=97):
    return np.random.RandomState(seed).randn(rows, vocab).astype(np.float32) * 3.0


@pytest.mark.parametrize(
    "name, arg",
    [("apply_temperature", 0.7), ("apply_temperature", 0.0), ("apply_top_k", 5), ("apply_top_k", 500),
     ("apply_top_p", 0.9), ("apply_top_p", 0.3)],
)
def test_processors_match_jax(name, arg):
    logits = _logits()
    want = np.asarray(getattr(jax_sampling, name)(jnp.asarray(logits), arg))
    got = getattr(sampling, name)(torch.from_numpy(logits), arg).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert ((got == sampling.NEG_INF) == (want == jax_sampling._NEG_INF)).all()


def test_sample_token():
    logits = torch.from_numpy(_logits())
    assert torch.equal(sampling.sample_token(logits), logits.argmax(-1))
    # top-k 1 leaves only the argmax to draw
    only = sampling.sample_token(logits, torch.Generator().manual_seed(0), do_sample=True, temperature=0.5, top_k=1)
    assert torch.equal(only, logits.argmax(-1))
    draws = [
        sampling.sample_token(logits, torch.Generator().manual_seed(3), do_sample=True, temperature=1.5, top_p=0.95)
        for _ in range(2)
    ]
    assert torch.equal(draws[0], draws[1])
    kept = torch.tensor(np.asarray(jax_sampling.apply_top_p(jnp.asarray(logits.numpy() / 1.5), 0.95)))
    assert bool((kept.gather(1, draws[0][:, None]) > sampling.NEG_INF).all())  # never a filtered token


def _caches(rs, batch=3, max_len=8, heads=2, dim=4):
    return {"k": rs.randn(batch, max_len, heads, dim).astype(np.float32), "v": rs.randn(batch, max_len, heads, dim).astype(np.float32)}


@pytest.mark.parametrize(
    "index, seq",
    [(0, 5), (3, 2), (7, 3), (np.array([0, 5, 7], np.int32), 1), (np.array([2, 6, 7], np.int32), 3),
     (np.array(4, np.int32), 2)],
    ids=["scalar_zero", "scalar", "scalar_clamped", "per_row", "per_row_drop", "scalar_tensor"],
)
def test_dense_update_kv_cache_matches_jax(index, seq):
    rs = np.random.RandomState(1)
    cache = _caches(rs)
    key = rs.randn(3, seq, 2, 4).astype(np.float32)
    value = rs.randn(3, seq, 2, 4).astype(np.float32)
    mask = (rs.rand(3, 8) > 0.2).astype(np.int32)
    jax_index = index if isinstance(index, int) else jnp.asarray(index)
    _, _, ref_cache, ref_mask, _ = jax_update_kv_cache(
        jnp.asarray(key), jnp.asarray(value), {n: jnp.asarray(a) for n, a in cache.items()}, jax_index,
        jnp.asarray(mask),
    )
    port_cache = {n: torch.from_numpy(a.copy()) for n, a in cache.items()}
    port_index = index if isinstance(index, int) else torch.from_numpy(index)
    k_view, v_view, got_mask = update_kv_cache(
        torch.from_numpy(key), torch.from_numpy(value), port_cache, port_index, torch.from_numpy(mask)
    )
    for name in ("k", "v"):
        assert np.array_equal(port_cache[name].numpy(), np.asarray(ref_cache[name])), name
    assert k_view is port_cache["k"] and v_view is port_cache["v"]  # written in place
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(ref_mask))


def test_sdpa_row_without_keys_is_finite_in_bf16():
    """A right-padded prefill under flash_attention_2: the padding mask becomes segment ids,
    and off the flash kernel a pad query sees no key. JAX's `sdpa_attention` fills with a
    finite fp32 constant; the port's masked attention must too (bf16 -inf fills gave NaN)."""
    rs = np.random.RandomState(2)
    q, k, v = (rs.randn(1, 12, 4, 8).astype(np.float32) for _ in range(3))
    mask = np.zeros((1, 12), np.int32)
    mask[0, :7] = 1
    ref = jax_attention(
        *(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)), implementation=JaxImpl.flash_attention_2,
        attention_mask=jnp.asarray(mask), softmax_scale=8**-0.5,
    )
    got = attention(
        *(torch.from_numpy(t).bfloat16() for t in (q, k, v)), implementation="flash_attention_2",
        attention_mask=torch.from_numpy(mask), softmax_scale=8**-0.5,
    )
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), atol=2e-2, rtol=0)
