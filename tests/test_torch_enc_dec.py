"""The port's EncDecDolomite against the JAX package's, on the CPU.

- The encoder output, the logits and the loss, with rope (GQA, tied head) and with T5's
  ``relative_bucketed`` bias (MHA, untied head, unscaled attention, a gated tanh-gelu),
  over a left-padded encoder batch and IGNORE_INDEX-padded targets, an encoder deeper than
  the decoder; fp32, atol = rtol = 1e-5 (the JAX package's own attention tolerance).
- The gradient of every parameter, both relative-bias tables included, against
  ``jax.grad`` (jitted); rtol 1e-5, atol 2e-5 (`GRAD_TOL`: the shared embedding table's
  gradient sums its encoder and decoder lookups, and jitted XLA orders that sum its own
  way).
- `load_jax_params` over an unrolled and a scanned (``scan_layers``) tree: the same
  logits as the JAX model that owns the tree.
- Decoding over the caches (`encode`, `precompute_cross_kv`, one token a step) gives the
  logits of the full decoder pass, as in JAX.
- The registry: `enc_dec_dolomite` builds, `is_encoder_decoder_model`, the other
  decoder-only families built as such.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from dolomite_engine_tpu.models import get_model_class as jax_model_class
from dolomite_engine_tpu.models.config import EncDecDolomiteConfig as JaxConfig
from dolomite_engine_tpu.models.enc_dec_dolomite import EncDecDolomiteForSeq2SeqLM as JaxModel
from dolomite_engine_tpu.models.enc_dec_dolomite import stack_enc_dec_params
from dolomite_engine_tpu_torch import models
from dolomite_engine_tpu_torch.models import EncDecDolomiteConfig, EncDecDolomiteForSeq2SeqLM, load_jax_params
from dolomite_engine_tpu_torch.ops.loss import IGNORE_INDEX

VOCAB = 96
BASE = dict(
    model_type="enc_dec_dolomite", vocab_size=VOCAB, n_positions=64, n_embd=64, n_layer=2, n_encoder_layer=3,
    n_head=4, normalization_function="rmsnorm", add_bias=False, resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0,
    bos_token_id=0, eos_token_id=1, pad_token_id=2, initializer_range=0.1,
)
ROPE_GQA = dict(
    BASE, num_key_value_heads=2, attention_head_type="gqa", position_embedding_type="rope",
    activation_function="swiglu",
)
T5_MHA = dict(
    BASE, num_key_value_heads=4, attention_head_type="mha", position_embedding_type="relative_bucketed",
    relative_attention_num_buckets=8, relative_attention_max_distance=12, activation_function="gelu_pytorch_tanh_glu",
    tie_word_embeddings=False, attention_multiplier=1.0, layer_norm_epsilon=1e-6, decoder_start_token_id=0,
)
CONFIGS = {"rope_gqa": ROPE_GQA, "t5_mha": T5_MHA}
TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=2e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(seed=0, rows=3, enc=13, dec=9):
    """Left-padded encoder ids with their mask and IGNORE_INDEX-padded targets ending in EOS."""
    rs = np.random.RandomState(seed)
    input_ids = rs.randint(3, VOCAB, (rows, enc)).astype(np.int32)
    mask = np.ones((rows, enc), np.int32)
    labels = rs.randint(3, VOCAB, (rows, dec)).astype(np.int32)
    for row, (pad, length) in enumerate(zip(rs.randint(0, enc - 2, rows), rs.randint(2, dec + 1, rows))):
        input_ids[row, :pad], mask[row, :pad] = 1, 0
        labels[row, length - 1] = 1
        labels[row, length:] = IGNORE_INDEX
    return input_ids, mask, labels


def jax_model_and_params(config, seed=1, scan=False):
    model = JaxModel(config=JaxConfig(**config), scan_layers=scan)
    ids, mask, labels = _batch()
    params = model.init(jax.random.PRNGKey(seed), jnp.asarray(ids), jnp.asarray(mask), labels=jnp.asarray(labels))
    return model, nn.unbox(params["params"])


def port_model(config, params):
    model = EncDecDolomiteForSeq2SeqLM(EncDecDolomiteConfig(**config), device="cpu")
    return load_jax_params(model, jax.tree.map(np.asarray, params), device="cpu")


def _flat(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        name = f"{prefix}.{key}" if prefix else key
        out.update(_flat(value, name) if isinstance(value, dict) else {name: np.asarray(value)})
    return out


def port_name(flax_name):
    """The port's parameter name of an unrolled flax leaf path."""
    parts = flax_name.split(".")
    for stack in ("encoder", "decoder"):
        if parts[0].startswith(stack + "_"):
            parts[0:1] = [stack, parts[0][len(stack) + 1 :]]
    leaf = parts[-1]
    return ".".join(parts[:-1] + ["weight" if leaf in ("kernel", "embedding") else leaf])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_encoder_logits_and_loss_match_jax(name):
    config = CONFIGS[name]
    jax_model, params = jax_model_and_params(config)
    ids, mask, labels = _batch(seed=5)
    variables = {"params": params}
    want_enc = jax_model.apply(variables, jnp.asarray(ids), jnp.asarray(mask), method="encode")
    want = jax_model.apply(variables, jnp.asarray(ids), jnp.asarray(mask), labels=jnp.asarray(labels))
    model = port_model(config, params)
    t = lambda a: torch.as_tensor(a).long()
    enc = model.encode(t(ids), t(mask))
    out = model(t(ids), t(mask), labels=t(labels))
    np.testing.assert_allclose(enc.detach().numpy(), np.asarray(want_enc), **TOL)
    np.testing.assert_allclose(out.logits.detach().numpy(), np.asarray(want.logits), **TOL)
    np.testing.assert_allclose(out.loss.item(), float(want.loss), **TOL)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_every_gradient_matches_jax(name):
    config = CONFIGS[name]
    jax_model, params = jax_model_and_params(config, seed=2)
    ids, mask, labels = _batch(seed=6)

    def loss_fn(p):
        return jax_model.apply({"params": p}, jnp.asarray(ids), jnp.asarray(mask), labels=jnp.asarray(labels)).loss

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    model = port_model(config, params)
    t = lambda a: torch.as_tensor(a).long()
    loss = model(t(ids), t(mask), labels=t(labels)).loss
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), **TOL)
    named = dict(model.named_parameters())
    flat = _flat(want_grads)
    assert len(flat) == len(named)
    if name == "t5_mha":
        assert {"rel_bias_enc.embedding", "rel_bias_dec.embedding"} <= set(flat)
    for flax_name, want in flat.items():
        if flax_name.endswith("kernel"):
            want = want.T
        grad = named[port_name(flax_name)].grad
        np.testing.assert_allclose(grad.numpy(), want, **GRAD_TOL, err_msg=flax_name)


@pytest.mark.parametrize("scan", [False, True], ids=["unrolled", "scanned"])
def test_load_jax_params_unrolled_and_scanned(scan):
    jax_model, params = jax_model_and_params(T5_MHA, seed=3, scan=scan)
    if scan:
        assert "encoder_scan" in params and "decoder_scan" in params
    ids, mask, labels = _batch(seed=7)
    want = jax_model.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask), labels=jnp.asarray(labels))
    model = port_model(T5_MHA, params)
    t = lambda a: torch.as_tensor(a).long()
    got = model(t(ids), t(mask), labels=t(labels))
    np.testing.assert_allclose(got.logits.detach().numpy(), np.asarray(want.logits), **TOL)
    if not scan:  # the JAX stacking of this tree loads to the same weights
        stacked = stack_enc_dec_params(params, T5_MHA["n_encoder_layer"], T5_MHA["n_layer"])
        again = port_model(T5_MHA, stacked)
        assert all(torch.equal(a, b) for a, b in zip(model.parameters(), again.parameters()))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_cached_decoding_matches_the_full_decoder_pass(name):
    """`encode` once, cross K/V projected once, then one decoder token a step over the dense
    cache: each step's logits equal the full teacher-forced pass's at that position, as the
    JAX model's do."""
    config = CONFIGS[name]
    jax_model, params = jax_model_and_params(config, seed=4)
    ids, mask, labels = _batch(seed=8)
    labels = np.where(labels == IGNORE_INDEX, 2, labels)
    model = port_model(config, params)
    t = lambda a: torch.as_tensor(a).long()
    with torch.no_grad():
        full = model(t(ids), t(mask), labels=t(labels)).logits
        enc = model.encode(t(ids), t(mask))
        cross = model.precompute_cross_kv(enc)
        caches = model.init_kv_caches(ids.shape[0], labels.shape[1])
        from dolomite_engine_tpu_torch.models.enc_dec_dolomite import shift_right

        decoder_ids = shift_right(t(labels), model.config.decoder_start_token_id, 2)
        steps = []
        for i in range(labels.shape[1]):
            out = model(
                None, t(mask), decoder_input_ids=decoder_ids[:, i : i + 1], encoder_hidden_states=enc,
                kv_caches=caches, cross_kv_caches=cross, cache_index=i,
            )
            steps.append(out.logits[:, -1])
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), full.numpy(), atol=2e-5, rtol=2e-5)
    variables = {"params": params}
    jax_enc = jax_model.apply(variables, jnp.asarray(ids), jnp.asarray(mask), method="encode")
    jax_cross = jax_model.apply(variables, jax_enc, method="precompute_cross_kv")
    for (k, v), (jk, jv) in zip(cross, jax_cross):
        np.testing.assert_allclose(k.numpy(), np.asarray(jk), **TOL)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), **TOL)


def test_registry():
    assert models.get_model_class("enc_dec_dolomite") is EncDecDolomiteForSeq2SeqLM
    assert isinstance(models.config_from_dict(dict(T5_MHA)), EncDecDolomiteConfig)
    assert models.is_encoder_decoder_model("enc_dec_dolomite") and not models.is_encoder_decoder_model("gpt_dolomite")
    assert jax_model_class("enc_dec_dolomite") is JaxModel
    for other in ("gpt_crosslayer", "dense_moe", "rnn_dolomite"):
        assert not models.is_encoder_decoder_model(other) and models.get_model_class(other).model_type == other
    config = EncDecDolomiteConfig(**dict(ROPE_GQA, n_encoder_layer=None, decoder_start_token_id=None, bos_token_id=None))
    want = JaxConfig(**dict(ROPE_GQA, n_encoder_layer=None, decoder_start_token_id=None, bos_token_id=None))
    assert (config.n_encoder_layer, config.decoder_start_token_id) == (want.n_encoder_layer, want.decoder_start_token_id) == (2, 2)
    with pytest.raises(ValueError, match="does not support position_embedding_type"):
        EncDecDolomiteConfig(**dict(ROPE_GQA, position_embedding_type="alibi"))
