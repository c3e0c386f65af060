"""The port's GPTCrossLayer (cross-layer KV sharing) against the JAX package's, on the CPU.

- The config's checks (the same AssertionErrors), logits and loss for four sharing
  patterns, with `joint_residual_stream` and with biases; `load_jax_params` carries the
  ``h_<group>`` trees.
- The conversion from a dense model against JAX's (every weight equal, the logits too),
  the identity pattern against the dense model, a parent that is not its group's first
  layer.
- Cache decode (a prefill, then one decode step a token) over a dense cache and a paged
  pool against the full forward; greedy `serve_batch` tokens equal to the JAX engine's
  over both pools, at half the bytes a token of the dense model's pool under CLA2.
- One train step, `pretrain.main` on a tiny YAML, the tflops formula, and the calls that
  fail in JAX (HF export, LoRA's default target, ``scan_layers``) refused with a
  ValueError.
- The base model's block hooks (`num_blocks`, `_make_block`, `dense_kv_cache`) leave a
  dense model as it was: the same seeded weights, bit-identical logits, training and
  cache-decode outputs and the same kernel launches as blocks built directly (the
  launches on the card in the test's ``cuda`` case, which skips without one).

Tolerances: `tests/torch_families.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from torch import nn as tnn

from dolomite_engine_tpu.arguments import TuningArgs as JaxTuningArgs
from dolomite_engine_tpu.enums import Mode as JaxMode
from dolomite_engine_tpu.hf_interop.weights import params_to_state_dict as jax_params_to_state_dict
from dolomite_engine_tpu.model_wrapper.peft import ModelWrapperForPEFT as JaxPEFT
from dolomite_engine_tpu.model_wrapper.pretraining import ModelWrapperForPretraining as JaxPretraining
from dolomite_engine_tpu.models.config import CommonConfig as JaxCommonConfig
from dolomite_engine_tpu.models.config import GPTCrossLayerConfig as JaxCrossLayerConfig
from dolomite_engine_tpu.models.gpt_crosslayer import GPTCrossLayerForCausalLM as JaxCrossLayerLM
from dolomite_engine_tpu.models.gpt_crosslayer import convert_gpt_dolomite_to_gpt_crosslayer as jax_convert
from dolomite_engine_tpu.models.gpt_dolomite import GPTDolomiteForCausalLM as JaxDense
from dolomite_engine_tpu.train_utils import get_model_tflops as jax_get_model_tflops
from dolomite_engine_tpu_torch.arguments import TuningArgs
from dolomite_engine_tpu_torch.hf_interop.weights import params_to_state_dict
from dolomite_engine_tpu_torch.model_wrapper import ModelWrapperForPEFT, ModelWrapperForPretraining
from dolomite_engine_tpu_torch.models import (
    CommonConfig,
    GPTCrossLayerConfig,
    GPTCrossLayerForCausalLM,
    GPTDolomiteForCausalLM,
    convert_gpt_dolomite_to_gpt_crosslayer,
    get_model_class,
    load_jax_params,
)
from dolomite_engine_tpu_torch.models.gpt_crosslayer import group_layout
from dolomite_engine_tpu_torch.models.modeling_utils import Block
from dolomite_engine_tpu_torch.ops.kernels import KERNELS, reset_launch_counts
from dolomite_engine_tpu_torch.train_utils import get_model_tflops
from tests.torch_families import (
    BASE,
    TOL,
    cache_decode_logits,
    logits_and_loss_match,
    make_family_models,
    pretrain_on_yaml,
    serve_both,
    train_step_matches_jax,
)

CL = dict(BASE, model_type="gpt_crosslayer", num_key_value_heads=2, sharing_pattern=[0, 0, 2, 2])
PATTERNS = [[0, 1, 2, 3], [0, 0, 2, 2], [0, 0, 0, 3], [0, 2, 2, 2]]
DENSE = {k: v for k, v in dict(BASE, num_key_value_heads=2, attention_head_type="gqa").items()}


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_config_checks_match_jax():
    for cls in (GPTCrossLayerConfig, JaxCrossLayerConfig):
        config = cls(**dict(CL, sharing_pattern=None, attention_head_type="mha", num_key_value_heads=None))
        assert config.sharing_pattern == [0, 1, 2, 3] and config.attention_head_type == "gqa"
        assert config.num_key_value_heads == 4
        for bad in ([0, 0, 1, 1], [0, 2, 1, 3], [0, 0, 2]):  # no parent, decreasing, wrong length
            with pytest.raises(AssertionError):
                cls(**dict(CL, sharing_pattern=bad))
    assert group_layout([0, 0, 2, 2, 4]) == [2, 2, 1]
    model = get_model_class("gpt_crosslayer")(GPTCrossLayerConfig(**CL), device="cpu")
    assert isinstance(model, GPTCrossLayerForCausalLM) and len(model.transformer.h) == 2
    assert [len(g.layers) for g in model.transformer.h] == [2, 2]
    assert len(model.init_kv_caches(1, 8)) == 2  # one cache a KV group


@pytest.mark.parametrize(
    "variant",
    [dict(sharing_pattern=p) for p in PATTERNS]
    + [dict(sharing_pattern=[0, 0, 2, 2], joint_residual_stream=True), dict(sharing_pattern=[0, 2, 2, 2], add_bias=True)],
    ids=[str(p) for p in PATTERNS] + ["joint_residual_stream", "add_bias"],
)
def test_logits_and_loss_match_jax(variant):
    logits_and_loss_match(*make_family_models(dict(CL, **variant)))


@pytest.mark.parametrize("pattern", [[0, 1, 2, 3], [0, 0, 2, 2], [0, 2, 2, 2]])
def test_conversion_matches_jax(pattern):
    """JAX's converter on the dense params against the port's on the dense model: every
    converted weight equal, and the converted models' logits (the identity pattern: the
    dense model's logits)."""
    dense_jax = JaxDense(config=JaxCommonConfig(**DENSE))
    params = nn.unbox(dense_jax.init(jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32))["params"])
    dense = GPTDolomiteForCausalLM(CommonConfig(**DENSE), device="cpu")
    load_jax_params(dense, jax.tree.map(np.asarray, params), device="cpu")
    cl_config, cl_params = jax_convert(dense_jax.config, params, pattern)
    converted = convert_gpt_dolomite_to_gpt_crosslayer(dense, pattern)
    assert converted.config.sharing_pattern == cl_config.sharing_pattern == pattern
    reference = GPTCrossLayerForCausalLM(converted.config, device="cpu")
    load_jax_params(reference, cl_params, device="cpu")  # JAX's converted weights
    for (name, got), (_, want) in zip(converted.state_dict().items(), reference.state_dict().items()):
        torch.testing.assert_close(got, want, atol=0, rtol=0, msg=name)
    ids = np.random.RandomState(2).randint(3, 96, (2, 24))
    want = JaxCrossLayerLM(config=cl_config).apply({"params": cl_params}, jnp.asarray(ids)).logits
    with torch.no_grad():
        got = converted(torch.from_numpy(ids)).logits
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        if pattern == [0, 1, 2, 3]:
            np.testing.assert_allclose(got.numpy(), dense(torch.from_numpy(ids)).logits.numpy(), **TOL)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_cache_decode_matches_the_full_forward(paged):
    jax_model, params, model = make_family_models(dict(CL, sharing_pattern=[0, 0, 0, 3]))
    ids = np.random.RandomState(5).randint(3, 96, (1, 20))
    want = np.asarray(jax_model.apply({"params": params}, jnp.asarray(ids)).logits)
    got = cache_decode_logits(model, torch.from_numpy(ids), 13, paged)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_greedy_serving_matches_the_jax_engine(paged):
    engine, jax_engine = serve_both(*make_family_models(dict(CL, initializer_range=0.3)), paged=paged)
    # CLA2 holds one cache a group: half the dense (4-cache) pool's bytes a token
    assert len(engine.pool.caches) == 2
    assert engine.pool.kv_bytes_per_token == jax_engine.pool.kv_bytes_per_token == 2 * 2 * 2 * 8 * 4
    if paged:
        assert engine.stats.prefix_hit_tokens == jax_engine.stats.prefix_hit_tokens > 0


def test_train_step_matches_jax():
    port = train_step_matches_jax(dict(CL, sharing_pattern=[0, 2, 2, 2], joint_residual_stream=True))
    assert isinstance(port.model, GPTCrossLayerForCausalLM)


def test_pretrain_main_on_a_yaml(tmp_path):
    pretrain_on_yaml(tmp_path, dict(CL, vocab_size=128, n_positions=64))


@pytest.mark.parametrize("every", [0, 2])
def test_model_tflops_match_jax(every):
    args = {"checkpoint_every": every} if every else None
    want = jax_get_model_tflops(JaxCrossLayerConfig(**CL), 2, 512, None, args)
    assert get_model_tflops(GPTCrossLayerConfig(**CL), 2, 512, None, args) == pytest.approx(want, rel=1e-12)


def test_calls_that_fail_in_jax_are_refused():
    _, params, model = make_family_models(CL)
    with pytest.raises(KeyError, match="ln_1"):
        jax_params_to_state_dict(JaxCrossLayerConfig(**CL), params)
    with pytest.raises(ValueError, match="no HF dolomite layout"):
        params_to_state_dict(model.config, model.state_dict())
    with pytest.raises(ValueError, match="scan_layers supports"):
        JaxPretraining(mode=JaxMode.training, pretrained_config=CL, model_kwargs={"scan_layers": True})
    with pytest.raises(ValueError, match="scan_layers supports"):
        ModelWrapperForPretraining(CL, device="cpu", scan_layers=True)


LORA = dict(tuning_method="lora", lora_args=dict(lora_rank=4, lora_alpha=8.0, lora_dropout=0.0))


def test_lora_default_target_adapts_nothing_in_jax_and_is_refused():
    """The default target ``c_attn`` names none of this family's projections: JAX's LoRA
    builds no adapter and its trainable mask is all False; the port refuses."""
    wrapper = JaxPEFT(mode=JaxMode.training, pretrained_config=CL, dtype="fp32", zero_stage=0, tuning_args=JaxTuningArgs(**LORA))
    params = nn.unbox(wrapper.model.init(jax.random.PRNGKey(0), **wrapper.get_dummy_inputs())["params"])
    leaves = jax.tree_util.tree_leaves_with_path(params)
    assert not any("lora" in jax.tree_util.keystr(path) for path, _ in leaves)
    assert not any(jax.tree.leaves(wrapper.trainable_mask(params)))
    with pytest.raises(ValueError, match="its linears: c_fc, c_proj, kv_attn, q_attn"):
        ModelWrapperForPEFT(CL, dtype="fp32", device="cpu", tuning_args=TuningArgs(**LORA))


def test_lora_on_the_query_and_kv_projections_matches_jax():
    lora = dict(LORA, lora_args=dict(LORA["lora_args"], lora_target_modules=["q_attn", "kv_attn"]))
    wrapper = JaxPEFT(mode=JaxMode.training, pretrained_config=CL, dtype="fp32", zero_stage=0, tuning_args=JaxTuningArgs(**lora))
    params = nn.unbox(wrapper.model.init(jax.random.PRNGKey(0), **wrapper.get_dummy_inputs())["params"])
    rs = np.random.RandomState(2)
    params = jax.tree_util.tree_map_with_path(
        lambda path, leaf: jnp.asarray(rs.normal(0, 0.3, leaf.shape), jnp.float32) if path[-1].key == "lora_b" else leaf,
        params,
    )
    ids = np.random.RandomState(3).randint(3, 96, (2, 16))
    batch = {"input_ids": ids, "labels": ids}
    want, grads = jax.value_and_grad(lambda p: wrapper.loss(p, {k: jnp.asarray(v) for k, v in batch.items()}, train=False))(params)
    port = ModelWrapperForPEFT(CL, dtype="fp32", device="cpu", tuning_args=TuningArgs(**lora))
    load_jax_params(port.model, jax.tree.map(np.asarray, params), device="cpu")
    assert len(port.lora_modules) == 2 + 4  # a kv_attn a group, a q_attn a layer
    loss = port.loss({k: torch.from_numpy(v) for k, v in batch.items()}, train=False)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), **TOL)
    group = grads["base_model"]["transformer"]["h_1"]
    layer = port.model.transformer.h[1]
    np.testing.assert_allclose(layer.kv_proj.kv_attn.lora_a.grad.numpy(), np.asarray(group["kv_proj"]["kv_attn"]["lora_a"]).T, **TOL)
    np.testing.assert_allclose(layer.layers[1].attn.q_attn.lora_b.grad.numpy(), np.asarray(group["layers_1_attn"]["q_attn"]["lora_b"]).T, **TOL)


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_dense_model_is_unchanged_by_the_block_hooks(device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    config = CommonConfig(**dict(DENSE, n_positions=512))
    dtype = torch.float32 if device == "cpu" else torch.bfloat16
    kwargs = dict(dtype=dtype, device=device, seed=3, attention_implementation="flash_attention_2")
    hooked = GPTDolomiteForCausalLM(config, **kwargs)
    direct = GPTDolomiteForCausalLM(config, **kwargs)
    # the construction before the hooks: n_layer blocks built directly
    direct.transformer.h = tnn.ModuleList(
        Block(config, dtype, torch.device(device), None, "flash_attention_2") for _ in range(config.n_layer)
    )
    direct.transformer.set_remat(1)
    hooked.transformer.set_remat(1)
    direct.init_weights(3)
    assert hooked.transformer.num_blocks == config.n_layer
    for (name, a), (other, b) in zip(hooked.state_dict().items(), direct.state_dict().items()):
        assert name == other and torch.equal(a, b), name
    ids = torch.from_numpy(np.random.RandomState(4).randint(3, 96, (2, 128))).to(device)
    results = []
    for model in (hooked, direct):
        reset_launch_counts()
        loss = model(ids, labels=ids).loss
        loss.backward()
        with torch.no_grad():
            caches = model.init_kv_caches(2, 136)
            prefill = model(ids, kv_caches=caches, cache_index=0).logits
            step = model(ids[:, :1], kv_caches=caches, cache_index=128).logits
        grads = [p.grad for p in model.parameters()]
        results.append((loss, prefill, step, grads, len(caches), {k.name: k.launches for k in KERNELS}))
    for got, want in zip(*results):
        if isinstance(got, list):
            assert all(torch.equal(a, b) for a, b in zip(got, want))
        elif isinstance(got, torch.Tensor):
            assert torch.equal(got, want)
        else:
            assert got == want
    if device == "cuda":
        assert results[0][-1]["flash_attn_fwd"] > 0 and results[0][-1]["rmsnorm"] > 0
