"""The port's DenseMoE (dense training, sparse inference) against the JAX package's, on the
CPU.

- The config's checks, `mask_probability` (threshold, top-k, the unknown method's
  ValueError), logits and loss with ``inference_method`` None, top-k and threshold
  (the routing gates carried by `load_jax_params`).
- Cache decode over a dense cache and a paged pool against the full forward; greedy
  `serve_batch` tokens equal to the JAX engine's over both pools, dense and top-k.
- One train step, `pretrain.main` on a tiny YAML, the tflops formula (the wide MLP:
  every expert a token), LoRA on its ``c_attn`` as JAX, and the HF export as JAX's: the
  same tensors, the routing gates left out, so the directory does not load back (JAX
  fails applying it, the port's loader raises a ValueError).

Tolerances: `tests/torch_families.py`; `mask_probability` exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from dolomite_engine_tpu.arguments import TuningArgs as JaxTuningArgs
from dolomite_engine_tpu.enums import Mode as JaxMode
from dolomite_engine_tpu.hf_interop.weights import params_to_state_dict as jax_params_to_state_dict
from dolomite_engine_tpu.hf_interop.weights import state_dict_to_params as jax_state_dict_to_params
from dolomite_engine_tpu.model_wrapper.peft import ModelWrapperForPEFT as JaxPEFT
from dolomite_engine_tpu.models.config import DenseMoEConfig as JaxDenseMoEConfig
from dolomite_engine_tpu.models.dense_moe import mask_probability as jax_mask_probability
from dolomite_engine_tpu.train_utils import get_model_tflops as jax_get_model_tflops
from dolomite_engine_tpu_torch.arguments import TuningArgs
from dolomite_engine_tpu_torch.hf_interop.weights import params_to_state_dict, state_dict_to_params
from dolomite_engine_tpu_torch.model_wrapper import ModelWrapperForFinetuning, ModelWrapperForPEFT
from dolomite_engine_tpu_torch.models import DenseMoEConfig, DenseMoEForCausalLM, get_model_class, load_jax_params
from dolomite_engine_tpu_torch.models.dense_moe import mask_probability
from dolomite_engine_tpu_torch.train_utils import get_model_tflops
from dolomite_engine_tpu_torch.utils.safetensors import SafeTensorsWeightsManager
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

DM = dict(BASE, model_type="dense_moe", num_experts=2, n_inner=32)
METHODS = {"dense": None, "top_k": {"top_k": 1}, "threshold": {"threshold": 0.45}}


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_config_checks_match_jax():
    for cls in (DenseMoEConfig, JaxDenseMoEConfig):
        config = cls(**DM)
        assert (config.num_key_value_heads, config.attention_head_type) == (2, "gqa")
        config = cls(**dict(DM, num_experts=4))
        assert (config.num_key_value_heads, config.attention_head_type) == (4, "mha")
        with pytest.raises(AssertionError, match="divisible by the number of experts"):
            cls(**dict(DM, num_experts=3))
    model = get_model_class("dense_moe")(DenseMoEConfig(**DM), device="cpu", inference_method={"top_k": 1})
    assert isinstance(model, DenseMoEForCausalLM)
    block = model.transformer.h[0]
    assert block.attn.inference_method == block.mlp.inference_method == {"top_k": 1}
    assert tuple(block.mlp.c_fc.weight.shape) == (2 * 2 * 32, 32)  # [up | gate] of E * n_inner


def test_mask_probability_matches_jax():
    p = np.random.RandomState(0).dirichlet(np.ones(4), size=(3, 5)).astype(np.float32)
    for method in (None, {"top_k": 2}, {"top_k": 1}, {"threshold": 0.3}):
        got = mask_probability(torch.from_numpy(p), method).numpy()
        np.testing.assert_array_equal(got, np.asarray(jax_mask_probability(jnp.asarray(p), method)))
    assert ((mask_probability(torch.from_numpy(p), {"top_k": 2}) > 0).sum(-1) == 2).all()  # not renormalised
    for fn, array in ((mask_probability, torch.from_numpy(p)), (jax_mask_probability, jnp.asarray(p))):
        with pytest.raises(ValueError, match="unexpected inference_method"):
            fn(array, {"top_p": 0.5})


@pytest.mark.parametrize("method", list(METHODS))
def test_logits_and_loss_match_jax(method):
    logits_and_loss_match(*make_family_models(DM, inference_method=METHODS[method]))


def test_logits_with_biases_match_jax():
    logits_and_loss_match(*make_family_models(dict(DM, add_bias=True, num_experts=4)))


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_cache_decode_matches_the_full_forward(paged):
    jax_model, params, model = make_family_models(DM, inference_method={"top_k": 1})
    ids = np.random.RandomState(5).randint(3, 96, (1, 20))
    want = np.asarray(jax_model.apply({"params": params}, jnp.asarray(ids)).logits)
    got = cache_decode_logits(model, torch.from_numpy(ids), 13, paged)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
@pytest.mark.parametrize("method", ["dense", "top_k"])
def test_greedy_serving_matches_the_jax_engine(paged, method):
    config = dict(DM, initializer_range=0.3)
    engine, _ = serve_both(*make_family_models(config, inference_method=METHODS[method]), paged=paged)
    assert len(engine.pool.caches) == DM["n_layer"]


def test_train_step_matches_jax():
    assert isinstance(train_step_matches_jax(DM).model, DenseMoEForCausalLM)


def test_pretrain_main_on_a_yaml(tmp_path):
    pretrain_on_yaml(tmp_path, dict(DM, vocab_size=128, n_positions=64))


@pytest.mark.parametrize("every", [0, 1])
def test_model_tflops_match_jax(every):
    args = {"checkpoint_every": every} if every else None
    want = jax_get_model_tflops(JaxDenseMoEConfig(**DM), 2, 512, None, args)
    assert get_model_tflops(DenseMoEConfig(**DM), 2, 512, None, args) == pytest.approx(want, rel=1e-12)


def test_lora_default_target_matches_jax():
    lora = dict(tuning_method="lora", lora_args=dict(lora_rank=4, lora_alpha=8.0, lora_dropout=0.0))
    wrapper = JaxPEFT(mode=JaxMode.training, pretrained_config=DM, dtype="fp32", zero_stage=0, tuning_args=JaxTuningArgs(**lora))
    params = nn.unbox(wrapper.model.init(jax.random.PRNGKey(0), **wrapper.get_dummy_inputs())["params"])
    rs = np.random.RandomState(2)
    params = jax.tree_util.tree_map_with_path(
        lambda path, leaf: jnp.asarray(rs.normal(0, 0.3, leaf.shape), jnp.float32) if path[-1].key == "lora_b" else leaf,
        params,
    )
    ids = np.random.RandomState(3).randint(3, 96, (2, 16))
    batch = {"input_ids": ids, "labels": ids}
    want, grads = jax.jit(jax.value_and_grad(lambda p, b: wrapper.loss(p, b, train=False)))(
        params, {k: jnp.asarray(v) for k, v in batch.items()}
    )
    port = ModelWrapperForPEFT(DM, dtype="fp32", device="cpu", tuning_args=TuningArgs(**lora))
    load_jax_params(port.model, jax.tree.map(np.asarray, params), device="cpu")
    assert port.lora_modules == [f"transformer.h.{i}.attn.c_attn" for i in range(4)]
    loss = port.loss({k: torch.from_numpy(v) for k, v in batch.items()}, train=False)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), **TOL)
    for i in range(4):
        c_attn = port.model.transformer.h[i].attn.c_attn
        want_grads = grads["base_model"]["transformer"][f"h_{i}"]["attn"]["c_attn"]
        np.testing.assert_allclose(c_attn.lora_a.grad.numpy(), np.asarray(want_grads["lora_a"]).T, **TOL)
        np.testing.assert_allclose(c_attn.lora_b.grad.numpy(), np.asarray(want_grads["lora_b"]).T, **TOL)


def test_hf_export_leaves_out_the_gates_as_jax(tmp_path):
    jax_model, params, model = make_family_models(dict(DM, add_bias=True))
    config = JaxDenseMoEConfig(**dict(DM, add_bias=True))
    want = jax_params_to_state_dict(config, params)
    got = params_to_state_dict(model.config, model.state_dict())
    assert list(got) == list(want) and not any("gate" in name for name in got)
    for name, tensor in got.items():
        np.testing.assert_array_equal(tensor.numpy(), np.asarray(want[name]), err_msg=name)
    # the directory does not load back: JAX's params lack the gates its model reads
    back = jax_state_dict_to_params(config, lambda name: want[name])
    with pytest.raises(Exception, match="gate"):
        jax_model.apply({"params": back}, jnp.zeros((1, 8), jnp.int32))
    assert set(state_dict_to_params(model.config, lambda name: got[name])) == set(model.state_dict()) - {
        f"transformer.h.{i}.{m}.gate.weight" for i in range(4) for m in ("attn", "mlp")
    }
    wrapper = ModelWrapperForFinetuning(dict(DM, add_bias=True), device="cpu")
    wrapper.model = model
    wrapper.save_pretrained(str(tmp_path))
    assert len(SafeTensorsWeightsManager(str(tmp_path))) == len(want)
    with pytest.raises(ValueError, match=r"missing \['transformer.h.0.attn.gate.weight'"):
        wrapper.load_pretrained_params(str(tmp_path))
