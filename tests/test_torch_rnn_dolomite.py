"""The port's RNNDolomite (the DeltaNet / attention hybrid) against the JAX package's, on the
CPU.

- The config's checks; logits and loss for the patterns ``dddd``, ``adad`` and ``ddda``
  at a length the delta rule runs recurrently (40) and at 64 * 2, where it runs chunked;
  `load_jax_params` carries the DeltaNet weights (projections, the fp32 ``[D, W]``
  convolutions, ``o_norm``).
- Left-padded greedy `generation_utils.generate_tokens` (the mixed recurrent and K/V
  caches) against JAX's, with and without EOS.
- `ServingEngine` (both pools) and `generate.main` refused with a ValueError, each beside
  the JAX failure it mirrors; the HF export refused beside JAX's KeyError.
- One train step, `pretrain.main` on a tiny YAML, the tflops formula, LoRA's default
  target (the attention layers' ``c_attn``) against JAX's.

Tolerances: `tests/torch_families.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

import chip_smoke
from dolomite_engine_tpu import generate as jax_generate
from dolomite_engine_tpu.arguments import InferenceArgs as JaxInferenceArgs
from dolomite_engine_tpu.arguments import TuningArgs as JaxTuningArgs
from dolomite_engine_tpu.data import get_datasets_list as jax_get_datasets_list
from dolomite_engine_tpu.enums import DatasetSplit as JaxSplit
from dolomite_engine_tpu.enums import Mode as JaxMode
from dolomite_engine_tpu.generation_utils import generate_tokens as jax_generate_tokens
from dolomite_engine_tpu.hf_interop.weights import params_to_state_dict as jax_params_to_state_dict
from dolomite_engine_tpu.model_wrapper import ModelWrapperForFinetuning as JaxWrapper
from dolomite_engine_tpu.model_wrapper.peft import ModelWrapperForPEFT as JaxPEFT
from dolomite_engine_tpu.models.config import RNNDolomiteConfig as JaxRNNConfig
from dolomite_engine_tpu.ops.pallas import kernel_overrides
from dolomite_engine_tpu.serving import ServingEngine as JaxServingEngine
from dolomite_engine_tpu.train_utils import get_model_tflops as jax_get_model_tflops
from dolomite_engine_tpu_torch import generate
from dolomite_engine_tpu_torch.arguments import InferenceArgs, TuningArgs
from dolomite_engine_tpu_torch.generation_utils import generate_tokens
from dolomite_engine_tpu_torch.hf_interop.weights import params_to_state_dict
from dolomite_engine_tpu_torch.model_wrapper import ModelWrapperForPEFT
from dolomite_engine_tpu_torch.models import RNNDolomiteConfig, RNNDolomiteForCausalLM, get_model_class, load_jax_params
from dolomite_engine_tpu_torch.serving import ServingEngine
from dolomite_engine_tpu_torch.train_utils import get_model_tflops
from tests.test_torch_data import WordTokenizer
from tests.test_torch_generate import _inference_config, _write_prompts
from tests.test_torch_model import ALL_KERNELS
from tests.test_torch_serving import ENGINE_ARGS
from tests.torch_families import (
    BASE,
    TOL,
    logits_and_loss_match,
    make_family_models,
    pretrain_on_yaml,
    train_step_matches_jax,
)

RNN = dict(BASE, model_type="rnn_dolomite", attention_pattern="adad", num_key_value_heads=2, attention_head_type="gqa")


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_config_checks_match_jax():
    for cls in (RNNDolomiteConfig, JaxRNNConfig):
        assert cls(**dict(RNN, attention_pattern=None)).attention_pattern == "dddd"
        for bad in ("ada", "adax"):
            with pytest.raises(AssertionError):
                cls(**dict(RNN, attention_pattern=bad))
    model = get_model_class("rnn_dolomite")(RNNDolomiteConfig(**RNN), device="cpu")
    assert isinstance(model, RNNDolomiteForCausalLM)
    assert [block.mixer for block in model.transformer.h] == list("adad")
    assert model.transformer.h[1].attn.q_conv1d.weight.dtype == torch.float32
    caches = model.init_kv_caches(2, 16)
    assert set(caches[0]) == {"k", "v"} and set(caches[1]) == {"conv_q", "conv_k", "conv_v", "recurrent"}
    assert caches[1]["conv_q"].shape == (2, 32, 4) and caches[1]["recurrent"].shape == (2, 4, 8, 8)


@pytest.mark.parametrize("length", [40, 128], ids=["recurrent", "chunked"])
@pytest.mark.parametrize("pattern", ["dddd", "adad", "ddda"])
def test_logits_and_loss_match_jax(pattern, length):
    logits_and_loss_match(*make_family_models(dict(RNN, attention_pattern=pattern)), length=length)


def _left_padded(vocab, pad, width):
    rs = np.random.RandomState(0)
    ids = rs.randint(3, vocab, (3, width))
    mask = np.ones((3, width), np.int32)
    for row, pads in ((1, 5), (2, 11)):
        ids[row, :pads] = pad
        mask[row, :pads] = 0
    return ids, mask


@pytest.mark.parametrize("pattern,width", [("ddda", 13), ("adad", 64)], ids=["recurrent", "chunked"])
def test_left_padded_generate_tokens_match_jax(pattern, width):
    config = dict(RNN, attention_pattern=pattern, initializer_range=0.3)
    jax_model, params, model = make_family_models(config)
    ids, mask = _left_padded(config["vocab_size"], config["pad_token_id"], width)

    def both(eos):
        with kernel_overrides(**ALL_KERNELS):
            ref, ref_n = jax_generate_tokens(
                jax_model, params, jnp.asarray(ids), jnp.asarray(mask), jax.random.PRNGKey(0), 8,
                eos_token_id=eos, pad_token_id=config["pad_token_id"],
            )
        got, got_n = generate_tokens(
            model, torch.from_numpy(ids), torch.from_numpy(mask), None, 8, eos_token_id=eos,
            pad_token_id=config["pad_token_id"],
        )
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        np.testing.assert_array_equal(got_n.numpy(), np.asarray(ref_n))
        return got, got_n

    free, counts = both(None)
    assert counts.tolist() == [8] * 3 and len(set(free.flatten().tolist())) > 4
    if pattern == "ddda":  # EOS once: its rules are the family-independent loop's
        _, counts = both(int(free[0, 3]))
        assert counts[0] == 4


@pytest.mark.parametrize("paged,error", [(True, TypeError), (False, KeyError)], ids=["paged", "dense"])
def test_engine_fails_in_jax_and_is_refused(paged, error):
    jax_model, params, model = make_family_models(RNN)
    jax_engine = JaxServingEngine(jax_model, params, **dict(ENGINE_ARGS, paged=paged))
    jax_engine.submit(prompt_ids=[5, 6, 7, 8, 9], max_new_tokens=4, rng=jax.random.PRNGKey(0))
    with pytest.raises(error):
        jax_engine.drain()
    with pytest.raises(ValueError, match="recurrent caches"):
        ServingEngine(model, None, device="cpu", **dict(ENGINE_ARGS, paged=paged))


def test_generate_main_fails_in_jax_and_is_refused(tmp_path):
    prompts = _write_prompts(tmp_path / "prompts", RNN["vocab_size"], rows=2)
    model_args = dict(model_class="AutoModelForCausalLM", pretrained_config=RNN)
    jax_args = JaxInferenceArgs(**_inference_config(prompts, tmp_path / "jax", False, model_args=model_args))
    jax_model = JaxWrapper(mode=JaxMode.inference, pretrained_config=RNN)
    jax_model.tokenizer = WordTokenizer()
    params = nn.unbox(jax_model.model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    datasets, _ = jax_get_datasets_list(jax_args.datasets, JaxSplit.test, JaxMode.inference, jax_model.tokenizer)
    with pytest.raises(KeyError, match="'k'"):
        jax_generate.generate(jax_args, jax_model, params, datasets, JaxMode.inference)
    tokenizer = chip_smoke.word_tokenizer(str(tmp_path / "tokenizer"), RNN["vocab_size"], RNN["eos_token_id"])
    args = InferenceArgs(**_inference_config(
        prompts, tmp_path / "port", True, model_args=model_args, tokenizer_args=dict(tokenizer_name=tokenizer)
    ))
    with pytest.raises(ValueError, match="rnn_dolomite does not serve through ServingEngine"):
        generate.main(args, device="cpu")


def test_hf_export_fails_in_jax_and_is_refused():
    _, params, model = make_family_models(RNN)
    with pytest.raises(KeyError, match="c_attn"):
        jax_params_to_state_dict(JaxRNNConfig(**RNN), params)
    first_deltanet = RNN["attention_pattern"].index("d")
    with pytest.raises(ValueError, match=rf"no HF dolomite layout.*transformer\.h\.{first_deltanet}\.attn\.c_attn"):
        params_to_state_dict(model.config, model.state_dict())


def test_train_step_matches_jax():
    assert isinstance(train_step_matches_jax(dict(RNN, attention_pattern="dada")).model, RNNDolomiteForCausalLM)


def test_pretrain_main_on_a_yaml(tmp_path):
    pretrain_on_yaml(tmp_path, dict(RNN, attention_pattern="ddda", vocab_size=128, n_positions=64))


def test_model_tflops_match_jax():
    args = {"checkpoint_every": 1}
    want = jax_get_model_tflops(JaxRNNConfig(**RNN), 2, 512, None, args)
    assert get_model_tflops(RNNDolomiteConfig(**RNN), 2, 512, None, args) == pytest.approx(want, rel=1e-12)


def test_lora_default_target_adapts_the_attention_layers_as_jax():
    lora = dict(tuning_method="lora", lora_args=dict(lora_rank=4, lora_alpha=8.0, lora_dropout=0.0))
    wrapper = JaxPEFT(mode=JaxMode.training, pretrained_config=RNN, dtype="fp32", zero_stage=0, tuning_args=JaxTuningArgs(**lora))
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
    port = ModelWrapperForPEFT(RNN, dtype="fp32", device="cpu", tuning_args=TuningArgs(**lora))
    load_jax_params(port.model, jax.tree.map(np.asarray, params), device="cpu")
    assert port.lora_modules == ["transformer.h.0.attn.c_attn", "transformer.h.2.attn.c_attn"]
    loss = port.loss({k: torch.from_numpy(v) for k, v in batch.items()}, train=False)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), **TOL)
    for i in (0, 2):
        c_attn = port.model.transformer.h[i].attn.c_attn
        want_grads = grads["base_model"]["transformer"][f"h_{i}"]["attn"]["c_attn"]
        np.testing.assert_allclose(c_attn.lora_a.grad.numpy(), np.asarray(want_grads["lora_a"]).T, **TOL)
        np.testing.assert_allclose(c_attn.lora_b.grad.numpy(), np.asarray(want_grads["lora_b"]).T, **TOL)
