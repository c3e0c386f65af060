"""The port's MoEDolomite against the JAX package's: registry, model, train step, serving.

Tiny MoE models (2 layers, n_embd 32, 4 experts, top-2, gqa, rope, swiglu, rmsnorm,
and the `LOSS_PARITY_moe_dolomite.json` configuration) are initialised by flax,
converted with ``np.asarray`` and loaded into the port with `load_jax_params`. The JAX
side runs its grouped-GEMM Pallas kernels in interpret mode under
``kernel_overrides(moe_dispatch="pallas")`` where the comparison is of the forward; the
train step runs the JAX model's default CPU path (`experts_eager`, pinned to the
grouped kernels at 1e-5 by the JAX package's own tests) to keep the jitted 5-step run
short.

Tolerances: logits atol = rtol = 1e-5 (fp32; the expert sums are reordered); the loss
with its auxiliary term rtol 1e-5; the paged prefill + decode path against the full
forward 1e-4 (the JAX MoE decode test's order of tolerance, here tighter); 5 train steps
losses rtol 1e-5 and parameters atol 2e-6 (the dense train-step test's); greedy serving
tokens exactly.
"""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from dolomite_engine_tpu.enums import AttentionImplementation as JaxImpl
from dolomite_engine_tpu.enums import LRDecaySchedule as JaxSchedule
from dolomite_engine_tpu.enums import Mode
from dolomite_engine_tpu.model_wrapper.pretraining import ModelWrapperForPretraining as JaxWrapper
from dolomite_engine_tpu.models import config_from_dict as jax_config_from_dict
from dolomite_engine_tpu.models import get_model_class as jax_get_model_class
from dolomite_engine_tpu.ops.pallas import kernel_overrides
from dolomite_engine_tpu.optimization import get_optimizer as jax_get_optimizer
from dolomite_engine_tpu.optimization import get_scheduler as jax_get_scheduler
from dolomite_engine_tpu.serving import ServingEngine as JaxServingEngine
from dolomite_engine_tpu.train_utils import TrainState as JaxTrainState
from dolomite_engine_tpu.train_utils import get_model_tflops as jax_get_model_tflops
from dolomite_engine_tpu.train_utils import make_train_step as jax_make_train_step
from dolomite_engine_tpu_torch.model_wrapper import ModelWrapperForPretraining
from dolomite_engine_tpu_torch.models import (
    CommonConfig,
    GPTDolomiteForCausalLM,
    MoEConfig,
    MoEDolomiteForCausalLM,
    config_from_dict,
    get_model_class,
    load_jax_params,
)
from dolomite_engine_tpu_torch.optimization import get_optimizer, get_scheduler
from dolomite_engine_tpu_torch.serving import RequestStatus, ServingEngine, serve_batch
from dolomite_engine_tpu_torch.train_utils import TrainState, get_model_tflops, make_train_step
from tests.test_torch_model import ALL_KERNELS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(REPO, "LOSS_PARITY_moe_dolomite.json")) as f:
    PARITY_CONFIG = json.load(f)["config"]

MOE = dict(
    model_type="moe_dolomite", vocab_size=96, n_positions=512, n_embd=32, n_layer=2, n_head=4,
    num_key_value_heads=2, attention_head_type="gqa", position_embedding_type="rope",
    add_bias=False, activation_function="swiglu", normalization_function="rmsnorm",
    resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0, bos_token_id=0, eos_token_id=1,
    pad_token_id=2, num_experts=4, num_experts_per_tok=2, router_aux_loss_coef=0.01,
)
MOE_KERNELS = dict(ALL_KERNELS, moe_dispatch="pallas")
PAGE = 16
SEQ = 40
ADAM = dict(betas=(0.9, 0.95), eps=1e-10, weight_decay=0.1)


def make_moe_models(config_kwargs=MOE, seed=0):
    """(jax model, jax params, port model with the same weights) on the CPU."""
    jax_model = jax_get_model_class("moe_dolomite")(config=jax_config_from_dict(config_kwargs))
    params = nn.unbox(jax_model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"])
    model = MoEDolomiteForCausalLM(config_from_dict(config_kwargs), device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, params), device="cpu")
    return jax_model, params, model


def _packed_batches(seed, shape, vocab, eos):
    """[..., SEQ + 1] tokens with EOS every 5-20 tokens."""
    rs = np.random.RandomState(seed)
    text = rs.randint(3, vocab, (*shape, SEQ + 1))
    for row in text.reshape(-1, SEQ + 1):
        pos = rs.randint(4, 15)
        while pos < SEQ:
            row[pos] = eos
            pos += rs.randint(5, 20)
    return text


# ------------------------------------------------------------------- registry


def test_registry_builds_moe_and_names_unported_families():
    config = config_from_dict(dict(MOE))
    assert isinstance(config, MoEConfig) and config.num_experts == 4
    model = get_model_class("moe_dolomite")(config, device="cpu")
    assert isinstance(model, MoEDolomiteForCausalLM)
    assert tuple(model.transformer.h[0].moe.c_fc.weight.shape) == (4, 32, 2 * 128)  # [E, d, 2f]
    assert isinstance(config_from_dict({"n_embd": 32, "n_head": 4}), CommonConfig)
    assert get_model_class("gpt_dolomite") is GPTDolomiteForCausalLM
    # every family of the JAX registry builds (tests/test_torch_{enc_dec,crosslayer,dense_moe,rnn_dolomite}.py)
    for family in ("enc_dec_dolomite", "gpt_crosslayer", "dense_moe", "rnn_dolomite"):
        assert get_model_class(family).model_type == family
        assert config_from_dict({"model_type": family, "n_embd": 32, "n_head": 4, "n_layer": 2, "num_experts": 2}).model_type == family
    with pytest.raises(ValueError, match="unknown model_type"):
        get_model_class("not_a_model")
    with pytest.raises(ValueError, match="unknown model_type"):
        config_from_dict({"model_type": "not_a_model"})


def test_wrapper_builds_the_moe_model_never_a_dense_one():
    """The fault this pins: the pretraining wrapper used to parse every config as a
    CommonConfig (dropping the MoE keys) and build a dense GPTDolomite for moe_dolomite."""
    wrapper = ModelWrapperForPretraining(dict(MOE), device="cpu")
    assert isinstance(wrapper.model, MoEDolomiteForCausalLM)
    assert isinstance(wrapper.config, MoEConfig) and wrapper.config.num_experts == 4
    names = [n for n, _ in wrapper.model.named_parameters()]
    assert "transformer.h.0.moe.c_fc.weight" in names and not any(".mlp." in n for n in names)
    # the dense class refuses a config of another family instead of building a dense model
    with pytest.raises(ValueError, match="get_model_class"):
        GPTDolomiteForCausalLM(config_from_dict(dict(MOE)), device="cpu")
    with pytest.raises(ValueError, match="get_model_class"):
        GPTDolomiteForCausalLM(CommonConfig.from_dict(dict(MOE)), device="cpu")


def test_unported_options_and_bad_names_raise():
    config = config_from_dict(dict(MOE))
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue A, 'Distribution'"):
        MoEDolomiteForCausalLM(config, device="cpu", ep_capacity_factor=2.0)
    with pytest.raises(ValueError, match="unknown moe_implementation"):
        MoEDolomiteForCausalLM(config, device="cpu", moe_implementation="ragged")
    for name in ("eager", "scatter", "scattermoe", "auto"):
        MoEDolomiteForCausalLM(config, device="cpu", moe_implementation=name)


def test_seeded_init_follows_the_jax_rules():
    config = MoEConfig(**dict(MOE, n_embd=64, n_layer=4, initializer_range=0.05, num_experts=8))
    model = MoEDolomiteForCausalLM(config, device="cpu", seed=3)
    again = MoEDolomiteForCausalLM(config, device="cpu", seed=3)
    for a, b in zip(model.parameters(), again.parameters()):
        assert torch.equal(a, b)
    moe = model.transformer.h[0].moe
    depth_scaled = 0.05 / math.sqrt(2 * config.n_layer)
    assert moe.c_fc.std == 0.05 and moe.c_proj.std == depth_scaled and moe.gate.std == 0.05
    assert abs(moe.c_fc.weight.std().item() - 0.05) < 0.005
    assert abs(moe.c_proj.weight.std().item() - depth_scaled) < 0.1 * depth_scaled
    mup = MoEConfig(**dict(MOE, init_method="mup", m_width=4.0))
    mup_moe = MoEDolomiteForCausalLM(mup, device="cpu").transformer.h[0].moe
    assert mup_moe.c_fc.std == mup.initializer_range / 2.0
    assert mup_moe.c_proj.std == mup.initializer_range / math.sqrt(2 * mup.n_layer) / 2.0


def test_load_jax_params_copies_banks_and_rejects_a_transposed_one():
    _, params, model = make_moe_models()
    params_np = jax.tree.map(np.asarray, params)
    block = params_np["transformer"]["h_0"]["moe"]
    np.testing.assert_array_equal(model.transformer.h[0].moe.c_fc.weight.detach().numpy(), block["c_fc"]["kernel"])
    np.testing.assert_array_equal(model.transformer.h[0].moe.gate.weight.detach().numpy(), block["gate"]["kernel"].T)
    bad = jax.tree.map(np.copy, params_np)
    bad["transformer"]["h_1"]["moe"]["c_fc"]["kernel"] = np.swapaxes(block["c_fc"]["kernel"], 1, 2)
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(model, bad, device="cpu")
    bad = jax.tree.map(np.copy, params_np)
    bad["transformer"]["h_1"]["moe"]["c_proj"]["kernel"] = block["c_proj"]["kernel"].T  # all axes reversed
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(model, bad, device="cpu")


# ------------------------------------------------------------------- forward and loss


@pytest.mark.parametrize("add_bias", [False, True])
def test_logits_match_jax(add_bias):
    jax_model, params, model = make_moe_models(dict(MOE, add_bias=add_bias))
    ids = np.random.RandomState(0).randint(3, 96, (2, 16))
    with kernel_overrides(**MOE_KERNELS):
        ref = jax_model.apply({"params": params}, jnp.asarray(ids))
    with torch.no_grad():
        got = model(torch.from_numpy(ids))
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(ref.logits), atol=1e-5, rtol=1e-5)
    assert got.loss is None and got.aux_loss is None


def _jax_wrapper(config):
    wrapper = JaxWrapper(
        mode=Mode.training, pretrained_config=config, dtype="fp32", sequence_length=SEQ,
        reset_attention_mask=True, reset_position_ids=True, zero_stage=0,
        attention_implementation=JaxImpl.flash_attention_2,
    )
    params = nn.unbox(wrapper.model.init(jax.random.PRNGKey(0), **wrapper.get_dummy_inputs())["params"])
    return wrapper, params


def _port_wrapper(params, config, checkpoint_every=0):
    wrapper = ModelWrapperForPretraining(
        config, dtype="fp32", attention_implementation="flash_attention_2",
        gradient_checkpointing_args={"checkpoint_every": checkpoint_every} if checkpoint_every else None,
        reset_attention_mask=True, reset_position_ids=True, device="cpu",
    )
    load_jax_params(wrapper.model, jax.tree.map(np.asarray, params), device="cpu")
    return wrapper


@pytest.mark.parametrize("fused", [True, False])
def test_loss_with_aux_and_packed_documents_matches_jax(fused):
    config = dict(MOE, fused_lm_head_loss=fused, loss_chunk_size=16)
    wrapper, params = _jax_wrapper(config)
    text = _packed_batches(1, (2,), 96, 1)
    with kernel_overrides(moe_dispatch="pallas"):
        want = wrapper.loss(params, jnp.asarray(text), train=False)
        batch = wrapper.prepare_inputs_and_labels(jnp.asarray(text))
        want_out = wrapper.model.apply({"params": params}, **batch)
    port = _port_wrapper(params, config)
    got = port.loss(torch.from_numpy(text), train=False)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    batch = port.prepare_inputs_and_labels(torch.from_numpy(text))
    with torch.no_grad():
        got_out = port.model(**batch)
    assert got_out.aux_loss is not None
    np.testing.assert_allclose(got_out.aux_loss.item(), float(want_out.aux_loss), rtol=1e-5)
    zero = _port_wrapper(params, dict(config, router_aux_loss_coef=0.0))
    with torch.no_grad():
        out = zero.model(**batch)
    assert out.aux_loss is None
    np.testing.assert_allclose(out.loss.item(), got.item() - got_out.aux_loss.item(), rtol=1e-6)


def test_remat_gives_the_same_loss_and_grads():
    """Router logits come out of checkpointed blocks too, so the auxiliary loss and its
    gradient are the same with remat of every block."""
    _, params = _jax_wrapper(MOE)
    text = torch.from_numpy(_packed_batches(3, (2,), 96, 1))
    results = []
    for every in (0, 1):
        port = _port_wrapper(params, MOE, checkpoint_every=every)
        loss = port.loss(text)
        loss.backward()
        results.append((loss.item(), {n: p.grad.clone() for n, p in port.model.named_parameters()}))
    assert results[0][0] == results[1][0]
    for name, grad in results[0][1].items():
        torch.testing.assert_close(results[1][1][name], grad, atol=0, rtol=0, msg=name)
    assert results[0][1]["transformer.h.0.moe.gate.weight"].abs().sum() > 0


def test_paged_prefill_then_decode_matches_the_full_forward():
    """JAX `tests/models/test_moe_dolomite.py::test_kv_cache_decode` on the port's paged
    pool: 6 prompt tokens as one chunk, then 4 decode steps, against the port's and the
    JAX model's full forward."""
    jax_model, params, model = make_moe_models()
    ids = np.random.RandomState(5).randint(3, 96, (1, 10))
    full = model(torch.from_numpy(ids)).logits.detach()
    ref = np.asarray(jax_model.apply({"params": params}, jnp.asarray(ids)).logits)
    num_pages = 2
    caches = model.init_kv_caches(1 + num_pages, PAGE)
    table = torch.arange(1, num_pages + 1, dtype=torch.int32)[None]
    kv = [{**c, "page_table": table} for c in caches]
    mask = torch.zeros((1, num_pages * PAGE), dtype=torch.int32)
    mask[0, :6] = 1
    with torch.no_grad():
        out = model(
            torch.from_numpy(ids[:, :8]), position_ids=torch.arange(8)[None], attention_mask=mask,
            kv_caches=kv, cache_index=torch.tensor(0, dtype=torch.int32),
        )
        logits = [out.logits[:, :6]]
        for t in range(6, 10):
            index = torch.tensor([t], dtype=torch.int32)
            step = model(torch.from_numpy(ids[:, t : t + 1]), position_ids=index[:, None], kv_caches=kv, cache_index=index)
            logits.append(step.logits)
    got = torch.cat(logits, dim=1).numpy()
    np.testing.assert_allclose(got, full.numpy(), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)


# ------------------------------------------------------------------- train step


def _flat_jax_params(params):
    """{port parameter name: numpy array} of the JAX params (2-D kernels transposed,
    expert banks as they are)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        keys = [p.key for p in path]
        name = ".".join(keys[:-1]).replace("h_", "h.")
        value = np.asarray(leaf)
        if keys[-1] == "kernel" and value.ndim == 2:
            value = value.T
        out[f"{name}.weight" if keys[-1] in ("kernel", "embedding", "weight") else f"{name}.{keys[-1]}"] = value
    return out


def test_train_step_matches_jax_over_five_steps():
    """The `LOSS_PARITY_moe_dolomite.json` configuration (vocab 512, 2 layers, 4 experts,
    top-2, router aux loss 0.01), packed documents, accumulation 2, clip 1.0, cosine
    with 2 warm-up steps, fp32: losses and final parameters."""
    accum, batch, steps = 2, 2, 5
    config = dict(PARITY_CONFIG)
    batches = _packed_batches(2, (steps, accum, batch), config["vocab_size"], config["eos_token_id"])
    wrapper, params = _jax_wrapper(config)
    schedule = jax_get_scheduler(2, 0, None, 10, JaxSchedule.cosine, 0.1, base_lr=3e-3)
    tx = jax_get_optimizer("TorchAdamW", dict(ADAM), schedule)
    port = _port_wrapper(params, config)
    assert isinstance(port.model, MoEDolomiteForCausalLM)
    jax_step = jax.jit(
        jax_make_train_step(
            lambda p, micro, rng: wrapper.loss(p, micro["text"], train=True), tx,
            gradient_accumulation_steps=accum, gradient_clipping=1.0, skip_nonfinite=True,
        )
    )
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=tx.init(params))
    want_losses = []
    for t in range(steps):
        state, metrics = jax_step(state, {"text": jnp.asarray(batches[t])}, jax.random.PRNGKey(t))
        want_losses.append(float(metrics["loss"]))

    opt = get_optimizer(
        "TorchAdamW", dict(ADAM), get_scheduler(2, 0, None, 10, "cosine", 0.1, base_lr=3e-3),
        port.model.named_parameters(),
    )
    train_state = TrainState(port.model, opt)
    step = make_train_step(
        lambda micro: port.loss(micro["text"]), opt, gradient_accumulation_steps=accum,
        gradient_clipping=1.0, skip_nonfinite=True,
    )
    got_losses = [step(train_state, {"text": torch.from_numpy(batches[t])})["loss"] for t in range(steps)]
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-5)
    want_params = _flat_jax_params(state.params)
    got_params = dict(port.model.named_parameters())
    assert set(got_params) == set(want_params)
    for name, value in got_params.items():
        np.testing.assert_allclose(value.detach().numpy(), want_params[name], rtol=0, atol=2e-6, err_msg=name)


@pytest.mark.parametrize("every", [0, 1])
def test_model_tflops_count_the_active_experts_as_jax(every):
    from dolomite_engine_tpu.models.config import MoEConfig as JaxMoEConfig

    kwargs = {k: v for k, v in PARITY_CONFIG.items() if k != "model_type"}
    args = {"checkpoint_every": every} if every else None
    want = jax_get_model_tflops(JaxMoEConfig(**kwargs), 2, 2048, None, args)
    got = get_model_tflops(MoEConfig(**kwargs), 2, 2048, None, args)
    assert got == pytest.approx(want, rel=1e-12)
    dense = get_model_tflops(CommonConfig.from_dict(kwargs), 2, 2048, None, args)
    assert got > dense  # top-2: two expert MLPs per token


# ------------------------------------------------------------------- serving


def test_greedy_serving_tokens_match_the_jax_engine():
    """A 2-layer MoE model behind both engines, with paged KV, the prefix cache and
    chunked prefill active (the prompts of `tests/test_torch_serving.py`)."""
    from tests.test_torch_serving import ENGINE_ARGS, _prompts

    jax_model, params, model = make_moe_models(dict(MOE, initializer_range=0.3))
    prompts = _prompts(MOE["vocab_size"])
    max_new = 12
    with kernel_overrides(**MOE_KERNELS):
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
        assert len(set(got.tokens)) > 3
    assert engine.stats.prefix_hit_tokens == jax_engine.stats.prefix_hit_tokens > 0
    assert engine.stats.prefill_chunks > len(prompts)
    assert engine.pool.num_free == engine.pool.num_slots
