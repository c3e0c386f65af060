"""The port's alibi GPTDolomite and MoEDolomite against the JAX package's, on the CPU.

Tiny alibi models in the shape of MPT-7B (layernorm, exact gelu, no linear biases, MHA,
tied embeddings) and a GQA variant are initialised by flax, converted with
``np.asarray`` and loaded into the port with `load_jax_params`:

- logits at fp32 atol = rtol = 1e-5, with and without a left-padded mask (the bias from
  the mask's cumsum; real positions compared);
- 5 `make_train_step` steps over packed documents (flash_attention_2: segment ids, the
  fused LM-head loss with z-loss, accumulation 2, clipping) against the JAX train step:
  losses rtol 1e-5 and parameters atol 2e-6, as `tests/test_torch_train.py` holds the
  rope model;
- remat of every block gives the same loss and gradients (the rerun gets the bias);
- an alibi MoEDolomite's logits (the JAX grouped-GEMM kernels in interpret mode) at
  1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from dolomite_engine_tpu.enums import LRDecaySchedule as JaxSchedule
from dolomite_engine_tpu.ops.pallas import kernel_overrides
from dolomite_engine_tpu.optimization import get_optimizer as jax_get_optimizer
from dolomite_engine_tpu.optimization import get_scheduler as jax_get_scheduler
from dolomite_engine_tpu.train_utils import TrainState as JaxTrainState
from dolomite_engine_tpu.train_utils import make_train_step as jax_make_train_step
from dolomite_engine_tpu_torch.optimization import get_optimizer, get_scheduler
from dolomite_engine_tpu_torch.train_utils import TrainState, make_train_step
from tests.test_torch_model import ROPE_GQA, make_models
from tests.test_torch_moe_model import MOE, MOE_KERNELS, make_moe_models
from tests.test_torch_train import ADAM, CONFIG, _flat_jax_params, _jax_wrapper, _packed_batches, _port_wrapper

MPT_LIKE = dict(
    ROPE_GQA, attention_head_type="mha", num_key_value_heads=None, position_embedding_type="alibi",
    normalization_function="layernorm", activation_function="gelu", add_bias=False,
    tie_word_embeddings=True,
)
ALIBI_GQA = dict(ROPE_GQA, position_embedding_type="alibi")
ALIBI_TRAIN = dict(
    CONFIG, attention_head_type="mha", num_key_value_heads=None, position_embedding_type="alibi",
    normalization_function="layernorm", activation_function="gelu",
)


@pytest.mark.parametrize("config_kwargs", [MPT_LIKE, ALIBI_GQA], ids=["mpt_like", "gqa"])
@pytest.mark.parametrize("padded", [False, True], ids=["no_mask", "left_padded"])
def test_alibi_logits_match_jax(config_kwargs, padded):
    jax_model, params, model = make_models(config_kwargs)
    ids = np.random.RandomState(0).randint(3, 96, (2, 12))
    mask = np.ones((2, 12), np.int32)
    if padded:
        mask[1, :4] = 0
    ref = jax_model.apply(
        {"params": params}, jnp.asarray(ids), attention_mask=jnp.asarray(mask) if padded else None
    ).logits
    with torch.no_grad():
        got = model(torch.from_numpy(ids), attention_mask=torch.from_numpy(mask) if padded else None).logits
    real = mask.astype(bool)
    np.testing.assert_allclose(got.numpy()[real], np.asarray(ref)[real], atol=1e-5, rtol=1e-5)


def test_alibi_train_step_matches_jax_over_five_steps():
    accum, batch, steps = 2, 2, 5
    batches = _packed_batches(5, steps, accum, batch)
    wrapper, params = _jax_wrapper(ALIBI_TRAIN)
    schedule = jax_get_scheduler(2, 0, None, 10, JaxSchedule.cosine, 0.1, base_lr=3e-3)
    tx = jax_get_optimizer("TorchAdamW", dict(ADAM), schedule)
    port = _port_wrapper(params, ALIBI_TRAIN)
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


def test_alibi_remat_gives_the_same_loss_and_grads():
    _, params = _jax_wrapper(ALIBI_TRAIN)
    text = torch.from_numpy(_packed_batches(6, 1, 1, 2)[0, 0])
    results = []
    for every in (0, 1):
        port = _port_wrapper(params, ALIBI_TRAIN, checkpoint_every=every)
        loss = port.loss(text)
        loss.backward()
        results.append((loss.item(), {n: p.grad.clone() for n, p in port.model.named_parameters()}))
    assert results[0][0] == results[1][0]
    for name, grad in results[0][1].items():
        torch.testing.assert_close(results[1][1][name], grad, atol=0, rtol=0, msg=name)


def test_alibi_moe_logits_match_jax():
    jax_model, params, model = make_moe_models(dict(MOE, position_embedding_type="alibi"))
    ids = np.random.RandomState(2).randint(3, 96, (2, 12))
    with kernel_overrides(**MOE_KERNELS):
        ref = jax_model.apply({"params": params}, jnp.asarray(ids)).logits
    with torch.no_grad():
        got = model(torch.from_numpy(ids)).logits
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
