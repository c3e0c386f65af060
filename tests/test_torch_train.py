"""The port's training slice against the JAX package's, on the CPU.

- `TorchAdamW` (bf16 first moment) against ``optax.adamw`` over 5 updates, and every
  `LRDecaySchedule` against the JAX `get_scheduler` over 20 steps: 1e-6 relative
  (fp32 arithmetic reassociated).
- The pretraining wrapper's packing (segment ids, reset positions, boundary labels)
  bit for bit, and the model's fused and unfused losses against the JAX model's.
- `make_train_step` on the `LOSS_PARITY.json` configuration (vocab 512, 2 layers, GQA,
  rope, swiglu, rmsnorm, fp32), with packed documents, the fused LM-head loss and
  z-loss, accumulation 2 and clipping: 5 steps from the same weights (`load_jax_params`)
  give the JAX step's losses within 1e-5 relative and its parameters within 2e-6.
- Remat on and off give the same loss and gradients; a non-finite loss leaves the
  parameters and the optimizer state untouched while the step advances.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from dolomite_engine_tpu.enums import AttentionImplementation as JaxImpl
from dolomite_engine_tpu.enums import LRDecaySchedule as JaxSchedule
from dolomite_engine_tpu.enums import Mode
from dolomite_engine_tpu.model_wrapper.pretraining import ModelWrapperForPretraining as JaxWrapper
from dolomite_engine_tpu.optimization import get_optimizer as jax_get_optimizer
from dolomite_engine_tpu.optimization import get_scheduler as jax_get_scheduler
from dolomite_engine_tpu.train_utils import TrainState as JaxTrainState
from dolomite_engine_tpu.train_utils import get_model_tflops as jax_get_model_tflops
from dolomite_engine_tpu.train_utils import make_train_step as jax_make_train_step
from dolomite_engine_tpu_torch.model_wrapper import ModelWrapperForPretraining
from dolomite_engine_tpu_torch.models import load_jax_params
from dolomite_engine_tpu_torch.optimization import TorchAdamW, get_optimizer, get_scheduler
from dolomite_engine_tpu_torch.train_utils import TrainState, get_model_tflops, make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(REPO, "LOSS_PARITY.json")) as f:
    PARITY_CONFIG = json.load(f)["config"]
CONFIG = dict(PARITY_CONFIG, fused_lm_head_loss=True, loss_chunk_size=16, z_loss_coef=1e-4)
SEQ = 40
ADAM = dict(betas=(0.9, 0.95), eps=1e-10, weight_decay=0.1)


def _packed_batches(seed, steps, accum, batch):
    """[steps, accum, B, SEQ + 1] tokens with EOS (id 1) every 5-20 tokens."""
    rs = np.random.RandomState(seed)
    text = rs.randint(3, CONFIG["vocab_size"], (steps, accum, batch, SEQ + 1))
    for row in text.reshape(-1, SEQ + 1):
        pos = rs.randint(4, 15)
        while pos < SEQ:
            row[pos] = CONFIG["eos_token_id"]
            pos += rs.randint(5, 20)
    return text


def _jax_wrapper(config=CONFIG):
    wrapper = JaxWrapper(
        mode=Mode.training, pretrained_config=config, dtype="fp32", sequence_length=SEQ,
        reset_attention_mask=True, reset_position_ids=True, zero_stage=0,
        attention_implementation=JaxImpl.flash_attention_2,
    )
    params = nn.unbox(wrapper.model.init(jax.random.PRNGKey(0), **wrapper.get_dummy_inputs())["params"])
    return wrapper, params


def _port_wrapper(params, config=CONFIG, checkpoint_every=0):
    wrapper = ModelWrapperForPretraining(
        config, dtype="fp32", attention_implementation="flash_attention_2",
        gradient_checkpointing_args={"checkpoint_every": checkpoint_every} if checkpoint_every else None,
        reset_attention_mask=True, reset_position_ids=True, device="cpu",
    )
    load_jax_params(wrapper.model, jax.tree.map(np.asarray, params), device="cpu")
    return wrapper


def _flat_jax_params(params):
    """{port parameter name: numpy array} of the JAX params (kernels transposed)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        keys = [p.key for p in path]
        name = ".".join(keys[:-1]).replace("h_", "h.")
        value = np.asarray(leaf)
        if keys[-1] == "kernel":
            value = value.T
        out[f"{name}.weight" if keys[-1] in ("kernel", "embedding", "weight") else f"{name}.{keys[-1]}"] = value
    return out


def test_adamw_bf16_mu_matches_optax():
    rs = np.random.RandomState(0)
    shapes = [(5, 7), (13,), (3, 4, 2)]
    params = [rs.randn(*s).astype(np.float32) for s in shapes]
    grads = [[rs.randn(*s).astype(np.float32) for s in shapes] for _ in range(5)]
    schedule = jax_get_scheduler(2, 1, None, 6, JaxSchedule.cosine, 0.1, base_lr=1e-2)
    tx = jax_get_optimizer("TorchAdamW", dict(ADAM, mu_dtype="bf16"), schedule)
    jax_params = [jnp.asarray(p) for p in params]
    state = tx.init(jax_params)
    torch_params = [torch.from_numpy(p.copy()) for p in params]
    opt = TorchAdamW(
        torch_params, get_scheduler(2, 1, None, 6, "cosine", 0.1, base_lr=1e-2), mu_dtype="bf16", **ADAM
    )
    for step_grads in grads:
        updates, state = tx.update([jnp.asarray(g) for g in step_grads], state, jax_params)
        jax_params = optax.apply_updates(jax_params, updates)
        opt.step([torch.from_numpy(g) for g in step_grads])
    for got, want in zip(torch_params, jax_params):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    jax_mu = state[0].mu
    for got, want in zip(opt.mu, jax_mu):
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=1e-2)
    assert opt.count == 5


# the power schedule takes no constant phase (both sides assert it)
@pytest.mark.parametrize(
    "style,warmup,constant,decay",
    [
        (style, *phases)
        for style in ("constant", "cosine", "linear", "exponential", "power")
        for phases in ((0, 0, None), (3, 2, None), (4, 0, 8))
        if not (style == "power" and phases[1])
    ],
)
def test_every_schedule_matches_jax(style, warmup, constant, decay):
    extra = {"a": 3e-3, "b": -0.5, "c": 1.0} if style == "power" else None
    want = jax_get_scheduler(warmup, constant, decay, 20, JaxSchedule(style), 0.1, extra, base_lr=1e-3)
    got = get_scheduler(warmup, constant, decay, 20, style, 0.1, extra, base_lr=1e-3)
    steps = np.arange(21)
    np.testing.assert_allclose([got(int(s)) for s in steps], [float(want(s)) for s in steps], rtol=1e-6, atol=1e-12)
    if warmup:
        assert got(0) == 0.0  # step 0 of a warmup has lr 0, as in optax


def test_prepare_inputs_and_labels_match_jax():
    wrapper, params = _jax_wrapper()
    text = _packed_batches(0, 1, 1, 3)[0, 0]
    want = wrapper.prepare_inputs_and_labels(jnp.asarray(text))
    got = _port_wrapper(params).prepare_inputs_and_labels(torch.from_numpy(text))
    for name in ("input_ids", "labels", "position_ids", "segment_ids"):
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]), err_msg=name)


@pytest.mark.parametrize("fused", [True, False])
def test_model_loss_matches_jax(fused):
    config = dict(CONFIG, fused_lm_head_loss=fused)
    wrapper, params = _jax_wrapper(config)
    text = _packed_batches(1, 1, 1, 2)[0, 0]
    want = wrapper.loss(params, jnp.asarray(text), train=False)
    got = _port_wrapper(params, config).loss(torch.from_numpy(text), train=False)
    np.testing.assert_allclose(got.item(), float(want), rtol=2e-6)


def test_train_step_matches_jax_over_five_steps():
    """Accumulation 2, clip 1.0, cosine with 2 warm-up steps, packed documents, the
    fused LM-head loss with z-loss, fp32: losses and final parameters."""
    accum, batch, steps = 2, 2, 5
    batches = _packed_batches(2, steps, accum, batch)
    wrapper, params = _jax_wrapper()
    schedule = jax_get_scheduler(2, 0, None, 10, JaxSchedule.cosine, 0.1, base_lr=3e-3)
    tx = jax_get_optimizer("TorchAdamW", dict(ADAM), schedule)
    port = _port_wrapper(params)  # loaded before the JAX step donates nothing: params stay valid
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
    assert train_state.step == steps and opt.count == steps
    want_params = _flat_jax_params(state.params)
    got_params = dict(port.model.named_parameters())
    assert set(got_params) == set(want_params)
    for name, value in got_params.items():
        np.testing.assert_allclose(value.detach().numpy(), want_params[name], rtol=0, atol=2e-6, err_msg=name)


def test_remat_gives_the_same_loss_and_grads():
    _, params = _jax_wrapper()
    text = torch.from_numpy(_packed_batches(3, 1, 1, 2)[0, 0])
    results = []
    for every in (0, 1):
        port = _port_wrapper(params, checkpoint_every=every)
        loss = port.loss(text)
        loss.backward()
        results.append((loss.item(), {n: p.grad.clone() for n, p in port.model.named_parameters()}))
    assert results[0][0] == results[1][0]
    for name, grad in results[0][1].items():
        torch.testing.assert_close(results[1][1][name], grad, atol=0, rtol=0, msg=name)


def test_nonfinite_step_leaves_params_and_state_untouched():
    _, params = _jax_wrapper()
    port = _port_wrapper(params)
    opt = get_optimizer("TorchAdamW", dict(ADAM, mu_dtype="bf16"), lambda step: 1e-3, port.model.named_parameters())
    poison = {"on": False}

    def loss_fn(micro):
        loss = port.loss(micro["text"])
        return loss * float("nan") if poison["on"] else loss

    state = TrainState(port.model, opt)
    step = make_train_step(loss_fn, opt, gradient_accumulation_steps=2, skip_nonfinite=True)
    batch = {"text": torch.from_numpy(_packed_batches(4, 1, 2, 2)[0])}
    assert step(state, batch)["skipped"] == 0
    before = [p.detach().clone() for p in opt.params]
    moments = [(m.clone(), v.clone()) for m, v in zip(opt.mu, opt.nu)]
    poison["on"] = True
    metrics = step(state, batch)
    assert metrics["skipped"] == 1 and not np.isfinite(metrics["loss"])
    assert state.step == 2 and opt.count == 1
    for p, old in zip(opt.params, before):
        assert torch.equal(p.detach(), old)
    for (m, v), (old_m, old_v) in zip(zip(opt.mu, opt.nu), moments):
        assert torch.equal(m, old_m) and torch.equal(v, old_v)
    poison["on"] = False
    assert step(state, batch)["skipped"] == 0 and opt.count == 2


def test_unported_options_raise_naming_the_roadmap():
    """The training options (offload, health, remat policies, fp8) now build;
    an option still unported (loading a model by name) raises naming its ROADMAP item."""
    opt = TorchAdamW([torch.zeros(2, requires_grad=True)], lambda step: 1e-3)
    for kwargs in (dict(offload_optimizer=True), dict(collect_health=True)):
        make_train_step(lambda micro: None, opt, **kwargs)
    wrapper = _port_wrapper(_jax_wrapper()[1], checkpoint_every=1).__class__(
        CONFIG, gradient_checkpointing_args={"checkpoint_every": 1, "policy": "save_dots"}, device="cpu"
    )
    assert wrapper.model.transformer.remat_policy.name == "save_dots"
    assert ModelWrapperForPretraining(CONFIG, dtype="fp8", device="cpu").fp8 is not None
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ModelWrapperForPretraining(CONFIG, model_name="ibm-granite/granite-3b-code-base", device="cpu")


@pytest.mark.parametrize("every", [0, 1, 2])
def test_model_tflops_match_jax(every):
    from dolomite_engine_tpu.models.config import CommonConfig as JaxConfig
    from dolomite_engine_tpu_torch.models import CommonConfig

    args = {"checkpoint_every": every} if every else None
    want = jax_get_model_tflops(JaxConfig(**CONFIG), 4, 4096, None, args)
    assert get_model_tflops(CommonConfig(**CONFIG), 4, 4096, None, args) == pytest.approx(want, rel=1e-12)
