"""The port's fp8 training (delayed scaling) against the JAX package's and flax's
`fp8_ops`, on the CPU.

- `quantize`, `compute_scale` (through `update_fp8_meta`) and the amax history bit for bit
  flax's, for e4m3 and e5m2, over saturating values and histories whose amax is 0, inf,
  NaN, tiny or ordinary.
- One fp8 dense projection (flax's `Fp8DirectDotGeneralOp`): its output, both gradients
  and its six new state tensors bit for bit flax's.
- The dense and the MoE train step with accumulation 2 over 3 steps from the JAX
  package's initial weights and fp8 state: losses within 1e-3 relative (bf16 compute);
  the final fp8 state's scales and forward amax histories within 3e-2 relative and its
  output-gradient histories within 1e-1 (each amax is the maximum of a bf16 activation or
  gradient that the port computes in another bf16 op order than XLA: a few bf16 ulps of
  2^-8, compounding through the backward; measured at most 2.3e-2 and 6.9e-2).
- A skipped non-finite step keeps the fp8 state the step began with; a resumed fp8 run
  restores it from the checkpoint and continues bit for bit.
- ``FP8_LOSS_DELTA.json`` (`tools/fp8_loss_delta.py`, the JAX package on the CPU): the
  port's 200-step fp8 curve on the same config, initial weights and seeded batches lies
  closer to JAX's ``fp8_losses``, in the mean over steps, than JAX's ``bf16_losses`` do.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from flax.linen import fp8_ops

from dolomite_engine_tpu.distributed import create_sharded_train_state
from dolomite_engine_tpu.enums import LRDecaySchedule as JaxSchedule
from dolomite_engine_tpu.enums import Mode as JaxMode
from dolomite_engine_tpu.model_wrapper.pretraining import ModelWrapperForPretraining as JaxWrapper
from dolomite_engine_tpu.optimization import get_optimizer as jax_get_optimizer
from dolomite_engine_tpu.optimization import get_scheduler as jax_get_scheduler
from dolomite_engine_tpu.parallel.mesh import MeshManager
from dolomite_engine_tpu.train_utils import make_train_step as jax_make_train_step
from dolomite_engine_tpu_torch.model_wrapper import ModelWrapperForPretraining
from dolomite_engine_tpu_torch.models import load_jax_params
from dolomite_engine_tpu_torch.ops import fp8
from dolomite_engine_tpu_torch.optimization import get_optimizer, get_scheduler
from dolomite_engine_tpu_torch.train_utils import TrainState, make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ = 32
ADAM = dict(weight_decay=0.1, betas=(0.9, 0.95), eps=1e-10)
DENSE = dict(
    model_type="gpt_dolomite", vocab_size=128, n_positions=64, n_embd=64, n_layer=2, n_head=4,
    attention_head_type="gqa", num_key_value_heads=2, position_embedding_type="rope",
    activation_function="swiglu", normalization_function="rmsnorm", add_bias=False, resid_pdrop=0.0,
    embd_pdrop=0.0, attn_pdrop=0.0, bos_token_id=0, eos_token_id=1, pad_token_id=2, upcast_logits_for_loss=True,
)
MOE = dict(DENSE, model_type="moe_dolomite", num_experts=4, num_experts_per_tok=2, router_aux_loss_coef=0.01)
PAIRS = ((jnp.float8_e4m3fn, torch.float8_e4m3fn), (jnp.float8_e5m2, torch.float8_e5m2))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: under the suite's parallel workers torch's spinning thread pool,
    oversubscribed, slows these small steps and the workers running beside them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bits(x) -> np.ndarray:
    return np.asarray(x).view(np.uint8 if np.asarray(x).dtype.itemsize == 1 else np.uint32)


@pytest.mark.parametrize("q_jax, q_torch", PAIRS, ids=["e4m3", "e5m2"])
def test_quantize_and_scale_update_are_flax_bit_for_bit(q_jax, q_torch):
    rs = np.random.RandomState(0)
    x = (rs.randn(64, 48) * 3).astype(np.float32)
    x[0, 0], x[1, 1], x[2, 2] = 1e6, -1e6, 0.0  # saturation both ways, and a zero
    xb = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(np.asarray(xb.astype(jnp.float32))).bfloat16()
    for scale in (1.0, 0.37, 3.3e-3, 1e-8):
        want = fp8_ops.quantize(xb, q_jax, jnp.asarray([scale], jnp.float32), jnp.bfloat16)
        got = fp8.quantize(tx, q_torch, torch.tensor([scale]), torch.bfloat16)
        np.testing.assert_array_equal(got.view(torch.uint8).numpy(), _bits(want), err_msg=f"scale {scale}")
    # the edge cases, then ordinary amaxes over 24 decades (a reciprocal times the maximum
    # would round differently from flax's division for most of them)
    ordinary = np.exp(np.random.RandomState(3).uniform(-30, 25, 32)).astype(np.float32)
    for amax in (0.0, np.inf, np.nan, 1e-30, 3.5, 448.0, *ordinary):
        history = np.zeros(16, np.float32)
        history[3] = amax
        want_scale, want_history = fp8_ops.update_fp8_meta(xb, q_jax, jnp.asarray([0.5], jnp.float32), jnp.asarray(history))
        got_scale, got_history = fp8.update_fp8_meta(tx, q_torch, torch.tensor([0.5]), torch.from_numpy(history))
        np.testing.assert_array_equal(_bits(got_scale.numpy()), _bits(want_scale), err_msg=f"amax {amax}")
        np.testing.assert_array_equal(_bits(got_history.numpy()), _bits(want_history), err_msg=f"amax {amax}")


def test_one_fp8_projection_is_flax_bit_for_bit():
    rs = np.random.RandomState(1)
    m, k, n = 48, 64, 80
    x, w, dy = rs.randn(m, k), rs.randn(k, n) * 0.05, rs.randn(m, n)

    class Dot(nn.Module):
        @nn.compact
        def __call__(self, x, kernel):
            return fp8_ops.Fp8DirectDotGeneralOp(name="fp8_dot")(x, kernel, (((1,), (0,)), ((), ())))

    module = Dot()
    xb, wb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    history = np.zeros(1024, np.float32)
    history[5] = 2.0
    owg = dict(module.init(jax.random.PRNGKey(0), xb, wb)["_overwrite_with_gradient"]["fp8_dot"])
    owg.update(input_amax_history=jnp.asarray(history), output_grad_amax_history=jnp.asarray(history * 0.01))

    def loss(x, kernel, owg):
        y = module.apply({"_overwrite_with_gradient": {"fp8_dot": owg}}, x, kernel)
        return jnp.sum(y.astype(jnp.float32) * dy), y

    (_, want_y), (want_dx, want_dw, want_state) = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(xb, wb, owg)
    state = fp8.Fp8State({name: torch.from_numpy(np.asarray(v).copy()) for name, v in owg.items()})
    tx = torch.from_numpy(np.asarray(xb.astype(jnp.float32))).bfloat16().requires_grad_()
    tw = torch.from_numpy(np.asarray(wb.astype(jnp.float32)).T.copy()).bfloat16().requires_grad_()
    y = fp8.fp8_dot(tx, tw, fp8.Fp8Slot(state, ""))
    (y.float() * torch.from_numpy(dy).float()).sum().backward()
    for got, want in ((y, want_y), (tx.grad, want_dx), (tw.grad.T, want_dw)):
        np.testing.assert_array_equal(got.detach().float().numpy(), np.asarray(want.astype(jnp.float32)))
    assert set(state.staged) == set(want_state)
    for name, value in want_state.items():
        np.testing.assert_array_equal(_bits(state.staged[name].numpy()), _bits(value), err_msg=name)


def _port_key(path) -> str:
    """The port's fp8 state key of a JAX OWG tree path."""
    keys = [str(p.key) for p in path if str(p.key) != "fp8_dot"]
    return ".".join(k.replace("h_", "h.", 1) if k.startswith("h_") else k for k in keys)


def _jax_run(config, batches, steps):
    """The JAX fp8 train step from `create_sharded_train_state`'s weights and fp8 state
    (one device, PRNGKey(0)): (initial params, initial fp8 state, losses, final fp8)."""
    MeshManager.destroy()
    MeshManager(devices=jax.devices()[:1])
    try:
        wrapper = JaxWrapper(
            mode=JaxMode.training, pretrained_config=config, dtype="fp8", sequence_length=SEQ,
            reset_attention_mask=False, zero_stage=0,
        )
        schedule = jax_get_scheduler(1, 0, None, 10, JaxSchedule.cosine, 0.1, base_lr=3e-3)
        tx = jax_get_optimizer("TorchAdamW", dict(ADAM), schedule)
        state, _ = create_sharded_train_state(wrapper, tx, MeshManager.get_mesh(), jax.random.PRNGKey(0))
        params, fp8_state = jax.tree.map(np.asarray, state.params), jax.tree.map(np.asarray, state.fp8)
        step = jax.jit(jax_make_train_step(
            lambda p, micro, rng, fp8_state=None: wrapper.loss(p, micro["text"], train=True, fp8_state=fp8_state),
            tx, gradient_accumulation_steps=batches.shape[1], gradient_clipping=1.0,
        ))
        losses = []
        with MeshManager.get_mesh():
            for t in range(steps):
                state, metrics = step(state, {"text": jnp.asarray(batches[t])}, jax.random.PRNGKey(t))
                losses.append(float(metrics["loss"]))
        return params, fp8_state, losses, jax.tree.map(np.asarray, state.fp8)
    finally:
        MeshManager.destroy()


def _flat_fp8(tree) -> dict:
    return {_port_key(path): np.asarray(leaf) for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_run(config, params, fp8_init, batches, steps):
    wrapper = ModelWrapperForPretraining(config, dtype="fp8", device="cpu")
    load_jax_params(wrapper.model, params, device="cpu")
    init = _flat_fp8(fp8_init)
    assert set(init) == set(wrapper.fp8.tensors)
    for name, value in init.items():
        wrapper.fp8.tensors[name].copy_(torch.from_numpy(value))
    opt = get_optimizer("TorchAdamW", dict(ADAM), get_scheduler(1, 0, None, 10, "cosine", 0.1, base_lr=3e-3),
                        wrapper.model.named_parameters())
    state = TrainState(wrapper.model, opt, fp8=wrapper.fp8)
    step = make_train_step(lambda micro: wrapper.loss(micro["text"]), opt, gradient_accumulation_steps=batches.shape[1])
    losses = [step(state, {"text": torch.from_numpy(batches[t]).long()})["loss"] for t in range(steps)]
    return losses, wrapper


@pytest.mark.parametrize("config", [DENSE, MOE], ids=["dense", "moe"])
def test_train_step_with_accumulation_matches_jax(config):
    steps = 3
    batches = np.random.RandomState(2).randint(3, config["vocab_size"], (steps, 2, 4, SEQ + 1)).astype(np.int32)
    params, fp8_init, want_losses, want_fp8 = _jax_run(config, batches, steps)
    losses, wrapper = _port_run(config, params, fp8_init, batches, steps)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-3)
    want = _flat_fp8(want_fp8)
    moved = 0
    for name, value in want.items():
        got = wrapper.fp8.tensors[name].numpy()
        rtol = 1e-1 if "output_grad_amax_history" in name else 3e-2
        np.testing.assert_allclose(got, value, rtol=rtol, atol=0, err_msg=name)
        moved += int(not np.array_equal(value, _flat_fp8(fp8_init)[name]))
    assert moved == len(want)  # every scale and history took the steps' amaxes


def test_skipped_step_keeps_the_fp8_state():
    wrapper = ModelWrapperForPretraining(DENSE, dtype="fp8", device="cpu")
    opt = get_optimizer("TorchAdamW", dict(ADAM), lambda step: 1e-3, wrapper.model.named_parameters())
    state = TrainState(wrapper.model, opt, fp8=wrapper.fp8)
    poison = {"on": False}

    def loss_fn(micro):
        loss = wrapper.loss(micro["text"])
        return loss * float("nan") if poison["on"] else loss

    step = make_train_step(loss_fn, opt, gradient_accumulation_steps=2, skip_nonfinite=True)
    batch = {"text": torch.from_numpy(np.random.RandomState(3).randint(3, 128, (2, 2, SEQ + 1)))}
    assert step(state, batch)["skipped"] == 0
    before = wrapper.fp8.snapshot()
    poison["on"] = True
    assert step(state, batch)["skipped"] == 1
    for name, value in before.items():
        assert torch.equal(wrapper.fp8.tensors[name], value), name
    assert not wrapper.fp8.staged


def test_fp8_state_round_trips_through_the_checkpoint(tmp_path):
    from tests.test_torch_pretrain import _curve, _training_args, _write_corpus

    from dolomite_engine_tpu_torch import pretrain
    from dolomite_engine_tpu_torch.checkpointing import load_checkpoint_for_training
    from dolomite_engine_tpu_torch.model_wrapper import get_model
    from dolomite_engine_tpu_torch.optimization import build_optimizer_from_args

    prefix = _write_corpus(tmp_path)
    fp8_args = {"mixed_precision_args": dict(dtype="fp8")}
    unbroken = pretrain.main(_training_args(tmp_path, prefix, num_steps=4, save_path="a", **fp8_args), device="cpu")
    pretrain.main(_training_args(tmp_path, prefix, num_steps=2, save_path="b", **fp8_args), device="cpu")
    args = _training_args(tmp_path, prefix, num_steps=4, save_path="b", load_args=dict(load_path=str(tmp_path / "b")), **fp8_args)
    model = get_model(args, device="cpu")
    state = TrainState(model.model, build_optimizer_from_args(args, model)[0], fp8=model.fp8)
    fresh = model.fp8.snapshot()
    load_checkpoint_for_training(args, state, iteration=2)
    assert any(not torch.equal(state.fp8.tensors[k], v) for k, v in fresh.items())  # restored, not fresh
    resumed = pretrain.main(args, device="cpu")
    assert _curve(resumed) == _curve(unbroken)[2:]


def test_loss_delta_artifact_port_tracks_jax_fp8():
    """`FP8_LOSS_DELTA.json`: measured here (one CPU thread), the port's mean gap to JAX's
    fp8 curve is 9.93e-4 against the bf16 curve's 1.213e-3 (both printed): the port's bf16
    op order moves its curve nearly as far as fp8 moves JAX's, so the margin is small."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("fp8_loss_delta", os.path.join(REPO, "tools", "fp8_loss_delta.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    with open(os.path.join(REPO, "FP8_LOSS_DELTA.json")) as f:
        artifact = json.load(f)
    steps = artifact["steps"]
    assert steps == 200 and artifact["config"] == tool.CONFIG
    batches = np.random.RandomState(99).randint(0, tool.CONFIG["vocab_size"], size=(steps, 4, tool.SEQ + 1))

    MeshManager.destroy()
    MeshManager(devices=jax.devices()[:1])
    try:
        jax_wrapper = JaxWrapper(
            mode=JaxMode.training, pretrained_config=tool.CONFIG, dtype="fp8", sequence_length=tool.SEQ,
            reset_attention_mask=False, zero_stage=0,
        )
        schedule = jax_get_scheduler(0, 0, None, steps + 1, JaxSchedule.constant, 0.0, base_lr=tool.LR)
        jax_state, _ = create_sharded_train_state(
            jax_wrapper, jax_get_optimizer("TorchAdamW", dict(tool.ADAM), schedule), MeshManager.get_mesh(),
            jax.random.PRNGKey(1234),
        )
        params, fp8_init = jax.tree.map(np.asarray, jax_state.params), jax.tree.map(np.asarray, jax_state.fp8)
    finally:
        MeshManager.destroy()

    wrapper = ModelWrapperForPretraining(tool.CONFIG, dtype="fp8", device="cpu")
    load_jax_params(wrapper.model, params, device="cpu")
    for name, value in _flat_fp8(fp8_init).items():
        wrapper.fp8.tensors[name].copy_(torch.from_numpy(value))
    opt = get_optimizer("TorchAdamW", dict(tool.ADAM), get_scheduler(0, 0, None, steps + 1, "constant", 0.0, base_lr=tool.LR),
                        wrapper.model.named_parameters())
    state = TrainState(wrapper.model, opt, fp8=wrapper.fp8)
    step = make_train_step(lambda micro: wrapper.loss(micro["text"]), opt, gradient_clipping=1.0)
    losses = np.array([step(state, {"text": torch.from_numpy(batches[t][None]).long()})["loss"] for t in range(steps)])
    jax_fp8, jax_bf16 = np.array(artifact["fp8_losses"]), np.array(artifact["bf16_losses"])
    port_gap = float(np.mean(np.abs(losses - jax_fp8)))
    bf16_gap = float(np.mean(np.abs(jax_bf16 - jax_fp8)))
    print(f"mean |port fp8 - jax fp8| {port_gap:.3e}, mean |jax bf16 - jax fp8| {bf16_gap:.3e}")
    assert port_gap < bf16_gap, (port_gap, bf16_gap)
