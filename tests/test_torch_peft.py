"""The port's PEFT (LoRA, prompt tuning) against the JAX package's, on the CPU.

- LoRA: the adapters' targets (default ``c_attn``, ``lora_target_modules`` overriding),
  the loss and every adapter gradient with a nonzero ``lora_b`` at dropout 0, against
  JAX's `LoRACausalLM` with the same weights (`load_jax_params` carries the adapters);
  fp32, atol = rtol = 1e-5.
- Prompt tuning: RANDOM and TEXT init (the init text's embedding rows, tiled), the loss
  and the prompt gradient against JAX's `PromptTuningCausalLM`; packed batches raise.
- The frozen base: 3 steps of the port's train step against JAX built from its own
  functions (``jax.grad`` over the adapters with the base closed over, its
  `clip_grad_norm`, optax AdamW over the adapter subtree); the base stays bit-identical
  and only adapters hold optimizer state. JAX's `finetune` optimizer
  (`build_optimizer_from_args`) over the whole tree moves a base weight: divergence 1 of
  ROADMAP.md Queue C, pinned here.
- NEFTune: ``neft_alpha`` changes no loss, in JAX and in the port (divergence 2).
- The CPU global norm (Queue C, repaired): a 4 M-element fp32 tree within 1e-6 relative
  of float64 and of JAX's `clip_grad_norm`.
- The fused loss's backward with a frozen tied table gives the same hidden gradient and
  no table gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

import chip_smoke
from dolomite_engine_tpu.arguments import TrainingArgs as JaxTrainingArgs
from dolomite_engine_tpu.arguments import TuningArgs as JaxTuningArgs
from dolomite_engine_tpu.data.utils import collate_fn as jax_collate
from dolomite_engine_tpu.enums import LossMask as JaxLossMask
from dolomite_engine_tpu.enums import Mode as JaxMode
from dolomite_engine_tpu.finetune import build_optimizer_from_args as jax_build_optimizer
from dolomite_engine_tpu.model_wrapper.peft import ModelWrapperForPEFT as JaxPEFT
from dolomite_engine_tpu.model_wrapper.pretraining import ModelWrapperForFinetuning as JaxFinetuning
from dolomite_engine_tpu.optimization import get_optimizer as jax_get_optimizer
from dolomite_engine_tpu.optimization import get_scheduler as jax_get_scheduler
from dolomite_engine_tpu.train_utils import TrainState as JaxTrainState
from dolomite_engine_tpu.train_utils import clip_grad_norm as jax_clip_grad_norm
from dolomite_engine_tpu.train_utils import make_train_step as jax_make_train_step
from dolomite_engine_tpu_torch.arguments import TrainingArgs, TuningArgs
from dolomite_engine_tpu_torch.model_wrapper import ModelWrapperForFinetuning, ModelWrapperForPEFT
from dolomite_engine_tpu_torch.models import load_jax_params
from dolomite_engine_tpu_torch.ops.loss import fused_linear_cross_entropy
from dolomite_engine_tpu_torch.optimization import build_optimizer_from_args, get_optimizer, get_scheduler
from dolomite_engine_tpu_torch.peft import lora_targets
from dolomite_engine_tpu_torch.train_utils import TrainState, clip_grad_norm, make_train_step
from dolomite_engine_tpu_torch.utils.diagnostics import squared_norms

VOCAB, EOS = 128, 0
MODEL = dict(
    model_type="gpt_dolomite", vocab_size=VOCAB, n_positions=128, n_embd=32, n_layer=2, n_head=4,
    num_key_value_heads=2, attention_head_type="gqa", position_embedding_type="rope",
    activation_function="swiglu", normalization_function="rmsnorm", add_bias=False,
    resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0, bos_token_id=EOS, eos_token_id=EOS, pad_token_id=EOS,
    fused_lm_head_loss=True, loss_chunk_size=8,
)
TOL = dict(atol=1e-5, rtol=1e-5)
LORA = dict(tuning_method="lora", lora_args=dict(lora_rank=4, lora_alpha=8.0, lora_dropout=0.0))
ADAM = dict(lr=1e-2, weight_decay=0.1, betas=[0.9, 0.95], eps=1e-10)


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tokenizer(tmp_path_factory):
    return chip_smoke.word_tokenizer(str(tmp_path_factory.mktemp("tokenizer")), VOCAB, EOS)


def _batch(seed=0, rows=3, packed=False):
    rs = np.random.RandomState(seed)
    examples = []
    for n in rs.randint(5, 15, rows):
        tokens = [int(t) for t in rs.randint(3, VOCAB, n)]
        examples.append({"input": tokens, "output": tokens[-4:]})
    return jax_collate(
        examples, mode=JaxMode.training, loss_mask=JaxLossMask.output_only, eos_token_id=EOS,
        is_encoder_decoder=False, use_padding_free_transformer=packed, pad_to_multiple=32,
    )


def _jnp(batch):
    return {key: jnp.asarray(value) for key, value in batch.items()}


def _jax_peft(tuning, tokenizer_name=None, seed=1):
    wrapper = JaxPEFT(
        mode=JaxMode.training, pretrained_config=MODEL, dtype="fp32", zero_stage=0,
        tuning_args=JaxTuningArgs(**tuning), tokenizer_name=tokenizer_name,
    )
    params = nn.unbox(wrapper.model.init(jax.random.PRNGKey(seed), **wrapper.get_dummy_inputs())["params"])
    return wrapper, params


def _port_peft(tuning, params, tokenizer_name=None):
    wrapper = ModelWrapperForPEFT(
        MODEL, dtype="fp32", device="cpu", tuning_args=TuningArgs(**tuning), tokenizer_name=tokenizer_name,
    )
    load_jax_params(wrapper.model, jax.tree.map(np.asarray, params), device="cpu")
    return wrapper


def _adapter_leaves(tree, prefix=""):
    """{port parameter name: array} of the adapter leaves of a JAX PEFT tree (torch layout)."""
    out = {}
    for key, value in tree.items():
        name = f"{prefix}.{key}" if prefix else key
        if isinstance(value, dict):
            out.update(_adapter_leaves(value, name))
        elif key in ("lora_a", "lora_b", "prompt_embeddings"):
            value = np.asarray(value)
            out[name.removeprefix("base_model.").replace("h_", "h.")] = value.T if key != "prompt_embeddings" else value
    return out


def _jax_loss_and_grads(wrapper, params, batch):
    """The JAX wrapper's eval loss and its gradients, jitted: one compile in place of eager
    JAX's compile per primitive."""
    return jax.jit(jax.value_and_grad(lambda p, b: wrapper.loss(p, b, train=False)))(params, _jnp(batch))


def _with_nonzero_lora_b(params, seed=2):
    rs = np.random.RandomState(seed)

    def fill(path, leaf):
        if getattr(path[-1], "key", None) == "lora_b":
            return jnp.asarray(rs.normal(0.0, 0.3, leaf.shape), jnp.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(fill, params)


@pytest.mark.parametrize("targets", [None, ["c_proj", "c_fc"]], ids=["default", "override"])
def test_lora_loss_and_adapter_grads_match_jax(targets):
    tuning = dict(LORA, lora_args=dict(LORA["lora_args"], lora_target_modules=targets))
    jax_wrapper, params = _jax_peft(tuning)
    params = _with_nonzero_lora_b(params)
    batch = _batch()
    want_loss, want_grads = _jax_loss_and_grads(jax_wrapper, params, batch)
    wrapper = _port_peft(tuning, params)
    expected = {f"transformer.h.{i}.{m}" for i in range(2) for m in (("attn.c_attn",) if targets is None else ("attn.c_proj", "mlp.c_proj", "mlp.c_fc"))}
    assert set(wrapper.lora_modules) == expected == {name for name, _ in lora_targets(wrapper.model, tuple(targets or ("c_attn",)))}
    loss = wrapper.loss(batch, train=True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), **TOL)
    named = dict(wrapper.model.named_parameters())
    want = _adapter_leaves(want_grads)
    assert set(want) == {name for name, p in named.items() if p.requires_grad} and len(want) == 2 * len(expected)
    for name, grad in want.items():
        np.testing.assert_allclose(named[name].grad.numpy(), grad, **TOL, err_msg=name)
    assert all(p.grad is None for p in named.values() if not p.requires_grad)  # the base: no gradient
    # the port's own init: lora_a normal with std in ** -0.5 [rank, in], lora_b zeros
    fresh = ModelWrapperForPEFT(MODEL, dtype="fp32", device="cpu", tuning_args=TuningArgs(**tuning))
    c_attn = fresh.model.transformer.h[0].attn.c_attn if targets is None else fresh.model.transformer.h[0].mlp.c_fc
    assert c_attn.lora_a.shape == (4, 32) and not c_attn.lora_b.any()
    assert abs(c_attn.lora_a.std().item() - 32**-0.5) < 0.05


@pytest.mark.parametrize("init", ["RANDOM", "TEXT"])
def test_prompt_tuning_matches_jax(init, tokenizer):
    prompt = dict(prompt_tuning_init=init, num_virtual_tokens=7)
    if init == "TEXT":
        prompt["prompt_tuning_init_text"] = "t5 t9 t17"
    tuning = dict(tuning_method="prompt_tuning", prompt_tuning_args=prompt)
    jax_wrapper, params = _jax_peft(tuning, tokenizer)
    batch = _batch(seed=3)
    want_loss, want_grads = _jax_loss_and_grads(jax_wrapper, params, batch)
    wrapper = _port_peft(tuning, params, tokenizer)
    if init == "TEXT":  # the port's own TEXT init from the same base: JAX's rows exactly
        carried = wrapper.model.prompt_embeddings.detach().clone()
        wrapper.model.init_prompt(0)
        assert torch.equal(wrapper.model.prompt_embeddings, carried)
        table = wrapper.model.base_model.transformer.wte.weight
        assert torch.equal(carried, table[[5, 9, 17, 5, 9, 17, 5]])
    loss = wrapper.loss(batch, train=True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), **TOL)
    np.testing.assert_allclose(wrapper.model.prompt_embeddings.grad.numpy(), np.asarray(want_grads["prompt_embeddings"]), **TOL)
    assert [n for n, p in wrapper.model.named_parameters() if p.requires_grad] == ["prompt_embeddings"]
    packed = _batch(seed=3, packed=True)
    with pytest.raises(NotImplementedError, match="padding-free"):
        jax_wrapper.loss(params, _jnp(packed), train=False)
    with pytest.raises(NotImplementedError, match="padding-free"):
        wrapper.loss(packed, train=False)


def test_frozen_base_steps_match_jax():
    """3 steps of the port's train step against JAX's own pieces over the adapter subtree."""
    jax_wrapper, params = _jax_peft(LORA)
    params = _with_nonzero_lora_b(params)
    batches = [_batch(seed=10 + i) for i in range(3)]
    schedule = jax_get_scheduler(1, 0, None, 3, "cosine", 0.1, base_lr=ADAM["lr"])
    tx = jax_get_optimizer("TorchAdamW", ADAM, schedule)

    def split(tree):
        adapters = jax.tree_util.tree_map_with_path(lambda p, x: x if p[-1].key in ("lora_a", "lora_b") else None, tree)
        return adapters

    def merged(adapters, base):
        return jax.tree.map(lambda a, b: b if a is None else a, adapters, base, is_leaf=lambda x: x is None)

    adapters = split(params)
    opt_state = tx.init(adapters)
    jax_curve = []
    grad_fn = jax.jit(jax.value_and_grad(lambda a, b: jax_wrapper.loss(merged(a, params), b, train=False)))
    for batch in batches:
        loss, grads = grad_fn(adapters, _jnp(batch))
        grads, norm = jax_clip_grad_norm(grads, 1.0)
        updates, opt_state = tx.update(grads, opt_state, adapters)
        adapters = optax.apply_updates(adapters, updates)
        jax_curve.append((float(loss), float(norm)))

    wrapper = _port_peft(LORA, params)
    base_before = {n: p.detach().clone() for n, p in wrapper.model.named_parameters() if not p.requires_grad}
    optimizer = get_optimizer("TorchAdamW", ADAM, get_scheduler(1, 0, None, 3, "cosine", 0.1, base_lr=ADAM["lr"]), wrapper.model.named_parameters())
    assert optimizer.param_names == [n for n, p in wrapper.model.named_parameters() if p.requires_grad]
    assert len(optimizer.param_names) == 4 and all(n.endswith(("lora_a", "lora_b")) for n in optimizer.param_names)
    state = TrainState(wrapper.model, optimizer)
    step = make_train_step(lambda micro: wrapper.loss(micro, train=False), optimizer, gradient_clipping=1.0)
    curve = [step(state, {k: [torch.as_tensor(v)] for k, v in batch.items()}) for batch in batches]
    np.testing.assert_allclose([m["loss"] for m in curve], [c[0] for c in jax_curve], rtol=1e-5)
    np.testing.assert_allclose([m["grad_norm"] for m in curve], [c[1] for c in jax_curve], rtol=1e-5)
    named = dict(wrapper.model.named_parameters())
    for name, value in _adapter_leaves(_drop_none(adapters)).items():
        np.testing.assert_allclose(named[name].detach().numpy(), value, atol=2e-6, rtol=1e-5, err_msg=name)
    assert all(torch.equal(named[n], before) for n, before in base_before.items())
    tree = state.state_dict()
    assert set(tree["optimizer"]["mu"]) == set(optimizer.param_names)
    assert len(tree["model"]) == len(named)  # the checkpoint keeps the frozen base


def _drop_none(tree):
    if isinstance(tree, dict):
        kept = {k: _drop_none(v) for k, v in tree.items()}
        return {k: v for k, v in kept.items() if v is not None and not (isinstance(v, dict) and not v)}
    return tree


def test_jax_finetune_optimizer_moves_the_base_the_port_does_not(tokenizer):
    """Divergence 1: JAX's `finetune.build_optimizer_from_args` builds AdamW over every
    leaf (no `freeze_base_weights`), so a LoRA step through its `make_train_step` moves a
    base weight; the port's step over the same args leaves every base tensor's bits."""
    config = dict(
        model_args=dict(model_class="AutoModelForCausalLM", pretrained_config=MODEL),
        tokenizer_args=dict(tokenizer_name=tokenizer), tuning_args=LORA,
        training_parameters=dict(num_training_steps=2, micro_batch_size=3, eval_during_training=False),
        datasets=[dict(class_name="DebugDataset", data_name="d", class_args={"num_examples": 4})],
        optimizer_args=dict(class_name="TorchAdamW", class_args=ADAM), lr_scheduler_args=dict(num_warmup_steps=0),
        mixed_precision_args=dict(dtype="fp32"),
        distributed_args=dict(stage=0), save_args=dict(save_path="unused", save_interval=1),
    )
    jax_args = JaxTrainingArgs(**config)
    jax_wrapper, params = _jax_peft(LORA, tokenizer)
    params = _with_nonzero_lora_b(params)
    optimizer, _ = jax_build_optimizer(jax_args, jax_wrapper)
    step = jax.jit(jax_make_train_step(lambda p, b, rng, fp8_state=None: jax_wrapper.loss(p, b, train=False), optimizer))
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=optimizer.init(params))
    batch = _batch(seed=4)
    wte = np.asarray(params["base_model"]["transformer"]["wte"]["embedding"]).copy()
    state, _ = step(state, {k: v[None] for k, v in _jnp(batch).items()}, jax.random.PRNGKey(0))
    assert np.abs(np.asarray(state.params["base_model"]["transformer"]["wte"]["embedding"]) - wte).max() > 0

    args = TrainingArgs(**config)
    wrapper = _port_peft(LORA, jax.tree.map(np.asarray, _with_nonzero_lora_b(_jax_peft(LORA, tokenizer)[1])), tokenizer)
    before = {n: p.detach().clone() for n, p in wrapper.model.named_parameters()}
    port_optimizer, _ = build_optimizer_from_args(args, wrapper)
    port_step = make_train_step(lambda micro: wrapper.loss(micro, train=True), port_optimizer)
    port_step(TrainState(wrapper.model, port_optimizer), {k: [torch.as_tensor(v)] for k, v in batch.items()})
    for name, param in wrapper.model.named_parameters():
        assert torch.equal(param, before[name]) != name.endswith(("lora_a", "lora_b")), name


def test_neftune_adds_no_noise():
    """Divergence 2: JAX sets a "neft" rng that no module draws from; the port adds no noise."""
    jax_plain = JaxFinetuning(mode=JaxMode.training, pretrained_config=MODEL, dtype="fp32", zero_stage=0)
    jax_neft = JaxFinetuning(mode=JaxMode.training, pretrained_config=MODEL, dtype="fp32", zero_stage=0, neft_alpha=5.0)
    params = nn.unbox(jax_plain.model.init(jax.random.PRNGKey(0), **jax_plain.get_dummy_inputs())["params"])
    batch = _jnp(_batch(seed=6))
    rngs = {"dropout": jax.random.PRNGKey(1)}
    want = float(jax_plain.loss(params, batch, rngs=rngs, train=True))
    assert float(jax_neft.loss(params, batch, rngs=dict(rngs, neft=jax.random.PRNGKey(2)), train=True)) == want
    losses = []
    for neft_alpha in (None, 5.0):
        wrapper = ModelWrapperForFinetuning(MODEL, neft_alpha=neft_alpha, dtype="fp32", device="cpu")
        load_jax_params(wrapper.model, jax.tree.map(np.asarray, params), device="cpu")
        torch.manual_seed(0)
        losses.append(wrapper.loss(_batch(seed=6), train=True).item())
    assert losses[0] == losses[1]
    np.testing.assert_allclose(losses[0], want, **TOL)


def test_cpu_global_norm_matches_float64_and_jax():
    """Queue C, repaired: the CPU grad norm is the summed fp32 squares (JAX's formula)."""
    rs = np.random.RandomState(0)
    tree = [rs.randn(2048, 2048).astype(np.float32), rs.randn(300).astype(np.float32)]  # 4 M + 300 elements
    exact = np.sqrt(sum(np.square(t.astype(np.float64)).sum() for t in tree))
    _, norm = clip_grad_norm([torch.from_numpy(t.copy()) for t in tree], None)
    _, jax_norm = jax_clip_grad_norm([jnp.asarray(t) for t in tree], None)
    assert abs(norm.item() - exact) / exact < 1e-6
    assert abs(norm.item() - float(jax_norm)) / exact < 1e-6
    squares = squared_norms([torch.from_numpy(t) for t in tree])
    for got, t in zip(squares, tree):
        want = np.square(t.astype(np.float64)).sum()
        assert abs(got.item() - want) / want < 1e-6
    grads = [torch.from_numpy(t.copy()) for t in tree]
    _, clipped_norm = clip_grad_norm(grads, 1.0)
    assert abs(np.sqrt(sum(g.double().square().sum().item() for g in grads)) - 1.0) < 1e-5


def test_fused_loss_skips_a_frozen_table():
    gen = torch.Generator().manual_seed(0)
    hidden = torch.randn(2, 24, 16, generator=gen)
    table = torch.randn(40, 16, generator=gen)
    labels = torch.randint(0, 40, (2, 24), generator=gen)
    grads = []
    for table_grad in (True, False):
        h = hidden.clone().requires_grad_(True)
        t = table.clone().requires_grad_(table_grad)
        fused_linear_cross_entropy(h, t, labels, chunk_size=8, compute_dtype=torch.float32).backward()
        grads.append((h.grad, t.grad))
    assert torch.equal(grads[0][0], grads[1][0]) and grads[0][1] is not None and grads[1][1] is None
