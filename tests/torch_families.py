"""Helpers of the CPU tests of the cross-layer, dense-MoE and DeltaNet-hybrid families
(`tests/test_torch_{crosslayer,dense_moe,rnn_dolomite}.py`): the JAX model and the port's
with the same weights, the logits and loss, cache decode against the full forward, the
two engines' greedy tokens, one train step and `pretrain.main` on a tiny YAML.

The JAX side runs its Pallas rmsnorm and rope kernels in interpret mode
(``kernel_overrides(**ALL_KERNELS)``) where a forward is compared. Tolerances: fp32 logits
and losses atol = rtol = 1e-5 (the attention tolerance of ROADMAP.md), a train step's loss
and grad norm rtol 1e-5, cache decode against the full forward 1e-4 (the MoE decode
test's), greedy tokens identical.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch
import yaml
from flax import linen as nn

from dolomite_engine_tpu.enums import AttentionImplementation as JaxImpl
from dolomite_engine_tpu.enums import LRDecaySchedule as JaxSchedule
from dolomite_engine_tpu.enums import Mode as JaxMode
from dolomite_engine_tpu.model_wrapper.pretraining import ModelWrapperForPretraining as JaxWrapper
from dolomite_engine_tpu.models import config_from_dict as jax_config_from_dict
from dolomite_engine_tpu.models import get_model_class as jax_get_model_class
from dolomite_engine_tpu.ops.pallas import kernel_overrides
from dolomite_engine_tpu.optimization import get_optimizer as jax_get_optimizer
from dolomite_engine_tpu.optimization import get_scheduler as jax_get_scheduler
from dolomite_engine_tpu.serving import ServingEngine as JaxServingEngine
from dolomite_engine_tpu.train_utils import TrainState as JaxTrainState
from dolomite_engine_tpu.train_utils import make_train_step as jax_make_train_step
from dolomite_engine_tpu_torch import pretrain
from dolomite_engine_tpu_torch.arguments import get_args
from dolomite_engine_tpu_torch.enums import Mode
from dolomite_engine_tpu_torch.model_wrapper import ModelWrapperForPretraining
from dolomite_engine_tpu_torch.models import config_from_dict, get_model_class, load_jax_params
from dolomite_engine_tpu_torch.optimization import get_optimizer, get_scheduler
from dolomite_engine_tpu_torch.serving import RequestStatus, ServingEngine, serve_batch
from dolomite_engine_tpu_torch.train_utils import TrainState, make_train_step
from tests.test_torch_model import ALL_KERNELS
from tests.test_torch_pretrain import _write_corpus
from tests.test_torch_serving import ENGINE_ARGS, _prompts

TOL = dict(atol=1e-5, rtol=1e-5)
BASE = dict(
    vocab_size=96, n_positions=256, n_embd=32, n_layer=4, n_head=4, position_embedding_type="rope",
    add_bias=False, activation_function="swiglu", normalization_function="rmsnorm",
    resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0, bos_token_id=0, eos_token_id=1, pad_token_id=2,
)
SEQ = 64  # the train step's packed rows
ADAM = dict(betas=(0.9, 0.95), eps=1e-10, weight_decay=0.1)
MAX_NEW = 10


def make_family_models(config_kwargs, seed=0, **model_kwargs):
    """(jax model, its params, the port's model with the same weights) on the CPU;
    `model_kwargs` go to both models (dense_moe's ``inference_method``)."""
    jax_model = jax_get_model_class(config_kwargs["model_type"])(
        config=jax_config_from_dict(config_kwargs), **model_kwargs
    )
    params = nn.unbox(jax_model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"])
    model = get_model_class(config_kwargs["model_type"])(config_from_dict(config_kwargs), device="cpu", **model_kwargs)
    load_jax_params(model, jax.tree.map(np.asarray, params), device="cpu")
    return jax_model, params, model


def logits_and_loss_match(jax_model, params, model, length=40, seed=0):
    """Logits of a [2, length] batch and the LM loss with labels, against JAX."""
    ids = np.random.RandomState(seed).randint(3, model.config.vocab_size, (2, length))
    with kernel_overrides(**ALL_KERNELS):
        ref = jax_model.apply({"params": params}, jnp.asarray(ids), labels=jnp.asarray(ids))
    with torch.no_grad():
        got = model(torch.from_numpy(ids), labels=torch.from_numpy(ids))
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(ref.logits), **TOL)
    np.testing.assert_allclose(got.loss.item(), float(ref.loss), **TOL)
    return got


@torch.no_grad()
def cache_decode_logits(model, ids, prompt, paged, page_size=16):
    """Logits of `ids` [1, L] computed as a prefill of `prompt` tokens (cache index a
    0-d tensor) and one decode step a token (a [1] index), over a dense cache or a paged
    pool."""
    length = ids.shape[1]
    if paged:
        pages = -(-length // page_size)
        caches = model.init_kv_caches(1 + pages, page_size)
        table = torch.arange(1, pages + 1, dtype=torch.int32)[None]
        caches = [{**c, "page_table": table} for c in caches]
        mask = torch.zeros((1, pages * page_size), dtype=torch.int32)
    else:
        caches = model.init_kv_caches(1, length)
        mask = torch.zeros((1, length), dtype=torch.int32)
    mask[0, :prompt] = 1
    out = model(
        ids[:, :prompt], position_ids=torch.arange(prompt)[None], attention_mask=mask, kv_caches=caches,
        cache_index=torch.tensor(0, dtype=torch.int32),
    )
    logits = [out.logits]
    for t in range(prompt, length):
        index = torch.tensor([t], dtype=torch.int32)
        step = model(ids[:, t : t + 1], position_ids=index[:, None], kv_caches=caches, cache_index=index)
        logits.append(step.logits)
    return torch.cat(logits, dim=1)


def serve_both(jax_model, params, model, **engine_args):
    """Greedy tokens of the JAX engine and of the port's for `_prompts` (paged: with the
    prefix cache and chunked prefill; ``paged=False``: the dense slot pool); the port's
    engine."""
    args = dict(ENGINE_ARGS, **engine_args)
    prompts = _prompts(model.config.vocab_size)
    with kernel_overrides(**ALL_KERNELS):
        jax_engine = JaxServingEngine(jax_model, params, **args)
        jax_states = [
            jax_engine.submit(prompt_ids=p, max_new_tokens=MAX_NEW, rng=jax.random.PRNGKey(i))
            for i, p in enumerate(prompts)
        ]
        jax_engine.drain()
    engine = ServingEngine(model, None, device="cpu", **args)
    states = serve_batch(engine, [dict(prompt_ids=p, max_new_tokens=MAX_NEW) for p in prompts])
    for i, (ref, got) in enumerate(zip(jax_states, states)):
        assert got.status == RequestStatus.completed
        assert got.tokens == ref.tokens, f"request {i} diverged"
    assert len({t for state in states for t in state.tokens}) > 6  # varied streams
    assert engine.stats.prefill_tokens == jax_engine.stats.prefill_tokens
    assert engine.pool.num_free == engine.pool.num_slots
    return engine, jax_engine


def packed_batches(seed, shape, vocab, eos):
    """[..., SEQ + 1] tokens with EOS every 5-20 tokens."""
    rs = np.random.RandomState(seed)
    text = rs.randint(3, vocab, (*shape, SEQ + 1))
    for row in text.reshape(-1, SEQ + 1):
        pos = rs.randint(4, 15)
        while pos < SEQ:
            row[pos] = eos
            pos += rs.randint(5, 20)
    return text


def train_step_matches_jax(config, checkpoint_every=1):
    """One `make_train_step` step (accumulation 2 x [2, SEQ] packed documents, clip 1.0,
    fp32, flash_attention_2, remat every `checkpoint_every`-th block in the port) against
    JAX's: loss and grad norm rtol 1e-5."""
    accum = 2
    batch = packed_batches(2, (accum, 2), config["vocab_size"], config["eos_token_id"])
    wrapper = JaxWrapper(
        mode=JaxMode.training, pretrained_config=config, dtype="fp32", sequence_length=SEQ,
        reset_attention_mask=True, reset_position_ids=True, zero_stage=0,
        attention_implementation=JaxImpl.flash_attention_2,
    )
    params = nn.unbox(wrapper.model.init(jax.random.PRNGKey(0), **wrapper.get_dummy_inputs())["params"])
    schedule = jax_get_scheduler(2, 0, None, 10, JaxSchedule.cosine, 0.1, base_lr=3e-3)
    tx = jax_get_optimizer("TorchAdamW", dict(ADAM), schedule)
    jax_step = jax.jit(
        jax_make_train_step(
            lambda p, micro, rng: wrapper.loss(p, micro["text"], train=True), tx,
            gradient_accumulation_steps=accum, gradient_clipping=1.0, skip_nonfinite=True,
        )
    )
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=tx.init(params))
    _, want = jax_step(state, {"text": jnp.asarray(batch)}, jax.random.PRNGKey(0))

    port = ModelWrapperForPretraining(
        config, dtype="fp32", attention_implementation="flash_attention_2",
        gradient_checkpointing_args={"checkpoint_every": checkpoint_every} if checkpoint_every else None,
        reset_attention_mask=True, reset_position_ids=True, device="cpu",
    )
    load_jax_params(port.model, jax.tree.map(np.asarray, params), device="cpu")
    opt = get_optimizer(
        "TorchAdamW", dict(ADAM), get_scheduler(2, 0, None, 10, "cosine", 0.1, base_lr=3e-3),
        port.model.named_parameters(),
    )
    step = make_train_step(
        lambda micro: port.loss(micro["text"]), opt, gradient_accumulation_steps=accum,
        gradient_clipping=1.0, skip_nonfinite=True,
    )
    got = step(TrainState(port.model, opt), {"text": torch.from_numpy(batch)})
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(got["grad_norm"]), float(want["grad_norm"]), rtol=1e-5)
    return port


def pretrain_on_yaml(tmp_path, pretrained_config, num_steps=3):
    """`pretrain.main` from a tiny YAML on the CPU (a seeded megatron corpus, packed
    documents, remat of every block, eval at steps 0, 2 and 3); returns its summary after
    checking that every loss is finite and the checkpoint was written."""
    prefix = _write_corpus(tmp_path)
    config = dict(
        model_args=dict(
            model_class="AutoModelForCausalLM", pretrained_config=pretrained_config,
            attention_implementation="flash_attention_2", reset_attention_mask=True, reset_position_ids=True,
        ),
        tuning_args=dict(tuning_method="pretraining"),
        training_parameters=dict(
            num_training_steps=num_steps, micro_batch_size=2, gradient_accumulation_steps=2,
            eval_during_training=True, eval_interval=2,
        ),
        datasets=[dict(class_name="MegatronDataset", data_name="Megatron", class_args=dict(
            eval_steps=1, data_cache_path=str(tmp_path / "cache"), data_path=[prefix], split="90,5,5",
            sequence_length=64,
        ))],
        optimizer_args=dict(class_args=dict(lr=1e-3)),
        save_args=dict(save_path=str(tmp_path / "ckpt"), save_interval=num_steps),
        distributed_args=dict(stage=0, gradient_checkpointing_method="block", gradient_checkpointing_args=dict(checkpoint_every=1)),
        logging_args=dict(log_interval=1),
        random_args=dict(seed=7),
    )
    path = tmp_path / "pretrain.yml"
    path.write_text(yaml.safe_dump(config))
    summary = pretrain.main(get_args(Mode.training, str(path)), device="cpu")
    losses = [s["loss"] for s in summary["steps"]]
    assert len(losses) == num_steps and np.isfinite(losses).all()
    assert (tmp_path / "ckpt" / f"global_step{num_steps}").is_dir()
    return summary
