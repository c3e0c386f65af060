"""The port's finetuning path against the JAX package's, on the CPU.

- `BlendedDistributedSampler`: the same index stream as JAX's for the same seed, ratios,
  epoch, replicas and rank, with and without ``ignore_sampling_proportion_for_validation``,
  and a resume from a saved index; `ResumableDataLoader` resumes mid-epoch; at one rank
  the sharded loader yields its loader's batches and the dispatching one the same arrays.
- `get_dataloader` (one device): the same collated batches as JAX's ``mesh=None`` loader
  on one device, padded and padding-free, under ``output_only`` and ``no_mask``.
- `ModelWrapperForFinetuning.loss` and its gradients against JAX's: padded (left-padded
  with ``attention_mask``), packed (``position_ids`` / ``segment_ids``), and MoE with its
  auxiliary loss. fp32, atol = rtol = 1e-5.
- ``model_name`` as a local directory: the config and the tokenizer; another model type
  or a hub id raise.
- `finetune.main` from YAML-shaped args on the CPU for full finetuning, LoRA and prompt
  tuning: 3 steps, a save, a resumed run to 5 equal to 5 unbroken steps bit for bit; and
  full finetuning's per-step losses and grad norms against JAX's `finetune.train` from
  the same weights over the same batches.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

import chip_smoke
from dolomite_engine_tpu import data as jax_data
from dolomite_engine_tpu import finetune as jax_finetune
from dolomite_engine_tpu.arguments import TrainingArgs as JaxTrainingArgs
from dolomite_engine_tpu.data.sampler import BlendedDistributedSampler as JaxSampler
from dolomite_engine_tpu.enums import DatasetSplit as JaxSplit
from dolomite_engine_tpu.enums import Mode as JaxMode
from dolomite_engine_tpu.model_wrapper import get_model as jax_get_model
from dolomite_engine_tpu.train_utils import TrainState as JaxTrainState
from dolomite_engine_tpu_torch import data, finetune
from dolomite_engine_tpu_torch.arguments import TrainingArgs
from dolomite_engine_tpu_torch.data.dataloader import DispatchingDataLoader, ResumableDataLoader, ShardedDataLoader
from dolomite_engine_tpu_torch.data.sampler import BlendedDistributedSampler
from dolomite_engine_tpu_torch.enums import DatasetSplit, Mode
from dolomite_engine_tpu_torch.model_wrapper import ModelWrapperForFinetuning, get_model
from dolomite_engine_tpu_torch.models import load_jax_params
from dolomite_engine_tpu_torch.optimization import build_optimizer_from_args
from dolomite_engine_tpu_torch.train_utils import TrainState

VOCAB, EOS = 128, 0  # EOS "t0": no other word starts with it (an added token matches inside words)
MODEL = dict(
    model_type="gpt_dolomite", vocab_size=VOCAB, n_positions=128, n_embd=32, n_layer=2, n_head=4,
    num_key_value_heads=2, attention_head_type="gqa", position_embedding_type="rope",
    activation_function="swiglu", normalization_function="rmsnorm", add_bias=False,
    resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0, bos_token_id=EOS, eos_token_id=EOS, pad_token_id=EOS,
)
MOE = dict(MODEL, model_type="moe_dolomite", num_experts=4, num_experts_per_tok=2, router_aux_loss_coef=0.01)
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread, as the other port test files hold it: the suite runs these
    files in parallel workers, where torch's spinning pool slows every other worker."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _words(rs, low, high):
    return " ".join(f"t{i}" for i in rs.randint(3, VOCAB, rs.randint(low, high)))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A word-level tokenizer over the vocabulary and two JSON-lines directories: `ragged`
    (inputs of 2-9 words, outputs of 2-6) and `even` (every input 6 words, every output 3:
    the padded ``no_mask`` collate stacks only rows of one length, on both sides)."""
    root = tmp_path_factory.mktemp("finetune")
    tokenizer = chip_smoke.word_tokenizer(str(root / "tokenizer"), VOCAB, EOS)
    rs = np.random.RandomState(0)
    for name, shape in (("ragged", ((2, 10), (2, 7))), ("even", ((6, 7), (3, 4)))):
        (root / name).mkdir()
        for split, count in (("train", 24), ("val", 6)):
            with open(root / name / f"{split}.jsonl", "w") as f:
                for _ in range(count):
                    f.write(json.dumps({"input": _words(rs, *shape[0]), "output": _words(rs, *shape[1])}) + "\n")
    return {"root": root, "tokenizer": tokenizer}


def _config(corpus, method="full_finetuning", save="ckpt", steps=3, data_dir="ragged", model=MODEL, load_args=None, **sections):
    config = dict(
        model_args=dict(model_class="AutoModelForCausalLM", pretrained_config=dict(model)),
        tokenizer_args=dict(tokenizer_name=corpus["tokenizer"]),
        tuning_args=dict(tuning_method=method),
        training_parameters=dict(
            num_training_steps=steps, micro_batch_size=3, gradient_accumulation_steps=1, eval_during_training=True,
            eval_interval=2, gradient_clipping=1.0,
        ),
        datasets=[dict(
            class_name="JSONLinesDataset", data_name="j", class_args=dict(data_path=str(corpus["root"] / data_dir)),
            input_format="__input__", output_format="__output__", max_input_tokens=16, max_output_tokens=8,
        )],
        optimizer_args=dict(class_name="TorchAdamW", class_args=dict(lr=1e-2, weight_decay=0.1, betas=[0.9, 0.95], eps=1e-10)),
        lr_scheduler_args=dict(lr_decay_style="cosine", num_warmup_steps=1),
        mixed_precision_args=dict(dtype="fp32"),
        distributed_args=dict(stage=0),
        save_args=dict(save_path=str(corpus["root"] / save), save_interval=3),
        logging_args=dict(log_interval=1),
        random_args=dict(seed=3),
    )
    for key, value in sections.items():
        config[key] = dict(config.get(key, {}), **value)
    if load_args is not None:
        config["load_args"] = load_args
    return config


# ----------------------------------------------------------------------------- data


class _Blended:
    """A BlendedDatasets stand-in: the sampler reads only sizes, the split and names."""

    def __init__(self, sizes, split):
        self.sizes, self.split, self.datasets = sizes, split, []

    def get_num_examples_in_each_dataset(self):
        return list(self.sizes)

    def get_num_datasets(self):
        return len(self.sizes)

    def __len__(self):
        return sum(self.sizes)


@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("ignore", [True, False])
@pytest.mark.parametrize("replicas", [1, 3])
def test_sampler_streams_match_jax(split, ignore, replicas):
    sizes, ratios = [7, 3, 12], [2, 5, 1]
    for rank in range(replicas):
        options = dict(
            data_sampling_ratios=ratios, num_replicas=replicas, rank=rank,
            ignore_sampling_proportion_for_validation=ignore, shuffle=split == "train", seed=11,
        )
        want = JaxSampler(_Blended(sizes, JaxSplit(split)), **options)
        got = BlendedDistributedSampler(_Blended(sizes, DatasetSplit(split)), **options)
        assert len(got) == len(want)
        for _ in range(3):  # the epoch advances after each pass
            it, want_it = iter(got), iter(want)
            head = [next(it) for _ in range(2)]
            assert head == [next(want_it) for _ in range(2)] and got.state_dict() == want.state_dict()
            assert list(it) == list(want_it)
            assert got.state_dict() == {"epoch": want.epoch, "index": 0}  # the next epoch's start


def test_sampler_and_loader_resume():
    def sampler():
        return BlendedDistributedSampler(_Blended([9, 5], DatasetSplit.train), [1, 1], 1, 0, seed=2)

    unbroken = sampler()
    stream = list(unbroken) + list(unbroken)  # epochs 0 and 1
    first, resumed = sampler(), sampler()
    it = iter(first)
    head = [next(it) for _ in range(5)]
    resumed.load_state_dict(first.state_dict())
    assert head == stream[:5] and list(resumed) == stream[5:14] and list(resumed) == stream[14:]
    # the JAX sampler replays to the index in a generator it drops: its restored pass
    # restarts the epoch (ROADMAP.md Queue C); the port's continues it
    jax_sampler = JaxSampler(_Blended([9, 5], JaxSplit.train), [1, 1], 1, 0, seed=2)
    jax_sampler.load_state_dict(first.state_dict())
    assert list(jax_sampler) == stream[:14]

    class Items:
        def __getitem__(self, i):
            return i

        def state_dict(self):
            return {}

        def load_state_dict(self, state):
            pass

    def loader():
        return ResumableDataLoader(Items(), 3, sampler(), collate_fn=list, drop_last=True)

    first = loader()
    it = iter(first)
    batches = [next(it) for _ in range(2)]
    second = loader()
    second.load_state_dict(json.loads(json.dumps(first.state_dict())))
    assert batches == [stream[0:3], stream[3:6]] and next(iter(second)) == stream[6:9] and len(second) == 4
    epoch = [stream[i : i + 3] for i in range(0, 12, 3)]
    assert list(ShardedDataLoader(loader())) == epoch
    arrays = ResumableDataLoader(
        Items(), 3, sampler(), collate_fn=lambda b: {"ids": np.asarray(b, np.int64), "none": None}, drop_last=True
    )
    dispatched = list(DispatchingDataLoader(arrays))
    assert [b["ids"].tolist() for b in dispatched] == epoch and all(b["none"] is None for b in dispatched)
    assert dispatched[0]["ids"].dtype == torch.int32  # the header announces int32, as in JAX


@pytest.mark.parametrize("padding_free", [False, True], ids=["padded", "padding_free"])
@pytest.mark.parametrize("loss_mask", ["output_only", "no_mask"])
def test_get_dataloader_matches_jax(corpus, padding_free, loss_mask, monkeypatch):
    data_dir = "even" if loss_mask == "no_mask" and not padding_free else "ragged"
    config = _config(
        corpus, data_dir=data_dir, model_args=dict(use_padding_free_transformer=padding_free),
        training_parameters=dict(loss_mask=loss_mask),
    )
    from transformers import AutoTokenizer

    tokenizer = AutoTokenizer.from_pretrained(corpus["tokenizer"])
    monkeypatch.setattr(jax, "device_count", lambda: 1)  # JAX's one-device batch: micro_batch_size rows
    for split in ("train", "val"):
        want_loader = jax_data.get_dataloader(JaxTrainingArgs(**config), JaxSplit(split), JaxMode.training, tokenizer)
        got_loader = data.get_dataloader(TrainingArgs(**config), DatasetSplit(split), Mode.training, tokenizer)
        assert len(got_loader) == len(want_loader)
        for _ in range(2):  # two epochs
            for want, got in zip(want_loader, got_loader, strict=True):
                assert got.keys() == want.keys()
                for key in want:
                    np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)
        if padding_free:
            assert "segment_ids" in got and got["input_ids"].shape[1] % 128 == 0
        else:
            assert "attention_mask" in got
    # dispatching at one rank: rank 0 reads, "broadcasts" to itself and keeps every row
    dispatching = data.get_dataloader(
        TrainingArgs(**dict(config, distributed_args=dict(stage=0, dispatching_dataloader=True))),
        DatasetSplit.train, Mode.training, tokenizer,
    )
    plain = data.get_dataloader(TrainingArgs(**config), DatasetSplit.train, Mode.training, tokenizer)
    assert len(dispatching) == len(plain)
    for want, got in zip(plain, dispatching, strict=True):
        assert got.keys() == want.keys()
        for key in want:
            np.testing.assert_array_equal(got[key].numpy(), want[key], err_msg=key)


# ----------------------------------------------------------------------------- the loss


def _jax_finetuning(model):
    from dolomite_engine_tpu.model_wrapper.pretraining import ModelWrapperForFinetuning as JaxFinetuning

    wrapper = JaxFinetuning(mode=JaxMode.training, pretrained_config=model, dtype="fp32", zero_stage=0)
    params = nn.unbox(wrapper.model.init(jax.random.PRNGKey(1), **wrapper.get_dummy_inputs())["params"])
    return wrapper, params


def _port_finetuning(model, params, **kwargs):
    wrapper = ModelWrapperForFinetuning(model, dtype="fp32", device="cpu", **kwargs)
    load_jax_params(wrapper.model, jax.tree.map(np.asarray, params), device="cpu")
    return wrapper


def _flat(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        name = f"{prefix}.{key}" if prefix else key
        out.update(_flat(value, name) if isinstance(value, dict) else {name: np.asarray(value)})
    return out


def _port_name(flax_name):
    """The port's parameter name of a flax leaf path (kernels are transposed by the caller)."""
    parts = flax_name.replace("h_", "h.").split(".")
    leaf = parts[-1]
    return ".".join(parts[:-1] + ["weight" if leaf in ("kernel", "embedding") else leaf])


@pytest.mark.parametrize("layout, model", [("padded", MODEL), ("packed", MODEL), ("padded", MOE)], ids=["padded", "packed", "moe"])
def test_finetuning_loss_and_grads_match_jax(layout, model):
    from dolomite_engine_tpu.enums import LossMask as JaxLossMask

    rs = np.random.RandomState(4)
    examples = []
    for n in rs.randint(4, 14, 3):
        tokens = list(rs.randint(3, VOCAB, n))
        examples.append({"input": tokens, "output": tokens[-3:]})
    batch = jax_data.collate_fn(
        examples, mode=JaxMode.training, loss_mask=JaxLossMask.output_only, eos_token_id=EOS,
        is_encoder_decoder=False, use_padding_free_transformer=layout == "packed", pad_to_multiple=32,
    )
    jax_wrapper, params = _jax_finetuning(model)
    # jitted: one compile in place of eager JAX's compile per primitive
    grad_fn = jax.jit(jax.value_and_grad(lambda p, b: jax_wrapper.loss(p, b, train=False)))
    want_loss, want_grads = grad_fn(params, {k: jnp.asarray(v) for k, v in batch.items()})
    wrapper = _port_finetuning(model, params)
    loss = wrapper.loss(batch, train=False)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), **TOL)
    named = dict(wrapper.model.named_parameters())
    for flax_name, want in _flat(want_grads).items():
        if flax_name.endswith("kernel") and want.ndim == 2:
            want = want.T
        np.testing.assert_allclose(named[_port_name(flax_name)].grad.numpy(), want, **TOL, err_msg=flax_name)
    if model is MOE:  # the auxiliary loss is in both
        out = wrapper.model(**wrapper.prepare_inputs(batch))
        assert out.aux_loss is not None and out.aux_loss.item() > 0


def test_model_name_local_directory(corpus, tmp_path):
    checkpoint = tmp_path / "granite"
    checkpoint.mkdir()
    (checkpoint / "config.json").write_text(json.dumps(MODEL))
    for name in ("tokenizer.json", "tokenizer_config.json", "special_tokens_map.json"):
        source = os.path.join(corpus["tokenizer"], name)
        if os.path.isfile(source):
            (checkpoint / name).write_text(open(source).read())
    config = _config(corpus, model_args=dict(model_name=str(checkpoint), pretrained_config=None), tokenizer_args=dict(tokenizer_name=None))
    wrapper = get_model(TrainingArgs(**config), Mode.training, device="cpu")
    assert wrapper.config.n_embd == MODEL["n_embd"] and wrapper.tokenizer.eos_token_id == EOS
    (checkpoint / "config.json").write_text(json.dumps(dict(MODEL, model_type="llama")))
    with pytest.raises(ValueError, match="not a dolomite model family"):
        get_model(TrainingArgs(**config), Mode.training, device="cpu")
    config["model_args"]["model_name"] = "ibm/granite-3b-code-base"
    with pytest.raises(NotImplementedError, match="'Interop and tools'"):
        finetune.main(TrainingArgs(**config), device="cpu")


# ----------------------------------------------------------------------------- finetune.main

METHODS = {
    "full_finetuning": {},
    "lora": dict(lora_args=dict(lora_rank=4, lora_alpha=8.0, lora_dropout=0.1)),
    "prompt_tuning": dict(prompt_tuning_args=dict(prompt_tuning_init="RANDOM", num_virtual_tokens=4)),
}


def _curve(summary):
    return [(s["step"], s["loss"], s["grad_norm"]) for s in summary["steps"]]


@pytest.mark.parametrize("method", list(METHODS))
def test_main_resume_is_bit_identical(corpus, method):
    """3 steps, a save, a resumed main to 5: the same losses, grad norms, batches and
    weights as 5 unbroken steps (dropout on in the model and the adapters)."""
    model = dict(MODEL, resid_pdrop=0.1)
    options = dict(
        tuning_args=dict(tuning_method=method, **METHODS[method]),
        training_parameters=dict(gradient_accumulation_steps=2, micro_batch_size=2),
        lr_scheduler_args=dict(num_decay_steps=4),  # the schedule does not depend on the run's length
    )

    def run(save, steps, load=None):
        config = _config(corpus, method, save=f"{method}-{save}", steps=steps, model=model, load_args=load, **options)
        config["save_args"]["save_optimizer"] = True
        return finetune.main(TrainingArgs(**config), device="cpu")

    unbroken = run("unbroken", 5)
    first = run("broken", 3)
    resumed = run("broken", 5, load={"load_path": str(corpus["root"] / f"{method}-broken")})
    assert _curve(first) == _curve(unbroken)[:3]
    assert _curve(resumed) == _curve(unbroken)[3:]
    assert resumed["val_losses"][5] == unbroken["val_losses"][5]
    assert all(np.isfinite(s["loss"]) for s in unbroken["steps"])
    import torch.distributed.checkpoint as dcp

    def weights(save):
        path = corpus["root"] / f"{method}-{save}" / "global_step5" / "state"
        keys = dcp.FileSystemReader(str(path)).read_metadata().state_dict_metadata
        tree = {k: torch.empty(m.size, dtype=m.properties.dtype) for k, m in keys.items() if k.startswith(("model.", "optimizer.mu.", "optimizer.nu."))}
        dcp.load(tree, checkpoint_id=str(path), no_dist=True)
        return tree

    a, b = weights("unbroken"), weights("broken")
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    moments = sorted(k.split(".", 2)[2] for k in a if k.startswith("optimizer.mu."))
    if method == "lora":
        assert moments and all(k.endswith(("lora_a", "lora_b")) for k in moments)
    elif method == "prompt_tuning":
        assert moments == ["prompt_embeddings"]


def test_main_losses_match_jax_train(corpus, monkeypatch):
    """Full finetuning: the port's loop against JAX's `finetune.train` from the same
    weights over the same batches (one device), 5 steps of AdamW with clipping and a
    cosine schedule, eval at steps 0, 2, 4 and 5."""
    config = _config(corpus, steps=5, training_parameters=dict(prefetch_depth=0))
    jax_args = JaxTrainingArgs(**config)
    monkeypatch.setattr(jax, "device_count", lambda: 1)
    jax_model = jax_get_model(jax_args, JaxMode.training)
    params = nn.unbox(jax_model.model.init(jax.random.PRNGKey(5), **jax_model.get_dummy_inputs())["params"])
    params_np = jax.tree.map(np.asarray, params)  # the JAX step donates its state
    optimizer, schedule = jax_finetune.build_optimizer_from_args(jax_args, jax_model)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=optimizer.init(params))
    steps, evals = [], {}
    monkeypatch.setattr(jax_finetune, "save_checkpoint", lambda *a, **k: None)
    monkeypatch.setattr(jax_finetune, "track_train_metrics", lambda **k: steps.append((k["global_step"], k["train_loss_step"], k["grad_norm"])))
    evaluate = jax_finetune.evaluate
    monkeypatch.setattr(jax_finetune, "evaluate", lambda loader, model, state, step, *a: evals.__setitem__(step, evaluate(loader, model, state, step, *a)))
    loader = jax_data.get_dataloader(jax_args, JaxSplit.train, JaxMode.training, jax_model.tokenizer)
    val = jax_data.get_dataloader(jax_args, JaxSplit.val, JaxMode.training, jax_model.tokenizer)
    jax_finetune.train(jax_args, jax_model, state, optimizer, schedule, loader, val, None)

    args = TrainingArgs(**config)
    model = get_model(args, Mode.training, device="cpu")
    load_jax_params(model.model, params_np, device="cpu")
    port_optimizer, port_schedule = build_optimizer_from_args(args, model)
    summary = finetune.train(
        args, model, TrainState(model.model, port_optimizer), port_schedule,
        data.get_dataloader(args, DatasetSplit.train, Mode.training, model.tokenizer),
        data.get_dataloader(args, DatasetSplit.val, Mode.training, model.tokenizer), None,
    )
    got = _curve(summary)
    assert [s for s, _, _ in got] == [s for s, _, _ in steps] == [1, 2, 3, 4, 5]
    np.testing.assert_allclose([l for _, l, _ in got], [l for _, l, _ in steps], rtol=1e-5)
    np.testing.assert_allclose([g for _, _, g in got], [g for _, _, g in steps], rtol=1e-5)
    assert summary["val_losses"].keys() == evals.keys() == {0, 2, 4, 5}
    np.testing.assert_allclose([summary["val_losses"][k] for k in sorted(evals)], [evals[k] for k in sorted(evals)], rtol=1e-5)
    assert got[-1][1] < got[0][1]


def test_generation_from_a_peft_checkpoint_is_refused(corpus):
    """JAX's serving engine cannot serve a prompt-tuning model (`PromptTuningCausalLM` has
    no ``init_kv_caches`` and refuses ``position_ids``), so the port refuses generation from
    a prompt-tuning checkpoint, naming why; a LoRA checkpoint loads with its adapters."""
    from dolomite_engine_tpu_torch.arguments import InferenceArgs
    from dolomite_engine_tpu_torch.checkpointing import load_checkpoint_for_inference

    for method in ("prompt_tuning", "lora"):
        config = _config(corpus, method, save=f"{method}-generate", steps=1, tuning_args=dict(tuning_method=method, **METHODS[method]))
        finetune.main(TrainingArgs(**config), device="cpu")
        inference = InferenceArgs(
            load_args=dict(load_path=config["save_args"]["save_path"]), datasets=config["datasets"],
            generation_parameters=dict(batch_size=1, max_new_tokens=2), output_dir=str(corpus["root"] / "out"),
        )
        if method == "prompt_tuning":
            with pytest.raises(NotImplementedError, match="cannot serve PromptTuningCausalLM"):
                load_checkpoint_for_inference(inference, device="cpu")
        else:
            wrapper, _ = load_checkpoint_for_inference(inference, device="cpu")
            adapters = [name for name, _ in wrapper.model.named_parameters() if name.endswith("lora_b")]
            assert adapters and not wrapper.model.training


def test_padded_micro_batches_of_different_lengths():
    """JAX stacks a step's micro-batches with ``jnp.stack``, which raises on two padded
    micro-batches of different lengths (ROADMAP.md Queue C); the port's step batch is a
    list, each micro-batch at its own length."""
    micros = [
        {"input_ids": np.ones((2, 7), np.int32), "attention_mask": np.ones((2, 7), np.int32), "labels": np.ones((2, 7), np.int32)},
        {"input_ids": np.ones((2, 9), np.int32), "attention_mask": np.ones((2, 9), np.int32), "labels": np.ones((2, 9), np.int32)},
    ]
    with pytest.raises((TypeError, ValueError)):
        jax_finetune._stack_micro_batches(micros)
    step = finetune.stack_micro_batches(micros)
    assert [t.shape for t in step["input_ids"]] == [(2, 7), (2, 9)] and step.keys() == micros[0].keys()
