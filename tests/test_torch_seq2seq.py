"""The port's seq2seq finetuning and generation against the JAX package's, on the CPU.

- `finetune.train` (the loop `finetune.main` runs) with full finetuning against JAX's
  `finetune.train` from the same weights over the same collated encoder-decoder batches:
  3 steps of AdamW with clipping and a cosine schedule, the losses and eval losses within
  rtol 1e-5, the grad norms within 1e-4 (`GRAD_NORM_RTOL`) (fp32).
- LoRA over the encoder-decoder: the default targets are JAX's (``c_attn``, ``c_q``,
  ``c_kv``: the same adapter paths as JAX's `LoRACausalLM` tree), and 3 steps of the
  port's loop against JAX built from its own pieces over the adapters alone (``jax.grad``
  with the base closed over, `clip_grad_norm`, optax AdamW), as JAX's `finetune` optimizer
  moves the base (ROADMAP.md Queue C): losses within rtol 1e-5, grad norms 1e-4.
- `generate.generate` writes JAX's jsonl, greedy, token for token (the same weights, a
  stub word tokenizer on both sides; a ragged last batch padded to `batch_size`).
- `finetune.main` on a tiny seq2seq YAML (full finetuning and LoRA) and `generate.main`
  from the full run's checkpoint: the rebuilt wrapper's logits equal the trained model's,
  and every prompt gets its line.
- The flan-t5-base literal of `chip_smoke.py` is what JAX's `hf_interop` makes of that
  model's public ``config.json``; `model_class` must match the family; prompt tuning over
  an encoder-decoder is refused (it fails in JAX too).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml
from flax import linen as nn

import chip_smoke
from dolomite_engine_tpu import data as jax_data
from dolomite_engine_tpu import finetune as jax_finetune
from dolomite_engine_tpu import generate as jax_generate
from dolomite_engine_tpu.arguments import InferenceArgs as JaxInferenceArgs
from dolomite_engine_tpu.arguments import TrainingArgs as JaxTrainingArgs
from dolomite_engine_tpu.arguments import TuningArgs as JaxTuningArgs
from dolomite_engine_tpu.data import get_datasets_list as jax_get_datasets_list
from dolomite_engine_tpu.enums import DatasetSplit as JaxSplit
from dolomite_engine_tpu.enums import Mode as JaxMode
from dolomite_engine_tpu.model_wrapper import ModelWrapperForFinetuning as JaxWrapper
from dolomite_engine_tpu.model_wrapper import get_model as jax_get_model
from dolomite_engine_tpu.model_wrapper.peft import ModelWrapperForPEFT as JaxPEFT
from dolomite_engine_tpu.optimization import get_optimizer as jax_get_optimizer
from dolomite_engine_tpu.train_utils import TrainState as JaxTrainState
from dolomite_engine_tpu.train_utils import clip_grad_norm as jax_clip_grad_norm
from dolomite_engine_tpu_torch import data, finetune, generate
from dolomite_engine_tpu_torch.arguments import InferenceArgs, TrainingArgs, get_args
from dolomite_engine_tpu_torch.checkpointing import load_checkpoint_for_inference
from dolomite_engine_tpu_torch.data import get_datasets_list
from dolomite_engine_tpu_torch.enums import DatasetSplit, Mode
from dolomite_engine_tpu_torch.model_wrapper import ModelWrapperForFinetuning, get_model
from dolomite_engine_tpu_torch.models import load_jax_params
from dolomite_engine_tpu_torch.optimization import build_optimizer_from_args
from dolomite_engine_tpu_torch.peft import lora_targets
from dolomite_engine_tpu_torch.train_utils import TrainState
from tests.test_torch_data import WordTokenizer

VOCAB, EOS = 96, 0  # EOS "t0": no other word starts with it
MODEL = dict(
    model_type="enc_dec_dolomite", vocab_size=VOCAB, n_positions=64, n_embd=32, n_layer=2, n_encoder_layer=2,
    n_head=4, num_key_value_heads=4, attention_head_type="mha", position_embedding_type="relative_bucketed",
    relative_attention_num_buckets=8, relative_attention_max_distance=16, activation_function="gelu_pytorch_tanh_glu",
    normalization_function="rmsnorm", add_bias=False, tie_word_embeddings=False, attention_multiplier=1.0,
    resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0, bos_token_id=None, eos_token_id=EOS, pad_token_id=EOS,
    initializer_range=0.05,
)
LORA = dict(tuning_method="lora", lora_args=dict(lora_rank=4, lora_alpha=8.0, lora_dropout=0.0))
ADAM = dict(lr=1e-2, weight_decay=0.1, betas=[0.9, 0.95], eps=1e-10)
SEQ2SEQ = "AutoModelForSeq2SeqLM"
# the global grad norm: the square root of ~40 k squared gradients of 2 + 2 blocks, summed
# in another order by jitted XLA, after steps whose updates carry those differences on
GRAD_NORM_RTOL = 1e-4


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _words(rs, low, high):
    return " ".join(f"t{i}" for i in rs.randint(3, VOCAB, rs.randint(low, high)))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A word-level tokenizer and JSON-lines train / val / test splits (inputs of 3-14
    words, outputs of 2-8)."""
    root = tmp_path_factory.mktemp("seq2seq")
    tokenizer = chip_smoke.word_tokenizer(str(root / "tokenizer"), VOCAB, EOS)
    rs = np.random.RandomState(0)
    (root / "data").mkdir()
    for split, count in (("train", 18), ("val", 4), ("test", 5)):
        with open(root / "data" / f"{split}.jsonl", "w") as f:
            for _ in range(count):
                f.write(json.dumps({"input": _words(rs, 3, 15), "output": _words(rs, 2, 9)}) + "\n")
    return {"root": root, "tokenizer": tokenizer}


def _config(corpus, method="full_finetuning", save="ckpt", steps=3, **sections):
    config = dict(
        model_args=dict(model_class=SEQ2SEQ, pretrained_config=dict(MODEL)),
        tokenizer_args=dict(tokenizer_name=corpus["tokenizer"]),
        tuning_args=dict(tuning_method=method),
        training_parameters=dict(
            num_training_steps=steps, micro_batch_size=3, gradient_accumulation_steps=1, eval_during_training=True,
            eval_interval=2, gradient_clipping=1.0, prefetch_depth=0,
        ),
        datasets=[dict(
            class_name="JSONLinesDataset", data_name="j", class_args=dict(data_path=str(corpus["root"] / "data")),
            input_format="__input__", output_format="__output__", max_input_tokens=12, max_output_tokens=8,
        )],
        optimizer_args=dict(class_name="TorchAdamW", class_args=ADAM),
        lr_scheduler_args=dict(lr_decay_style="cosine", num_warmup_steps=1),
        mixed_precision_args=dict(dtype="fp32"),
        distributed_args=dict(stage=0),
        save_args=dict(save_path=str(corpus["root"] / save), save_interval=3),
        logging_args=dict(log_interval=1),
        random_args=dict(seed=3),
    )
    for key, value in sections.items():
        config[key] = dict(config.get(key, {}), **value)
    return config


def _curve(summary):
    return [(s["step"], s["loss"], s["grad_norm"]) for s in summary["steps"]]


def test_full_finetuning_losses_match_jax_train(corpus, monkeypatch):
    config = _config(corpus)
    jax_args = JaxTrainingArgs(**config)
    monkeypatch.setattr(jax, "device_count", lambda: 1)
    jax_model = jax_get_model(jax_args, JaxMode.training)
    assert jax_model.is_encoder_decoder
    params = nn.unbox(jax_model.model.init(jax.random.PRNGKey(5), **jax_model.get_dummy_inputs())["params"])
    params_np = jax.tree.map(np.asarray, params)  # the JAX step donates its state
    optimizer, schedule = jax_finetune.build_optimizer_from_args(jax_args, jax_model)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=optimizer.init(params))
    steps, evals = [], {}
    monkeypatch.setattr(jax_finetune, "save_checkpoint", lambda *a, **k: None)
    monkeypatch.setattr(jax_finetune, "track_train_metrics", lambda **k: steps.append((k["global_step"], k["train_loss_step"], k["grad_norm"])))
    evaluate = jax_finetune.evaluate
    monkeypatch.setattr(jax_finetune, "evaluate", lambda loader, model, state, step, *a: evals.__setitem__(step, evaluate(loader, model, state, step, *a)))
    loader = jax_data.get_dataloader(jax_args, JaxSplit.train, JaxMode.training, jax_model.tokenizer, is_encoder_decoder=True)
    val = jax_data.get_dataloader(jax_args, JaxSplit.val, JaxMode.training, jax_model.tokenizer, is_encoder_decoder=True)
    jax_finetune.train(jax_args, jax_model, state, optimizer, schedule, loader, val, None)

    args = TrainingArgs(**config)
    model = get_model(args, Mode.training, device="cpu")
    assert model.is_encoder_decoder
    load_jax_params(model.model, params_np, device="cpu")
    port_optimizer, port_schedule = build_optimizer_from_args(args, model)
    summary = finetune.train(
        args, model, TrainState(model.model, port_optimizer), port_schedule,
        data.get_dataloader(args, DatasetSplit.train, Mode.training, model.tokenizer, is_encoder_decoder=True),
        data.get_dataloader(args, DatasetSplit.val, Mode.training, model.tokenizer, is_encoder_decoder=True), None,
    )
    got = _curve(summary)
    assert [s for s, _, _ in got] == [s for s, _, _ in steps] == [1, 2, 3]
    np.testing.assert_allclose([l for _, l, _ in got], [l for _, l, _ in steps], rtol=1e-5)
    np.testing.assert_allclose([g for _, _, g in got], [g for _, _, g in steps], rtol=GRAD_NORM_RTOL)
    assert summary["val_losses"].keys() == evals.keys() == {0, 2, 3}
    np.testing.assert_allclose([summary["val_losses"][k] for k in sorted(evals)], [evals[k] for k in sorted(evals)], rtol=1e-5)


def _adapter_paths(tree, prefix=""):
    out = set()
    for key, value in tree.items():
        name = f"{prefix}.{key}" if prefix else key
        if isinstance(value, dict):
            out |= _adapter_paths(value, name)
        elif key == "lora_a":
            out.add(prefix.removeprefix("base_model."))
    return out


def _port_path(flax_path):
    parts = flax_path.split(".")
    for stack in ("encoder", "decoder"):
        if parts[0].startswith(stack + "_"):
            parts[0:1] = [stack, parts[0][len(stack) + 1 :]]
    return ".".join(parts)


def test_lora_targets_and_steps_match_jax(corpus):
    config = _config(corpus, "lora", tuning_args=LORA)
    jax_wrapper = JaxPEFT(
        mode=JaxMode.training, pretrained_config=MODEL, model_class=SEQ2SEQ, dtype="fp32", zero_stage=0,
        tuning_args=JaxTuningArgs(**LORA),
    )
    params = nn.unbox(jax_wrapper.model.init(jax.random.PRNGKey(1), **jax_wrapper.get_dummy_inputs())["params"])
    rs = np.random.RandomState(2)
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.asarray(rs.normal(0.0, 0.3, x.shape), jnp.float32) if p[-1].key == "lora_b" else x, params
    )
    args = TrainingArgs(**config)
    model = get_model(args, Mode.training, device="cpu")
    targets = {name for name, _ in lora_targets(model.model, ("c_attn", "c_q", "c_kv"))}
    assert {name for name, _ in lora_targets(model.model, ("lora",))} == set()
    assert set(model.lora_modules) == targets == {_port_path(p) for p in _adapter_paths(params)}
    assert any(".cross_attn.c_kv" in name for name in targets)
    load_jax_params(model.model, jax.tree.map(np.asarray, params), device="cpu")

    batches = list(data.get_dataloader(args, DatasetSplit.train, Mode.training, model.tokenizer, is_encoder_decoder=True))[:3]
    _, schedule = jax_finetune.build_optimizer_from_args(JaxTrainingArgs(**config), jax_wrapper)
    tx = jax_get_optimizer("TorchAdamW", ADAM, schedule)
    adapters = jax.tree_util.tree_map_with_path(lambda p, x: x if p[-1].key in ("lora_a", "lora_b") else None, params)

    def merged(a):
        return jax.tree.map(lambda x, b: b if x is None else x, a, params, is_leaf=lambda x: x is None)

    grad_fn = jax.jit(jax.value_and_grad(lambda a, b: jax_wrapper.loss(merged(a), b, train=False)))
    opt_state, jax_curve = tx.init(adapters), []
    for batch in batches:
        loss, grads = grad_fn(adapters, {k: jnp.asarray(v) for k, v in batch.items()})
        grads, norm = jax_clip_grad_norm(grads, 1.0)
        updates, opt_state = tx.update(grads, opt_state, adapters)
        adapters = optax.apply_updates(adapters, updates)
        jax_curve.append((float(loss), float(norm)))

    port_optimizer, port_schedule = build_optimizer_from_args(args, model)
    summary = finetune.train(
        args, model, TrainState(model.model, port_optimizer), port_schedule,
        data.get_dataloader(args, DatasetSplit.train, Mode.training, model.tokenizer, is_encoder_decoder=True), None, None,
    )
    got = _curve(summary)
    np.testing.assert_allclose([l for _, l, _ in got], [c[0] for c in jax_curve], rtol=1e-5)
    np.testing.assert_allclose([g for _, _, g in got], [c[1] for c in jax_curve], rtol=GRAD_NORM_RTOL)


def _write_prompts(directory, rows=5, seed=3):
    rs = np.random.RandomState(seed)
    directory.mkdir(parents=True, exist_ok=True)
    with open(directory / "test.jsonl", "w") as f:
        for _ in range(rows):
            f.write(json.dumps({"input": _words(rs, 3, 20), "output": ""}) + "\n")
    return str(directory)


def _inference_config(prompts, output_dir, **extra):
    return dict(
        datasets=[dict(class_name="JSONLinesDataset", data_name="prompts", class_args={"data_path": prompts}, max_input_tokens=24)],
        generation_parameters=dict(batch_size=2, max_new_tokens=6, prompt_bucket_multiple=8),
        output_dir=str(output_dir),
        **extra,
    )


def test_generate_writes_the_jax_jsonl(tmp_path):
    config = dict(MODEL, initializer_range=0.5)
    prompts = _write_prompts(tmp_path / "prompts")
    model_args = dict(model_class=SEQ2SEQ, pretrained_config=config)
    jax_args = JaxInferenceArgs(**_inference_config(prompts, tmp_path / "jax", model_args=model_args))
    jax_model = JaxWrapper(mode=JaxMode.inference, pretrained_config=config, model_class=SEQ2SEQ)
    jax_model.tokenizer = WordTokenizer()
    params = nn.unbox(jax_model.model.init(jax.random.PRNGKey(0), **jax_model.get_dummy_inputs())["params"])
    datasets, _ = jax_get_datasets_list(
        jax_args.datasets, JaxSplit.test, JaxMode.inference, jax_model.tokenizer, is_encoder_decoder=True
    )
    jax_generate.generate(jax_args, jax_model, params, datasets, JaxMode.inference)

    args = InferenceArgs(**_inference_config(prompts, tmp_path / "port", model_args=model_args))
    model = ModelWrapperForFinetuning(config, mode=Mode.inference, device="cpu", model_class=SEQ2SEQ)
    model.tokenizer = WordTokenizer()
    load_jax_params(model.model, jax.tree.map(np.asarray, params), device="cpu")
    datasets, _ = get_datasets_list(args.datasets, DatasetSplit.test, Mode.inference, model.tokenizer, is_encoder_decoder=True)
    summary = generate.generate(args, model, datasets, Mode.inference)

    want = (tmp_path / "jax" / "output-prompts.jsonl").read_text()
    got = (tmp_path / "port" / "output-prompts.jsonl").read_text()
    assert got == want
    lines = [json.loads(line) for line in got.splitlines()]
    assert len(lines) == 5 and len({line["generated_text"] for line in lines}) > 1
    assert summary["requests"] == 5 and summary["batches"] == 3
    assert summary["generated_tokens"] == sum(line["num_generated_tokens"] for line in lines)


def test_main_finetunes_and_generates_from_its_checkpoint(corpus, tmp_path):
    """`finetune.main` from a YAML file (full finetuning, then LoRA), then `generate.main`
    from the full run's checkpoint."""
    summaries = {}
    for method, tuning in (("full_finetuning", {"tuning_method": "full_finetuning"}), ("lora", LORA)):
        config = _config(corpus, method, save=f"main-{method}", tuning_args=tuning)
        path = tmp_path / f"{method}.yml"
        path.write_text(yaml.safe_dump(config))
        summaries[method] = finetune.main(get_args(Mode.training, str(path)), device="cpu")
        assert [s["step"] for s in summaries[method]["steps"]] == [1, 2, 3]
        assert all(np.isfinite(s["loss"]) for s in summaries[method]["steps"])
    save_path = corpus["root"] / "main-full_finetuning"
    prompts = _write_prompts(tmp_path / "prompts", rows=3)
    config = _inference_config(
        prompts, tmp_path / "out", load_args=dict(load_path=str(save_path)),
    )
    summary = generate.main(InferenceArgs(**config), device="cpu")
    lines = [json.loads(line) for line in open(summary["outputs"][0])]
    assert len(lines) == 3 and all(0 < line["num_generated_tokens"] <= 6 for line in lines)
    assert all(word.startswith("t") for line in lines for word in line["generated_text"].split())
    model, training_args = load_checkpoint_for_inference(InferenceArgs(**config), device="cpu")
    assert model.is_encoder_decoder and training_args.model_args.model_class == SEQ2SEQ
    # the rebuilt wrapper holds the trained weights: its val loss is the run's last
    batch = next(iter(data.get_dataloader(TrainingArgs(**_config(corpus)), DatasetSplit.val, Mode.training, model.tokenizer, is_encoder_decoder=True)))
    trained = get_model(TrainingArgs(**_config(corpus)), Mode.training, device="cpu")
    import torch.distributed.checkpoint as dcp

    state = {"model": trained.model.state_dict()}
    dcp.load(state, checkpoint_id=str(save_path / "global_step3" / "state"), no_dist=True)
    with torch.no_grad():
        np.testing.assert_allclose(model.loss(batch, train=False).item(), trained.loss(batch, train=False).item(), rtol=1e-6)


FLAN_T5_BASE_CONFIG_JSON = {  # google/flan-t5-base config.json, as published
    "architectures": ["T5ForConditionalGeneration"], "d_ff": 2048, "d_kv": 64, "d_model": 768,
    "decoder_start_token_id": 0, "dense_act_fn": "gelu_new", "dropout_rate": 0.1, "eos_token_id": 1,
    "feed_forward_proj": "gated-gelu", "initializer_factor": 1.0, "is_encoder_decoder": True,
    "is_gated_act": True, "layer_norm_epsilon": 1e-06, "model_type": "t5", "n_positions": 512,
    "num_decoder_layers": 12, "num_heads": 12, "num_layers": 12, "output_past": True, "pad_token_id": 0,
    "relative_attention_max_distance": 128, "relative_attention_num_buckets": 32, "tie_word_embeddings": False,
    "transformers_version": "4.23.1", "use_cache": True, "vocab_size": 32128,
}


def test_flan_t5_literal_is_the_hf_import_of_its_config():
    from dolomite_engine_tpu.hf_interop.conversion import _t5_config_to_dolomite

    assert chip_smoke.FLAN_T5_BASE == _t5_config_to_dolomite(FLAN_T5_BASE_CONFIG_JSON)


def test_model_class_must_match_and_prompt_tuning_is_refused(corpus):
    with pytest.raises(ValueError, match="does not match model_type"):
        ModelWrapperForFinetuning(MODEL, device="cpu", model_class="AutoModelForCausalLM")
    with pytest.raises(ValueError, match="does not match model_type"):
        JaxWrapper(mode=JaxMode.training, pretrained_config=MODEL, model_class="AutoModelForCausalLM")
    config = _config(corpus, "prompt_tuning", tuning_args=dict(
        tuning_method="prompt_tuning", prompt_tuning_args=dict(prompt_tuning_init="RANDOM", num_virtual_tokens=2)
    ))
    with pytest.raises(NotImplementedError, match="'Other families and parallel ops'"):
        get_model(TrainingArgs(**config), Mode.training, device="cpu")
