"""The port's generation entry point against the JAX package's, on the CPU.

- `generate.generate` writes the same jsonl as the JAX function, greedy, through the
  paged engine and through the dense slot pool (the same weights, carried by
  `load_jax_params`; a stub word tokenizer on both sides);
- `generate.main` from a checkpoint the port's `pretrain.main` wrote (2 steps of a tiny
  model with a word-level tokenizer built in the test): `load_checkpoint_for_inference`
  reads the model's weights and no optimizer moment, and its logits equal the trained
  model's; the jsonl holds every prompt's line in order, within `max_new_tokens`, in the
  tokenizer's words, for both engines; `main` without `load_args` builds the model from
  `model_args`;
- with speculation or swap preemption over an oversubscribed pool, `generate.generate`
  writes the JAX function's jsonl; from the checkpoint, `generate.main` with n-gram
  speculation or recompute preemption writes the plain greedy run's;
- the options the port does not run raise, naming their ROADMAP item (the fleet's
  ``replicas``, ``disaggregate`` and ``trace_requests`` run: `tests/test_torch_serving_cluster.py`);
- `_pad_to_static_shapes` pads as the JAX function does.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed.checkpoint as dcp
from flax import linen as nn

from dolomite_engine_tpu import generate as jax_generate
from dolomite_engine_tpu.arguments import InferenceArgs as JaxInferenceArgs
from dolomite_engine_tpu.data import get_datasets_list as jax_get_datasets_list
from dolomite_engine_tpu.enums import DatasetSplit as JaxSplit
from dolomite_engine_tpu.enums import Mode as JaxMode
from dolomite_engine_tpu.model_wrapper import ModelWrapperForFinetuning as JaxWrapper
from dolomite_engine_tpu_torch import checkpointing, generate, pretrain
from dolomite_engine_tpu_torch.arguments import InferenceArgs, TrainingArgs
from dolomite_engine_tpu_torch.data import get_datasets_list
from dolomite_engine_tpu_torch.enums import DatasetSplit, Mode
from dolomite_engine_tpu_torch.model_wrapper import ModelWrapperForFinetuning, ModelWrapperForPretraining, get_model
from dolomite_engine_tpu_torch.models import GPTDolomiteForCausalLM, load_jax_params
from tests.test_torch_data import WordTokenizer
from tests.test_torch_model import ROPE_GQA
from tests.test_torch_pretrain import _training_args, _write_corpus

MAX_NEW = 6


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: generation is many small steps, and under the suite's parallel
    workers an oversubscribed thread pool runs them many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _write_prompts(directory, vocab, rows=5, seed=3):
    rs = np.random.RandomState(seed)
    directory.mkdir(parents=True, exist_ok=True)
    with open(directory / "test.jsonl", "w") as f:
        for n in rs.randint(4, 30, rows):
            f.write(json.dumps({"input": " ".join(f"t{i}" for i in rs.randint(3, vocab, n)), "output": ""}) + "\n")
    return str(directory)


def _inference_config(prompts, output_dir, paged, **extra):
    return dict(
        datasets=[dict(class_name="JSONLinesDataset", data_name="prompts", class_args={"data_path": prompts}, max_input_tokens=24)],
        generation_parameters=dict(
            batch_size=2, max_new_tokens=MAX_NEW, prompt_bucket_multiple=8, paged_kv_cache=paged, kv_page_size=8,
            prefill_chunk_tokens=16,
        ),
        output_dir=str(output_dir),
        **extra,
    )


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_generate_writes_the_jax_jsonl(tmp_path, paged):
    config = dict(ROPE_GQA, initializer_range=0.3)
    prompts = _write_prompts(tmp_path / "prompts", config["vocab_size"])
    model_args = dict(model_class="AutoModelForCausalLM", pretrained_config=config)

    jax_args = JaxInferenceArgs(**_inference_config(prompts, tmp_path / "jax", paged, model_args=model_args))
    jax_model = JaxWrapper(mode=JaxMode.inference, pretrained_config=config)
    jax_model.tokenizer = WordTokenizer()
    params = nn.unbox(jax_model.model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    datasets, _ = jax_get_datasets_list(jax_args.datasets, JaxSplit.test, JaxMode.inference, jax_model.tokenizer)
    jax_generate.generate(jax_args, jax_model, params, datasets, JaxMode.inference)

    args = InferenceArgs(**_inference_config(prompts, tmp_path / "port", paged, model_args=model_args))
    model = ModelWrapperForFinetuning(config, device="cpu")
    model.tokenizer = WordTokenizer()
    load_jax_params(model.model, jax.tree.map(np.asarray, params), device="cpu")
    datasets, _ = get_datasets_list(args.datasets, DatasetSplit.test, Mode.inference, model.tokenizer)
    summary = generate.generate(args, model, datasets, Mode.inference)

    want = (tmp_path / "jax" / "output-prompts.jsonl").read_text()
    got = (tmp_path / "port" / "output-prompts.jsonl").read_text()
    assert got == want
    lines = [json.loads(line) for line in got.splitlines()]
    assert len(lines) == 5 and len({line["generated_text"] for line in lines}) > 1
    assert summary["requests"] == 5 and summary["generated_tokens"] == sum(line["num_generated_tokens"] for line in lines)
    assert summary["pool"]["paged"] == paged and (tmp_path / "port" / "inference_config.yml").is_file()


@pytest.mark.parametrize(
    "options",
    [dict(speculate_ngram=True, draft_k=3), dict(preemption="swap", oversubscribe_ratio=2.0, kv_num_pages=5)],
    ids=["speculate_ngram", "swap-oversubscribed"],
)
def test_generate_with_speculation_or_preemption_writes_the_jax_jsonl(tmp_path, options):
    """The YAML's speculation, and swap preemption over an oversubscribed pool of 4 pages
    (each request's worst case is up to 4 pages, so two in flight run it dry), through
    both packages' `generate` with the same weights: the same greedy jsonl, and the port's
    engine really speculated or preempted."""
    config = dict(ROPE_GQA, initializer_range=0.3)
    prompts = _write_prompts(tmp_path / "prompts", config["vocab_size"], rows=6)
    model_args = dict(model_class="AutoModelForCausalLM", pretrained_config=config)

    def args_for(cls, name):
        args = _inference_config(prompts, tmp_path / name, True, model_args=model_args)
        args["generation_parameters"].update(options)
        return cls(**args)

    jax_args = args_for(JaxInferenceArgs, "jax")
    jax_model = JaxWrapper(mode=JaxMode.inference, pretrained_config=config)
    jax_model.tokenizer = WordTokenizer()
    params = nn.unbox(jax_model.model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    datasets, _ = jax_get_datasets_list(jax_args.datasets, JaxSplit.test, JaxMode.inference, jax_model.tokenizer)
    jax_generate.generate(jax_args, jax_model, params, datasets, JaxMode.inference)

    args = args_for(InferenceArgs, "port")
    model = ModelWrapperForFinetuning(config, device="cpu")
    model.tokenizer = WordTokenizer()
    load_jax_params(model.model, jax.tree.map(np.asarray, params), device="cpu")
    datasets, _ = get_datasets_list(args.datasets, DatasetSplit.test, Mode.inference, model.tokenizer)
    summary = generate.generate(args, model, datasets, Mode.inference)

    got = (tmp_path / "port" / "output-prompts.jsonl").read_text()
    assert got == (tmp_path / "jax" / "output-prompts.jsonl").read_text()
    assert len(got.splitlines()) == 6
    stats = summary["stats"]
    if "speculate_ngram" in options:
        assert stats.draft_tokens_proposed > 0
    else:
        assert stats.preemptions > 0 and stats.pages_swapped_in == stats.pages_swapped_out > 0


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A 2-step pretrain run of the port with a word-level tokenizer: (its directory, the
    trained wrapper, the tokenizer directory)."""
    import chip_smoke

    tmp_path = tmp_path_factory.mktemp("trained")
    tokenizer = chip_smoke.word_tokenizer(str(tmp_path / "tokenizer"), 128, 1)
    args = _training_args(tmp_path, _write_corpus(tmp_path), num_steps=2, tokenizer_args={"tokenizer_name": tokenizer})
    wrappers = []
    build = pretrain.get_model

    def keep(*a, **kw):
        wrappers.append(build(*a, **kw))
        return wrappers[-1]

    pretrain.get_model = keep
    try:
        pretrain.main(args, device="cpu")
    finally:
        pretrain.get_model = build
    return tmp_path, wrappers[0], tokenizer


def test_load_checkpoint_for_inference_reads_only_the_weights(trained, monkeypatch):
    tmp_path, trained_wrapper, _ = trained
    read = []
    original = dcp.FileSystemReader.read_data

    def recording(self, plan, planner):
        read.extend(item.storage_index.fqn for item in plan.items)
        return original(self, plan, planner)

    monkeypatch.setattr(dcp.FileSystemReader, "read_data", recording)
    args = InferenceArgs(**_inference_config("unused", tmp_path / "out", True, load_args={"load_path": str(tmp_path / "ckpt")}))
    inits = []
    monkeypatch.setattr(GPTDolomiteForCausalLM, "init_weights", lambda self, seed: inits.append(seed))
    seconds = {}
    model, training_args = checkpointing.load_checkpoint_for_inference(args, device="cpu", seconds=seconds)
    assert not inits  # built on the meta device: no random init before the restore
    assert set(seconds) == {"build", "read", "cast"} and all(v >= 0 for v in seconds.values())
    assert isinstance(model, ModelWrapperForPretraining) and model.mode == Mode.inference
    assert isinstance(training_args, TrainingArgs)
    assert read and all(name.startswith("model.") for name in read)  # no optimizer moment, no step
    assert sorted(read) == sorted(f"model.{name}" for name in model.model.state_dict())
    ids = torch.randint(3, 128, (2, 16), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert torch.equal(model.model(ids).logits, trained_wrapper.model(ids).logits)
    assert model.tokenizer is not None and model.eos_token_id == 1


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_main_from_a_port_checkpoint(trained, paged):
    tmp_path, _, _ = trained
    prompts = _write_prompts(tmp_path / "prompts", 128, rows=6)
    output_dir = tmp_path / f"out-{paged}"
    generation = dict(do_sample=True, temperature=0.7, top_p=0.95)
    config = _inference_config(prompts, output_dir, paged, load_args={"load_path": str(tmp_path / "ckpt"), "iteration": 2})
    config["generation_parameters"].update(generation)
    summary = generate.main(InferenceArgs(**config), device="cpu")
    lines = [json.loads(line) for line in (output_dir / "output-prompts.jsonl").read_text().splitlines()]
    assert len(lines) == 6 == summary["requests"]
    assert all(0 < line["num_generated_tokens"] <= MAX_NEW for line in lines)
    words = [word for line in lines for word in line["generated_text"].split()]
    assert words and all(word[0] == "t" and 0 <= int(word[1:]) < 128 for word in words)
    assert set(summary["seconds"]) == {"load", "datasets", "generate"}
    assert set(summary["load_seconds"]) == {"build", "read", "cast"}
    assert summary["stats"].completed == 6 and summary["pool"]["paged"] == paged
    # the same seeds draw the same streams
    again = generate.main(InferenceArgs(**dict(config, output_dir=str(tmp_path / f"again-{paged}"))), device="cpu")
    assert (tmp_path / f"again-{paged}" / "output-prompts.jsonl").read_text() == (output_dir / "output-prompts.jsonl").read_text()
    assert again["generated_tokens"] == summary["generated_tokens"]


def test_main_with_speculation_and_preemption_writes_the_plain_greedy_jsonl(trained):
    """`generate.main` from the port's checkpoint, greedy: with n-gram speculation, and
    with recompute preemption over an oversubscribed pool of 5 pages, it writes the jsonl
    of the plain run."""
    tmp_path, _, _ = trained
    prompts = _write_prompts(tmp_path / "prompts-spec", 128, rows=6, seed=4)
    outputs = []
    for name, options in (
        ("plain", {}),
        ("spec", dict(speculate_ngram=True, draft_k=4)),
        ("recompute", dict(preemption="recompute", oversubscribe_ratio=2.0, kv_num_pages=5)),
    ):
        config = _inference_config(prompts, tmp_path / f"out-{name}", True, load_args={"load_path": str(tmp_path / "ckpt"), "iteration": 2})
        config["generation_parameters"].update(options)
        summary = generate.main(InferenceArgs(**config), device="cpu")
        outputs.append((tmp_path / f"out-{name}" / "output-prompts.jsonl").read_text())
        if name == "recompute":
            assert summary["stats"].preemptions > 0
    assert outputs[1] == outputs[0] and outputs[2] == outputs[0]


def test_main_without_a_checkpoint(tmp_path, trained):
    _, _, tokenizer = trained
    config = dict(ROPE_GQA, vocab_size=128, eos_token_id=1)
    prompts = _write_prompts(tmp_path / "prompts", 128, rows=3)
    args = InferenceArgs(
        **_inference_config(
            prompts, tmp_path / "out", False, model_args=dict(model_class="AutoModelForCausalLM", pretrained_config=config),
            tokenizer_args={"tokenizer_name": tokenizer},
        )
    )
    summary = generate.main(args, device="cpu")
    assert summary["requests"] == 3 and (tmp_path / "out" / "output-prompts.jsonl").read_text().count("\n") == 3


@pytest.mark.parametrize(
    "option, item",
    [
        (dict(draft_model="a-model"), "Interop and tools"),
        (dict(tensor_parallel_size=2), "Distribution"),
    ],
    ids=lambda value: "-".join(value) if isinstance(value, dict) else None,
)
def test_unported_generation_options_name_their_roadmap_item(tmp_path, option, item, monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)  # tensor_parallel_size's check
    config = _inference_config("unused", tmp_path, True, load_args={"load_path": "unused"})
    config["generation_parameters"].update(option)
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md Queue A, '{item}'"):
        generate.main(InferenceArgs(**config), device="cpu")


def test_other_refusals(tmp_path):
    model_args = dict(model_class="AutoModelForCausalLM", pretrained_config=ROPE_GQA)
    config = _inference_config("unused", tmp_path, True, model_args=dict(model_class="AutoModelForCausalLM", model_name="a/model"))
    with pytest.raises(NotImplementedError, match="'Interop and tools'"):
        generate.main(InferenceArgs(**config), device="cpu")
    config = _inference_config("unused", tmp_path, True, model_args=model_args, kernel_args={"rmsnorm": "pallas"})
    with pytest.raises(ValueError, match="no backend switch"):
        generate.main(InferenceArgs(**config), device="cpu")
    with pytest.raises(NotImplementedError, match="'Interop and tools'"):
        generate.load_draft_model("a/draft")
    assert generate.load_draft_model(None) == (None, None)
    # the finetuning wrapper's loss over a collated padded batch
    finetuning = ModelWrapperForFinetuning(ROPE_GQA, device="cpu")
    batch = {
        "input_ids": np.array([[1, 1, 5, 6, 7], [8, 9, 10, 11, 12]]), "attention_mask": np.array([[0, 0, 1, 1, 1], [1, 1, 1, 1, 1]]),
        "labels": np.array([[-100, -100, -100, 7, -100], [-100, -100, 11, 12, -100]]),
    }
    assert torch.isfinite(finetuning.loss(batch))
    training = TrainingArgs(
        model_args=model_args, tuning_args=dict(tuning_method="full_finetuning"), save_args=dict(save_path="unused", save_interval=1),
        datasets=[dict(class_name="DebugDataset", data_name="d", class_args={"num_examples": 1})],
        mixed_precision_args=dict(dtype="bf16"),
    )
    wrapper = get_model(training, Mode.inference, device="cpu")
    assert isinstance(wrapper, ModelWrapperForFinetuning)
    assert wrapper.model.transformer.h[0].attn.c_attn.weight.dtype == torch.bfloat16  # the compute dtype
    wrapper = get_model(training, Mode.training, device="cpu")  # finetuning trains: fp32 master weights
    assert isinstance(wrapper, ModelWrapperForFinetuning)
    assert wrapper.model.transformer.h[0].attn.c_attn.weight.dtype == torch.float32


@pytest.mark.parametrize("rows, width", [(2, 13), (3, 16)])
def test_pad_to_static_shapes_matches_jax(rows, width):
    rs = np.random.RandomState(0)
    collated = {"input_ids": rs.randint(3, 90, (rows, width)), "attention_mask": (rs.rand(rows, width) > 0.3).astype(np.int32)}
    want = jax_generate._pad_to_static_shapes(collated, 4, 1, width_multiple=8)
    got = generate._pad_to_static_shapes(collated, 4, 1, width_multiple=8)
    for key in want:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]))
