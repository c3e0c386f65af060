"""Generation from LoRA checkpoints and from HF-layout directories, port against JAX, on the CPU.

- LoRA: a JAX `LoRACausalLM` tree with seeded non-zero ``lora_b`` (dropout 0.1 in its
  config: the engines run without it) is carried across by `load_jax_params` and saved as a
  port checkpoint; the port's `generate.main` from it writes the jsonl JAX's `generate`
  (its `ServingEngine` over the same tree) writes, greedy, on the paged and on the dense
  engine; without the adapters the tokens differ. The encoder-decoder's LoRA checkpoint
  (adapters on ``c_attn``, ``c_q``, ``c_kv``) through the fixed-batch loop
  (`generate_seq2seq_tokens`) likewise.
- Prompt tuning: JAX's engine cannot serve `PromptTuningCausalLM`, and the port's
  `generate.main` refuses a prompt-tuning checkpoint, naming why.
- By name: `generate.main` with a local ``model_name`` directory that JAX's
  `save_pretrained` wrote and no ``load_args`` writes the jsonl JAX's `generate.main` writes
  from it; a ``draft_model`` directory of another depth gives the same greedy tokens.
"""

import json

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
from dolomite_engine_tpu.model_wrapper import ModelWrapperForFinetuning as JaxWrapper
from dolomite_engine_tpu.model_wrapper.peft import ModelWrapperForPEFT as JaxPEFT
from dolomite_engine_tpu.parallel.mesh import MeshManager as JaxMeshManager
from dolomite_engine_tpu_torch import checkpointing, generate
from dolomite_engine_tpu_torch.arguments import InferenceArgs, TrainingArgs
from dolomite_engine_tpu_torch.enums import Mode
from dolomite_engine_tpu_torch.model_wrapper import get_model
from dolomite_engine_tpu_torch.models import load_jax_params
from dolomite_engine_tpu_torch.train_utils import TrainState
from tests.test_torch_generate import _inference_config, _write_prompts
from tests.test_torch_model import ROPE_GQA
from tests.test_torch_seq2seq import MODEL as SEQ2SEQ_MODEL
from tests.test_torch_seq2seq import _inference_config as _seq2seq_inference_config
from tests.test_torch_seq2seq import _write_prompts as _seq2seq_prompts

VOCAB = 128
CAUSAL = dict(ROPE_GQA, vocab_size=VOCAB, initializer_range=0.3, bos_token_id=0, eos_token_id=0, pad_token_id=0)
SEQ2SEQ = dict(SEQ2SEQ_MODEL, initializer_range=0.5)
LORA = dict(tuning_method="lora", lora_args=dict(lora_rank=4, lora_alpha=8.0, lora_dropout=0.1))
PROMPT_TUNING = dict(tuning_method="prompt_tuning", prompt_tuning_args=dict(prompt_tuning_init="RANDOM", num_virtual_tokens=3))


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tokenizers(tmp_path_factory):
    """Word tokenizers (EOS ``t0``) of both vocabularies."""
    root = tmp_path_factory.mktemp("tokenizers")
    return {vocab: chip_smoke.word_tokenizer(str(root / str(vocab)), vocab, 0) for vocab in (VOCAB, SEQ2SEQ["vocab_size"])}


def _jax_peft(config, model_class, tuning, tokenizer, plant_seed=1):
    """JAX's PEFT wrapper and its tree, every ``lora_b`` drawn from a seeded normal."""
    wrapper = JaxPEFT(
        mode=JaxMode.inference, pretrained_config=config, model_class=model_class, tuning_args=JaxTuningArgs(**tuning),
        tokenizer_name=tokenizer,
    )
    params = nn.unbox(wrapper.model.init(jax.random.PRNGKey(0), **wrapper.get_dummy_inputs())["params"])
    rs = np.random.RandomState(plant_seed)
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.asarray(rs.normal(0.0, 0.3, x.shape), jnp.float32) if p[-1].key == "lora_b" else x, params
    )
    return wrapper, params


def _port_checkpoint(path, config, model_class, tuning, tokenizer, params):
    """`params` (a JAX tree) carried into the port's wrapper for `tuning` and saved as the
    port's checkpoint at `path` (step 1, the weights alone)."""
    args = TrainingArgs(
        model_args=dict(model_class=model_class, pretrained_config=config), tuning_args=tuning,
        tokenizer_args=dict(tokenizer_name=tokenizer),
        datasets=[dict(class_name="DebugDataset", data_name="debug", class_args=dict(num_examples=4))],
        save_args=dict(save_path=str(path), save_interval=1, save_optimizer=False),
    )
    wrapper = get_model(args, Mode.training, device="cpu")
    load_jax_params(wrapper.model, jax.tree.map(np.asarray, params), device="cpu")
    checkpointing.save_checkpoint(args, wrapper, TrainState(wrapper.model, None), None, None, 1)
    return str(path)


def _jax_generate(args, wrapper, params, is_encoder_decoder=False):
    datasets, _ = jax_get_datasets_list(args.datasets, JaxSplit.test, JaxMode.inference, wrapper.tokenizer, is_encoder_decoder=is_encoder_decoder)
    jax_generate.generate(args, wrapper, params, datasets, JaxMode.inference)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_lora_checkpoint_generates_the_jax_tokens(tmp_path, tokenizers, paged):
    tokenizer = tokenizers[VOCAB]
    prompts = _write_prompts(tmp_path / "prompts", VOCAB)
    model_args = dict(model_class="AutoModelForCausalLM", pretrained_config=CAUSAL)
    jax_wrapper, params = _jax_peft(CAUSAL, "AutoModelForCausalLM", LORA, tokenizer)
    _jax_generate(JaxInferenceArgs(**_inference_config(prompts, tmp_path / "jax", paged, model_args=model_args)), jax_wrapper, params)

    checkpoint = _port_checkpoint(tmp_path / "ckpt", CAUSAL, "AutoModelForCausalLM", LORA, tokenizer, params)
    summary = generate.main(InferenceArgs(**_inference_config(prompts, tmp_path / "port", paged, load_args=dict(load_path=checkpoint))), device="cpu")
    want = (tmp_path / "jax" / "output-prompts.jsonl").read_text()
    assert (tmp_path / "port" / "output-prompts.jsonl").read_text() == want
    assert summary["requests"] == 5 and summary["pool"]["paged"] == paged

    if paged:  # the same base without its adapters writes other tokens
        bare = jax.tree_util.tree_map_with_path(lambda p, x: jnp.zeros_like(x) if p[-1].key == "lora_b" else x, params)
        _jax_generate(JaxInferenceArgs(**_inference_config(prompts, tmp_path / "bare", paged, model_args=model_args)), jax_wrapper, bare)
        assert (tmp_path / "bare" / "output-prompts.jsonl").read_text() != want


def test_seq2seq_lora_checkpoint_generates_the_jax_tokens(tmp_path, tokenizers):
    tokenizer = tokenizers[SEQ2SEQ["vocab_size"]]
    prompts = _seq2seq_prompts(tmp_path / "prompts")
    jax_wrapper, params = _jax_peft(SEQ2SEQ, "AutoModelForSeq2SeqLM", LORA, tokenizer)
    model_args = dict(model_class="AutoModelForSeq2SeqLM", pretrained_config=SEQ2SEQ)
    _jax_generate(JaxInferenceArgs(**_seq2seq_inference_config(prompts, tmp_path / "jax", model_args=model_args)), jax_wrapper, params, True)

    checkpoint = _port_checkpoint(tmp_path / "ckpt", SEQ2SEQ, "AutoModelForSeq2SeqLM", LORA, tokenizer, params)
    summary = generate.main(InferenceArgs(**_seq2seq_inference_config(prompts, tmp_path / "port", load_args=dict(load_path=checkpoint))), device="cpu")
    want = (tmp_path / "jax" / "output-prompts.jsonl").read_text()
    assert (tmp_path / "port" / "output-prompts.jsonl").read_text() == want
    assert summary["requests"] == 5 and len({json.loads(line)["generated_text"] for line in want.splitlines()}) > 1


def test_prompt_tuning_generation_fails_in_jax_and_is_refused(tmp_path, tokenizers):
    tokenizer = tokenizers[VOCAB]
    prompts = _write_prompts(tmp_path / "prompts", VOCAB)
    jax_wrapper, params = _jax_peft(CAUSAL, "AutoModelForCausalLM", PROMPT_TUNING, tokenizer)
    model_args = dict(model_class="AutoModelForCausalLM", pretrained_config=CAUSAL)
    with pytest.raises(AttributeError, match="init_kv_caches"):
        _jax_generate(JaxInferenceArgs(**_inference_config(prompts, tmp_path / "jax", True, model_args=model_args)), jax_wrapper, params)

    checkpoint = _port_checkpoint(tmp_path / "ckpt", CAUSAL, "AutoModelForCausalLM", PROMPT_TUNING, tokenizer, params)
    args = InferenceArgs(**_inference_config(prompts, tmp_path / "port", True, load_args=dict(load_path=checkpoint)))
    with pytest.raises(NotImplementedError, match="cannot serve PromptTuningCausalLM"):
        generate.main(args, device="cpu")


def test_generation_from_a_model_name_and_a_draft_by_name(tmp_path, tokenizers):
    """A directory JAX's `save_pretrained` wrote (config, safetensors, tokenizer): both
    packages' `generate.main` from it without ``load_args`` write the same jsonl; the port's
    with a 1-layer ``draft_model`` directory writes it too, having drafted."""
    tokenizer = tokenizers[VOCAB]
    prompts = _write_prompts(tmp_path / "prompts", VOCAB, rows=4)
    for name, config, seed in (("target", CAUSAL, 0), ("draft", dict(CAUSAL, n_layer=1), 1)):
        wrapper = JaxWrapper(mode=JaxMode.inference, pretrained_config=config, tokenizer_name=tokenizer)
        params = nn.unbox(wrapper.model.init(jax.random.PRNGKey(seed), **wrapper.get_dummy_inputs())["params"])
        wrapper.save_pretrained(str(tmp_path / name), params=params)
    model_args = dict(model_class="AutoModelForCausalLM", model_name=str(tmp_path / "target"))

    JaxMeshManager.destroy()
    try:
        jax_generate.main(JaxInferenceArgs(**_inference_config(prompts, tmp_path / "jax", True, model_args=model_args)))
    finally:
        JaxMeshManager.destroy()
    want = (tmp_path / "jax" / "output-prompts.jsonl").read_text()
    summary = generate.main(InferenceArgs(**_inference_config(prompts, tmp_path / "port", True, model_args=model_args)), device="cpu")
    assert (tmp_path / "port" / "output-prompts.jsonl").read_text() == want
    assert set(summary["load_seconds"]) == {"read", "copy"}

    config = _inference_config(prompts, tmp_path / "drafted", True, model_args=model_args)
    config["generation_parameters"].update(draft_model=str(tmp_path / "draft"), draft_k=3)
    summary = generate.main(InferenceArgs(**config), device="cpu")
    assert (tmp_path / "drafted" / "output-prompts.jsonl").read_text() == want
    assert summary["stats"].draft_tokens_proposed > 0
