"""The port's `save_pretrained`, `load_pretrained_params` and `unshard.main` against the
JAX package's, on the CPU.

- For the dense (learned positions, biases, layernorm, an untied head), MoE (expert banks
  with biases) and encoder-decoder (T5's relative bias, an untied head) families, JAX's
  `ModelWrapper.save_pretrained(params)` and the port's `save_pretrained` of the same
  weights (carried across by `load_jax_params`) write equal ``config.json`` dicts and
  bit-identical tensors; the port reads its directory back to the same weights.
- `unshard.main` on ``configs/pretraining-examples/unshard.yml`` as written (its relative
  paths, its iteration, its ``mixed_precision_args.dtype: bf16``) over a checkpoint of the
  same weights in each package: the same directory as JAX's unshard writes, bit for bit and
  dtype for dtype (fp32: the checkpoint's, not the YAML's bf16).
- A PEFT model or checkpoint has no HF layout: JAX's `save_pretrained` fails on its tree,
  and the port's `save_pretrained` and `unshard.main` raise.
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
from dolomite_engine_tpu import checkpointing as jax_checkpointing
from dolomite_engine_tpu import unshard as jax_unshard
from dolomite_engine_tpu.arguments import TrainingArgs as JaxTrainingArgs
from dolomite_engine_tpu.arguments import TuningArgs as JaxTuningArgs
from dolomite_engine_tpu.arguments import UnshardingArgs as JaxUnshardingArgs
from dolomite_engine_tpu.enums import Mode as JaxMode
from dolomite_engine_tpu.model_wrapper import ModelWrapperForFinetuning as JaxWrapper
from dolomite_engine_tpu.model_wrapper import get_model as jax_get_model
from dolomite_engine_tpu.model_wrapper.peft import ModelWrapperForPEFT as JaxPEFT
from dolomite_engine_tpu.parallel.mesh import MeshManager as JaxMeshManager
from dolomite_engine_tpu.train_utils import TrainState as JaxTrainState
from dolomite_engine_tpu_torch import checkpointing, unshard
from dolomite_engine_tpu_torch.arguments import TrainingArgs, UnshardingArgs, get_args
from dolomite_engine_tpu_torch.enums import Mode
from dolomite_engine_tpu_torch.model_wrapper import ModelWrapperForFinetuning, get_model
from dolomite_engine_tpu_torch.models import load_jax_params
from dolomite_engine_tpu_torch.train_utils import TrainState
from dolomite_engine_tpu_torch.utils import load_yaml
from dolomite_engine_tpu_torch.utils.safetensors import SafeTensorsWeightsManager
from tests.test_torch_enc_dec import T5_MHA
from tests.test_torch_hf_interop import assert_same_tensors
from tests.test_torch_model import LEARNED_LAYERNORM
from tests.test_torch_moe_model import MOE

UNSHARD_YAML = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs", "pretraining-examples", "unshard.yml")
SEQ2SEQ = "AutoModelForSeq2SeqLM"
FAMILIES = {
    "dense": (LEARNED_LAYERNORM, "AutoModelForCausalLM"),
    "moe": (dict(MOE, add_bias=True), "AutoModelForCausalLM"),
    "enc_dec": (T5_MHA, SEQ2SEQ),
}
LORA = dict(tuning_method="lora", lora_args=dict(lora_rank=4, lora_alpha=8.0, lora_dropout=0.0))


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_params(wrapper, seed=0):
    return nn.unbox(wrapper.model.init(jax.random.PRNGKey(seed), **wrapper.get_dummy_inputs())["params"])


@pytest.mark.parametrize("family", list(FAMILIES))
def test_save_pretrained_writes_the_jax_directory(tmp_path, family):
    config, model_class = FAMILIES[family]
    jax_wrapper = JaxWrapper(mode=JaxMode.inference, pretrained_config=config, model_class=model_class)
    params = _jax_params(jax_wrapper)
    jax_wrapper.save_pretrained(str(tmp_path / "jax"), params=params)

    port = ModelWrapperForFinetuning(config, mode=Mode.inference, dtype="fp32", device="cpu", model_class=model_class)
    load_jax_params(port.model, jax.tree.map(np.asarray, params), device="cpu")
    port.save_pretrained(str(tmp_path / "port"))
    with open(tmp_path / "port" / "config.json") as f, open(tmp_path / "jax" / "config.json") as g:
        assert json.load(f) == json.load(g)
    assert_same_tensors(tmp_path / "port", tmp_path / "jax")

    # and back: the directory fills a model built on the meta device with the same weights
    back = ModelWrapperForFinetuning(None, mode=Mode.inference, dtype="fp32", model_name=str(tmp_path / "jax"), device="meta", model_class=model_class)
    seconds = {}
    back.load_pretrained_params(str(tmp_path / "jax"), "cpu", seconds)
    assert set(seconds) == {"read", "copy"}
    want = port.model.state_dict()
    assert sorted(back.model.state_dict()) == sorted(want)
    for name, tensor in back.model.state_dict().items():
        assert torch.equal(tensor, want[name]), name


def _training_config(save_path, tokenizer, tuning=None):
    return dict(
        model_args=dict(model_class="AutoModelForCausalLM", pretrained_config=dict(LEARNED_LAYERNORM, vocab_size=128, eos_token_id=0, pad_token_id=0, bos_token_id=0)),
        tuning_args=tuning or dict(tuning_method="full_finetuning"),
        tokenizer_args=dict(tokenizer_name=tokenizer),
        datasets=[dict(class_name="DebugDataset", data_name="debug", class_args=dict(num_examples=4))],
        save_args=dict(save_path=save_path, save_interval=1, save_optimizer=False),
        mixed_precision_args=dict(dtype="bf16"),
    )


def test_unshard_writes_what_the_jax_unshard_writes(tmp_path, monkeypatch, eight_devices):
    """The YAML's checkpoint (``checkpoints``, iteration 100000, relative to the working
    directory) written by each package from the same fp32 weights, then each package's
    unshard of it: the same directory, bit for bit, in the checkpoint's fp32."""
    tokenizer = chip_smoke.word_tokenizer(str(tmp_path / "tokenizer"), 128, 0)
    unshard_config = load_yaml(UNSHARD_YAML)
    iteration = unshard_config["load_args"]["iteration"]
    assert unshard_config["mixed_precision_args"]["dtype"] == "bf16"
    for side in ("jax", "port"):
        (tmp_path / side).mkdir()

    monkeypatch.chdir(tmp_path / "jax")
    jax_args = JaxTrainingArgs(**_training_config("checkpoints", tokenizer))
    JaxMeshManager.destroy()
    try:
        jax_wrapper = jax_get_model(jax_args, JaxMode.training)
        params = _jax_params(jax_wrapper)
        state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=())
        jax_checkpointing.save_checkpoint(jax_args, jax_wrapper, state, None, None, iteration)
        jax_checkpointing.finish_pending_checkpoint()
        jax_unshard.main(JaxUnshardingArgs(**unshard_config))
    finally:
        JaxMeshManager.destroy()

    monkeypatch.chdir(tmp_path / "port")
    args = TrainingArgs(**_training_config("checkpoints", tokenizer))
    wrapper = get_model(args, Mode.training, device="cpu")
    load_jax_params(wrapper.model, jax.tree.map(np.asarray, params), device="cpu")
    checkpointing.save_checkpoint(args, wrapper, TrainState(wrapper.model, None), None, None, iteration)
    summary = unshard.main(get_args(Mode.unsharding, UNSHARD_YAML), device="cpu")
    assert set(summary["seconds"]) == {"load", "save"} and set(summary["load_seconds"]) == {"build", "read", "cast"}

    got, want = tmp_path / "port" / "checkpoints" / "unsharded-hf", tmp_path / "jax" / "checkpoints" / "unsharded-hf"
    with open(got / "config.json") as f, open(want / "config.json") as g:
        assert json.load(f) == json.load(g)
    assert_same_tensors(got, want)
    written = SafeTensorsWeightsManager(str(got))
    assert {written.get_tensor(name).dtype for name in written} == {torch.float32}
    assert (got / "tokenizer.json").is_file()


def test_a_peft_model_has_no_hf_layout_in_either_package(tmp_path):
    jax_wrapper = JaxPEFT(mode=JaxMode.inference, pretrained_config=LEARNED_LAYERNORM, tuning_args=JaxTuningArgs(**LORA))
    params = _jax_params(jax_wrapper)
    assert "base_model" in params
    with pytest.raises(KeyError):
        jax_wrapper.save_pretrained(str(tmp_path / "jax"), params=params)

    tokenizer = chip_smoke.word_tokenizer(str(tmp_path / "tokenizer"), 128, 0)
    args = TrainingArgs(**_training_config(str(tmp_path / "ckpt"), tokenizer, LORA))
    wrapper = get_model(args, Mode.training, device="cpu")
    with pytest.raises(ValueError, match="PEFT model"):
        wrapper.save_pretrained(str(tmp_path / "port"))
    checkpointing.save_checkpoint(args, wrapper, TrainState(wrapper.model, None), None, None, 1)
    unshard_args = UnshardingArgs(**dict(load_yaml(UNSHARD_YAML), load_args=dict(load_path=str(tmp_path / "ckpt")), unsharded_path=str(tmp_path / "out")))
    with pytest.raises(ValueError, match="PEFT model"):
        unshard.main(unshard_args, device="cpu")
    assert not (tmp_path / "out").exists()
