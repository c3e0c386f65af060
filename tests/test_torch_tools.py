"""The port's CLI tools (`tools/*_torch.py`) against the JAX package's, one CPU run each.

- `inference_torch.py` prints what `tools/inference.py` prints for the same prompts from
  the same HF-layout directory (greedy, fp32);
- `export_to_hf_torch.py` writes JAX's llama export, and with ``--import`` JAX's import;
- `pt_to_safetensors_torch.py` writes what `tools/pt_to_safetensors.py` writes;
- `params_calculator_torch.py` counts JAX's `ModelWrapper.num_parameters()`.
"""

import importlib.util
import json
import os
import sys

import jax
import pytest
import torch
from flax import linen as nn

import chip_smoke
from dolomite_engine_tpu.enums import Mode as JaxMode
from dolomite_engine_tpu.hf_interop import export_to_huggingface as jax_export
from dolomite_engine_tpu.hf_interop import import_from_huggingface as jax_import
from dolomite_engine_tpu.model_wrapper import ModelWrapper as JaxModelWrapper
from dolomite_engine_tpu.model_wrapper import ModelWrapperForFinetuning as JaxWrapper
from dolomite_engine_tpu.parallel.mesh import MeshManager as JaxMeshManager
from tests.test_torch_hf_interop import _llama, assert_same_tensors
from tests.test_torch_model import ROPE_GQA

TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools")


def _tool(name):
    spec = importlib.util.spec_from_file_location(f"tool_{name}", os.path.join(TOOLS, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_inference_prints_what_the_jax_tool_prints(tmp_path, monkeypatch, capsys):
    tokenizer = chip_smoke.word_tokenizer(str(tmp_path / "tokenizer"), 96, 0)
    config = dict(ROPE_GQA, initializer_range=0.3, eos_token_id=0, pad_token_id=0, bos_token_id=0)
    wrapper = JaxWrapper(mode=JaxMode.inference, pretrained_config=config, tokenizer_name=tokenizer)
    params = nn.unbox(wrapper.model.init(jax.random.PRNGKey(0), **wrapper.get_dummy_inputs())["params"])
    wrapper.save_pretrained(str(tmp_path / "model"), params=params)
    flags = ["--model", str(tmp_path / "model"), "--prompt", "t5 t17 t33 t8", "--prompt", "t41 t2 t90", "--max-new-tokens", "6", "--bucket-multiple", "8"]

    JaxMeshManager.destroy()
    monkeypatch.setattr(sys, "argv", ["inference.py", *flags])
    try:
        _tool("inference").main()
    finally:
        JaxMeshManager.destroy()
    want = capsys.readouterr().out
    continuations = _tool("inference_torch").main([*flags, "--device", "cpu", "--dtype", "fp32"])
    assert capsys.readouterr().out == want
    assert len(continuations) == 2 and all(continuations)


def test_export_and_import_write_the_jax_directories(tmp_path, capsys):
    _llama(tmp_path / "hf", num_kv_heads=2)
    tool = _tool("export_to_hf_torch")
    tool.main([str(tmp_path / "hf"), str(tmp_path / "port-dolomite"), "--import"])
    jax_import(str(tmp_path / "hf"), str(tmp_path / "jax-dolomite"))
    assert_same_tensors(tmp_path / "port-dolomite", tmp_path / "jax-dolomite")
    tool.main([str(tmp_path / "jax-dolomite"), str(tmp_path / "port-llama")])
    jax_export(str(tmp_path / "jax-dolomite"), str(tmp_path / "jax-llama"), model_type="llama")
    assert_same_tensors(tmp_path / "port-llama", tmp_path / "jax-llama")
    with open(tmp_path / "port-llama" / "config.json") as f, open(tmp_path / "jax-llama" / "config.json") as g:
        assert json.load(f) == json.load(g)
    assert "wrote" in capsys.readouterr().out


def test_pt_to_safetensors_writes_the_jax_files(tmp_path):
    generator = torch.Generator().manual_seed(0)
    src = tmp_path / "bin"
    src.mkdir()
    torch.save({"a.weight": torch.randn(8, 4, generator=generator), "b.weight": torch.randn(4, generator=generator).bfloat16()}, src / "pytorch_model.bin")
    (src / "tokenizer_config.json").write_text("{}")
    assert _tool("pt_to_safetensors_torch").convert(str(src), str(tmp_path / "port")) == 2
    _tool("pt_to_safetensors").convert(str(src), str(tmp_path / "jax"))
    assert_same_tensors(tmp_path / "port", tmp_path / "jax")
    assert (tmp_path / "port" / "tokenizer_config.json").is_file()


def test_params_calculator_counts_the_jax_parameters(tmp_path, capsys):
    config = dict(
        model_type="moe_dolomite", vocab_size=512, n_positions=256, n_embd=64, n_layer=3, n_head=4, num_key_value_heads=2,
        attention_head_type="gqa", n_inner=96, position_embedding_type="rope", activation_function="swiglu",
        normalization_function="rmsnorm", add_bias=True, num_experts=4, num_experts_per_tok=2, tie_word_embeddings=False,
    )
    (tmp_path / "config.json").write_text(json.dumps(config))
    total = _tool("params_calculator_torch").main(["--config", str(tmp_path / "config.json")])
    want = JaxModelWrapper(mode=JaxMode.inference, pretrained_config=config).num_parameters()
    assert total == want > 0
    assert capsys.readouterr().out.strip() == f"total {want:,}"
