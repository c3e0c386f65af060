"""The port's HF interop against the JAX package's, on the CPU.

For each model type the JAX package converts (llama MHA / GQA / MQA and with biases and a
tied head, granite with its µP multipliers, mixtral, granitemoe, gpt_bigcode, t5 v1.0 and
v1.1), from one HF directory built with seeded weights (`transformers`, as
`tests/hf_interop/` builds them; granitemoe's tensors synthesized, as there):
- the port's `import_from_huggingface` writes the same ``config.json`` dict as JAX's and
  bit-identical tensors (name, dtype, bytes);
- `export_to_huggingface` of each package's import does the same;
- the port's model filled from its directory (`ModelWrapper.load_pretrained_params`) gives
  fp32 logits within atol = rtol = 1e-5 of the JAX model filled from JAX's directory.
Also `interleave_qkv` / `split_qkv` per head type against JAX's, the ``.bin``-only staging
path, and the refusal of a hub id.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dolomite_engine_tpu.hf_interop import export_to_huggingface as jax_export
from dolomite_engine_tpu.hf_interop import import_from_huggingface as jax_import
from dolomite_engine_tpu.hf_interop import interleave_qkv as jax_interleave_qkv
from dolomite_engine_tpu.hf_interop import split_qkv as jax_split_qkv
from dolomite_engine_tpu.hf_interop import state_dict_to_params as jax_state_dict_to_params
from dolomite_engine_tpu.models import config_from_dict as jax_config_from_dict
from dolomite_engine_tpu.models import get_model_class as jax_get_model_class
from dolomite_engine_tpu.utils.safetensors import SafeTensorsWeightsManager as JaxManager
from dolomite_engine_tpu_torch.enums import Mode
from dolomite_engine_tpu_torch.hf_interop import export_to_huggingface, import_from_huggingface, interleave_qkv, split_qkv
from dolomite_engine_tpu_torch.model_wrapper import ModelWrapperForFinetuning
from dolomite_engine_tpu_torch.models import CommonConfig
from dolomite_engine_tpu_torch.utils.safetensors import SafeTensorsWeightsManager
from tests.hf_interop.test_t5_conversion import _batch, _tiny_t5

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _llama(path, num_kv_heads=4, bias=False, tied=False):
    from transformers import LlamaConfig, LlamaForCausalLM

    torch.manual_seed(0)
    config = LlamaConfig(
        vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=num_kv_heads, max_position_embeddings=128, rms_norm_eps=1e-6, attention_bias=bias,
        mlp_bias=bias, tie_word_embeddings=tied, bos_token_id=0, eos_token_id=1, pad_token_id=2,
    )
    LlamaForCausalLM(config).save_pretrained(path, safe_serialization=True)


def _granite(path):
    _llama(path, num_kv_heads=2)
    with open(os.path.join(path, "config.json")) as f:
        config = json.load(f)
    config.update(model_type="granite", embedding_multiplier=12.0, residual_multiplier=0.22, logits_scaling=8.0, attention_multiplier=0.015625)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f)


def _mixtral(path):
    from transformers import MixtralConfig, MixtralForCausalLM

    torch.manual_seed(0)
    config = MixtralConfig(
        vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, num_local_experts=4, num_experts_per_tok=2, max_position_embeddings=128,
        rms_norm_eps=1e-6, tie_word_embeddings=False, bos_token_id=0, eos_token_id=1, pad_token_id=2,
    )
    MixtralForCausalLM(config).save_pretrained(path, safe_serialization=True)


def _granitemoe(path):
    """granitemoe's layout synthesized from a seed: the fused input_linear [E, [gate; up], H]."""
    rs = np.random.RandomState(3)
    experts, hidden, inner, layers = 4, 32, 48, 2
    sd = {
        "model.embed_tokens.weight": rs.randn(64, hidden), "model.norm.weight": rs.randn(hidden),
        "lm_head.weight": rs.randn(64, hidden),
    }
    for i in range(layers):
        p = f"model.layers.{i}."
        sd[p + "input_layernorm.weight"] = rs.randn(hidden)
        sd[p + "post_attention_layernorm.weight"] = rs.randn(hidden)
        sd[p + "block_sparse_moe.router.layer.weight"] = rs.randn(experts, hidden)
        sd[p + "block_sparse_moe.input_linear.weight"] = rs.randn(experts, 2 * inner, hidden) * 0.2
        sd[p + "block_sparse_moe.output_linear.weight"] = rs.randn(experts, hidden, inner) * 0.2
        sd[p + "self_attn.q_proj.weight"] = rs.randn(hidden, hidden) * 0.2
        sd[p + "self_attn.k_proj.weight"] = rs.randn(hidden // 2, hidden) * 0.2
        sd[p + "self_attn.v_proj.weight"] = rs.randn(hidden // 2, hidden) * 0.2
        sd[p + "self_attn.o_proj.weight"] = rs.randn(hidden, hidden) * 0.2
    SafeTensorsWeightsManager.save_state_dict({k: torch.from_numpy(v.astype(np.float32)) for k, v in sd.items()}, path)
    config = dict(
        model_type="granitemoe", vocab_size=64, hidden_size=hidden, intermediate_size=inner, num_hidden_layers=layers,
        num_attention_heads=4, num_key_value_heads=2, num_local_experts=experts, num_experts_per_tok=2,
        embedding_multiplier=2.0, residual_multiplier=0.5, logits_scaling=1.0, attention_multiplier=0.5,
        rms_norm_eps=1e-6, tie_word_embeddings=False, bos_token_id=0, eos_token_id=1, pad_token_id=2,
    )
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f)


def _bigcode(path):
    from transformers import GPTBigCodeConfig, GPTBigCodeForCausalLM

    torch.manual_seed(0)
    config = GPTBigCodeConfig(
        vocab_size=128, n_positions=64, n_embd=32, n_layer=2, n_head=4, n_inner=64, multi_query=True,
        attn_pdrop=0.0, resid_pdrop=0.0, embd_pdrop=0.0, bos_token_id=0, eos_token_id=1, pad_token_id=2,
    )
    GPTBigCodeForCausalLM(config).save_pretrained(path, safe_serialization=True)


def _t5(v1_1):
    def build(path):
        model, hf = _tiny_t5(path.parent / "t5-build", v1_1=v1_1)
        os.rename(hf, path)

    return build


# name -> (the function that writes its HF directory, the HF type to export to)
FAMILIES = {
    "llama_mha": (_llama, "llama"),
    "llama_gqa": (lambda p: _llama(p, num_kv_heads=2), "llama"),
    "llama_mqa": (lambda p: _llama(p, num_kv_heads=1), "llama"),
    "llama_gqa_bias_tied": (lambda p: _llama(p, num_kv_heads=2, bias=True, tied=True), "llama"),
    "granite": (_granite, "granite"),
    "mixtral": (_mixtral, "mixtral"),
    "granitemoe": (_granitemoe, "granitemoe"),
    "gpt_bigcode": (_bigcode, "gpt_bigcode"),
    "t5_v1_0": (_t5(False), "t5"),
    "t5_v1_1": (_t5(True), "t5"),
}


def _config(path):
    with open(os.path.join(path, "config.json")) as f:
        return json.load(f)


def assert_same_tensors(got_path, want_path):
    """The same tensor names, and each the same dtype, shape and bytes (the header metadata
    of `safetensors.torch` and `safetensors.numpy` differ, so the files are not compared)."""
    got, want = SafeTensorsWeightsManager(got_path), SafeTensorsWeightsManager(want_path)
    assert sorted(got) == sorted(want)
    for name in want:
        a, b = got.get_tensor(name), want.get_tensor(name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)), name


def _port_logits(path, ids, mask=None, labels=None):
    wrapper = ModelWrapperForFinetuning(None, mode=Mode.inference, model_name=path, dtype="fp32", device="meta")
    wrapper.load_pretrained_params(path, "cpu")
    with torch.no_grad():
        if wrapper.is_encoder_decoder:
            out = wrapper.model(torch.tensor(ids), attention_mask=torch.tensor(mask), labels=torch.tensor(labels))
        else:
            out = wrapper.model(torch.tensor(ids))
    return out.logits.float().numpy()


def _jax_logits(path, ids, mask=None, labels=None):
    config = jax_config_from_dict(_config(path))
    cls = jax_get_model_class(config.model_type)
    model = cls(config=config, moe_implementation="eager") if config.model_type == "moe_dolomite" else cls(config=config)
    params = jax_state_dict_to_params(config, JaxManager(path))
    if config.model_type == "enc_dec_dolomite":
        out = model.apply({"params": params}, jnp.asarray(ids, jnp.int32), attention_mask=jnp.asarray(mask, jnp.int32), labels=jnp.asarray(labels, jnp.int32))
    else:
        out = model.apply({"params": params}, jnp.asarray(ids, jnp.int32))
    return np.asarray(out.logits, np.float32)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_import_export_and_logits_match_jax(tmp_path, family):
    build, hf_type = FAMILIES[family]
    hf = tmp_path / "hf"
    build(hf)
    for name, convert in (("jax", jax_import), ("port", import_from_huggingface)):
        convert(str(hf), str(tmp_path / f"{name}-dolomite"))
    assert _config(tmp_path / "port-dolomite") == _config(tmp_path / "jax-dolomite")
    assert_same_tensors(tmp_path / "port-dolomite", tmp_path / "jax-dolomite")

    for name, convert in (("jax", jax_export), ("port", export_to_huggingface)):
        convert(str(tmp_path / f"{name}-dolomite"), str(tmp_path / f"{name}-export"), model_type=hf_type)
    assert _config(tmp_path / "port-export") == _config(tmp_path / "jax-export")
    assert_same_tensors(tmp_path / "port-export", tmp_path / "jax-export")

    if hf_type == "t5":
        ids, mask, labels = _batch(np.random.RandomState(0))
        vocab = _config(hf)["vocab_size"]
    else:
        vocab = _config(tmp_path / "port-dolomite")["vocab_size"]
        ids, mask, labels = np.random.RandomState(0).randint(0, vocab, (2, 10)), None, None
    got = _port_logits(str(tmp_path / "port-dolomite"), ids, mask, labels)
    want = _jax_logits(str(tmp_path / "jax-dolomite"), ids, mask, labels)
    assert got.shape[-1] == vocab
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("heads", [(4, 4), (4, 2), (4, 1)], ids=["mha", "gqa", "mqa"])
def test_interleave_and_split_match_jax(heads):
    n_head, n_kv = heads
    head_type = {4: "mha", 2: "gqa", 1: "mqa"}[n_kv]
    config = CommonConfig(n_embd=32, n_head=n_head, num_key_value_heads=n_kv, attention_head_type=head_type)
    rs = np.random.RandomState(0)
    q, k, v = rs.randn(32, 8), rs.randn(8 * n_kv, 8), rs.randn(8 * n_kv, 8)
    want = jax_interleave_qkv(q, k, v, config)
    got = interleave_qkv(*(torch.from_numpy(a) for a in (q, k, v)), config)
    np.testing.assert_array_equal(got.numpy(), want)
    for a, b in zip(split_qkv(got, config), jax_split_qkv(want, config)):
        np.testing.assert_array_equal(a.numpy(), b)
    for a, b in zip(split_qkv(got, config), (q, k, v)):
        np.testing.assert_array_equal(a.numpy(), b)


def test_bin_only_directory_imports_as_jax_does(tmp_path):
    """A directory with only ``pytorch_model.bin`` goes through the staging conversion in
    both packages: the same files, and no staging directory left behind."""
    from transformers import LlamaConfig, LlamaForCausalLM

    torch.manual_seed(0)
    config = LlamaConfig(
        vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, max_position_embeddings=64,
    )
    LlamaForCausalLM(config).save_pretrained(tmp_path / "bin", safe_serialization=False)
    assert not list((tmp_path / "bin").glob("*.safetensors"))
    jax_import(str(tmp_path / "bin"), str(tmp_path / "jax"))
    import_from_huggingface(str(tmp_path / "bin"), str(tmp_path / "port"))
    assert _config(tmp_path / "port") == _config(tmp_path / "jax")
    assert_same_tensors(tmp_path / "port", tmp_path / "jax")


def test_refusals(tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue A, 'Interop and tools'"):
        import_from_huggingface("ibm-granite/granite-3b-code-base", str(tmp_path / "out"))
    (tmp_path / "weightless").mkdir()
    (tmp_path / "weightless" / "config.json").write_text(json.dumps({"model_type": "llama"}))
    with pytest.raises(ValueError, match="no supported weight format"):
        import_from_huggingface(str(tmp_path / "weightless"), str(tmp_path / "out"))
    with pytest.raises(NotImplementedError, match="not yet supported"):
        export_to_huggingface(str(tmp_path / "weightless"), str(tmp_path / "out"), model_type="bloom")
