"""The port's safetensors reader and writer against the JAX package's, on the CPU.

- each package reads the other's files (one file and a sharded set; a scalar is written as
  ``[1]`` by both);
- a sharded save writes the same file names, the same index and the same tensors;
- a bf16 state dict round-trips bit for bit (no ``ml_dtypes`` in the port), and the JAX
  package reads the port's bf16 file to the same bits;
- `torch_bin_to_safetensors` writes what JAX's writes from the same ``.bin`` (fp32, bf16
  and a tied pair sharing memory).
Tensors are compared by name, dtype and bytes, not file bytes: the header metadata of
`safetensors.torch` and `safetensors.numpy` differ.
"""

import json

import numpy as np
import pytest
import torch

from dolomite_engine_tpu.utils.safetensors import SafeTensorsWeightsManager as JaxManager
from dolomite_engine_tpu.utils.safetensors import torch_bin_to_safetensors as jax_bin_to_safetensors
from dolomite_engine_tpu_torch.utils.safetensors import SafeTensorsWeightsManager, torch_bin_to_safetensors


def _state_dict(seed=0):
    rs = np.random.RandomState(seed)
    shapes = {"a.weight": (16, 8), "a.bias": (16,), "b.weight": (4, 6, 8), "c.table": (32, 8), "d.scalar": ()}
    return {name: np.asarray(rs.randn(*shape), np.float32) for name, shape in shapes.items()}


def _bits(t):
    return np.asarray(t).reshape(-1).view(np.uint8)


def _assert_same(got: torch.Tensor, want: np.ndarray):
    """`got` holds `want` as both packages write it: a scalar as ``[1]``."""
    want = np.atleast_1d(want)
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.reshape(-1).view(torch.uint8).numpy(), _bits(want))


@pytest.mark.parametrize("shard_bytes", [5 * 2**30, 600], ids=["one-file", "sharded"])
def test_each_package_reads_the_others_files(tmp_path, shard_bytes):
    sd = _state_dict()
    JaxManager.save_state_dict(sd, str(tmp_path / "jax"), max_shard_bytes=shard_bytes)
    SafeTensorsWeightsManager.save_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, str(tmp_path / "port"), max_shard_bytes=shard_bytes)
    port_reads_jax, jax_reads_port = SafeTensorsWeightsManager(str(tmp_path / "jax")), JaxManager(str(tmp_path / "port"))
    assert sorted(port_reads_jax) == sorted(jax_reads_port) == sorted(sd)
    for name, want in sd.items():
        _assert_same(port_reads_jax.get_tensor(name), want)
        np.testing.assert_array_equal(_bits(jax_reads_port.get_tensor(name)), _bits(want))
        assert port_reads_jax.get_shape(name) == jax_reads_port.get_shape(name) == np.atleast_1d(want).shape
    assert SafeTensorsWeightsManager(str(tmp_path / "jax")) == SafeTensorsWeightsManager(str(tmp_path / "port"))


def test_sharded_save_writes_the_jax_files_and_index(tmp_path):
    sd = _state_dict(1)
    JaxManager.save_state_dict(sd, str(tmp_path / "jax"), max_shard_bytes=600)
    SafeTensorsWeightsManager.save_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, str(tmp_path / "port"), max_shard_bytes=600)
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert len(names) > 2 and names == sorted(p.name for p in (tmp_path / "port").iterdir())
    index = "model.safetensors.index.json"
    assert json.loads((tmp_path / "port" / index).read_text()) == json.loads((tmp_path / "jax" / index).read_text())
    got = SafeTensorsWeightsManager(str(tmp_path / "port"))
    for name, want in sd.items():
        _assert_same(got.get_tensor(name), want)
    # a changed tensor is seen
    sd["a.bias"][0] += 1
    JaxManager.save_state_dict(sd, str(tmp_path / "changed"), max_shard_bytes=600)
    assert SafeTensorsWeightsManager(str(tmp_path / "changed")) != got


def test_bf16_round_trip_is_bit_for_bit(tmp_path):
    import ml_dtypes

    generator = torch.Generator().manual_seed(0)
    sd = {"w": torch.randn(64, 48, generator=generator).bfloat16(), "b": torch.randn(48, generator=generator).bfloat16(), "f": torch.randn(3, 5, generator=generator)}
    SafeTensorsWeightsManager.save_state_dict(sd, str(tmp_path))
    back = SafeTensorsWeightsManager(str(tmp_path))
    for name, want in sd.items():
        got = back.get_tensor(name)
        assert got.dtype == want.dtype and torch.equal(got.view(torch.uint8), want.view(torch.uint8))
    jax_view = JaxManager(str(tmp_path)).get_tensor("w")
    assert jax_view.dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(_bits(jax_view), sd["w"].view(torch.uint16).numpy().reshape(-1).view(np.uint8))


def test_torch_bin_to_safetensors_matches_jax(tmp_path):
    generator = torch.Generator().manual_seed(0)
    table = torch.randn(32, 8, generator=generator)
    sd = {
        "embed.weight": table, "head.weight": table,  # tied: one storage
        "proj.weight": torch.randn(8, 8, generator=generator).bfloat16(), "norm.weight": torch.ones(8),
    }
    src = tmp_path / "bin"
    src.mkdir()
    torch.save(sd, src / "pytorch_model.bin")
    (src / "config.json").write_text(json.dumps({"model_type": "llama"}))
    (src / "tokenizer_config.json").write_text("{}")
    assert torch_bin_to_safetensors(str(src), str(tmp_path / "port")) == jax_bin_to_safetensors(str(src), str(tmp_path / "jax")) == 4
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert SafeTensorsWeightsManager(str(tmp_path / "port")) == SafeTensorsWeightsManager(str(tmp_path / "jax"))
    with pytest.raises(FileNotFoundError, match="no pytorch_model"):
        torch_bin_to_safetensors(str(tmp_path / "port"), str(tmp_path / "again"))
