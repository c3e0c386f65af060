"""Lazy multi-file safetensors reader and writer over torch tensors.

Counterpart of `dolomite_engine_tpu/utils/safetensors.py`: the same reader over one
``model.safetensors``, a sharded set with its ``model.safetensors.index.json``, or any
``*.safetensors`` files of a directory; the same shard sizes, file names and index on
save; and `torch_bin_to_safetensors` for a torch-pickle checkpoint. Tensors are torch
tensors (``safetensors.torch``), so bf16 needs no ``ml_dtypes``. The ``safetensors``
package is imported where it is used: a machine without it raises there.
"""

from __future__ import annotations

import json
import os
import shutil

import torch

from .hf_hub import TOKENIZER_FILES

_INDEX_NAME = "model.safetensors.index.json"
_SINGLE_NAME = "model.safetensors"


def _safe_open(path: str):
    from safetensors import safe_open

    return safe_open(path, framework="pt")


class SafeTensorsWeightsManager:
    def __init__(self, model_path: str) -> None:
        self.model_path = model_path
        self.tensor_filenames: dict[str, str] = {}

        index_path = os.path.join(model_path, _INDEX_NAME)
        if os.path.isfile(index_path):
            with open(index_path) as f:
                self.tensor_filenames = dict(json.load(f)["weight_map"])
        else:
            single = os.path.isfile(os.path.join(model_path, _SINGLE_NAME))
            names = [_SINGLE_NAME] if single else sorted(n for n in os.listdir(model_path) if n.endswith(".safetensors"))
            for fname in names:
                with _safe_open(os.path.join(model_path, fname)) as f:
                    for name in f.keys():
                        self.tensor_filenames[name] = fname

        self._file_handles: dict[str, object] = {}

    def _handle(self, tensor_name: str):
        fname = self.tensor_filenames[tensor_name]
        if fname not in self._file_handles:
            self._file_handles[fname] = _safe_open(os.path.join(self.model_path, fname))
        return self._file_handles[fname]

    def get_tensor(self, tensor_name: str) -> torch.Tensor:
        return self._handle(tensor_name).get_tensor(tensor_name)

    def get_slice(self, tensor_name: str):
        return self._handle(tensor_name).get_slice(tensor_name)

    def get_shape(self, tensor_name: str) -> tuple[int, ...]:
        return tuple(self.get_slice(tensor_name).get_shape())

    def has_tensor(self, tensor_name: str) -> bool:
        return tensor_name in self.tensor_filenames

    def state_dict(self) -> dict[str, torch.Tensor]:
        return {name: self.get_tensor(name) for name in self.tensor_filenames}

    def __len__(self) -> int:
        return len(self.tensor_filenames)

    def __iter__(self):
        return iter(self.tensor_filenames)

    def __eq__(self, other) -> bool:
        """The same names, and each tensor the same dtype, shape and bytes."""
        if not isinstance(other, SafeTensorsWeightsManager):
            return NotImplemented
        if set(self.tensor_filenames) != set(other.tensor_filenames):
            return False
        return all(_same(self.get_tensor(n), other.get_tensor(n)) for n in self.tensor_filenames)

    @staticmethod
    def save_state_dict(state_dict: dict[str, torch.Tensor], save_path: str, max_shard_bytes: int = 5 * 2**30) -> None:
        """Shard by size and write ``model.safetensors`` (or numbered shards and the index
        json), each tensor in its dtype and at least 1-D (a scalar is written as ``[1]``, as
        the JAX package's `np.ascontiguousarray` writes it). One shard at a time is copied to
        the host, so a model on a card never needs its whole size in host memory."""
        from safetensors.torch import save_file

        os.makedirs(save_path, exist_ok=True)
        shards: list[list[str]] = [[]]
        shard_sizes = [0]
        for name, tensor in state_dict.items():
            nbytes = tensor.numel() * tensor.element_size()
            if shard_sizes[-1] > 0 and shard_sizes[-1] + nbytes > max_shard_bytes:
                shards.append([])
                shard_sizes.append(0)
            shards[-1].append(name)
            shard_sizes[-1] += nbytes

        names = [_SINGLE_NAME] if len(shards) == 1 else [f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors" for i in range(len(shards))]
        for fname, shard in zip(names, shards):
            host, storages = {}, set()  # `save_file` refuses tensors that share memory (tied weights): copy
            for name in shard:
                tensor = state_dict[name].detach().to("cpu").contiguous().reshape(state_dict[name].shape or (1,))
                storage = tensor.untyped_storage().data_ptr()
                host[name] = tensor.clone() if storage in storages else tensor
                storages.add(storage)
            save_file(host, os.path.join(save_path, fname))
            del host
        if len(shards) == 1:
            return
        index = {
            "metadata": {"total_size": int(sum(shard_sizes))},
            "weight_map": {name: fname for fname, shard in zip(names, shards) for name in shard},
        }
        with open(os.path.join(save_path, _INDEX_NAME), "w") as f:
            json.dump(index, f, indent=2)


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(_bytes(a), _bytes(b))


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)


def torch_bin_to_safetensors(checkpoint_dir: str, dest_dir: str) -> int:
    """Convert a torch-pickle HF checkpoint (``pytorch_model*.bin``, with or without its
    index) to safetensors in `dest_dir`, each tensor in its own dtype, and copy the
    tokenizer and config files beside it. Returns the tensor count."""
    index_path = os.path.join(checkpoint_dir, "pytorch_model.bin.index.json")
    if os.path.isfile(index_path):
        with open(index_path) as f:
            files = sorted(set(json.load(f)["weight_map"].values()))
    else:
        files = sorted(f for f in os.listdir(checkpoint_dir) if f.startswith("pytorch_model") and f.endswith(".bin"))
    if not files:
        raise FileNotFoundError(f"no pytorch_model*.bin found in {checkpoint_dir}")

    state_dict: dict = {}
    for fname in files:
        state_dict.update(torch.load(os.path.join(checkpoint_dir, fname), map_location="cpu", weights_only=True))
    SafeTensorsWeightsManager.save_state_dict(state_dict, dest_dir)
    for fname in TOKENIZER_FILES:
        src = os.path.join(checkpoint_dir, fname)
        if os.path.isfile(src):
            shutil.copy2(src, os.path.join(dest_dir, fname))
    return len(state_dict)
