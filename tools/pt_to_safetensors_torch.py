"""Convert a torch-pickle HF checkpoint (``pytorch_model*.bin``) to safetensors with the
PyTorch port (`utils.safetensors.torch_bin_to_safetensors`: each tensor in its own dtype,
the tokenizer and config files copied beside it); the counterpart of
`tools/pt_to_safetensors.py`, with no JAX.

Usage: python tools/pt_to_safetensors_torch.py <checkpoint_dir> <safetensors_dest_dir>
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from dolomite_engine_tpu_torch.utils.safetensors import torch_bin_to_safetensors  # noqa: E402


def convert(checkpoint_dir: str, dest_dir: str) -> int:
    n = torch_bin_to_safetensors(checkpoint_dir, dest_dir)
    print(f"wrote {n} tensors -> {dest_dir}")
    return n


if __name__ == "__main__":
    if len(sys.argv) != 3:
        print(__doc__)
        sys.exit(2)
    convert(sys.argv[1], sys.argv[2])
