"""Unshard entry point: a training checkpoint -> an HF-layout safetensors directory.

Counterpart of `dolomite_engine_tpu/unshard.py`: `load_checkpoint_for_inference(args,
Mode.unsharding)` rebuilds the checkpoint's model with each weight in the dtype the
checkpoint holds (not cast to ``mixed_precision_args.dtype``, which the JAX unshard does not
apply to the written weights either), then rank 0's `ModelWrapper.save_pretrained` writes
``config.json``, the safetensors and the tokenizer into ``unsharded_path``. A PEFT
checkpoint raises there: its weights have no HF layout, and the JAX package fails on it too.

    python -m dolomite_engine_tpu_torch.unshard --config configs/pretraining-examples/unshard.yml
"""

from __future__ import annotations

import time

import torch

from .arguments import UnshardingArgs, get_args
from .checkpointing import load_checkpoint_for_inference
from .device import resolve_device
from .enums import Mode
from .utils import process_index


def main(args: UnshardingArgs | None = None, device: str | torch.device = "cuda") -> dict:
    """Unshard onto `device` (the GPU unless ``"cpu"`` is passed) and write the directory;
    returns the seconds of the load (its parts under ``load_seconds``) and of the save."""
    device = resolve_device(device)
    if args is None:
        args = get_args(Mode.unsharding)
    load_seconds = {}
    t0 = time.perf_counter()
    model, _ = load_checkpoint_for_inference(args, Mode.unsharding, device, load_seconds)
    t1 = time.perf_counter()
    if process_index() == 0:
        model.save_pretrained(args.unsharded_path)
    return {"seconds": {"load": t1 - t0, "save": time.perf_counter() - t1}, "load_seconds": load_seconds}


if __name__ == "__main__":
    main()
