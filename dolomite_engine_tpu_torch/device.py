"""Device selection shared by the port's entry points."""

from __future__ import annotations

import os

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The torch device an entry point runs on. The default is the GPU; without one a
    clear error is raised instead of silently running on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "dolomite_engine_tpu_torch runs on an NVIDIA GPU by default and no CUDA "
                "device is available; pass device='cpu' to run the plain PyTorch versions"
            )
        if device.index is None:  # under torchrun, this process's card
            local_rank = os.environ.get("LOCAL_RANK")
            device = torch.device("cuda", int(local_rank) if local_rank is not None else torch.cuda.current_device())
    return device
