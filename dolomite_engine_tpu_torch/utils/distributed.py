"""The process group (counterpart of `dolomite_engine_tpu/utils/__init__.init_distributed`).

Under ``torchrun`` (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` /
``MASTER_PORT`` set) `init_distributed` joins the job's group: NCCL for CUDA tensors after
``torch.cuda.set_device(LOCAL_RANK)`` (with gloo beside it for host tensors), gloo on the
CPU. Without that environment it makes a group of one rank over an in-process store, so
a run of one process wraps its model as a run of many does, as the JAX package always
builds a mesh. A group someone else initialized (a test's ``file://`` rendezvous) is
taken as it is.
"""

from __future__ import annotations

import logging
import os
from datetime import timedelta

import torch
import torch.distributed as dist

from .logger import log_rank_0


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def init_distributed(timeout_minutes: int | None = None, device: torch.device | str = "cuda") -> None:
    """Initialize the default process group once (a second call is a no-op). `device` is
    the device the run computes on: its type picks the backend."""
    if dist.is_initialized():
        return
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device if device.index is not None else int(os.environ.get("LOCAL_RANK", 0)))
        backend = "cpu:gloo,cuda:nccl"
    else:
        backend = "gloo"
    kwargs = {"timeout": timedelta(minutes=timeout_minutes)} if timeout_minutes else {}
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(
            backend, rank=int(os.environ["RANK"]), world_size=int(os.environ["WORLD_SIZE"]), **kwargs
        )
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1, **kwargs)
    log_rank_0(logging.INFO, f"initialized torch.distributed: {dist.get_world_size()} rank(s), backend {backend}")


_CHECKPOINT_GROUP: tuple | None = None  # (the default group it was made under, the group)


def checkpoint_group():
    """A gloo group of every rank for the checkpoint writer: an async save's collectives
    run on it, apart from the training step's. Made on first use under the current
    default group, which every rank reaches in the same order (a save)."""
    global _CHECKPOINT_GROUP
    if _CHECKPOINT_GROUP is None or _CHECKPOINT_GROUP[0] is not dist.group.WORLD:
        _CHECKPOINT_GROUP = (dist.group.WORLD, dist.new_group(backend="gloo"))
    return _CHECKPOINT_GROUP[1]


def sum_over_ranks(value: float) -> float:
    """`value` summed over every rank (itself in a world of one)."""
    if world_size() == 1:
        return value
    t = torch.tensor([value], dtype=torch.float64)
    dist.all_reduce(t)
    return float(t[0])


def any_rank(flag: bool) -> bool:
    """True on every rank when `flag` is on any (a preemption notice one rank received)."""
    if world_size() == 1:
        return flag
    t = torch.tensor([int(flag)], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t[0])
