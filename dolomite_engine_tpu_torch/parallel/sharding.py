"""The ZeRO stages as FSDP2 settings, and the local view of a sharded tensor.

Counterpart of `dolomite_engine_tpu/parallel/sharding.py`. The JAX package maps logical
axis names onto mesh axes and lets GSPMD place every tensor; the port has no logical-axis
rules to port: FSDP2 (`torch.distributed.fsdp.fully_shard`) shards each parameter's first
dimension over the mesh's ``fsdp`` axis and replicates it over ``dp`` (HSDP), and the
stage picks the mesh and when a block's parameters are gathered whole:

    stage 0    every rank a replica: the ``(dp * fsdp, 1)`` mesh (DDP)
    stage 1-2  ``reshard_after_forward=False``: gathered in the forward, whole until the
               backward is done (upstream's SHARD_GRAD_OP)
    stage 3    ``reshard_after_forward=True``: gathered again in the backward

The JAX package keeps a stage 1-2 model's parameters replicated at rest and shards only
the optimizer state; FSDP2 keeps them sharded at rest as well and whole from the forward
to the backward. The arithmetic is the same (ROADMAP.md Queue C records the departure).

Every optimizer and every statistic of the train step works on `local` views; a sum
over a whole tensor all-reduces its local sums over `shard_group`.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor


@dataclass(frozen=True)
class StageLayout:
    replicate_only: bool  # stage 0: the params are whole on every rank
    reshard_after_forward: bool  # stage 3: a block is gathered again in the backward


def stage_layout(stage: int) -> StageLayout:
    if stage not in (0, 1, 2, 3):
        raise ValueError(f"unexpected ZeRO stage ({stage})")
    return StageLayout(replicate_only=stage == 0, reshard_after_forward=stage == 3)


def fsdp_mesh(stage: int):
    """The mesh `fully_shard` takes at `stage`: the 1-D ``fsdp`` axis when nothing
    replicates, else the 2-D ``(dp, fsdp)`` mesh (HSDP)."""
    from .mesh import MeshManager

    mesh = MeshManager.replicated_mesh() if stage_layout(stage).replicate_only else MeshManager.get_mesh()
    return mesh["fsdp"] if mesh.size(0) == 1 else mesh


def local(t: torch.Tensor) -> torch.Tensor:
    """This rank's part of `t` (`t` itself unless it is a DTensor)."""
    return t.to_local() if isinstance(t, DTensor) else t


def shard_group(t: torch.Tensor):
    """The process group over which `t`'s elements are split (None when every rank holds
    all of them)."""
    if not isinstance(t, DTensor):
        return None
    for dim, placement in enumerate(t.placements):
        if placement.is_shard() and t.device_mesh.size(dim) > 1:
            return t.device_mesh.get_group(dim)
    return None


_HOST_MESHES: dict = {}


def host_mesh(mesh):
    """`mesh`'s ranks and layout over host tensors (gloo): `DTensor.from_local` moves a local
    tensor to its mesh's device, so a host shard (a checkpoint's copy, an offloaded moment)
    keeps its place in the whole on this mesh instead. Made once a layout, on the save or
    load that every rank makes together."""
    if mesh.device_type == "cpu":
        return mesh
    key = (tuple(mesh.shape), mesh.mesh_dim_names)
    if key not in _HOST_MESHES:
        _HOST_MESHES[key] = init_device_mesh("cpu", key[0], mesh_dim_names=key[1])
    return _HOST_MESHES[key]


def like(param: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """`value` (this rank's part of a tensor laid out as `param`) as a DTensor of
    `param`'s layout, sharing `value`'s storage (on the host mesh for a host `value`);
    `value` itself when `param` is not a DTensor or `value` does not have its local shape
    (a per-tensor scalar)."""
    if not isinstance(param, DTensor) or value.shape != param.to_local().shape:
        return value
    mesh = host_mesh(param.device_mesh) if value.device.type == "cpu" else param.device_mesh
    return DTensor.from_local(value, mesh, param.placements, run_check=False, shape=param.shape, stride=param.stride())


def all_reduce_(tensor: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """All-reduce `tensor` in place over `group` (nothing without one)."""
    if group is not None:
        dist.all_reduce(tensor, op=op, group=group)
    return tensor
