"""Distributed wrapping: the mesh from the args and the model under FSDP2.

Counterpart of `dolomite_engine_tpu/distributed/__init__.py`. `build_mesh_from_args`
builds the `MeshManager` mesh, holding ``data_parallel_size`` to the world as the JAX
package does (a topology assertion, not a setting); `wrap_model_for_distributed_training`
applies `fully_shard` to every transformer block and then to the root (which holds the
embeddings, the tied LM-head table and the last norm) under the ZeRO stage's layout
(`parallel/sharding.py`). FSDP2 gets no mixed-precision policy: the parameters stay fp32
masters and the model casts them to its compute dtype as it does unwrapped, so a world of
one at stage 3 computes what stage 0 computes.

FSDP2 replaces the module's parameters with sharded ones, so the optimizer is built after
the wrap, over the new parameters (the JAX package builds the sharded state and the
optimizer state together).
"""

from __future__ import annotations

import logging

import torch.distributed as dist
from torch import nn
from torch.distributed.fsdp import fully_shard

from ..parallel.mesh import MeshManager
from ..parallel.sharding import fsdp_mesh, stage_layout
from ..utils import log_rank_0, world_size


def get_data_parallel_world_size(args) -> int:
    """Ranks on the batch axes: the world (1 without a process group) less tensor and
    context parallelism."""
    dist_args = args.distributed_args
    model_parallel = max(dist_args.tensor_parallel_size * dist_args.context_parallel_size, 1)
    return max(world_size() // model_parallel, 1)


def build_mesh_from_args(args, device_type: str = "cuda"):
    dist_args = args.distributed_args
    if dist_args.data_parallel_size is not None:
        derived = get_data_parallel_world_size(args)
        if dist_args.data_parallel_size != derived:
            raise ValueError(
                f"distributed_args.data_parallel_size={dist_args.data_parallel_size} does not "
                f"match the derived data-parallel world size {derived} "
                f"({dist.get_world_size()} devices / tp={dist_args.tensor_parallel_size} / "
                f"cp={dist_args.context_parallel_size})"
            )
    MeshManager(
        tensor_parallel_size=dist_args.tensor_parallel_size,
        sequence_parallel_size=dist_args.context_parallel_size,
        expert_parallel_size=dist_args.expert_parallel_size,
        data_parallel_replication_world_size=dist_args.zero_topology.data_parallel_replication_world_size,
        data_parallel_sharding_world_size=dist_args.zero_topology.data_parallel_sharding_world_size,
        device_type=device_type,
    )
    return MeshManager.get_mesh()


def transformer_blocks(module: nn.Module) -> list[nn.Module]:
    """The blocks of the model's ``transformer.h`` (under a PEFT wrapper too), or an
    encoder-decoder's ``encoder`` then ``decoder`` blocks."""
    stacks = []
    for name, child in module.named_modules():
        if not isinstance(child, nn.ModuleList):
            continue
        if name.split(".")[-2:] == ["transformer", "h"]:
            return list(child)
        if name.split(".")[-1] in ("encoder", "decoder"):
            stacks.extend(child)
    if stacks:
        return stacks
    raise ValueError(f"no transformer.h block list in {type(module).__name__}")


def shard_module(module: nn.Module, stage: int) -> None:
    """`fully_shard` every block of `module`, then `module` itself, on the mesh and with
    the resharding of `stage`. The root (the embeddings, the tied LM-head table the loss
    reads at the end of the forward, the last norm) stays whole from its forward to its
    backward at every stage: its backward starts at once. Over more than one rank the
    gradients are summed, not averaged: each rank's loss is already its share of the
    global batch's."""
    layout = stage_layout(stage)
    mesh = fsdp_mesh(stage)
    for unit in transformer_blocks(module) + [module]:
        reshard = layout.reshard_after_forward and unit is not module
        fully_shard(unit, mesh=mesh, reshard_after_forward=reshard)
        if dist.get_world_size() > 1:
            unit.set_gradient_divide_factor(1.0)
            unit.set_force_sum_reduction_for_comms(True)


def wrap_model_for_distributed_training(args, model) -> object:
    """Build the mesh and shard `model` (a `ModelWrapper`) under the stage; an fp8 run's
    delayed-scaling state then reduces its amax updates over every rank. Returns the mesh."""
    device = model.model.device
    mesh = build_mesh_from_args(args, device.type)
    stage = args.distributed_args.stage
    shard_module(model.model, stage)
    group = dist.group.WORLD if dist.get_world_size() > 1 else None
    # every rank holds other rows of the global batch: the losses' token counts, MoE's
    # routing statistics and fp8's amax updates are reduced over all of them
    for module in model.model.modules():
        if hasattr(module, "data_parallel_group"):
            module.data_parallel_group = group
    if model.fp8 is not None:
        model.fp8.group = group
    log_rank_0(
        logging.INFO,
        f"FSDP2: stage {stage}, mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}, "
        f"{len(transformer_blocks(model.model))} blocks + the root",
    )
    return mesh
