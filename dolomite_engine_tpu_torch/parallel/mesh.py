"""MeshManager: the data-parallel layout of the ranks.

Counterpart of `dolomite_engine_tpu/parallel/mesh.py`, with its axis names
``("dp", "fsdp", "sp", "tp", "ep")`` and accessors. The port runs data parallelism only
(tensor, sequence and expert parallelism are ROADMAP.md Queue A, 'Distribution', later
parts), so ``sp``, ``tp`` and ``ep`` are 1 and the mesh is a
`torch.distributed.device_mesh.DeviceMesh` of shape ``(dp, fsdp)``: ``dp`` replicates
(the HSDP replicate axis), ``fsdp`` shards. The split is JAX's: all sharding by default,
``zero_topology`` with the same errors.
"""

from __future__ import annotations

import math
from contextlib import contextmanager

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

MESH_AXES = ("dp", "fsdp", "sp", "tp", "ep")
DATA_AXES = ("dp", "fsdp")


def mesh_sizes(
    world_size: int,
    tensor_parallel_size: int = 1,
    sequence_parallel_size: int = 1,
    expert_parallel_size: int = 1,
    data_parallel_replication_world_size: int | None = None,
    data_parallel_sharding_world_size: int | None = None,
) -> dict[str, int]:
    """The size of each mesh axis for `world_size` ranks, or the JAX MeshManager's
    ValueError."""
    model_parallel = tensor_parallel_size * sequence_parallel_size * expert_parallel_size
    if world_size % model_parallel != 0:
        raise ValueError(f"device count {world_size} not divisible by tp*sp*ep = {model_parallel}")
    data_parallel_size = world_size // model_parallel
    if data_parallel_replication_world_size is None and data_parallel_sharding_world_size is None:
        replicate, shard = 1, data_parallel_size
    else:
        replicate = data_parallel_replication_world_size
        shard = data_parallel_sharding_world_size
        if replicate is None:
            replicate = data_parallel_size // shard
        if shard is None:
            shard = data_parallel_size // replicate
        if replicate * shard != data_parallel_size:
            raise ValueError(
                f"replication ({replicate}) x sharding ({shard}) != data parallel size ({data_parallel_size})"
            )
    shape = (replicate, shard, sequence_parallel_size, tensor_parallel_size, expert_parallel_size)
    if math.prod(shape) != world_size:
        raise ValueError(f"mesh shape {shape} does not cover {world_size} devices")
    return dict(zip(MESH_AXES, shape))


class MeshManager:
    """Singleton over the ranks' mesh (the module-level accessors below read it)."""

    mesh: DeviceMesh | None = None
    _sizes: dict[str, int] = {}
    _replicated: DeviceMesh | None = None

    def __init__(
        self,
        tensor_parallel_size: int = 1,
        sequence_parallel_size: int = 1,
        expert_parallel_size: int = 1,
        data_parallel_replication_world_size: int | None = None,
        data_parallel_sharding_world_size: int | None = None,
        device_type: str = "cuda",
    ) -> None:
        if tensor_parallel_size * sequence_parallel_size * expert_parallel_size != 1:
            raise NotImplementedError(
                "tensor, sequence and expert parallel meshes are not ported yet: ROADMAP.md Queue A, "
                "'Distribution'"
            )
        sizes = mesh_sizes(
            dist.get_world_size(),
            data_parallel_replication_world_size=data_parallel_replication_world_size,
            data_parallel_sharding_world_size=data_parallel_sharding_world_size,
        )
        MeshManager.mesh = init_device_mesh(device_type, (sizes["dp"], sizes["fsdp"]), mesh_dim_names=DATA_AXES)
        MeshManager._sizes = sizes
        MeshManager._replicated = None

    # ------------------------------------------------------------------ accessors
    @staticmethod
    def get_mesh() -> DeviceMesh:
        if MeshManager.mesh is None:
            raise RuntimeError("MeshManager not initialized")
        return MeshManager.mesh

    @staticmethod
    def replicated_mesh() -> DeviceMesh:
        """The ``(dp * fsdp, 1)`` mesh of ZeRO stage 0: every rank a replica (DDP)."""
        if MeshManager._replicated is None:
            mesh = MeshManager.get_mesh()
            MeshManager._replicated = init_device_mesh(
                mesh.device_type, (mesh.size(), 1), mesh_dim_names=DATA_AXES
            )
        return MeshManager._replicated

    @staticmethod
    def is_initialized() -> bool:
        return MeshManager.mesh is not None

    @staticmethod
    def get_global_rank() -> int:
        return dist.get_rank()

    @staticmethod
    def get_world_size() -> int:
        return dist.get_world_size()

    @staticmethod
    def axis_size(axis: str) -> int:
        return MeshManager._sizes.get(axis, 1)

    @staticmethod
    def get_data_parallel_world_size() -> int:
        return MeshManager.axis_size("dp") * MeshManager.axis_size("fsdp") * MeshManager.axis_size("ep")

    @staticmethod
    def get_tensor_parallel_world_size() -> int:
        return MeshManager.axis_size("tp")

    @staticmethod
    def get_sequence_parallel_world_size() -> int:
        return MeshManager.axis_size("sp")

    @staticmethod
    def get_expert_parallel_world_size() -> int:
        return MeshManager.axis_size("ep")

    @staticmethod
    def destroy() -> None:
        MeshManager.mesh = None
        MeshManager._sizes = {}
        MeshManager._replicated = None


def get_mesh() -> DeviceMesh:
    return MeshManager.get_mesh()


@contextmanager
def temporary_mesh(mesh: DeviceMesh):
    """Swap the global mesh (tests)."""
    saved = MeshManager.mesh, MeshManager._sizes, MeshManager._replicated
    MeshManager.mesh = mesh
    MeshManager._sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    MeshManager._replicated = None
    try:
        yield mesh
    finally:
        MeshManager.mesh, MeshManager._sizes, MeshManager._replicated = saved
