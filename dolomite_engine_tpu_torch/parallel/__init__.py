"""The device mesh and the ZeRO stages on FSDP2 (mirrors `dolomite_engine_tpu/parallel/`)."""

from .mesh import MESH_AXES, MeshManager, get_mesh, mesh_sizes, temporary_mesh
from .sharding import StageLayout, local, shard_group, stage_layout
