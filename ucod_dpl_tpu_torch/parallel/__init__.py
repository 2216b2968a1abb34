"""Parallelism of the PyTorch port: device meshes and tensor parallelism."""

from .mesh import Mesh, build_mesh, data_sharding, replicate, shard_batch

__all__ = ["Mesh", "build_mesh", "data_sharding", "replicate", "shard_batch"]
