"""Scaling over cards: one process per GPU, and the in-process data mesh."""

from .distributed import host_shard, init_distributed
from .mesh import (
    DATA_AXIS,
    Mesh,
    make_mesh,
    pad_to_multiple,
    partition_by_shard,
    partition_rows_by_shard,
    shard_batch,
    shard_params,
)

__all__ = [
    "DATA_AXIS",
    "Mesh",
    "host_shard",
    "init_distributed",
    "make_mesh",
    "pad_to_multiple",
    "partition_by_shard",
    "partition_rows_by_shard",
    "shard_batch",
    "shard_params",
]
