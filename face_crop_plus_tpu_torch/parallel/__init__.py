"""One process per GPU: the process group's topology and file shards."""

from .distributed import host_shard, init_distributed

__all__ = ["host_shard", "init_distributed"]
