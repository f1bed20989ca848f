"""One process per GPU: process bootstrap and file-list sharding.

Counterpart of ``face_crop_plus_tpu.parallel.distributed`` (the same
names and return contracts).  The workload is embarrassingly parallel over
files: every process runs the single-card pipeline on its own card over
its own strided shard of the directory listing, and outputs are distinct
files.  So the process group carries only the topology (rank and world
size), over the "gloo" backend; no tensor rides a collective.

* :func:`init_distributed` wraps ``torch.distributed.init_process_group``.
* :func:`host_shard` gives the ``(shard_index, num_shards)`` pair for
  ``Cropper.process_dir``.

A launcher sets ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``
and ``LOCAL_RANK`` for each process (``torchrun --nproc-per-node N -m
face_crop_plus_tpu_torch -si auto ...``, or by hand); under ``-si auto``
the CLI runs on ``cuda:{LOCAL_RANK}``::

    from face_crop_plus_tpu_torch.parallel import host_shard, init_distributed

    init_distributed()  # False on a single-process run
    shard, num = host_shard()
    Cropper(device=f"cuda:{local_rank}", ...).process_dir(
        in_dir, out_dir, shard_index=shard, num_shards=num)
"""

from __future__ import annotations

import os

import torch.distributed as dist


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Joins this process to the process group ("gloo").

    Each argument left None is read from the launcher's environment:
    ``MASTER_ADDR`` and ``MASTER_PORT`` (the coordinator's ``host:port``),
    ``WORLD_SIZE`` and ``RANK``.  ``coordinator_address`` may also be an
    init URL (``tcp://…``, ``file://…``).  The call blocks until every
    process has joined.

    Returns:
        True when this call created the group; False when a group exists
        already or no topology is configured (a single-process run), so
        callers may call it unconditionally.  A group that is configured
        but cannot be created raises.
    """
    if dist.is_initialized():
        return False
    env = os.environ
    if coordinator_address is None and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None and env.get("WORLD_SIZE"):
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and env.get("RANK"):
        process_id = int(env["RANK"])
    if coordinator_address is None or num_processes is None or process_id is None:
        return False
    if "://" not in coordinator_address:
        coordinator_address = "tcp://" + coordinator_address
    dist.init_process_group("gloo", init_method=coordinator_address,
                            world_size=num_processes, rank=process_id)
    return True


def host_shard() -> tuple[int, int]:
    """This process's ``(shard_index, num_shards)`` for file sharding.

    The group's rank and size; without a group, ``RANK`` and
    ``WORLD_SIZE`` when both are set; else ``(0, 1)``, so the result can
    be passed to ``process_dir`` unconditionally.
    """
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    env = os.environ
    if env.get("RANK") and env.get("WORLD_SIZE"):
        return int(env["RANK"]), int(env["WORLD_SIZE"])
    return 0, 1
