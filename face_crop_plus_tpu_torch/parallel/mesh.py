"""Device mesh: data-parallel scaling of the image pipeline in one process.

Counterpart of ``face_crop_plus_tpu.parallel.mesh`` (the same names and
return contracts where torch has the concept).  The workload is
embarrassingly parallel over images, so the mesh is one ``("data",)``
axis: every shard holds its own replica of each network
(:func:`shard_params`) and a contiguous block of the batch
(:func:`shard_batch`), and faces index images of their own shard, so
compaction, gated super-resolution and warps stay shard-local: no tensor
crosses shards.

PyTorch has no ``NamedSharding`` and no pjit.  Where XLA runs one
partitioned program, the callers run one program per shard, each on its
own card and that card's current stream, and enqueue every shard before
the host waits on any of them; where XLA gives one cap diagnostic, they
take the largest over shards.  ``batch_sharding`` and ``replicated`` name
``NamedSharding`` objects, which have no counterpart here, so they are
left out.

A mesh may repeat a device (``make_mesh(devices=[torch.device("cpu")] *
4)``, ``[cuda:0] * 2``): each entry is still one shard with its own
replica.  That is the counterpart of the JAX tests' virtual CPU devices
(``--xla_force_host_platform_device_count``), and it runs the sharding,
padding and per-shard launches on a machine with one card.

Batch sizes must divide by the mesh size; :func:`pad_to_multiple` handles
the boundary, as validity counts already flow through the pipeline.
"""

from __future__ import annotations

import copy
import dataclasses
import itertools

import numpy as np
import torch

from ..utils.device import to_device

DATA_AXIS = "data"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D ``("data",)`` mesh: one shard per entry of ``devices``.

    All entries are of one type, all CUDA or all CPU; an entry may repeat.
    """

    devices: tuple

    axis_names = (DATA_AXIS,)

    def __post_init__(self):
        devices = tuple(torch.device(d) for d in self.devices)
        if not devices:
            raise ValueError("Cannot build a mesh over zero devices.")
        types = {d.type for d in devices}
        if len(types) > 1 or not types <= {"cuda", "cpu"}:
            raise ValueError(
                f"A mesh's devices must be all CUDA or all CPU, got {[str(d) for d in devices]}"
            )
        object.__setattr__(self, "devices", devices)

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """Builds a 1-D data-parallel mesh.

    With no ``devices`` it takes ``cuda:0 … cuda:{n-1}`` (every card when
    ``n_devices`` is None).  A mesh never falls to the CPU by itself: pass
    ``devices=[torch.device("cpu")] * n`` for a CPU mesh.

    Raises:
        ValueError: On ``n_devices <= 0``, on more devices than there are,
            on an empty list and on a list mixing device types: a smaller
            mesh than asked would change padding multiples and throughput
            with no visible signal.
        RuntimeError: With no ``devices`` when CUDA is not available.
    """
    if devices is None:
        if n_devices is not None and n_devices <= 0:
            raise ValueError(f"n_devices must be positive, got {n_devices}")
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: make_mesh() builds a mesh over CUDA cards; pass "
                "devices=[torch.device('cpu')] * n for a CPU mesh."
            )
        count = torch.cuda.device_count()
        if n_devices is not None and n_devices > count:
            raise ValueError(
                f"Requested a {n_devices}-device mesh but only {count} devices are available."
            )
        n = count if n_devices is None else n_devices
        devices = [torch.device("cuda", i) for i in range(n)]
    return Mesh(tuple(devices))


def check_mesh(mesh) -> Mesh | None:
    """``mesh`` itself when it is None or a :class:`Mesh`.

    Raises:
        TypeError: For anything else (a JAX mesh, a device list).
    """
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(
            f"mesh must be a face_crop_plus_tpu_torch.parallel.Mesh (make_mesh), got "
            f"{type(mesh).__name__}"
        )
    return mesh


def shard_params(module: torch.nn.Module, mesh: Mesh) -> tuple:
    """One replica of ``module`` per shard, on its device, in ``eval()`` with
    ``requires_grad_(False)``, its tensors in the module's own dtypes (a
    model's ``compute_dtype``).  A repeated device still gets its own
    replica, so each shard's program reads only its own copy."""
    replicas = []
    for device in mesh.devices:
        replica = copy.deepcopy(module).to(device).eval()
        replicas.append(replica.requires_grad_(False))
    return tuple(replicas)


class Replicas:
    """:func:`shard_params` of a model's network, made again when it changes.

    A network swapped in after the replicas were made, or weights loaded
    into it (a checkpoint, ``load_state_dict``, which bumps its tensors'
    version counters), make :meth:`get` replicate it again, so no shard
    runs stale weights.
    """

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self._key = None
        self._replicas = ()

    def get(self, module: torch.nn.Module) -> tuple:
        tensors = itertools.chain(module.parameters(), module.buffers())
        key = (id(module), tuple((t.data_ptr(), t._version) for t in tensors))
        if key != self._key:
            self._replicas = shard_params(module, self.mesh)
            self._key = key
        return self._replicas


def shard_batch(x, mesh: Mesh) -> tuple:
    """A batch as S contiguous row blocks of N/S rows, block s on shard s.

    A host array goes up through pinned memory without making the host
    wait (:func:`..utils.device.to_device`); a tensor's blocks are copied
    to their devices without blocking (a block already there is a view).

    Raises:
        ValueError: When N does not divide by the mesh size
            (:func:`pad_to_multiple` first).
    """
    n, s = x.shape[0], mesh.size
    if n % s:
        raise ValueError(f"batch of {n} rows does not divide over {s} shards")
    b = n // s
    if torch.is_tensor(x):
        return tuple(x[i * b : (i + 1) * b].to(d, non_blocking=True)
                     for i, d in enumerate(mesh.devices))
    x = np.asarray(x)
    return tuple(to_device(x[i * b : (i + 1) * b], d) for i, d in enumerate(mesh.devices))


def pad_to_multiple(batch: np.ndarray, multiple: int) -> tuple[np.ndarray, int]:
    """Pads dim 0 to a multiple (repeating the last row); returns valid len."""
    valid = batch.shape[0]
    rem = (-valid) % multiple
    if rem == 0:
        return batch, valid
    reps = np.repeat(batch[-1:], rem, axis=0)
    return np.concatenate([batch, reps], axis=0), valid


def partition_by_shard(
    shard_ids: np.ndarray,
    local_rows: np.ndarray,
    mesh_size: int,
    chunk: int,
) -> list[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Packs shard-owned row selections into uniform-capacity dispatches.

    Each shard's selection list is padded to a shared capacity C, and
    capacities above ``chunk`` split into several dispatches (bounding the
    warp and SR working set of one dispatch, the mesh analog of
    ``max_warp_chunk`` and ``enh_batch_size``).

    Args:
        shard_ids: (J,) owning shard of each requested row.
        local_rows: (J,) row index within its shard's local block.
        mesh_size: Number of shards S.
        chunk: Per-shard capacity ceiling per dispatch (>= 1).

    Returns:
        One ``(sel, req, out_rows)`` triple per dispatch: ``sel`` is the
        (S*C,) int32 local-row selection (padding repeats the shard's last
        real row, or 0 for a shard with nothing to do), ``req`` the (J_c,)
        int64 requests it serves, and ``out_rows`` the (J_c,) int64 output
        row of each of them.
    """
    lists: list[list[tuple[int, int]]] = [[] for _ in range(mesh_size)]
    for j, (s, l) in enumerate(zip(shard_ids, local_rows)):
        lists[int(s)].append((int(l), j))
    cmax = max((len(x) for x in lists), default=0)
    out = []
    for p0 in range(0, max(cmax, 1), chunk):
        if p0 >= cmax:
            break
        c = min(chunk, cmax - p0)
        sel = np.zeros((mesh_size, c), np.int32)
        req, rows = [], []
        for s in range(mesh_size):
            seg = lists[s][p0 : p0 + c]
            for p, (l, j) in enumerate(seg):
                sel[s, p] = l
                req.append(j)
                rows.append(s * c + p)
            if seg:
                sel[s, len(seg) : c] = seg[-1][0]
        out.append((sel.reshape(-1), np.asarray(req, np.int64), np.asarray(rows, np.int64)))
    return out


def partition_rows_by_shard(
    global_rows: np.ndarray, n_rows: int, mesh_size: int, chunk: int
) -> list[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """:func:`partition_by_shard` for rows of a contiguously sharded array.

    :func:`shard_batch` over ``n_rows`` (divisible by the mesh size) gives
    shard ``s`` the block ``[s*n_rows/S, (s+1)*n_rows/S)``, so global rows
    split as ``(row // block, row % block)``.
    """
    global_rows = np.asarray(global_rows, np.int64)
    block = n_rows // mesh_size
    return partition_by_shard(global_rows // block, global_rows % block, mesh_size, chunk)
