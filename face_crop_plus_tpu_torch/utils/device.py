"""Device resolution and compute precision.

The port runs on a CUDA card unless told otherwise.  Its networks compute
in float32 by default, as the JAX package does off the TPU
(``face_crop_plus_tpu/models/detection.py:205-206``); a caller may ask a
model for bfloat16 (or float16) convolutions with ``compute_dtype``, as a
JAX caller passes ``jnp.bfloat16`` (:func:`resolve_compute_dtype`).  PyTorch lets cuDNN
convolutions (and, when a caller asks, CUDA matmuls) run in TF32 by
default; :func:`f32_precision` turns both off around the package's own work
and restores the caller's settings after it.  :func:`to_device` moves host
data to the card without making the host wait for the card, :func:`to_host_async` and
:func:`to_host` bring results back the same way, each on the card that
holds them.
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """Resolves a device spec; None and "auto" mean "cuda".

    Raises:
        RuntimeError: If a CUDA device is asked for (explicitly or by
            default) and CUDA is not available.  There is no silent CPU
            path: pass ``device="cpu"`` to run on the CPU.
    """
    if device is None or device == "auto":
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: face_crop_plus_tpu_torch runs on an "
            "NVIDIA GPU by default; pass device='cpu' to run on the CPU."
        )
    return dev


def to_device(values, device: torch.device, dtype=None) -> torch.Tensor:
    """Host data (an array or nested lists) as a tensor on ``device``.

    On a CUDA device the data is staged in a pinned buffer from PyTorch's
    caching host allocator and copied with ``non_blocking=True`` on the
    current stream: the copy runs in stream order, behind the work already
    enqueued, and the host goes on.  A blocking copy from pageable memory
    would synchronise the stream, so the host would wait for every earlier
    batch first.  The allocator records the copy on the buffer and reuses
    it only after the copy is done.  Elsewhere the data is wrapped as
    ``torch.from_numpy(...).to(device)``; a read-only array (a cached
    grid) is copied first.
    """
    array = np.asarray(values, dtype, order="C")
    host = torch.from_numpy(array if array.flags.writeable else array.copy())
    if device.type != "cuda":
        return host.to(device)
    pinned = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
    pinned.copy_(host)
    return pinned.to(device, non_blocking=True)


def to_host_async(tensors) -> tuple[tuple[torch.Tensor, ...], "torch.cuda.Event | None"]:
    """Starts device→host copies of ``tensors``; returns (host tensors, event).

    On a CUDA device the copies go into pinned buffers, enqueued with
    ``non_blocking=True`` on the current stream of the tensors' own card
    (the first tensor's; all must share it), and the returned event is
    recorded on that stream, after them: waiting on it waits for these
    copies whatever the current device is.  CPU tensors come back as they
    are, with no event.
    """
    device = tensors[0].device
    if device.type != "cuda":
        return tuple(tensors), None
    stream = torch.cuda.current_stream(device)
    host = []
    for t in tensors:
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t, non_blocking=True)
        host.append(buf)
    event = torch.cuda.Event()
    event.record(stream)
    return tuple(host), event


def to_host(shard_outputs) -> list[tuple[np.ndarray, ...]]:
    """Host arrays of each shard's tuple of tensors, in order.

    Every shard's copies are started (:func:`to_host_async`) before the
    host waits on any of them, so S cards finish their work side by side.
    """
    started = [to_host_async(tensors) for tensors in shard_outputs]
    for _host, event in started:
        if event is not None:
            event.synchronize()
    return [tuple(t.numpy() for t in host) for host, _event in started]


# The TF32 switches are process-wide, and worker threads of one directory
# run overlap: the first holder saves the caller's settings and the last to
# leave restores them, so no holder runs with TF32 back on.
_precision_lock = threading.Lock()
_precision_holders = 0
_saved_tf32: tuple[bool, bool] | None = None


@contextlib.contextmanager
def f32_precision():
    """Runs the block with TF32 off for cuDNN convolutions and CUDA matmuls."""
    global _precision_holders, _saved_tf32
    with _precision_lock:
        if _precision_holders == 0:
            _saved_tf32 = (
                torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32,
            )
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        _precision_holders += 1
    try:
        yield
    finally:
        with _precision_lock:
            _precision_holders -= 1
            if _precision_holders == 0:
                cudnn_tf32, matmul_tf32 = _saved_tf32
                torch.backends.cudnn.allow_tf32 = cudnn_tf32
                torch.backends.cuda.matmul.allow_tf32 = matmul_tf32


#: The dtypes a model's ``compute_dtype`` accepts: the JAX package's float
#: compute dtypes (``jnp.float32``, ``jnp.bfloat16``, ``jnp.float16``).
COMPUTE_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def resolve_compute_dtype(compute_dtype) -> torch.dtype:
    """A model's ``compute_dtype`` argument as a torch dtype.

    None gives ``torch.float32``: the JAX package picks bfloat16 only where
    its platform is a TPU, and the port's devices (a CUDA card, the CPU)
    never are.

    Raises:
        ValueError: For anything but None and :data:`COMPUTE_DTYPES`.
    """
    if compute_dtype is None:
        return torch.float32
    if not isinstance(compute_dtype, torch.dtype) or compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(
            f"compute_dtype must be one of {', '.join(map(str, COMPUTE_DTYPES))} or None, "
            f"got {compute_dtype!r}"
        )
    return compute_dtype


def compute_precision(compute=None) -> dict:
    """The precision a network computes in, read inside :func:`f32_precision`.

    ``compute`` is a model (its ``compute_dtype``), a dtype, or None: the
    float32 every model computes in unless its caller asked otherwise.  The
    TF32 switches are the ones the package pins around its own work; they
    do not touch bfloat16 or float16 convolutions.
    """
    dtype = resolve_compute_dtype(getattr(compute, "compute_dtype", compute))
    with f32_precision():
        return {
            "dtype": str(dtype).removeprefix("torch."),
            "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
            "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        }
