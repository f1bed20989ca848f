"""Device resolution and compute precision.

The port runs on a CUDA card unless told otherwise, and its detector
computes in float32, as the JAX package does off the TPU
(``face_crop_plus_tpu/models/detection.py:206``).  PyTorch lets cuDNN
convolutions (and, when a caller asks, CUDA matmuls) run in TF32 by
default; :func:`f32_precision` turns both off around the package's own work
and restores the caller's settings after it.
"""

from __future__ import annotations

import contextlib
import threading

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


def compute_precision() -> dict:
    """The precision the detector computes in, read inside :func:`f32_precision`."""
    with f32_precision():
        return {
            "dtype": "float32",
            "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
            "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        }
