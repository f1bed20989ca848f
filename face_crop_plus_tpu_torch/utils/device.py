"""Device resolution: the port runs on a CUDA card unless told otherwise."""

from __future__ import annotations

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
