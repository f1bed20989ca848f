"""face_crop_plus_tpu_torch: the PyTorch / CUDA port of face_crop_plus_tpu.

A second package beside the JAX one, for NVIDIA GPUs (Hopper).  It never
imports JAX or the JAX package; the hand-written CUDA kernels under
``csrc/`` are built with ``nvcc`` at first use.  Entry points run on the
card unless the caller passes ``device="cpu"``.
"""

from .cropper import Cropper

__all__ = ["Cropper"]
