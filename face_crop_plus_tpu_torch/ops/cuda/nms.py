"""Greedy-NMS keep mask: the hand-written CUDA kernel and its dispatch.

The kernel (``csrc/nms.cu``) replaces the TPU kernel
``face_crop_plus_tpu/ops/pallas/nms_kernel.py:_nms_kernel``; the source
says what bounds it on the card and how its two passes are laid out.  It is
built with ``nvcc`` at first use (:mod:`.build`) and called through
``ctypes`` on PyTorch's current stream, without synchronising.

:func:`greedy_nms_mask_cuda` launches the kernel for a CUDA tensor and
runs the plain version (:func:`..nms.greedy_nms_mask` over
:func:`..nms.iou_matrix_plus1`) for a CPU tensor; it never falls back from
one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from ..nms import greedy_nms_mask, iou_matrix_plus1
from .build import load_library

#: Largest candidate count the kernel takes (the detector's pre-NMS ceiling).
MAX_K = 1024

#: Kernel launches so far (each call of the kernel counts one).
launches = 0


def _kernel():
    lib = load_library("nms.cu")
    fn = lib.fcpt_greedy_nms_mask
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p,  # boxes
            ctypes.c_void_p,  # valid
            ctypes.c_void_p,  # mask scratch
            ctypes.c_void_p,  # keep
            ctypes.c_int,  # n
            ctypes.c_int,  # k
            ctypes.c_float,  # threshold
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
        lib.fcpt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.fcpt_cuda_error_string.restype = ctypes.c_char_p
    return lib, fn


def greedy_nms_mask_cuda(
    boxes: torch.Tensor, valid: torch.Tensor, threshold: float
) -> torch.Tensor:
    """Exact greedy NMS keep mask of score-sorted candidates.

    Args:
        boxes: (N, K, 4) float32 contiguous corner-form boxes, score-
            descending per image, K <= 1024.
        valid: (N, K) bool contiguous candidate validity.
        threshold: Suppression IoU threshold (> threshold suppresses).

    Returns:
        (N, K) bool keep mask on the boxes' device.  On CUDA the kernel's,
        on the CPU the plain version's.
    """
    global launches
    if boxes.device.type == "cpu" and valid.device.type == "cpu":
        return greedy_nms_mask(iou_matrix_plus1(boxes), valid, threshold)
    if boxes.device.type != "cuda" or valid.device != boxes.device:
        raise ValueError(
            f"boxes and valid must share one CUDA device, got {boxes.device} "
            f"and {valid.device}"
        )
    if boxes.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(
            f"expected float32 boxes and bool valid, got {boxes.dtype}, {valid.dtype}"
        )
    if boxes.dim() != 3 or boxes.shape[2] != 4 or valid.shape != boxes.shape[:2]:
        raise ValueError(
            f"expected boxes (N, K, 4) and valid (N, K), got {tuple(boxes.shape)} "
            f"and {tuple(valid.shape)}"
        )
    if not (boxes.is_contiguous() and valid.is_contiguous()):
        raise ValueError("boxes and valid must be contiguous")
    if boxes.data_ptr() % 16:
        raise ValueError("boxes must start on a 16-byte boundary (one float4 per box)")
    n, k = valid.shape
    if k > MAX_K:
        raise ValueError(f"K = {k} exceeds the kernel's limit of {MAX_K}")
    keep = torch.empty((n, k), dtype=torch.bool, device=boxes.device)
    if n == 0 or k == 0:
        return keep
    words = (k + 63) // 64
    # Rows padded to 64 per word: every 64-row strip of an image's mask is a
    # 16-byte aligned block of 512 * words bytes, as the scan's bulk copies need.
    mask = torch.empty((n, 64 * words, words), dtype=torch.int64, device=boxes.device)
    lib, fn = _kernel()
    with torch.cuda.device(boxes.device):
        err = fn(
            boxes.data_ptr(),
            valid.data_ptr(),
            mask.data_ptr(),
            keep.data_ptr(),
            n,
            k,
            float(threshold),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        msg = lib.fcpt_cuda_error_string(err).decode()
        raise RuntimeError(f"greedy NMS kernel launch failed: {msg} ({err})")
    launches += 1
    return keep
