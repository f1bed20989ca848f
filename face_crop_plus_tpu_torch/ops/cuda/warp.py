"""Affine warp to uint8 crops and the 2-D gather: CUDA kernels and dispatch.

The kernels (``csrc/warp.cu``) replace the TPU kernel
``tools/mosaic_gather_probe.py:kern`` (the Pallas probe of the gather a
warp kernel needs) and, with it, the JAX warp's index gathers; the source
says what bounds them on the card and how they are laid out.  They are
built with ``nvcc`` at first use (:mod:`.build`) and called through
``ctypes`` on PyTorch's current stream, without synchronising.

* :func:`warp_affine_u8` computes ``to_uint8(warp_affine_batch(...))`` of
  :mod:`..warp`, the composition every crop of the pipeline uses.
* :func:`gather2d` is the probe's own function, ``torch.gather`` of an
  (h, w) f32 tile by (h, w) int32 indices along one axis.

Each launches its kernel for CUDA tensors and runs the plain version for
CPU tensors; it never falls back from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from ..warp import BORDER_MODES, to_uint8, warp_affine_batch
from .build import load_library

#: Launches of the warp kernel so far (each call of the kernel counts one).
launches = 0
#: Launches of the gather2d kernel so far.
gather2d_launches = 0


def _lib():
    lib = load_library("warp.cu")
    if lib.fcpt_warp_affine_u8.argtypes is None:
        lib.fcpt_warp_affine_u8.argtypes = [
            ctypes.c_void_p,  # src
            ctypes.c_void_p,  # forward matrices
            ctypes.c_void_p,  # img_idx
            ctypes.c_void_p,  # windows (or None)
            ctypes.c_void_p,  # out
            ctypes.c_int,  # n
            ctypes.c_int,  # h
            ctypes.c_int,  # w
            ctypes.c_int,  # f
            ctypes.c_int,  # ho
            ctypes.c_int,  # wo
            ctypes.c_int,  # border mode
            ctypes.c_void_p,  # stream
        ]
        lib.fcpt_warp_affine_u8.restype = ctypes.c_int
        lib.fcpt_gather2d.argtypes = [
            ctypes.c_void_p,  # src
            ctypes.c_void_p,  # idx
            ctypes.c_void_p,  # out
            ctypes.c_int,  # h
            ctypes.c_int,  # w
            ctypes.c_int,  # axis
            ctypes.c_void_p,  # stream
        ]
        lib.fcpt_gather2d.restype = ctypes.c_int
        lib.fcpt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.fcpt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_device(tensors: dict[str, torch.Tensor]) -> torch.device:
    """The device all ``tensors`` share: the CPU or one CUDA device.

    Raises on a mix, and on a non-contiguous kernel input on either device,
    so that the CPU tests hold callers to what the kernel takes.
    """
    devices = {t.device for t in tensors.values()}
    dev = next(iter(devices))
    if len(devices) != 1 or dev.type not in ("cpu", "cuda"):
        raise ValueError(
            "inputs must share one CUDA device (or all lie on the CPU), got "
            + ", ".join(f"{k} on {t.device}" for k, t in tensors.items())
        )
    for name, t in tensors.items():
        # The wrapper hands the kernel a contiguous copy of the matrices.
        if name != "matrices" and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return dev


def _raise_on(lib, err: int, what: str):
    if err != 0:
        msg = lib.fcpt_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({err})")


def warp_affine_u8(
    images: torch.Tensor,
    matrices: torch.Tensor,
    img_idx: torch.Tensor,
    output_size: tuple[int, int],
    border_mode: str = "constant",
    windows: torch.Tensor | None = None,
) -> torch.Tensor:
    """Warps F faces to uint8 crops: ``to_uint8(warp_affine_batch(...))``.

    Args:
        images: uint8 (N, H, W, 3) sources.
        matrices: float32 (F, 2, 3) forward transforms (source → crop), as
            for :func:`..warp.warp_affine_batch`; on CUDA the kernel inverts
            them as :func:`..transform.invert_affine` does, bit for bit.
        img_idx: int32 (F,) source image of each face.
        output_size: Crop (width, height).
        border_mode: One of :data:`..warp.BORDER_MODES`.
        windows: Optional int32 (F, 4) per-face (top, left, height, width)
            windows inside the sources.

    Returns:
        uint8 (F, Ho, Wo, 3) crops on the inputs' device: the kernel's on
        CUDA, the plain version's on the CPU.
    """
    global launches
    if border_mode not in BORDER_MODES:
        raise ValueError(f"Unsupported border mode: {border_mode}")
    if images.dtype != torch.uint8 or matrices.dtype != torch.float32:
        raise TypeError(
            f"expected uint8 images and float32 matrices, got {images.dtype}, "
            f"{matrices.dtype}"
        )
    if img_idx.dtype != torch.int32 or (
        windows is not None and windows.dtype != torch.int32
    ):
        raise TypeError("img_idx and windows must be int32")
    if images.dim() != 4 or images.shape[-1] != 3:
        raise ValueError(f"expected images (N, H, W, 3), got {tuple(images.shape)}")
    f = matrices.shape[0]
    if (
        tuple(matrices.shape) != (f, 2, 3)
        or tuple(img_idx.shape) != (f,)
        or (windows is not None and tuple(windows.shape) != (f, 4))
    ):
        raise ValueError(
            "expected matrices (F, 2, 3), img_idx (F,) and windows (F, 4), got "
            f"{tuple(matrices.shape)}, {tuple(img_idx.shape)}, "
            f"{None if windows is None else tuple(windows.shape)}"
        )
    tensors = {"images": images, "matrices": matrices, "img_idx": img_idx}
    if windows is not None:
        tensors["windows"] = windows
    dev = _check_device(tensors)
    if dev.type == "cpu":
        return to_uint8(
            warp_affine_batch(images, matrices, img_idx, output_size, border_mode, windows)
        )
    n, h, w, _ = images.shape
    wo, ho = output_size
    if h * w * 3 >= 2**31 or ho * wo * 3 >= 2**31:
        raise ValueError("one source image and one crop must each hold fewer than 2^31 bytes")
    out = torch.empty((f, ho, wo, 3), dtype=torch.uint8, device=dev)
    if f == 0 or n == 0 or h == 0 or w == 0 or ho == 0 or wo == 0:
        return out.zero_()
    mats = matrices.contiguous()
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.fcpt_warp_affine_u8(
            images.data_ptr(),
            mats.data_ptr(),
            img_idx.data_ptr(),
            None if windows is None else windows.data_ptr(),
            out.data_ptr(),
            n, h, w, f, ho, wo,
            BORDER_MODES.index(border_mode),
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(lib, err, "warp_affine_u8")
    launches += 1
    return out


def gather2d(src: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    """``out[i, j] = src[idx[i, j], j]`` (axis 0) or ``src[i, idx[i, j]]`` (axis 1).

    Args:
        src: float32 (h, w).
        idx: int32 (h, w) indices, in range (not checked: on the card the
            kernel clamps them, which keeps it memory-safe).
        axis: 0 or 1.

    Returns:
        float32 (h, w): the kernel's on CUDA, ``torch.gather``'s on the CPU.
    """
    global gather2d_launches
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 or 1, got {axis}")
    if src.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError(f"expected float32 src and int32 idx, got {src.dtype}, {idx.dtype}")
    if src.dim() != 2 or idx.shape != src.shape:
        raise ValueError(
            f"expected src and idx of one (h, w) shape, got {tuple(src.shape)}, "
            f"{tuple(idx.shape)}"
        )
    dev = _check_device({"src": src, "idx": idx})
    if dev.type == "cpu":
        return torch.gather(src, axis, idx.long())
    h, w = src.shape
    out = torch.empty_like(src)
    if h == 0 or w == 0:
        return out
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.fcpt_gather2d(
            src.data_ptr(), idx.data_ptr(), out.data_ptr(), h, w, axis,
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(lib, err, "gather2d")
    gather2d_launches += 1
    return out
