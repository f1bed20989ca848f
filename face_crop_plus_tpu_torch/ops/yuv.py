"""Packed YCbCr 4:2:0 rows: RGB → rows for JPEG-bound crops, rows → RGB.

Counterpart of ``face_crop_plus_tpu.ops.yuv``.  Every JPEG the pipeline
writes is 4:2:0: the encoder converts RGB to YCbCr (JFIF/BT.601 full
range) and averages chroma over 2x2 blocks before entropy coding.  Running
those two lossy stages before the device→host copy shrinks a crop to 1.5
bytes a pixel; the host feeds the planes straight to libjpeg's raw-data
encoder (``native/fcpt_io.cpp::fcpt_jpeg_encode_yuv420``).  The inverse,
:func:`yuv420_to_rgb`, reconstructs RGB on the device from sources decoded
to their stored planes (entropy decode and IDCT only), which cross the
host→device link at 1.5 bytes a pixel.

A packed row is the full-resolution Y plane followed by the 2x2-subsampled
Cb and Cr planes, each row-major: ``L = H*W + 2*(H//2)*(W//2)`` bytes.

The torch functions run on any device and are stock torch ops (the JAX
module is XLA ops, not a Pallas kernel).  Each elementwise step is its own
op in the order of the numpy twins, which are copies of the JAX package's:
every product and sum rounds to float32 once, so the torch results equal
the twins bit for bit on the CPU and on a CUDA card.
"""

from __future__ import annotations

import numpy as np
import torch


def packed_length(output_size: tuple[int, int]) -> int:
    """Packed bytes per crop for an (width, height) output size."""
    w, h = output_size
    return h * w + 2 * (h // 2) * (w // 2)


def _to_u8(v: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(v), 0, 255).to(torch.uint8)


def rgb_to_yuv420(crops: torch.Tensor) -> torch.Tensor:
    """uint8 RGB (F, H, W, 3) → packed planar YCbCr 4:2:0 uint8 (F, L).

    H and W must be even (callers gate on this).  Chroma is quantized to
    code levels before the 2x2 average, as libjpeg downsamples stored
    8-bit samples; every rounding is half to even.
    """
    f, h, w, _ = crops.shape
    x = crops.to(torch.float32)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = r * 0.299 + g * 0.587 + b * 0.114
    cb = (r * -0.168735892 - g * 0.331264108 + b * 0.5) + 128.0
    cr = (r * 0.5 - g * 0.418687589 - b * 0.081312411) + 128.0
    cb = torch.clamp(torch.round(cb), 0, 255)
    cr = torch.clamp(torch.round(cr), 0, 255)
    cb = cb.reshape(f, h // 2, 2, w // 2, 2).mean(dim=(2, 4))
    cr = cr.reshape(f, h // 2, 2, w // 2, 2).mean(dim=(2, 4))
    return torch.cat(
        [_to_u8(y).reshape(f, -1), _to_u8(cb).reshape(f, -1), _to_u8(cr).reshape(f, -1)],
        dim=1,
    )


def rgb_to_yuv420_np(crops: np.ndarray) -> np.ndarray:
    """Numpy twin of :func:`rgb_to_yuv420` (bit-identical float32 math).

    Packs host-resident crops (the staged leftovers of a batch whose fused
    crops come down packed), so one save call can mix both.
    """
    f, h, w, _ = crops.shape
    x = crops.astype(np.float32)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = np.float32(0.299) * r + np.float32(0.587) * g + np.float32(0.114) * b
    cb = np.float32(128.0) + (
        np.float32(-0.168735892) * r
        - np.float32(0.331264108) * g
        + np.float32(0.5) * b
    )
    cr = np.float32(128.0) + (
        np.float32(0.5) * r
        - np.float32(0.418687589) * g
        - np.float32(0.081312411) * b
    )
    cb = np.clip(np.rint(cb), 0, 255)
    cr = np.clip(np.rint(cr), 0, 255)
    cb = cb.reshape(f, h // 2, 2, w // 2, 2).mean(axis=(2, 4), dtype=np.float32)
    cr = cr.reshape(f, h // 2, 2, w // 2, 2).mean(axis=(2, 4), dtype=np.float32)
    to_u8 = lambda v: np.clip(np.rint(v), 0, 255).astype(np.uint8)  # noqa: E731
    return np.concatenate(
        [to_u8(y).reshape(f, -1), to_u8(cb).reshape(f, -1), to_u8(cr).reshape(f, -1)],
        axis=1,
    )


def _upsample2x(c: torch.Tensor) -> torch.Tensor:
    """2x chroma upsample with half-pixel centers (triangle filter).

    Output sample i reads chroma coordinate i/2 - 0.25: even outputs blend
    0.75*current + 0.25*previous, odd outputs 0.75*current + 0.25*next
    (edges clamped), libjpeg's "fancy" h2v2 weights in float.  Applied per
    axis on (..., H2, W2) tensors.
    """
    for ax in (-2, -1):
        c = c.movedim(ax, -1)
        prev = torch.cat([c[..., :1], c[..., :-1]], dim=-1)
        nxt = torch.cat([c[..., 1:], c[..., -1:]], dim=-1)
        even = c * 0.75 + prev * 0.25
        odd = c * 0.75 + nxt * 0.25
        c = torch.stack([even, odd], dim=-1).reshape(*c.shape[:-1], -1)
        c = c.movedim(-1, ax)
    return c


def _upsample2x_np(c: np.ndarray) -> np.ndarray:
    """Numpy twin of :func:`_upsample2x` (bit-identical float32 math)."""
    for ax in (-2, -1):
        c = np.moveaxis(c, ax, -1)
        prev = np.concatenate([c[..., :1], c[..., :-1]], axis=-1)
        nxt = np.concatenate([c[..., 1:], c[..., -1:]], axis=-1)
        even = np.float32(0.75) * c + np.float32(0.25) * prev
        odd = np.float32(0.75) * c + np.float32(0.25) * nxt
        c = np.stack([even, odd], axis=-1).reshape(c.shape[:-1] + (-1,))
        c = np.moveaxis(c, -1, ax)
    return np.ascontiguousarray(c)


def yuv420_to_rgb(packed: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Packed planar YCbCr 4:2:0 (N, L) → uint8 RGB (N, h, w, 3).

    The upload-side inverse of :func:`rgb_to_yuv420`: the chroma upsample
    and the BT.601 inverse that libjpeg would run on the host.  Pixels
    match ``cv2.imread`` (libjpeg's fixed-point upsampler over the same
    stored samples) within ~1 intensity level.
    """
    n = packed.shape[0]
    ylen, clen = h * w, (h // 2) * (w // 2)
    y = packed[:, :ylen].reshape(n, h, w).to(torch.float32)
    cb = packed[:, ylen : ylen + clen].reshape(n, h // 2, w // 2).to(torch.float32)
    cr = packed[:, ylen + clen :].reshape(n, h // 2, w // 2).to(torch.float32)
    cb = _upsample2x(cb) - 128.0
    cr = _upsample2x(cr) - 128.0
    r = y + cr * 1.402
    g = y - cb * 0.344136286 - cr * 0.714136286
    b = y + cb * 1.772
    return _to_u8(torch.stack([r, g, b], dim=-1))


def yuv420_to_rgb_np(packed: np.ndarray, h: int, w: int) -> np.ndarray:
    """Numpy twin of :func:`yuv420_to_rgb` (bit-identical float32 math).

    For packed sources that take a host path after all (staged leftovers
    of a fused run, host-crop warp sources).  A 1-D row gives one image.
    """
    packed = np.asarray(packed)
    squeeze = packed.ndim == 1
    if squeeze:
        packed = packed[None]
    n = packed.shape[0]
    ylen, clen = h * w, (h // 2) * (w // 2)
    y = packed[:, :ylen].reshape(n, h, w).astype(np.float32)
    cb = packed[:, ylen : ylen + clen].reshape(n, h // 2, w // 2).astype(np.float32)
    cr = packed[:, ylen + clen :].reshape(n, h // 2, w // 2).astype(np.float32)
    cb = _upsample2x_np(cb) - np.float32(128.0)
    cr = _upsample2x_np(cr) - np.float32(128.0)
    r = y + np.float32(1.402) * cr
    g = y - np.float32(0.344136286) * cb - np.float32(0.714136286) * cr
    b = y + np.float32(1.772) * cb
    out = np.clip(np.rint(np.stack([r, g, b], axis=-1)), 0, 255).astype(np.uint8)
    return out[0] if squeeze else out


def unpack_yuv420(packed: np.ndarray, output_size: tuple[int, int]):
    """Splits packed (F, L) rows into (y, cb, cr) planes (testing/tooling).

    Returns uint8 arrays of shapes (F, H, W), (F, H/2, W/2), (F, H/2, W/2).
    """
    w, h = output_size
    f = packed.shape[0]
    ylen, clen = h * w, (h // 2) * (w // 2)
    y = packed[:, :ylen].reshape(f, h, w)
    cb = packed[:, ylen : ylen + clen].reshape(f, h // 2, w // 2)
    cr = packed[:, ylen + clen :].reshape(f, h // 2, w // 2)
    return y, cb, cr
