"""Host-side ragged-image batching and bucketing helpers.

Counterpart of ``face_crop_plus_tpu.utils.batching``, every function of
it.  :func:`as_batch` normalises ragged images into one (N, H, W, 3)
interim batch on the host: an aspect-preserving resize
(``INTER_AREA`` to downscale, ``INTER_CUBIC`` to upscale; cv2 first, PIL
second, as the JAX module does) and a centred pad.  The staged detect path
runs on that batch.

:func:`pad_batch_to` pads a batch to a fixed size by repeating its last
row.  The JAX package pads every detector batch because XLA compiles one
program per shape.  Eager PyTorch runs any batch size, but cuDNN picks its
convolution algorithms by batch size, and some picks are slow: on an H100
the fused detector took 618 ms for 15 images of 218×178 at a 1024² interim
and 203 ms for 16 (``chip_smoke.py``, phase 5 (e)).  So the port pads the
fused path's groups to ``batch_size`` as the JAX package does, and the
staged path's batches to the smallest measured good size that holds them
(``cropper.STAGED_PAD_SIZES``: one image runs fastest alone).

:func:`as_numpy` and :func:`as_device` move image batches between the host
(uint8 NHWC numpy) and a device (float32 NHWC tensors); :func:`bucket_size`
picks a padded batch size from a fixed set.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device

try:  # pragma: no cover - environment dependent
    import cv2

    _HAS_CV2 = True
except ImportError:  # pragma: no cover
    cv2 = None
    _HAS_CV2 = False

#: Supported padding mode names (cv2 BorderTypes, lowercase).
PADDING_MODES = ("constant", "replicate", "reflect", "wrap", "reflect_101")


def _resize(image: np.ndarray, wh: tuple[int, int], upscale: bool) -> np.ndarray:
    if _HAS_CV2:
        interp = cv2.INTER_CUBIC if upscale else cv2.INTER_AREA
        return cv2.resize(image, wh, interpolation=interp)
    # Pillow fallback (BICUBIC both ways; AREA ~ BOX reduction).
    from PIL import Image

    resample = Image.BICUBIC if upscale else Image.BOX
    return np.asarray(Image.fromarray(image).resize(wh, resample))


def _pad(image: np.ndarray, tblr: list[int], mode: str) -> np.ndarray:
    t, b, l, r = tblr
    if _HAS_CV2:
        border = getattr(cv2, f"BORDER_{mode.upper()}")
        return cv2.copyMakeBorder(image, t, b, l, r, borderType=border)
    np_mode = {
        "constant": "constant",
        "replicate": "edge",
        "reflect": "symmetric",
        "wrap": "wrap",
        "reflect_101": "reflect",
    }[mode]
    pad_width = [(t, b), (l, r)] + [(0, 0)] * (image.ndim - 2)
    return np.pad(image, pad_width, mode=np_mode)


def as_batch(
    images: list[np.ndarray],
    size: int | tuple[int, int] = 512,
    padding_mode: str = "constant",
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stacks ragged images into a fixed-shape (N, H, W, 3) batch.

    Each image is resized (aspect preserved) so that it fits inside ``size``
    (given as (width, height)) and the short dimension is center-padded.

    Returns:
        Tuple of the uint8 image batch (N, H, W, 3), float32 un-scale factors
        (N,) mapping batch coordinates back to original-image coordinates, and
        int64 paddings (N, 4) in (top, bottom, left, right) order.
    """
    size = (size, size) if isinstance(size, int) else tuple(size)
    tw, th = size
    img_batch, unscales, paddings = [], [], []

    for image in images:
        h, w = image.shape[:2]
        # CUBIC unless the longest image side exceeds the longest target
        # side (the reference's rule); for non-square targets a mild
        # downscale can pick CUBIC, kept so resized pixels stay comparable.
        upscale = max(h, w) <= max(size)

        # The binding axis has the smaller target/source ratio, compared as
        # integer cross-products (tw/w < th/h ⟺ tw·h < th·w) so near-square
        # inputs cannot flip on float rounding.  It fills its target
        # dimension; the other scales by the same factor (truncated) and is
        # centered with the extra pixel below/right.
        if tw * h < th * w:
            scale = tw / w
            rw, rh = tw, int(h * scale)
        else:
            scale = th / h
            rw, rh = int(w * scale), th
        # Extreme aspect ratios can truncate the short side to 0 px: clamp
        # to 1 px so one pathological image cannot stop a directory run.
        rw, rh = max(rw, 1), max(rh, 1)
        top, left = (th - rh) // 2, (tw - rw) // 2
        pad = [top, th - rh - top, left, tw - rw - left]

        image = _pad(_resize(image, (rw, rh), upscale), pad, padding_mode)
        img_batch.append(image)
        unscales.append(np.float32(scale))
        paddings.append(np.asarray(pad, np.int64))

    return np.stack(img_batch), np.stack(unscales), np.stack(paddings)


def next_pow2(n: int, lo: int = 1) -> int:
    """Smallest power-of-two multiple of ``lo`` that is >= n (>= lo).

    The growth policy for the detector's candidate and face caps.
    """
    b = lo
    while b < n:
        b *= 2
    return b


def pad_batch_to(batch: np.ndarray, n: int) -> tuple[np.ndarray, int]:
    """Pads the leading axis of a batch up to ``n`` by repeating the last row.

    Counterpart of ``face_crop_plus_tpu.utils.batching.pad_batch_to``
    (``:152-168``).  Returns the padded batch and the original (valid)
    length.
    """
    valid = batch.shape[0]
    if valid == n:
        return batch, valid
    if valid > n:
        raise ValueError(f"Batch of {valid} does not fit bucket {n}")
    if valid == 0:
        return np.zeros((n,) + batch.shape[1:], batch.dtype), 0
    reps = np.repeat(batch[-1:], n - valid, axis=0)
    return np.concatenate([batch, reps], axis=0), valid


def as_numpy(images) -> np.ndarray | list[np.ndarray]:
    """Device image batch → host uint8 numpy (N, H, W, 3).

    Counterpart of the JAX ``as_numpy`` (the reference's ``as_numpy``,
    ``utils.py:170-196``): numpy inputs (or lists of them) pass through;
    tensors on any device, or lists of them, become uint8 host arrays.
    """
    if isinstance(images, list):
        if len(images) == 0 or isinstance(images[0], np.ndarray):
            return images
        return [x.detach().cpu().numpy().astype(np.uint8) for x in images]
    if isinstance(images, np.ndarray):
        return images
    return images.detach().cpu().numpy().astype(np.uint8)


def as_device(images, device=None):
    """Host image batch → float32 NHWC tensor on ``device``.

    Counterpart of the JAX ``as_device`` (the reference's ``as_tensor``,
    ``utils.py:198-226``): numpy arrays (or ragged lists of them) become
    float32 tensors on ``device``, which resolves as every entry point of
    the port resolves it (None: the card); tensors, and lists of them,
    pass through.
    """
    if isinstance(images, list):
        if len(images) and not isinstance(images[0], np.ndarray):
            return images
        dev = resolve_device(device)
        return [torch.as_tensor(x, dtype=torch.float32, device=dev) for x in images]
    if isinstance(images, np.ndarray):
        return torch.as_tensor(images, dtype=torch.float32, device=resolve_device(device))
    return images


def bucket_size(n: int, buckets: tuple[int, ...]) -> int:
    """Smallest bucket >= n; beyond the largest bucket, the next multiple of
    it (so ``pad_batch_to(batch, bucket_size(len(batch), buckets))`` always
    succeeds while the number of distinct shapes stays bounded)."""
    for b in buckets:
        if n <= b:
            return b
    top = buckets[-1]
    return -(-n // top) * top
