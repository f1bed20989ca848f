"""Anchor (prior box) grid of the face detector.

A copy of ``face_crop_plus_tpu.ops.anchors`` (pure numpy): the port keeps
its own so that it never imports the JAX package.  The grid is computed once
per input resolution and cached; the detector uploads it to its device.

Anchor layout parity: for each FPN level (strides 8/16/32 with min sizes
(16,32)/(64,128)/(256,512)), anchors are ordered row-major over the feature
grid with the per-cell min-sizes innermost — the order of the prediction
heads' NHWC → (H*W*anchors) reshape, so decode lines up.
Each anchor is (cx, cy, w, h), normalized by image size.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np

STRIDES = (8, 16, 32)
MIN_SIZES = ((16, 32), (64, 128), (256, 512))


@lru_cache(maxsize=32)
def anchor_grid(height: int, width: int) -> np.ndarray:
    """Returns the (A, 4) float32 normalized anchor grid for an input size.

    A = sum over levels of ceil(H/s) * ceil(W/s) * 2; at 1024x1024 this is
    43,008.
    """
    levels = []
    for stride, sizes in zip(STRIDES, MIN_SIZES):
        fh = math.ceil(height / stride)
        fw = math.ceil(width / stride)
        cy = (np.arange(fh, dtype=np.float32) + 0.5) * stride / height
        cx = (np.arange(fw, dtype=np.float32) + 0.5) * stride / width
        # (fh, fw, n_sizes, 4) with row-major grid, sizes innermost.
        grid_cy = np.broadcast_to(cy[:, None, None], (fh, fw, len(sizes)))
        grid_cx = np.broadcast_to(cx[None, :, None], (fh, fw, len(sizes)))
        aw = np.array([s / width for s in sizes], np.float32)
        ah = np.array([s / height for s in sizes], np.float32)
        grid_w = np.broadcast_to(aw[None, None, :], (fh, fw, len(sizes)))
        grid_h = np.broadcast_to(ah[None, None, :], (fh, fw, len(sizes)))
        level = np.stack([grid_cx, grid_cy, grid_w, grid_h], axis=-1)
        levels.append(level.reshape(-1, 4))
    out = np.concatenate(levels, axis=0)
    # The lru_cache hands this array out by reference; freeze it so an
    # accidental in-place mutation cannot poison every later detection.
    out.flags.writeable = False
    return out


def num_anchors(height: int, width: int) -> int:
    return sum(
        math.ceil(height / s) * math.ceil(width / s) * len(m)
        for s, m in zip(STRIDES, MIN_SIZES)
    )
