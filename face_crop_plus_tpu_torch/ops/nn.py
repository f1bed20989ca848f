"""NN primitives for the inference-only frozen networks (PyTorch).

Counterpart of ``face_crop_plus_tpu.ops.nn``.  The networks are
``nn.Module`` trees whose state-dict keys equal the JAX package's flat
parameter names (which mirror the reference's torch module paths), so one
``.npz`` weight contract serves both packages:

* The conv stack runs NCHW with OIHW kernels; images and resize inputs stay
  NHWC at the public boundaries, as in the JAX package.
* BatchNorm is inference-only and pre-folded to a per-channel
  ``scale``/``bias`` pair (γ/√(σ²+ε), β−μ·scale), held as buffers.
* Random init draws He-normal conv kernels, zero biases and unit BN scale
  from ``np.random.default_rng(seed)`` in parameter-creation order, the
  same draws the JAX package's ``Params`` init mode makes.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def conv(
    in_ch: int,
    out_ch: int,
    kernel: int = 3,
    stride: int = 1,
    padding: int | None = None,
    bias: bool = False,
) -> nn.Conv2d:
    """A 2D convolution with torch-style padding.

    ``padding=None`` means ``kernel // 2`` ("same" for odd kernels at
    stride 1), the JAX ``conv2d`` default.
    """
    pad = kernel // 2 if padding is None else padding
    return nn.Conv2d(in_ch, out_ch, kernel, stride=stride, padding=pad, bias=bias)


class FoldedBatchNorm(nn.Module):
    """Inference BatchNorm folded to per-channel ``scale``/``bias`` (NCHW)."""

    def __init__(self, channels: int):
        super().__init__()
        self.register_buffer("scale", torch.ones(channels))
        self.register_buffer("bias", torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale[:, None, None] + self.bias[:, None, None]


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.0) -> torch.Tensor:
    if negative_slope == 0.0:
        return torch.relu(x)
    return torch.where(x >= 0, x, x * negative_slope)


def max_pool(x: torch.Tensor, window: int, stride: int, padding: int) -> torch.Tensor:
    """Max pooling (NCHW) with -inf symmetric padding."""
    return F.max_pool2d(x, window, stride, padding)


def resize_nearest(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Torch-legacy nearest resize of an NCHW tensor: src = floor(i*in/out).

    Two axis gathers with the JAX package's float32 index arithmetic, so the
    source rows and columns are the same for any size ratio.
    """
    h, w = x.shape[2], x.shape[3]
    oh, ow = size
    dev = x.device
    iy = torch.floor(torch.arange(oh, dtype=torch.float32, device=dev) * (h / oh))
    ix = torch.floor(torch.arange(ow, dtype=torch.float32, device=dev) * (w / ow))
    return x[:, :, iy.long()][:, :, :, ix.long()]


def _linear_resize_matrix(
    n_in: int, n_out: int, align_corners: bool, pad: tuple[int, int] = (0, 0)
) -> np.ndarray:
    """Dense (n_out, n_in) bilinear interpolation matrix (one axis).

    ``pad`` embeds (before, after) rows of zeros around the interpolation
    rows, folding a zero pad of the resized output into the same product.
    """
    if pad != (0, 0):
        m = _linear_resize_matrix(n_in, n_out, align_corners)
        out = np.zeros((pad[0] + n_out + pad[1], n_in), dtype=np.float32)
        out[pad[0] : pad[0] + n_out] = m
        return out
    if n_in == n_out:
        return np.eye(n_out, dtype=np.float32)
    if align_corners:
        # torch uses scale (n_in-1)/(n_out-1), which degenerates to 0 for a
        # single output sample: the corner pixel, not the center.
        scale_ac = (n_in - 1) / (n_out - 1) if n_out > 1 else 0.0
        src = np.arange(n_out, dtype=np.float64) * scale_ac
    else:
        scale = n_in / n_out
        src = (np.arange(n_out, dtype=np.float64) + 0.5) * scale - 0.5
    src = np.clip(src, 0.0, n_in - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    frac = (src - lo).astype(np.float64)
    m = np.zeros((n_out, n_in), dtype=np.float32)
    m[np.arange(n_out), lo] += (1.0 - frac).astype(np.float32)
    m[np.arange(n_out), hi] += frac.astype(np.float32)
    return m


def resize_bilinear(
    x: torch.Tensor,
    size: tuple[int, int],
    align_corners: bool = False,
    pad: tuple[tuple[int, int], tuple[int, int]] | None = None,
) -> torch.Tensor:
    """Separable bilinear resize of an NHWC float tensor as two products.

    Matches ``F.interpolate(mode="bilinear", align_corners=...)`` sampling.
    ``pad`` = ((top, bottom), (left, right)) appends zero borders around the
    resized image inside the same products.  The interpolation matrices are
    the JAX package's, so the padded geometry is identical.
    """
    h, w = x.shape[1], x.shape[2]
    oh, ow = size
    py, px = pad if pad is not None else ((0, 0), (0, 0))
    my = torch.from_numpy(_linear_resize_matrix(h, oh, align_corners, tuple(py)))
    mx = torch.from_numpy(_linear_resize_matrix(w, ow, align_corners, tuple(px)))
    my = my.to(device=x.device, dtype=x.dtype)
    mx = mx.to(device=x.device, dtype=x.dtype)
    y = torch.einsum("oh,nhwc->nowc", my, x)
    return torch.einsum("pw,nhwc->nhpc", mx, y)


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return torch.softmax(x.float(), dim=dim).to(x.dtype)
