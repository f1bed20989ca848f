"""Building blocks of the plain reference networks, and their precision.

* Convolutions are ``nn.Conv2d`` (NCHW, OIHW); inference BatchNorm is a
  per-channel affine (``scale``, ``bias``), the folded form of
  γ/√(σ²+ε) and β−μ·γ/√(σ²+ε).
* Bilinear resizes are written as their interpolation matrices, one axis
  at a time (rows, then columns): the weights ``F.interpolate`` uses, as
  dense products.
* :func:`precision` runs a block in float32 with TF32 off (the
  configurations' stated precision) or with TF32 on (the control).  On the
  CPU, which has no TF32, the control rounds the operands of every
  convolution and matrix product to TF32's 10-bit mantissa instead.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

#: Whether the CPU emulates TF32 products (set only by :func:`precision`).
_EMULATE_TF32 = [False]


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to nearest-even at TF32's 10-bit mantissa."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = (bits + 0x0FFF + lsb) & ~0x1FFF
    return rounded.view(torch.float32)


@contextlib.contextmanager
def precision(mode: str):
    """Runs the block in ``"float32"`` (TF32 off) or ``"tf32"``.

    Sets both cuDNN's and cuBLAS's TF32 switches and restores them after.
    """
    if mode not in ("float32", "tf32"):
        raise ValueError(f"unknown precision {mode!r}")
    tf32 = mode == "tf32"
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
             _EMULATE_TF32[0])
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    _EMULATE_TF32[0] = tf32
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
         _EMULATE_TF32[0]) = saved


def _operand(x: torch.Tensor) -> torch.Tensor:
    if _EMULATE_TF32[0] and x.device.type == "cpu" and x.dtype == torch.float32:
        return round_tf32(x)
    return x


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` whose operands the CPU control rounds to TF32."""

    def forward(self, x):
        w = _operand(self.weight)
        b = None if self.bias is None else self.bias
        return F.conv2d(_operand(x), w, b, self.stride, self.padding, self.dilation, self.groups)


def conv(in_ch: int, out_ch: int, kernel: int = 3, stride: int = 1,
         padding: int | None = None, bias: bool = False) -> Conv2d:
    """A convolution padded by ``kernel // 2`` unless ``padding`` is given."""
    pad = kernel // 2 if padding is None else padding
    return Conv2d(in_ch, out_ch, kernel, stride=stride, padding=pad, bias=bias)


class Affine(nn.Module):
    """Inference BatchNorm: ``x * scale + bias`` per channel (NCHW)."""

    def __init__(self, channels: int):
        super().__init__()
        self.register_buffer("scale", torch.ones(channels))
        self.register_buffer("bias", torch.zeros(channels))

    def forward(self, x):
        return x * self.scale[:, None, None] + self.bias[:, None, None]


def einsum(spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.einsum(spec, _operand(a), _operand(b))


def bilinear_matrix(n_in: int, n_out: int, pad: tuple[int, int] = (0, 0)) -> np.ndarray:
    """(pad[0] + n_out + pad[1], n_in) float32 weights of a bilinear resize.

    Half-pixel centres (source ``(i + 0.5)·n_in/n_out − 0.5``, clamped into
    the image); each output row holds the two taps ``1 − frac`` and
    ``frac``.  ``pad`` adds rows of zeros: a zero border around the resized
    image.
    """
    rows = np.zeros((pad[0] + n_out + pad[1], n_in), np.float32)
    if n_in == n_out:
        rows[pad[0]: pad[0] + n_out] = np.eye(n_out, dtype=np.float32)
        return rows
    src = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    src = np.clip(src, 0.0, n_in - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    frac = src - lo
    body = np.zeros((n_out, n_in), np.float32)
    body[np.arange(n_out), lo] += (1.0 - frac).astype(np.float32)
    body[np.arange(n_out), hi] += frac.astype(np.float32)
    rows[pad[0]: pad[0] + n_out] = body
    return rows


def resize_bilinear_nhwc(x: torch.Tensor, size: tuple[int, int],
                         pad: tuple[tuple[int, int], tuple[int, int]] = ((0, 0), (0, 0))):
    """Bilinear resize of an NHWC float32 batch to ``size`` = (h, w), with
    an optional zero border ((top, bottom), (left, right)) around it."""
    h, w = x.shape[1], x.shape[2]
    my = torch.from_numpy(bilinear_matrix(h, size[0], pad=pad[0])).to(x.device)
    mx = torch.from_numpy(bilinear_matrix(w, size[1], pad=pad[1])).to(x.device)
    y = einsum("oh,nhwc->nowc", my, x)
    return einsum("pw,nhwc->nhpc", mx, y)
