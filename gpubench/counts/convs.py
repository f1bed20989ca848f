"""Multiply-adds of a convolution and of dense bilinear resizes."""

from __future__ import annotations


def out_size(n: int, kernel: int, stride: int = 1, padding: int | None = None) -> int:
    """Output length of a convolution or pooling along one axis."""
    pad = kernel // 2 if padding is None else padding
    return (n + 2 * pad - kernel) // stride + 1


def conv_macs(h: int, w: int, cin: int, cout: int, kernel: int, stride: int = 1,
              padding: int | None = None) -> tuple[int, int, int]:
    """(multiply-adds, out h, out w) of one convolution of an h×w input."""
    oh, ow = out_size(h, kernel, stride, padding), out_size(w, kernel, stride, padding)
    return oh * ow * cin * cout * kernel * kernel, oh, ow


def resize_macs(h: int, w: int, oh: int, ow: int, channels: int) -> int:
    """Multiply-adds of a separable resize done as two dense products:
    rows (oh × h) over every column, then columns (ow × w) over the new
    rows."""
    return channels * (oh * h * w + oh * ow * w)
