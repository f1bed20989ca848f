"""Bucketing helpers.

The JAX package pads request batches to a fixed size (``pad_batch_to``)
because XLA compiles one program per shape; eager PyTorch runs any batch
size, and every image's result is independent of the others in its batch,
so the port does not pad.
"""

from __future__ import annotations


def next_pow2(n: int, lo: int = 1) -> int:
    """Smallest power-of-two multiple of ``lo`` that is >= n (>= lo).

    The growth policy for the detector's candidate and face caps.
    """
    b = lo
    while b < n:
        b *= 2
    return b
