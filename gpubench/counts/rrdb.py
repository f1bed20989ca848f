"""Multiply-adds of RRDBNet x4 at the widths of a configuration's
``model.enhancer`` block (``nf``, ``gc``, ``num_blocks``): its
convolutions only.  The enhancer's bicubic x0.25 back (60 multiply-adds an
output pixel) lies outside the network and its span, and is not counted."""

from __future__ import annotations

from .convs import conv_macs


def dense_block_macs(h: int, w: int, nf: int, gc: int) -> int:
    """One residual dense block: conv k reads nf + (k − 1)·gc channels."""
    return sum(conv_macs(h, w, nf + k * gc, nf if k == 4 else gc, 3)[0] for k in range(5))


def network_macs(h: int, w: int, enhancer: dict) -> int:
    """One h×w row through the network: ``conv_first``, 3 dense blocks an
    RRDB, ``trunk_conv`` at h×w; ``upconv1`` at 2h×2w; ``upconv2``,
    ``HRconv`` and ``conv_last`` at 4h×4w."""
    nf, gc = enhancer["nf"], enhancer["gc"]
    total = conv_macs(h, w, 3, nf, 3)[0] + conv_macs(h, w, nf, nf, 3)[0]
    total += 3 * enhancer["num_blocks"] * dense_block_macs(h, w, nf, gc)
    total += conv_macs(2 * h, 2 * w, nf, nf, 3)[0]
    return total + 2 * conv_macs(4 * h, 4 * w, nf, nf, 3)[0] + conv_macs(4 * h, 4 * w, nf, 3, 3)[0]


def row_flop(h: int, w: int, enhancer: dict) -> int:
    """FLOPs (2 × multiply-adds) of enhancing one h×w row."""
    return 2 * network_macs(h, w, enhancer)
