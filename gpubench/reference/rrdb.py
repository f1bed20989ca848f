"""Plain RRDBNet x4, ESRGAN's generator, and the gated enhancer's use of it.

The network is ``RRDBNet_arch.py`` of ESRGAN (Wang et al., 2018,
arXiv:1809.00219; github.com/xinntao/ESRGAN) as BSRGAN releases it at x4
(github.com/cszn/BSRGAN), the model face-crop-plus loads: ``conv_first``
(3 → ``nf``), ``num_blocks`` RRDBs, ``trunk_conv`` and a residual around
the trunk; two nearest x2 upsamples, each followed by a convolution
(``upconv1``, ``upconv2``), then ``HRconv`` and ``conv_last`` (``nf`` →
3).  An RRDB is three residual dense blocks and a residual scaled by 0.2;
a dense block is five 3x3 convolutions, the k-th reading the block's input
concatenated with the k − 1 outputs before it (``nf + (k − 1)·gc``
channels in, ``gc`` out; the fifth ``nf`` out), LeakyReLU 0.2 after the
first four, and its own residual scaled by 0.2.  Every convolution has a
bias; LeakyReLU 0.2 follows ``upconv1``, ``upconv2`` and ``HRconv``.
Widths come from a configuration's ``model.enhancer`` block (``nf``,
``gc``, ``num_blocks``, ``scale``); parameter names are the published
module paths, which the package under test keeps, so one state dict
serves both.

:func:`enhance` is face-crop-plus's use of the network on uint8 rows: /255,
the network, bicubic x0.25 back to the row's size (``F.interpolate``,
``align_corners=False``), clip to [0, 1], x255, round half to even.

Departures from the published description: none in the network (each
operation out of place, in float32); BSRGAN's ``sf`` argument is fixed at
4 (:func:`check_enhancer` refuses another scale).  The bicubic x0.25, the
clip and the rounding are the package's documented use, not part of the
release.  Against ``gpubench/tests/stubs/rrdb_gated.py``, which sketched
this module, the enhancer's input here is the rounded uint8 interim, as
the package (and face-crop-plus, whose interim is a uint8 image) feeds it,
where the sketch fed the unrounded float32 interim.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .nn import conv

SLOPE = 0.2
RESIDUAL = 0.2


def check_enhancer(enhancer: dict):
    """Raises ValueError unless this module builds ``enhancer`` as stated."""
    if enhancer.get("scale", 4) != 4:
        raise ValueError("RRDBNet reference: only the x4 release (two x2 upsamples) is built")
    if min(enhancer["nf"], enhancer["gc"], enhancer["num_blocks"]) < 1:
        raise ValueError("RRDBNet reference: nf, gc and num_blocks must be positive")


class DenseBlock(nn.Module):
    """Five convolutions over a growing concatenation; residual x0.2."""

    def __init__(self, nf: int, gc: int):
        super().__init__()
        for k in range(1, 6):
            setattr(self, f"conv{k}", conv(nf + (k - 1) * gc, nf if k == 5 else gc, bias=True))

    def forward(self, x):
        c = x
        for k in range(1, 5):
            c = torch.cat([c, F.leaky_relu(getattr(self, f"conv{k}")(c), SLOPE)], dim=1)
        return self.conv5(c) * RESIDUAL + x


class RRDB(nn.Module):
    """Three dense blocks with a residual x0.2 around them."""

    def __init__(self, nf: int, gc: int):
        super().__init__()
        self.RDB1, self.RDB2, self.RDB3 = (DenseBlock(nf, gc) for _ in range(3))

    def forward(self, x):
        return self.RDB3(self.RDB2(self.RDB1(x))) * RESIDUAL + x


class RRDBNet(nn.Module):
    """(N, 3, H, W) in [0, 1] → (N, 3, 4H, 4W), at the widths of
    ``enhancer``."""

    def __init__(self, enhancer: dict):
        super().__init__()
        check_enhancer(enhancer)
        nf, gc = enhancer["nf"], enhancer["gc"]
        self.conv_first = conv(3, nf, bias=True)
        self.RRDB_trunk = nn.Sequential(*[RRDB(nf, gc) for _ in range(enhancer["num_blocks"])])
        self.trunk_conv = conv(nf, nf, bias=True)
        self.upconv1 = conv(nf, nf, bias=True)
        self.upconv2 = conv(nf, nf, bias=True)
        self.HRconv = conv(nf, nf, bias=True)
        self.conv_last = conv(nf, 3, bias=True)

    def forward(self, x):
        fea = self.conv_first(x)
        fea = fea + self.trunk_conv(self.RRDB_trunk(fea))
        for up in (self.upconv1, self.upconv2):
            fea = F.leaky_relu(up(F.interpolate(fea, scale_factor=2, mode="nearest")), SLOPE)
        return self.conv_last(F.leaky_relu(self.HRconv(fea), SLOPE))


@torch.no_grad()
def enhance(net: RRDBNet, rows: torch.Tensor) -> torch.Tensor:
    """uint8 (N, H, W, 3) rows → enhanced uint8 (N, H, W, 3)."""
    hr = net(rows.permute(0, 3, 1, 2).to(torch.float32) / 255.0)
    lr = F.interpolate(hr, scale_factor=0.25, mode="bicubic", align_corners=False)
    out = torch.clamp(torch.round(torch.clamp(lr, 0.0, 1.0) * 255.0), 0, 255).to(torch.uint8)
    return out.permute(0, 2, 3, 1).contiguous()
