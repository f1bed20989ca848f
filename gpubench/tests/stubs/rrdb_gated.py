"""A reference pipeline of two networks, for the harness's tests only: the
RetinaFace detector under "largest" with the package's gated RRDBNet x4
(``enh_threshold``) on the fused path of ``process_images``.

The tests copy it into a copy's ``reference/pipelines/`` and name it from a
configuration's ``"reference"``; it shows that the harness's contract
carries such a configuration with new files only: both networks served
(``SERVED_BY``), the crops of gated images judged from their enhanced
interim rows (``crops``), and the enhancer's rows counted
(``window_flop``).  The model block gives the enhancer's widths under
``"enhancer"`` (``nf``, ``gc``, ``num_blocks``).

The enhancer as the package documents it: each gated image's whole padded
interim (float32, unrounded) / 255 through the network at 4x, bicubic
x0.25 back (``F.interpolate``), clipped to [0, 1], x255 and rounded half to
even; its face fitted in interim pixels and warped from the enhanced row
inside the interim's un-padded window.  An image is gated when its face's
area factor (the right mouth corner less the left eye, in interim pixels,
over the whole padded interim) is at most ``enh_threshold``.
"""

from __future__ import annotations

import sys

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gpubench.counts import retinaface as det_counts
from gpubench.counts.convs import conv_macs
from gpubench.reference import retinaface
from gpubench.reference.nn import conv, resize_bilinear_nhwc

SERVED_BY = {"retinaface": "det_model", "rrdb": "enh_model"}
SLOPE = 0.2


class DenseBlock(nn.Module):
    def __init__(self, nf: int, gc: int):
        super().__init__()
        for k in range(1, 6):
            setattr(self, f"conv{k}", conv(nf + (k - 1) * gc, nf if k == 5 else gc, bias=True))

    def forward(self, x):
        c = x
        for k in range(1, 5):
            c = torch.cat([c, F.leaky_relu(getattr(self, f"conv{k}")(c), SLOPE)], dim=1)
        return self.conv5(c) * 0.2 + x


class RRDB(nn.Module):
    def __init__(self, nf: int, gc: int):
        super().__init__()
        self.RDB1, self.RDB2, self.RDB3 = (DenseBlock(nf, gc) for _ in range(3))

    def forward(self, x):
        return self.RDB3(self.RDB2(self.RDB1(x))) * 0.2 + x


class RRDBNet(nn.Module):
    """ESRGAN's generator: (N, 3, H, W) in [0, 1] → (N, 3, 4H, 4W)."""

    def __init__(self, enhancer: dict):
        super().__init__()
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


def rrdb_macs(h: int, w: int, enhancer: dict) -> int:
    """Multiply-adds of one h×w row through :class:`RRDBNet`."""
    nf, gc = enhancer["nf"], enhancer["gc"]
    dense = sum(conv_macs(h, w, nf + k * gc, nf if k == 4 else gc, 3)[0] for k in range(5))
    total = conv_macs(h, w, 3, nf, 3)[0] + 3 * enhancer["num_blocks"] * dense
    total += conv_macs(h, w, nf, nf, 3)[0] + conv_macs(2 * h, 2 * w, nf, nf, 3)[0]
    return total + 2 * conv_macs(4 * h, 4 * w, nf, nf, 3)[0] + conv_macs(4 * h, 4 * w, nf, 3, 3)[0]


def networks(model: dict) -> dict:
    return {"retinaface": retinaface.RetinaFaceNet(model), "rrdb": RRDBNet(model["enhancer"])}


def faces(nets: dict, model: dict, images: torch.Tensor, interim: tuple[int, int],
          threshold: float):
    lm, found = retinaface.detect_largest(nets["retinaface"], model, images, interim, threshold)
    idx = torch.nonzero(found).flatten()
    return lm[idx], idx


def image_flop(h: int, w: int, interim: tuple[int, int], model: dict) -> int:
    return det_counts.image_flop(h, w, interim[0], interim[1], model)


@torch.no_grad()
def enhance(net: RRDBNet, rows: torch.Tensor) -> torch.Tensor:
    """Float32 (N, H, W, 3) rows in [0, 255] → enhanced uint8 (N, H, W, 3)."""
    hr = net(rows.permute(0, 3, 1, 2) / 255.0)
    lr = F.interpolate(hr, scale_factor=0.25, mode="bicubic", align_corners=False)
    out = torch.clamp(torch.round(torch.clamp(lr, 0.0, 1.0) * 255.0), 0, 255).to(torch.uint8)
    return out.permute(0, 2, 3, 1).contiguous()


def crops(cell, nets: dict, images: torch.Tensor, offset=None, windows=None):
    if offset is not None or windows is not None:
        raise NotImplementedError("this pipeline judges the fused path of process_images")
    h, w = images.shape[1:3]
    ih = iw = cell.kw["resize_size"]
    lm, idx = faces(nets, cell.model, images, (ih, iw), cell.kw["det_threshold"])
    scale, (t, b, l, r) = ((1.0, (0, 0, 0, 0)) if (h, w) == (ih, iw)
                           else retinaface.interim_geometry(h, w, ih, iw))
    lm_interim = lm * scale
    wh = lm_interim[:, 4] - lm_interim[:, 0]
    gated = wh[:, 0] * wh[:, 1] / float(ih * iw) <= cell.kw["enh_threshold"]
    out, found = cell.warp_faces(images, lm[~gated], idx[~gated])
    n_plain = len(found)
    rows = idx[gated]
    if len(rows):
        interim = resize_bilinear_nhwc(images[rows].to(torch.float32), (ih - t - b, iw - l - r),
                                       pad=((t, b), (l, r)))
        window = torch.tensor([[t, l, ih - t - b, iw - l - r]], dtype=torch.int32,
                              device=images.device).expand(len(rows), 4)
        local = torch.arange(len(rows), device=images.device)
        enhanced, local = cell.warp_faces(enhance(nets["rrdb"], interim), lm_interim[gated],
                                          local, window)
        out = np.concatenate([out, enhanced])
        found = np.concatenate([found, rows.cpu().numpy()[local]])
    print(f"rrdb_gated crops: {n_plain} plain, {len(found) - n_plain} gated", file=sys.stderr)
    order = np.argsort(found, kind="stable")
    return out[order], found[order]


def window_flop(run, stats: dict) -> int:
    """The detector's real images, and every row the enhancer ran (a whole
    padded interim each)."""
    ih = iw = run.kw["resize_size"]
    det = sum(image_flop(h, w, (ih, iw), run.model) for h, w in run.images_done())
    rows = stats.get("enh_net", {}).get("items", 0)
    return det + rows * 2 * rrdb_macs(ih, iw, run.model["enhancer"])
