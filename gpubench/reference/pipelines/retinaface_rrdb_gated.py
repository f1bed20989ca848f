"""RetinaFace under strategy "largest", with the gated RRDBNet x4 enhancer
(``enh_threshold``) on the fused path of ``process_images``.

Per image of a uniform batch: the largest kept face (``retinaface.
detect_largest``).  The gate: the face's area factor, the (right mouth −
left eye) extent in interim pixels, width times height, over the whole
padded interim area, at most ``enh_threshold`` (an image without a face is
never gated).  Faces of other images warp from the source images.  A gated
image's interim row (the bilinear resize with its zero border, rounded to
uint8) goes through :func:`..rrdb.enhance`, and its face, fitted in
interim pixels, warps from the enhanced row inside the interim's un-padded
window.

The enhancer runs one row at a time in the package (its ``enh_batch_size``
is 1), so every row of the ``enh_net`` span is a real gated image, and
:func:`window_flop` counts no padding.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ...counts import rrdb as rrdb_counts
from .. import retinaface, rrdb
from ..nn import resize_bilinear_nhwc
from .retinaface_largest import faces, image_flop

SERVED_BY = {"retinaface": "det_model", "rrdb": "enh_model"}


def networks(model: dict) -> dict:
    return {"retinaface": retinaface.RetinaFaceNet(model),
            "rrdb": rrdb.RRDBNet(model["enhancer"])}


def geometry(h: int, w: int, interim: tuple[int, int]):
    """(scale, (top, bottom, left, right)) of an h×w image in the interim."""
    if (h, w) == tuple(interim):
        return 1.0, (0, 0, 0, 0)
    return retinaface.interim_geometry(h, w, *interim)


def gate_factors(lm: torch.Tensor, h: int, w: int, interim: tuple[int, int]) -> torch.Tensor:
    """The gate's face factor of each face, landmarks (F, 5, 2) in the
    source pixels of h×w images: its extent in interim pixels, width times
    height, over the padded interim area."""
    scale, _ = geometry(h, w, interim)
    wh = (lm[:, 4] - lm[:, 0]) * scale
    return wh[:, 0] * wh[:, 1] / float(interim[0] * interim[1])


def interim_rows(images: torch.Tensor, interim: tuple[int, int]) -> torch.Tensor:
    """uint8 (N, H, W, 3) → the uint8 interim rows (N, ih, iw, 3)."""
    h, w = images.shape[1:3]
    ih, iw = interim
    _, (t, b, l, r) = geometry(h, w, interim)
    x = images.to(torch.float32)
    if (h, w) != (ih, iw):
        x = resize_bilinear_nhwc(x, (ih - t - b, iw - l - r), pad=((t, b), (l, r)))
    return torch.clamp(torch.round(x), 0, 255).to(torch.uint8)


def crops(cell, nets: dict, images: torch.Tensor, offset=None, windows=None):
    """Plain faces warped from ``images``; gated faces from their enhanced
    interim rows, inside the interim's un-padded window.  Prints, for the
    judged batch, its plain and gated crops, and of its enhanced rows
    (inside the window) the share of bytes at 0 or 255 and the mean
    absolute difference from the un-enhanced interim, in levels."""
    if offset is not None or windows is not None:
        raise NotImplementedError("this pipeline judges the fused path of process_images")
    h, w = images.shape[1:3]
    interim = (cell.kw["resize_size"],) * 2
    lm, idx = faces(nets, cell.model, images, interim, cell.kw["det_threshold"])
    gated = gate_factors(lm, h, w, interim) <= cell.kw["enh_threshold"]
    out, found = cell.warp_faces(images, lm[~gated], idx[~gated])
    n_plain = len(found)
    rows = idx[gated]
    if len(rows):
        scale, (t, b, l, r) = geometry(h, w, interim)
        ih, iw = interim
        rows_u8 = interim_rows(images[rows], interim)
        enhanced = rrdb.enhance(nets["rrdb"], rows_u8)
        inner = (slice(None), slice(t, ih - b), slice(l, iw - r))
        e, x = enhanced[inner], rows_u8[inner]
        saturated = float(((e == 0) | (e == 255)).float().mean())
        moved = float((e.float() - x.float()).abs().mean())
        print(f"rrdb_gated enhanced: {len(rows)} rows, saturated share {saturated}, "
              f"mean |enhanced - interim| {moved} levels", file=sys.stderr)
        window = torch.tensor([[t, l, ih - t - b, iw - l - r]], dtype=torch.int32,
                              device=images.device).expand(len(rows), 4)
        local = torch.arange(len(rows), device=images.device)
        enh_crops, local = cell.warp_faces(enhanced, lm[gated] * scale, local, window)
        out = np.concatenate([out, enh_crops])
        found = np.concatenate([found, rows.cpu().numpy()[local]])
    print(f"rrdb_gated crops: {n_plain} plain, {len(found) - n_plain} gated", file=sys.stderr)
    order = np.argsort(found, kind="stable")
    return out[order], found[order]


def window_flop(run, stats: dict) -> int:
    """The detector's real images, and every row the enhancer ran (a whole
    padded interim each; none is padding at its batch of 1)."""
    interim = (run.kw["resize_size"],) * 2
    det = sum(image_flop(h, w, interim, run.model) for h, w in run.images_done())
    rows = stats.get("enh_net", {}).get("items", 0)
    return det + rows * rrdb_counts.row_flop(*interim, run.model["enhancer"])
