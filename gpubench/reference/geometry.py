"""Plain alignment geometry: the target template, the similarity fit, the
affine warp with a constant border, and rounding to uint8.

* The template is the ArcFace-style 5-point set in [0, 1]², scaled by the
  face factor about the crop's centre.
* The fit is the closed-form least-squares similarity (OpenCV's
  ``estimateAffinePartial2D`` without RANSAC), in float32; a fit whose
  source points coincide is invalid.
* The warp samples each crop pixel bilinearly at the inverse-mapped source
  point, with zeros outside the image or outside a (top, left, height,
  width) window, as ``cv2.warpAffine`` with ``BORDER_CONSTANT`` does; the
  result rounds half to even and saturates to uint8.
"""

from __future__ import annotations

import numpy as np
import torch

TEMPLATE_5 = np.array(
    [[0.31556875000000000, 0.4615741071428571],
     [0.68262291666666670, 0.4615741071428571],
     [0.50026249999999990, 0.6405053571428571],
     [0.34947187500000004, 0.8246919642857142],
     [0.65343645833333330, 0.8246919642857142]], np.float32)


def target_landmarks(output_size: tuple[int, int], face_factor: float) -> np.ndarray:
    """(5, 2) float32 target points of an (width, height) crop."""
    t = TEMPLATE_5.copy()
    w, h = output_size
    t[:, 0] = t[:, 0] * w * face_factor + (1 - face_factor) * w / 2
    t[:, 1] = t[:, 1] * h * face_factor + (1 - face_factor) * h / 2
    return t


def fit_similarity(src, dst):
    """(F, 2, 3) similarity transforms source → crop and (F,) validity.

    ``src`` (F, 5, 2) and ``dst`` (5, 2), torch tensors or numpy arrays
    (the result follows ``src``'s kind); every step in float32.
    """
    lib = torch if torch.is_tensor(src) else np
    if lib is np:
        src = np.asarray(src, np.float32)
        dst = np.broadcast_to(np.asarray(dst, np.float32), src.shape)
        mean = lambda a, axis: a.mean(axis=axis)  # noqa: E731
        total = lambda a, axis: a.sum(axis=axis)  # noqa: E731
    else:
        dst = torch.as_tensor(dst, dtype=torch.float32, device=src.device).broadcast_to(src.shape)
        mean = lambda a, axis: a.mean(dim=axis)  # noqa: E731
        total = lambda a, axis: a.sum(dim=axis)  # noqa: E731
    sm, dm = mean(src, -2), mean(dst, -2)
    s, d = src - sm[..., None, :], dst - dm[..., None, :]
    denom = total(s * s, (-1, -2))
    valid = denom > 1e-12
    safe = lib.where(valid, denom, lib.ones_like(denom))
    a = total(s * d, (-1, -2)) / safe
    b = total(s[..., 0] * d[..., 1] - s[..., 1] * d[..., 0], -1) / safe
    tx = dm[..., 0] - (a * sm[..., 0] - b * sm[..., 1])
    ty = dm[..., 1] - (b * sm[..., 0] + a * sm[..., 1])
    stack = (lambda xs, axis: torch.stack(xs, dim=axis)) if lib is torch else np.stack
    m = stack([stack([a, -b, tx], -1), stack([b, a, ty], -1)], -2)
    return m, valid & (a * a + b * b > 1e-12)


def invert(m: torch.Tensor) -> torch.Tensor:
    """Inverses of (F, 2, 3) affine transforms."""
    a, b, tx = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    c, d, ty = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    det = a * d - b * c
    eps = torch.where(det < 0, -1e-12, 1e-12).to(det.dtype)
    det = torch.where(torch.abs(det) < 1e-12, eps, det)
    ia, ib, ic, id_ = d / det, -b / det, -c / det, a / det
    row0 = torch.stack([ia, ib, -(ia * tx + ib * ty)], dim=-1)
    row1 = torch.stack([ic, id_, -(ic * tx + id_ * ty)], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def warp_constant(images: torch.Tensor, m: torch.Tensor, img_idx: torch.Tensor,
                  output_size: tuple[int, int], windows: torch.Tensor | None = None):
    """uint8 crops (F, Ho, Wo, 3) of ``images`` (N, H, W, 3) by forward
    transforms ``m`` (F, 2, 3) of each face's image ``img_idx`` (F,).

    ``windows`` (F, 4) as (top, left, height, width): source coordinates
    are relative to the window and pixels outside it count as zero.
    """
    n, h, w, c = images.shape
    dev = images.device
    inv = invert(m.to(torch.float32))
    wo, ho = output_size
    gy, gx = torch.meshgrid(torch.arange(ho, dtype=torch.float32, device=dev),
                            torch.arange(wo, dtype=torch.float32, device=dev), indexing="ij")
    k = inv[:, :, :, None, None]
    sx = k[:, 0, 0] * gx + k[:, 0, 1] * gy + k[:, 0, 2]
    sy = k[:, 1, 0] * gx + k[:, 1, 1] * gy + k[:, 1, 2]
    bidx = img_idx.to(device=dev, dtype=torch.long)[:, None, None]
    if windows is None:
        # A ring of zeros around each image: taps outside read zero, and a
        # sample point more than a pixel outside is zero.
        src = torch.nn.functional.pad(images, (0, 0, 1, 1, 1, 1))
        inside = (sx > -1.0) & (sx < w) & (sy > -1.0) & (sy < h)
        x0, y0 = torch.floor(sx), torch.floor(sy)
        fx, fy = sx - x0, sy - y0
        ys = torch.clamp(y0.long() + 1, 0, h)
        xs = torch.clamp(x0.long() + 1, 0, w)
        out = (src[bidx, ys, xs].float() * ((1 - fx) * (1 - fy))[..., None]
               + src[bidx, ys, xs + 1].float() * (fx * (1 - fy))[..., None]
               + src[bidx, ys + 1, xs].float() * ((1 - fx) * fy)[..., None]
               + src[bidx, ys + 1, xs + 1].float() * (fx * fy)[..., None])
        out = out * inside[..., None].to(torch.float32)
    else:
        win = windows.to(device=dev, dtype=torch.long)
        top, left = win[:, 0, None, None], win[:, 1, None, None]
        eh, ew = win[:, 2, None, None], win[:, 3, None, None]
        x0, y0 = torch.floor(sx), torch.floor(sy)
        fx, fy = sx - x0, sy - y0
        x0, y0 = x0.long(), y0.long()
        out = torch.zeros(tuple(sx.shape) + (c,), dtype=torch.float32, device=dev)
        for dy in (0, 1):
            for dx in (0, 1):
                xi, yi = x0 + dx, y0 + dy
                xm = torch.minimum(torch.maximum(xi, torch.zeros_like(ew)), ew - 1) + left
                ym = torch.minimum(torch.maximum(yi, torch.zeros_like(eh)), eh - 1) + top
                wgt = (fx if dx else 1.0 - fx) * (fy if dy else 1.0 - fy)
                ok = (xi >= 0) & (xi < ew) & (yi >= 0) & (yi < eh)
                wgt = wgt * ok.to(torch.float32)
                out = out + images[bidx, ym, xm].float() * wgt[..., None]
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)
