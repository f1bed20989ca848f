"""Batched closed-form alignment-transform estimation (PyTorch).

Counterpart of ``face_crop_plus_tpu.ops.transform``: the least-squares fits
that OpenCV's ``estimateAffinePartial2D`` / ``estimateAffine2D`` compute
without RANSAC, in closed form for the whole face batch, plus the batched
inverse.  Transforms are 2x3 matrices ``M = [A | t]`` mapping source pixel
coordinates to destination coordinates, as in OpenCV.
"""

from __future__ import annotations

import torch


def _as_pair(src, dst) -> tuple[torch.Tensor, torch.Tensor]:
    src = torch.as_tensor(src, dtype=torch.float32)
    dst = torch.as_tensor(dst, dtype=torch.float32, device=src.device)
    return src, dst.broadcast_to(src.shape)


def estimate_similarity(src, dst) -> tuple[torch.Tensor, torch.Tensor]:
    """Least-squares 4-DOF similarity transform (rotation+scale+translation).

    Args:
        src: Source points of shape (..., L, 2).
        dst: Destination points of shape (..., L, 2) or (L, 2) (broadcast).

    Returns:
        The transform batch (..., 2, 3) and a validity mask (...,) that is
        False where the fit is degenerate (coincident source points or a
        vanishing rotation-scale).
    """
    src, dst = _as_pair(src, dst)
    src_mean = src.mean(dim=-2)
    dst_mean = dst.mean(dim=-2)
    s = src - src_mean[..., None, :]
    d = dst - dst_mean[..., None, :]

    denom = (s * s).sum(dim=(-1, -2))
    valid = denom > 1e-12
    safe = torch.where(valid, denom, torch.ones_like(denom))

    a = (s * d).sum(dim=(-1, -2)) / safe
    b = (s[..., 0] * d[..., 1] - s[..., 1] * d[..., 0]).sum(dim=-1) / safe

    tx = dst_mean[..., 0] - (a * src_mean[..., 0] - b * src_mean[..., 1])
    ty = dst_mean[..., 1] - (b * src_mean[..., 0] + a * src_mean[..., 1])

    row0 = torch.stack([a, -b, tx], dim=-1)
    row1 = torch.stack([b, a, ty], dim=-1)
    valid = valid & (a * a + b * b > 1e-12)
    return torch.stack([row0, row1], dim=-2), valid


def estimate_affine(src, dst) -> tuple[torch.Tensor, torch.Tensor]:
    """Least-squares 6-DOF affine transform (allows skew).

    Centered, scale-normalized normal equations reduce to a 2x2 solve.

    Args:
        src: Source points of shape (..., L, 2).
        dst: Destination points of shape (..., L, 2) or (L, 2) (broadcast).

    Returns:
        The transform batch (..., 2, 3) and a validity mask (...,) that is
        False where the source points are collinear/degenerate or the fitted
        linear part is singular.
    """
    src, dst = _as_pair(src, dst)
    src_mean = src.mean(dim=-2)
    dst_mean = dst.mean(dim=-2)
    s = src - src_mean[..., None, :]
    d = dst - dst_mean[..., None, :]

    scale = torch.sqrt((s * s).sum(dim=(-1, -2)) / s.shape[-2])
    valid_scale = scale > 1e-6
    safe_scale = torch.where(valid_scale, scale, torch.ones_like(scale))[..., None, None]
    s = s / safe_scale

    sts = torch.einsum("...li,...lj->...ij", s, s)  # (..., 2, 2)
    std = torch.einsum("...li,...lj->...ij", s, d)  # rows = src dims

    det = sts[..., 0, 0] * sts[..., 1, 1] - sts[..., 0, 1] * sts[..., 1, 0]
    valid = valid_scale & (torch.abs(det) > 1e-8)
    safe_det = torch.where(valid, det, torch.ones_like(det))

    inv = torch.stack(
        [
            torch.stack([sts[..., 1, 1] / safe_det, -sts[..., 0, 1] / safe_det], dim=-1),
            torch.stack([-sts[..., 1, 0] / safe_det, sts[..., 0, 0] / safe_det], dim=-1),
        ],
        dim=-2,
    )

    # A = (S^T S)^-1 (S^T D), transposed to map column vectors; undo scaling.
    a = torch.einsum("...ij,...jk->...ik", inv, std).transpose(-1, -2)
    a = a / safe_scale

    t = dst_mean - torch.einsum("...ij,...j->...i", a, src_mean)
    m = torch.cat([a, t[..., None]], dim=-1)  # (..., 2, 3)
    det_a = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
    valid = valid & (torch.abs(det_a) > 1e-12)
    return m, valid


def invert_affine(m: torch.Tensor) -> torch.Tensor:
    """Inverts a batch of 2x3 affine transforms ``[A | t] -> [A^-1 | -A^-1 t]``."""
    a, b, tx = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    c, d, ty = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    det = a * d - b * c
    # Sign-preserving epsilon: replacing a small *negative* det with +1e-12
    # would flip the sign of every inverse coefficient (mirrored output).
    eps = torch.where(det < 0, -1e-12, 1e-12).to(det.dtype)
    det = torch.where(torch.abs(det) < 1e-12, eps, det)
    ia, ib = d / det, -b / det
    ic, id_ = -c / det, a / det
    itx = -(ia * tx + ib * ty)
    ity = -(ic * tx + id_ * ty)
    row0 = torch.stack([ia, ib, itx], dim=-1)
    row1 = torch.stack([ic, id_, ity], dim=-1)
    return torch.stack([row0, row1], dim=-2)
