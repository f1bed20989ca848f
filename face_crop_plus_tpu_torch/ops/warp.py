"""Batched inverse affine warping with OpenCV-compatible border modes.

Counterpart of ``face_crop_plus_tpu.ops.warp``: every face of a batch is
warped out of its source image in one pass of index gathers, with border
arithmetic done in un-padded per-face *window coordinates*.  Written as
gathers rather than ``F.grid_sample``, whose padding modes do not reproduce
cv2's reflect/wrap/reflect_101 index maps.

Two sampling paths, as in the JAX package:

* **window path**: the four pixels of each bilinear window, exact for the
  modes whose extension is a remap of the *continuous* sample coordinate —
  ``replicate`` (clamp), ``reflect_101`` (continuous mirror) — and for
  ``constant`` without windows (1-pixel zero ring + fully-outside mask);
* **per-neighbour path**: four gathers with cv2's discrete index remap, for
  ``reflect``/``wrap`` and for ``constant`` with per-face windows.

Border semantics follow ``cv2.borderInterpolate``:

* ``constant``:     value 0 outside          ``...000|abcdefgh|000...``
* ``replicate``:    clamp                    ``aaaaaa|abcdefgh|hhhhhh``
* ``reflect``:      reflect incl. edge       ``fedcba|abcdefgh|hgfedc``
* ``wrap``:         periodic                 ``cdefgh|abcdefgh|abcdef``
* ``reflect_101``:  reflect excl. edge       ``gfedcb|abcdefgh|gfedcb``
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .transform import invert_affine

BORDER_MODES = ("constant", "replicate", "reflect", "wrap", "reflect_101")


def _clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    return torch.minimum(torch.maximum(x, torch.as_tensor(lo, device=x.device)),
                         torch.as_tensor(hi, device=x.device))


def _map_index(i: torch.Tensor, n: torch.Tensor, mode: str) -> torch.Tensor:
    """cv2 ``borderInterpolate``: maps out-of-range int indices into [0, n).

    For ``constant`` the index is only clamped for gather safety; the
    caller masks the value separately.
    """
    if mode in ("constant", "replicate"):
        return _clip(i, 0, n - 1)
    if mode == "wrap":
        return torch.remainder(i, n)
    if mode == "reflect":
        p = 2 * n
        j = torch.remainder(i, p)
        return torch.where(j >= n, p - 1 - j, j)
    if mode == "reflect_101":
        p = torch.clamp(2 * n - 2, min=1)
        j = torch.remainder(i, p)
        return torch.where(j >= n, p - j, j)
    raise ValueError(f"Unsupported border mode: {mode}")


def _map_coord(s: torch.Tensor, n: torch.Tensor, mode: str) -> torch.Tensor:
    """Continuous-coordinate border remap into [0, n-1] (window-path modes)."""
    nf = n.to(torch.float32)
    if mode == "replicate":
        return _clip(s, 0.0, nf - 1.0)
    if mode == "reflect_101":
        p = torch.clamp(2.0 * (nf - 1.0), min=1.0)
        sm = torch.remainder(s, p)
        # n == 1 collapses every coordinate to 0 (cv2 semantics).
        return torch.where(
            nf <= 1.0, torch.zeros_like(sm), torch.where(sm > nf - 1.0, p - sm, sm)
        )
    raise ValueError(mode)


def _source_coords(inv: torch.Tensor, output_size):
    """Per-face source-coordinate grids (F, Ho, Wo) for a dst grid."""
    wo, ho = output_size
    xs = torch.arange(wo, dtype=torch.float32, device=inv.device)
    ys = torch.arange(ho, dtype=torch.float32, device=inv.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    c = inv[:, :, :, None, None]
    sx = c[:, 0, 0] * gx + c[:, 0, 1] * gy + c[:, 0, 2]
    sy = c[:, 1, 0] * gx + c[:, 1, 1] * gy + c[:, 1, 2]
    return sx, sy


def warp_affine_batch(
    images: torch.Tensor,
    matrices: torch.Tensor,
    img_idx: torch.Tensor,
    output_size: tuple[int, int],
    border_mode: str = "constant",
    windows: torch.Tensor | None = None,
) -> torch.Tensor:
    """Warps F faces out of an image batch in one pass.

    Args:
        images: Source batch (N, H, W, C), any real dtype (uint8/float32);
            compute happens in float32.
        matrices: (F, 2, 3) forward transforms mapping *source* (un-padded
            window) coordinates to *destination* crop coordinates; inverted
            internally (same convention as ``cv2.warpAffine``).
        img_idx: (F,) index of the source image for each face.
        output_size: Destination (width, height).
        border_mode: One of :data:`BORDER_MODES`.
        windows: Optional (F, 4) per-face un-padded windows as (top, left,
            height, width) inside the padded source image.  When None the
            full image is the window.

    Returns:
        Float32 crops of shape (F, Ho, Wo, C).
    """
    if border_mode not in BORDER_MODES:
        raise ValueError(f"Unsupported border mode: {border_mode}")

    n, h, w, c = images.shape
    f = matrices.shape[0]
    dev = images.device
    inv = invert_affine(matrices.to(torch.float32))
    img_idx = img_idx.to(device=dev, dtype=torch.long)
    sx, sy = _source_coords(inv, output_size)  # (F, Ho, Wo)

    if windows is None:
        to = lo = 0
        eh = torch.full((f, 1, 1), h, dtype=torch.long, device=dev)
        ew = torch.full((f, 1, 1), w, dtype=torch.long, device=dev)
    else:
        windows = windows.to(device=dev, dtype=torch.long)
        to = windows[:, 0, None, None]
        lo = windows[:, 1, None, None]
        eh = windows[:, 2, None, None]
        ew = windows[:, 3, None, None]
    bidx = img_idx[:, None, None]

    fast_ok = border_mode in ("replicate", "reflect_101") or (
        border_mode == "constant" and windows is None
    )

    if fast_ok:
        if border_mode == "constant":
            # 1-pixel zero ring: partial-support edge pixels blend with true
            # zeros; fully-outside pixels are masked to zero afterwards.
            src = F.pad(images, (0, 0, 1, 1, 1, 1))
            inside = (sx > -1.0) & (sx < w) & (sy > -1.0) & (sy < h)
            x0 = torch.floor(sx)
            y0 = torch.floor(sy)
            fx = sx - x0
            fy = sy - y0
            ys = _clip(y0.long() + 1, 0, h)  # padded range [0, H+1], start <= H
            xs = _clip(x0.long() + 1, 0, w)
        else:
            src = images
            sxm = _map_coord(sx, ew, border_mode)
            sym = _map_coord(sy, eh, border_mode)
            x0 = torch.clamp(torch.minimum(torch.floor(sxm).long(), ew - 2), min=0)
            y0 = torch.clamp(torch.minimum(torch.floor(sym).long(), eh - 2), min=0)
            fx = sxm - x0
            fy = sym - y0
            # Clamp the absolute window start into the image and carry the
            # shift into the bilinear fraction (a 1-pixel window flush with
            # the far edge; these modes clamp coordinates into the window).
            ys_raw = y0 + to
            xs_raw = x0 + lo
            ys = _clip(ys_raw, 0, max(h - 2, 0))
            xs = _clip(xs_raw, 0, max(w - 2, 0))
            fy = fy + (ys_raw - ys).to(fy.dtype)
            fx = fx + (xs_raw - xs).to(fx.dtype)
            inside = None

        w00 = ((1 - fx) * (1 - fy))[..., None]
        w01 = (fx * (1 - fy))[..., None]
        w10 = ((1 - fx) * fy)[..., None]
        w11 = (fx * fy)[..., None]
        out = (
            src[bidx, ys, xs].float() * w00
            + src[bidx, ys, xs + 1].float() * w01
            + src[bidx, ys + 1, xs].float() * w10
            + src[bidx, ys + 1, xs + 1].float() * w11
        )
        if inside is not None:
            out = out * inside[..., None].to(torch.float32)
        return out

    # Exact per-neighbour path (reflect / wrap / constant-with-windows).
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = sx - x0
    fy = sy - y0
    x0 = x0.long()
    y0 = y0.long()

    out = torch.zeros((f,) + tuple(sx.shape[1:]) + (c,), dtype=torch.float32, device=dev)
    for dy in (0, 1):
        for dx in (0, 1):
            xi = x0 + dx
            yi = y0 + dy
            xm = _map_index(xi, ew, border_mode) + lo
            ym = _map_index(yi, eh, border_mode) + to
            val = images[bidx, ym, xm].float()
            wgt = (fx if dx else 1.0 - fx) * (fy if dy else 1.0 - fy)
            if border_mode == "constant":
                ok = (xi >= 0) & (xi < ew) & (yi >= 0) & (yi < eh)
                wgt = wgt * ok.to(torch.float32)
            out = out + val * wgt[..., None]
    return out


def to_uint8(x: torch.Tensor) -> torch.Tensor:
    """Rounds half-to-even and saturates float image data to uint8."""
    return torch.clamp(torch.round(x), 0, 255).to(torch.uint8)
