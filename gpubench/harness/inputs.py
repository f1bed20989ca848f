"""The one generator of every traffic mix's inputs, driven by its data.

Images are smooth, photo-like RGB: a coarse uniform grid of ``cell``
pixels upsampled bilinearly, plus Gaussian noise of ``noise`` levels,
rounded to uint8.  They are drawn on the device from the run's seed in
one call a shape, so the same seed gives the same pixels.  Directories
hold them as JPEGs (cv2, its default quality 95).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .weights import generator

def images(seed: int, stream: int, n: int, h: int, w: int, content: dict, device) -> np.ndarray:
    """(n, h, w, 3) uint8 host images (see the module docstring)."""
    if n == 0:
        return np.zeros((0, h, w, 3), np.uint8)
    cell = int(content.get("cell", 8))
    g = generator(seed, device, stream)
    coarse = torch.rand((n, 3, h // cell + 2, w // cell + 2), generator=g, device=device) * 255.0
    up = torch.nn.functional.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=False)
    noise = float(content.get("noise", 0.0))
    if noise:
        up = up + torch.randn(up.shape, generator=g, device=device) * noise
    out = torch.clamp(torch.round(up), 0, 255).to(torch.uint8).permute(0, 2, 3, 1)
    return out.contiguous().cpu().numpy()


def request_pool(traffic: dict, seed: int, device) -> np.ndarray:
    """(distinct requests, images a request, h, w, 3) uint8 request batches."""
    h, w = traffic["image_hw"]
    n, k = traffic["distinct_requests"], traffic["request_images"]
    return images(seed, 10, n * k, h, w, traffic["content"], device).reshape(n, k, h, w, 3)


def directory_names(traffic: dict) -> list[tuple[str, tuple[int, int]]]:
    """(file name, (h, w)) of every file of a directory mix, sorted.

    ``files`` JPEGs of ``image_hw`` are named ``img_NNNN.jpg``; each size
    of ``other_sizes`` gets one JPEG named after a uniform file spread
    evenly through the listing, so no file batch holds two of them.
    """
    n = traffic["files"]
    names = [(f"img_{i:05d}.jpg", tuple(traffic["image_hw"])) for i in range(n)]
    others = traffic.get("other_sizes", [])
    step = max(1, n // (len(others) + 1))
    for j, hw in enumerate(others):
        names.append((f"img_{(j + 1) * step:05d}_r.jpg", tuple(hw)))
    return sorted(names)


def write_directory(path: str, traffic: dict, seed: int, device) -> list[str]:
    """Writes a directory mix's JPEGs into ``path``; returns the names."""
    import cv2

    os.makedirs(path, exist_ok=True)
    files = directory_names(traffic)
    by_size: dict = {}
    for name, hw in files:
        by_size.setdefault(hw, []).append(name)
    for stream, (hw, names) in enumerate(sorted(by_size.items())):
        pixels = images(seed, 20 + stream, len(names), hw[0], hw[1], traffic["content"], device)
        for name, img in zip(names, pixels):
            if not cv2.imwrite(os.path.join(path, name), cv2.cvtColor(img, cv2.COLOR_RGB2BGR)):
                raise OSError(f"could not write {name}")
    return [name for name, _ in files]
