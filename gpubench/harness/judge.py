"""Comparisons that decide ``correct``, and the trees they read.

Every number compared has a limit in ``limits/<cell>.json``; a number
with the limit ``null`` is printed for the record and decides nothing.
"""

from __future__ import annotations

import os

import numpy as np


def diff_share(got: np.ndarray, want: np.ndarray) -> float:
    """Share of ``got``'s bytes that differ from ``want``'s (1 when the
    shapes differ or ``got`` is missing)."""
    if got is None or got.shape != want.shape:
        return 1.0
    return float(np.count_nonzero(got != want)) / max(1, want.size)


def encoded(image: np.ndarray, rel: str) -> np.ndarray:
    """An RGB uint8 image as the package's writer leaves it on disk for the
    file name ``rel``, decoded again (BGR): cv2's encoder with its
    defaults, chosen by the extension."""
    import cv2

    img = cv2.cvtColor(image, cv2.COLOR_RGB2BGR)
    ok, buf = cv2.imencode(os.path.splitext(rel)[1], np.ascontiguousarray(img))
    if not ok:
        raise RuntimeError(f"could not encode {rel}")
    return cv2.imdecode(buf, cv2.IMREAD_UNCHANGED)


def read_decoded(path: str):
    import cv2

    return cv2.imread(path, cv2.IMREAD_UNCHANGED) if os.path.isfile(path) else None


def listing(root: str) -> list[str]:
    """Every file under ``root``, by path relative to it."""
    out = []
    for d, _, files in os.walk(root):
        out.extend(os.path.relpath(os.path.join(d, f), root) for f in files)
    return sorted(out)


def tree_bytes(root: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root) for f in fs)


def write_tree(root: str, tree: dict):
    """Writes a reference tree ({file name: RGB crop}) as the package
    writes its files: cv2's encoder by extension."""
    import cv2

    os.makedirs(root, exist_ok=True)
    for rel, image in tree.items():
        img = cv2.cvtColor(image, cv2.COLOR_RGB2BGR)
        if not cv2.imwrite(os.path.join(root, rel), np.ascontiguousarray(img)):
            raise OSError(f"could not write {rel}")


def verdict(checks: dict) -> bool:
    """Whether every number is within its limit."""
    return all(limit is None or value <= limit for value, limit in checks.values())
