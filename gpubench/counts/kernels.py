"""The work bounds of the package's two hand-written kernels."""

from __future__ import annotations

#: float32 operations of one candidate pair in the greedy-NMS IoU test:
#: four max/min, two widths with +1, the intersection, the union (areas
#: included) and the comparison.
NMS_OPS_PER_PAIR = 20


def nms_ops(n: int, k: int) -> int:
    """Operations of one greedy-NMS launch over (n, k) score-sorted
    candidates: every pair i < j of an image tested once."""
    return NMS_OPS_PER_PAIR * n * k * (k - 1) // 2


def warp_bytes(faces: int, out_h: int, out_w: int) -> int:
    """Bytes one warp launch must move at least: its uint8 RGB crops
    written, and each face's 2×3 float32 transform and int32 image index
    read."""
    return faces * (out_h * out_w * 3 + 28)
