"""Tensor operations of the port: plain PyTorch, and the CUDA kernels under ``cuda``."""

from .anchors import anchor_grid, num_anchors
from .nms import greedy_nms_mask, iou_matrix_plus1, select_faces
from .transform import estimate_affine, estimate_similarity, invert_affine
from .warp import BORDER_MODES, to_uint8, warp_affine_batch

__all__ = [
    "BORDER_MODES",
    "anchor_grid",
    "estimate_affine",
    "estimate_similarity",
    "greedy_nms_mask",
    "invert_affine",
    "iou_matrix_plus1",
    "num_anchors",
    "select_faces",
    "to_uint8",
    "warp_affine_batch",
]
