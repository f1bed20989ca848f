"""Batched greedy NMS and per-image strategy selection (PyTorch).

Counterpart of ``face_crop_plus_tpu.ops.nms``, with the same semantics bit
for bit:

1. The K highest-scoring candidates per image are pre-selected (scores at
   or below the visibility threshold are masked to -inf).  A stable
   descending sort keeps the lower anchor index first among equal scores,
   as ``lax.top_k`` does; ``torch.topk`` orders ties differently, which
   with saturated scores would select other candidates.
2. Exact greedy suppression over the score-sorted candidates: on a CUDA
   tensor the hand-written kernel (:mod:`.cuda.nms`), on a CPU tensor the
   plain version below (IoU matrix with the reference's +1 area convention,
   then a K-step loop of (N, K) updates).
3. Strategy reduction ("all"/"best"/"largest") is a masked argmax / ranked
   scatter over the keep mask, giving padded (N, F) outputs + validity.

``torch.maximum``/``torch.minimum`` propagate NaN like ``jnp.maximum``/
``jnp.minimum``; random-weight detectors produce NaN and inf boxes.
"""

from __future__ import annotations

import torch


def iou_matrix_plus1(boxes: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU with the reference's +1 area convention.

    Args:
        boxes: (..., K, 4) corner-form boxes (x1, y1, x2, y2).

    Returns:
        (..., K, K) IoU matrix.
    """
    x1, y1, x2, y2 = (boxes[..., i] for i in range(4))
    area = (x2 - x1 + 1.0) * (y2 - y1 + 1.0)

    ix1 = torch.maximum(x1[..., :, None], x1[..., None, :])
    iy1 = torch.maximum(y1[..., :, None], y1[..., None, :])
    ix2 = torch.minimum(x2[..., :, None], x2[..., None, :])
    iy2 = torch.minimum(y2[..., :, None], y2[..., None, :])

    zero = boxes.new_zeros(())
    iw = torch.maximum(zero, ix2 - ix1 + 1.0)
    ih = torch.maximum(zero, iy2 - iy1 + 1.0)
    inter = iw * ih
    union = area[..., :, None] + area[..., None, :] - inter
    return inter / torch.maximum(union, boxes.new_tensor(1e-12))


def greedy_nms_mask(
    iou: torch.Tensor, valid: torch.Tensor, threshold: float
) -> torch.Tensor:
    """Exact greedy NMS over score-sorted candidates (plain version).

    Args:
        iou: (N, K, K) pairwise IoU of score-descending candidates.
        valid: (N, K) bool candidate validity.
        threshold: Suppression IoU threshold (> threshold suppresses).

    Returns:
        (N, K) bool keep mask.
    """
    n, k, _ = iou.shape
    col = torch.arange(k, device=iou.device)
    keep = torch.ones_like(valid)
    for i in range(k):
        alive = keep[:, i] & valid[:, i]  # (N,)
        suppress = (iou[:, i, :] > threshold) & (col[None, :] > i)
        keep = keep & ~(suppress & alive[:, None])
    return keep & valid


def top_candidates(
    scores: torch.Tensor, vis_threshold: float, pre_topk: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Score-descending top-K candidate indices per image.

    Returns (indices (N, K) int64, valid (N, K) bool, n_above (N,) int32)
    with K = ``min(pre_topk, A)``; ties keep the lower anchor index first.
    """
    above = scores > vis_threshold
    s = scores.masked_fill(~above, float("-inf"))
    k = min(pre_topk, scores.shape[1])  # clamp for tiny inputs
    top_s, top_i = torch.sort(s, dim=1, descending=True, stable=True)
    top_s, top_i = top_s[:, :k], top_i[:, :k]
    return top_i, torch.isfinite(top_s), above.sum(dim=1).to(torch.int32)


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(x, idx[..., None], axis=1)`` for (N, A, C) x."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def select_faces(
    scores: torch.Tensor,
    boxes: torch.Tensor,
    landms: torch.Tensor,
    vis_threshold: float,
    nms_threshold: float = 0.4,
    pre_topk: int = 256,
    max_faces: int = 64,
    strategy: str = "all",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Thresholds, NMS-filters and strategy-selects faces for a whole batch.

    Args:
        scores: (N, A) face confidence per anchor.
        boxes: (N, A, 4) decoded corner-form boxes (pixel units).
        landms: (N, A, 10) decoded landmarks (pixel units).
        vis_threshold: Minimum confidence (reference ``vis``).
        nms_threshold: Greedy IoU suppression threshold.
        pre_topk: Per-image candidate cap before NMS.
        max_faces: Per-image output cap (only used for "all").
        strategy: "all" | "best" | "largest".

    Returns:
        Padded landmarks (N, F, 10) float32, validity (N, F) bool, where
        F = ``max_faces`` for "all" and 1 otherwise, and int32 cap
        diagnostics (N, 2): candidates above the visibility threshold and
        the raw NMS keep count, as in the JAX package.
    """
    from .cuda.nms import greedy_nms_mask_cuda  # imports this module

    top_i, valid, n_above = top_candidates(scores, vis_threshold, pre_topk)
    b = _take_rows(boxes, top_i)  # (N, K, 4)
    lm = _take_rows(landms, top_i)  # (N, K, 10)

    # Kernel on a CUDA tensor, plain version on a CPU tensor.
    keep = greedy_nms_mask_cuda(b.contiguous(), valid.contiguous(), nms_threshold)

    kept_raw = keep.sum(dim=1).to(torch.int32)  # (N,) pre-max_faces
    caps = torch.stack([n_above, kept_raw], dim=1)  # (N, 2)
    any_kept = keep.any(dim=1)

    if strategy == "best":
        # First kept candidate per image == highest score (argmax returns
        # the first maximum).
        idx = keep.to(torch.uint8).argmax(dim=1)
        return _take_rows(lm, idx[:, None]), any_kept[:, None], caps

    if strategy == "largest":
        area = (b[..., 2] - b[..., 0] + 1.0) * (b[..., 3] - b[..., 1] + 1.0)
        area = area.masked_fill(~keep, float("-inf"))
        idx = area.argmax(dim=1)  # first NaN wins, as with jnp.argmax
        return _take_rows(lm, idx[:, None]), any_kept[:, None], caps

    if strategy == "all":
        # Rank kept candidates (score order) and scatter into fixed slots;
        # slot ``max_faces`` collects the dropped rows and is cut off.
        rank = torch.cumsum(keep, dim=1) - 1  # (N, K)
        slot = torch.where(keep & (rank < max_faces), rank, max_faces)
        out = lm.new_zeros((scores.shape[0], max_faces + 1, 10))
        out.scatter_(1, slot[..., None].expand(-1, -1, 10), lm)
        counts = torch.clamp(kept_raw, max=max_faces)
        ar = torch.arange(max_faces, device=scores.device)
        return out[:, :max_faces], ar[None, :] < counts[:, None], caps

    raise ValueError(f"Unsupported strategy: {strategy}")
