"""RetinaFace under strategy "largest": per image, the kept face of
largest box area (none where nothing is kept)."""

from __future__ import annotations

import torch

from ...counts import retinaface as counts
from .. import retinaface

SERVED_BY = {"retinaface": "det_model"}


def networks(model: dict) -> dict:
    return {"retinaface": retinaface.RetinaFaceNet(model)}


def faces(nets: dict, model: dict, images: torch.Tensor, interim: tuple[int, int],
          threshold: float):
    lm, found = retinaface.detect_largest(nets["retinaface"], model, images, interim, threshold)
    idx = torch.nonzero(found).flatten()
    return lm[idx], idx


def image_flop(h: int, w: int, interim: tuple[int, int], model: dict) -> int:
    return counts.image_flop(h, w, interim[0], interim[1], model)
