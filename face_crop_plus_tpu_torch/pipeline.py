"""Detect → align → crop for uniform batches, on one device (PyTorch).

Counterpart of the single-dispatch path of
``face_crop_plus_tpu.pipeline.FusedPipeline``: uint8 images go up once, and

    [resize+pad → detect → NMS/strategy → similarity fit → warp crop]

runs on the device; only uint8 crops, landmarks and validity (plus the
small cap diagnostics the growth policy reads) come back to the host.  Crops
sample the original-resolution sources (``crop_source="original"``).

Strategy "all" (the two-program path), ``crop_source="interim"``, packed
4:2:0 uploads, enhancement and meshes are not ported yet and raise
``NotImplementedError``.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .models.detection import decode_detections, preprocess, retinaface_forward
from .ops.anchors import anchor_grid
from .ops.nms import select_faces
from .ops.nn import resize_bilinear
from .ops.transform import estimate_affine, estimate_similarity
from .ops.warp import to_uint8, warp_affine_batch


def interim_geometry(
    h: int, w: int, size: tuple[int, int]
) -> tuple[float, tuple[int, int, int, int]]:
    """Scale factor and (top, bottom, left, right) padding of the resize.

    For an (h, w) source and ``size`` = (width, height) target: the
    aspect-preserving fit, centered with zero padding.
    """
    tw, th = size
    if tw * h < th * w:
        scale = tw / w
        rw, rh = tw, int(h * scale)
    else:
        scale = th / h
        rw, rh = int(w * scale), th
    return scale, ((th - rh) // 2, (th - rh + 1) // 2, (tw - rw) // 2, (tw - rw + 1) // 2)


def device_resize_pad(
    images: torch.Tensor, size: tuple[int, int]
) -> tuple[torch.Tensor, float, tuple[int, int, int, int]]:
    """Aspect-preserving resize + centered zero pad of a uniform batch.

    Returns the padded float32 (N, size[1], size[0], C) batch, the scale
    factor and the (top, bottom, left, right) padding (shared: uniform
    inputs).  The zero borders fold into the resize products.
    """
    n, h, w, c = images.shape
    scale, pad = interim_geometry(h, w, size)
    t, b, l, r = pad
    hh, ww = size[1] - t - b, size[0] - l - r
    x = resize_bilinear(images.to(torch.float32), (hh, ww), pad=((t, b), (l, r)))
    return x, scale, pad


class FusedPipeline:
    """Detect→align→crop executor for uniform batches (strategies best/largest).

    ``stage_timer``, when set, is called with a stage name and must return a
    context manager; each stage of :meth:`process` runs inside it
    ("resize_pad", "network", "select", "fit_warp", "to_host").
    """

    STAGES = ("resize_pad", "network", "select", "fit_warp", "to_host")

    def __init__(
        self,
        det_model,
        target_landmarks: np.ndarray,
        output_size: tuple[int, int],
        border_mode: str,
        allow_skew: bool = False,
    ):
        self.det = det_model
        self.target = np.asarray(target_landmarks, np.float32)
        self.output_size = tuple(output_size)
        self.border_mode = border_mode
        self.allow_skew = allow_skew
        self.stage_timer = None

    @property
    def device(self) -> torch.device:
        return self.det.device

    def _stage(self, name: str):
        return contextlib.nullcontext() if self.stage_timer is None else self.stage_timer(name)

    def _run(self, images: torch.Tensor, interim_h: int, interim_w: int, args: dict):
        """uint8 (N, H, W, 3) device batch → (crops u8, landmarks, valid, caps).

        Landmarks are (N, 5, 2) in source-image coordinates; the face grid
        equals the image batch (one face slot per image).
        """
        if args["strategy"] not in ("best", "largest"):
            raise NotImplementedError(
                f"strategy {args['strategy']!r} is not ported yet (best/largest only)"
            )
        n, h, w, _ = images.shape
        with self._stage("resize_pad"):
            if (h, w) != (interim_h, interim_w):
                interim, scale, pad = device_resize_pad(images, (interim_w, interim_h))
            else:
                interim, scale, pad = images.to(torch.float32), 1.0, (0, 0, 0, 0)

        with self._stage("network"):
            x = preprocess(interim)
            scores2, loc, ldm = retinaface_forward(self.det.net, x)

        with self._stage("select"):
            priors = torch.tensor(anchor_grid(interim_h, interim_w), device=self.device)
            boxes, landms = decode_detections(
                loc, ldm, priors, (interim_h, interim_w), args["variances"]
            )
            sel, valid, caps = select_faces(
                scores2[..., 1].float(),
                boxes,
                landms,
                vis_threshold=args["vis_threshold"],
                nms_threshold=args["nms_threshold"],
                pre_topk=args["pre_topk"],
                max_faces=args["max_faces"],
                strategy=args["strategy"],
            )  # sel: (N, 1, 10), valid: (N, 1), caps: (N, 2)

        with self._stage("fit_warp"):
            # Landmarks back to source-image coordinates: un-pad, un-scale.
            offset = torch.tensor([pad[2], pad[0]], dtype=torch.float32, device=self.device)
            scale_t = torch.tensor(scale, dtype=torch.float32, device=self.device)
            face_lm = (sel.reshape(n, 5, 2) - offset) / scale_t
            estimate = estimate_affine if self.allow_skew else estimate_similarity
            target = torch.from_numpy(self.target).to(self.device)
            mats, ok = estimate(face_lm, target)
            img_idx = torch.arange(n, device=self.device)
            crops = warp_affine_batch(
                images, mats, img_idx, self.output_size, self.border_mode
            )
            crops = to_uint8(crops)
        return crops, face_lm, valid.reshape(n) & ok, caps

    def process(self, images: np.ndarray, interim_size: tuple[int, int]):
        """Runs the batch; returns host (crops, landmarks, indices).

        Args:
            images: Uniform uint8 (N, H, W, 3) batch (original resolution).
            interim_size: Detector (width, height).

        Returns:
            Compacted uint8 crops (F, Ho, Wo, 3), float32 landmarks
            (F, 5, 2) in source coordinates, and int64 face→image indices.
        """
        iw, ih = interim_size
        imgs = torch.from_numpy(np.ascontiguousarray(images)).to(self.device)

        def dispatch(args):
            out = self._run(imgs, ih, iw, args)
            return out, out[-1]

        crops, face_lm, valid, _caps = self.det.dispatch_with_growth(
            dispatch, len(anchor_grid(ih, iw)), len(images)
        )
        with self._stage("to_host"):
            crops = crops.cpu().numpy()
            face_lm = face_lm.cpu().numpy()
            valid = valid.cpu().numpy()
        keep = np.nonzero(valid)[0]
        return crops[keep], face_lm[keep], keep.astype(np.int64)
