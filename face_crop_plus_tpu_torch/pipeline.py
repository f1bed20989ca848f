"""Detect → align → crop for uniform batches, on one device (PyTorch).

Counterpart of ``face_crop_plus_tpu.pipeline.FusedPipeline``: uint8 images
go up once, and

    [resize+pad → detect → NMS/strategy → similarity fit → warp crop]

runs on the device; only uint8 crops, landmarks and validity (plus the
small cap diagnostics the growth policy reads) come back to the host.

* Strategies "best"/"largest" run the single-dispatch path: one face slot
  per image, detect and warp in one pass (:meth:`FusedPipeline._run_core`).
* Strategy "all" runs the two-program path: a detect-only pass returns
  landmarks and validity, the host compacts the sparse (N, max_faces) face
  grid once, and chunked warps crop exactly the kept faces from the
  still-resident sources (:meth:`FusedPipeline._crop_selected_chunked`).

Crops sample the original-resolution sources (``crop_source="original"``)
or, for reference parity, the uint8 detector-resolution interim inside its
un-padded window (``crop_source="interim"``).  Every crop goes through the
warp kernel's wrapper (:func:`.ops.cuda.warp.warp_affine_u8`).

Packed 4:2:0 uploads, enhancement and meshes are not ported yet; the
Cropper refuses them.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .ops.anchors import num_anchors
from .ops.cuda.warp import warp_affine_u8
from .ops.nn import resize_bilinear
from .ops.transform import estimate_affine, estimate_similarity
from .ops.warp import to_uint8
from .utils.batching import next_pow2


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


def _to_host_async(tensors) -> tuple[tuple[torch.Tensor, ...], torch.cuda.Event | None]:
    """Starts device→host copies of ``tensors``; returns (host tensors, event).

    On a CUDA device the copies go into pinned buffers, enqueued with
    ``non_blocking=True`` on the current stream, and the returned event
    completes with them.  CPU tensors come back as they are, with no event.
    """
    if tensors[0].device.type != "cuda":
        return tuple(tensors), None
    host = []
    for t in tensors:
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t, non_blocking=True)
        host.append(buf)
    event = torch.cuda.Event()
    event.record()
    return tuple(host), event


class FusedPipeline:
    """Detect→align→crop executor for uniform batches.

    ``stage_timer``, when set, is called with a stage name and must return a
    context manager; each stage runs inside it (:attr:`STAGES`).  "compact"
    is the two-program path's host compaction (validity to the host, kept
    slots); "fit_warp" and "to_host" recur once per crop chunk there.
    """

    STAGES = ("resize_pad", "network", "select", "compact", "fit_warp", "to_host")

    #: Faces per crop dispatch on the two-program path: bounds the crop
    #: buffer of one chunk (512 × 256² × 3 B = 100.7 MB) whatever a crowd
    #: batch keeps.
    max_warp_chunk: int = 512

    def __init__(
        self,
        det_model,
        target_landmarks: np.ndarray,
        output_size: tuple[int, int],
        border_mode: str,
        allow_skew: bool = False,
        crop_source: str = "original",
    ):
        if crop_source not in ("original", "interim"):
            raise ValueError(f"unknown crop_source: {crop_source!r}")
        self.det = det_model
        self.target = np.asarray(target_landmarks, np.float32)
        self.output_size = tuple(output_size)
        self.border_mode = border_mode
        self.allow_skew = allow_skew
        #: Which pixels the crops sample: "original" (the full-resolution
        #: sources) or "interim" (the uint8 detector-resolution batch, the
        #: reference's sampling, for parity runs).
        self.crop_source = crop_source
        self.stage_timer = None

    @property
    def device(self) -> torch.device:
        return self.det.device

    def _stage(self, name: str):
        return contextlib.nullcontext() if self.stage_timer is None else self.stage_timer(name)

    def _estimate(self, lm: torch.Tensor):
        estimate = estimate_affine if self.allow_skew else estimate_similarity
        return estimate(lm, torch.from_numpy(self.target).to(lm.device))

    def _interim_window(self, h: int, w: int, interim_h: int, interim_w: int):
        """(scale, (top, left, height, width)) of the un-padded interim."""
        scale, (t, b, l, r) = interim_geometry(h, w, (interim_w, interim_h))
        return scale, (t, l, interim_h - t - b, interim_w - l - r)

    def _detect_trace(self, images: torch.Tensor, interim_h: int, interim_w: int, args: dict):
        """Detect stage shared by every path.

        uint8 (N, H, W, 3) device batch → (landmarks (N·K, 5, 2) in source
        image coordinates, validity (N·K,), cap diagnostics (N, 2), float32
        interim batch).  K is 1 for "best"/"largest" and ``max_faces`` for
        "all".  When the interim size differs from the input shape, the
        resize+pad runs on the device.
        """
        n, h, w, _ = images.shape
        with self._stage("resize_pad"):
            if (h, w) != (interim_h, interim_w):
                interim, scale, pad = device_resize_pad(images, (interim_w, interim_h))
            else:
                interim, scale, pad = images.to(torch.float32), 1.0, (0, 0, 0, 0)

        sel, valid, caps = self.det._detect(interim, args, self._stage)
        with self._stage("select"):
            k = sel.shape[1]
            # Landmarks back to source-image coordinates: un-pad, un-scale.
            offset = torch.tensor([pad[2], pad[0]], dtype=torch.float32, device=self.device)
            scale_t = torch.tensor(scale, dtype=torch.float32, device=self.device)
            face_lm = (sel.reshape(n * k, 5, 2) - offset) / scale_t
        return face_lm, valid.reshape(n * k), caps, interim

    def _run_core(self, images: torch.Tensor, interim_h: int, interim_w: int, args: dict):
        """Single-dispatch detect→estimate→warp (strategies best/largest).

        uint8 (N, H, W, 3) → (crops u8 (N·K, Ho, Wo, 3), landmarks, valid,
        caps).  The face grid equals the image batch (K = 1), so warping
        every slot wastes nothing.  ``crop_source="interim"`` warps the
        rounded interim inside its un-padded window, with the landmarks
        scaled to interim coordinates.
        """
        face_lm, valid, caps, interim = self._detect_trace(images, interim_h, interim_w, args)
        n, h, w, _ = images.shape
        k = face_lm.shape[0] // n
        with self._stage("fit_warp"):
            img_idx = torch.arange(n, dtype=torch.int32, device=self.device)
            img_idx = img_idx.repeat_interleave(k)
            if self.crop_source == "interim" and (h, w) != (interim_h, interim_w):
                scale, window = self._interim_window(h, w, interim_h, interim_w)
                scale_t = torch.tensor(scale, dtype=torch.float32, device=self.device)
                mats, ok = self._estimate(face_lm * scale_t)  # un-padded interim coords
                windows = torch.tensor(window, dtype=torch.int32, device=self.device)
                windows = windows[None].expand(n * k, 4).contiguous()
                # The rounded interim holds exact integers in [0, 255]: the
                # uint8 cast is lossless.
                crops = warp_affine_u8(
                    to_uint8(interim).contiguous(), mats, img_idx, self.output_size,
                    self.border_mode, windows,
                )
            else:
                mats, ok = self._estimate(face_lm)
                crops = warp_affine_u8(
                    images, mats, img_idx, self.output_size, self.border_mode
                )
        return crops, face_lm, valid & ok, caps

    def _crop_selected(self, images, face_lm, sel_idx, lm_scale=1.0, window=None):
        """Warps the selected face slots out of device-resident images.

        Args:
            images: uint8 (N, H, W, 3) device batch (original resolution,
                or the uint8 interim under ``crop_source="interim"``).
            face_lm: (N·K, 5, 2) landmarks from the detect pass.
            sel_idx: (F,) int64 device face-slot indices (a power-of-two
                bucket; padding rows repeat a kept slot).
            lm_scale: Source→``images`` coordinate scale.
            window: Optional int32 (4,) (top, left, height, width) region
                every face samples from.

        Returns:
            uint8 crops (F, Ho, Wo, 3) and a bool (F,) mask of faces whose
            transform was estimable.
        """
        k = face_lm.shape[0] // images.shape[0]
        lm_scale_t = torch.tensor(lm_scale, dtype=torch.float32, device=face_lm.device)
        lm = face_lm.index_select(0, sel_idx) * lm_scale_t
        mats, ok = self._estimate(lm)
        img_idx = torch.div(sel_idx, k, rounding_mode="floor").to(torch.int32)
        windows = None if window is None else window[None].expand(len(sel_idx), 4).contiguous()
        crops = warp_affine_u8(
            images, mats, img_idx, self.output_size, self.border_mode, windows
        )
        return crops, ok

    def _crop_selected_chunked(self, imgs, face_lm, keep: np.ndarray, lm_scale=1.0, window=None):
        """Runs :meth:`_crop_selected` over ``keep`` in bounded chunks.

        Returns host crops (F, Ho, Wo, 3), an ok mask (F,), and the device
        crop array when a single chunk covered everything (else None).
        Each chunk's crops are copied straight into their rows of the host
        array.
        """
        f = len(keep)
        chunk = self.max_warp_chunk
        crops = np.empty((f,) + self._empty_crops().shape[1:], np.uint8)
        ok = np.empty(f, bool)
        dev_handle = None
        for s in range(0, f, chunk):
            sub = keep[s : s + chunk]
            sel = np.full(next_pow2(len(sub)), sub[-1], np.int64)
            sel[: len(sub)] = sub
            with self._stage("fit_warp"):
                dev_crops, dev_ok = self._crop_selected(
                    imgs, face_lm, torch.from_numpy(sel).to(self.device), lm_scale, window
                )
            if f <= chunk:
                dev_handle = dev_crops
            with self._stage("to_host"):
                torch.from_numpy(crops[s : s + len(sub)]).copy_(dev_crops[: len(sub)])
                ok[s : s + len(sub)] = dev_ok[: len(sub)].cpu().numpy()
        return crops, ok, dev_handle

    def _empty_crops(self) -> np.ndarray:
        return np.zeros((0,) + self.output_size[::-1] + (3,), np.uint8)

    def _empty_result(self, return_device_crops: bool):
        empty = self._empty_crops()
        lm0 = np.zeros((0, 5, 2), np.float32)
        idx0 = np.zeros((0,), np.int64)
        return (empty, lm0, idx0, None) if return_device_crops else (empty, lm0, idx0)

    def process(
        self,
        images: np.ndarray,
        interim_size: tuple[int, int],
        return_device_crops: bool = False,
        valid_n: int | None = None,
    ):
        """Runs the batch; returns host (crops, landmarks, indices).

        Args:
            images: Uniform uint8 (N, H, W, 3) batch (original resolution).
            interim_size: Detector (width, height).
            return_device_crops: Also return the compacted crops as a device
                tensor, padded to a power-of-two face bucket (rows beyond F
                repeat the last face), for a downstream device consumer.
            valid_n: Number of leading real rows when the caller padded the
                batch; faces of later rows never surface.  Defaults to N.

        Returns:
            Compacted uint8 crops (F, Ho, Wo, 3), float32 landmarks
            (F, 5, 2) in source coordinates and int64 face→image indices
            (F,); with ``return_device_crops`` a 4th element, the device
            crop tensor of bucketed length F' >= F, or None when the
            two-program path needed several chunks or dropped a face whose
            fit was degenerate.
        """
        n = images.shape[0]
        valid_n = n if valid_n is None else min(int(valid_n), n)
        iw, ih = interim_size
        imgs = torch.from_numpy(np.ascontiguousarray(images)).to(self.device)

        # Strategy "all" runs the detect pass alone; the host compacts the
        # sparse face grid once and the crop chunks warp exactly the kept
        # faces, instead of every padded slot.
        two_program = self.det.strategy == "all"
        h, w = images.shape[1:3]
        interim_crops = self.crop_source == "interim" and (h, w) != (ih, iw)

        def dispatch(args):
            if not two_program:
                out = self._run_core(imgs, ih, iw, args)
                return out, out[3]
            face_lm, valid, caps, interim = self._detect_trace(imgs, ih, iw, args)
            # Keep only the pixels the crops sample.  The rounded interim
            # holds exact integers in [0, 255]: the uint8 cast is lossless.
            src = to_uint8(interim).contiguous() if interim_crops else imgs
            return (face_lm, valid, caps, src), caps

        out = self.det.dispatch_with_growth(dispatch, num_anchors(ih, iw), valid_n)

        if two_program:
            dev_face_lm, dev_valid, _caps, src_imgs = out
            k = dev_face_lm.shape[0] // n
            with self._stage("compact"):
                keep = np.nonzero(dev_valid[: valid_n * k].cpu().numpy())[0]
            if len(keep) == 0:
                return self._empty_result(return_device_crops)

            lm_scale, window = 1.0, None
            if interim_crops:
                lm_scale, win = self._interim_window(h, w, ih, iw)
                window = torch.tensor(win, dtype=torch.int32, device=self.device)
            crops_k, ok, dev_handle = self._crop_selected_chunked(
                src_imgs, dev_face_lm, keep, lm_scale, window
            )
            with self._stage("to_host"):
                face_lm = dev_face_lm.cpu().numpy()[keep][ok]
                crops = crops_k if ok.all() else crops_k[ok]
            indices = (keep[ok] // k).astype(np.int64)
            if not return_device_crops:
                return crops, face_lm, indices
            # The chunk's output is compacted already; hand it on unless a
            # degenerate fit punched a hole in it or several chunks ran.
            return crops, face_lm, indices, (dev_handle if ok.all() else None)

        dev_crops, dev_face_lm, dev_valid = out[0], out[1], out[2]
        k = dev_valid.shape[0] // n
        with self._stage("to_host"):
            crops = dev_crops[: valid_n * k].cpu().numpy()
            face_lm = dev_face_lm[: valid_n * k].cpu().numpy()
            valid = dev_valid[: valid_n * k].cpu().numpy()
        keep = np.nonzero(valid)[0]
        indices = (keep // k).astype(np.int64)
        if not return_device_crops:
            return crops[keep], face_lm[keep], indices

        # Compact on the device into a power-of-two face bucket; rows beyond
        # len(keep) repeat the last kept face.
        sel = np.zeros(next_pow2(max(len(keep), 1)), np.int64)
        sel[: len(keep)] = keep
        if len(keep):
            sel[len(keep) :] = keep[-1]
        dev_compact = dev_crops.index_select(0, torch.from_numpy(sel).to(self.device))
        return crops[keep], face_lm[keep], indices, dev_compact

    def detect_only(
        self, images: np.ndarray, interim_size: tuple[int, int], valid_n: int | None = None
    ):
        """Detect-only pass: host (landmarks (F, 5, 2), face→image indices (F,)).

        For callers that warp elsewhere: only landmarks and validity leave
        the device.
        """
        return self.detect_only_finish(self.detect_only_async(images, interim_size, valid_n))

    def detect_only_async(
        self, images: np.ndarray, interim_size: tuple[int, int], valid_n: int | None = None
    ) -> dict:
        """Dispatch half of :meth:`detect_only`; returns an in-flight handle.

        Uploads the batch, enqueues the detect pass on PyTorch's current
        stream and the device→host copies of its outputs into pinned
        buffers, records an event after them, and returns without waiting.
        On the CPU the pass runs synchronously.  Pass the handle to
        :meth:`detect_only_finish`.
        """
        n = images.shape[0]
        valid_n = n if valid_n is None else min(int(valid_n), n)
        iw, ih = interim_size
        imgs = torch.from_numpy(np.ascontiguousarray(images)).to(self.device)

        def dispatch(args):
            out = self._detect_trace(imgs, ih, iw, args)[:3]  # landmarks, valid, caps
            return out, out[2]

        args = self.det._detect_args()
        out, _caps = dispatch(args)
        host, event = _to_host_async(out)
        return {
            "out": host,
            "event": event,
            "args": args,
            "dispatch": dispatch,
            "n_anchors": num_anchors(ih, iw),
            "valid_n": valid_n,
            "n": n,
        }

    def detect_only_finish(self, handle: dict):
        """Collects a :meth:`detect_only_async` handle → (landmarks, indices).

        Waits for the handle's copies, resumes the cap-growth retries of
        the synchronous path (``RetinaFace.finish_growth``), then compacts
        the padded face grid on the host.
        """
        if handle["event"] is not None:
            handle["event"].synchronize()
        valid_n = handle["valid_n"]
        out = handle["out"]
        face_lm, valid, _caps = self.det.finish_growth(
            out, out[2], handle["args"], handle["dispatch"], handle["n_anchors"], valid_n
        )
        k = valid.shape[0] // handle["n"]
        keep = np.nonzero(valid[: valid_n * k].cpu().numpy())[0]
        lm = face_lm.cpu().numpy()[keep].astype(np.float32)
        return lm, (keep // k).astype(np.int64)
