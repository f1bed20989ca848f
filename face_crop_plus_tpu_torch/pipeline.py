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

With an enhancer (:class:`.models.enhancement.RRDBNet`) every strategy runs
the detect pass alone, keeping the uint8 interim on the device, and
:meth:`FusedPipeline._finish_enhanced` gates each image by its mean face
factor: gated images are super-resolved at interim resolution and their
faces crop from the enhanced interim, the others crop as without an
enhancer.

Packed 4:2:0 uploads (``packed_hw``): the batch arrives as (N, L) rows
of stored YCbCr planes at 1.5 bytes a pixel, and the RGB reconstruction
(:func:`.ops.yuv.yuv420_to_rgb`) runs on the device first and stays
resident as the batch every path above detects on and crops from.
Packed fetches (``pack_crops``): the host-bound copy of the crops is
packed on the device (:func:`.ops.yuv.rgb_to_yuv420`) before it comes
down; a device handoff stays RGB.

On a mesh (``mesh=``, :mod:`.parallel.mesh`) the batch is padded to a
multiple of the mesh size and split into one block a shard; every shard
runs the same passes on its own card with its own replica of each
network, and all shards are enqueued before the host waits on any.  Faces
index images of their own shard, so compaction, gated super-resolution
and warps stay shard-local (:meth:`FusedPipeline._crop_rows_mesh`,
:meth:`FusedPipeline._finish_gated_mesh`); a mesh of one device takes the
same code as a mesh of S.  No device crops are handed on from a mesh.

On the single-program path, :meth:`FusedPipeline.process_async` and
:meth:`FusedPipeline.process_finish` split a batch into its dispatch and
its collect (``detect_only_async``/``detect_only_finish`` split the
detect-only pass), so that a caller keeps batches in flight.  Every host
→ device copy on a dispatch goes through pinned memory without waiting
(:func:`.utils.device.to_device`).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .models.enhancement import mean_face_factor
from .ops.anchors import num_anchors
from .ops.cuda.warp import warp_affine_u8
from .ops.nn import resize_bilinear
from .ops.transform import estimate_affine, estimate_similarity
from .ops.warp import to_uint8
from .ops.yuv import packed_length, rgb_to_yuv420, yuv420_to_rgb
from .parallel.mesh import (
    pad_to_multiple,
    partition_by_shard,
    partition_rows_by_shard,
    shard_batch,
)
from .utils.batching import next_pow2
from .utils.device import f32_precision, to_device, to_host, to_host_async, wait_device
from .utils.profiling import PipelineStats


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


@contextlib.contextmanager
def _within(outer, inner):
    with outer, inner:
        yield


def _cat_shards(host) -> tuple[torch.Tensor, ...]:
    """Every shard's host tuple of arrays or tensors, concatenated in shard
    order into one tuple of tensors."""
    return tuple(torch.cat([torch.as_tensor(t) for t in ts]) for ts in zip(*host))


class FusedPipeline:
    """Detect→align→crop executor for uniform batches.

    Each stage (:attr:`STAGES`) is a span of :attr:`stats` while tracing
    (:mod:`.utils.profiling`).  "compact" is the two-program path's host
    compaction (validity to the host, kept slots); "fit_warp" and
    "to_host" recur once per crop chunk there.  "enhance" is the
    super-resolution of the gated interim rows; "unpack" the device
    reconstruction of packed 4:2:0 uploads.  ``stage_timer``, an optional
    hook, is called with a stage name and must return a context manager;
    each stage runs inside it, within the stage's span.  The pipeline counts
    "warp_crops" a warp launch and the bytes it moves ("bytes_up",
    "bytes_home") into :attr:`stats`, which the ``Cropper`` hands it.
    """

    STAGES = ("unpack", "resize_pad", "network", "select", "compact", "enhance", "fit_warp",
              "to_host")

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
        enh_model=None,
        mesh=None,
    ):
        if crop_source not in ("original", "interim"):
            raise ValueError(f"unknown crop_source: {crop_source!r}")
        self.det = det_model
        self.enh = enh_model
        self.target = np.asarray(target_landmarks, np.float32)
        self.output_size = tuple(output_size)
        self.border_mode = border_mode
        self.allow_skew = allow_skew
        #: Which pixels the crops sample: "original" (the full-resolution
        #: sources) or "interim" (the uint8 detector-resolution batch, the
        #: reference's sampling, for parity runs).
        self.crop_source = crop_source
        #: The :class:`.parallel.mesh.Mesh` the batch shards over, or None.
        self.mesh = mesh
        self.stage_timer = None
        self.stats = PipelineStats()

    @property
    def device(self) -> torch.device:
        return self.det.device

    def _stage(self, name: str):
        span = self.stats.span(name)
        if self.stage_timer is None:
            return span
        return _within(span, self.stage_timer(name))

    def _warp(self, images, matrices, img_idx, *args):
        """The warp kernel's wrapper, counted as "warp_crops" (a launch's
        crops, with the output size)."""
        self.stats.count("warp_crops", matrices.shape[0], size=self.output_size)
        return warp_affine_u8(images, matrices, img_idx, self.output_size, *args)

    def _estimate(self, lm: torch.Tensor):
        estimate = estimate_affine if self.allow_skew else estimate_similarity
        return estimate(lm, to_device(self.target, lm.device))

    def _interim_window(self, h: int, w: int, interim_h: int, interim_w: int):
        """(scale, (top, left, height, width)) of the un-padded interim."""
        scale, (t, b, l, r) = interim_geometry(h, w, (interim_w, interim_h))
        return scale, (t, l, interim_h - t - b, interim_w - l - r)

    def _detect_trace(self, images: torch.Tensor, interim_h: int, interim_w: int, args: dict,
                      net=None):
        """Detect stage shared by every path.

        uint8 (N, H, W, 3) device batch → (landmarks (N·K, 5, 2) in source
        image coordinates, validity (N·K,), cap diagnostics (N, 2), float32
        interim batch).  K is 1 for "best"/"largest" and ``max_faces`` for
        "all".  When the interim size differs from the input shape, the
        resize+pad runs on the device.  ``net`` is the detector replica of
        the images' shard (the detector's own by default).
        """
        n, h, w, _ = images.shape
        with self._stage("resize_pad"):
            if (h, w) != (interim_h, interim_w):
                interim, scale, pad = device_resize_pad(images, (interim_w, interim_h))
            else:
                interim, scale, pad = images.to(torch.float32), 1.0, (0, 0, 0, 0)

        sel, valid, caps = self.det._detect(interim, args, self._stage, net)
        with self._stage("select"):
            k = sel.shape[1]
            # Landmarks back to source-image coordinates: un-pad, un-scale.
            offset = to_device([pad[2], pad[0]], images.device, np.float32)
            scale_t = to_device(scale, images.device, np.float32)
            face_lm = (sel.reshape(n * k, 5, 2) - offset) / scale_t
        return face_lm, valid.reshape(n * k), caps, interim

    def _run_core(self, images: torch.Tensor, interim_h: int, interim_w: int, args: dict,
                  net=None):
        """Single-dispatch detect→estimate→warp (strategies best/largest).

        uint8 (N, H, W, 3) → (crops u8 (N·K, Ho, Wo, 3), landmarks, valid,
        caps).  The face grid equals the image batch (K = 1), so warping
        every slot wastes nothing.  ``crop_source="interim"`` warps the
        rounded interim inside its un-padded window, with the landmarks
        scaled to interim coordinates.
        """
        face_lm, valid, caps, interim = self._detect_trace(images, interim_h, interim_w, args, net)
        n, h, w, _ = images.shape
        k = face_lm.shape[0] // n
        with self._stage("fit_warp"):
            img_idx = torch.arange(n, dtype=torch.int32, device=images.device)
            img_idx = img_idx.repeat_interleave(k)
            if self.crop_source == "interim" and (h, w) != (interim_h, interim_w):
                scale, window = self._interim_window(h, w, interim_h, interim_w)
                scale_t = to_device(scale, images.device, np.float32)
                mats, ok = self._estimate(face_lm * scale_t)  # un-padded interim coords
                windows = to_device(window, images.device, np.int32)
                windows = windows[None].expand(n * k, 4).contiguous()
                # The rounded interim holds exact integers in [0, 255]: the
                # uint8 cast is lossless.
                crops = self._warp(
                    to_uint8(interim).contiguous(), mats, img_idx, self.border_mode, windows
                )
            else:
                mats, ok = self._estimate(face_lm)
                crops = self._warp(images, mats, img_idx, self.border_mode)
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
        crops = self._warp(images, mats, img_idx, self.border_mode, windows)
        return crops, ok

    def _crop_selected_chunked(self, imgs, face_lm, keep: np.ndarray, lm_scale=1.0, window=None,
                               pack: bool = False):
        """Runs :meth:`_crop_selected` over ``keep`` in bounded chunks.

        Returns host crops (F, Ho, Wo, 3), or with ``pack`` packed 4:2:0
        rows (F, L), an ok mask (F,), and the (RGB) device crop array when
        a single chunk covered everything (else None).  Each chunk's crops
        are copied straight into their rows of the host array.
        """
        f = len(keep)
        chunk = self.max_warp_chunk
        crops = np.empty((f,) + self._empty_crops(pack).shape[1:], np.uint8)
        ok = np.empty(f, bool)
        dev_handle = None
        for s in range(0, f, chunk):
            sub = keep[s : s + chunk]
            sel = np.full(next_pow2(len(sub)), sub[-1], np.int64)
            sel[: len(sub)] = sub
            with self._stage("fit_warp"):
                dev_crops, dev_ok = self._crop_selected(
                    imgs, face_lm, torch.from_numpy(sel).to(imgs.device), lm_scale, window
                )
            if f <= chunk:
                dev_handle = dev_crops
            with self._stage("to_host"):
                fetch = dev_crops[: len(sub)]
                if pack:
                    fetch = rgb_to_yuv420(fetch)
                self.stats.count("bytes_home", fetch.numel() + len(sub))
                with wait_device(self.stats):
                    torch.from_numpy(crops[s : s + len(sub)]).copy_(fetch)
                    ok[s : s + len(sub)] = dev_ok[: len(sub)].cpu().numpy()
        return crops, ok, dev_handle

    def _upload(self, images: np.ndarray, packed_hw) -> torch.Tensor:
        """The uint8 batch on the device: RGB as it is, or packed rows
        reconstructed there (stage "unpack").  The copy does not make the
        host wait (:func:`.utils.device.to_device`)."""
        imgs = to_device(images, self.device, stats=self.stats)
        if packed_hw is None:
            return imgs
        with self._stage("unpack"):
            return yuv420_to_rgb(imgs, *packed_hw)

    def _empty_crops(self, pack: bool = False) -> np.ndarray:
        if pack:
            return np.zeros((0, packed_length(self.output_size)), np.uint8)
        return np.zeros((0,) + self.output_size[::-1] + (3,), np.uint8)

    def _empty_result(self, return_device_crops: bool, pack: bool = False):
        empty = self._empty_crops(pack)
        lm0 = np.zeros((0, 5, 2), np.float32)
        idx0 = np.zeros((0,), np.int64)
        return (empty, lm0, idx0, None) if return_device_crops else (empty, lm0, idx0)

    def process(
        self,
        images: np.ndarray,
        interim_size: tuple[int, int],
        return_device_crops: bool = False,
        valid_n: int | None = None,
        pack_crops: bool = False,
        packed_hw: tuple[int, int] | None = None,
    ):
        """Runs the batch; returns host (crops, landmarks, indices).

        Args:
            images: Uniform uint8 (N, H, W, 3) batch (original resolution),
                or with ``packed_hw`` (N, L) packed 4:2:0 rows.
            interim_size: Detector (width, height).
            return_device_crops: Also return the compacted crops as a device
                tensor, padded to a power-of-two face bucket (rows beyond F
                repeat the last face), for a downstream device consumer.
            valid_n: Number of leading real rows when the caller padded the
                batch; faces of later rows never surface.  Defaults to N.
            pack_crops: Fetch the crops as packed 4:2:0 rows (F, L) instead
                of RGB; even output dimensions only (callers gate).  The
                device handoff stays RGB.
            packed_hw: Source (height, width) of packed rows; the
                reconstruction runs on the device and stays resident.

        Returns:
            Compacted uint8 crops (F, Ho, Wo, 3) (or packed rows), float32 landmarks
            (F, 5, 2) in source coordinates and int64 face→image indices
            (F,); with ``return_device_crops`` a 4th element, the device
            crop tensor of bucketed length F' >= F, or None when the
            two-program path needed several chunks, dropped a face whose
            fit was degenerate, or gated a face for enhancement, and
            always on a mesh.
        """
        if self.mesh is not None:
            result = self._process_mesh(images, interim_size, valid_n, pack_crops, packed_hw)
            return (*result, None) if return_device_crops else result
        if self.single_program:
            handle = self.process_async(images, interim_size, valid_n, pack_crops, packed_hw)
            return self.process_finish(handle, return_device_crops)

        n = images.shape[0]
        valid_n = n if valid_n is None else min(int(valid_n), n)
        iw, ih = interim_size
        imgs = self._upload(images, packed_hw)

        # Strategy "all" runs the detect pass alone; the host compacts the
        # sparse face grid once and the crop chunks warp exactly the kept
        # faces, instead of every padded slot.  So does every strategy with
        # an enhancer, which needs the interim.
        enhanced = self.enh is not None
        h, w = imgs.shape[1:3]
        interim_crops = self.crop_source == "interim" and (h, w) != (ih, iw)

        def dispatch(args):
            face_lm, valid, caps, interim = self._detect_trace(imgs, ih, iw, args)
            # Keep only the pixels the crops sample (the enhancer's input is
            # the interim).  The rounded interim holds exact integers in
            # [0, 255]: the uint8 cast is lossless.
            src = to_uint8(interim).contiguous() if interim_crops or enhanced else imgs
            return (face_lm, valid, caps, src), caps

        out = self.det.dispatch_with_growth(dispatch, num_anchors(ih, iw), valid_n)

        if enhanced:
            return self._finish_enhanced(out, imgs, (ih, iw), valid_n, return_device_crops,
                                         pack_crops)

        dev_face_lm, dev_valid, _caps, src_imgs = out
        k = dev_face_lm.shape[0] // n
        with self._stage("compact"), wait_device(self.stats):
            keep = np.nonzero(dev_valid[: valid_n * k].cpu().numpy())[0]
        if len(keep) == 0:
            return self._empty_result(return_device_crops, pack_crops)

        lm_scale, window = 1.0, None
        if interim_crops:
            lm_scale, win = self._interim_window(h, w, ih, iw)
            window = torch.tensor(win, dtype=torch.int32, device=self.device)
        crops_k, ok, dev_handle = self._crop_selected_chunked(
            src_imgs, dev_face_lm, keep, lm_scale, window, pack_crops
        )
        with self._stage("to_host"), wait_device(self.stats):
            face_lm = dev_face_lm.cpu().numpy()[keep][ok]
            crops = crops_k if ok.all() else crops_k[ok]
        indices = (keep[ok] // k).astype(np.int64)
        if not return_device_crops:
            return crops, face_lm, indices
        # The chunk's output is compacted already; hand it on unless a
        # degenerate fit punched a hole in it or several chunks ran.
        return crops, face_lm, indices, (dev_handle if ok.all() else None)

    @property
    def single_program(self) -> bool:
        """Whether :meth:`process` runs detect and warp in one pass
        (strategies "best"/"largest" without an enhancer), which
        :meth:`process_async` and :meth:`process_finish` split."""
        return self.enh is None and self.det.strategy != "all"

    def process_async(
        self,
        images: np.ndarray,
        interim_size: tuple[int, int],
        valid_n: int | None = None,
        pack_crops: bool = False,
        packed_hw: tuple[int, int] | None = None,
    ) -> dict:
        """Dispatch half of :meth:`process` on the single-program path.

        Uploads the batch without waiting (:meth:`_upload`), enqueues
        detect→fit→warp (:meth:`_run_core`) on PyTorch's current stream
        and the device→host copies of the first ``valid_n``·K crops (packed
        on the device with ``pack_crops``), landmarks and validity and of
        the caps into pinned buffers, records an event after them, and
        returns a handle without waiting.  On the CPU the pass runs
        synchronously.  Pass the handle to :meth:`process_finish`.
        """
        if not self.single_program:
            raise ValueError("process_async runs strategies 'best'/'largest' without an enhancer")
        if self.mesh is not None:
            raise ValueError("process_async runs on one device; on a mesh, process runs every "
                             "shard")
        n = images.shape[0]
        valid_n = n if valid_n is None else min(int(valid_n), n)
        iw, ih = interim_size
        imgs = self._upload(images, packed_hw)

        def dispatch(args):
            out = self._run_core(imgs, ih, iw, args)
            return out, out[3]

        args = self.det._detect_args()
        out, _caps = dispatch(args)
        host, event = self._fetch_async(out, valid_n, pack_crops)
        return {
            "out": out,
            "host": host,
            "event": event,
            "args": args,
            "dispatch": dispatch,
            "n_anchors": num_anchors(ih, iw),
            "valid_n": valid_n,
            "pack": pack_crops,
        }

    def _fetch_async(self, out, valid_n: int, pack: bool):
        """Starts the host copies of a single-program result's real rows:
        ((crops, landmarks, validity, caps), event) of :func:`_to_host_async`."""
        crops, face_lm, valid, caps = out
        rows = valid_n * (valid.shape[0] // caps.shape[0])
        with self._stage("to_host"):
            fetch = rgb_to_yuv420(crops[:rows]) if pack else crops[:rows]
            return to_host_async((fetch, face_lm[:rows], valid[:rows], caps), self.stats)

    def process_finish(self, handle: dict, return_device_crops: bool = False):
        """Collects a :meth:`process_async` handle; returns what
        :meth:`process` returns.

        Waits for the handle's copies and resumes the cap-growth policy
        (``RetinaFace.finish_growth``: a binding cap, or caps grown by a
        batch finished after this one was dispatched, re-run the pass
        synchronously), then compacts the face grid on the host.  With
        ``return_device_crops`` the kept crops are also compacted on the
        device into a power-of-two bucket whose rows beyond F repeat the
        last kept face.
        """
        with wait_device(self.stats):
            if handle["event"] is not None:
                handle["event"].synchronize()
        valid_n, host = handle["valid_n"], handle["host"]
        out = self.det.finish_growth(handle["out"], host[3], handle["args"], handle["dispatch"],
                                     handle["n_anchors"], valid_n)
        if out is not handle["out"]:  # re-dispatched: fetch the new result
            host, event = self._fetch_async(out, valid_n, handle["pack"])
            with wait_device(self.stats):
                if event is not None:
                    event.synchronize()
        crops, face_lm, valid = (t.numpy() for t in host[:3])
        k = out[2].shape[0] // out[3].shape[0]
        keep = np.nonzero(valid)[0]
        indices = (keep // k).astype(np.int64)
        if not return_device_crops:
            return crops[keep], face_lm[keep], indices

        sel = np.zeros(next_pow2(max(len(keep), 1)), np.int64)
        sel[: len(keep)] = keep
        if len(keep):
            sel[len(keep) :] = keep[-1]
        dev_compact = out[0].index_select(0, torch.from_numpy(sel).to(self.device))
        return crops[keep], face_lm[keep], indices, dev_compact

    def _finish_enhanced(self, out, imgs, interim_hw, valid_n: int, return_device_crops: bool,
                         pack: bool = False):
        """Gate → super-resolution → crop, after the detect pass.

        Counterpart of the single-card branch of the JAX
        ``_finish_enhanced`` (``pipeline.py:681-840``).  The gate compares
        each real image's mean face factor, measured in interim coordinates
        against the full padded interim area (the reference's quirk), with
        the enhancer's threshold.  Faces of other images crop as without an
        enhancer (from the originals, or from the interim under
        ``crop_source="interim"``); the gated images' interim rows are
        super-resolved on the device and their faces crop from the enhanced
        rows inside the interim's un-padded window (the JAX
        ``_crop_gated``), in chunks of :attr:`max_warp_chunk`.

        Returns what :meth:`process` returns (packed rows with ``pack``);
        the device crops are handed on only when no face was gated and
        every fit was sound.
        """
        dev_face_lm, dev_valid, _caps, dev_interim = out
        h, w = imgs.shape[1:3]
        k = dev_face_lm.shape[0] // imgs.shape[0]
        with self._stage("compact"), wait_device(self.stats):
            keep = np.nonzero(dev_valid[: valid_n * k].cpu().numpy())[0]
            if len(keep) == 0:
                return self._empty_result(return_device_crops, pack)
            face_lm = dev_face_lm.cpu().numpy()[keep]  # (F, 5, 2) source coordinates
        indices = (keep // k).astype(np.int64)

        scale, win, gated, is_gated = self._gate(face_lm, indices, (h, w), interim_hw, valid_n)
        window = torch.tensor(win, dtype=torch.int32, device=self.device)

        crops_all = np.empty((len(keep),) + self._empty_crops(pack).shape[1:], np.uint8)
        ok_all = np.zeros(len(keep), bool)
        dev_handle = None

        plain_pos = np.nonzero(~is_gated)[0]
        if len(plain_pos):
            if self.crop_source == "interim":
                crops_p, ok_p, dev_handle = self._crop_selected_chunked(
                    dev_interim, dev_face_lm, keep[plain_pos], scale, window, pack
                )
            else:
                crops_p, ok_p, dev_handle = self._crop_selected_chunked(
                    imgs, dev_face_lm, keep[plain_pos], pack=pack
                )
            crops_all[plain_pos] = crops_p
            ok_all[plain_pos] = ok_p

        gated_pos = np.nonzero(is_gated)[0]
        if len(gated_pos):
            dev_handle = None
            with self._stage("enhance"):
                rows = torch.from_numpy(gated).to(self.device)
                enhanced = self.enh.enhance_device(dev_interim.index_select(0, rows))
            lm_interim = (face_lm[gated_pos] * scale).astype(np.float32)
            local = np.searchsorted(gated, indices[gated_pos]).astype(np.int32)
            chunk = self.max_warp_chunk
            for s in range(0, len(gated_pos), chunk):
                pos = gated_pos[s : s + chunk]
                with self._stage("fit_warp"):
                    lm = torch.from_numpy(lm_interim[s : s + chunk]).to(self.device)
                    mats, ok = self._estimate(lm)
                    crops = self._warp(
                        enhanced, mats, torch.from_numpy(local[s : s + chunk]).to(self.device),
                        self.border_mode, window[None].expand(len(pos), 4).contiguous(),
                    )
                with self._stage("to_host"), wait_device(self.stats):
                    crops_all[pos] = (rgb_to_yuv420(crops) if pack else crops).cpu().numpy()
                    ok_all[pos] = ok.cpu().numpy()

        crops, face_lm, indices = crops_all[ok_all], face_lm[ok_all], indices[ok_all]
        if not return_device_crops:
            return crops, face_lm, indices
        return crops, face_lm, indices, (dev_handle if ok_all.all() else None)

    def _gate(self, face_lm: np.ndarray, indices: np.ndarray, src_hw, interim_hw, valid_n: int):
        """The enhancer's gate: (interim scale, un-padded interim window,
        gated image indices, per-face gated mask).  Each real image's mean
        face factor, measured in interim coordinates against the full
        padded interim area (the reference's quirk), is compared with the
        enhancer's threshold."""
        (h, w), (ih, iw) = src_hw, interim_hw
        scale, win = self._interim_window(h, w, ih, iw)
        factors = mean_face_factor(face_lm * scale, indices.tolist(), valid_n, (ih, iw))
        gated = np.nonzero(np.isfinite(factors) & (factors <= self.enh.min_face_factor))[0]
        return scale, win, gated, np.isin(indices, gated)

    def detect_only(
        self,
        images: np.ndarray,
        interim_size: tuple[int, int],
        valid_n: int | None = None,
        packed_hw: tuple[int, int] | None = None,
    ):
        """Detect-only pass: host (landmarks (F, 5, 2), face→image indices (F,)).

        For callers that warp elsewhere (the host-crop mode): only
        landmarks and validity leave the device.  With ``packed_hw`` the
        batch is packed 4:2:0 rows, reconstructed on the device for the
        detector; the caller warps its own twin of the reconstruction.
        """
        return self.detect_only_finish(
            self.detect_only_async(images, interim_size, valid_n, packed_hw)
        )

    def detect_only_async(
        self,
        images: np.ndarray,
        interim_size: tuple[int, int],
        valid_n: int | None = None,
        packed_hw: tuple[int, int] | None = None,
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
        if self.mesh is not None:
            return self._detect_only_mesh_async(images, ih, iw, valid_n, packed_hw)
        imgs = self._upload(images, packed_hw)

        def dispatch(args):
            out = self._detect_trace(imgs, ih, iw, args)[:3]  # landmarks, valid, caps
            return out, out[2]

        args = self.det._detect_args()
        out, _caps = dispatch(args)
        host, event = to_host_async(out, self.stats)
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
        the padded face grid on the host.  A mesh handle holds one event
        and one host tuple a shard.
        """
        events, out = handle["event"], handle["out"]
        with wait_device(self.stats):
            for event in events if isinstance(events, list) else [events]:
                if event is not None:
                    event.synchronize()
        if isinstance(out, list):  # a mesh: every shard's host tuple
            out = _cat_shards(out)
        valid_n = handle["valid_n"]
        out = self.det.finish_growth(
            out, out[2], handle["args"], handle["dispatch"], handle["n_anchors"], valid_n
        )
        if isinstance(out, list):  # re-dispatched on a mesh
            out = _cat_shards(to_host(out, self.stats))
        face_lm, valid, _caps = out
        k = valid.shape[0] // handle["n"]
        keep = np.nonzero(valid[: valid_n * k].cpu().numpy())[0]
        lm = face_lm.cpu().numpy()[keep].astype(np.float32)
        return lm, (keep // k).astype(np.int64)

    # ------------------------------------------------------------------
    # The mesh: one program a shard, shard-local compaction
    #
    # Faces index images of their own shard (the face grid of image i
    # lives on i's shard), so compaction, gated-SR gathers and warps run
    # within each shard: no tensor crosses shards.  Each shard runs on its
    # own card and that card's current stream; every shard is enqueued
    # before the host waits on any (:func:`.utils.device.to_host`).
    # ------------------------------------------------------------------

    def _mesh_upload(self, images: np.ndarray, valid_n: int, packed_hw):
        """The batch padded to a multiple of the mesh size and split into one
        block a shard (reconstructed on each card from packed rows, stage
        "unpack"), and the real rows: ``min(caller's valid_n, N)``."""
        padded, mesh_valid = pad_to_multiple(np.asarray(images), self.mesh.size)
        blocks = shard_batch(padded, self.mesh)
        if packed_hw is not None:
            with self._stage("unpack"):
                blocks = tuple(yuv420_to_rgb(b, *packed_hw) for b in blocks)
        return blocks, min(valid_n, mesh_valid)

    def _process_mesh(self, images, interim_size, valid_n, pack: bool, packed_hw):
        """The mesh side of :meth:`process` (JAX ``pipeline.py:972-977``,
        ``:1068-1080``); returns host (crops, landmarks, indices).

        "best"/"largest" without an enhancer run :meth:`_run_core` on every
        shard and fetch each shard's rows; otherwise every shard runs the
        detect pass, the host compacts the face grid, and the kept faces
        warp shard-locally (:meth:`_crop_rows_mesh`), or go through the
        gate (:meth:`_finish_enhanced_mesh`).
        """
        n = images.shape[0]
        valid_n = n if valid_n is None else min(int(valid_n), n)
        iw, ih = interim_size
        blocks, valid_n = self._mesh_upload(images, valid_n, packed_hw)
        if self.single_program:
            return self._mesh_core(blocks, ih, iw, valid_n, pack)

        n_pad = len(blocks) * blocks[0].shape[0]
        h, w = blocks[0].shape[1:3]
        enhanced = self.enh is not None
        interim_crops = self.crop_source == "interim" and (h, w) != (ih, iw)

        def dispatch(args):
            outs = []
            with f32_precision():  # once around every shard's pass
                for block, net in zip(blocks, self.det.replicas()):
                    face_lm, valid, caps, interim = self._detect_trace(block, ih, iw, args, net)
                    # The rounded interim holds exact integers: the cast is lossless.
                    src = to_uint8(interim).contiguous() if interim_crops or enhanced else block
                    outs.append((face_lm, valid, caps, src))
            return outs, [out[2] for out in outs]

        outs = self.det.dispatch_with_growth(dispatch, num_anchors(ih, iw), valid_n)
        with self._stage("compact"):
            face_lm, valid = (np.concatenate(x)
                              for x in zip(*to_host((o[:2] for o in outs), self.stats)))
            k = face_lm.shape[0] // n_pad
            keep = np.nonzero(valid[: valid_n * k])[0]
        if len(keep) == 0:
            return self._empty_result(False, pack)
        face_lm, indices = face_lm[keep], (keep // k).astype(np.int64)
        srcs = [out[3] for out in outs]
        if enhanced:
            return self._finish_enhanced_mesh(blocks, srcs, face_lm, indices, (ih, iw),
                                              valid_n, pack)

        lm_scale, window = 1.0, None
        if interim_crops:
            lm_scale, window = self._interim_window(h, w, ih, iw)
        n_loc = blocks[0].shape[0]
        crops = np.empty((len(indices),) + self._empty_crops(pack).shape[1:], np.uint8)
        ok = np.zeros(len(indices), bool)
        self._crop_rows_mesh(srcs, face_lm * np.float32(lm_scale), indices // n_loc,
                             indices % n_loc, window, pack, crops, ok, np.arange(len(indices)))
        return crops[ok], face_lm[ok], indices[ok]

    def _mesh_core(self, blocks, ih: int, iw: int, valid_n: int, pack: bool):
        """"best"/"largest" on a mesh: :meth:`_run_core` on every shard, the
        host copies of every shard started before the host waits, then the
        cap-growth policy (``RetinaFace.finish_growth`` over the shards'
        caps: a cap binding on any shard re-runs every shard) and the host
        compaction of :meth:`process_finish`."""
        b = blocks[0].shape[0]

        def dispatch(args):
            with f32_precision():  # once around every shard's pass
                outs = [self._run_core(block, ih, iw, args, net)
                        for block, net in zip(blocks, self.det.replicas())]
            return outs, [out[3] for out in outs]

        def fetch(outs):
            with self._stage("to_host"):
                return [np.concatenate(x) for x in zip(*to_host(
                    ((rgb_to_yuv420(crops) if pack else crops, lm, valid, caps)
                     for crops, lm, valid, caps in outs), self.stats))]

        args = self.det._detect_args()
        outs, _caps = dispatch(args)
        host = fetch(outs)
        grown = self.det.finish_growth(outs, host[3], args, dispatch, num_anchors(ih, iw),
                                       valid_n)
        if grown is not outs:  # re-dispatched: fetch the new result
            host = fetch(grown)
        crops, face_lm, valid = host[:3]
        k = valid.shape[0] // (b * len(blocks))
        keep = np.nonzero(valid[: valid_n * k])[0]
        return crops[keep], face_lm[keep], (keep // k).astype(np.int64)

    def _crop_local_sharded(self, blocks, lm: np.ndarray, local_idx: np.ndarray, window=None):
        """Shard-local estimate→warp: per shard, the fits of its C landmark
        rows and the warp of its own images (JAX ``_crop_local_sharded``).

        Args:
            blocks: Each shard's uint8 (N/S, H, W, 3) block, on its device.
            lm: (S·C, 5, 2) float32 landmarks, row ``s·C + p`` the face
                shard ``s`` warps at slot ``p`` (padding slots carry the
                target template: an identity fit).
            local_idx: (S·C,) int32 image row within each shard's block.
            window: Optional (top, left, height, width) every face samples
                inside.

        Returns:
            One (uint8 crops (C, Ho, Wo, 3), bool ok (C,)) pair a shard, on
            its device.
        """
        c = len(local_idx) // len(blocks)
        outs = []
        for s, block in enumerate(blocks):
            dev = block.device
            mats, ok = self._estimate(to_device(lm[s * c : (s + 1) * c], dev, np.float32))
            idx = to_device(local_idx[s * c : (s + 1) * c], dev, np.int32)
            win = None
            if window is not None:
                win = to_device(window, dev, np.int32)[None].expand(c, 4).contiguous()
            outs.append((self._warp(block, mats, idx, self.border_mode, win), ok))
        return outs

    @staticmethod
    def _gather_rows_sharded(blocks, local_idx: np.ndarray) -> list:
        """Shard-local row gather: block s selects its rows ``local_idx[s·C :
        (s+1)·C]`` (JAX ``_gather_rows_sharded``); no row crosses shards."""
        c = len(local_idx) // len(blocks)
        return [block.index_select(0, to_device(local_idx[s * c : (s + 1) * c], block.device,
                                                np.int64))
                for s, block in enumerate(blocks)]

    def _crop_rows_mesh(self, blocks, lm: np.ndarray, img_shard, img_local, window, pack: bool,
                        crops_out: np.ndarray, ok_out: np.ndarray, out_pos: np.ndarray):
        """Warps faces out of a sharded batch, shard-locally: the mesh's
        :meth:`_crop_selected_chunked` (JAX ``_crop_rows_mesh``).

        Faces are grouped by their image's shard in chunks of
        ``max_warp_chunk // S`` faces a shard (:func:`partition_by_shard`),
        each chunk is warped by :meth:`_crop_local_sharded`, and every
        shard's host rows land in face order.

        Args:
            blocks: Each shard's uint8 source block (originals, interim or
                enhanced interim), on its device.
            lm: (F, 5, 2) float32 landmarks in ``blocks``' coordinates
                (callers apply any interim scale).
            img_shard / img_local: (F,) owning shard and local image row of
                each face.
            window: Optional (top, left, height, width) sampling window.
            pack: Fetch the crops as packed 4:2:0 rows.
            crops_out / ok_out: Host crops and ok mask written at
                ``out_pos`` (F,), the faces' rows there.
        """
        s = len(blocks)
        cf = max(1, self.max_warp_chunk // s)
        for sel, req, rows in partition_by_shard(img_shard, img_local, s, cf):
            c = len(sel) // s
            lm_rows = np.tile(self.target[None], (len(sel), 1, 1))
            lm_rows[rows] = lm[req]
            with self._stage("fit_warp"):
                outs = self._crop_local_sharded(blocks, lm_rows, sel, window)
            with self._stage("to_host"):
                host = to_host(((rgb_to_yuv420(crops) if pack else crops, ok)
                                for crops, ok in outs), self.stats)
                # Shard i's faces fill its leading slots; each lands in its
                # output row straight from the pinned buffer (one host copy).
                for i, (crops, ok) in enumerate(host):
                    mine = req[rows // c == i]
                    crops_out[out_pos[mine]] = crops[: len(mine)]
                    ok_out[out_pos[mine]] = ok[: len(mine)]

    def _finish_enhanced_mesh(self, blocks, interims, face_lm, indices, interim_hw,
                              valid_n: int, pack: bool):
        """Gate → super-resolution → crop on a mesh: the mesh side of the
        JAX ``_finish_enhanced`` (``pipeline.py:745-782``).

        Faces of non-gated images warp shard-locally from the originals (or
        the interim under ``crop_source="interim"``); gated images go
        through :meth:`_finish_gated_mesh`.  Returns host (crops,
        landmarks, indices).
        """
        n_loc = blocks[0].shape[0]
        scale, win, gated, is_gated = self._gate(face_lm, indices, blocks[0].shape[1:3],
                                                 interim_hw, valid_n)
        crops = np.empty((len(indices),) + self._empty_crops(pack).shape[1:], np.uint8)
        ok = np.zeros(len(indices), bool)
        plain = np.nonzero(~is_gated)[0]
        if len(plain):
            img = indices[plain]
            if self.crop_source == "interim":
                self._crop_rows_mesh(interims, face_lm[plain] * np.float32(scale),
                                       img // n_loc, img % n_loc, win, pack, crops, ok, plain)
            else:
                self._crop_rows_mesh(blocks, face_lm[plain], img // n_loc, img % n_loc,
                                       None, pack, crops, ok, plain)
        gated_pos = np.nonzero(is_gated)[0]
        if len(gated_pos):
            self._finish_gated_mesh(interims, face_lm, indices, gated, gated_pos, scale, win,
                                    pack, crops, ok)
        return crops[ok], face_lm[ok], indices[ok]

    def _finish_gated_mesh(self, interims, face_lm, indices, gated, gated_pos, scale: float,
                           window, pack: bool, crops_all: np.ndarray, ok_all: np.ndarray):
        """Gate → SR → crop of the gated images on a mesh, shard-locally
        (JAX ``_finish_gated_mesh``, ``pipeline.py:842-915``).

        Images shard contiguously, so each shard gathers its own gated
        interim rows (:meth:`_gather_rows_sharded`) in chunks of
        ``enh_batch_size // S`` a shard (:func:`partition_rows_by_shard`),
        super-resolves them with its replica
        (``RRDBNet.enhance_shards``) and warps its own faces from its
        enhanced block inside the interim window.  Results land in
        ``crops_all``/``ok_all`` at ``gated_pos``.
        """
        s = len(interims)
        n_pad = s * interims[0].shape[0]
        cg = max(1, self.enh.enh_batch_size // s)
        chunks = partition_rows_by_shard(gated, n_pad, s, cg)
        # Gated image → (chunk, shard, slot) in that chunk's SR output.
        img_loc: dict[int, tuple[int, int, int]] = {}
        for ci, (sel, req, rows) in enumerate(chunks):
            c = len(sel) // s
            for j, r in zip(req, rows):
                img_loc[int(gated[j])] = (ci, int(r // c), int(r % c))
        loc = np.asarray([img_loc[int(indices[p])] for p in gated_pos], np.int64).reshape(-1, 3)
        # The single-device path's landmark scaling, so a one-device mesh
        # fits the same f32 landmarks.
        lm_interim = (face_lm[gated_pos] * scale).astype(np.float32)
        for ci, (sel, _req, _rows) in enumerate(chunks):
            with self._stage("enhance"):
                enhanced = self.enh.enhance_shards(self._gather_rows_sharded(interims, sel))
            mine = np.nonzero(loc[:, 0] == ci)[0]
            self._crop_rows_mesh(enhanced, lm_interim[mine], loc[mine, 1], loc[mine, 2],
                                   window, pack, crops_all, ok_all, gated_pos[mine])

    def _detect_only_mesh_async(self, images, ih: int, iw: int, valid_n: int, packed_hw):
        """:meth:`detect_only_async` on a mesh: the detect pass on every
        shard, each shard's host copies started before returning
        (JAX ``pipeline.py:1187-1192``)."""
        blocks, valid_n = self._mesh_upload(images, valid_n, packed_hw)

        def dispatch(args):
            with f32_precision():  # once around every shard's pass
                outs = [self._detect_trace(block, ih, iw, args, net)[:3]
                        for block, net in zip(blocks, self.det.replicas())]
            return outs, [out[2] for out in outs]

        args = self.det._detect_args()
        outs, _caps = dispatch(args)
        started = [to_host_async(out, self.stats) for out in outs]
        return {
            "out": [host for host, _event in started],
            "event": [event for _host, event in started],
            "args": args,
            "dispatch": dispatch,
            "n_anchors": num_anchors(ih, iw),
            "valid_n": valid_n,
            "n": len(blocks) * blocks[0].shape[0],
        }
