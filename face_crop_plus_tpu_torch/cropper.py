"""Face cropper: images or a directory → aligned face crops and groups.

Counterpart of ``face_crop_plus_tpu.cropper.Cropper`` with the same
constructor surface.  Ported: the detection configuration with strategies
"best"/"largest"/"all" and ``crop_source`` "original"/"interim", through
the in-memory serving entry points :meth:`Cropper.process_images` and
:meth:`Cropper.process_images_stream` (batches in flight) and the
directory pipeline :meth:`Cropper.process_dir` (read → detect and crop →
parse → save, the JAX package's tree), which the CLI
(``python -m face_crop_plus_tpu_torch``) drives; the landmark-file mode
(``landmarks=``: a .json/.csv/.txt file or (landmarks, file names) arrays;
no detector, crops straight from the given points, reduced to 5 when the
scheme is larger); BiSeNet parsing into ``attr_groups``/``mask_groups``
(the ``<attr>/<mask>`` and ``<mask>_mask`` subtrees); gated RRDBNet x4
enhancement (``enh_threshold``); and the landmark-free mode
(``det_threshold=None`` without landmarks), where whole images pass
through to the tree, enhanced when ``enh_threshold`` is set and parsed
when groups are set.

Two paths crop detected faces, and which one a batch takes decides which
pixels its crops sample, so the routing is part of the result:

* the fused path (:class:`.pipeline.FusedPipeline`) resizes on the device
  and samples crops from the original pixels (or, under
  ``crop_source="interim"``, from the device-resized interim);
* the staged path (:meth:`Cropper._detect_crop_staged`) resizes on the host
  (:func:`.utils.batching.as_batch`: cv2 ``INTER_AREA``/``INTER_CUBIC``),
  detects on that interim batch and samples crops from it, inside each
  image's un-padded window.

With an enhancer, gated images' crops sample the enhanced interim on both
paths (the fused path's other crops keep sampling the originals).

Images of one shape take the fused path only when :meth:`_fused_eligible`
grants their shape: it is one of the ``max_fused_shapes`` shapes already
granted, or the group holds at least ``max(2, batch_size // 2)`` images and
fewer than ``max_fused_shapes`` shapes are held.  Every other group, and
every ragged ``process_images`` batch, takes the staged path.  This is the
JAX package's rule (``cropper.py:312-329``, ``:1487-1521``), where the
budget bounds compiled XLA programs; the port keeps it so that both
packages crop the same pixels.

When a directory batch forms exactly one fused group and nothing is staged
(nor gated), the parser reads that group's crops on the device (the fused
pipeline's handoff); otherwise it reads the host crops.  Both give the same
groups.

The host path (the JAX package's, with its switches):

* the host warp (:func:`.utils.native_io.warp_affine_batch_native`, the
  native library built from ``native/fcpt_io.cpp``) crops in the
  landmark-file mode on the CPU and in the host-crop mode; otherwise, on
  every card and wherever the library is missing, the warp kernel
  (:func:`.ops.cuda.warp.warp_affine_u8`) crops, as it always does for
  pixels already on a card.  ``FCPT_NATIVE_WARP=0`` switches the host warp off,
  ``FCPT_WARP_EXACT=1`` makes it sample in float instead of 10-bit fixed
  point;
* the host-crop mode (:meth:`_host_crop_enabled`, ``FCPT_HOST_CROP`` auto,
  0 or 1): fused groups run the detect-only program on the device and the
  host fits and warps; staged crops warp on the host too;
* the packed 4:2:0 wire: sources upload as stored YCbCr planes
  (:meth:`_packed_upload_eligible`, ``FCPT_PACK_UPLOAD``) and JPEG-bound
  crops come down packed (:meth:`_packed_fetch_eligible`,
  ``FCPT_PACK_FETCH``), feeding the raw-data JPEG encoder; landmark-file
  crops of JPEGs stay in 4:2:0 end to end (:meth:`_yuv_crop_eligible`,
  ``FCPT_YUV_CROP``).  Both "auto" settings hold off on the CPU.

The JAX package moves crops to the host because its device warp is slow;
the port's warp kernel is not, and no measurement yet says a host warp
beats it on a card.  So where the JAX package turns the host warp on by
itself ("auto"), the port does so only on the CPU: on a card the
host-crop mode and the YUV-direct crops run only when ``FCPT_HOST_CROP=1``
or ``FCPT_YUV_CROP=1`` asks for them.  Nor does the port warp staged crops
on the host merely because its device is the CPU: with
``FCPT_HOST_CROP=0`` every detected face crops through the warp kernel's
wrapper.

On a mesh (``mesh=make_mesh(...)``, :mod:`.parallel.mesh`) every model
holds one replica a shard and the fused pipeline shards each batch over
the mesh's devices; the first device runs the rest (staged warps, fits).
As in the JAX package, a mesh turns off the host-crop mode, the host
warp, the YUV-direct crops and the parser's device handoff, and
:meth:`Cropper.process_images_stream` runs every batch as
:meth:`Cropper.process_images`.
"""

from __future__ import annotations

import os
import threading
from collections import defaultdict, deque
from functools import partial
from multiprocessing.pool import ThreadPool

import numpy as np
import torch

from .ops.cuda.warp import warp_affine_u8
from .ops.transform import (
    estimate_affine,
    estimate_affine_np,
    estimate_similarity,
    estimate_similarity_np,
)
from .ops.yuv import packed_length, rgb_to_yuv420_np, yuv420_to_rgb_np
from .parallel.mesh import check_mesh
from .utils import native_io
from .utils.batching import as_batch, pad_batch_to
from .utils.device import resolve_device, wait_device
from .utils.io import (
    PackedYUVImage,
    encoder_available,
    imwrite,
    imwrite_yuv420,
    read_images,
    unpack_images,
)
from .utils.landmarks import make_target_landmarks, parse_landmarks_file, reduce_landmarks
from .utils.profiling import PipelineStats

#: Batch sizes the staged detect pads its interim batch to (with
#: ``batch_size``, which is always one): cuDNN picks its convolution
#: algorithms by batch size, and on an H100 some sizes run several times
#: slower than a larger one (``PERF.md`` §5, the staged sweep of
#: ``chip_smoke.py`` phase 5 (e)).
STAGED_PAD_SIZES = (1, 8)


def _pair(size) -> tuple[int, int]:
    if isinstance(size, int):
        return (size, size)
    if len(size) == 1:
        return (size[0], size[0])
    return tuple(size)




def _host_threads(num_processes: int) -> int:
    """Native threads of one host warp: the cores shared by the workers."""
    return max(1, (os.cpu_count() or 1) // max(1, num_processes))


class Cropper:
    """Face cropper on a CUDA card, or the CPU on request.

    Args mirror the JAX ``Cropper``; ``device`` None (or "auto") means
    "cuda" and raises when CUDA is absent — pass ``device="cpu"`` to run on
    the CPU.  ``mesh`` is a :class:`.parallel.mesh.Mesh` (``make_mesh``);
    it takes the place of ``device``.  ``landmarks`` is a landmarks file
    path (parsed here) or a (landmarks (N, L, 2), file names (N,)) pair.  ``det_model``,
    ``enh_model`` and ``par_model`` are None when their feature is off (the
    detector also when landmarks are given); ``stats`` accumulates
    per-stage wall time (:class:`.utils.profiling.PipelineStats`) and, while
    a ``torch.profiler`` profile runs, the spans and counters of the
    cropper and of the models and pipeline it hands ``stats`` to.
    """

    #: Faces per device warp launch: bounds one launch's crop buffer
    #: (512 × 256² × 3 B = 100.7 MB).
    max_warp_chunk: int = 512

    def __init__(
        self,
        output_size: int | tuple[int, int] | list[int] = 256,
        output_format: str | None = None,
        resize_size: int | tuple[int, int] | list[int] = 1024,
        face_factor: float = 0.65,
        strategy: str = "largest",
        padding: str = "constant",
        allow_skew: bool = False,
        landmarks: str | tuple[np.ndarray, np.ndarray] | None = None,
        attr_groups: dict[str, list[int]] | None = None,
        mask_groups: dict[str, list[int]] | None = None,
        det_threshold: float | None = 0.6,
        enh_threshold: float | None = None,
        batch_size: int = 8,
        num_processes: int = 1,
        device: str | None = None,
        max_faces: int = 64,
        pre_topk: int = 256,
        auto_grow: bool = True,
        max_fused_shapes: int = 4,
        weights_dir: str | None = None,
        mesh=None,
        crop_source: str = "original",
    ):
        self.output_size = _pair(output_size)
        self.output_format = output_format
        self.resize_size = _pair(resize_size)
        self.face_factor = face_factor
        self.strategy = strategy
        self.padding = padding
        self.allow_skew = allow_skew
        self.landmarks = landmarks
        self.attr_groups = attr_groups
        self.mask_groups = mask_groups
        self.det_threshold = det_threshold
        self.enh_threshold = enh_threshold
        self.batch_size = batch_size
        self.num_processes = num_processes
        self.device = device
        self.max_faces = max_faces
        self.pre_topk = pre_topk
        self.auto_grow = auto_grow
        self.max_fused_shapes = max_fused_shapes
        self.weights_dir = weights_dir
        self.mesh = mesh
        self.crop_source = crop_source
        self.num_std_landmarks = 5
        self._stats = PipelineStats()

        check_mesh(mesh)
        if isinstance(self.landmarks, str):
            self.landmarks = parse_landmarks_file(self.landmarks)
        self._device = mesh.devices[0] if mesh is not None else resolve_device(device)
        self._init_models()
        self._init_landmarks_target()
        self._init_fused()
        #: One batch's device work at a time (detect, crop and parse).
        #: ``process_dir``'s worker threads overlap host decode, resize,
        #: host warps and encode with it.  Batches run together only queue
        #: on the card and add up their peak memory (~19 GiB for 16 images
        #: at a 1024² interim; four at once reached 35–74 GB on an 80 GB
        #: H100), and near its limit cuDNN may pick other algorithms, whose
        #: f32 sums round differently: the tree would depend on
        #: ``num_processes``.
        self._device_lock = threading.Lock()
        self.stats = self._stats

    @property
    def stats(self) -> PipelineStats:
        """The stage times, spans and counters of this cropper."""
        return self._stats

    @stats.setter
    def stats(self, stats: PipelineStats):
        """Replaces the stats, here and in every model and the pipeline."""
        self._stats = stats
        for layer in (getattr(self, name, None)
                      for name in ("det_model", "enh_model", "par_model", "_fused")):
            if layer is not None:
                layer.stats = stats

    def _locked(self):
        """The device lock; while tracing, its wait and hold are the spans
        "device_lock.wait" and "device_lock" (:meth:`PipelineStats.locked`)."""
        return self._stats.locked(self._device_lock)

    def _init_models(self):
        """Builds the models the configuration asks for.

        The detector exists when ``det_threshold`` is set and no landmarks
        are given, the enhancer when ``enh_threshold`` is set, the parser
        when either grouping is set (the JAX ``_init_models``,
        ``cropper.py:335-383``).
        """
        self.det_model = None
        self.enh_model = None
        self.par_model = None
        if self.det_threshold is not None and self.landmarks is None:
            from .models.detection import RetinaFace

            self.det_model = RetinaFace(
                strategy=self.strategy,
                vis=self.det_threshold,
                max_faces=self.max_faces,
                pre_topk=self.pre_topk,
                auto_grow=self.auto_grow,
                weights_dir=self.weights_dir,
                device=self._device,
                mesh=self.mesh,
            )
        if self.enh_threshold is not None:
            from .models.enhancement import RRDBNet

            self.enh_model = RRDBNet(
                min_face_factor=self.enh_threshold,
                weights_dir=self.weights_dir,
                device=self._device,
                mesh=self.mesh,
            )
        if self.attr_groups is not None or self.mask_groups is not None:
            from .models.parsing import BiSeNet

            self.par_model = BiSeNet(
                attr_groups=self.attr_groups,
                mask_groups=self.mask_groups,
                max_batch_size=self.batch_size,
                weights_dir=self.weights_dir,
                device=self._device,
                mesh=self.mesh,
            )

    def _init_fused(self):
        """Builds the fused pipeline, which needs the detector."""
        self._fused = None
        #: Source shapes granted the fused path (see the module docstring);
        #: locked, since worker threads race on check-then-add.
        self._fused_shapes: set = set()
        self._fused_shapes_lock = threading.Lock()
        if self.det_model is not None:
            from .pipeline import FusedPipeline

            self._fused = FusedPipeline(
                det_model=self.det_model,
                target_landmarks=self.landmarks_target,
                output_size=self.output_size,
                border_mode=self.padding,
                allow_skew=self.allow_skew,
                crop_source=self.crop_source,
                enh_model=self.enh_model,
                mesh=self.mesh,
            )

    def _init_landmarks_target(self):
        """Builds the scaled/centered 5-point alignment target template."""
        self.landmarks_target = make_target_landmarks(
            self.output_size, self.face_factor, self.num_std_landmarks
        )

    def _host_crop_enabled(self) -> bool:
        """Whether detected faces are fitted and warped on the host.

        The JAX ``_host_crop_enabled`` (``cropper.py:275-310``):
        ``FCPT_HOST_CROP`` "0" off, "1" on, "auto" (default) on when the
        native host warp is built, but in the port on the CPU only (see
        the module docstring).  Never on a mesh (shard-local warps scale
        with it; the host would serialize them) nor under
        ``crop_source="interim"``, whose interim exists only on the device.
        Callers also need no enhancer (gated crops sample the device's
        enhanced interim) and no parser handoff.  In this mode fused groups run the detect-only
        program; with the library missing the forced mode still warps on
        the device (:meth:`_native_warp` gives None).
        """
        env = os.environ.get("FCPT_HOST_CROP", "auto")
        if env == "0" or self.mesh is not None or self.crop_source != "original":
            return False
        if env == "1":
            return True
        return self._device.type == "cpu" and native_io.native_warp_available(self.padding)

    def _fused_eligible(self, shape, count: int) -> bool:
        """Grants/uses the fused path for a source shape (bounded set)."""
        if self._fused is None:
            return False
        with self._fused_shapes_lock:
            if shape in self._fused_shapes:
                return True
            if (
                len(self._fused_shapes) < self.max_fused_shapes
                and count >= max(2, self.batch_size // 2)
            ):
                self._fused_shapes.add(shape)
                return True
        return False

    def _empty(self) -> tuple[np.ndarray, np.ndarray]:
        return (
            np.zeros((0,) + self.output_size[::-1] + (3,), np.uint8),
            np.zeros((0,), np.int64),
        )

    def _fused_process(self, batch: np.ndarray, return_device_crops: bool = False, **kw):
        """The fused path for a uniform group: (crops, landmarks, indices),
        and with ``return_device_crops`` the crops on the device (or None;
        see :meth:`.pipeline.FusedPipeline.process`, which takes ``kw``).

        A group below ``batch_size`` is padded to it by repeating its last
        image, as the JAX package pads (``cropper.py:1240-1242``), and only
        its real rows surface: cuDNN's algorithm picks for other batch
        sizes can be several times slower (:mod:`.utils.batching`).
        """
        with self._locked():
            return self._fused.process(self._pad_group(batch), self.resize_size,
                                       return_device_crops=return_device_crops,
                                       valid_n=len(batch), **kw)

    def _pad_group(self, batch: np.ndarray) -> np.ndarray:
        """A fused group padded to ``batch_size`` by repeating its last row."""
        return batch if len(batch) >= self.batch_size else pad_batch_to(batch, self.batch_size)[0]

    def _host_crop_group(self, batch: np.ndarray, packed_hw=None, host_pack: bool = False):
        """The host-crop mode for one uniform group: (crops, indices).

        The detect-only program runs on the device (the batch padded as
        :meth:`_fused_process` pads it); the host fits the transforms with
        the numpy twins and warps (:meth:`_align_crop_filtered` with
        ``prefer_native``), outside the device lock.  Packed rows
        (``packed_hw``) are warped from the numpy twin of the device's
        reconstruction, or with ``host_pack`` straight from the stored
        planes into packed rows (:meth:`_align_crop_yuv_rows`); with
        ``host_pack`` RGB crops are packed on the host too.  The JAX
        ``process_batch``'s host-crop branch (``cropper.py:1244-1292``).
        """
        with self._locked():
            lm, loc = self._fused.detect_only(self._pad_group(batch), self.resize_size,
                                              valid_n=len(batch), packed_hw=packed_hw)
        if len(lm) == 0:
            return self._empty()
        if packed_hw is not None and host_pack:
            rows = self._align_crop_yuv_rows(batch, packed_hw, loc, lm)
            if rows is not None:
                return rows
        src = batch
        if packed_hw is not None:
            src = native_io.yuv420_to_rgb_native(batch, *packed_hw)
            if src is None:
                src = yuv420_to_rgb_np(batch, *packed_hw)
        crops, loc = self._align_crop_filtered(src, None, loc, lm, prefer_native=True)
        if host_pack and len(crops):
            crops = rgb_to_yuv420_np(crops)
        return crops, loc

    def _parse(self, faces, src_hw=None) -> tuple:
        """(attr_groups, mask_groups) of host crops or device crops (or of
        packed 4:2:0 rows of ``src_hw``)."""
        if self.par_model is None:
            return None, None
        with self.stats.stage("parse", len(faces)), self._locked():
            return self.par_model.predict(faces, src_hw=src_hw)

    # ------------------------------------------------------------------
    # Geometry: fits and warps
    # ------------------------------------------------------------------

    def _estimate(self, landmarks: np.ndarray, host: bool = False):
        """Transform fits: host (F, 2, 3) float32 matrices and bool validity.

        Without a detector and an enhancer (or with ``host``) the numpy
        twins fit on the host, as the JAX ``_estimate`` does; otherwise the
        torch fits run on the device.
        """
        if host or (self.det_model is None and self.enh_model is None):
            fit = estimate_affine_np if self.allow_skew else estimate_similarity_np
            return fit(landmarks, np.asarray(self.landmarks_target))
        fit = estimate_affine if self.allow_skew else estimate_similarity
        target = torch.from_numpy(np.asarray(self.landmarks_target, np.float32))
        with self._locked():
            matrices, valid = fit(torch.from_numpy(landmarks).to(self._device), target)
            with wait_device(self._stats):
                return matrices.cpu().numpy(), valid.cpu().numpy()

    def crop_align(self, images, padding, indices, landmarks_source) -> np.ndarray:
        """Aligns and center-crops every face: (F', Ho, Wo, 3) uint8 crops.

        The JAX ``crop_align`` (``cropper.py:412-441``).  ``images`` is a
        uniform (N, H, W, 3) uint8 batch or a list of ragged images;
        ``padding`` optional (N, 4) per-image paddings (top, bottom, left,
        right) that crops must not sample; ``indices`` each face's image;
        ``landmarks_source`` (F, 5, 2) landmarks in un-padded coordinates.
        Faces whose transform cannot be fitted are dropped.
        """
        return self._align_crop_filtered(images, padding, indices, landmarks_source)[0]

    def _align_crop_filtered(self, images, paddings, indices, landmarks,
                             prefer_native: bool = False):
        """Fits and warps faces, dropping degenerate fits with their indices.

        Counterpart of the JAX ``_align_crop_filtered`` (``:443-489``).

        Args:
            images: A uniform uint8 (N, H, W, 3) batch (host array or
                device tensor) or a list of ragged host images.
            paddings: Optional (N, 4) per-image paddings (top, bottom, left,
                right) that crops must not sample (uniform batches).
            indices: Length-F map from each face to its source image.
            landmarks: (F, 5, 2) source landmarks in un-padded coordinates.
            prefer_native: Fit with the numpy twins and warp on the host
                (the host-crop mode) when the native warp is there.

        Returns:
            Tuple of uint8 crops (F', Ho, Wo, 3) and int64 indices (F',).
        """
        indices = np.asarray(indices, np.int64)
        landmarks = np.ascontiguousarray(landmarks, np.float32)
        matrices, valid = self._estimate(landmarks, host=prefer_native)
        pos = np.nonzero(valid)[0]
        if len(pos) == 0:
            return self._empty()
        indices = indices[pos]
        matrices = np.asarray(matrices, np.float32)[pos]
        if torch.is_tensor(images) or (isinstance(images, np.ndarray) and images.ndim == 4):
            crops = self._warp_uniform(images, paddings, indices, matrices, prefer_native)
        else:
            crops = self._warp_ragged(images, indices, matrices, prefer_native)
        return crops, indices

    def _native_warp(self, images, matrices, indices, windows, force: bool = False):
        """The host warp's crops, or None where the device warps.

        The JAX ``_native_warp`` (``cropper.py:498-548``): the host warps
        when neither a detector nor an enhancer runs on the CPU, in the
        host-crop mode (``force``, or staged crops while
        :meth:`_host_crop_enabled`), and only when the native library is
        built and ``FCPT_NATIVE_WARP`` is not "0"; never on a mesh.  Pixels
        already on a card stay there for the warp kernel.  Threads: the
        host's cores over ``num_processes``; 10-bit fixed point unless
        ``FCPT_WARP_EXACT=1``.
        """
        if self.mesh is not None or os.environ.get("FCPT_NATIVE_WARP") == "0":
            return None
        if torch.is_tensor(images) and images.device.type != "cpu":
            return None
        pure_host = (self.det_model is None and self.enh_model is None
                     and self._device.type == "cpu")
        if not (force or pure_host or self._host_crop_enabled()):
            return None
        if not native_io.native_warp_available(self.padding):
            return None
        if torch.is_tensor(images):
            images = images.numpy()
        return native_io.warp_affine_batch_native(
            images, matrices, indices, self.output_size, self.padding, windows,
            n_threads=_host_threads(self.num_processes),
            exact=os.environ.get("FCPT_WARP_EXACT") == "1",
        )

    def _warp_uniform(self, images, padding, indices, matrices, prefer_native=False) -> np.ndarray:
        """Warps faces out of a uniform batch: on the host, or through the
        warp kernel's wrapper.

        Counterpart of the JAX ``_warp_uniform`` (``:550-600``): per-face
        windows come from the paddings.  On the device the batch goes up
        (unless it is there already) and faces go in chunks of
        :attr:`max_warp_chunk`, each warped exactly (no power-of-two
        bucket), under the device lock.
        """
        windows = None
        if padding is not None:
            pad = np.asarray(padding, np.int64)
            h = images.shape[1] - pad[:, 0] - pad[:, 1]
            w = images.shape[2] - pad[:, 2] - pad[:, 3]
            windows = np.stack([pad[:, 0], pad[:, 2], h, w], axis=1)[indices].astype(np.int32)
        native = self._native_warp(images, matrices, indices, windows, force=prefer_native)
        if native is not None:
            return native
        f = len(indices)
        crops = np.empty((f,) + self.output_size[::-1] + (3,), np.uint8)
        if not torch.is_tensor(images):
            images = torch.from_numpy(np.ascontiguousarray(images))
        with self._locked():
            with wait_device(self._stats):  # a blocking copy from pageable memory
                images = images.to(self._device)
            mats = torch.from_numpy(np.ascontiguousarray(matrices, np.float32)).to(self._device)
            for s in range(0, f, self.max_warp_chunk):
                e = min(s + self.max_warp_chunk, f)
                idx = torch.from_numpy(indices[s:e].astype(np.int32)).to(self._device)
                win = None if windows is None else torch.from_numpy(windows[s:e]).to(self._device)
                self._stats.count("warp_crops", e - s, size=self.output_size)
                out = warp_affine_u8(images, mats[s:e], idx, self.output_size, self.padding, win)
                self._stats.count("bytes_home", crops[s:e].nbytes)
                with wait_device(self._stats):
                    torch.from_numpy(crops[s:e]).copy_(out)
        return crops

    def _warp_ragged(self, images, indices, matrices, prefer_native=False) -> np.ndarray:
        """Warps faces from ragged images, one uniform warp per source shape.

        Counterpart of the JAX ``_warp_ragged`` (``:602-654``): each shape's
        images are stacked and warped on the host or, where the device
        warps, uploaded and warped by the kernel.
        """
        shapes: defaultdict[tuple, list[int]] = defaultdict(list)
        for face_i, img_i in enumerate(indices):
            shapes[images[img_i].shape].append(face_i)
        crops = np.empty((len(indices),) + self.output_size[::-1] + (3,), np.uint8)
        for face_ids in shapes.values():
            img_ids = sorted({int(indices[i]) for i in face_ids})
            remap = {g: k for k, g in enumerate(img_ids)}
            stack = np.stack([images[g] for g in img_ids])
            local = np.array([remap[int(indices[i])] for i in face_ids], np.int64)
            crops[face_ids] = self._warp_uniform(stack, None, local, matrices[face_ids],
                                                 prefer_native)
        return crops

    # ------------------------------------------------------------------
    # The packed 4:2:0 wire and the YUV-direct crops
    # ------------------------------------------------------------------

    def _pack_allowed(self, var: str) -> bool:
        """Whether the switch ``var`` allows packing: "1" forces it, "0"
        forbids it, "auto" allows it off the CPU (on the CPU there is no
        link to save)."""
        mode = os.environ.get(var, "auto")
        return mode == "1" or (mode != "0" and self._device.type != "cpu")

    def _packed_fetch_eligible(self, file_names, parser_handoff: bool = False) -> bool:
        """Whether this batch's crops come down as device-packed 4:2:0 rows.

        The JAX ``_packed_fetch_eligible`` (``cropper.py:660-704``): a
        fused pipeline, no parser reading host crops (with the handoff the
        parser reads the RGB device crops), even output dimensions,
        ``FCPT_PACK_FETCH`` not "0" ("auto" holds off on the CPU), only
        JPEG outputs (the packing is the JPEG encoder's lossy front half)
        and the native raw-data encoder built.
        """
        if self._fused is None or (self.par_model is not None and not parser_handoff):
            return False
        w, h = self.output_size
        if w % 2 or h % 2 or w < 2 or h < 2:
            return False
        if not self._pack_allowed("FCPT_PACK_FETCH") or not self._jpeg_bound(file_names):
            return False
        return native_io.yuv_encoder_available()

    def _packed_upload_eligible(self) -> bool:
        """Whether sources may upload as stored 4:2:0 planes.

        The JAX ``_packed_upload_eligible`` (``cropper.py:706-761``): the
        fused detect path with ``crop_source="original"``, or the
        landmark-free mode with an enhancer or a parser;
        ``FCPT_PACK_UPLOAD`` not "0" ("auto" holds off on the CPU); and the
        native 4:2:0 decoder built.  Without it every source decodes to
        RGB, whatever ``FCPT_PACK_UPLOAD`` says.
        """
        fused_detect = (self._fused is not None and self.landmarks is None
                        and self.crop_source == "original")
        pure_no_crop = (self.landmarks is None and self.det_model is None
                        and (self.enh_model is not None or self.par_model is not None))
        if not (fused_detect or pure_no_crop):
            return False
        return self._pack_allowed("FCPT_PACK_UPLOAD") and native_io.yuv_encoder_available()

    def _yuv_crop_eligible(self) -> bool:
        """Whether landmark-file crops run in 4:2:0 end to end.

        The JAX ``_yuv_crop_eligible`` (``cropper.py:763-804``): plain 4:2:0
        JPEG sources decode to their planes, faces warp per plane
        (:func:`.utils.native_io.warp_yuv420_batch_native`) and the packed
        rows feed the raw-data encoder, within the 4:2:0 band of the RGB
        path.  Needs the landmark-file mode with no model, JPEG outputs of
        even size, the native library, none of ``FCPT_YUV_CROP=0``,
        ``FCPT_WARP_EXACT=1``, ``FCPT_NATIVE_WARP=0``, and on a card
        ``FCPT_YUV_CROP=1`` (there the warp kernel crops by default).
        """
        if not self._yuv_switches_on():
            return False
        if self._device.type != "cpu" and os.environ.get("FCPT_YUV_CROP") != "1":
            return False
        if self.landmarks is None or self.det_model is not None:
            return False
        if self.enh_model is not None or self.par_model is not None:
            return False
        if self.output_format is not None and self.output_format.lower() not in ("jpg", "jpeg"):
            return False
        return self._yuv_rows_possible()

    def _yuv_switches_on(self) -> bool:
        """No switch forbids the YUV-direct crops."""
        return (os.environ.get("FCPT_YUV_CROP", "auto") != "0"
                and os.environ.get("FCPT_WARP_EXACT") != "1"
                and os.environ.get("FCPT_NATIVE_WARP") != "0")

    def _yuv_rows_possible(self) -> bool:
        """No mesh (the JAX ``cropper.py:792``), even output sides, and the
        native 4:2:0 warp and encoder built."""
        if self.mesh is not None:
            return False
        wo, ho = self.output_size
        if wo % 2 or ho % 2 or min(wo, ho) < 2:
            return False
        return native_io.yuv_encoder_available() and native_io.warp_yuv420_available(self.padding)

    def _host_yuv_rows_ok(self, file_names) -> bool:
        """Detection-mode twin of :meth:`_yuv_crop_eligible`'s output gate.

        In the host-crop mode with packed uploads, crops may warp straight
        from the stored planes into packed rows when every output of the
        batch is a JPEG of even size.  Unlike the JAX package
        (``cropper.py:872-893``), ``FCPT_NATIVE_WARP=0`` switches this off
        as it does :meth:`_yuv_crop_eligible`.
        """
        return (self._yuv_switches_on() and self._jpeg_bound(file_names)
                and self._yuv_rows_possible())

    def _align_crop_yuv(self, images, indices, landmarks):
        """Landmark-file crops in packed 4:2:0 space (see
        :meth:`_yuv_crop_eligible`).

        Packed sources warp per plane straight to packed crop rows; RGB
        entries of the batch (other samplings, rotated files) warp on the
        host as RGB.  Returns a per-face list (1-D packed rows and/or
        (Ho, Wo, 3) crops, in face order) and the filtered int64 indices;
        :meth:`save_group` writes both forms.  The JAX ``_align_crop_yuv``
        (``cropper.py:806-870``).
        """
        indices = np.asarray(indices, np.int64)
        matrices, valid = self._estimate(np.ascontiguousarray(landmarks, np.float32), host=True)
        pos = np.nonzero(valid)[0]
        if len(pos) == 0:
            return [], np.zeros((0,), np.int64)
        indices = indices[pos]
        matrices = np.asarray(matrices, np.float32)[pos]
        out: list = [None] * len(indices)
        packed_face = np.array([isinstance(images[i], PackedYUVImage) for i in indices], bool)
        rgb_ks = [int(k) for k in np.nonzero(~packed_face)[0]]
        by_hw: defaultdict[tuple, list[int]] = defaultdict(list)
        for k in np.nonzero(packed_face)[0]:
            im = images[indices[k]]
            by_hw[(im.h, im.w)].append(int(k))
        for hw, ks in by_hw.items():
            uniq, local = np.unique(indices[ks], return_inverse=True)
            rows = native_io.warp_yuv420_batch_native(
                np.stack([images[i].packed for i in uniq]), hw, matrices[ks],
                local.astype(np.int32), self.output_size, self.padding,
                n_threads=_host_threads(self.num_processes),
            )
            if rows is None:  # pragma: no cover - gated by _yuv_crop_eligible
                rgb_ks.extend(ks)
                continue
            for j, k in enumerate(ks):
                out[k] = rows[j]
        if rgb_ks:
            rgb_ks = np.asarray(sorted(rgb_ks))
            crops = self._warp_ragged(unpack_images(list(images)), indices[rgb_ks],
                                      matrices[rgb_ks], prefer_native=True)
            for j, k in enumerate(rgb_ks):
                out[int(k)] = crops[j]
        return out, indices

    def _align_crop_yuv_rows(self, rows, src_hw, indices, landmarks):
        """Fits (numpy twins), filters and warps straight from packed source
        rows: (packed crop rows (F', L), int64 indices (F',)), or None when
        the native warp is missing.  The JAX ``_align_crop_yuv_rows``
        (``cropper.py:895-932``)."""
        indices = np.asarray(indices, np.int64)
        matrices, valid = self._estimate(np.ascontiguousarray(landmarks, np.float32), host=True)
        pos = np.nonzero(valid)[0]
        if len(pos) == 0:
            return np.zeros((0, packed_length(self.output_size)), np.uint8), indices[:0]
        indices = indices[pos]
        out = native_io.warp_yuv420_batch_native(
            rows, src_hw, np.asarray(matrices, np.float32)[pos], indices.astype(np.int32),
            self.output_size, self.padding, n_threads=_host_threads(self.num_processes),
        )
        return None if out is None else (out, indices)

    def _jpeg_bound(self, file_names) -> bool:
        """Whether every output of this batch will be a JPEG file."""
        if self.output_format is not None:
            return self.output_format.lower() in ("jpg", "jpeg")
        return all(str(n).lower().endswith((".jpg", ".jpeg")) for n in file_names)

    # ------------------------------------------------------------------
    # The staged path
    # ------------------------------------------------------------------

    def _staged_pad_size(self, n: int) -> int:
        """The batch size the staged detect runs n images at: the smallest
        of :data:`STAGED_PAD_SIZES` (up to ``batch_size``) and
        ``batch_size`` that holds them, or n itself above ``batch_size``."""
        sizes = {s for s in STAGED_PAD_SIZES if s <= self.batch_size} | {self.batch_size}
        return min((s for s in sizes if s >= n), default=n)

    def _detect_interim(self, images: list[np.ndarray]):
        """Detects faces on the host-resized interim batch.

        Counterpart of the JAX ``_detect_interim`` (``:1074-1100``):
        ``as_batch`` to the interim size, the batch padded by repeating its
        last image to :meth:`_staged_pad_size` (where the JAX package pads
        to ``batch_size``), one upload, detection, the faces of padding
        rows dropped, and landmark coordinates un-padded.

        Returns:
            Tuple of the uint8 interim batch (N, H, W, 3) on the device,
            its paddings (N, 4), landmarks (F, 5, 2) in un-padded interim
            coordinates, and the face→image index list (F,).
        """
        batch, _, paddings = as_batch(images, self.resize_size)
        n_true = len(batch)
        batch, _ = pad_batch_to(batch, self._staged_pad_size(n_true))
        self._stats.count("bytes_up", batch.nbytes)
        with self._locked():
            with wait_device(self._stats):  # a blocking copy from pageable memory
                batch = torch.from_numpy(batch).to(self._device)
            landmarks, indices = self.det_model.predict(batch)
        keep = [j for j, i in enumerate(indices) if i < n_true]
        landmarks, indices = landmarks[keep], [indices[j] for j in keep]
        if len(landmarks) > 0:
            landmarks = landmarks - paddings[indices][:, None, [2, 0]]
        return batch[:n_true], paddings, landmarks, indices

    def _detect_crop_staged(self, images: list[np.ndarray]):
        """Staged detect → (gated enhance) → align → crop for a ragged list.

        Counterpart of the JAX ``_detect_crop_staged`` (``:1102-1130``):
        with an enhancer, the gated rows of the interim batch are
        super-resolved on the device before their faces crop from it.  In
        the host-crop mode the crops warp on the host (:meth:`_native_warp`).

        Returns:
            Tuple of uint8 crops (F, Ho, Wo, 3) and int64 local image
            indices (F,).
        """
        with self.stats.stage("detect", len(images)):
            batch, paddings, landmarks, indices = self._detect_interim(images)
            if len(landmarks) == 0:
                return self._empty()
        if self.enh_model is not None:
            with self.stats.stage("enhance", len(batch)), self._locked():
                batch = self.enh_model.predict(batch, landmarks, list(indices))
        with self.stats.stage("crop", len(landmarks)):
            return self._align_crop_filtered(batch, paddings, indices, landmarks)

    # ------------------------------------------------------------------
    # Saving
    # ------------------------------------------------------------------

    def _crop_file_name(self, source_name: str, occurrence: int) -> str:
        """Output file name for the ``occurrence``-th face of a source image.

        ``output_format`` overrides the extension; with ``strategy="all"``
        a ``_<occurrence>`` suffix keeps names unique.
        """
        stem, ext = os.path.splitext(source_name)
        if self.output_format is not None:
            ext = "." + self.output_format
        if self.strategy == "all":
            stem = f"{stem}_{occurrence}"
        return stem + ext

    def save_group(self, faces, file_names, output_dir: str):
        """Writes one group of faces (RGB), masks (2-D) or packed 4:2:0 rows
        (1-D, or :class:`.utils.io.PackedYUVImage` sources) into one
        directory.

        Names come from :meth:`_crop_file_name`; an empty group creates no
        directory.  Under strategy "all" each source's occurrence 0 is
        written last: its existence is the resume marker
        ``process_dir(skip_existing=True)`` checks, so it must imply the
        source's other faces already landed.  Packed rows go to the native
        raw-data JPEG encoder; a packed source (the landmark-free mode)
        does too when its target is a JPEG (its stored samples are written
        back), else it is reconstructed to RGB (the JAX ``save_group``,
        ``cropper.py:960-1021``).
        """
        if len(faces) == 0:
            return
        os.makedirs(output_dir, exist_ok=True)
        seen: defaultdict[str, int] = defaultdict(int)
        writes = []
        for face, source in zip(faces, file_names):
            writes.append((seen[source], source, face))
            seen[source] += 1
        if self.strategy == "all":
            writes = [w for w in writes if w[0] != 0] + [w for w in writes if w[0] == 0]
        for occurrence, source, face in writes:
            path = os.path.join(output_dir, self._crop_file_name(source, occurrence))
            if isinstance(face, PackedYUVImage):
                if path.lower().endswith((".jpg", ".jpeg")) and imwrite_yuv420(
                    path, face.packed, (face.w, face.h)
                ):
                    continue
                face = face.to_rgb()
            face = np.asarray(face)
            if face.ndim == 1:
                imwrite_yuv420(path, face, self.output_size)
            else:
                imwrite(path, face)

    def save_groups(self, faces, file_names, output_dir: str, attr_groups, mask_groups):
        """Saves faces (and masks) into the attr × mask tree.

        Counterpart of the JAX ``save_groups`` (``:1023-1068``): no grouping
        puts everything in ``output_dir``; attribute groups give one
        sub-directory each; mask groups give ``<mask>`` plus a
        ``<mask>_mask`` sibling of 0/255 masks; both give
        ``output_dir/<attr>/<mask>[_mask]`` holding the intersection, in
        ascending face order.  ``faces`` may be a list of ragged images
        (the landmark-free mode).
        """
        n = len(faces)
        attr_cells = {"": list(range(n))} if attr_groups is None else attr_groups
        mask_cells = {"": (list(range(n)), None)} if mask_groups is None else mask_groups
        for attr_name, attr_members in attr_cells.items():
            attr_set = set(attr_members)
            for mask_name, (mask_members, masks) in mask_cells.items():
                # ``pos`` is a member's row in the mask group's mask stack.
                cell = sorted((face_i, pos) for pos, face_i in enumerate(mask_members)
                              if face_i in attr_set)
                if not cell:
                    continue
                members = [face_i for face_i, _ in cell]
                names = [file_names[i] for i in members]
                cell_dir = os.path.join(output_dir, attr_name, mask_name)
                self.save_group([faces[i] for i in members], names, cell_dir)
                if masks is not None:
                    self.save_group(masks[[pos for _, pos in cell]], names, cell_dir + "_mask")

    # ------------------------------------------------------------------
    # Entry points
    # ------------------------------------------------------------------

    def process_images(
        self, images: list[np.ndarray] | np.ndarray
    ) -> tuple[np.ndarray, np.ndarray, tuple]:
        """In-memory serving API: images → (crops, indices, groups).

        Args:
            images: Uniform (N, H, W, 3) uint8 batch or a list of RGB arrays
                (of one shape or ragged).

        Returns:
            Tuple of uint8 crops (F, Ho, Wo, 3), int64 face→image indices
            (F,), and the (attr_groups, mask_groups) pair of the crops
            (None elements when grouping is not configured).

        Raises:
            ValueError: Without a detector (the landmark-file and
                landmark-free modes).

        While tracing, the call is the span "request" (items: the images)
        under a request id of its own.
        """
        if self.det_model is None:
            raise ValueError(
                "process_images requires an active detector "
                "(det_threshold must be set and landmarks must be None)."
            )
        with self._stats.span("request", len(images), request=True):
            if isinstance(images, np.ndarray):
                images = list(images)
            if len(images) == 0:
                return (*self._empty(), (None, None))
            uniform = len({im.shape for im in images}) == 1
            if uniform and self._fused_eligible(images[0].shape, len(images)):
                if self.enh_model is None and self._host_crop_enabled():
                    crops, indices = self._host_crop_group(np.stack(images))
                else:
                    crops, _lm, indices = self._fused_process(np.stack(images))
            else:
                crops, indices = self._detect_crop_staged(images)
            self._stats.count("faces_kept", len(crops))
            groups = self._parse(crops) if len(crops) else (None, None)
            return crops, indices, groups

    def process_images_stream(self, batches, depth: int = 2, pack_upload: bool | None = None):
        """Pipelined serving: request batches in, one ``(crops, indices,
        groups)`` tuple out per batch, in order.

        Counterpart of the JAX ``process_images_stream``
        (``cropper.py:1528-1638``).  :meth:`process_images` must wait for
        its own results, so back-to-back calls serialize the upload, the
        device's work and the host's.  This generator keeps up to ``depth``
        batches in flight: batch k+1 is uploaded and its device work
        enqueued before batch k's results are collected, so the card
        starts on the next batch while the host finishes the last one.

        Two modes keep batches in flight, each padded to ``batch_size`` as
        :meth:`process_images` pads them:

        * the host-crop mode (:meth:`_host_crop_enabled`), as in the JAX
          package: the detect-only pass in flight, fits and warps at
          collect time, any strategy;
        * otherwise (a card's default), strategies "best"/"largest": the
          whole detect→fit→warp pass in flight
          (:meth:`.pipeline.FusedPipeline.process_async`).  The JAX stream
          pipelines only the host-crop mode; on a card the port's "auto"
          keeps that mode off, so the port pipelines the path its
          :meth:`process_images` runs there.

        An empty, ragged or ineligible batch, strategy "all" outside the
        host-crop mode, and every batch of a configuration with an enhancer
        or a mesh (as in the JAX stream, whose host-crop mode a mesh turns
        off) first drain the queue and then run as :meth:`process_images`.
        Each result equals :meth:`process_images` of the same batch (also when
        a batch grows the detector's caps while later batches are in
        flight: their collect re-runs them with the grown caps), except
        under ``pack_upload``.  Parsing runs at collect time.  The device
        lock is held around each dispatch and each collect, never across a
        ``yield``.

        Args:
            batches: Iterable of uniform (N, H, W, 3) uint8 batches or
                lists of RGB arrays (a request stream).
            depth: Most batches in flight after a collect (at least 1).
            pack_upload: In the host-crop mode, send the detector's input
                as packed YCbCr 4:2:0 rows (1.5 B a pixel) when H and W are
                even; crops still warp from the caller's RGB pixels, and
                detection sees the 4:2:0 round trip of its input.  No
                effect in the other mode.  None reads ``FCPT_SERVE_PACK``
                ("1" on, anything else off).

        While tracing, each batch kept in flight records the spans
        "stream.dispatch" and "stream.collect" under one request id.

        Yields:
            The :meth:`process_images` result tuple for each input batch.

        Raises:
            ValueError: Without a detector.
        """
        if self.det_model is None:
            raise ValueError(
                "process_images_stream requires an active detector "
                "(det_threshold must be set and landmarks must be None)."
            )
        depth = max(1, int(depth))
        if pack_upload is None:
            pack_upload = os.environ.get("FCPT_SERVE_PACK") == "1"
        queue: deque = deque()
        for images in batches:
            if isinstance(images, np.ndarray):
                images = list(images)
            item = self._stream_dispatch(images, pack_upload)
            if item is None:
                while queue:
                    yield self._stream_collect(queue.popleft())
                yield self.process_images(images)
                continue
            queue.append(item)
            while len(queue) > depth:
                yield self._stream_collect(queue.popleft())
        while queue:
            yield self._stream_collect(queue.popleft())

    def _stream_dispatch(self, images: list, pack_upload: bool):
        """Puts one stream batch in flight: (batch, host crop?, handle,
        request id), or None when the batch runs as :meth:`process_images`.

        The shape is granted last (:meth:`_fused_eligible` records it).
        Packed uploads are keyed ``("yuv420", h, w)``, the key packed
        groups take in :meth:`_process_detected`.
        """
        if (not images or len({im.shape for im in images}) > 1 or self.enh_model is not None
                or self.mesh is not None):
            return None
        host_crop = self._host_crop_enabled()
        if not (host_crop or self._fused.single_program):
            return None
        batch = np.stack(images)
        h, w = batch.shape[1:3]
        packed = host_crop and pack_upload and h % 2 == 0 and w % 2 == 0
        if not self._fused_eligible(("yuv420", h, w) if packed else images[0].shape, len(batch)):
            return None
        with self._stats.span("stream.dispatch", len(batch), request=True) as span:
            padded = self._pad_group(batch)
            with self._locked():
                if not host_crop:
                    handle = self._fused.process_async(padded, self.resize_size,
                                                       valid_n=len(batch))
                elif packed:
                    handle = self._fused.detect_only_async(
                        rgb_to_yuv420_np(padded), self.resize_size, valid_n=len(batch),
                        packed_hw=(h, w))
                else:
                    handle = self._fused.detect_only_async(padded, self.resize_size,
                                                           valid_n=len(batch))
        return batch, host_crop, handle, None if span is None else span.request

    def _stream_collect(self, item) -> tuple:
        """Finishes one in-flight stream batch: what :meth:`process_images`
        returns for it (host crops as :meth:`_host_crop_group` makes them)."""
        batch, host_crop, handle, request = item
        with self._stats.span("stream.collect", len(batch), request=request):
            if host_crop:
                with self._locked():
                    lm, loc = self._fused.detect_only_finish(handle)
                crops, indices = (
                    self._align_crop_filtered(batch, None, loc, lm, prefer_native=True)
                    if len(lm) else self._empty())
            else:
                with self._locked():
                    crops, _lm, indices = self._fused.process_finish(handle)
            self._stats.count("faces_kept", len(crops))
            groups = self._parse(crops) if len(crops) else (None, None)
            return crops, indices, groups

    def _process_landmark_free(self, images, file_names, output_dir: str, want_packed: bool):
        """The landmark-free mode: whole images pass through to the tree.

        Counterpart of the JAX ``process_batch``'s no-crop branch
        (``:1354-1366``, ``:1387-1453``): with an enhancer every image is
        enhanced (a ragged list in one bucket per shape; packed sources
        come back packed for JPEG outputs); with groups set, the originals
        are parsed whole, so they must share one shape.  Packed sources are
        parsed as rows when all are packed, else all are reconstructed.
        """
        if self.enh_model is not None:
            pack_out = want_packed and self._jpeg_bound(file_names)
            with self.stats.stage("enhance", len(images)), self._locked():
                images = self.enh_model.predict(images, None, None, pack_out=pack_out)
        groups = (None, None)
        if self.par_model is not None:
            if len({im.shape for im in images}) > 1:
                raise ValueError(
                    "Parsing without cropping requires all images to "
                    "share dimensions; resize them or enable cropping "
                    "(set det_threshold or provide landmarks)."
                )
            if all(isinstance(im, PackedYUVImage) for im in images):
                groups = self._parse(np.stack([im.packed for im in images]),
                                     src_hw=images[0].shape[:2])
            else:
                images = unpack_images(images)
                groups = self._parse(np.stack(images))
        with self.stats.stage("save", len(images)):
            self.save_groups(images, np.asarray(file_names), output_dir, *groups)

    def _process_landmarks(self, images, file_names, output_dir: str, yuv_crop: bool):
        """The landmark-file mode for one batch: the JAX ``process_batch``'s
        landmark branch (``cropper.py:1367-1385``, ``:1387-1419``).

        Each file takes every row of the landmarks that names it (none: no
        crop), reduced to 5 points when the scheme is larger; the enhancer
        gates the images; crops warp on the host (or in 4:2:0 end to end
        with ``yuv_crop``) on the CPU, or on the device on a card and
        where the host warp is missing or off; then parse and save.
        """
        indices, rows = [], []
        for i, name in enumerate(file_names):
            matches = np.nonzero(name == self.landmarks[1])[0]
            indices.extend([i] * len(matches))
            rows.extend(matches.tolist())
        landmarks = self.landmarks[0][rows]
        if len(landmarks) == 0:
            return
        if landmarks.shape[1] != self.num_std_landmarks:
            landmarks = reduce_landmarks(landmarks, self.num_std_landmarks)
        if self.enh_model is not None:
            with self.stats.stage("enhance", len(images)), self._locked():
                images = self.enh_model.predict(images, landmarks, indices)
        with self.stats.stage("crop", len(landmarks)):
            if yuv_crop:
                crops, indices = self._align_crop_yuv(images, indices, landmarks)
            else:
                crops, indices = self._align_crop_filtered(images, None, indices, landmarks)
        if len(crops) == 0:
            return
        groups = self._parse(crops)
        with self.stats.stage("save", len(crops)):
            self.save_groups(crops, np.asarray(file_names)[indices], output_dir, *groups)

    def _process_detected(self, images, file_names, output_dir: str):
        """The detection mode for one batch: the JAX ``process_batch``'s
        fused block (``cropper.py:1164-1352``).

        Images are grouped by decoded shape (packed sources apart, keyed
        ``("yuv420", h, w)``); groups that :meth:`_fused_eligible` grants
        run the fused path (or, in the host-crop mode, the detect-only
        program and host crops), the rest the staged path.  JPEG-bound
        crops of a batch with a fused group may come down packed (``pack``,
        or ``host_pack`` in the host-crop mode); its staged crops are then
        packed on the host.  With
        one fused group and nothing staged, the parser reads that group's
        crops on the device; otherwise the host crops (reconstructed from
        packed rows).
        """
        by_shape: dict[tuple, list[int]] = defaultdict(list)
        for i, im in enumerate(images):
            by_shape[getattr(im, "group_key", im.shape)].append(i)
        fused_groups, staged_ids = [], []
        for shape, ids in by_shape.items():
            if self._fused_eligible(shape, len(ids)):
                fused_groups.append(ids)
            else:
                staged_ids.extend(ids)

        # A batch without a fused group packs nothing: the JAX package runs
        # it through its generic staged block (``cropper.py:1354-1453``).
        handoff = (self.par_model is not None and self.mesh is None and len(fused_groups) == 1
                   and not staged_ids)
        host_crop = (bool(fused_groups) and self.enh_model is None and not handoff
                     and self._host_crop_enabled())
        pack = (bool(fused_groups) and not host_crop
                and self._packed_fetch_eligible(file_names, handoff))
        host_pack = host_crop and self.par_model is None and self._host_yuv_rows_ok(file_names)
        dev_crops = None
        crops_parts, idx_parts = [], []
        for ids in fused_groups:
            first = images[ids[0]]
            if isinstance(first, PackedYUVImage):
                batch, packed_hw = np.stack([images[i].packed for i in ids]), (first.h, first.w)
            else:
                batch, packed_hw = np.stack([images[i] for i in ids]), None
            with self.stats.stage("detect+crop", len(ids)):
                if host_crop:
                    crops, loc = self._host_crop_group(batch, packed_hw, host_pack)
                else:
                    result = self._fused_process(batch, return_device_crops=handoff,
                                                 pack_crops=pack, packed_hw=packed_hw)
                    crops, _lm, loc = result[:3]
                    if handoff:
                        dev_crops = result[3]
            if len(crops):
                crops_parts.append(crops)
                idx_parts.append(np.asarray(ids)[loc])
        if staged_ids:
            crops, loc = self._detect_crop_staged(unpack_images([images[i] for i in staged_ids]))
            if len(crops):
                crops_parts.append(rgb_to_yuv420_np(crops) if pack or host_pack else crops)
                idx_parts.append(np.asarray(staged_ids)[loc])
        if not crops_parts:
            return
        crops = np.concatenate(crops_parts)
        indices = np.concatenate(idx_parts)
        self._stats.count("faces_kept", len(crops))
        # The handoff tensor is a power-of-two bucket whose extra rows
        # repeat the last face: the parser gets exactly the F real rows.
        if dev_crops is not None:
            parse_in = dev_crops[: len(crops)]
        elif pack:
            parse_in = yuv420_to_rgb_np(crops, *self.output_size[::-1])
        else:
            parse_in = crops
        groups = self._parse(parse_in)
        with self.stats.stage("save", len(crops)):
            self.save_groups(crops, np.asarray(file_names)[indices], output_dir, *groups)

    def process_batch(self, file_names: list[str], input_dir: str, output_dir: str):
        """Reads, detects (or looks up) and crops, parses, and saves one batch.

        Counterpart of the JAX ``process_batch`` (``:1132-1453``), with its
        three modes: detection (:meth:`_process_detected`), the landmark
        file (:meth:`_process_landmarks`) and the landmark-free mode
        (:meth:`_process_landmark_free`).  In detection mode, oversized
        JPEGs decode at a reduced DCT scale, never below
        ``max(resize_size)``; landmark coordinates are in full-resolution
        space, so there every source decodes at its own size.  Packed
        uploads and the YUV-direct crops read plain 4:2:0 JPEGs as their
        stored planes.  While tracing, the call is the span "batch" (items:
        the files) under a request id of its own.
        """
        with self._stats.span("batch", len(file_names), request=True):
            detect = self.det_model is not None
            target_max = max(self.resize_size) if detect else None
            want_packed = self._packed_upload_eligible()
            yuv_crop = self._yuv_crop_eligible()
            with self.stats.stage("read", len(file_names)):
                images, file_names = read_images(file_names, input_dir, target_max,
                                                 want_packed=want_packed or yuv_crop)
            if len(images) == 0:
                return
            if detect:
                self._process_detected(images, file_names, output_dir)
            elif self.landmarks is not None:
                self._process_landmarks(images, file_names, output_dir, yuv_crop)
            else:
                self._process_landmark_free(images, file_names, output_dir, want_packed)

    def process_dir(
        self,
        input_dir: str,
        output_dir: str | None = None,
        desc: str | None = "Processing",
        shard_index: int | None = None,
        num_shards: int | None = None,
        skip_existing: bool = False,
    ):
        """Processes a whole directory in file batches.

        Counterpart of the JAX ``process_dir`` (``:1640-1711``): sorted
        listing, the strided shard ``files[shard_index::num_shards]``,
        ``skip_existing`` after the shard split (a source is skipped when
        ``output_dir`` already holds its crop, occurrence 0 under strategy
        "all"), ``output_dir=None`` meaning ``<input_dir>_faces``, and
        batches of ``batch_size`` files mapped over ``num_processes``
        threads that share the models and the card.

        Raises:
            RuntimeError: Before any file is read, when neither cv2 nor PIL
                is there to encode the crops.
        """
        if not encoder_available():
            raise RuntimeError("No image encoding backend available (cv2 or PIL).")
        if output_dir is None:
            output_dir = input_dir + "_faces"

        files, bs = sorted(os.listdir(input_dir)), self.batch_size
        if num_shards is not None and num_shards > 1:
            files = files[(shard_index or 0) :: num_shards]
        if skip_existing and os.path.isdir(output_dir):
            # After the shard split, so every shard keeps its partition.
            done = set(os.listdir(output_dir))
            files = [f for f in files if self._crop_file_name(f, 0) not in done]
        file_batches = [files[i : i + bs] for i in range(0, len(files), bs)]
        if len(file_batches) == 0:
            return

        worker = partial(self.process_batch, input_dir=input_dir, output_dir=output_dir)
        if self.num_processes <= 1:
            for _ in self._progress(map(worker, file_batches), len(file_batches), desc):
                pass
            return
        with ThreadPool(self.num_processes) as pool:
            imap = pool.imap_unordered(worker, file_batches)
            for _ in self._progress(imap, len(file_batches), desc):
                pass

    @staticmethod
    def _progress(iterator, total, desc):
        if desc is None:
            return iterator
        try:
            import tqdm
        except ImportError:  # pragma: no cover
            return iterator
        return tqdm.tqdm(iterator, total=total, desc=desc)
