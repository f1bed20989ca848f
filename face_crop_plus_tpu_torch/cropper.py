"""Face cropper: images or a directory → aligned face crops and groups.

Counterpart of ``face_crop_plus_tpu.cropper.Cropper`` with the same
constructor surface.  Ported: the detection configuration with strategies
"best"/"largest"/"all" and ``crop_source`` "original"/"interim", through
the in-memory serving entry point :meth:`Cropper.process_images` and the
directory pipeline :meth:`Cropper.process_dir` (read → detect and crop →
parse → save, the JAX package's tree), which the CLI
(``python -m face_crop_plus_tpu_torch``) drives; BiSeNet parsing into
``attr_groups``/``mask_groups`` (the ``<attr>/<mask>`` and ``<mask>_mask``
subtrees); gated RRDBNet x4 enhancement (``enh_threshold``: images whose
mean face factor is at or below it are super-resolved before their faces
crop); and the landmark-free mode (``det_threshold=None`` without
landmarks), where whole images pass through to the tree, enhanced when
``enh_threshold`` is set and parsed when groups are set.

Two paths crop faces, and which one a batch takes decides which pixels its
crops sample, so the routing is part of the result:

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

Everything else raises ``NotImplementedError`` naming the missing path:
the landmark-file mode, meshes, the host-crop mode (``FCPT_HOST_CROP=1``)
and packed 4:2:0 transfers (``FCPT_PACK_UPLOAD=1``,
``FCPT_PACK_FETCH=1``).
"""

from __future__ import annotations

import os
import threading
from collections import defaultdict
from functools import partial
from multiprocessing.pool import ThreadPool

import numpy as np
import torch

from .ops.cuda.warp import warp_affine_u8
from .ops.transform import estimate_affine, estimate_similarity
from .utils.batching import as_batch, pad_batch_to
from .utils.device import resolve_device
from .utils.io import encoder_available, imwrite, read_images
from .utils.landmarks import make_target_landmarks
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


class Cropper:
    """Face cropper on a CUDA card, or the CPU on request.

    Args mirror the JAX ``Cropper``; ``device`` None (or "auto") means
    "cuda" and raises when CUDA is absent — pass ``device="cpu"`` to run on
    the CPU.  ``det_model``, ``enh_model`` and ``par_model`` are None when
    their feature is off; ``stats`` accumulates per-stage wall time
    (:class:`.utils.profiling.PipelineStats`).
    """

    #: Faces per staged warp launch: bounds one launch's crop buffer
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
        landmarks=None,
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
        self.stats = PipelineStats()

        self._check_ported()
        self._device = resolve_device(device)
        self._init_models()
        self._init_landmarks_target()
        self._init_fused()
        #: One batch's device work at a time (detect, crop and parse).
        #: ``process_dir``'s worker threads overlap host decode, resize and
        #: encode with it.  Batches run together only queue on the card and
        #: add up their peak memory (~19 GiB for 16 images at a 1024²
        #: interim; four at once reached 35–74 GB on an 80 GB H100), and
        #: near its limit cuDNN may pick other algorithms, whose f32 sums
        #: round differently: the tree would depend on ``num_processes``.
        self._device_lock = threading.Lock()

    def _check_ported(self):
        """Raises for configurations whose paths are not ported yet."""
        missing = []
        if self.landmarks is not None:
            missing.append("the landmark-file mode")
        if self.mesh is not None:
            missing.append("meshes")
        if os.environ.get("FCPT_HOST_CROP") == "1":
            missing.append("the host-crop mode (FCPT_HOST_CROP=1)")
        if "1" in (os.environ.get("FCPT_PACK_UPLOAD"), os.environ.get("FCPT_PACK_FETCH")):
            missing.append("packed 4:2:0 transfers (FCPT_PACK_UPLOAD/FCPT_PACK_FETCH=1)")
        if missing:
            raise NotImplementedError(
                "face_crop_plus_tpu_torch does not port these paths yet: "
                + ", ".join(missing)
            )

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
            )
        if self.enh_threshold is not None:
            from .models.enhancement import RRDBNet

            self.enh_model = RRDBNet(
                min_face_factor=self.enh_threshold,
                weights_dir=self.weights_dir,
                device=self._device,
            )
        if self.attr_groups is not None or self.mask_groups is not None:
            from .models.parsing import BiSeNet

            self.par_model = BiSeNet(
                attr_groups=self.attr_groups,
                mask_groups=self.mask_groups,
                max_batch_size=self.batch_size,
                weights_dir=self.weights_dir,
                device=self._device,
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
            )

    def _init_landmarks_target(self):
        """Builds the scaled/centered 5-point alignment target template."""
        self.landmarks_target = make_target_landmarks(
            self.output_size, self.face_factor, self.num_std_landmarks
        )

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

    def _fused_process(self, batch: np.ndarray, return_device_crops: bool = False):
        """The fused path for a uniform group: (crops, landmarks, indices),
        and with ``return_device_crops`` the crops on the device (or None;
        see :meth:`.pipeline.FusedPipeline.process`).

        A group below ``batch_size`` is padded to it by repeating its last
        image, as the JAX package pads (``cropper.py:1240-1242``), and only
        its real rows surface: cuDNN's algorithm picks for other batch
        sizes can be several times slower (:mod:`.utils.batching`).
        """
        n_true = len(batch)
        if n_true < self.batch_size:
            batch, _ = pad_batch_to(batch, self.batch_size)
        with self._device_lock:
            return self._fused.process(batch, self.resize_size,
                                       return_device_crops=return_device_crops,
                                       valid_n=n_true)

    def _parse(self, faces) -> tuple:
        """(attr_groups, mask_groups) of host crops or device crops."""
        if self.par_model is None:
            return None, None
        with self.stats.stage("parse", len(faces)), self._device_lock:
            return self.par_model.predict(faces)

    # ------------------------------------------------------------------
    # The staged path
    # ------------------------------------------------------------------

    def _estimate(self, landmarks: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
        """Batched transform fit on the device: (F, 2, 3) matrices, validity."""
        fit = estimate_affine if self.allow_skew else estimate_similarity
        src = torch.from_numpy(np.asarray(landmarks, np.float32)).to(self._device)
        return fit(src, torch.from_numpy(np.asarray(self.landmarks_target, np.float32)))

    def _align_crop_filtered(self, images: torch.Tensor, paddings, indices, landmarks):
        """Fits and warps faces out of a uniform batch, dropping degenerate fits.

        Counterpart of the JAX ``_align_crop_filtered`` (``:443-484``) for a
        uniform batch: a face whose transform cannot be estimated is dropped
        together with its index.

        Args:
            images: uint8 (N, H, W, 3) sources on the device.
            paddings: Optional (N, 4) per-image paddings (top, bottom, left,
                right) that crops must not sample.
            indices: Length-F map from each face to its source image.
            landmarks: (F, 5, 2) source landmarks in un-padded coordinates.

        Returns:
            Tuple of uint8 crops (F', Ho, Wo, 3) and int64 indices (F',).
        """
        indices = np.asarray(indices, np.int64)
        matrices, valid = self._estimate(landmarks)
        pos = np.nonzero(valid.cpu().numpy())[0]
        if len(pos) == 0:
            return self._empty()
        indices = indices[pos]
        matrices = matrices.index_select(0, torch.from_numpy(pos).to(self._device))
        return self._warp_uniform(images, paddings, indices, matrices), indices

    def _warp_uniform(self, images: torch.Tensor, padding, indices, matrices) -> np.ndarray:
        """Warps faces out of a uniform batch through the warp kernel's wrapper.

        Counterpart of the device branch of the JAX ``_warp_uniform``
        (``:550-600``): per-face windows come from the paddings, and faces
        go in chunks of :attr:`max_warp_chunk`, each warped exactly (no
        power-of-two bucket).
        """
        windows = None
        if padding is not None:
            pad = np.asarray(padding, np.int64)
            h = images.shape[1] - pad[:, 0] - pad[:, 1]
            w = images.shape[2] - pad[:, 2] - pad[:, 3]
            windows = np.stack([pad[:, 0], pad[:, 2], h, w], axis=1)[indices].astype(np.int32)
        f = len(indices)
        crops = np.empty((f,) + self.output_size[::-1] + (3,), np.uint8)
        for s in range(0, f, self.max_warp_chunk):
            e = min(s + self.max_warp_chunk, f)
            idx = torch.from_numpy(indices[s:e].astype(np.int32)).to(self._device)
            win = None if windows is None else torch.from_numpy(windows[s:e]).to(self._device)
            out = warp_affine_u8(
                images, matrices[s:e], idx, self.output_size, self.padding, win
            )
            torch.from_numpy(crops[s:e]).copy_(out)
        return crops

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
        with self._device_lock:
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
        super-resolved on the device before their faces crop from it.

        Returns:
            Tuple of uint8 crops (F, Ho, Wo, 3) and int64 local image
            indices (F,).
        """
        with self.stats.stage("detect", len(images)):
            batch, paddings, landmarks, indices = self._detect_interim(images)
            if len(landmarks) == 0:
                return self._empty()
        if self.enh_model is not None:
            with self.stats.stage("enhance", len(batch)), self._device_lock:
                batch = self.enh_model.predict(batch, landmarks, list(indices))
        with self.stats.stage("crop", len(landmarks)), self._device_lock:
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
        """Writes one group of faces (RGB) or masks (2-D) into one directory.

        Names come from :meth:`_crop_file_name`; an empty group creates no
        directory.  Under strategy "all" each source's occurrence 0 is
        written last: its existence is the resume marker
        ``process_dir(skip_existing=True)`` checks, so it must imply the
        source's other faces already landed.
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
            imwrite(os.path.join(output_dir, self._crop_file_name(source, occurrence)), face)

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
            ValueError: Without a detector (the landmark-free mode).
        """
        if isinstance(images, np.ndarray):
            images = list(images)
        if self.det_model is None:
            raise ValueError(
                "process_images requires an active detector "
                "(det_threshold must be set and landmarks must be None)."
            )
        if len(images) == 0:
            return (*self._empty(), (None, None))
        uniform = len({im.shape for im in images}) == 1
        if uniform and self._fused_eligible(images[0].shape, len(images)):
            crops, _lm, indices = self._fused_process(np.stack(images))
        else:
            crops, indices = self._detect_crop_staged(images)
        groups = self._parse(crops) if len(crops) else (None, None)
        return crops, indices, groups

    def _process_landmark_free(self, images, file_names, output_dir: str):
        """The landmark-free mode: whole images pass through to the tree.

        Counterpart of the JAX ``process_batch``'s no-crop branch
        (``:1354-1366``, ``:1387-1453``): with an enhancer every image is
        enhanced (a ragged list in one bucket per shape); with groups set,
        the originals are parsed whole, so they must share one shape.
        """
        if self.enh_model is not None:
            with self.stats.stage("enhance", len(images)), self._device_lock:
                images = self.enh_model.predict(images, None, None)
        groups = (None, None)
        if self.par_model is not None:
            if len({im.shape for im in images}) > 1:
                raise ValueError(
                    "Parsing without cropping requires all images to "
                    "share dimensions; resize them or enable cropping "
                    "(set det_threshold or provide landmarks)."
                )
            groups = self._parse(np.stack(images))
        with self.stats.stage("save", len(images)):
            self.save_groups(images, np.asarray(file_names), output_dir, *groups)

    def process_batch(self, file_names: list[str], input_dir: str, output_dir: str):
        """Reads, detects and crops, parses, and saves one batch of files.

        Counterpart of the JAX ``process_batch`` (``:1132-1453``) without
        landmark files and packed sources: images are grouped by decoded
        shape; groups that :meth:`_fused_eligible` grants run the fused
        path, the rest the staged path; both enhance gated images.
        Oversized JPEGs decode at a reduced DCT scale, never below
        ``max(resize_size)``.  With one fused group and nothing staged, the
        parser reads that group's crops on the device; otherwise the host
        crops.
        """
        target_max = None if self.det_model is None else max(self.resize_size)
        with self.stats.stage("read", len(file_names)):
            images, file_names = read_images(file_names, input_dir, target_max)
        if len(images) == 0:
            return
        if self.det_model is None:
            self._process_landmark_free(images, file_names, output_dir)
            return

        by_shape: dict[tuple, list[int]] = defaultdict(list)
        for i, im in enumerate(images):
            by_shape[im.shape].append(i)
        fused_groups, staged_ids = [], []
        for shape, ids in by_shape.items():
            if self._fused_eligible(shape, len(ids)):
                fused_groups.append(ids)
            else:
                staged_ids.extend(ids)

        # The fused pipeline hands one group's crops over on the device.
        handoff = self.par_model is not None and len(fused_groups) == 1 and not staged_ids
        dev_crops = None
        crops_parts, idx_parts = [], []
        for ids in fused_groups:
            with self.stats.stage("detect+crop", len(ids)):
                result = self._fused_process(np.stack([images[i] for i in ids]),
                                             return_device_crops=handoff)
            crops, _lm, loc = result[:3]
            if handoff:
                dev_crops = result[3]
            if len(crops):
                crops_parts.append(crops)
                idx_parts.append(np.asarray(ids)[loc])
        if staged_ids:
            crops, loc = self._detect_crop_staged([images[i] for i in staged_ids])
            if len(crops):
                crops_parts.append(crops)
                idx_parts.append(np.asarray(staged_ids)[loc])
        if not crops_parts:
            return
        crops = np.concatenate(crops_parts)
        indices = np.concatenate(idx_parts)
        # The handoff tensor is a power-of-two bucket whose extra rows
        # repeat the last face: the parser gets exactly the F real rows.
        groups = self._parse(crops if dev_crops is None else dev_crops[: len(crops)])
        with self.stats.stage("save", len(crops)):
            self.save_groups(crops, np.asarray(file_names)[indices], output_dir, *groups)

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
        threads that share the detector and the card.

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
