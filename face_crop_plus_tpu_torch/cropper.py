"""Face cropper, detection mode: images or a directory → aligned face crops.

Counterpart of ``face_crop_plus_tpu.cropper.Cropper`` with the same
constructor surface.  Ported: the detection configuration with strategies
"best"/"largest"/"all" and ``crop_source`` "original"/"interim", through
the in-memory serving entry point :meth:`Cropper.process_images` and the
directory pipeline :meth:`Cropper.process_dir` (read → detect and crop →
save, the JAX package's crop tree), which the CLI
(``python -m face_crop_plus_tpu_torch``) drives.

Two paths crop faces, and which one a batch takes decides which pixels its
crops sample, so the routing is part of the result:

* the fused path (:class:`.pipeline.FusedPipeline`) resizes on the device
  and samples crops from the original pixels (or, under
  ``crop_source="interim"``, from the device-resized interim);
* the staged path (:meth:`Cropper._detect_crop_staged`) resizes on the host
  (:func:`.utils.batching.as_batch`: cv2 ``INTER_AREA``/``INTER_CUBIC``),
  detects on that interim batch and samples crops from it, inside each
  image's un-padded window.

Images of one shape take the fused path only when :meth:`_fused_eligible`
grants their shape: it is one of the ``max_fused_shapes`` shapes already
granted, or the group holds at least ``max(2, batch_size // 2)`` images and
fewer than ``max_fused_shapes`` shapes are held.  Every other group, and
every ragged ``process_images`` batch, takes the staged path.  This is the
JAX package's rule (``cropper.py:312-329``, ``:1487-1521``), where the
budget bounds compiled XLA programs; the port keeps it so that both
packages crop the same pixels.

Everything else raises ``NotImplementedError`` naming the missing path:
landmark-file and landmark-free modes, enhancement, parsing, meshes, the
host-crop mode (``FCPT_HOST_CROP=1``) and packed 4:2:0 transfers
(``FCPT_PACK_UPLOAD=1``, ``FCPT_PACK_FETCH=1``).
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


def _pair(size) -> tuple[int, int]:
    if isinstance(size, int):
        return (size, size)
    if len(size) == 1:
        return (size[0], size[0])
    return tuple(size)


class Cropper:
    """Face cropper (detection mode) on a CUDA card, or the CPU on request.

    Args mirror the JAX ``Cropper``; ``device`` None (or "auto") means
    "cuda" and raises when CUDA is absent — pass ``device="cpu"`` to run on
    the CPU.  ``stats`` accumulates per-stage wall time
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

        from .pipeline import FusedPipeline

        self._fused = FusedPipeline(
            det_model=self.det_model,
            target_landmarks=self.landmarks_target,
            output_size=self.output_size,
            border_mode=self.padding,
            allow_skew=self.allow_skew,
            crop_source=self.crop_source,
        )
        #: Source shapes granted the fused path (see the module docstring);
        #: locked, since worker threads race on check-then-add.
        self._fused_shapes: set = set()
        self._fused_shapes_lock = threading.Lock()
        #: One batch's device work at a time.  ``process_dir``'s worker
        #: threads overlap host decode, resize and encode with it.  Batches
        #: run together only queue on the card and add up their peak memory
        #: (~19 GiB for 16 images at a 1024² interim; four at once reached
        #: 35–74 GB on an 80 GB H100), and near its limit cuDNN may pick
        #: other algorithms, whose f32 sums round differently: the crop
        #: tree would depend on ``num_processes``.
        self._device_lock = threading.Lock()

    def _check_ported(self):
        """Raises for configurations whose paths are not ported yet."""
        missing = []
        if self.landmarks is not None or self.det_threshold is None:
            missing.append("landmark-file and landmark-free modes")
        if self.enh_threshold is not None:
            missing.append("enhancement")
        if self.attr_groups is not None or self.mask_groups is not None:
            missing.append("parsing")
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
        """Builds the detector (the only model of the detection path)."""
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

    def _init_landmarks_target(self):
        """Builds the scaled/centered 5-point alignment target template."""
        self.landmarks_target = make_target_landmarks(
            self.output_size, self.face_factor, self.num_std_landmarks
        )

    def _fused_eligible(self, shape, count: int) -> bool:
        """Grants/uses the fused path for a source shape (bounded set)."""
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

    def _fused_process(self, batch: np.ndarray):
        """The fused path for a uniform group: (crops, landmarks, indices).

        A group below ``batch_size`` is padded to it by repeating its last
        image, as the JAX package pads (``cropper.py:1240-1242``), and only
        its real rows surface: cuDNN's algorithm picks for other batch
        sizes can be several times slower (:mod:`.utils.batching`).
        """
        n_true = len(batch)
        if n_true < self.batch_size:
            batch, _ = pad_batch_to(batch, self.batch_size)
        with self._device_lock:
            return self._fused.process(batch, self.resize_size, valid_n=n_true)

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

    def _detect_interim(self, images: list[np.ndarray]):
        """Detects faces on the host-resized interim batch.

        Counterpart of the JAX ``_detect_interim`` (``:1074-1100``) without
        its batch padding: ``as_batch`` to the interim size, one upload,
        detection, and landmark coordinates un-padded.

        Returns:
            Tuple of the uint8 interim batch (N, H, W, 3) on the device,
            its paddings (N, 4), landmarks (F, 5, 2) in un-padded interim
            coordinates, and the face→image index list (F,).
        """
        batch, _, paddings = as_batch(images, self.resize_size)
        with self._device_lock:
            batch = torch.from_numpy(batch).to(self._device)
            landmarks, indices = self.det_model.predict(batch)
        if len(landmarks) > 0:
            landmarks = landmarks - paddings[indices][:, None, [2, 0]]
        return batch, paddings, landmarks, indices

    def _detect_crop_staged(self, images: list[np.ndarray]):
        """Staged detect → align → crop for a ragged image list.

        Counterpart of the JAX ``_detect_crop_staged`` (``:1102-1130``).

        Returns:
            Tuple of uint8 crops (F, Ho, Wo, 3) and int64 local image
            indices (F,).
        """
        with self.stats.stage("detect", len(images)):
            batch, paddings, landmarks, indices = self._detect_interim(images)
            if len(landmarks) == 0:
                return self._empty()
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
        """Writes one group of faces into one directory.

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
        """Saves faces into the output tree.

        Without grouping everything lands directly in ``output_dir``.  The
        attribute/mask subtrees need the parser, which is not ported.
        """
        if attr_groups is not None or mask_groups is not None:
            raise NotImplementedError("attribute/mask groups need parsing, not ported yet")
        self.save_group(faces, file_names, output_dir)

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
            (F,), and the (attr_groups, mask_groups) pair — (None, None)
            while parsing is not ported.
        """
        if isinstance(images, np.ndarray):
            images = list(images)
        if len(images) == 0:
            return (*self._empty(), (None, None))
        uniform = len({im.shape for im in images}) == 1
        if uniform and self._fused_eligible(images[0].shape, len(images)):
            crops, _lm, indices = self._fused_process(np.stack(images))
        else:
            crops, indices = self._detect_crop_staged(images)
        return crops, indices, (None, None)

    def process_batch(self, file_names: list[str], input_dir: str, output_dir: str):
        """Reads, detects and crops, and saves one batch of files.

        Counterpart of the detection branch of the JAX ``process_batch``
        (``:1132-1353``): images are grouped by decoded shape; groups that
        :meth:`_fused_eligible` grants run the fused path, the rest the
        staged path.  Oversized JPEGs decode at a reduced DCT scale, never
        below ``max(resize_size)``.
        """
        with self.stats.stage("read", len(file_names)):
            images, file_names = read_images(file_names, input_dir, max(self.resize_size))
        if len(images) == 0:
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

        crops_parts, idx_parts = [], []
        for ids in fused_groups:
            with self.stats.stage("detect+crop", len(ids)):
                crops, _lm, loc = self._fused_process(np.stack([images[i] for i in ids]))
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
        with self.stats.stage("save", len(crops)):
            self.save_groups(crops, np.asarray(file_names)[indices], output_dir, None, None)

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
