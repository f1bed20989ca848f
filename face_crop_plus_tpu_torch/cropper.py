"""Face cropper, detection mode: images → aligned face crops (PyTorch).

Counterpart of ``face_crop_plus_tpu.cropper.Cropper`` with the same
constructor surface.  Ported so far: the detection configuration and the
in-memory serving entry point :meth:`Cropper.process_images` for a uniform
uint8 batch, with strategies "best"/"largest" (single dispatch) and "all"
(detect-only pass, host compaction, chunked crops of the kept faces), and
``crop_source`` "original" or "interim".  Everything else raises
``NotImplementedError`` naming the missing path: landmark-file and
landmark-free modes, ragged batches, enhancement, parsing, meshes and the
directory pipeline.

The JAX package's compile cache, accelerator prewarm and fused-shape budget
(``max_fused_shapes``) manage XLA programs; eager PyTorch has none, so the
argument is accepted and unused.
"""

from __future__ import annotations

import numpy as np

from .utils.device import resolve_device
from .utils.landmarks import make_target_landmarks


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
    the CPU.
    """

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

    def process_images(
        self, images: list[np.ndarray] | np.ndarray
    ) -> tuple[np.ndarray, np.ndarray, tuple]:
        """In-memory serving API: images → (crops, indices, groups).

        Args:
            images: Uniform (N, H, W, 3) uint8 batch or list of RGB arrays
                of one shape.

        Returns:
            Tuple of uint8 crops (F, Ho, Wo, 3), int64 face→image indices
            (F,), and the (attr_groups, mask_groups) pair — (None, None)
            while parsing is not ported.
        """
        if isinstance(images, np.ndarray):
            images = list(images)
        if len(images) == 0:
            return (
                np.zeros((0,) + self.output_size[::-1] + (3,), np.uint8),
                np.zeros((0,), np.int64),
                (None, None),
            )
        if len({im.shape for im in images}) != 1:
            raise NotImplementedError(
                "ragged batches (the staged host-resize path) are not ported "
                "yet: pass images of one shape"
            )
        crops, _lm, indices = self._fused.process(np.stack(images), self.resize_size)
        return crops, indices, (None, None)
