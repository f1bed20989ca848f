"""What every entry shares: the configuration's reference pipeline, its
seeded weights handed to the package and to the reference alike, the
``Cropper``, and the reference's crops.

An entry is ``entries/<entry>.py``, named by the traffic file's
``entry``; its class ``Entry`` subclasses :class:`Cell` with

* ``_make_inputs()``, ``_build()`` (the cropper) and ``_warm_up()``;
* ``run(seconds)``: the window, setting ``attempted``, ``failed``,
  ``faces`` and ``window_s``;
* ``images_done()``: (h, w) of every image the window detected on;
* ``control_outputs(nets)``: the reference's outputs put where ``run``
  leaves the package's (the control);
* ``judge(limits, nets)``: (correct, {number: (value, limit)}).

The configuration's reference pipeline is the module of
``reference/pipelines/`` that :func:`.spec.pipeline_name` names (see that
package); an entry gets the reference's crops from
:meth:`Cell.reference_crops`, which hands them to the pipeline's own
``crops`` when it has one.
"""

from __future__ import annotations

import importlib
import shutil
import time
import warnings

import numpy as np
import torch

from ..reference.geometry import fit_similarity, target_landmarks, warp_constant
from ..reference.nn import precision
from .spec import pipeline_name
from .weights import tamed_state_dict


def _shapes(state) -> dict:
    return {k: tuple(v.shape) for k, v in state.items()}


class Cell:
    """One run of a cell: set-up, window and judgement (see the module)."""

    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device,
                 workdir: str):
        self.config, self.traffic, self.seed = config, traffic, int(seed)
        self.device, self.workdir = device, workdir
        self.model = config["model"]
        self.kw = {**config["cropper"], **traffic.get("cropper", {})}
        self.pipeline = importlib.import_module(
            f"gpubench.reference.pipelines.{pipeline_name(config)}")
        self.parts: dict[str, float] = {}
        self.attempted = self.failed = self.faces = 0
        self.window_s = 0.0
        self.weights: dict = {}

    def _timed(self, part: str, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.parts[part] = self.parts.get(part, 0.0) + time.perf_counter() - t0
        return out

    def _make_weights(self):
        """The tamed weights of the model block's networks, on the device."""
        with torch.device("meta"):
            nets = self.pipeline.networks(self.model)
        for name, net in nets.items():
            self.weights[name] = tamed_state_dict(_shapes(net.state_dict()),
                                                  self.config["weights"][name], self.seed,
                                                  self.device)

    def _make_cropper(self, **extra):
        """The package's ``Cropper`` serving the run's weights.

        Raises:
            ValueError: When the model block's networks are not the
                package's (the reference would judge another model).
        """
        from face_crop_plus_tpu_torch import Cropper

        kw = dict(self.kw, device=str(self.device), **extra)
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message="No pretrained weights found")
            cropper = Cropper(**kw)
        for name, attr in self.pipeline.SERVED_BY.items():
            net = getattr(cropper, attr).net
            if _shapes(net.state_dict()) != _shapes(self.weights[name]):
                raise ValueError(f"the configuration's model block does not describe the "
                                 f"package's {name} network")
            net.load_state_dict(self.weights[name])
        return cropper

    def setup(self):
        with precision("float32"):
            self._timed("weights_s", self._make_weights)
        self._timed("inputs_s", self._make_inputs)
        self.cropper = self._timed("cropper_s", self._build)
        self._timed("warmup_s", self._warm_up)

    def reference_nets(self) -> dict:
        """The plain networks with the run's weights, on the device."""
        nets = self.pipeline.networks(self.model)
        for name, net in nets.items():
            net.load_state_dict(self.weights[name])
            nets[name] = net.to(self.device).eval()
        return nets

    def reference_crops(self, nets: dict, images: torch.Tensor, offset=None, windows=None):
        """The reference's uint8 crops (F, Ho, Wo, 3) and image indices (F,)
        of a uniform uint8 batch on the device, in the package's order.

        The pipeline's ``crops(cell, nets, images, offset, windows)`` when
        it has one (a pipeline whose crops do not all come from the source
        images: a gated enhancer's come from its enhanced rows); else the
        strategy's faces (their landmarks less ``offset``), warped from
        ``images`` by :meth:`warp_faces` (inside each image's ``windows``
        row, when given).
        """
        if hasattr(self.pipeline, "crops"):
            return self.pipeline.crops(self, nets, images, offset, windows)
        interim = (self.kw["resize_size"],) * 2
        lm, idx = self.pipeline.faces(nets, self.model, images, interim, self.kw["det_threshold"])
        if offset is not None:
            lm = lm - offset
        return self.warp_faces(images, lm, idx, None if windows is None else windows[idx])

    def warp_faces(self, images: torch.Tensor, lm: torch.Tensor, idx: torch.Tensor,
                   windows=None):
        """The crops of faces in a uint8 (N, H, W, 3) batch on the device:
        each face's landmarks ``lm`` (F, 5, 2) in ``images``' pixels fitted
        to the cell's target landmarks, and warped from its row ``idx``
        (F,) inside its ``windows`` row (F, 4) when given.  Faces without a
        sound fit are dropped.  Returns (uint8 crops (F', Ho, Wo, 3), image
        indices (F',) int64) on the host."""
        out_size = (self.kw["output_size"],) * 2
        m, ok = fit_similarity(lm, target_landmarks(out_size, self.kw["face_factor"]))
        m, idx = m[ok], idx[ok]
        win = None if windows is None else windows[ok]
        crops = warp_constant(images, m, idx.to(torch.int32), out_size, win)
        return crops.cpu().numpy(), idx.cpu().numpy().astype(np.int64)

    def release(self):
        """Frees the package's state before the reference runs."""
        self.cropper = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def clean(self):
        """Removes what the run wrote."""
        shutil.rmtree(self.workdir, ignore_errors=True)
