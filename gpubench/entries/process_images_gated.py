"""``Cropper.process_images`` in a closed loop with one client, over a pool
of requests that each hold a fixed number of images the enhancer's gate
takes (``entries/process_images.py`` with a pool built for the gate).

The gate compares each image's face factor, the (right mouth − left eye)
extent of its largest face in interim pixels, width times height, over the
padded interim area, with the configuration's fixed ``enh_threshold``.  The
detector's seeded weights are set so that this factor is a face size, and
so that each image holds one face:

* every landmark head regresses a standard five-point face (``constant``
  biases of the configuration, in units of 0.1 anchor) with a small random
  part (its ``head`` gain), so a face's factor grows with its anchor: at a
  1024² interim 0.0065 for the coarsest level's 256-pixel anchors and
  0.0262 for its 512-pixel ones, on either side of the README's 0.01;
* the two finer levels' class logits are constant and far below (their
  kernels' gain 0, a ``constant`` bias), so the K best candidates all come
  from the coarsest level;
* the coarsest level's boxes are constant squares of 8192 pixels (gain 0,
  a ``constant`` log size), so any two overlap beyond the NMS threshold:
  NMS keeps one face an image, its best-scoring anchor, 256 or 512 pixels;
* :meth:`Entry._calibrate` shifts the 256-pixel anchors' class logit so
  that the best anchor is a 256 one in a share :data:`GATED_SHARE` of the
  first :data:`CALIBRATION_IMAGES` candidates (a quantile of the
  difference of the two sizes' best logits), whatever the seed's random
  class head favours.

Every candidate is one draw of a fixed block (``candidate_block``, the
generator and ``content`` of every request mix), calibrated on its first
images and then gated by the reference detector (its ``gate_factors``),
once.  Each request takes ``gated_per_request`` images whose factor is at
most ``enh_threshold × (1 − gate_margin)``, at positions drawn from the
seed, and the rest from those at least ``enh_threshold × (1 +
gate_margin)``, drawn from the seed without repeats inside a request; the
block's images recur across the pool's requests, which the package caches
nothing of.  An image whose two best logits lie within :data:`TIE` of each
other is left out: float32 rounding could pick the other anchor in the
package than in the reference.  That hides no defect, since every image
still goes through the same detector and gate in both.  Without enough of
either kind the entry exits 2.  The reference runs under float32 in
batches of :data:`SELECTION_BATCH` images, whose allocations stay below
the package's own peak (the window's ``peak_device_gib`` reads the whole
process).

Traffic keys beyond ``process_images``'s: ``gated_per_request``,
``gate_margin``, ``candidate_block``.

A network's weight recipe (the configuration's ``weights``) may also name
``constant``: parameter → the value (a number, or a list of the
parameter's shape) it is set to after the draw.  The enhancer's output is
the image itself (ESRGAN has no global residual), so the bias of its last
convolution sets the enhanced image's level: a zero-mean draw leaves about
half of each channel below 0, clipped, on any seed.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from gpubench.entries import process_images
from gpubench.harness import inputs
from gpubench.reference.nn import precision
from gpubench.reference.retinaface import RetinaFaceNet

#: The generator stream of the candidates (10 is the request pool's).
CANDIDATE_STREAM = 100
#: Images a reference forward of the selection: at 1024² on an H100 its
#: peak is 17.9 GiB, under the package's 19.6 (16 images reached 19.4).
SELECTION_BATCH = 8
#: Candidates whose best logits set the calibration.
CALIBRATION_IMAGES = 16
#: The share of those whose best anchor the calibration makes a 256 one.
GATED_SHARE = 0.25
#: Least gap between an image's two best logits (the 256 and the 512
#: anchors'), in logit units; the logits spread ~0.3 at the tamed gain.
TIE = 1e-3
#: The coarsest level, whose two anchor sizes compete.
LEVEL = 2


class Entry(process_images.Entry):

    def _make_weights(self):
        super()._make_weights()
        for name, recipe in self.config["weights"].items():
            for key, value in recipe.get("constant", {}).items():
                param = self.weights[name][key]
                param.copy_(torch.as_tensor(value, dtype=param.dtype).expand(param.shape))

    def _scores(self, det, images: np.ndarray):
        """Each image's gate factor by the reference detector (NaN without
        a face) and its best coarsest-level class logit difference of the
        smaller anchors less that of the larger ones (> 0: a gated face)."""
        interim = (self.kw["resize_size"],) * 2
        h, w = images.shape[1:3]
        cls = det.ClassHead[LEVEL].conv1x1
        a = self.model["anchors_per_cell"]
        factors, best = np.full(len(images), np.nan), np.zeros(len(images))
        feats = []
        hook = det.ssh3.register_forward_hook(lambda m, i, o: feats.append(o))
        try:
            for s in range(0, len(images), SELECTION_BATCH):
                imgs = torch.from_numpy(images[s: s + SELECTION_BATCH]).to(self.device)
                lm, idx = self.pipeline.faces({"retinaface": det}, self.model, imgs, interim,
                                              self.kw["det_threshold"])
                f = self.pipeline.gate_factors(lm, h, w, interim)
                factors[s + idx.cpu().numpy()] = f.double().cpu().numpy()
                c = cls(feats.pop())
                c = c.permute(0, 2, 3, 1).reshape(len(imgs), -1, a, 2)
                d = (c[..., 1] - c[..., 0]).amax(dim=1)
                best[s: s + len(imgs)] = (d[:, 0] - d[:, 1]).double().cpu().numpy()
        finally:
            hook.remove()
        return factors, best

    def _calibrate(self, det, images: np.ndarray):
        """Shifts the coarsest level's smaller anchors' class logit so that
        their best one leads in a share :data:`GATED_SHARE` of ``images``,
        in the run's weights and in ``det``."""
        _, best = self._scores(det, images)
        w = self.weights["retinaface"]
        # Logit pairs (background, face) a size, the smaller size first.
        w[f"ClassHead.{LEVEL}.conv1x1.bias"][1] -= float(np.quantile(best, 1 - GATED_SHARE))
        det.load_state_dict(w)

    def _make_inputs(self):
        t = self.traffic
        (h, w), k, n = t["image_hw"], t["request_images"], t["distinct_requests"]
        g, threshold, margin = t["gated_per_request"], self.kw["enh_threshold"], t["gate_margin"]
        block = inputs.images(self.seed, CANDIDATE_STREAM, t["candidate_block"], h, w,
                              t["content"], self.device)
        det = RetinaFaceNet(self.model)
        det.load_state_dict(self.weights["retinaface"])
        det = det.to(self.device).eval()
        with precision("float32"), torch.no_grad():
            self._calibrate(det, block[:CALIBRATION_IMAGES])
            f, best = self._scores(det, block)
        del det
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        gated = np.nonzero((f <= threshold * (1 - margin)) & (best > TIE))[0]
        plain = np.nonzero((f >= threshold * (1 + margin)) & (best < -TIE))[0]
        peak = torch.cuda.max_memory_allocated(self.device) if self.device.type == "cuda" else 0
        spans = [[float(f[i].min()), float(f[i].max())] if len(i) else [] for i in (gated, plain)]
        print(f"gated pool: {len(f)} candidates at enh_threshold {threshold}: {len(gated)} gated "
              f"(factors {spans[0]}) and {len(plain)} plain ({spans[1]}) beyond a margin of "
              f"{margin} of it, {len(f) - len(gated) - len(plain)} neither; "
              f"device peak {peak} bytes", flush=True)
        if len(gated) < g or len(plain) < k - g:
            print(f"gpubench: {len(f)} candidates hold {len(gated)} gated and {len(plain)} plain "
                  f"images; a request needs {g} and {k - g}", file=sys.stderr)
            raise SystemExit(2)
        rng = np.random.default_rng([self.seed & ((1 << 63) - 1), 41])
        pool = np.empty((n, k, h, w, 3), np.uint8)
        for r in range(n):
            mask = np.zeros(k, bool)
            mask[rng.choice(k, size=g, replace=False)] = True
            pool[r, mask] = block[gated[(r * g + np.arange(g)) % len(gated)]]
            pool[r, ~mask] = block[rng.choice(plain, size=k - g, replace=False)]
        self.pool = pool
