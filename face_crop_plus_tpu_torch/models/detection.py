"""RetinaFace face detector + 5-point landmark predictor (PyTorch).

Counterpart of ``face_crop_plus_tpu.models.detection``: ResNet-50 → FPN →
SSH → three prediction heads (class/bbox/landmark over 2 anchors per cell at
strides 8/16/32), anchor decode with variances (0.1, 0.2), visibility
thresholding, greedy NMS and "all"/"best"/"largest" strategy selection.

The network runs NCHW inside; its public functions keep the JAX package's
layouts (NHWC inputs, (N, A, C) predictions).  Module paths give the JAX
package's parameter names, and children are registered in the order the
JAX forward creates their parameters, so seeded random init draws the same
weights in both packages.  PyTorch runs eagerly: there is no compiled
program per static argument set, so the overridable knobs are read when a
batch runs, and grown caps cost no recompile.

On a mesh (``mesh=``, :mod:`..parallel.mesh`) every shard holds its own
replica of the network and runs its block of the batch on its own card;
the cap diagnostics of all shards feed one growth decision.

The network computes in float32 unless its caller passes
``compute_dtype=torch.bfloat16`` (or ``torch.float16``), as the JAX
detector computes in f32 off the TPU and in its ``compute_dtype`` when
given one.  Preprocessing and the anchor decode stay f32; the softmaxed
scores are rounded to the compute dtype, as the JAX ones are, before the
face selection reads them in f32.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch import nn

from ..ops.anchors import anchor_grid, num_anchors
from ..ops.nms import select_faces
from ..ops.nn import FoldedBatchNorm, conv, leaky_relu, resize_nearest, softmax
from ..utils.batching import next_pow2
from ..parallel.mesh import Replicas, pad_to_multiple, shard_batch
from ..utils.device import (
    f32_precision,
    resolve_compute_dtype,
    resolve_device,
    to_device,
    to_host,
    wait_device,
)
from ..utils.profiling import PipelineStats
from .backbones import ResNet50Features
from .weights import load_or_init

#: Mean pixel offset in BGR order (detector preprocessing).
_BGR_MEAN = (104.0, 117.0, 123.0)

#: Box/landmark decode variances.
_VARIANCES = (0.1, 0.2)

#: Hard ceiling for grow-on-demand pre-NMS candidates (and the NMS kernel's
#: largest K).
_PRE_TOPK_CEILING = 1024

#: Batch sizes a mesh shard's network runs at: its block is padded
#: (repeating its last row) to the smallest of these that holds it, larger
#: blocks run as they are.  cuDNN picks its convolution algorithms by batch
#: size; on an H100 only 1, 8 and 16 of n = 1…16 run fast (``PERF.md`` §5,
#: ``chip_smoke.py`` phase 5 (e)), and 8 rows a shard give the 16-row
#: batch's sums bit for bit, 4 rows other ones (phase 10).
SHARD_PAD_SIZES = (1, 8, 16)


# ---------------------------------------------------------------------------
# Network blocks (module paths mirror the reference's)
# ---------------------------------------------------------------------------


class ConvBN(nn.Sequential):
    """Conv → folded BN (→ ReLU): keys ``<name>.0.weight``, ``<name>.1.scale``."""

    def __init__(self, in_ch, out_ch, kernel, stride=1, padding=None, act=True):
        super().__init__(
            conv(in_ch, out_ch, kernel, stride=stride, padding=padding),
            FoldedBatchNorm(out_ch),
        )
        self.act = act

    def forward(self, x):
        x = super().forward(x)
        return leaky_relu(x) if self.act else x


class SSH(nn.Module):
    """SSH context module: parallel 3x3 / 5x5 / 7x7 receptive-field branches."""

    def __init__(self, in_ch: int = 256, out_ch: int = 256):
        super().__init__()
        quarter = out_ch // 4
        self.conv3X3 = ConvBN(in_ch, out_ch // 2, 3, act=False)
        self.conv5X5_1 = ConvBN(in_ch, quarter, 3)
        self.conv5X5_2 = ConvBN(quarter, quarter, 3, act=False)
        self.conv7X7_2 = ConvBN(quarter, quarter, 3)
        self.conv7x7_3 = ConvBN(quarter, quarter, 3, act=False)

    def forward(self, x):
        b3 = self.conv3X3(x)
        b5_1 = self.conv5X5_1(x)
        b5 = self.conv5X5_2(b5_1)
        b7 = self.conv7x7_3(self.conv7X7_2(b5_1))
        return leaky_relu(torch.cat([b3, b5, b7], dim=1))


class FPN(nn.Module):
    """3-level top-down FPN with nearest upsampling and 3x3 merge convs."""

    def __init__(self, in_chs=(512, 1024, 2048), out_ch: int = 256):
        super().__init__()
        self.output1 = ConvBN(in_chs[0], out_ch, 1, padding=0)
        self.output2 = ConvBN(in_chs[1], out_ch, 1, padding=0)
        self.output3 = ConvBN(in_chs[2], out_ch, 1, padding=0)
        # merge2 before merge1: the JAX forward creates it first.
        self.merge2 = ConvBN(out_ch, out_ch, 3)
        self.merge1 = ConvBN(out_ch, out_ch, 3)

    def forward(self, feats):
        c3, c4, c5 = feats
        o1 = self.output1(c3)
        o2 = self.output2(c4)
        o3 = self.output3(c5)
        o2 = self.merge2(o2 + resize_nearest(o3, tuple(o2.shape[2:])))
        o1 = self.merge1(o1 + resize_nearest(o2, tuple(o1.shape[2:])))
        return [o1, o2, o3]


class Head(nn.Module):
    """1x1 prediction conv over 2 anchors per cell."""

    def __init__(self, in_ch: int, num_out: int):
        super().__init__()
        self.num_out = num_out
        self.conv1x1 = conv(in_ch, 2 * num_out, 1, padding=0, bias=True)

    def forward(self, x):
        y = self.conv1x1(x)
        # NCHW → NHWC before the reshape: (H*W*2) must run row-major over the
        # grid with the 2 anchors innermost, the anchor grid's order.
        return y.permute(0, 2, 3, 1).reshape(y.shape[0], -1, self.num_out)


def _heads(in_ch: int, num_out: int) -> nn.ModuleList:
    return nn.ModuleList(Head(in_ch, num_out) for _ in range(3))


class RetinaFaceNet(nn.Module):
    """Backbone + FPN + SSH + heads; NCHW in, (N, A, C) predictions out."""

    def __init__(self):
        super().__init__()
        self.body = ResNet50Features()
        self.fpn = FPN()
        self.ssh1 = SSH()
        self.ssh2 = SSH()
        self.ssh3 = SSH()
        self.ClassHead = _heads(256, 2)
        self.BboxHead = _heads(256, 4)
        self.LandmarkHead = _heads(256, 10)

    def forward(self, x: torch.Tensor):
        fpn = self.fpn(self.body(x))
        feats = [ssh(f) for ssh, f in zip((self.ssh1, self.ssh2, self.ssh3), fpn)]
        cls = torch.cat([h(f) for h, f in zip(self.ClassHead, feats)], dim=1)
        loc = torch.cat([h(f) for h, f in zip(self.BboxHead, feats)], dim=1)
        ldm = torch.cat([h(f) for h, f in zip(self.LandmarkHead, feats)], dim=1)
        return softmax(cls, dim=-1), loc, ldm


def retinaface_forward(net: RetinaFaceNet, x: torch.Tensor):
    """(N, H, W, 3) preprocessed NHWC input → (scores, loc, ldm).

    Returns softmaxed class scores (N, A, 2), box regressions (N, A, 4) and
    landmark regressions (N, A, 10).
    """
    return net(x.permute(0, 3, 1, 2).contiguous())


def preprocess(images: torch.Tensor) -> torch.Tensor:
    """RGB (N, H, W, 3) pixels → f32 BGR minus the detector's mean, NHWC."""
    mean = to_device(_BGR_MEAN, images.device, np.float32)
    return images.float().flip(-1) - mean


def decode_detections(loc, ldm, priors, image_size, variances=_VARIANCES):
    """Undoes the training-time center-offset encoding (f32).

    Args:
        loc: (N, A, 4) box regressions.
        ldm: (N, A, 10) landmark regressions.
        priors: (A, 4) normalized anchor grid (cx, cy, w, h), a tensor on
            the predictions' device.
        image_size: (H, W) ints for pixel scaling.
        variances: The (center, size) encoding variances.

    Returns:
        Corner-form pixel boxes (N, A, 4) and pixel landmarks (N, A, 10).
    """
    h, w = image_size
    v0, v1 = variances
    loc = loc.float()
    ldm = ldm.float()
    cxy, pwh = priors[:, :2], priors[:, 2:]

    b_cxy = cxy + loc[..., :2] * v0 * pwh
    b_wh = pwh * torch.exp(loc[..., 2:] * v1)
    xy1 = b_cxy - b_wh / 2.0
    xy2 = xy1 + b_wh
    boxes = torch.cat([xy1, xy2], dim=-1)
    boxes = boxes * to_device([w, h, w, h], loc.device, np.float32)

    pts = ldm.reshape(*ldm.shape[:-1], 5, 2)
    pts = cxy[:, None, :] + pts * v0 * pwh[:, None, :]
    pts = pts * to_device([w, h], loc.device, np.float32)
    return boxes, pts.reshape(*ldm.shape[:-1], 10)


def _host_caps(caps) -> np.ndarray:
    """The (N, 2) cap diagnostic on the host: from a tensor, an array, or a
    mesh's list of per-shard tensors (concatenated in shard order)."""
    if isinstance(caps, (list, tuple)):
        return np.concatenate([_host_caps(c) for c in caps])
    return caps.cpu().numpy() if torch.is_tensor(caps) else np.asarray(caps)


# ---------------------------------------------------------------------------
# Model wrapper
# ---------------------------------------------------------------------------


class RetinaFace:
    """Detector with the reference's prediction semantics.

    Attributes mirror the JAX package: ``strategy``, ``vis_threshold``,
    ``nms_threshold``, ``variance``, ``max_faces``, ``pre_topk``,
    ``auto_grow``; ``net`` is the :class:`RetinaFaceNet` on ``device``, its
    weights in ``compute_dtype`` (:func:`..utils.device.resolve_compute_dtype`:
    None gives float32 on every device).  With a ``mesh`` the device is the
    mesh's first, and each shard runs a replica of ``net``
    (:meth:`replicas`), in the same dtype.
    """

    #: Grow-on-demand ceiling for ``pre_topk``.
    pre_topk_ceiling: int = _PRE_TOPK_CEILING

    def __init__(
        self,
        strategy: str = "all",
        vis: float = 0.6,
        max_faces: int = 64,
        pre_topk: int = 256,
        auto_grow: bool = True,
        weights_dir: str | None = None,
        device=None,
        mesh=None,
        compute_dtype=None,
    ):
        self.strategy = strategy
        self.vis_threshold = float(vis)
        self.nms_threshold = 0.4
        self.variance = list(_VARIANCES)
        self.max_faces = int(max_faces)
        self.pre_topk = int(pre_topk)
        #: Grow ``pre_topk``/``max_faces`` on demand when a batch overflows
        #: them.  Off → a warning marks potential divergence from the
        #: uncapped reference semantics.
        self.auto_grow = bool(auto_grow)
        self._cap_warned = False
        self.mesh = mesh
        self.device = mesh.devices[0] if mesh is not None else resolve_device(device)
        self.compute_dtype = resolve_compute_dtype(compute_dtype)

        # float32 by default, as the JAX package computes off the TPU; the
        # forward runs under f32_precision (TF32 off).  The f32 weights are
        # rounded once to the compute dtype, as the JAX conv casts them.
        net = RetinaFaceNet()
        self.pretrained = load_or_init("retinaface", net, weights_dir)
        self.net = net.to(self.device, self.compute_dtype).eval()
        self.net.requires_grad_(False)
        self._replicas = None if mesh is None else Replicas(mesh)
        #: Where the spans "det_net" and "wait_device" and the counts
        #: "nms_pairs" and "redispatch" go (the ``Cropper`` hands its own).
        self.stats = PipelineStats()

    def replicas(self) -> tuple:
        """The network of each shard: one replica per mesh entry, kept
        equal to :attr:`net` (:class:`..parallel.mesh.Replicas`), or
        ``(net,)`` without a mesh."""
        return (self.net,) if self._replicas is None else self._replicas.get(self.net)

    def _detect(self, images: torch.Tensor, args: dict, stage=None, net=None):
        """Network, decode and face selection for a batch on the device.

        Args:
            images: (N, H, W, 3) RGB pixels (uint8 or float32) at the
                detector's resolution, on :attr:`device`.
            args: The knobs of :meth:`_detect_args` (or grown ones).
            stage: Optional ``stage(name)`` → context manager, entered
                around "network" and "select".
            net: The replica to run (a shard's, on the images' device);
                :attr:`net` by default.  On a mesh the network runs the
                block padded to :data:`SHARD_PAD_SIZES`.

        Returns:
            Padded landmarks (N, K, 10), validity (N, K) and int32 cap
            diagnostics (N, 2) of :func:`..ops.nms.select_faces`, which
            launches the greedy-NMS kernel on a CUDA batch.
        """
        stage = stage or (lambda name: contextlib.nullcontext())
        n, h, w = images.shape[:3]
        with stage("network"), f32_precision():
            x = preprocess(images).to(self.compute_dtype)
            rows = n if self.mesh is None else min(
                (s for s in SHARD_PAD_SIZES if s >= n), default=n)
            if rows > n:  # a shard's block, at a batch size cuDNN runs well
                x = torch.cat([x, x[-1:].expand(rows - n, *x.shape[1:])])
            with self.stats.span("det_net", rows, device=x.device):
                out = retinaface_forward(net or self.net, x)
            scores2, loc, ldm = (t[:n] for t in out)
        with stage("select"):
            priors = to_device(anchor_grid(h, w), images.device)
            boxes, landms = decode_detections(loc, ldm, priors, (h, w), args["variances"])
            return select_faces(
                scores2[..., 1].float(),
                boxes,
                landms,
                vis_threshold=args["vis_threshold"],
                nms_threshold=args["nms_threshold"],
                pre_topk=args["pre_topk"],
                max_faces=args["max_faces"],
                strategy=args["strategy"],
                stats=self.stats,
            )

    def _detect_args(self) -> dict:
        """Current values of the overridable knobs."""
        return dict(
            strategy=self.strategy,
            vis_threshold=float(self.vis_threshold),
            nms_threshold=float(self.nms_threshold),
            max_faces=int(self.max_faces),
            pre_topk=int(self.pre_topk),
            variances=tuple(self.variance),
        )

    def grown_args(self, caps: np.ndarray, args: dict, n_anchors: int) -> dict | None:
        """Enlarged detect args when a candidate/face cap bound.

        ``caps`` is the (N, 2) diagnostic from
        :func:`..ops.nms.select_faces` (candidates above threshold, raw NMS
        keeps).  Caps grow to the next
        power of two that fits the observed demand — ``pre_topk`` bounded by
        the anchor count and :attr:`pre_topk_ceiling`, ``max_faces`` (only
        meaningful for strategy "all") bounded by ``pre_topk``.  Returns
        None when nothing needs to (or can) grow; a cap that still binds at
        its ceiling warns once.
        """
        if len(caps) == 0:
            return None
        n_above = int(caps[:, 0].max())
        kept_raw = int(caps[:, 1].max())
        new = dict(args)
        grew = False

        k = min(args["pre_topk"], n_anchors)
        k_ceiling = min(self.pre_topk_ceiling, n_anchors)
        if n_above > k:
            if self.auto_grow and k < k_ceiling:
                new["pre_topk"] = min(next_pow2(n_above, k), k_ceiling)
                grew = True
            else:
                self._warn_cap(
                    f"{n_above} candidates above the visibility threshold "
                    f"exceed pre_topk={k}"
                )

        if args["strategy"] == "all" and kept_raw > args["max_faces"]:
            f_ceiling = new["pre_topk"]
            if self.auto_grow and args["max_faces"] < f_ceiling:
                new["max_faces"] = min(
                    next_pow2(kept_raw, args["max_faces"]), f_ceiling
                )
                grew = True
            else:
                self._warn_cap(
                    f"{kept_raw} NMS-kept faces exceed max_faces="
                    f"{args['max_faces']}"
                )

        return new if grew else None

    def dispatch_with_growth(self, dispatch, n_anchors: int, valid_n: int):
        """Runs a detect dispatch under the cap-growth retry policy.

        ``dispatch(args)`` must return ``(out, caps)`` where ``caps`` is the
        (N, 2) cap diagnostic, or on a mesh the list of every shard's (in
        shard order: a cap binding on any shard grows the caps, and the
        re-dispatch runs every shard).  When a cap binds and
        ``auto_grow`` is on, the dispatch re-runs with grown caps, and the
        grown caps persist on the model so later batches skip the retry.
        """
        args = self._detect_args()
        out, caps = dispatch(args)
        return self.finish_growth(out, caps, args, dispatch, n_anchors, valid_n)

    def finish_growth(self, out, caps, args, dispatch, n_anchors: int, valid_n: int):
        """Completes the growth policy for an already-dispatched detect call.

        A call dispatched before another one grew the caps (batches in
        flight) first re-runs with the current caps, as a dispatch made now
        would: the result is the one a serial caller gets.
        """
        current = self._detect_args()
        if args != current:
            args = current
            self.stats.count("redispatch")
            out, caps = dispatch(args)
        while True:
            with wait_device(self.stats):
                caps_np = _host_caps(caps)
            grown = self.grown_args(caps_np[:valid_n], args, n_anchors)
            if grown is None:
                return out
            args = grown
            self.pre_topk = args["pre_topk"]
            self.max_faces = args["max_faces"]
            self.stats.count("redispatch")
            out, caps = dispatch(args)

    def _warn_cap(self, detail: str):
        if self._cap_warned:
            return
        self._cap_warned = True
        import warnings

        warnings.warn(
            f"Detection cap binding: {detail}; output is truncated and may "
            "diverge from the uncapped reference semantics. Raise "
            "pre_topk/max_faces or enable auto_grow."
        )

    def detect_padded(self, images: np.ndarray | torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
        """Detection on an interim batch, returning padded host arrays.

        Counterpart of the JAX ``RetinaFace.detect_padded``
        (``face_crop_plus_tpu/models/detection.py:396-427``): the uint8
        (N, H, W, 3) batch (a host array, or a tensor) runs under the
        cap-growth policy.  On a mesh it is padded to a multiple of the
        mesh size, split into one block a shard, and every shard's pass is
        enqueued on its card with its replica before any result is read;
        results come back in shard order, the padding rows dropped.

        Returns:
            Landmarks (N, K, 10) float32 and validity (N, K) bool, where K
            is ``max_faces`` for strategy "all" and 1 otherwise.
        """
        n, h, w = images.shape[:3]
        if self.mesh is None:
            if not torch.is_tensor(images):
                images = torch.from_numpy(np.ascontiguousarray(images))
            blocks = (images.to(self.device),)
        elif torch.is_tensor(images):
            rem = (-n) % self.mesh.size
            if rem:
                images = torch.cat([images, images[-1:].expand(rem, *images.shape[1:])])
            blocks = shard_batch(images, self.mesh)
        else:
            blocks = shard_batch(pad_to_multiple(np.asarray(images), self.mesh.size)[0], self.mesh)

        def dispatch(args):
            with f32_precision():  # once around every shard's pass
                outs = [self._detect(b, args, net=net) for b, net in zip(blocks, self.replicas())]
            return outs, [caps for _sel, _valid, caps in outs]

        outs = self.dispatch_with_growth(dispatch, num_anchors(h, w), n)
        host = to_host((out[:2] for out in outs), self.stats)
        sel = np.concatenate([lm for lm, _valid in host])[:n]
        valid = np.concatenate([v for _lm, v in host])[:n]
        return sel, valid

    def predict(self, images: np.ndarray | torch.Tensor) -> tuple[np.ndarray, list[int]]:
        """Predicts landmark sets for a uint8 RGB (N, H, W, 3) image batch.

        Counterpart of the JAX ``RetinaFace.predict`` (``:429-444``).

        Returns:
            Tuple of a float32 (num_faces, 5, 2) landmark array and the
            list of source-image indices, compacted row-major: in image
            order, then score order.
        """
        landms, valid = self.detect_padded(images)
        img_idx, face_idx = np.nonzero(valid)
        landmarks = landms[img_idx, face_idx].reshape(-1, 5, 2)
        return landmarks.astype(np.float32), img_idx.tolist()
