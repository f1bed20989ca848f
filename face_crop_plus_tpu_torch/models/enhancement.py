"""RRDBNet (BSRGAN x4) gated super-resolution enhancer (PyTorch).

Counterpart of ``face_crop_plus_tpu.models.enhancement``: a residual-in-
residual dense network (23 RRDBs, 64 trunk channels, 32 growth channels,
LeakyReLU 0.2, residuals scaled by 0.2) upscales an image 4x with a
nearest-upsample tail; an exact bicubic x0.25 filter brings it back to its
own size (a deblur), and the result is clipped and rounded to uint8.  Only
images whose mean face-area factor is at or below the threshold are
enhanced; without landmarks every image is.

The network runs NCHW with module paths that give the reference's (and the
JAX package's) parameter names (``conv_first``, ``RRDB_trunk.<i>.RDB<d>.
conv<k>``, ``trunk_conv``, ``upconv1``, ``upconv2``, ``HRconv``,
``conv_last``), children registered in the order the JAX forward creates
their parameters, so seeded random init draws the same weights in both
packages.  It computes in float32 by default, as the JAX package does off
the TPU, under :func:`..utils.device.f32_precision`; a caller may ask for
bfloat16 (or float16) with ``compute_dtype``, as a JAX caller does: the
input is scaled to [0, 1] in f32 and cast, the trunk and the tail run in
the compute dtype, and their 4x output goes to f32 before the bicubic
x0.25, the clip and the rounding.  No function of this module
reaches a Pallas kernel in the JAX package: the convolutions are cuDNN's,
and the concatenations, activations, upsampling and the bicubic filter are
stock torch ops.

The JAX module's space-to-depth trunks and H-strip dense blocks are TPU
layout strategies (128-lane tiles, 16 GB of HBM) and have no counterpart
here: ``trunk_mode`` "auto" and "plain" give the plain trunk, the others
raise.  The 4x tail, whose activations are 16x the input's pixels at 64
channels, runs in row strips with an exact halo above
:attr:`RRDBNetwork.tail_max_pixels` input pixels, so a large original in
the landmark-free mode keeps its tail tensors bounded.

Packed 4:2:0 sources (``src_hw``) are reconstructed on the device before
the network, and ``pack_out`` packs the enhanced images on the device for
JPEG-bound saves (:mod:`..ops.yuv`).

On a mesh (``mesh=``, :mod:`..parallel.mesh`) ``enh_batch_size`` rounds up
to a multiple of the mesh size and every sub-batch splits into one block a
shard, each enhanced on its card by its own replica
(:meth:`RRDBNet.enhance_shards`).
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.nn import conv, downscale4x_bicubic, upsample2x_nearest
from ..ops.warp import to_uint8
from ..ops.yuv import packed_length, rgb_to_yuv420, yuv420_to_rgb
from ..parallel.mesh import Replicas, shard_batch
from ..utils.device import (
    f32_precision,
    resolve_compute_dtype,
    resolve_device,
    to_host,
    wait_device,
)
from ..utils.profiling import PipelineStats
from .weights import load_or_init

_NF = 64  # trunk width
_GC = 32  # dense growth channels
_NUM_BLOCKS = 23
_SLOPE = 0.2

#: Seed of the random-init fallback (the JAX ``RRDBNet._init_fn``).
_INIT_SEED = 2

#: Input rows of halo around a tail strip: upconv1 at 2x and the three
#: convolutions at 4x spoil 5 output rows (4x) next to a cut edge, less
#: than 2 input rows (8 output rows).
_TAIL_HALO = 2


def _act(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, _SLOPE, inplace=True)


# ---------------------------------------------------------------------------
# Network (module paths give the JAX package's parameter names)
# ---------------------------------------------------------------------------


class DenseBlock(nn.Module):
    """5-conv residual dense block with 0.2 residual scaling."""

    def __init__(self):
        super().__init__()
        for k in range(1, 6):
            out_ch = _NF if k == 5 else _GC
            setattr(self, f"conv{k}", conv(_NF + (k - 1) * _GC, out_ch, bias=True))

    def forward(self, x):
        c = x
        for k in range(1, 5):
            c = torch.cat([c, _act(getattr(self, f"conv{k}")(c))], dim=1)
        return self.conv5(c).mul_(0.2).add_(x)


class RRDB(nn.Module):
    """Three dense blocks with a 0.2-scaled residual around them."""

    def __init__(self):
        super().__init__()
        self.RDB1 = DenseBlock()
        self.RDB2 = DenseBlock()
        self.RDB3 = DenseBlock()

    def forward(self, x):
        return self.RDB3(self.RDB2(self.RDB1(x))).mul_(0.2).add_(x)


class RRDBNetwork(nn.Module):
    """The enhancer network: (N, 3, H, W) in [0, 1] → (N, 3, 4H, 4W).

    Counterpart of the JAX ``rrdbnet_forward`` (``_dense_block``,
    ``_rrdb``, ``_tail``) with ``num_blocks`` RRDBs in the trunk.
    """

    #: Input pixels above which the 4x tail runs in row strips: 1024² keeps
    #: one tail tensor at 4.3 GB (f32, 64 channels).
    tail_max_pixels: int = 1024 * 1024

    def __init__(self, num_blocks: int = _NUM_BLOCKS):
        super().__init__()
        self.conv_first = conv(3, _NF, bias=True)
        self.RRDB_trunk = nn.Sequential(*[RRDB() for _ in range(num_blocks)])
        self.trunk_conv = conv(_NF, _NF, bias=True)
        self.upconv1 = conv(_NF, _NF, bias=True)
        self.upconv2 = conv(_NF, _NF, bias=True)
        self.HRconv = conv(_NF, _NF, bias=True)
        self.conv_last = conv(_NF, 3, bias=True)

    def _tail(self, fea: torch.Tensor) -> torch.Tensor:
        """x4 nearest-upsample conv stack; each input is freed once consumed."""
        fea = _act(self.upconv1(upsample2x_nearest(fea)))
        fea = _act(self.upconv2(upsample2x_nearest(fea)))
        fea = _act(self.HRconv(fea))
        return self.conv_last(fea)

    def _tail_strips(self, fea: torch.Tensor) -> torch.Tensor:
        """:meth:`_tail` over row strips of ``fea`` with a :data:`_TAIL_HALO`.

        Strip s yields input rows ``[p, p + R)`` from the window ``[a, a +
        L)``, ``L = R + 2·halo``, ``a = clip(p - halo, 0, H - L)``: a window
        that touches the image's edge starts or ends there, so the
        convolutions' own zero padding applies; at a cut edge the halo
        absorbs the rows the missing neighbours spoil.  The last strip is
        shifted up to end at H (its overlap recomputes the same rows).
        """
        n, _, h, w = fea.shape
        halo = _TAIL_HALO
        rows = max(1, self.tail_max_pixels // w)
        n_strips = -(-h // rows)
        rows = -(-h // n_strips)
        length = rows + 2 * halo
        if h <= length:
            return self._tail(fea)
        out = torch.empty((n, 3, 4 * h, 4 * w), dtype=fea.dtype, device=fea.device)
        for s in range(n_strips):
            p = min(s * rows, h - rows)
            a = min(max(p - halo, 0), h - length)
            hr = self._tail(fea[:, :, a : a + length])
            out[:, :, 4 * p : 4 * (p + rows)] = hr[:, :, 4 * (p - a) : 4 * (p - a + rows)]
        return out

    def forward(self, x):
        fea = self.conv_first(x)
        fea = self.trunk_conv(self.RRDB_trunk(fea)).add_(fea)
        if fea.shape[2] * fea.shape[3] > self.tail_max_pixels:
            return self._tail_strips(fea)
        return self._tail(fea)


# ---------------------------------------------------------------------------
# The gate
# ---------------------------------------------------------------------------


def mean_face_factor(
    landmarks: np.ndarray, indices: list[int], n_images: int, image_hw: tuple[int, int]
) -> np.ndarray:
    """Per-image mean face-area factor from 5-point landmarks (host).

    The face extent is the (right mouth − left eye) vector, whose w·h is
    divided by the image area (``image_hw``: the full padded interim on the
    detection paths, as the reference divides by its batch's shape).
    Images with no face get NaN.
    """
    factors = np.full(n_images, np.nan, np.float64)
    if len(indices) == 0:
        return factors
    idx = np.asarray(indices)
    wh = landmarks[:, 4] - landmarks[:, 0]  # (F, 2)
    f = wh[:, 0] * wh[:, 1] / float(image_hw[0] * image_hw[1])
    sums = np.zeros(n_images)
    cnts = np.zeros(n_images)
    np.add.at(sums, idx, f)
    np.add.at(cnts, idx, 1)
    has = cnts > 0
    factors[has] = sums[has] / cnts[has]
    return factors


# ---------------------------------------------------------------------------
# Model wrapper
# ---------------------------------------------------------------------------


class RRDBNet:
    """Gated enhancer, the JAX ``RRDBNet``'s predict contract.

    ``min_face_factor`` is the gate's threshold; ``net`` is the
    :class:`RRDBNetwork` on ``device``.  Images go through the network in
    sub-batches of ``enh_batch_size`` (1 by default, as the reference
    enhances), a short last one padded by repeating its last row.  With a
    ``mesh`` the device is the mesh's first, ``enh_batch_size`` is a
    multiple of the mesh size, and each shard runs its own replica of
    ``net``.  The network's weights are in ``compute_dtype`` (None gives
    float32 on every device).

    ``trunk_mode`` and ``use_s2d`` are the JAX constructor's: "auto" and
    "plain" resolve to the plain trunk, as the JAX package resolves "auto"
    off a TPU.

    Raises:
        NotImplementedError: For ``trunk_mode`` "ws2d" or "s2d", or
            ``use_s2d=True``: TPU layouts of the same function, which the
            port does not carry.
        ValueError: For any other ``trunk_mode``.
    """

    def __init__(
        self,
        min_face_factor: float = 0.001,
        enh_batch_size: int = 1,
        weights_dir: str | None = None,
        device=None,
        num_blocks: int = _NUM_BLOCKS,
        mesh=None,
        compute_dtype=None,
        use_s2d: bool = False,
        trunk_mode: str = "auto",
    ):
        if use_s2d:
            trunk_mode = "s2d"
        elif trunk_mode == "auto":
            trunk_mode = "plain"
        if trunk_mode not in ("plain", "ws2d", "s2d"):
            raise ValueError(f"unknown trunk_mode: {trunk_mode!r}")
        if trunk_mode != "plain":
            raise NotImplementedError(
                f"trunk_mode={trunk_mode!r}: the ws2d and s2d trunks are TPU layouts "
                "(128-lane space-to-depth) of the plain trunk's function; ROADMAP.md "
                "lists them as TPU-only, and the port runs the plain trunk"
            )
        self.trunk_mode = trunk_mode
        self.use_s2d = False
        self.min_face_factor = float(min_face_factor)
        self.enh_batch_size = int(enh_batch_size)
        self.num_blocks = int(num_blocks)
        self.mesh = mesh
        self.device = mesh.devices[0] if mesh is not None else resolve_device(device)
        self.compute_dtype = resolve_compute_dtype(compute_dtype)
        if mesh is not None:
            # Sub-batches split evenly over the shards.
            self.enh_batch_size = -(-self.enh_batch_size // mesh.size) * mesh.size

        net = RRDBNetwork(self.num_blocks)
        self.pretrained = load_or_init("rrdb", net, weights_dir, seed=_INIT_SEED)
        self.net = net.to(self.device, self.compute_dtype).eval()
        self.net.requires_grad_(False)
        self._replicas = None if mesh is None else Replicas(mesh)
        #: Where the spans "enh_net" and "wait_device" go (the ``Cropper`` hands its own).
        self.stats = PipelineStats()

    def replicas(self) -> tuple:
        """The network of each shard (``(net,)`` without a mesh)."""
        return (self.net,) if self._replicas is None else self._replicas.get(self.net)

    def _sr_uint8(self, images: torch.Tensor, net=None) -> torch.Tensor:
        """uint8 (B, H, W, 3) on the device → enhanced uint8 (B, H, W, 3).

        /255 in f32, the network at 4x in :attr:`compute_dtype`, its output
        in f32 through the exact bicubic x0.25 back, clip to [0, 1], x255,
        round half to even.  ``net`` is the replica to run (a shard's, on
        the images' device); :attr:`net` by default.
        """
        with f32_precision():
            x = images.permute(0, 3, 1, 2).to(torch.float32) / 255.0
            with self.stats.span("enh_net", x.shape[0], device=x.device):
                hr = (net or self.net)(x.to(self.compute_dtype)).float()
            lr = downscale4x_bicubic(hr)
            out = to_uint8(torch.clamp(lr, 0.0, 1.0) * 255.0)
        return out.permute(0, 2, 3, 1).contiguous()

    def _chunks(self, n: int):
        """(start, valid rows, row indices of a full sub-batch) over n rows;
        a short last sub-batch repeats its last row."""
        bs = self.enh_batch_size
        for start in range(0, n, bs):
            yield start, min(bs, n - start), np.minimum(np.arange(start, start + bs), n - 1)

    def enhance_shards(self, blocks, src_hw=None, pack_out: bool = False) -> list:
        """The mesh counterpart of :meth:`_sr_uint8`: block s of a sharded
        sub-batch through shard s's replica on its own card, every shard
        enqueued before the host waits.  ``src_hw`` marks the blocks as
        packed 4:2:0 rows, ``pack_out`` packs the results (on each card).
        The x4 tail runs in row strips above
        :attr:`RRDBNetwork.tail_max_pixels` on every shard as without a
        mesh."""
        outs = []
        with f32_precision():  # once around every shard's pass
            for block, net in zip(blocks, self.replicas()):
                if src_hw is not None:
                    block = yuv420_to_rgb(block, *src_hw)
                out = self._sr_uint8(block, net)
                outs.append(rgb_to_yuv420(out) if pack_out else out)
        return outs

    def enhance_device(self, images: torch.Tensor) -> torch.Tensor:
        """Enhances a uint8 (N, H, W, 3) batch on the device, staying there
        (on a mesh, each sub-batch sharded and gathered back to the
        batch's device)."""
        n = images.shape[0]
        if n == self.enh_batch_size and self.mesh is None:  # one full sub-batch: no gather
            return self._sr_uint8(images)
        outs = []
        for _start, valid, rows in self._chunks(n):
            chunk = images.index_select(0, torch.from_numpy(rows).to(images.device))
            if self.mesh is None:
                outs.append(self._sr_uint8(chunk)[:valid])
                continue
            shards = self.enhance_shards(shard_batch(chunk, self.mesh))
            outs.append(torch.cat([out.to(images.device) for out in shards])[:valid])
        return outs[0] if len(outs) == 1 else torch.cat(outs)

    def enhance_images(self, images: np.ndarray, src_hw=None, pack_out: bool = False) -> np.ndarray:
        """Enhances a uniform host uint8 (N, H, W, 3) batch; returns a host
        array.  Each sub-batch goes up, through the network and back.

        ``src_hw`` marks ``images`` as packed 4:2:0 rows (N, L) of that
        (h, w), reconstructed on the device; ``pack_out`` returns packed
        rows (N, L), packed on the device (even h and w, callers gate).
        """
        images = np.ascontiguousarray(images)
        h, w = src_hw if src_hw is not None else images.shape[1:3]
        shape = (packed_length((w, h)),) if pack_out else (h, w, 3)
        out = np.empty((len(images),) + shape, np.uint8)
        for start, valid, rows in self._chunks(len(images)):
            if self.mesh is not None:
                shards = self.enhance_shards(shard_batch(images[rows], self.mesh), src_hw, pack_out)
                host = to_host(((t,) for t in shards), self.stats)
                res = np.concatenate([t for t, in host])
                out[start : start + valid] = res[:valid]
                continue
            chunk = torch.from_numpy(images[rows]).to(self.device)
            if src_hw is not None:
                chunk = yuv420_to_rgb(chunk, *src_hw)
            res = self._sr_uint8(chunk)
            if pack_out:
                res = rgb_to_yuv420(res)
            with wait_device(self.stats):
                out[start : start + valid] = res[:valid].cpu().numpy()
        return out

    def predict(self, images, landmarks: np.ndarray | None, indices: list[int] | None,
                pack_out: bool = False):
        """Enhances the images whose mean face factor is <= the threshold.

        Args:
            images: A uniform uint8 (N, H, W, 3) host array or device
                tensor, or a list of host arrays (of one shape or ragged)
                and :class:`..utils.io.PackedYUVImage` entries, which are
                reconstructed on the device.
            landmarks: (F, 5, 2) landmarks in ``images``' coordinates, or
                None: then every image is enhanced.
            indices: Length-F map from each face to its image (None with
                ``landmarks``).
            pack_out: List input only: enhanced images of even dimensions
                come back as :class:`..utils.io.PackedYUVImage` (packed on
                the device) for JPEG-bound saves.

        Returns:
            ``images`` with the gated ones enhanced, of the same kind: an
            array or tensor is copied first, a list is rebuilt, and with
            nothing gated (or no image) ``images`` itself comes back.
            Images without a face are never gated.
        """
        if pack_out and not isinstance(images, list):
            raise ValueError("pack_out requires list input")
        n = len(images)
        if n == 0:
            return images
        if landmarks is None or indices is None:
            gated = list(range(n))
        else:
            factors = mean_face_factor(np.asarray(landmarks), indices, n, images[0].shape[:2])
            gated = [
                i for i in range(n)
                if np.isfinite(factors[i]) and factors[i] <= self.min_face_factor
            ]
        if not gated:
            return images

        if torch.is_tensor(images):
            rows = torch.as_tensor(gated, device=images.device)
            out = images.clone()
            out[rows] = self.enhance_device(images.index_select(0, rows))
            return out
        if not isinstance(images, list):
            out = np.array(images, copy=True)
            out[gated] = self.enhance_images(out[gated])
            return out

        # A ragged list: one bucket of gated images per shape (packed
        # sources apart from RGB arrays of the same dimensions).
        from ..utils.io import PackedYUVImage

        out = list(images)
        by_shape = defaultdict(list)
        for i in gated:
            by_shape[getattr(images[i], "group_key", images[i].shape)].append(i)
        for ids in by_shape.values():
            first = images[ids[0]]
            h, w = first.shape[:2]
            pack = pack_out and h % 2 == 0 and w % 2 == 0
            if isinstance(first, PackedYUVImage):
                stack, src_hw = np.stack([images[i].packed for i in ids]), (h, w)
            else:
                stack, src_hw = np.stack([images[i] for i in ids]), None
            sub = self.enhance_images(stack, src_hw, pack)
            for j, i in enumerate(ids):
                out[i] = PackedYUVImage(sub[j], h, w) if pack else sub[j]
        return out
