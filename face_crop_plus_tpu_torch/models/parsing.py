"""BiSeNet 19-class face parser with attribute and mask grouping (PyTorch).

Counterpart of ``face_crop_plus_tpu.models.parsing``: per-pixel
classification of face crops into 19 classes, then grouping of whole faces
into attribute groups (pixel-count thresholds, AND or OR join, a negative
index meaning "must not contain") and mask groups (binary 0/255 masks).

A batch runs on the device as: /255 → bilinear resize to 512² (half-pixel
centres, as two products) → ImageNet normalization → BiSeNet (ResNet-18
trunk, context path, feature fusion) → 8× align-corners bilinear upsample of
the logits → argmax → nearest resize back to the crop size → a 19-bin
count per face.  Only the (F, 19) counts and, for mask groups, bit-packed
masks come back to the host, where membership is decided.  Packed 4:2:0
sources (``src_hw``) are reconstructed on the device first
(:func:`..ops.yuv.yuv420_to_rgb`).

The network runs NCHW with module paths that give the JAX package's
parameter names (``cp.resnet.layer1.0.conv1``, ``cp.arm32``,
``ffm.convblk``, ``conv_out.conv_out``, ...), children registered in the
order the JAX forward creates their parameters, so seeded random init draws
the same weights in both packages.  It computes in float32 by default, as
the JAX package does off the TPU, under
:func:`..utils.device.f32_precision`; a caller may ask for bfloat16 (or
float16) with ``compute_dtype``, as a JAX caller does.  The normalisation
runs in f32 before the cast, the sigmoid gates run in f32 whatever the
feature dtype, and the logits go to f32 before the 8× upsample and the
argmax.  No function of this module reaches a Pallas kernel in the JAX
package: its convolutions are cuDNN's, and the resizes, argmax and counts
are stock torch ops.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..ops.nn import (
    FoldedBatchNorm,
    conv,
    global_avg_pool,
    leaky_relu,
    max_pool,
    resize_bilinear_nchw,
    resize_nearest,
)
from ..ops.yuv import yuv420_to_rgb
from ..parallel.mesh import Replicas, shard_batch
from ..utils.batching import pad_batch_to
from ..utils.device import f32_precision, resolve_compute_dtype, resolve_device, to_host
from .weights import load_or_init

#: ImageNet channel statistics used at training time.
_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)

NUM_CLASSES = 19
_INFER_SIZE = 512

#: Seed of the random-init fallback (the JAX package's ``_random_init``).
_INIT_SEED = 1

#: MSB-first bit weights of the mask packing (``np.packbits`` order).
_BIT_WEIGHTS = tuple(1 << (7 - k) for k in range(8))


# ---------------------------------------------------------------------------
# Network (module paths give the JAX package's parameter names)
# ---------------------------------------------------------------------------


class ConvBNReLU(nn.Module):
    """Conv → folded BN → ReLU: keys ``<name>.conv.weight``, ``<name>.bn.*``."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, stride: int = 1,
                 padding: int | None = None):
        super().__init__()
        self.conv = conv(in_ch, out_ch, kernel, stride=stride, padding=padding)
        self.bn = FoldedBatchNorm(out_ch)

    def forward(self, x):
        return leaky_relu(self.bn(self.conv(x)))


class BasicBlock(nn.Module):
    """ResNet basic block: 3x3(stride) → 3x3, projected shortcut on a change."""

    def __init__(self, in_ch: int, out_ch: int, stride: int):
        super().__init__()
        self.conv1 = conv(in_ch, out_ch, 3, stride=stride)
        self.bn1 = FoldedBatchNorm(out_ch)
        self.conv2 = conv(out_ch, out_ch, 3)
        self.bn2 = FoldedBatchNorm(out_ch)
        self.downsample = (
            nn.Sequential(conv(in_ch, out_ch, 1, stride=stride, padding=0),
                          FoldedBatchNorm(out_ch))
            if stride != 1 or in_ch != out_ch
            else None
        )

    def forward(self, x):
        out = leaky_relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        sc = x if self.downsample is None else self.downsample(x)
        return leaky_relu(sc + out)


def _layer(in_ch: int, out_ch: int, stride: int) -> nn.Sequential:
    return nn.Sequential(BasicBlock(in_ch, out_ch, stride), BasicBlock(out_ch, out_ch, 1))


class ResNet18(nn.Module):
    """BiSeNet's ResNet-18 trunk: (N, 3, H, W) → features at strides 8/16/32."""

    def __init__(self):
        super().__init__()
        self.conv1 = conv(3, 64, 7, stride=2, padding=3)
        self.bn1 = FoldedBatchNorm(64)
        self.layer1 = _layer(64, 64, 1)
        self.layer2 = _layer(64, 128, 2)
        self.layer3 = _layer(128, 256, 2)
        self.layer4 = _layer(256, 512, 2)

    def forward(self, x):
        x = leaky_relu(self.bn1(self.conv1(x)))
        x = max_pool(x, 3, 2, 1)
        f8 = self.layer2(self.layer1(x))
        f16 = self.layer3(f8)
        return f8, f16, self.layer4(f16)


def _gate(x: torch.Tensor) -> torch.Tensor:
    """Sigmoid gate computed in f32, returned in ``x``'s dtype."""
    return torch.sigmoid(x.float()).to(x.dtype)


class AttentionRefinement(nn.Module):
    """ConvBNReLU → global-pool sigmoid gate over its output."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = ConvBNReLU(in_ch, out_ch)
        self.conv_atten = conv(out_ch, out_ch, 1, padding=0)
        self.bn_atten = FoldedBatchNorm(out_ch)

    def forward(self, x):
        feat = self.conv(x)
        atten = self.bn_atten(self.conv_atten(global_avg_pool(feat)))
        return feat * _gate(atten)


class ContextPath(nn.Module):
    """Trunk + global context + two attention-refined upsampling heads."""

    def __init__(self):
        super().__init__()
        self.resnet = ResNet18()
        self.conv_avg = ConvBNReLU(512, 128, 1, padding=0)
        self.arm32 = AttentionRefinement(512, 128)
        self.conv_head32 = ConvBNReLU(128, 128)
        self.arm16 = AttentionRefinement(256, 128)
        self.conv_head16 = ConvBNReLU(128, 128)

    def forward(self, x):
        f8, f16, f32 = self.resnet(x)
        avg = self.conv_avg(global_avg_pool(f32))  # broadcasts over f32's grid
        f32_up = resize_nearest(self.arm32(f32) + avg, tuple(f16.shape[2:]))
        f32_up = self.conv_head32(f32_up)
        f16_up = resize_nearest(self.arm16(f16) + f32_up, tuple(f8.shape[2:]))
        return f8, self.conv_head16(f16_up)


class FeatureFusion(nn.Module):
    """Concat → 1x1 ConvBNReLU → squeeze-excite-style gate, plus identity."""

    def __init__(self, in_ch: int = 256, out_ch: int = 256):
        super().__init__()
        self.convblk = ConvBNReLU(in_ch, out_ch, 1, padding=0)
        self.conv1 = conv(out_ch, out_ch // 4, 1, padding=0)
        self.conv2 = conv(out_ch // 4, out_ch, 1, padding=0)

    def forward(self, fsp, fcp):
        feat = self.convblk(torch.cat([fsp, fcp], dim=1))
        atten = self.conv2(leaky_relu(self.conv1(global_avg_pool(feat))))
        return feat * _gate(atten) + feat


class BiSeNetOutput(nn.Module):
    """3x3 ConvBNReLU → 1x1 class logits."""

    def __init__(self, in_ch: int = 256, mid_ch: int = 256, n_classes: int = NUM_CLASSES):
        super().__init__()
        self.conv = ConvBNReLU(in_ch, mid_ch)
        self.conv_out = conv(mid_ch, n_classes, 1, padding=0)

    def forward(self, x):
        return self.conv_out(self.conv(x))


class BiSeNetNet(nn.Module):
    """The parser network: (N, 3, H, W) normalized → (N, 19, H, W) f32 logits.

    The final 8× upsample is align-corners bilinear, as two products.
    """

    def __init__(self):
        super().__init__()
        self.cp = ContextPath()
        self.ffm = FeatureFusion()
        self.conv_out = BiSeNetOutput()

    def forward(self, x):
        f8, f16_up = self.cp(x)
        out = self.conv_out(self.ffm(f8, f16_up)).float()
        return resize_bilinear_nchw(out, tuple(x.shape[2:]), align_corners=True)


def bisenet_forward(net: BiSeNetNet, x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) normalized NHWC input → (N, H, W, 19) f32 logits.

    The JAX ``bisenet_forward``'s layouts around :class:`BiSeNetNet`.
    """
    return net(x.permute(0, 3, 1, 2).contiguous()).permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# Model wrapper
# ---------------------------------------------------------------------------


class BiSeNet:
    """Face parser with grouping, the JAX ``BiSeNet``'s predict contract.

    Overridable after construction, read at every call: ``attr_join_by_and``,
    ``attr_threshold``, ``mask_threshold``, ``mean``, ``std``.  ``net`` is
    the :class:`BiSeNetNet` on ``device``; every sub-batch is padded to
    ``batch_size`` by repeating its last face, as the JAX package pads, so
    the card runs one batch size (cuDNN picks its algorithms by batch size,
    and some picks are several times slower; see :mod:`..utils.batching`).
    With a ``mesh`` (:mod:`..parallel.mesh`) the device is the mesh's first,
    ``batch_size`` rounds up to a multiple of the mesh size, and every
    sub-batch splits into one block a shard, parsed on its card by its own
    replica of ``net``; results gather in shard order.  The network's
    weights are in ``compute_dtype`` (None gives float32 on every device).
    """

    def __init__(
        self,
        attr_groups: dict[str, list[int]] | None = None,
        mask_groups: dict[str, list[int]] | None = None,
        max_batch_size: int = 8,
        weights_dir: str | None = None,
        device=None,
        mesh=None,
        compute_dtype=None,
    ):
        self.attr_groups = attr_groups
        self.mask_groups = mask_groups
        self.batch_size = int(max_batch_size)
        self.attr_join_by_and = True
        self.attr_threshold = 5
        self.mask_threshold = 10
        self.mean = list(_MEAN)
        self.std = list(_STD)
        self.mesh = mesh
        self.device = mesh.devices[0] if mesh is not None else resolve_device(device)
        self.compute_dtype = resolve_compute_dtype(compute_dtype)
        if mesh is not None:
            # Sub-batches split evenly over the shards.
            self.batch_size = -(-self.batch_size // mesh.size) * mesh.size

        net = BiSeNetNet()
        self.pretrained = load_or_init("bisenet", net, weights_dir, seed=_INIT_SEED)
        self.net = net.to(self.device, self.compute_dtype).eval()
        self.net.requires_grad_(False)
        self._replicas = None if mesh is None else Replicas(mesh)

    def replicas(self) -> tuple:
        """The network of each shard (``(net,)`` without a mesh)."""
        return (self.net,) if self._replicas is None else self._replicas.get(self.net)

    def _logits(self, images: torch.Tensor, net=None) -> torch.Tensor:
        """uint8 (B, H, W, 3) crops on the device → (B, 19, 512, 512) f32
        logits: /255, half-pixel bilinear to 512², ImageNet normalization
        with the current ``mean``/``std`` (all f32), the cast to
        :attr:`compute_dtype`, the network (``net``, a shard's replica on
        the crops' device; :attr:`net` by default)."""
        mean = torch.tensor([float(v) for v in self.mean], device=images.device)
        std = torch.tensor([float(v) for v in self.std], device=images.device)
        with f32_precision():
            x = (images.float() / 255.0).permute(0, 3, 1, 2)
            x = resize_bilinear_nchw(x, (_INFER_SIZE, _INFER_SIZE))
            x = (x - mean[:, None, None]) / std[:, None, None]
            return (net or self.net)(x.to(self.compute_dtype))

    def _parse(self, images: torch.Tensor, out_h: int, out_w: int, src_hw=None, net=None):
        """uint8 (B, H, W, 3) crops on the device → (labels (B, out_h, out_w)
        uint8, counts (B, 19) int32), both on the device.  With ``src_hw``
        the images are packed 4:2:0 rows (B, L) of that (h, w)."""
        if src_hw is not None:
            images = yuv420_to_rgb(images, *src_hw)
        labels = self._logits(images, net).argmax(dim=1).to(torch.uint8)
        labels = resize_nearest(labels[:, None], (out_h, out_w))[:, 0]
        b = labels.shape[0]
        offset = torch.arange(b, device=labels.device)[:, None, None] * NUM_CLASSES
        counts = torch.bincount((labels.long() + offset).reshape(-1),
                                minlength=b * NUM_CLASSES)
        return labels, counts.reshape(b, NUM_CLASSES).to(torch.int32)

    def _parse_packed(self, images: torch.Tensor, out_h: int, out_w: int,
                      mask_attrs: tuple, src_hw=None, net=None):
        """Like :meth:`_parse`, with bit-packed per-group masks for labels.

        Each group's mask is padded on the right to a multiple of 8 columns
        and packed MSB first (``np.packbits`` order, 1 bit a pixel).

        Returns:
            uint8 packed masks (G, B, out_h, ceil(out_w/8)) and int32 counts
            (B, 19), on the device.
        """
        labels, counts = self._parse(images, out_h, out_w, src_hw, net)
        w8 = -(-out_w // 8)
        weights = torch.tensor(_BIT_WEIGHTS, dtype=torch.uint8, device=labels.device)
        packed = []
        for attrs in mask_attrs:
            m = torch.isin(labels, torch.tensor(attrs, dtype=torch.uint8, device=labels.device))
            m = torch.nn.functional.pad(m.to(torch.uint8), (0, w8 * 8 - out_w))
            m = m.reshape(m.shape[0], out_h, w8, 8)
            packed.append((m * weights).sum(dim=-1).to(torch.uint8))
        return torch.stack(packed), counts

    def _sub_batches(self, images):
        """Yields (device sub-batch of ``batch_size``, start, valid rows).

        ``images`` is a host uint8 array or a tensor (crops handed over on
        the device by the fused pipeline: no re-upload).  A short last
        sub-batch is padded by repeating its last row.  On a mesh the
        sub-batch is a tuple of one block a shard, each on its device.
        """
        bs = self.batch_size
        for start in range(0, images.shape[0], bs):
            chunk = images[start : start + bs]
            valid = chunk.shape[0]
            if torch.is_tensor(chunk):
                if self.mesh is None:
                    chunk = chunk.to(self.device)
                if valid < bs:
                    chunk = torch.cat([chunk, chunk[-1:].expand(bs - valid, *chunk.shape[1:])])
            else:
                chunk = np.ascontiguousarray(pad_batch_to(chunk, bs)[0])
                if self.mesh is None:
                    chunk = torch.from_numpy(chunk).to(self.device)
            if self.mesh is not None:
                chunk = shard_batch(chunk, self.mesh)
            yield chunk, start, valid

    def _each_shard(self, imgs, fn) -> list[tuple[np.ndarray, ...]]:
        """``fn(block, net)`` on a sub-batch: on every shard's block with its
        replica (every shard enqueued before the host waits on any), or on
        the whole sub-batch with :attr:`net`.  Returns each shard's host
        arrays, in shard order."""
        if self.mesh is None:
            return to_host([fn(imgs, self.net)])
        with f32_precision():  # once around every shard's pass
            outs = [fn(block, net) for block, net in zip(imgs, self.replicas())]
        return to_host(outs)

    @staticmethod
    def _out_hw(images, src_hw) -> tuple[int, int]:
        return src_hw if src_hw is not None else tuple(images.shape[1:3])

    def parse_batch(self, images, src_hw=None) -> tuple[np.ndarray, np.ndarray]:
        """Parses every face in sub-batches of ``batch_size``.

        ``src_hw`` marks ``images`` as packed 4:2:0 rows (N, L) of that
        (h, w).  Returns host arrays: uint8 labels (N, H, W) and int32
        counts (N, 19).
        """
        n = images.shape[0]
        h, w = self._out_hw(images, src_hw)
        labels_out = np.empty((n, h, w), np.uint8)
        counts_out = np.empty((n, NUM_CLASSES), np.int32)
        for imgs, start, valid in self._sub_batches(images):
            shards = self._each_shard(imgs, lambda b, net: self._parse(b, h, w, src_hw, net))
            labels_out[start : start + valid] = np.concatenate([s[0] for s in shards])[:valid]
            counts_out[start : start + valid] = np.concatenate([s[1] for s in shards])[:valid]
        return labels_out, counts_out

    def parse_counts(self, images, src_hw=None) -> np.ndarray:
        """Per-face class pixel counts (N, 19) int32 only; the labels stay
        on the device."""
        n = images.shape[0]
        h, w = self._out_hw(images, src_hw)
        counts_out = np.empty((n, NUM_CLASSES), np.int32)
        for imgs, start, valid in self._sub_batches(images):
            shards = self._each_shard(imgs, lambda b, net: self._parse(b, h, w, src_hw, net)[1:])
            counts_out[start : start + valid] = np.concatenate([s[0] for s in shards])[:valid]
        return counts_out

    def parse_batch_packed(self, images, mask_attrs: tuple,
                           src_hw=None) -> tuple[np.ndarray, np.ndarray]:
        """Like :meth:`parse_batch`, with bit-packed per-group masks.

        Returns host arrays: uint8 packed masks (G, N, H, ceil(W/8)) and
        int32 counts (N, 19).
        """
        n = images.shape[0]
        h, w = self._out_hw(images, src_hw)
        packed_out = np.empty((len(mask_attrs), n, h, -(-w // 8)), np.uint8)
        counts_out = np.empty((n, NUM_CLASSES), np.int32)
        for imgs, start, valid in self._sub_batches(images):
            shards = self._each_shard(
                imgs, lambda b, net: self._parse_packed(b, h, w, mask_attrs, src_hw, net))
            packed = np.concatenate([s[0] for s in shards], axis=1)
            packed_out[:, start : start + valid] = packed[:, :valid]
            counts_out[start : start + valid] = np.concatenate([s[1] for s in shards])[:valid]
        return packed_out, counts_out

    # -- grouping (host, from the device's counts and masks) -------------

    def group_by_attributes(self, counts: np.ndarray) -> dict[str, list[int]]:
        """Attribute-group membership from per-face class pixel counts.

        A positive index needs count > ``attr_threshold``, a negative one
        count <= ``attr_threshold``; the conditions join by AND (OR when
        ``attr_join_by_and`` is False).
        """
        join = np.all if self.attr_join_by_and else np.any
        groups: dict[str, list[int]] = {}
        for name, attrs in self.attr_groups.items():
            conds = np.stack(
                [counts[:, abs(a)] > self.attr_threshold if a > 0
                 else counts[:, abs(a)] <= self.attr_threshold for a in attrs],
                axis=1,
            )
            groups[name] = np.nonzero(join(conds, axis=1))[0].tolist()
        return groups

    def group_by_masks(
        self, labels: np.ndarray, counts: np.ndarray
    ) -> dict[str, tuple[list[int], np.ndarray]]:
        """Mask-group membership and 0/255 masks from the label raster."""
        groups: dict[str, tuple[list[int], np.ndarray]] = {}
        for name, attrs in self.mask_groups.items():
            inds = np.nonzero(counts[:, attrs].sum(axis=1) > self.mask_threshold)[0].tolist()
            masks = (
                np.isin(labels[inds], attrs).astype(np.uint8) * 255
                if inds
                else np.zeros((0,) + labels.shape[1:], np.uint8)
            )
            groups[name] = (inds, masks)
        return groups

    def group_by_masks_packed(
        self, packed: np.ndarray, counts: np.ndarray, width: int
    ) -> dict[str, tuple[list[int], np.ndarray]]:
        """:meth:`group_by_masks` from bit-packed masks.

        Membership comes from ``counts`` as on the raster path; only member
        rows are unpacked (``np.unpackbits``, MSB first).
        """
        groups: dict[str, tuple[list[int], np.ndarray]] = {}
        h, w8 = packed.shape[2], packed.shape[3]
        for g, (name, attrs) in enumerate(self.mask_groups.items()):
            inds = np.nonzero(counts[:, attrs].sum(axis=1) > self.mask_threshold)[0].tolist()
            if inds:
                bits = np.unpackbits(packed[g][inds], axis=-1)
                masks = bits.reshape(len(inds), h, w8 * 8)[:, :, :width] * 255
            else:
                masks = np.zeros((0, h, width), np.uint8)
            groups[name] = (inds, masks)
        return groups

    def predict(self, images, valid_n: int | None = None, src_hw=None):
        """Attribute and mask groups of a uint8 face batch.

        Args:
            images: Host uint8 (N, H, W, 3) array or list of arrays, or a
                tensor (crops already on the device).
            valid_n: Only faces with index < ``valid_n`` join a group (a
                batch that carries padding rows at its end).
            src_hw: When set, ``images`` is packed 4:2:0 rows (N, L) of
                this (h, w), reconstructed on the device.

        Returns:
            ``attr_groups`` (name → face indices) and ``mask_groups`` (name
            → (face indices, stacked uint8 0/255 masks)), empty groups
            dropped; either is None when not configured.  Only counts and,
            with mask groups, bit-packed masks leave the device.
        """
        if isinstance(images, list):
            images = np.stack(images)
        if not torch.is_tensor(images):
            images = np.asarray(images, np.uint8)
        if src_hw is not None:
            src_hw = (int(src_hw[0]), int(src_hw[1]))

        if self.mask_groups is not None:
            mask_attrs = tuple(
                tuple(int(a) for a in attrs) for attrs in self.mask_groups.values()
            )
            packed, counts = self.parse_batch_packed(images, mask_attrs, src_hw)
        else:
            packed, counts = None, self.parse_counts(images, src_hw)

        attr_groups = None
        if self.attr_groups is not None:
            attr_groups = self.group_by_attributes(counts)
            if valid_n is not None:
                attr_groups = {k: [i for i in v if i < valid_n] for k, v in attr_groups.items()}
            attr_groups = {k: v for k, v in attr_groups.items() if len(v) > 0}

        mask_groups = None
        if self.mask_groups is not None:
            width = self._out_hw(images, src_hw)[1]
            mask_groups = self.group_by_masks_packed(packed, counts, int(width))
            if valid_n is not None:
                filtered = {}
                for k, (inds, masks) in mask_groups.items():
                    sel = [j for j, i in enumerate(inds) if i < valid_n]
                    filtered[k] = ([inds[j] for j in sel], masks[sel])
                mask_groups = filtered
            mask_groups = {k: v for k, v in mask_groups.items() if len(v[0]) > 0}

        return attr_groups, mask_groups
