"""Plain RetinaFace detector: network, decode, greedy NMS, "largest".

Everything is built from a configuration's ``model`` block, the keys of
biubug6/Pytorch_Retinaface's ``cfg_re50`` (:func:`check_model` refuses a
block this module cannot build).  The network: a torchvision ResNet-50
trunk (C3/C4/C5 at strides 8, 16, 32, ``return_layers``), a 3-level FPN
from ``in_channel`` × (2, 4, 8) to ``out_channel`` channels with nearest
upsampling, one SSH module a level (3×3, 5×5 and 7×7 branches of
``ssh_branches`` channels) and three 1×1 heads a level over
``anchors_per_cell`` anchors (2 class logits, 4 box and 10 landmark
regressions).  Activations are ReLU (the published ``leaky`` is 0 at 256
channels); BatchNorm is folded (:class:`.nn.Affine`).  Parameter names
follow the published module paths, with ``.scale``/``.bias`` for a folded
BatchNorm.

Around it: the RGB batch resized (aspect kept, zero border) to the
interim size, flipped to BGR minus the training mean (104, 117, 123);
anchors of ``min_sizes`` at ``steps``; the decode with ``variance``;
candidates above the visibility threshold, the K best by a stable
descending sort (K from ``pre_topk`` and ``pre_topk_ceiling``); greedy NMS
at IoU ``nms_threshold`` with the +1 area convention; and per image the
kept box of largest area.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from .nn import Affine, conv, resize_bilinear_nhwc

BGR_MEAN = (104.0, 117.0, 123.0)
#: The ResNet-50 trunk's C3, C4 and C5, as ``return_layers`` names them.
RETURN_LAYERS = {"layer2": 1, "layer3": 2, "layer4": 3}


def check_model(model: dict):
    """Raises ValueError unless this module builds ``model`` as stated."""
    cin, cout = model["in_channel"], model["out_channel"]
    problems = []
    if model["backbone"] != "resnet50" or model["return_layers"] != RETURN_LAYERS:
        problems.append("only the ResNet-50 trunk with C3-C5 is built")
    if cin * 2 != 512:
        problems.append("ResNet-50's C3 has 512 channels: in_channel must be 256")
    if list(model["ssh_branches"]) != [cout // 2, cout // 4, cout // 4]:
        problems.append("ssh_branches must be out_channel / (2, 4, 4)")
    if len(model["min_sizes"]) != 3 or len(model["steps"]) != 3 or any(
            len(s) != model["anchors_per_cell"] for s in model["min_sizes"]):
        problems.append("three levels, each with anchors_per_cell min sizes")
    if problems:
        raise ValueError("RetinaFace model block: " + "; ".join(problems))


class ConvBN(nn.Sequential):
    """Conv → folded BN (→ ReLU): ``<name>.0.weight``, ``<name>.1.scale``."""

    def __init__(self, in_ch, out_ch, kernel, padding=None, act=True):
        super().__init__(conv(in_ch, out_ch, kernel, padding=padding), Affine(out_ch))
        self.act = act

    def forward(self, x):
        x = super().forward(x)
        return torch.relu(x) if self.act else x


class Bottleneck(nn.Module):
    def __init__(self, in_ch, width, stride, project):
        super().__init__()
        self.conv1 = conv(in_ch, width, 1, padding=0)
        self.bn1 = Affine(width)
        self.conv2 = conv(width, width, 3, stride=stride)
        self.bn2 = Affine(width)
        self.conv3 = conv(width, width * 4, 1, padding=0)
        self.bn3 = Affine(width * 4)
        self.downsample = (nn.Sequential(conv(in_ch, width * 4, 1, stride=stride, padding=0),
                                         Affine(width * 4)) if project else None)

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + identity)


def _stage(in_ch, width, depth, stride):
    blocks = [Bottleneck(in_ch, width, stride, True)]
    blocks += [Bottleneck(width * 4, width, 1, False) for _ in range(depth - 1)]
    return nn.Sequential(*blocks)


class ResNet50(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = conv(3, 64, 7, stride=2, padding=3)
        self.bn1 = Affine(64)
        self.layer1 = _stage(64, 64, 3, 1)
        self.layer2 = _stage(256, 128, 4, 2)
        self.layer3 = _stage(512, 256, 6, 2)
        self.layer4 = _stage(1024, 512, 3, 2)

    def forward(self, x):
        x = torch.relu(self.bn1(self.conv1(x)))
        x = torch.nn.functional.max_pool2d(x, 3, 2, 1)
        c3 = self.layer2(self.layer1(x))
        c4 = self.layer3(c3)
        return c3, c4, self.layer4(c4)


class SSH(nn.Module):
    def __init__(self, in_ch=256, out_ch=256):
        super().__init__()
        q = out_ch // 4
        self.conv3X3 = ConvBN(in_ch, out_ch // 2, 3, act=False)
        self.conv5X5_1 = ConvBN(in_ch, q, 3)
        self.conv5X5_2 = ConvBN(q, q, 3, act=False)
        self.conv7X7_2 = ConvBN(q, q, 3)
        self.conv7x7_3 = ConvBN(q, q, 3, act=False)

    def forward(self, x):
        b5_1 = self.conv5X5_1(x)
        b7 = self.conv7x7_3(self.conv7X7_2(b5_1))
        return torch.relu(torch.cat([self.conv3X3(x), self.conv5X5_2(b5_1), b7], dim=1))


def _upsample_nearest(x, like):
    return torch.nn.functional.interpolate(x, size=tuple(like.shape[2:]), mode="nearest")


class FPN(nn.Module):
    def __init__(self, in_chs=(512, 1024, 2048), out_ch=256):
        super().__init__()
        self.output1 = ConvBN(in_chs[0], out_ch, 1, padding=0)
        self.output2 = ConvBN(in_chs[1], out_ch, 1, padding=0)
        self.output3 = ConvBN(in_chs[2], out_ch, 1, padding=0)
        self.merge1 = ConvBN(out_ch, out_ch, 3)
        self.merge2 = ConvBN(out_ch, out_ch, 3)

    def forward(self, feats):
        o1, o2, o3 = self.output1(feats[0]), self.output2(feats[1]), self.output3(feats[2])
        o2 = self.merge2(o2 + _upsample_nearest(o3, o2))
        o1 = self.merge1(o1 + _upsample_nearest(o2, o1))
        return [o1, o2, o3]


class Head(nn.Module):
    def __init__(self, in_ch, num_out, anchors_per_cell):
        super().__init__()
        self.num_out = num_out
        self.conv1x1 = conv(in_ch, anchors_per_cell * num_out, 1, padding=0, bias=True)

    def forward(self, x):
        y = self.conv1x1(x)
        return y.permute(0, 2, 3, 1).reshape(y.shape[0], -1, self.num_out)


class RetinaFaceNet(nn.Module):
    """(N, 3, H, W) BGR-minus-mean → softmaxed scores (N, A, 2), box (N, A, 4)
    and landmark (N, A, 10) regressions, at the widths of ``model``."""

    def __init__(self, model: dict):
        super().__init__()
        check_model(model)
        cin, cout, a = model["in_channel"], model["out_channel"], model["anchors_per_cell"]
        self.body = ResNet50()
        self.fpn = FPN((cin * 2, cin * 4, cin * 8), cout)
        self.ssh1, self.ssh2, self.ssh3 = SSH(cout, cout), SSH(cout, cout), SSH(cout, cout)
        self.ClassHead = nn.ModuleList(Head(cout, 2, a) for _ in range(3))
        self.BboxHead = nn.ModuleList(Head(cout, 4, a) for _ in range(3))
        self.LandmarkHead = nn.ModuleList(Head(cout, 10, a) for _ in range(3))

    def forward(self, x):
        fpn = self.fpn(self.body(x))
        feats = [m(f) for m, f in zip((self.ssh1, self.ssh2, self.ssh3), fpn)]
        cls = torch.cat([h(f) for h, f in zip(self.ClassHead, feats)], dim=1)
        loc = torch.cat([h(f) for h, f in zip(self.BboxHead, feats)], dim=1)
        ldm = torch.cat([h(f) for h, f in zip(self.LandmarkHead, feats)], dim=1)
        return torch.softmax(cls, dim=-1), loc, ldm


def anchors(h: int, w: int, model: dict) -> np.ndarray:
    """(A, 4) normalized (cx, cy, w, h): levels in stride order, each
    row-major over its grid with the level's sizes innermost."""
    levels = []
    for stride, sizes in zip(model["steps"], model["min_sizes"]):
        fh, fw = math.ceil(h / stride), math.ceil(w / stride)
        cy = (np.arange(fh, dtype=np.float32) + 0.5) * stride / h
        cx = (np.arange(fw, dtype=np.float32) + 0.5) * stride / w
        g = np.zeros((fh, fw, len(sizes), 4), np.float32)
        g[..., 0] = cx[None, :, None]
        g[..., 1] = cy[:, None, None]
        g[..., 2] = np.array([s / w for s in sizes], np.float32)
        g[..., 3] = np.array([s / h for s in sizes], np.float32)
        levels.append(g.reshape(-1, 4))
    return np.concatenate(levels)


def interim_geometry(h: int, w: int, ih: int, iw: int):
    """Scale and (top, bottom, left, right) border of the aspect-kept fit
    of an h×w image into ih×iw (the binding axis by integer products)."""
    if iw * h < ih * w:
        scale = iw / w
        rw, rh = iw, int(h * scale)
    else:
        scale = ih / h
        rw, rh = int(w * scale), ih
    return scale, ((ih - rh) // 2, (ih - rh + 1) // 2, (iw - rw) // 2, (iw - rw + 1) // 2)


def decode(loc, ldm, priors, h, w, variance):
    """Corner boxes (N, A, 4) and landmarks (N, A, 10) in interim pixels."""
    v0, v1 = variance
    cxy, pwh = priors[:, :2], priors[:, 2:]
    b_cxy = cxy + loc[..., :2] * v0 * pwh
    b_wh = pwh * torch.exp(loc[..., 2:] * v1)
    xy1 = b_cxy - b_wh / 2.0
    boxes = torch.cat([xy1, xy1 + b_wh], dim=-1)
    boxes = boxes * torch.tensor([w, h, w, h], dtype=torch.float32, device=loc.device)
    pts = ldm.reshape(*ldm.shape[:-1], 5, 2)
    pts = cxy[:, None, :] + pts * v0 * pwh[:, None, :]
    pts = pts * torch.tensor([w, h], dtype=torch.float32, device=loc.device)
    return boxes, pts.reshape(*ldm.shape[:-1], 10)


def greedy_nms(boxes: torch.Tensor, valid: torch.Tensor, threshold: float) -> torch.Tensor:
    """Keep mask (N, K) of greedy NMS over score-sorted boxes (N, K, 4):
    candidate i, if still kept, suppresses every later j whose IoU with it
    (areas with +1) exceeds the threshold."""
    x1, y1, x2, y2 = (boxes[..., i] for i in range(4))
    area = (x2 - x1 + 1.0) * (y2 - y1 + 1.0)
    zero = boxes.new_zeros(())
    iw = torch.maximum(zero, torch.minimum(x2[..., :, None], x2[..., None, :])
                       - torch.maximum(x1[..., :, None], x1[..., None, :]) + 1.0)
    ih = torch.maximum(zero, torch.minimum(y2[..., :, None], y2[..., None, :])
                       - torch.maximum(y1[..., :, None], y1[..., None, :]) + 1.0)
    inter = iw * ih
    union = area[..., :, None] + area[..., None, :] - inter
    iou = inter / torch.maximum(union, boxes.new_tensor(1e-12))
    n, k = valid.shape
    later = torch.arange(k, device=boxes.device)
    keep = torch.ones_like(valid)
    for i in range(k):
        alive = keep[:, i] & valid[:, i]
        keep = keep & ~((iou[:, i, :] > threshold) & (later[None, :] > i) & alive[:, None])
    return keep & valid


def pre_topk(n_above: int, n_anchors: int, model: dict) -> int:
    """K of the candidate pre-selection: ``pre_topk``, grown to the next
    power of two of the candidates above the threshold, at most
    ``pre_topk_ceiling`` (the package's documented cap-growth policy,
    whose grown value persists)."""
    base = model["pre_topk"]
    k = min(base, n_anchors)
    if n_above > k:
        grown = base
        while grown < n_above:
            grown *= 2
        k = min(grown, model["pre_topk_ceiling"], n_anchors)
    return k


@torch.no_grad()
def detect_largest(net: RetinaFaceNet, model: dict, images: torch.Tensor,
                   interim: tuple[int, int], vis_threshold: float):
    """The largest kept face of each image of a uniform uint8 (N, H, W, 3)
    batch on the net's device.

    Returns (landmarks (N, 5, 2) in source pixels, found (N,) bool).
    """
    n, h, w, _ = images.shape
    ih, iw = interim
    scale, (t, b, l, r) = interim_geometry(h, w, ih, iw)
    x = images.to(torch.float32)
    if (h, w) != (ih, iw):
        x = resize_bilinear_nhwc(x, (ih - t - b, iw - l - r), pad=((t, b), (l, r)))
    else:
        scale, (t, b, l, r) = 1.0, (0, 0, 0, 0)
    mean = torch.tensor(BGR_MEAN, dtype=torch.float32, device=x.device)
    x = x.flip(-1) - mean
    scores, loc, ldm = net(x.permute(0, 3, 1, 2).contiguous())
    priors = torch.from_numpy(anchors(ih, iw, model)).to(x.device)
    boxes, pts = decode(loc.float(), ldm.float(), priors, ih, iw, model["variance"])
    s = scores[..., 1].float()
    above = s > vis_threshold
    k = pre_topk(int(above.sum(dim=1).max()), s.shape[1], model)
    s = s.masked_fill(~above, float("-inf"))
    top_s, top_i = torch.sort(s, dim=1, descending=True, stable=True)
    top_s, top_i = top_s[:, :k], top_i[:, :k]
    bx = torch.gather(boxes, 1, top_i[..., None].expand(-1, -1, 4))
    lm = torch.gather(pts, 1, top_i[..., None].expand(-1, -1, 10))
    keep = greedy_nms(bx, torch.isfinite(top_s), model["nms_threshold"])
    area = (bx[..., 2] - bx[..., 0] + 1.0) * (bx[..., 3] - bx[..., 1] + 1.0)
    pick = area.masked_fill(~keep, float("-inf")).argmax(dim=1)
    sel = torch.gather(lm, 1, pick[:, None, None].expand(-1, 1, 10)).reshape(n, 5, 2)
    offset = torch.tensor([l, t], dtype=torch.float32, device=x.device)
    return (sel - offset) / torch.tensor(scale, dtype=torch.float32, device=x.device), \
        keep.any(dim=1)
