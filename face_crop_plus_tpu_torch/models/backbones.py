"""ResNet-50 trunk of the face detector (PyTorch, NCHW).

:class:`ResNet50Features` is the counterpart of
``face_crop_plus_tpu.models.backbones.resnet50_features``:
the torchvision ResNet-50 v1.5 trunk (7x7/2 stem + 3x3/2 max-pool;
bottlenecks with expansion 4 and the stride on the 3x3 conv; stage widths
64/128/256/512 with depths 3/4/6/3) returning the C3/C4/C5 pyramid.
Module paths give the JAX package's parameter names under the caller's
prefix (``body.conv1.weight``, ``body.layer1.0.bn1.scale``, ...).

The JAX package's default stem is an exact space-to-depth reformulation of
the 7x7/2 conv, and its W-s2d variants are TPU lane-packing strategies;
the port runs the plain convolution they are equal to.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.nn import FoldedBatchNorm, conv, leaky_relu, max_pool


class Bottleneck(nn.Module):
    """Torchvision Bottleneck: 1x1 → 3x3(stride) → 1x1(×4) + identity."""

    def __init__(self, in_ch: int, width: int, stride: int, project: bool):
        super().__init__()
        self.conv1 = conv(in_ch, width, 1, padding=0)
        self.bn1 = FoldedBatchNorm(width)
        self.conv2 = conv(width, width, 3, stride=stride)
        self.bn2 = FoldedBatchNorm(width)
        self.conv3 = conv(width, width * 4, 1, padding=0)
        self.bn3 = FoldedBatchNorm(width * 4)
        self.downsample = (
            nn.Sequential(
                conv(in_ch, width * 4, 1, stride=stride, padding=0),
                FoldedBatchNorm(width * 4),
            )
            if project
            else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = leaky_relu(self.bn1(self.conv1(x)))
        out = leaky_relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return leaky_relu(out + identity)


def _stage(in_ch: int, width: int, depth: int, stride: int) -> nn.Sequential:
    blocks = [Bottleneck(in_ch, width, stride, project=True)]
    blocks += [Bottleneck(width * 4, width, 1, project=False) for _ in range(1, depth)]
    return nn.Sequential(*blocks)


class ResNet50Features(nn.Module):
    """ResNet-50 trunk: (N, 3, H, W) → (C3, C4, C5) at strides 8/16/32."""

    def __init__(self, in_ch: int = 3):
        super().__init__()
        self.conv1 = conv(in_ch, 64, 7, stride=2, padding=3)
        self.bn1 = FoldedBatchNorm(64)
        self.layer1 = _stage(64, 64, 3, stride=1)
        self.layer2 = _stage(256, 128, 4, stride=2)
        self.layer3 = _stage(512, 256, 6, stride=2)
        self.layer4 = _stage(1024, 512, 3, stride=2)

    def forward(self, x: torch.Tensor):
        x = leaky_relu(self.bn1(self.conv1(x)))
        x = max_pool(x, window=3, stride=2, padding=1)
        x = self.layer1(x)
        c3 = self.layer2(x)
        c4 = self.layer3(c3)
        c5 = self.layer4(c4)
        return c3, c4, c5

