"""ResNet backbone (NCHW) with DeepLab output-stride-8 dilation.

The port of ``hiast_tpu/models/resnet.py`` (reference:
code/sseg/models/modules/resnet.py:58-190) with the ``_nostride_dilate``
surgery DeepLab-v2 applies (reference: seg_models/deeplab_v2.py:42-56):

- layer3: the stride-2 3x3 conv of block 0 becomes stride 1 / dilation 1;
  every other 3x3 conv gets dilation 2; the block-0 downsample loses its
  stride.
- layer4: block-0 3x3 conv becomes stride 1 / dilation 2; the rest dilation 4.

This yields output stride 8 with a 2048-channel feature map.  Parameter
names are the torch reference's (``layer3.5.conv2.weight``,
``layer1.0.downsample.1.running_var``), so a state_dict of this module is the
reference ``.pth`` layout.

Normalisation is ``nn.BatchNorm2d`` (eps 1e-5, momentum 0.1): torch's own
running-statistics rule, which the JAX package's ``models/norm.py``
imitates.  This slice runs it in eval mode only (generation); the
train-mode frozen-affine behaviour comes with the training slice.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

BN_EPS = 1e-5


def _bn(channels: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(channels, eps=BN_EPS, momentum=0.1)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride/dilation) -> 1x1 with residual, expansion 4."""

    def __init__(
        self, inplanes: int, planes: int, stride: int = 1, dilation: int = 1,
        has_downsample: bool = False,
    ):
        super().__init__()
        out_ch = planes * 4
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = nn.Conv2d(
            planes, planes, 3, stride=stride, padding=dilation, dilation=dilation, bias=False
        )
        self.bn2 = _bn(planes)
        self.conv3 = nn.Conv2d(planes, out_ch, 1, bias=False)
        self.bn3 = _bn(out_ch)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = (
            nn.Sequential(nn.Conv2d(inplanes, out_ch, 1, stride=stride, bias=False), _bn(out_ch))
            if has_downsample
            else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return self.relu(y + identity)


class ResNetOS8(nn.Module):
    """Dilated ResNet, output stride 8 (DeepLab-v2 backbone)."""

    # (planes, first-block stride, first-block dilation, rest dilation)
    STAGES = ((64, 1, 1, 1), (128, 2, 1, 1), (256, 1, 1, 2), (512, 1, 2, 4))

    def __init__(self, layers: Sequence[int] = (3, 4, 23, 3)):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = _bn(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        inplanes = 64
        for idx, ((planes, stride, dil0, dil), depth) in enumerate(zip(self.STAGES, layers)):
            blocks = [
                Bottleneck(
                    inplanes if b == 0 else planes * 4,
                    planes,
                    stride=stride if b == 0 else 1,
                    dilation=dil0 if b == 0 else dil,
                    has_downsample=b == 0,
                )
                for b in range(depth)
            ]
            inplanes = planes * 4
            self.add_module(f"layer{idx + 1}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor, return_low: bool = False):
        """[B, 2048, H/8, W/8]; with ``return_low`` also layer1's output,
        the 256-channel stride-4 feature DeepLab-v3+'s decoder reads."""
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        low = self.layer1(x)
        x = self.layer4(self.layer3(self.layer2(low)))
        return (x, low) if return_low else x
