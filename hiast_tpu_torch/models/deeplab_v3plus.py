"""DeepLab-v3+ segmentation head on the OS8 ResNet backbone (NCHW).

The port of ``hiast_tpu/models/deeplab_v3plus.py``: ASPP-v3 (a 1x1 and
three 3x3 convs at dilations 12/24/36 plus image-level pooling, each 256
channels with BatchNorm and ReLU, concatenated and projected to 256) over
the 2048-channel OS8 feature; the stride-4 low-level feature (layer1's
output) reduced to 48 channels; the ASPP output upsampled 2x (bilinear,
align_corners=True, in float32) and concatenated with it; two 3x3 convs and
a 1x1 classifier with bias.  Logits come out at stride 4, not 8.  No
dropout, as in the JAX package.

Module names are the flax names (``aspp.branch0.conv``, ``aspp.pool_proj.bn``,
``low_proj``, ``decoder0``, ``decoder1``, ``classifier``) and the trunk is
DeepLab-v2's ``backbone.*``, so ``flax_to_port_state_dict`` carries the JAX
variables across and a DeepLab-v2 ``.pth`` loads into the trunk
(``utils/checkpoint.load_weights`` leaves the head at its initialisation).
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from hiast_tpu_torch.models.deeplab_v2 import init_weights
from hiast_tpu_torch.models.resnet import BN_EPS, ResNetOS8
from hiast_tpu_torch.ops.resize import bilinear_resize
from hiast_tpu_torch.registry import SEG_MODEL


class PooledBatchNorm(nn.BatchNorm2d):
    """BatchNorm of the image-pooled branch, which holds one value per
    channel and sample.  In train mode at batch 1 torch's ``batch_norm``
    raises; the JAX ``TorchBatchNorm`` normalises by that one value's
    variance, 0, so the output is the BatchNorm bias (no gradient reaches
    the input or the scale), and moves the running variance toward 0 and
    the running mean toward the value.  This does the same."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and x.shape[0] * x.shape[2] * x.shape[3] == 1):
            return super().forward(x)
        with torch.no_grad():
            self.running_mean.lerp_(x.detach().float().flatten(), self.momentum)
            self.running_var.mul_(1.0 - self.momentum)
            self.num_batches_tracked.add_(1)
        return torch.zeros_like(x) + self.bias.view(1, -1, 1, 1).to(x.dtype)


class ConvBNReLU(nn.Module):
    """conv (no bias, 'same' padding) -> BatchNorm -> ReLU (JAX ``_ConvBNReLU``)."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3, dilation: int = 1,
                 norm: type[nn.BatchNorm2d] = nn.BatchNorm2d):
        super().__init__()
        pad = dilation * (kernel - 1) // 2
        self.conv = nn.Conv2d(in_channels, features, kernel, padding=pad, dilation=dilation, bias=False)
        self.bn = norm(features, eps=BN_EPS, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(self.conv(x)))


class ASPPV3(nn.Module):
    """1x1 + dilated 3x3 branches + image-level pooling, concatenated -> 256."""

    def __init__(self, in_channels: int = 2048, features: int = 256, dilations: Sequence[int] = (12, 24, 36)):
        super().__init__()
        self.branch0 = ConvBNReLU(in_channels, features, kernel=1)
        for i, d in enumerate(dilations):
            self.add_module(f"branch{i + 1}", ConvBNReLU(in_channels, features, kernel=3, dilation=d))
        self.num_dilated = len(dilations)
        self.pool_proj = ConvBNReLU(in_channels, features, kernel=1, norm=PooledBatchNorm)
        self.project = ConvBNReLU((len(dilations) + 2) * features, features, kernel=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        branches = [getattr(self, f"branch{i}")(x) for i in range(self.num_dilated + 1)]
        # the image-level mean in float32 (bf16 loses precision over the
        # whole grid), cast back to the compute dtype, as the JAX head does
        pooled = x.mean((2, 3), keepdim=True, dtype=torch.float32).to(x.dtype)
        branches.append(self.pool_proj(pooled).expand_as(branches[0]))
        return self.project(torch.cat(branches, dim=1))


@SEG_MODEL.register("DeepLab_V3Plus")
class DeepLabV3Plus(nn.Module):
    row_stride = None  # runs no slabs of the ``space`` axis yet (the pooled branch, ROADMAP A20)

    def __init__(
        self, num_classes: int = 19, output_dim: int = 256,
        backbone_layers: Sequence[int] = (3, 4, 23, 3), low_level_dim: int = 48,
    ):
        super().__init__()
        self.backbone = ResNetOS8(layers=backbone_layers)
        self.aspp = ASPPV3(2048, output_dim)
        self.low_proj = ConvBNReLU(256, low_level_dim, kernel=1)
        self.decoder0 = ConvBNReLU(output_dim + low_level_dim, output_dim, kernel=3)
        self.decoder1 = ConvBNReLU(output_dim, output_dim, kernel=3)
        self.classifier = nn.Conv2d(output_dim, num_classes, 1)

    def forward(self, x: torch.Tensor) -> dict:
        feat, low = self.backbone(x, return_low=True)
        y = self.aspp(feat)
        low = self.low_proj(low)
        # stride 8 -> 4: interpolated in float32, back in the compute dtype
        y = bilinear_resize(y, low.shape[2], low.shape[3])
        y = self.decoder1(self.decoder0(torch.cat([y, low], dim=1)))
        return {"logits": self.classifier(y), "backbone": feat}

    def init_weights(self, generator: torch.Generator) -> None:
        init_weights(self, generator)
