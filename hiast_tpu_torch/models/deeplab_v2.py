"""DeepLab-v2 segmentation head on the OS8 ResNet backbone (NCHW).

The port of ``hiast_tpu/models/deeplab_v2.py`` (reference:
code/sseg/models/modules/seg_models/deeplab_v2.py:8-69): ASPP-v2 = sum of
four parallel 3x3 convs at dilations 6/12/18/24 over the 2048-d backbone
feature.  The 1x1 256-d ``representation`` head is kept for checkpoint
parity (the reference computes it but never returns it); generation does
not run it.  ``FCDiscriminator`` is the adversarial warmup's domain
discriminator.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from hiast_tpu_torch.models.resnet import ResNetOS8
from hiast_tpu_torch.parallel import spatial
from hiast_tpu_torch.registry import SEG_MODEL


class ASPPV2(nn.Module):
    """Sum of parallel dilated 3x3 convs (with bias)."""

    def __init__(self, in_channels: int, num_classes: int, dilations: Sequence[int] = (6, 12, 18, 24)):
        super().__init__()
        self.conv2d_list = nn.ModuleList(
            nn.Conv2d(in_channels, num_classes, 3, padding=d, dilation=d, bias=True)
            for d in dilations
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv2d_list[0](x)
        for conv in self.conv2d_list[1:]:
            out = out + conv(x)
        return out


class SpatialASPPV2(ASPPV2):
    """``ASPPV2`` on a row slab (``parallel/spatial.py:convert_spatial``):
    its input's halo is exchanged once, at the deepest dilation (24 rows),
    and each branch reads its own depth of it."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if spatial.rows_group() is None:
            return super().forward(x)
        deepest = max(conv.dilation[0] for conv in self.conv2d_list)
        rows = spatial.halo_rows(x, deepest, deepest)
        h, out = x.shape[2], None
        for conv in self.conv2d_list:
            d = conv.dilation[0]
            y = F.conv2d(rows[:, :, deepest - d:deepest + h + d], conv.weight, conv.bias, 1, (0, conv.padding[1]),
                         conv.dilation)
            out = y if out is None else out + y
        return out


@SEG_MODEL.register("DeepLab_V2")
class DeepLabV2(nn.Module):
    # the rows each slab of the ``space`` axis is a multiple of: the output
    # stride, which also starts every slab on the strong view's equalize grid of 4
    row_stride = 8

    def __init__(
        self, num_classes: int = 19, output_dim: int = 256,
        backbone_layers: Sequence[int] = (3, 4, 23, 3),
    ):
        super().__init__()
        self.backbone = ResNetOS8(layers=backbone_layers)
        self.aspp = ASPPV2(2048, num_classes)
        self.representation = nn.Sequential(nn.Conv2d(2048, output_dim, 1))

    def forward(self, x: torch.Tensor) -> dict:
        feat = self.backbone(x)
        return {"logits": self.aspp(feat), "backbone": feat}

    def init_weights(self, generator: torch.Generator) -> None:
        init_weights(self, generator)


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded random initialisation drawn from ``generator``: He-normal convs
    (fan-in), N(0, 0.01) kernels for the classifying convs as in the JAX
    package (DeepLab-v2's ASPP, DeepLab-v3+'s ``classifier``), zero biases,
    identity BatchNorm except the last BN of each residual branch, scaled to
    0.1 so that a random 101-layer trunk keeps its activations, and so its
    logits and confidences, in a realistic range."""
    for name, m in module.named_modules():
        if isinstance(m, nn.Conv2d):
            if ".conv2d_list." in f".{name}." or name == "classifier":
                std = 0.01
            else:
                std = (2.0 / (m.in_channels * m.kernel_size[0] * m.kernel_size[1])) ** 0.5
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator) * std)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
            m.reset_running_stats()
            if name.endswith(".bn3"):
                m.weight.fill_(0.1)


class FCDiscriminator(nn.Module):
    """Fully-convolutional domain discriminator (JAX
    ``deeplab_v2.FCDiscriminator``; reference
    code/sseg/models/modules/discriminator.py:7-29): five 4x4 stride-2
    pad-1 convs, widths ndf, 2ndf, 4ndf, 8ndf and 1, LeakyReLU 0.2 between
    them.  NCHW [B, C, H, W] -> [B, 1, H/32, W/32]."""

    def __init__(self, num_classes: int, ndf: int = 64):
        super().__init__()
        widths = [num_classes, ndf, ndf * 2, ndf * 4, ndf * 8]
        for i in range(4):
            setattr(self, f"conv{i + 1}", nn.Conv2d(widths[i], widths[i + 1], 4, stride=2, padding=1))
        self.classifier = nn.Conv2d(ndf * 8, 1, 4, stride=2, padding=1)
        self.leaky_relu = nn.LeakyReLU(0.2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv in (self.conv1, self.conv2, self.conv3, self.conv4):
            x = self.leaky_relu(conv(x))
        return self.classifier(x)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """torch's default Conv2d initialisation (the reference's), drawn
        from ``generator``: weights and biases U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                bound = 1.0 / (m.in_channels * m.kernel_size[0] * m.kernel_size[1]) ** 0.5
                m.weight.copy_((torch.rand(m.weight.shape, generator=generator) * 2 - 1) * bound)
                m.bias.copy_((torch.rand(m.bias.shape, generator=generator) * 2 - 1) * bound)


REMAT_MODES = ("full", "dots", "blocks", "blocks_dots")


def validate_remat_mode(mode: str) -> str:
    """The one check of ``runtime.remat_mode`` (JAX ``validate_remat_mode``),
    at every SegFormer build and wherever ``remat_plan`` runs."""
    if mode not in REMAT_MODES:
        raise ValueError(
            f"unknown runtime.remat_mode {mode!r}; expected one of "
            + ", ".join(repr(m) for m in REMAT_MODES)
        )
    return mode


def remat_plan(cfg) -> tuple[str, bool]:
    """Where ``runtime.remat`` reruns the trunk's activations, as the JAX
    ``raw_apply`` dispatches: ``('none', False)`` with remat off;
    ``('blocks', save_dots)`` for 'blocks'/'blocks_dots' on SegFormer (each
    encoder block, inside the module); else ``('trunk', save_dots)`` around
    the whole trunk (``segmentors.raw_apply``), where the block modes fall
    back to 'full' on trunks without blocks.  ``save_dots``: keep the Linear
    outputs ('dots', and 'blocks_dots' on SegFormer)."""
    if not cfg.runtime.remat:
        return "none", False
    mode = validate_remat_mode(cfg.runtime.remat_mode)
    if mode in ("blocks", "blocks_dots") and cfg.model.seg_model.type.startswith("SegFormer"):
        return "blocks", mode == "blocks_dots"
    return "trunk", mode == "dots"


def build_seg_model(cfg) -> nn.Module:
    """Instantiate the configured segmentation trunk (registry-dispatched).

    Every trunk takes ``backbone_layers``; SegFormer ignores it, as the JAX
    factory does.  For SegFormer ``runtime.remat_mode`` is validated on
    every build, and the encoder reruns its blocks where ``remat_plan``
    says so ('full' and 'dots' are applied around the whole trunk by
    ``segmentors.raw_apply``);
    ``runtime.fused_attention`` is checked for the JAX package's shape (one
    bool or 4 per-stage flags) and selects nothing: on the card every stage
    runs the SRA kernel."""
    seg = cfg.model.seg_model
    kwargs = {}
    if seg.type.startswith("SegFormer"):
        validate_remat_mode(cfg.runtime.remat_mode)  # with remat off too, as JAX does
        scope, save_dots = remat_plan(cfg)
        kwargs = {"remat_blocks": scope == "blocks", "save_dots": save_dots}
        fused = cfg.runtime.fused_attention
        if isinstance(fused, (list, tuple)) and len(fused) != 4:
            raise ValueError(
                f"runtime.fused_attention as a list needs 4 per-stage flags, got {list(fused)!r}"
            )
    return SEG_MODEL[seg.type](
        num_classes=cfg.dataset.num_classes,
        output_dim=seg.output_dim,
        backbone_layers=tuple(seg.backbone_layers),
        **kwargs,
    )
