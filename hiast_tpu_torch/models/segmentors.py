"""Segmentors: the segmentation trunk plus its training objective.

The port of ``hiast_tpu/models/segmentors.py`` (reference:
code/sseg/models/segmentors/*.py).  This slice needs only the forward; the
segmentors' ``compute_loss`` comes with the training slice, and the
adversarial-warmup segmentor with the warmup slice.
"""
from __future__ import annotations

import torch

from hiast_tpu_torch.models.deeplab_v2 import build_seg_model
from hiast_tpu_torch.ops.resize import bilinear_resize
from hiast_tpu_torch.registry import MODEL


class BaseSegmentor:
    """Holds the trunk (``self.module``, an ``nn.Module``) and the cfg."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.module = build_seg_model(cfg)

    def raw_apply(self, img: torch.Tensor, dtype: torch.dtype) -> dict:
        """The trunk's outputs on its own grid, computed under ``dtype``
        autocast (the JAX segmentor's compute dtype; float32 runs the trunk
        as it is)."""
        with torch.autocast(img.device.type, dtype=dtype, enabled=dtype != torch.float32):
            return self.module(img)

    def forward(self, img: torch.Tensor, dtype: torch.dtype = torch.float32) -> dict:
        """NCHW image -> {'logits': full-res fp32 [B, C, H, W], 'backbone'}.

        The logits are cast to fp32 before the align_corners=True bilinear
        upsampling (reference self_training_segmentor.py:27)."""
        out = self.raw_apply(img, dtype)
        logits = bilinear_resize(out["logits"].float(), img.shape[2], img.shape[3])
        return {"logits": logits, "backbone": out["backbone"]}


@MODEL.register("SourceOnlySegmentor")
class SourceOnlySegmentor(BaseSegmentor):
    """Supervised training on source only (reference source_only_segmentor.py)."""


@MODEL.register("SelfTrainingSegmentor")
class SelfTrainingSegmentor(BaseSegmentor):
    """HIAST self-training segmentor (reference self_training_segmentor.py)."""


def build_segmentor(cfg) -> BaseSegmentor:
    return MODEL[cfg.model.type](cfg)
