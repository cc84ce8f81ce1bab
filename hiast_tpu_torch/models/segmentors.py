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

    def forward(self, img: torch.Tensor) -> dict:
        """NCHW image -> {'logits': full-res fp32 [B, C, H, W], 'backbone'}.

        The logits are cast to fp32 before the align_corners=True bilinear
        upsampling (reference self_training_segmentor.py:27)."""
        out = self.module(img)
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
