"""Segmentors: the segmentation trunk plus its training objective.

The port of ``hiast_tpu/models/segmentors.py`` (reference:
code/sseg/models/segmentors/*.py).  ``raw_apply`` and ``forward`` run with
autograd wherever the caller has it on (a train step); the eval paths wrap
them in ``torch.inference_mode``.  ``SelfTrainingSegmentor.compute_loss``
is the self-training objective with its consistency term against a
teacher target; the directional-consistency loss and the
adversarial-warmup segmentor come with their slices.
"""
from __future__ import annotations

import copy

import torch
from torch import nn

from hiast_tpu_torch.models.deeplab_v2 import build_seg_model
from hiast_tpu_torch.ops import losses as L
from hiast_tpu_torch.ops.resize import bilinear_resize
from hiast_tpu_torch.registry import LOSS, MODEL


class BaseSegmentor:
    """Holds the trunk (``self.module``, an ``nn.Module``) and the cfg."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.module = build_seg_model(cfg)

    def with_module(self, module: nn.Module) -> "BaseSegmentor":
        """This segmentor over another trunk of the same layout (the EMA
        teacher's)."""
        other = copy.copy(self)
        other.module = module
        return other

    def raw_apply(self, img: torch.Tensor, dtype: torch.dtype) -> dict:
        """The trunk's outputs on its own grid, computed under ``dtype``
        autocast (the JAX segmentor's compute dtype; float32 runs the trunk
        as it is).  Master weights stay float32."""
        if self.module.training and torch.is_grad_enabled() and self.cfg.runtime.remat:
            raise NotImplementedError(
                "runtime.remat (activation rematerialisation) is ROADMAP.md item A8: "
                "not ported yet (torch.utils.checkpoint); train with runtime.remat False"
            )
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
    """HIAST loss assembly (reference self_training_segmentor.py:30-53):
    pseudo-label CE + KLD-to-uniform on the confident region + entropy
    sharpening on the ignored region + the consistency loss against a
    teacher target."""

    def __init__(self, cfg):
        if cfg.cst_training.dcst_loss.weight > 0:
            raise NotImplementedError(
                "cst_training.dcst_loss (the directional-consistency loss on copy-pasted "
                "regions) is ROADMAP.md item A10: not ported yet; train with its weight 0"
            )
        super().__init__(cfg)

    def compute_loss(self, t_logits: torch.Tensor, t_plbl: torch.Tensor,
                     t_cst_lbl: torch.Tensor | None = None) -> dict:
        """NCHW logits and [B, H, W] pseudo-labels -> the weighted losses
        under the JAX package's names.  ``t_cst_lbl`` is the teacher's target
        for the consistency loss: hard labels [B, H, W] for 'CE', an NCHW
        probability map for the other types (reference consistency trainer
        :117-119); the loss runs on ``cst_loss.region`` of the pseudo-labels."""
        cfg = self.cfg
        pred = cfg.model.predictor
        losses = {"target_seg_loss": pred.seg_loss.target_pseudo_weight * LOSS[pred.seg_loss.type](t_logits, t_plbl)}
        confident, ignored = L.build_region_weight(t_plbl)
        if pred.kld_loss.weight > 0:
            losses["kld_confident_loss"] = pred.kld_loss.weight * L.kld_to_uniform(t_logits, confident)
        if pred.ent_loss.weight > 0:
            losses["ent_ignored_loss"] = pred.ent_loss.weight * L.entropy_sharpen(t_logits, ignored)
        cst = cfg.cst_training
        if t_cst_lbl is not None and cst.is_enabled and cst.cst_loss.weight > 0:
            losses["cst_loss"] = cst.cst_loss.weight * LOSS[cst.cst_loss.type](
                t_logits, t_cst_lbl, refer_labels=t_plbl, region=cst.cst_loss.region,
            )
        return losses


def build_segmentor(cfg) -> BaseSegmentor:
    return MODEL[cfg.model.type](cfg)
