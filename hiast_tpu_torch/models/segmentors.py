"""Segmentors: the segmentation trunk plus its training objective.

The port of ``hiast_tpu/models/segmentors.py`` (reference:
code/sseg/models/segmentors/*.py).  ``raw_apply`` and ``forward`` run with
autograd wherever the caller has it on (a train step); the eval paths wrap
them in ``torch.inference_mode``.  ``SourceOnlySegmentor.compute_loss`` is
the supervised source loss; ``SelfTrainingSegmentor.compute_loss`` the
self-training objective with its consistency term against a teacher
target, the directional-consistency loss on copy-pasted pixels and the
mutual-learning loss against a peer's target; ``AdversarialWarmupSegmentor``
holds the domain discriminator and the generator's and the discriminator's
losses.
"""
from __future__ import annotations

import copy

import torch
from torch import nn

from hiast_tpu_torch.models.deeplab_v2 import FCDiscriminator, build_seg_model
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

    def compute_loss(self, logits: torch.Tensor, lbl: torch.Tensor) -> dict:
        seg = self.cfg.model.predictor.seg_loss
        return {"seg_loss": seg.source_weight * LOSS[seg.type](logits, lbl)}


@MODEL.register("SelfTrainingSegmentor")
class SelfTrainingSegmentor(BaseSegmentor):
    """HIAST loss assembly (reference self_training_segmentor.py:30-53):
    pseudo-label CE + KLD-to-uniform on the confident region + entropy
    sharpening on the ignored region + the consistency loss against a
    teacher target.  The consistency step adds the directional-consistency
    loss, the mutual step the mutual loss."""

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

    def compute_directional_consistency_loss(self, logits_a: torch.Tensor, logits_b: torch.Tensor,
                                             cp_mask: torch.Tensor, bidirectional: bool = True) -> dict:
        """Pixel-level directional consistency on the copy-pasted pixels
        (``cp_mask != 255``; JAX ``compute_directional_consistency_loss``,
        reference self_training_segmentor.py:85-117): where view a is the
        less confident (max softmax), it takes SoftCE against view b's
        softmax, the target without gradient; with ``bidirectional`` the
        other direction is added (False when b is a teacher).  NCHW logits,
        [B, H, W] mask; an empty region gives exactly 0."""
        prob_a = torch.softmax(logits_a, dim=1)
        prob_b = torch.softmax(logits_b, dim=1)
        conf_a, conf_b = prob_a.amax(1), prob_b.amax(1)
        pasted = cp_mask != 255

        def one_direction(logits_src, prob_tgt, src_worse):
            region = (pasted & src_worse).long()  # 1 in the region, 0 (the ignore index) outside
            return LOSS["SoftCE"](logits_src, prob_tgt.detach(), refer_labels=region, region="confident",
                                  ignore_index=0)

        loss = one_direction(logits_a, prob_b, conf_a < conf_b)
        if bidirectional:
            loss = loss + one_direction(logits_b, prob_a, conf_b < conf_a)
        return {"dcst_loss": self.cfg.cst_training.dcst_loss.weight * loss}

    def compute_mutual_loss(self, t_logits: torch.Tensor, t_plbl: torch.Tensor, t_mut_lbl: torch.Tensor) -> dict:
        """The mutual-learning loss against a peer's target ``t_mut_lbl``
        (hard labels for a 'CE' consistency loss, an NCHW probability map
        otherwise; JAX ``compute_mutual_loss``, the reference's latent
        ``mut_training``, self_training_segmentor.py:55-61): the
        consistency loss's type, on ``mut_training.mut_loss.region`` of
        the pseudo-labels."""
        mut = self.cfg.mut_training
        if not (mut.is_enabled and mut.mut_loss.weight > 0):
            return {}
        return {"mut_loss": mut.mut_loss.weight * LOSS[self.cfg.cst_training.cst_loss.type](
            t_logits, t_mut_lbl, refer_labels=t_plbl, region=mut.mut_loss.region,
        )}


@MODEL.register("AdversarialWarmupSegmentor")
class AdversarialWarmupSegmentor(BaseSegmentor):
    """AdaptSegNet/AdvEnt-style adversarial warmup (JAX
    ``segmentors.AdversarialWarmupSegmentor``, reference
    adversarial_warmup_segmentor.py:12-86): the trunk and a domain
    discriminator (``self.discriminator``, an ``FCDiscriminator`` over the
    class maps; source is 0, target 1).  The discriminator runs under
    ``dtype`` autocast on float32 inputs and returns float32."""

    def __init__(self, cfg):
        if not cfg.model.discriminator.is_enabled:
            raise ValueError("AdversarialWarmupSegmentor needs model.discriminator.is_enabled True")
        super().__init__(cfg)
        self.discriminator = FCDiscriminator(cfg.dataset.num_classes)

    def d_input(self, logits: torch.Tensor) -> torch.Tensor:
        """The softmax of NCHW logits in float32 (AdaptSegNet), or its
        entropy map under ``is_entropy_input`` (AdvEnt)."""
        probs = torch.softmax(logits.float(), dim=1)
        if self.cfg.model.discriminator.is_entropy_input:
            return L.prob_to_entropy(probs)
        return probs

    def d_forward(self, logits: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x = self.d_input(logits)
        with torch.autocast(x.device.type, dtype=dtype, enabled=dtype != torch.float32):
            return self.discriminator(x).float()

    def compute_g_loss(self, s_logits: torch.Tensor, t_logits: torch.Tensor, s_lbl: torch.Tensor,
                       dtype: torch.dtype) -> dict:
        """The generator's losses: the source segmentation loss, the
        adversarial loss (the target's discriminator output against the
        source label 0) and, with ``ent_loss.weight`` > 0, MinEnt on the
        target.  Gradients reach the discriminator's parameters too where
        they require them; the step keeps them out of its update."""
        cfg = self.cfg
        pred, disc = cfg.model.predictor, cfg.model.discriminator
        losses = {"source_seg_loss": pred.seg_loss.source_weight * LOSS[pred.seg_loss.type](s_logits, s_lbl)}
        t_d = self.d_forward(t_logits, dtype)
        losses["adv_loss"] = disc.D_loss.adv_weight * LOSS[disc.D_loss.type](t_d, torch.zeros_like(t_d))
        if pred.ent_loss.weight > 0:  # MinEnt
            losses["target_ent_loss"] = pred.ent_loss.weight * L.mean_entropy(torch.softmax(t_logits.float(), dim=1))
        return losses

    def compute_d_loss(self, s_logits: torch.Tensor, t_logits: torch.Tensor, dtype: torch.dtype) -> dict:
        """The discriminator's loss on the detached logits: source 0,
        target 1, averaged."""
        disc = self.cfg.model.discriminator
        d_loss_fn = LOSS[disc.D_loss.type]
        s_d = self.d_forward(s_logits.detach(), dtype)
        t_d = self.d_forward(t_logits.detach(), dtype)
        d_loss = (d_loss_fn(s_d, torch.zeros_like(s_d)) + d_loss_fn(t_d, torch.ones_like(t_d))) / 2
        return {"D_loss": disc.D_loss.weight * d_loss}


def build_segmentor(cfg) -> BaseSegmentor:
    return MODEL[cfg.model.type](cfg)
