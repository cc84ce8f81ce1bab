"""Segmentation losses of the self-training path.

The port of ``hiast_tpu/ops/losses.py`` (reference:
code/sseg/models/modules/losses.py:9-89 and the region regularisers of
code/sseg/models/segmentors/self_training_segmentor.py:128-163): the
registered losses CE, SoftCE, KLDIV, MSE and BCEWithLogits, the
region regularisers KLD-to-uniform and entropy, and the adversarial
warmup's entropy map and MinEnt loss.

Logits are NCHW [B, C, H, W], the port's layout (the JAX functions take
NHWC); labels and region masks are [B, H, W].  Region protocol: a loss can
be restricted by ``refer_labels`` to the 'confident' region (refer !=
ignore), the 'ignored' region or 'all', and is then normalised by the number
of NONZERO entries, the reference's ``loss.sum() / (loss != 0).sum()``.
Reductions run in float32 whatever the logits' dtype.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from hiast_tpu_torch.registry import LOSS

IGNORE_INDEX = 255


def region_mask(refer_labels: torch.Tensor, region: str, ignore_index: int = IGNORE_INDEX) -> torch.Tensor:
    """Boolean [B, H, W] mask selecting the requested region."""
    if region == "ignored":
        return refer_labels == ignore_index
    if region == "confident":
        return refer_labels != ignore_index
    if region == "all":
        return torch.ones_like(refer_labels, dtype=torch.bool)
    raise ValueError(f"{region!r} is not a valid region")


def _masked_nonzero_mean(loss: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """sum(loss * mask) / count(loss * mask != 0), guarding empty regions.
    ``loss`` is [B, H, W] or [B, C, H, W]; ``mask`` is [B, H, W] bool."""
    if loss.dim() == 4:
        mask = mask[:, None]
    masked = loss * mask.to(loss.dtype)
    count = (masked != 0).sum().clamp(min=1).to(loss.dtype)
    return masked.sum() / count


def build_region_weight(plbl: torch.Tensor, ignore_index: int = IGNORE_INDEX):
    """(confident, ignored) float [B, H, W] masks from a pseudo-label map
    (reference self_training_segmentor.py:128-137, kept per pixel)."""
    confident = (plbl != ignore_index).float()
    return confident, 1.0 - confident


def _log_softmax(logits: torch.Tensor) -> torch.Tensor:
    return F.log_softmax(logits.float(), dim=1)


@LOSS.register("CE")
def cross_entropy(
    logits: torch.Tensor,
    labels: torch.Tensor,
    weights=None,
    ignore_index: int = IGNORE_INDEX,
    refer_labels: torch.Tensor | None = None,
    region: str = "confident",
) -> torch.Tensor:
    """Hard-label CE; mean over valid pixels, or region-masked nonzero-mean.
    The label's log-probability is gathered (the JAX one-hot contraction was
    a TPU workaround for slow gathers; the sum it forms is the same)."""
    logp = _log_softmax(logits)
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    nll = -logp.gather(1, safe[:, None]).squeeze(1)
    if weights is not None:
        w = torch.as_tensor(weights, dtype=nll.dtype, device=nll.device)[safe]
        nll = nll * w
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    if refer_labels is None:
        if weights is None:
            denom = valid.sum().clamp(min=1).to(nll.dtype)
        else:
            denom = torch.where(valid, w, torch.zeros_like(w)).sum().clamp(min=1e-12)
        return nll.sum() / denom
    return _masked_nonzero_mean(nll, region_mask(refer_labels, region, ignore_index))


@LOSS.register("SoftCE")
def soft_cross_entropy(
    logits: torch.Tensor,
    target_probs: torch.Tensor,
    weights=None,
    ignore_index: int = IGNORE_INDEX,
    refer_labels: torch.Tensor | None = None,
    region: str = "confident",
) -> torch.Tensor:
    """Soft-label CE, -sum(target * log_softmax(logits)), per class and
    pixel; ``target_probs`` is an NCHW probability map (the EMA teacher's
    softmax).  Mean over every entry, or the region's nonzero-mean
    (reference losses.py:39-66)."""
    nll = -_log_softmax(logits)
    t = target_probs.to(nll.dtype)
    if weights is not None:
        t = t * torch.as_tensor(weights, dtype=nll.dtype, device=nll.device).view(1, -1, 1, 1)
    per_elem = nll * t
    if refer_labels is None:
        return per_elem.sum() / per_elem.numel()
    return _masked_nonzero_mean(per_elem, region_mask(refer_labels, region, ignore_index))


@LOSS.register("KLDIV")
def kl_divergence(
    input_logits: torch.Tensor,
    target_logits: torch.Tensor,
    weights=None,
    ignore_index: int = IGNORE_INDEX,
    refer_labels: torch.Tensor | None = None,
    region: str = "confident",
) -> torch.Tensor:
    """KL(softmax(target) || softmax(input)) per entry, torch KLDivLoss's
    'mean' over every entry, or the region's nonzero-mean (reference
    losses.py:16-23)."""
    logp = _log_softmax(input_logits)
    q = F.softmax(target_logits.float(), dim=1)
    per_elem = q * (torch.log(q.clamp(min=1e-30)) - logp)
    if refer_labels is None:
        return per_elem.mean()
    return _masked_nonzero_mean(per_elem, region_mask(refer_labels, region, ignore_index))


@LOSS.register("MSE")
def mse(
    logits: torch.Tensor,
    labels: torch.Tensor,
    weights=None,
    ignore_index: int = IGNORE_INDEX,
    refer_labels: torch.Tensor | None = None,
    region: str = "all",
) -> torch.Tensor:
    per_elem = (logits.float() - labels.float()) ** 2
    if refer_labels is None:
        return per_elem.mean()
    return _masked_nonzero_mean(per_elem, region_mask(refer_labels, region, ignore_index))


@LOSS.register("BCEWithLogits")
def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor, **_) -> torch.Tensor:
    """Binary CE on logits in the stable form max(x, 0) - x y + log1p(exp(-|x|))."""
    x, y = logits.float(), labels.float()
    return (torch.clamp(x, min=0) - x * y + torch.log1p(torch.exp(-x.abs()))).mean()


def kld_to_uniform(logits: torch.Tensor, pixel_weight: torch.Tensor) -> torch.Tensor:
    """KLD-to-uniform smoothing on the confident region, with the reference's
    normalisation (self_training_segmentor.py:153-163): its weight is
    broadcast to [B, C, H, W], so ``val_num`` counts #valid-pixels x C and
    the loss is -1/C * sum(w * log_softmax) / (#pixels * C)."""
    num_classes = logits.shape[1]
    logp = _log_softmax(logits)
    val_num = (pixel_weight > 0).sum().clamp(min=1).float() * num_classes
    return -(pixel_weight[:, None] * logp).sum() / (num_classes * val_num)


def entropy_sharpen(logits: torch.Tensor, pixel_weight: torch.Tensor) -> torch.Tensor:
    """Entropy regulariser on the ignored region, same normalisation:
    -sum(softmax * w * log_softmax) / (#pixels * C)."""
    num_classes = logits.shape[1]
    logp = _log_softmax(logits)
    val_num = (pixel_weight > 0).sum().clamp(min=1).float() * num_classes
    return -(logp.exp() * pixel_weight[:, None] * logp).sum() / val_num


def prob_to_entropy(prob: torch.Tensor) -> torch.Tensor:
    """Per-class weighted self-information map of NCHW probabilities, the
    AdvEnt discriminator input (reference adversarial_warmup_segmentor.py:71-86):
    -p log2(p) / log2(C), in float32."""
    c = prob.shape[1]
    p = prob.float()
    return -(p * torch.log2(p + 1e-30)) / math.log2(c)


def mean_entropy(prob: torch.Tensor) -> torch.Tensor:
    """MinEnt loss: the mean per-pixel entropy of NCHW probabilities,
    log2-normalised by the number of classes."""
    b, c, h, w = prob.shape
    p = prob.float()
    return -(p * torch.log2(p + 1e-30)).sum() / (b * h * w * math.log2(c))
