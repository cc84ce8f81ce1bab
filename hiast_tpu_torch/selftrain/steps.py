"""Train and eval steps of the port.

The port of ``hiast_tpu/selftrain/steps.py``: ``normalize_image``,
``make_eval_forward`` and the plain self-training step.  The JAX package
compiles one program per step; here a step is eager PyTorch: the trunk
under bf16 autocast (float32 master weights, no loss scaling), BatchNorm in
train mode (batch statistics, running statistics updated; frozen affine
under ``model.is_freeze_bn``), the losses in float32, backward through the
SRA kernels, then the optimizer update.  The consistency step comes with
its slice.
"""
from __future__ import annotations

from typing import Callable

import torch

from hiast_tpu_torch.selftrain.train_state import set_lr

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_image(img_uint8: torch.Tensor) -> torch.Tensor:
    """uint8/float [0,255] RGB [B, H, W, 3] -> ImageNet-normalized float32
    NCHW [B, 3, H, W] (reference code/sseg/datasets/utils.py:37-55)."""
    x = img_uint8.float() / 255.0
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
    return ((x - mean) / std).permute(0, 3, 1, 2).contiguous()


def make_eval_forward(segmentor, dtype: torch.dtype = torch.bfloat16) -> Callable:
    """Normalized eval forward: uint8 [B, H, W, 3] -> full-res fp32 NCHW
    logits (``hiast_tpu/selftrain/steps.py:make_eval_forward``), the trunk
    at compute dtype ``dtype``."""

    @torch.inference_mode()
    def fwd(img_uint8: torch.Tensor) -> torch.Tensor:
        return segmentor.forward(normalize_image(img_uint8), dtype)["logits"]

    return fwd


def _total_loss(losses: dict) -> torch.Tensor:
    """Sum of all non-discriminator losses (reference base_trainer.py:128)."""
    return sum(v for k, v in losses.items() if "D_" not in k)


def _loss_grid(segmentor) -> str:
    res = segmentor.cfg.train.loss_resolution
    if res not in ("full", "os8"):
        raise ValueError(f"train.loss_resolution must be 'full' or 'os8', got {res!r}")
    return res


def _forward_for_loss(segmentor, img: torch.Tensor, dtype: torch.dtype) -> dict:
    """Logits at the configured loss resolution: full-res ('full') or the
    trunk's own grid ('os8'), float32 either way."""
    if _loss_grid(segmentor) == "full":
        return segmentor.forward(img, dtype)
    out = segmentor.raw_apply(img, dtype)
    return {"logits": out["logits"].float(), "backbone": out["backbone"]}


def _labels_for_loss(segmentor, lbl: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """Labels [B, H, W] on the loss grid: nearest-downsampled to the logits'
    grid under 'os8' (torch's 'nearest' convention, as the JAX resize)."""
    if _loss_grid(segmentor) == "full" or tuple(lbl.shape[-2:]) == tuple(logits.shape[-2:]):
        return lbl
    h, w = lbl.shape[-2:]
    oh, ow = logits.shape[-2:]
    rows = torch.clamp(torch.floor(torch.arange(oh, dtype=torch.float64) * (h / oh)), max=h - 1).long()
    cols = torch.clamp(torch.floor(torch.arange(ow, dtype=torch.float64) * (w / ow)), max=w - 1).long()
    return lbl[..., rows.to(lbl.device), :][..., cols.to(lbl.device)]


def make_self_training_step(segmentor, optimizer: torch.optim.Optimizer, lr_fn: Callable,
                            dtype: torch.dtype = torch.bfloat16) -> Callable:
    """One plain self-training update (JAX ``make_self_training_step``).

    ``step(batch, t)`` takes ``t_img`` uint8 [B, H, W, 3] and ``t_plbl``
    uint8 [B, H, W] on the device and the count t of updates done so far,
    updates the module and optimizer in place at lr ``lr_fn(t)`` and returns
    the detached losses ``target_seg_loss``, ``kld_confident_loss``,
    ``ent_ignored_loss`` (those whose weight is nonzero)."""
    cfg = segmentor.cfg
    if cfg.runtime.skip_nonfinite_updates:
        raise NotImplementedError(
            "runtime.skip_nonfinite_updates is not ported yet: train with it False"
        )
    module = segmentor.module

    def step(batch: dict, t: int) -> dict:
        module.train()
        img = normalize_image(batch["t_img"])
        out = _forward_for_loss(segmentor, img, dtype)
        plbl = _labels_for_loss(segmentor, batch["t_plbl"].long(), out["logits"])
        losses = segmentor.compute_loss(out["logits"], plbl)
        optimizer.zero_grad(set_to_none=True)
        _total_loss(losses).backward()
        set_lr(optimizer, lr_fn(t))
        optimizer.step()
        return {k: v.detach() for k, v in losses.items()}

    return step
