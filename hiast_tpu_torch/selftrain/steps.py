"""Train and eval steps of the port.

The port of ``hiast_tpu/selftrain/steps.py``: ``normalize_image``,
``make_eval_forward``, the plain self-training step and the HIAST
consistency step.  The JAX package compiles one program per step; here a
step is eager PyTorch: the trunk under bf16 autocast (float32 master
weights, no loss scaling), BatchNorm in train mode (batch statistics,
running statistics updated; frozen affine under ``model.is_freeze_bn``),
the losses in float32, backward through the SRA kernels, then the
optimizer update.

A step is ``step(batch, count) -> losses``: ``count`` (``StepCount``) holds
the steps taken and the updates applied, and the step advances both.  The
lr of an update is the schedule at the count of updates applied before it
(optax's ``scale_by_schedule`` count, which lives in the optimizer state).
With ``runtime.skip_nonfinite_updates`` a step whose losses or gradients
hold a non-finite value applies nothing: parameters, optimizer moments and
BatchNorm buffers keep their values from before the step (the buffers from
a snapshot taken before the forward), and only the step count advances, as
in the JAX ``_guard_nonfinite``.  That check reads one flag back to the
host per step; with the option off (the default) a step never waits for
the card.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
from torch import nn

from hiast_tpu_torch.ops.color_aug import apply_color_aug, draw_color_aug
from hiast_tpu_torch.selftrain.train_state import ema_update, set_lr

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


@dataclass
class StepCount:
    """Steps taken (the JAX ``TrainState.step``) and updates applied (the
    optimizer's schedule count); they differ by the skipped steps."""

    iterations: int = 0
    updates: int = 0


def _all_finite(losses: dict, params: list[torch.Tensor]) -> bool:
    """Whether every loss and gradient is finite; one read to the host."""
    grads = [p.grad for p in params if p.grad is not None]
    flags = [torch.isfinite(v).all() for v in losses.values()]
    if grads:  # a max-norm is NaN or inf exactly when a gradient entry is
        flags.append(torch.isfinite(torch.stack(torch._foreach_norm(grads, float("inf")))).all())
    return bool(torch.stack(flags).all())


def _apply_update(optimizer, lr_fn: Callable, count: StepCount, losses: dict, params: list,
                  buffers: list, snapshot: list | None) -> None:
    """The optimizer update at lr ``lr_fn(count.updates)``; under the guard
    (``snapshot`` set) only where ``_all_finite``, else the buffers go back
    to ``snapshot``.  Advances ``count``."""
    if snapshot is None or _all_finite(losses, params):
        set_lr(optimizer, lr_fn(count.updates))
        optimizer.step()
        count.updates += 1
    else:
        torch._foreach_copy_(buffers, snapshot)
    count.iterations += 1


def _trainable(optimizer) -> list:
    return [p for group in optimizer.param_groups for p in group["params"]]


def make_self_training_step(segmentor, optimizer: torch.optim.Optimizer, lr_fn: Callable,
                            dtype: torch.dtype = torch.bfloat16) -> Callable:
    """One plain self-training update (JAX ``make_self_training_step``).

    ``step(batch, count)`` takes ``t_img`` uint8 [B, H, W, 3] and ``t_plbl``
    uint8 [B, H, W] on the device, updates the module and optimizer in place
    and returns the detached losses ``target_seg_loss``,
    ``kld_confident_loss``, ``ent_ignored_loss`` (those whose weight is
    nonzero)."""
    guard = segmentor.cfg.runtime.skip_nonfinite_updates
    module = segmentor.module
    params, buffers = _trainable(optimizer), list(module.buffers())

    def step(batch: dict, count: StepCount) -> dict:
        module.train()
        snapshot = [b.clone() for b in buffers] if guard else None
        img = normalize_image(batch["t_img"])
        out = _forward_for_loss(segmentor, img, dtype)
        plbl = _labels_for_loss(segmentor, batch["t_plbl"].long(), out["logits"])
        losses = segmentor.compute_loss(out["logits"], plbl)
        optimizer.zero_grad(set_to_none=True)
        _total_loss(losses).backward()
        _apply_update(optimizer, lr_fn, count, losses, params, buffers, snapshot)
        return {k: v.detach() for k, v in losses.items()}

    return step


def make_consistency_step(segmentor, ema_module: nn.Module, optimizer: torch.optim.Optimizer, lr_fn: Callable,
                          dtype: torch.dtype = torch.bfloat16, strong_aug: str | None = "CCA",
                          generator: torch.Generator | None = None) -> Callable:
    """One HIAST consistency update (JAX ``make_consistency_step``, reference
    consistency_self_training_trainer.py:62-124).

    ``step(batch, count)`` takes the weak view ``t_img`` uint8 [B, H, W, 3]
    and ``t_plbl`` on the device.  The strong view is made on the card by
    ``strong_aug`` ('CCA' or 'SCA', in bf16, drawn from ``generator``), or,
    with ``strong_aug=None``, taken from ``batch['t_img_strong']`` (the weak
    view when absent).  The EMA teacher (``ema_module``: the EMA parameters,
    the student's BatchNorm buffers from before this step copied in) runs
    the weak view in eval mode without gradients, under the same autocast;
    its target is the argmax for a 'CE' consistency loss and the softmax
    otherwise, at the loss resolution.  The student trains on the strong
    view.  After the update, every ``ema_model.iter_update`` steps taken,
    the EMA parameters move toward the student's (their values before the
    step when the guard skipped it).  Returns the detached losses, the
    student's and ``cst_loss``."""
    cst = segmentor.cfg.cst_training
    gamma = cst.ema_model.gamma
    iter_update = max(1, int(cst.ema_model.iter_update))
    hard_teacher = cst.cst_loss.type == "CE"
    guard = segmentor.cfg.runtime.skip_nonfinite_updates
    if strong_aug is not None and generator is None:
        raise ValueError(f"a {strong_aug!r} strong view needs a torch.Generator on the batch's device")
    module = segmentor.module
    teacher = segmentor.with_module(ema_module)
    params, buffers = _trainable(optimizer), list(module.buffers())
    student_params, ema_params = list(module.parameters()), list(ema_module.parameters())
    ema_buffers = list(ema_module.buffers())

    def step(batch: dict, count: StepCount) -> dict:
        module.train()
        ema_module.eval()
        snapshot = [b.clone() for b in buffers] if guard else None
        weak_raw = batch["t_img"]
        if strong_aug is not None:
            draws = draw_color_aug(weak_raw.shape[0], strong_aug, generator)
            strong_raw = apply_color_aug(weak_raw, draws, torch.bfloat16)
        else:
            strong_raw = batch.get("t_img_strong", weak_raw)
        weak, strong = normalize_image(weak_raw), normalize_image(strong_raw)

        torch._foreach_copy_(ema_buffers, buffers)  # the student's running statistics
        with torch.no_grad():
            t_logits = _forward_for_loss(teacher, weak, dtype)["logits"]
            cst_lbl = t_logits.argmax(1) if hard_teacher else torch.softmax(t_logits, dim=1)
        plbl = _labels_for_loss(segmentor, batch["t_plbl"].long(), t_logits)

        out = _forward_for_loss(segmentor, strong, dtype)
        losses = segmentor.compute_loss(out["logits"], plbl, t_cst_lbl=cst_lbl)
        optimizer.zero_grad(set_to_none=True)
        _total_loss(losses).backward()
        _apply_update(optimizer, lr_fn, count, losses, params, buffers, snapshot)
        if count.iterations % iter_update == 0:
            with torch.no_grad():
                ema_update(ema_params, student_params, gamma)
        return {k: v.detach() for k, v in losses.items()}

    return step
