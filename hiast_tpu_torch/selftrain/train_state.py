"""Optimizer and learning-rate schedule of the trainers.

The port of ``hiast_tpu/selftrain/train_state.py`` (reference:
code/utils/utils.py:135-163, code/sseg/models/modules/schedulers.py:7-14) on
``torch.optim``, with the same update rule as the JAX package's optax chain:

- parameter groups: the backbone at the base lr, everything else at 10x
  (the ``lr_mult`` of each group); frozen leaves take no update at all and
  are left out of the optimizer with ``requires_grad`` off.  Frozen means
  the BatchNorm affine parameters under ``model.is_freeze_bn`` (matched by
  module type; the JAX package matches its ``bn*`` / ``*_bn`` names, which
  are exactly its BatchNorms) and DeepLab's vestigial ``representation``;
- 'Adam' couples weight decay into the gradient, 'AdamW' decouples it
  (torch's AdamW is optax's adam -> add_decayed_weights -> scale(-lr)),
  'SGD' is momentum 0.9 with coupled decay;
- the lr of step t (0-based, counted before the update, as
  ``optax.scale_by_schedule`` evaluates it) is ``lr_schedule(cfg)(t)``
  times the group's multiplier, set by ``set_lr`` before each update.

bf16 autocast needs no loss scaling, so there is no GradScaler.  The EMA
teacher's update is ``ema_update``.
"""
from __future__ import annotations

import math
from typing import Callable

import torch
from torch import nn

HEAD_LR_MULT = 10.0


def lr_schedule(cfg) -> Callable[[int], float]:
    """step -> absolute lr of the backbone group."""
    base = cfg.train.lr
    total = cfg.train.total_iter
    kind = cfg.train.lr_scheduler.type
    if kind == "Cosine":
        eta_min = base * 1e-3
        return lambda t: eta_min + (base - eta_min) * 0.5 * (1 + math.cos(math.pi * t / total))
    if kind == "Poly":
        power = cfg.train.lr_scheduler.poly.power
        return lambda t: base * (1.0 - t / total) ** power
    raise ValueError(f"{kind!r} is not a valid scheduler")


def param_labels(module: nn.Module, freeze_bn: bool) -> dict[str, str]:
    """Parameter name -> 'backbone' | 'head' | 'frozen' (JAX ``_param_labels``)."""
    frozen = set()
    for mod_name, mod in module.named_modules():
        if freeze_bn and isinstance(mod, nn.modules.batchnorm._BatchNorm):
            frozen.update(f"{mod_name}.{p}" for p, _ in mod.named_parameters(recurse=False))
        if mod_name == "representation":
            frozen.update(f"{mod_name}.{p}" for p, _ in mod.named_parameters())
    labels = {}
    for name, _ in module.named_parameters():
        if name in frozen:
            labels[name] = "frozen"
        elif name.startswith("backbone."):
            labels[name] = "backbone"
        else:
            labels[name] = "head"
    return labels


def make_optimizer(cfg, module: nn.Module) -> torch.optim.Optimizer:
    """The segmentation model's optimizer over ``module``'s parameters; sets
    ``requires_grad`` off on the frozen ones."""
    labels = param_labels(module, cfg.model.is_freeze_bn)
    groups = {"backbone": [], "head": []}
    for name, p in module.named_parameters():
        if labels[name] == "frozen":
            p.requires_grad_(False)
        else:
            groups[labels[name]].append(p)
    base = cfg.train.lr
    param_groups = [
        {"params": groups["backbone"], "lr": base, "lr_mult": 1.0},
        {"params": groups["head"], "lr": base * HEAD_LR_MULT, "lr_mult": HEAD_LR_MULT},
    ]
    param_groups = [g for g in param_groups if g["params"]]
    wd = cfg.train.weight_decay
    kind = cfg.train.optimizer
    if kind == "Adam":
        return torch.optim.Adam(param_groups, betas=(0.9, 0.999), eps=1e-8, weight_decay=wd)
    if kind == "AdamW":
        return torch.optim.AdamW(param_groups, betas=(0.9, 0.999), eps=1e-8, weight_decay=wd)
    if kind == "SGD":
        return torch.optim.SGD(param_groups, momentum=0.9, weight_decay=wd)
    raise ValueError(f"{kind!r} is not a valid optimizer")


@torch.no_grad()
def ema_update(ema_params: list[torch.Tensor], params: list[torch.Tensor], gamma: float) -> None:
    """Move every EMA parameter toward its student parameter in place,
    ema <- gamma * ema + (1 - gamma) * p (reference code/utils/utils.py:115-123;
    JAX ``train_state.ema_update``), one multi-tensor lerp.  Parameters
    only: the teacher's buffers are the student's, copied in before use."""
    torch._foreach_lerp_(ema_params, params, 1.0 - gamma)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Each group's lr for the next update: ``lr`` times its multiplier."""
    for group in optimizer.param_groups:
        group["lr"] = lr * group["lr_mult"]
