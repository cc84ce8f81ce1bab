"""Train and eval steps of the port.

The port of ``hiast_tpu/selftrain/steps.py``: ``normalize_image``,
``make_eval_forward``, the source-only and adversarial warmup steps, the
plain self-training step, the HIAST consistency step and the
mutual-learning step.  The JAX package compiles one program per step; here a
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

Under a process group (``parallel/mesh.py``) a step is the step of the
global batch, of which this rank holds its contiguous share: the losses
take the global batch's denominators (``ops/losses.py:over_ranks``),
BatchNorm its statistics (``models/norm.py``), and after the backward one
all-reduce sums the trainable gradients and the losses over the ranks, so
the optimizer, the guard and the reported losses see the global values and
every rank steps, or skips, alike.  The strong view's draws are made for
the global batch from the same-seeded generator, and each data index takes
its samples.  On image rows sharded over the ``space`` axis
(``parallel/spatial.py``) a batch holds this rank's slab of its samples'
rows, and the same sums complete the step: each rank's gradient is its
rows' share, the halos' backward included.  At world size 1 every sum is
the identity.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable

import torch
from torch import nn

from hiast_tpu_torch.ops import losses as L
from hiast_tpu_torch.ops.color_aug import apply_color_aug, draw_color_aug
from hiast_tpu_torch.parallel import mesh
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
    grid under 'os8' (torch's 'nearest' convention, as the JAX resize).  On
    a row slab the ratio is the trunk's stride and each slab starts on a
    multiple of it, so the slab's own rows are the ones it reads."""
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


def _global_losses():
    """The context in which a step's losses take the global batch's
    denominators; none without a process group."""
    if not mesh.initialized():
        return contextlib.nullcontext()
    return L.over_ranks(mesh.summed, mesh.world_size())


def _sum_over_ranks(losses: dict, params: list[torch.Tensor]) -> dict:
    """Sum the gradients of ``params`` over the ranks, in place, and
    return the detached losses summed likewise: one collective, after the
    backward and before the guard and the update."""
    if not mesh.initialized():
        return {k: v.detach() for k, v in losses.items()}
    reported = {k: v.detach().clone() for k, v in losses.items()}
    mesh.all_reduce_sum([p.grad for p in params if p.grad is not None] + list(reported.values()))
    return reported


def _strong_draws(local_b: int, kind: str, generator: torch.Generator):
    """This data index's samples of the colour-aug draws of the global batch."""
    global_b = local_b * mesh.data_size()
    return draw_color_aug(global_b, kind, generator).rows(mesh.local_share(global_b))


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


def make_source_only_step(segmentor, optimizer: torch.optim.Optimizer, lr_fn: Callable,
                          dtype: torch.dtype = torch.bfloat16) -> Callable:
    """One supervised source update (JAX ``make_source_only_step``):
    ``step(batch, count)`` takes ``s_img`` uint8 [B, H, W, 3] and ``s_lbl``
    uint8 [B, H, W] on the device and returns the detached ``seg_loss``,
    computed on the full-resolution logits."""
    guard = segmentor.cfg.runtime.skip_nonfinite_updates
    module = segmentor.module
    params, buffers = _trainable(optimizer), list(module.buffers())

    def step(batch: dict, count: StepCount) -> dict:
        module.train()
        snapshot = [b.clone() for b in buffers] if guard else None
        out = segmentor.forward(normalize_image(batch["s_img"]), dtype)
        with _global_losses():
            losses = segmentor.compute_loss(out["logits"], batch["s_lbl"].long())
        optimizer.zero_grad(set_to_none=True)
        _total_loss(losses).backward()
        losses = _sum_over_ranks(losses, params)
        _apply_update(optimizer, lr_fn, count, losses, params, buffers, snapshot)
        return losses

    return step


def make_adversarial_step(segmentor, optimizer: torch.optim.Optimizer, lr_fn: Callable,
                          d_optimizer: torch.optim.Optimizer, d_lr_fn: Callable,
                          dtype: torch.dtype = torch.bfloat16) -> Callable:
    """One adversarial warmup update (JAX ``make_adversarial_step``,
    reference adversarial_warmup_trainer.py).

    ``step(batch, count)`` takes ``s_img``, ``s_lbl`` and ``t_img`` (uint8,
    on the device).  The trunk runs the source, then the target, in train
    mode (BatchNorm's running statistics update twice, in that order).
    The generator's losses see the discriminator as it was before the step
    with its parameters frozen, so the generator's backward writes no
    gradient into them; the discriminator's loss then runs on the detached
    logits of the same two forwards.  Then the generator's update, then the
    discriminator's, each at its schedule's lr for ``count.updates``.
    Under ``runtime.skip_nonfinite_updates`` one check covers every loss and
    both models' gradients, and a skipped step leaves both models, both
    optimizers and the BatchNorm buffers as they were.  Returns the
    detached ``source_seg_loss``, ``adv_loss``, ``target_ent_loss`` (when
    its weight is nonzero) and ``D_loss``."""
    guard = segmentor.cfg.runtime.skip_nonfinite_updates
    module, discriminator = segmentor.module, segmentor.discriminator
    params, buffers = _trainable(optimizer), list(module.buffers())
    d_params = _trainable(d_optimizer)

    def step(batch: dict, count: StepCount) -> dict:
        module.train()
        snapshot = [b.clone() for b in buffers] if guard else None
        s_logits = segmentor.forward(normalize_image(batch["s_img"]), dtype)["logits"]
        t_logits = segmentor.forward(normalize_image(batch["t_img"]), dtype)["logits"]
        discriminator.requires_grad_(False)
        try:
            with _global_losses():
                losses = segmentor.compute_g_loss(s_logits, t_logits, batch["s_lbl"].long(), dtype)
        finally:
            discriminator.requires_grad_(True)
        optimizer.zero_grad(set_to_none=True)
        _total_loss(losses).backward()
        with _global_losses():
            d_losses = segmentor.compute_d_loss(s_logits, t_logits, dtype)
        d_optimizer.zero_grad(set_to_none=True)
        d_losses["D_loss"].backward()
        losses.update(d_losses)
        losses = _sum_over_ranks(losses, params + d_params)
        if snapshot is None or _all_finite(losses, params + d_params):
            set_lr(optimizer, lr_fn(count.updates))
            optimizer.step()
            set_lr(d_optimizer, d_lr_fn(count.updates))
            d_optimizer.step()
            count.updates += 1
        else:
            torch._foreach_copy_(buffers, snapshot)
        count.iterations += 1
        return losses

    return step


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
        with _global_losses():
            losses = segmentor.compute_loss(out["logits"], plbl)
        optimizer.zero_grad(set_to_none=True)
        _total_loss(losses).backward()
        losses = _sum_over_ranks(losses, params)
        _apply_update(optimizer, lr_fn, count, losses, params, buffers, snapshot)
        return losses

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
    view.  With ``cst_training.dcst_loss.weight`` > 0 and a
    ``copy_paste_mask`` in the batch (on the crop's grid), the mask goes to
    the loss grid as the pseudo-labels do and the directional-consistency
    loss of the student's logits against the teacher's joins the
    differentiated sum.  After the update, every ``ema_model.iter_update``
    steps taken, the EMA parameters move toward the student's (their values
    before the step when the guard skipped it).  Returns the detached
    losses, the student's, ``cst_loss`` and ``dcst_loss``."""
    cst = segmentor.cfg.cst_training
    gamma = cst.ema_model.gamma
    iter_update = max(1, int(cst.ema_model.iter_update))
    hard_teacher = cst.cst_loss.type == "CE"
    dcst = cst.dcst_loss.weight > 0
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
            strong_raw = apply_color_aug(weak_raw, _strong_draws(weak_raw.shape[0], strong_aug, generator),
                                         torch.bfloat16)
        else:
            strong_raw = batch.get("t_img_strong", weak_raw)
        weak, strong = normalize_image(weak_raw), normalize_image(strong_raw)

        torch._foreach_copy_(ema_buffers, buffers)  # the student's running statistics
        with torch.no_grad():
            t_logits = _forward_for_loss(teacher, weak, dtype)["logits"]
            cst_lbl = t_logits.argmax(1) if hard_teacher else torch.softmax(t_logits, dim=1)
        plbl = _labels_for_loss(segmentor, batch["t_plbl"].long(), t_logits)

        out = _forward_for_loss(segmentor, strong, dtype)
        with _global_losses():
            losses = segmentor.compute_loss(out["logits"], plbl, t_cst_lbl=cst_lbl)
            if dcst and "copy_paste_mask" in batch:
                cp_mask = _labels_for_loss(segmentor, batch["copy_paste_mask"].long(), t_logits)
                losses.update(segmentor.compute_directional_consistency_loss(
                    out["logits"], t_logits, cp_mask, bidirectional=False))
        optimizer.zero_grad(set_to_none=True)
        _total_loss(losses).backward()
        losses = _sum_over_ranks(losses, params)
        _apply_update(optimizer, lr_fn, count, losses, params, buffers, snapshot)
        if count.iterations % iter_update == 0:
            with torch.no_grad():
                ema_update(ema_params, student_params, gamma)
        return losses

    return step


def make_mutual_step(segmentor, peer_module: nn.Module, optimizer: torch.optim.Optimizer,
                     peer_optimizer: torch.optim.Optimizer, lr_fn: Callable,
                     dtype: torch.dtype = torch.bfloat16, strong_aug: str | None = None,
                     generator: torch.Generator | None = None) -> Callable:
    """One mutual-learning update (JAX ``make_mutual_step``; the reference's
    latent ``mut_training``): two students, ``segmentor.module`` (A) and
    ``peer_module`` (B), train on the same pseudo-labelled batch, each also
    matching the other's target.

    ``step(batch, count)`` takes ``t_img`` and ``t_plbl`` on the device.
    First both targets, from the weak view in eval mode without gradients
    (each student's BatchNorm buffers as they stood before the step): the
    argmax for a 'CE' consistency loss, the softmax otherwise, at the loss
    resolution.  With ``mut_training.is_strong_input`` and a ``strong_aug``
    ('CCA' or 'SCA'), each student trains on its own strong view, drawn from
    ``generator``, A's first; otherwise both train on the weak view.  Each
    student's loss is ``compute_loss`` plus ``compute_mutual_loss`` against
    the other's target; one backward runs on the sum, then both optimizers
    step at the one lr ``lr_fn(count.updates)``.  Under
    ``runtime.skip_nonfinite_updates`` one check covers both students'
    losses and gradients, and a skipped step updates neither and restores
    both students' buffers.  Returns the detached losses, B's under the
    prefix ``peer_``."""
    cfg = segmentor.cfg
    strong_input = cfg.mut_training.is_strong_input and strong_aug is not None
    hard_target = cfg.cst_training.cst_loss.type == "CE"  # the mutual loss is the consistency loss's type
    guard = cfg.runtime.skip_nonfinite_updates
    if strong_input and generator is None:
        raise ValueError(f"a {strong_aug!r} strong view needs a torch.Generator on the batch's device")
    peer = segmentor.with_module(peer_module)
    students = (segmentor, peer)
    params = _trainable(optimizer) + _trainable(peer_optimizer)
    buffers = list(segmentor.module.buffers()) + list(peer_module.buffers())

    def target(student, weak: torch.Tensor) -> torch.Tensor:
        student.module.eval()
        with torch.no_grad():
            logits = _forward_for_loss(student, weak, dtype)["logits"]
        return logits.argmax(1) if hard_target else torch.softmax(logits, dim=1)

    def step(batch: dict, count: StepCount) -> dict:
        snapshot = [b.clone() for b in buffers] if guard else None
        weak_raw = batch["t_img"]
        weak = normalize_image(weak_raw)
        targets = [target(student, weak) for student in students]
        if strong_input:
            inputs = [normalize_image(apply_color_aug(
                weak_raw, _strong_draws(weak_raw.shape[0], strong_aug, generator), torch.bfloat16))
                for _ in students]
        else:
            inputs = [weak, weak]
        plbl = _labels_for_loss(segmentor, batch["t_plbl"].long(), targets[0])

        losses, total = {}, 0.0
        for prefix, student, img, peer_target in zip(("", "peer_"), students, inputs, targets[::-1]):
            student.module.train()
            logits = _forward_for_loss(student, img, dtype)["logits"]
            with _global_losses():
                own = student.compute_loss(logits, plbl)
                own.update(student.compute_mutual_loss(logits, plbl, peer_target))
            total = total + _total_loss(own)
            losses.update({prefix + k: v for k, v in own.items()})
        optimizer.zero_grad(set_to_none=True)
        peer_optimizer.zero_grad(set_to_none=True)
        total.backward()
        losses = _sum_over_ranks(losses, params)
        if snapshot is None or _all_finite(losses, params):
            lr = lr_fn(count.updates)
            for opt in (optimizer, peer_optimizer):
                set_lr(opt, lr)
                opt.step()
            count.updates += 1
        else:
            torch._foreach_copy_(buffers, snapshot)
        count.iterations += 1
        return losses

    return step
