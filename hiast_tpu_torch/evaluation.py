"""Evaluation: multi-scale / flip probability fusion and IoU, on the device.

The port of ``hiast_tpu/evaluation.py`` (reference:
code/workflows/validator.py:34-115, code/workflows/trainer/base_trainer.py:
160-186): per batch, resize (align_corners=True) -> forward under bf16
autocast -> upsample the logits -> softmax [-> + the flipped pass] -> resize
to the label size -> sum over scales -> argmax -> per-class intersection and
union.  The host only adds up two [C] vectors per batch.  Under a process
group (``parallel/mesh.py``) each rank validates its contiguous share of
every global batch (``BatchIterator``'s ``share``), the IoU areas are
summed over the ranks, and every rank returns the same IoU; the rank that
holds a sample writes its colour mask.
"""
from __future__ import annotations

import os
import time
from typing import Callable, Iterable

import numpy as np
import torch

from hiast_tpu_torch.data.pipeline import pad_batch
from hiast_tpu_torch.data.png import encode_png
from hiast_tpu_torch.ops.metrics import intersection_and_union, iou_from_areas, synthia_mious
from hiast_tpu_torch.ops.resize import bilinear_resize
from hiast_tpu_torch.parallel import mesh
from hiast_tpu_torch.selftrain.steps import normalize_image

# Class palettes for colorized prediction export (reference validator.py:57-70)
PALETTE_19 = [
    128, 64, 128, 244, 35, 232, 70, 70, 70, 102, 102, 156, 190, 153, 153,
    153, 153, 153, 250, 170, 30, 220, 220, 0, 107, 142, 35, 152, 251, 152,
    70, 130, 180, 220, 20, 60, 255, 0, 0, 0, 0, 142, 0, 0, 70, 0, 60, 100,
    0, 80, 100, 0, 0, 230, 119, 11, 32,
]
PALETTE_9 = [
    70, 130, 180, 220, 20, 60, 119, 11, 32, 0, 0, 142, 220, 220, 0,
    250, 170, 30, 70, 70, 70, 244, 35, 232, 128, 64, 128,
]


def colorize_mask(mask: np.ndarray, num_classes: int) -> bytes:
    """A predicted [H, W] class map -> the PNG bytes of the palette image
    that the JAX package writes with PIL (``Image.putpalette`` of the 19 or
    9 class colours, then ``save``): the class colours as PLTE, 8-bit
    indices for 19 classes, 4-bit for 9 (indices keep their low bits)."""
    palette = {19: PALETTE_19, 9: PALETTE_9}[num_classes]
    return encode_png(mask.astype(np.uint8), palette=np.asarray(palette, np.uint8))


def make_val_step(segmentor, resize_size, num_classes: int, dtype: torch.dtype = torch.bfloat16) -> Callable:
    """Training-loop validation step: single-scale logits -> (inter, union).

    Matches base_trainer.get_validate_result: resize the input to
    ``resize_size``, forward, resize the logits to the label size, argmax."""
    rh, rw = resize_size

    @torch.inference_mode()
    def step(img_uint8: torch.Tensor, lbl: torch.Tensor):
        img = bilinear_resize(normalize_image(img_uint8), rh, rw)
        logits = bilinear_resize(segmentor.raw_apply(img, dtype)["logits"].float(), lbl.shape[1], lbl.shape[2])
        return intersection_and_union(logits.argmax(1), lbl, num_classes)

    return step


def make_ms_flip_step(
    segmentor, resize_sizes, is_flip: bool, num_classes: int, dtype: torch.dtype = torch.bfloat16
) -> Callable:
    """Standalone validator step: multi-scale + flip softmax fusion, in the
    JAX step's order.  Returns (pred [B, H, W], inter [C], union [C])."""
    if not resize_sizes:
        raise ValueError(
            "make_ms_flip_step needs at least one eval size; set "
            "validate.resize_sizes (multi-scale) or dataset.val.resize_size"
        )
    for rh, rw in resize_sizes:
        if rh > rw:
            raise ValueError(f"resize_size must be [height, width] with h <= w, got {[rh, rw]}")

    def forward_probs(x: torch.Tensor) -> torch.Tensor:
        return torch.softmax(segmentor.forward(x, dtype)["logits"], dim=1)

    @torch.inference_mode()
    def step(img_uint8: torch.Tensor, lbl: torch.Tensor):
        img = normalize_image(img_uint8)
        h, w = img.shape[2], img.shape[3]
        fused = None
        for rh, rw in resize_sizes:
            scaled = bilinear_resize(img, rh, rw)
            probs = forward_probs(scaled)
            if is_flip:
                probs = probs + forward_probs(scaled.flip(3)).flip(3)
            probs = bilinear_resize(probs, h, w)
            fused = probs if fused is None else fused + probs
        pred = fused.argmax(1)
        inter, union = intersection_and_union(pred, lbl, num_classes)
        return pred, inter, union

    return step


def run_validation(step_fn: Callable, data_iter: Iterable, device: torch.device, with_pred: bool = False,
                   target: int | None = None):
    """Accumulate (iou, miou) over a batch iterator.

    Partial tail batches are padded to ``target`` samples (default: the
    first batch's size) with all-255 labels (``pad_batch``): the pad
    samples add nothing to intersection or union, and every batch has one
    shape.  The areas are summed over the ranks of a process group."""
    inter_sum = union_sum = None
    preds = []
    for batch in data_iter:
        if target is None:
            target = batch["images"].shape[0]
        batch = pad_batch(batch, target)
        img = torch.from_numpy(batch["images"]).to(device, non_blocking=True)
        lbl = torch.from_numpy(batch["labels"].astype(np.int64)).to(device, non_blocking=True)
        *pred, inter, union = step_fn(img, lbl)  # a ms/flip step also returns pred
        if with_pred:
            n = batch["n_valid"]
            preds.append((pred[0][:n].cpu().numpy(), batch["image_paths"][:n]))
        inter_sum = inter if inter_sum is None else inter_sum + inter
        union_sum = union if union_sum is None else union_sum + union
    mesh.all_reduce_sum([inter_sum, union_sum])
    iou = iou_from_areas(inter_sum.cpu().numpy(), union_sum.cpu().numpy())
    miou = float(np.mean(iou))
    return (iou, miou, preds) if with_pred else (iou, miou)


class Validator:
    """Standalone multi-scale evaluator (reference code/workflows/validator.py)."""

    def __init__(self, cfg, segmentor, device: torch.device):
        self.cfg = cfg
        self.segmentor = segmentor
        self.device = device
        self.run_seconds = 0.0
        # validate.resize_sizes is the multi-scale protocol; an empty list
        # falls back to the single dataset.val.resize_size
        sizes = [tuple(s) for s in cfg.validate.resize_sizes]
        if not sizes and cfg.dataset.val.resize_size:
            sizes = [tuple(cfg.dataset.val.resize_size)]
        self.step = make_ms_flip_step(segmentor, sizes, cfg.validate.is_flip, cfg.dataset.num_classes)
        self.color_dir = cfg.validate.color_mask_dir_path
        if self.color_dir:
            os.makedirs(self.color_dir, exist_ok=True)
            if os.listdir(self.color_dir):
                raise RuntimeError(f"validate.color_mask_dir_path {self.color_dir!r} is not empty")

    def run(self, data_iter: Iterable, target: int | None = None) -> dict:
        """{'iou', 'miou'} (+ 'miou_16', 'miou_13' for SYNTHIA sources).  The
        predictions come back to the host only for colour export.
        ``run_seconds`` is the host time of the batch loop, which ends in
        the fetch of the summed areas.  ``target``: ``run_validation``'s."""
        t0 = time.perf_counter()
        iou, miou, *preds = run_validation(
            self.step, data_iter, self.device, with_pred=bool(self.color_dir), target=target
        )
        self.run_seconds = time.perf_counter() - t0
        if self.color_dir:
            for batch_preds, paths in preds[0]:
                for pred, path in zip(batch_preds, paths):
                    with open(os.path.join(self.color_dir, os.path.basename(path)), "wb") as f:
                        f.write(colorize_mask(pred, self.cfg.dataset.num_classes))
        result = {"iou": iou, "miou": miou}
        if self.cfg.dataset.source.type and "SYNTHIA" in self.cfg.dataset.source.type:
            miou_16, miou_13 = synthia_mious(iou)
            result.update({"miou_16": miou_16, "miou_13": miou_13})
        return result
