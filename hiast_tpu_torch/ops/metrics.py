"""Segmentation metrics: per-class intersection and union on the device.

The port of ``hiast_tpu/ops/metrics.py`` (reference: code/utils/metrics.py:
6-19).  The areas are three ``bincount``s over the pixels, so a batch's
[C] vectors are the only thing the host fetches; the mIoU arithmetic stays
on the host in numpy.
"""
from __future__ import annotations

import numpy as np
import torch

IGNORE_INDEX = 255


def intersection_and_union(
    pred: torch.Tensor, target: torch.Tensor, num_classes: int, ignore_index: int = IGNORE_INDEX
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-class (intersection, union) pixel areas, float32 [C] each.

    ``pred`` and ``target`` are integer maps of one shape.  Pixels whose
    target is ``ignore_index`` are left out; a target or prediction outside
    [0, C) counts for no class, as in the JAX one-hot formulation."""
    pred = pred.reshape(-1).long()
    target = target.reshape(-1).long()
    none = torch.full_like(pred, num_classes)  # the bucket that is dropped
    in_range_t = (target >= 0) & (target < num_classes)
    t = torch.where(in_range_t, target, none)
    p = torch.where((target != ignore_index) & (pred >= 0) & (pred < num_classes), pred, none)
    n = num_classes + 1
    inter = torch.bincount(torch.where(p == t, p, none), minlength=n)[:num_classes]
    area_pred = torch.bincount(p, minlength=n)[:num_classes]
    area_target = torch.bincount(t, minlength=n)[:num_classes]
    return inter.float(), (area_pred + area_target - inter).float()


def iou_from_areas(intersection: np.ndarray, union: np.ndarray) -> np.ndarray:
    return np.asarray(intersection) / (np.asarray(union) + 1e-10)


def synthia_mious(iou: np.ndarray) -> tuple[float, float]:
    """SYNTHIA protocol: 19-slot IoU rescaled to 16- and 13-class mIoU.

    Reference: code/workflows/validator.py:108-113 — mIoU-16 multiplies the
    19-slot mean by 19/16; mIoU-13 additionally zeroes classes 3..5
    (wall/fence/pole) and multiplies by 19/13.
    """
    iou = np.asarray(iou)
    miou_16 = float(np.mean(iou) * 19 / 16)
    iou_13 = iou.copy()
    iou_13[3:6] = 0
    miou_13 = float(np.mean(iou_13) * 19 / 13)
    return miou_16, miou_13
