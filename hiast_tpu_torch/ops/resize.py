"""Bilinear resizing of NCHW tensors.

The JAX package writes align_corners=True bilinear as two interpolation
matmuls for the TPU (``hiast_tpu/ops/resize.py``); PyTorch has the operation
itself (the reference's ``F.interpolate(mode='bilinear', align_corners=True)``,
self_training_segmentor.py:27).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def bilinear_resize(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """[B, C, H, W] -> [B, C, out_h, out_w] with align_corners=True,
    interpolated in float32 and returned in the input's dtype."""
    if tuple(x.shape[-2:]) == (out_h, out_w):
        return x
    out = F.interpolate(
        x.float(), size=(out_h, out_w), mode="bilinear", align_corners=True
    )
    return out.to(x.dtype)
