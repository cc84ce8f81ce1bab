"""Bilinear resizing of NCHW tensors.

The JAX package writes bilinear resizing as two interpolation matmuls for the
TPU (``hiast_tpu/ops/resize.py``); PyTorch has the operation itself (the
reference's ``F.interpolate(mode='bilinear', align_corners=True)``,
self_training_segmentor.py:27).  ``align_corners=False`` is the half-pixel
convention of the JAX package's ``_linear_interp_matrix`` (source index
``(i + 0.5) * n_in / n_out - 0.5`` clipped to [0, n_in - 1]), which is
``F.interpolate``'s own for an output size given without a scale factor.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def bilinear_resize(
    x: torch.Tensor, out_h: int, out_w: int, align_corners: bool = True
) -> torch.Tensor:
    """[B, C, H, W] -> [B, C, out_h, out_w], interpolated in float32 and
    returned in the input's dtype."""
    if tuple(x.shape[-2:]) == (out_h, out_w):
        return x
    out = F.interpolate(
        x.float(), size=(out_h, out_w), mode="bilinear", align_corners=align_corners
    )
    return out.to(x.dtype)
