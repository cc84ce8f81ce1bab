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

from hiast_tpu_torch.parallel import spatial


def source_index(n_in: int, n_out: int, align_corners: bool, out_index: torch.Tensor):
    """(i0, i1, w1) of output positions ``out_index`` (int64) along one
    axis: the two input positions each reads and the weight of the second,
    in float32 as ``F.interpolate`` computes them."""
    dst = out_index.to(torch.float32)
    if align_corners:
        scale = (n_in - 1) / (n_out - 1) if n_out > 1 else 0.0
        src = dst * torch.tensor(scale, dtype=torch.float32)
    else:
        src = ((dst + 0.5) * torch.tensor(n_in / n_out, dtype=torch.float32) - 0.5).clamp(min=0.0)
    i0 = src.floor().to(torch.int64).clamp(max=n_in - 1)
    i1 = torch.where(i0 < n_in - 1, i0 + 1, i0)
    return i0, i1, src - i0.to(torch.float32)


def resize_cols(x: torch.Tensor, out_w: int, align_corners: bool) -> torch.Tensor:
    """float32 [B, C, H, W] -> [B, C, H, out_w], the rows kept as they are
    (an interpolation over the same row count reads each row with weight 1)."""
    if x.shape[-1] == out_w:
        return x
    return F.interpolate(x, size=(x.shape[-2], out_w), mode="bilinear", align_corners=align_corners)


def bilinear_resize(
    x: torch.Tensor, out_h: int, out_w: int, align_corners: bool = True
) -> torch.Tensor:
    """[B, C, H, W] -> [B, C, out_h, out_w], interpolated in float32 and
    returned in the input's dtype.  Where image rows are sharded over the
    ``space`` axis (``parallel/spatial.py``), ``x`` is this rank's slab and
    ``out_h`` its share of the output rows."""
    if spatial.rows_group() is not None:
        return spatial.resize_rows(x, out_h, out_w, align_corners).to(x.dtype)
    if tuple(x.shape[-2:]) == (out_h, out_w):
        return x
    out = F.interpolate(
        x.float(), size=(out_h, out_w), mode="bilinear", align_corners=align_corners
    )
    return out.to(x.dtype)
