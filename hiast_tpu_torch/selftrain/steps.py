"""Step-level helpers shared by the port's entry points.

``normalize_image`` and ``make_eval_forward`` so far; the consistency and
self-training steps of ``hiast_tpu/selftrain/steps.py`` come with the
training slice.
"""
from __future__ import annotations

from typing import Callable

import torch

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
