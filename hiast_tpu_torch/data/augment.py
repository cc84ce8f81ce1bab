"""Host-side geometric augmentation for generation (numpy only).

The part of ``hiast_tpu/data/augment.py`` that pseudo-label generation uses:
the deterministic 'PRS-h-w' resize and the aug-type parsing.  The resize
follows cv2's conventions without needing cv2: INTER_LINEAR with half-pixel
centres (edges clamped) for images, rounded to uint8, and INTER_NEAREST
(``floor(dst * src / dst_size)``) for labels.  cv2 rounds its bilinear
weights to 11-bit fixed point, so images may differ from cv2's by one
intensity level; labels match it exactly.

The training augs ('MS', 'OMS', 'DACS', 'FDA-*') come with the training slice.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def _linear_taps(n_in: int, n_out: int):
    """Source rows (lo, hi) and the weight of hi, per output position."""
    src = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    lo = np.floor(src).astype(np.int64)
    frac = (src - lo).astype(np.float32)
    clamp = (lo < 0) | (lo >= n_in - 1)
    frac[clamp] = 0.0
    lo = np.clip(lo, 0, n_in - 1)
    return lo, np.minimum(lo + 1, n_in - 1), frac


def resize_linear(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """uint8 [H, W(, C)] -> uint8 [out_h, out_w(, C)], half-pixel bilinear."""
    lo_y, hi_y, fy = _linear_taps(img.shape[0], out_h)
    lo_x, hi_x, fx = _linear_taps(img.shape[1], out_w)
    x = img.astype(np.float32)
    extra = (1,) * (img.ndim - 2)
    fy = fy.reshape((-1, 1) + extra)
    rows = x[lo_y] * (1.0 - fy) + x[hi_y] * fy
    fx = fx.reshape((1, -1) + extra)
    out = rows[:, lo_x] * (1.0 - fx) + rows[:, hi_x] * fx
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def resize_nearest(lbl: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    h, w = lbl.shape[:2]
    rows = np.minimum(np.floor(np.arange(out_h) * (h / out_h)), h - 1).astype(np.int64)
    cols = np.minimum(np.floor(np.arange(out_w) * (w / out_w)), w - 1).astype(np.int64)
    return np.ascontiguousarray(lbl[rows][:, cols])


@dataclass
class Resize:
    out_h: int
    out_w: int

    def __call__(self, img, lbl, rng=None):
        if img.shape[:2] != (self.out_h, self.out_w):
            img = resize_linear(img, self.out_h, self.out_w)
        if lbl is not None and lbl.shape[:2] != (self.out_h, self.out_w):
            lbl = resize_nearest(lbl, self.out_h, self.out_w)
        return img, lbl


def parse_resize_params(aug_type: str) -> tuple[int, int]:
    """'PRS-768-1536' -> (768, 1536) (reference datasets/utils.py:67-71)."""
    parts = aug_type.split("-")
    if len(parts) != 3:
        raise ValueError(f"aug_type should be like 'PRS-512-1024', got {aug_type!r}")
    return int(parts[1]), int(parts[2])


# device-side color-aug kinds recognized in aug_type lists
DEVICE_COLOR_AUGS = ("SCA", "CCA")


def split_aug_types(aug_types: list[str]) -> tuple[list[str], str | None]:
    """Partition an aug_type list into (host geometric augs, device color aug)."""
    host = [a for a in aug_types if a not in DEVICE_COLOR_AUGS]
    device = [a for a in aug_types if a in DEVICE_COLOR_AUGS]
    if len(device) > 1:
        raise ValueError(f"at most one device color aug, got {device}")
    return host, (device[0] if device else None)
