"""Host-side geometric augmentation.

The part of ``hiast_tpu/data/augment.py`` that generation and plain
self-training use: the deterministic 'PRS-h-w' resize, the 'MS' / 'OMS'
random flip + sized crop + resize (``GeometricAug``) and the aug-type
parsing.  The resize follows cv2's conventions without needing cv2:
INTER_LINEAR with half-pixel centres (edges clamped) for images, rounded to
uint8, and INTER_NEAREST (``floor(dst * src / dst_size)``) for labels.  cv2
rounds its bilinear weights to 11-bit fixed point, so images may differ from
cv2's by one intensity level; labels match it exactly.  ``crop_flip_resize``
repeats the arithmetic of the JAX package's fused C++ crop+flip+resize
(``hiast_tpu/data/native_ops.py:crop_flip_resize``) in numpy.

The numpy functions here (``resize_linear``, ``resize_nearest``,
``crop_flip_resize``) are the plain versions and the specification of the
port's C++ ones (``data/native_ops.py``); each aug calls the set of its
``host`` (a ``native_ops.HostOps``), the native one beside a card.

The source-domain augs: 'DACS' (``ResizeCrop``: resize, then a random
crop) and 'FDA-*' (``FDA``: the low-frequency amplitude band of a random
image of the other domain, by numpy FFT on the host), each drawing from the
sample's ``rng`` in the JAX package's order.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Callable

import numpy as np

if TYPE_CHECKING:
    from hiast_tpu_torch.data.native_ops import HostOps


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


def _crop_taps(n_crop: int, n_out: int):
    """Crop-relative source indices (a, b) and the weight of b per output
    position, in float32 as the C++ op computes them."""
    f = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * np.float32(n_crop) / np.float32(n_out)
    f = np.clip(f - np.float32(0.5), np.float32(0.0), np.float32(n_crop - 1))
    a = f.astype(np.int64)
    return a, np.minimum(a + 1, n_crop - 1), (f - a.astype(np.float32)).astype(np.float32)


def crop_flip_resize(img, lbl, y0: int, x0: int, ch: int, cw: int, flip: bool, oh: int, ow: int):
    """Crop [y0:y0+ch, x0:x0+cw], flip it horizontally when ``flip``, and
    resize to (oh, ow): bilinear (half-pixel, rounded half up) for the uint8
    [H, W, C] image, nearest for the uint8 [H, W] label."""
    ya, yb, fy = _crop_taps(ch, oh)
    xa, xb, fx = _crop_taps(cw, ow)
    if flip:  # flip within the crop window
        xa, xb = cw - 1 - xa, cw - 1 - xb
    x = img.astype(np.float32)
    fx = fx[None, :, None]
    r0 = x[y0 + ya]
    r1 = x[y0 + yb]
    a0 = r0[:, x0 + xa] * (1 - fx) + r0[:, x0 + xb] * fx
    a1 = r1[:, x0 + xa] * (1 - fx) + r1[:, x0 + xb] * fx
    fy = fy[:, None, None]
    out = (a0 * (1 - fy) + a1 * fy + np.float32(0.5)).astype(np.uint8)
    rows = y0 + np.minimum(np.floor(np.arange(oh) * (ch / oh)).astype(np.int64), ch - 1)
    cols = np.minimum(np.floor(np.arange(ow) * (cw / ow)).astype(np.int64), cw - 1)
    if flip:
        cols = cw - 1 - cols
    return np.ascontiguousarray(out), np.ascontiguousarray(lbl[rows][:, x0 + cols])


@dataclass
class GeometricAug:
    """flip + RandomSizedCrop(min_max_height, w2h_ratio) + resize to (h, w),
    drawing from ``rng`` in the JAX package's order: flip, crop height, y0,
    x0 (so one seed gives one crop in both packages)."""

    out_h: int
    out_w: int
    min_max_height: tuple[int, int]
    w2h_ratio: float
    flip_p: float = 0.5
    host: HostOps = field(kw_only=True)

    def __call__(self, img: np.ndarray, lbl: np.ndarray, rng: np.random.Generator):
        flip = bool(rng.random() < self.flip_p)
        h, w = img.shape[:2]
        crop_h = int(rng.integers(self.min_max_height[0], self.min_max_height[1] + 1))
        crop_h = min(crop_h, h)
        crop_w = min(int(round(crop_h * self.w2h_ratio)), w)
        y0 = int(rng.integers(0, h - crop_h + 1))
        x0 = int(rng.integers(0, w - crop_w + 1))
        return self.host.crop_flip_resize(img, lbl, y0, x0, crop_h, crop_w, flip, self.out_h, self.out_w)


@dataclass
class Resize:
    out_h: int
    out_w: int
    host: HostOps = field(kw_only=True)

    def __call__(self, img, lbl, rng=None):
        if img.shape[:2] != (self.out_h, self.out_w):
            img = self.host.resize_linear(img, self.out_h, self.out_w)
        if lbl is not None and lbl.shape[:2] != (self.out_h, self.out_w):
            lbl = self.host.resize_nearest(lbl, self.out_h, self.out_w)
        return img, lbl


@dataclass
class ResizeCrop:
    """'DACS': resize to (h, w), then a random (crop_h, crop_w) crop, its
    corner drawn y0 then x0."""

    h: int
    w: int
    crop_h: int
    crop_w: int
    host: HostOps = field(kw_only=True)

    def __call__(self, img, lbl, rng: np.random.Generator):
        img, lbl = Resize(self.h, self.w, host=self.host)(img, lbl)
        y0 = int(rng.integers(0, self.h - self.crop_h + 1))
        x0 = int(rng.integers(0, self.w - self.crop_w + 1))
        return (
            np.ascontiguousarray(img[y0 : y0 + self.crop_h, x0 : x0 + self.crop_w]),
            np.ascontiguousarray(lbl[y0 : y0 + self.crop_h, x0 : x0 + self.crop_w]),
        )


class FDA:
    """Fourier Domain Adaptation (arXiv:2004.05498; JAX ``augment.FDA``):
    the centred low-frequency amplitude band of each channel, 2b x 2b with
    b = max(floor(min(h, w) * beta), 1), is taken from a random image of the
    other domain's manifest (drawn first from ``rng``), read with
    ``read_rgb`` and resized to the sample with ``host``'s bilinear resize;
    the phase stays the sample's.  The result is clipped to [0, 255] and
    truncated to uint8, as in JAX."""

    def __init__(self, json_path: str, image_dir: str, read_rgb: Callable[[str], np.ndarray],
                 beta_limit: float = 0.001, *, host: HostOps):
        with open(json_path) as f:
            data = json.load(f)
        self.paths = [os.path.join(image_dir, d["image_name"]) for d in data]
        self.read_rgb = read_rgb
        self.beta = beta_limit
        self.host = host

    def _load_target(self, rng: np.random.Generator, shape) -> np.ndarray:
        img = self.read_rgb(self.paths[int(rng.integers(0, len(self.paths)))])
        return Resize(shape[0], shape[1], host=self.host)(img, None)[0]

    def __call__(self, img, lbl, rng: np.random.Generator):
        tgt = self._load_target(rng, img.shape[:2]).astype(np.float32)
        src = img.astype(np.float32)
        h, w = src.shape[:2]
        b = max(int(np.floor(min(h, w) * self.beta)), 1)
        cy, cx = h // 2, w // 2
        out = np.empty_like(src)
        for c in range(3):
            fs = np.fft.fft2(src[..., c])
            amp_s = np.fft.fftshift(np.abs(fs))
            amp_t = np.fft.fftshift(np.abs(np.fft.fft2(tgt[..., c])))
            amp_s[cy - b : cy + b, cx - b : cx + b] = amp_t[cy - b : cy + b, cx - b : cx + b]
            out[..., c] = np.real(np.fft.ifft2(np.fft.ifftshift(amp_s) * np.exp(1j * np.angle(fs))))
        return np.clip(out, 0, 255).astype(np.uint8), lbl


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
