"""Fourier Domain Adaptation on the device (arXiv:2004.05498).

The port of ``hiast_tpu/ops/fda.py``: the host FDA (``data/augment.py:FDA``)
follows the reference's per-sample numpy path; this swaps the centred
low-frequency amplitude band of a batch of source images for a batch of
target images' with ``torch.fft`` on the images' device, for callers that
hold both batches there.  Nothing in either package's training path calls
it.
"""
from __future__ import annotations

import numpy as np
import torch


def _low_freq_mask(h: int, w: int, beta: float) -> np.ndarray:
    """The centred (fftshift) square band of half-width
    max(floor(min(h, w) * beta), 1), in the unshifted layout."""
    b = max(int(np.floor(min(h, w) * beta)), 1)
    cy, cx = h // 2, w // 2
    mask = np.zeros((h, w), np.float32)
    mask[cy - b : cy + b, cx - b : cx + b] = 1.0
    return np.fft.ifftshift(mask)


def fda_device(src: torch.Tensor, tgt: torch.Tensor, beta: float = 0.001) -> torch.Tensor:
    """``tgt``'s low-frequency amplitude onto ``src``, the phase kept:
    [B, H, W, 3] images in 0..255 (any dtype) of one shape -> float32,
    clipped to 0..255, on their device."""
    _, h, w, _ = src.shape
    mask = torch.from_numpy(_low_freq_mask(h, w, beta)).to(src.device)[None, :, :, None]
    fs = torch.fft.fft2(src.float(), dim=(1, 2))
    ft = torch.fft.fft2(tgt.float(), dim=(1, 2))
    amp = fs.abs() * (1.0 - mask) + ft.abs() * mask
    out = torch.fft.ifft2(torch.polar(amp, fs.angle()), dim=(1, 2)).real
    return out.clamp(0.0, 255.0)
