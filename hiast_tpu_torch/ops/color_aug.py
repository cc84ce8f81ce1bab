"""The strong view on the device: batched colour augmentation ('CCA', 'SCA').

The port of ``hiast_tpu/ops/color_aug.py:batched_color_aug`` (:280; the
batched transforms :175-326), the same math in PyTorch.  The reference
builds the view on the host with albumentations' ``SomeOf(3 of 8)``
(reference augmentations.py:73-89, 106-134); here, as in the JAX package,
it is made on the card inside the train step from the weak view's uint8
batch.

The random draws and the transform are split: ``draw_color_aug`` makes
every random number a batch needs from a ``torch.Generator``, and
``apply_color_aug`` is a deterministic function of the images and those
draws.  Torch cannot reproduce ``jax.random``, so the tests rebuild the
JAX package's draws from its own key splits and feed them to
``apply_color_aug``.

'CCA' (complex): each sample picks 3 of the 8 transforms without
replacement and gates each pick at p = 0.5; the picked ones apply in pool
order (ColorJitter(0.2), GaussianBlur(3..41), RandomContrast(0..3),
RandomBrightness(+-0.5), Posterize(4 bits), Equalize, Solarize(128),
ToGray).  'SCA' (simple): ColorJitter then GaussianBlur, each at p = 0.5
(reference augmentations.py:67-70).  Images are NHWC, RGB, in [0, 255].

Precision: the train step runs the chain in bf16, as the JAX step does
(the reference's own aug runs on uint8 images); the per-image means and the
equalize histograms accumulate in float32.  Every transform is computed
for the whole batch and kept per sample where its gate is on, as in JAX.

The blur is separable, with per-sample taps up to 41 wide, as one grouped
``conv2d`` per axis over the B*3 channels.  The equalize takes its 256-bin
CDF from the [::4, ::4] grid and applies the 33-knot piecewise-linear LUT
of the JAX package, evaluated as a gather of the two knots around each
pixel and a lerp (JAX's hat-function weights over all 33 knots give the
same sum and would take a [B, H, W, 3, 33] tensor).  None of this is a
Pallas kernel in the JAX package; it runs as PyTorch operations (cuDNN for
the convolutions).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

N_POOL = 8  # CCA's transform pool
MAX_BLUR = 41  # albumentations' blur_limit upper bound
_GRAY = (0.299, 0.587, 0.114)  # ITU-R BT.601 luma, what OpenCV's cvtColor uses
_T_YIQ = ((0.299, 0.587, 0.114), (0.596, -0.274, -0.322), (0.211, -0.523, 0.312))
_T_RGB = ((1.0, 0.956, 0.621), (1.0, -0.272, -0.647), (1.0, -1.106, 1.703))


@dataclass
class ColorAugDraws:
    """Every random number of one batch's strong view.

    ``gates`` bool [B, 8] ('CCA', pool order) or [B, 2] ('SCA': jitter,
    blur); ``jitter`` float32 [B, 4]: brightness, contrast and saturation
    factors in [0.8, 1.2] and the hue shift in [-0.2, 0.2] (of pi);
    ``ksize`` int64 [B], the odd blur width in [3, 41]; ``alpha`` float32
    [B], the contrast factor in [1, 4], and ``beta`` float32 [B], the
    brightness shift in [-0.5, 0.5] ('CCA' only)."""

    kind: str
    gates: torch.Tensor
    jitter: torch.Tensor
    ksize: torch.Tensor
    alpha: torch.Tensor | None = None
    beta: torch.Tensor | None = None

    def rows(self, share: slice) -> "ColorAugDraws":
        """The draws of the samples in ``share`` (a data-parallel rank's)."""
        return ColorAugDraws(self.kind, *(None if t is None else t[share] for t in
                                          (self.gates, self.jitter, self.ksize, self.alpha, self.beta)))


def _uniform(shape, lo: float, hi: float, generator: torch.Generator) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=generator.device, dtype=torch.float32)
    return lo + (hi - lo) * u


def draw_color_aug(b: int, kind: str, generator: torch.Generator, selected_num: int = 3) -> ColorAugDraws:
    """The draws of a batch of ``b`` on ``generator``'s device."""
    dev = generator.device
    jitter = torch.cat([_uniform((b, 3), 0.8, 1.2, generator), _uniform((b, 1), -0.2, 0.2, generator)], 1)
    ksize = 3 + 2 * torch.randint(0, (MAX_BLUR - 3) // 2 + 1, (b,), generator=generator, device=dev)
    if kind == "SCA":
        gates = torch.rand((b, 2), generator=generator, device=dev) < 0.5
        return ColorAugDraws(kind, gates, jitter, ksize)
    if kind != "CCA":
        raise ValueError(f"colour aug kind must be 'CCA' or 'SCA', got {kind!r}")
    # selected_num of 8 without replacement per sample, then each at p = 0.5
    picks = torch.rand((b, N_POOL), generator=generator, device=dev).argsort(1)[:, :selected_num]
    chosen = torch.zeros((b, N_POOL), dtype=torch.bool, device=dev).scatter_(1, picks, True)
    gates = chosen & (torch.rand((b, N_POOL), generator=generator, device=dev) < 0.5)
    alpha = 1.0 + _uniform((b,), 0.0, 3.0, generator)
    beta = _uniform((b,), -0.5, 0.5, generator)
    return ColorAugDraws(kind, gates, jitter, ksize, alpha, beta)


# -- the transforms, batched, NHWC ----------------------------------------------
def _clip(x: torch.Tensor) -> torch.Tensor:
    return x.clamp(0.0, 255.0)


def _gray(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 3] -> [B, H, W] luma, in x's dtype."""
    return x @ torch.tensor(_GRAY, dtype=x.dtype, device=x.device)


def _pixel_mean(g: torch.Tensor) -> torch.Tensor:
    """[B, H, W] -> [B, 1, 1, 1] mean accumulated in float32 (a bf16 sum over
    ~0.5M pixels would lose every addend below its ulp)."""
    return g.mean(dim=(1, 2), dtype=torch.float32)[:, None, None, None]


def _per_sample(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """[B] -> [B, 1, 1, 1] in the image dtype (a float32 factor would lift a
    bf16 chain back to float32)."""
    return v.to(dtype)[:, None, None, None]


def color_jitter(x: torch.Tensor, jitter: torch.Tensor) -> torch.Tensor:
    """Brightness, contrast, saturation, then a hue rotation in YIQ space."""
    b, dt = x.shape[0], x.dtype
    bf, cf, sf = (_per_sample(jitter[:, i], dt) for i in range(3))
    x = _clip(x * bf)
    mean = _pixel_mean(_gray(x)).to(dt)
    x = _clip(mean + cf * (x - mean))
    g = _gray(x)[..., None]
    x = _clip(g + sf * (x - g))
    theta = jitter[:, 3] * math.pi
    cos_t, sin_t = torch.cos(theta).to(dt), torch.sin(theta).to(dt)
    rot = torch.eye(3, dtype=dt, device=x.device).repeat(b, 1, 1)
    rot[:, 1, 1], rot[:, 1, 2], rot[:, 2, 1], rot[:, 2, 2] = cos_t, -sin_t, sin_t, cos_t
    t_rgb = torch.tensor(_T_RGB, dtype=dt, device=x.device)
    t_yiq = torch.tensor(_T_YIQ, dtype=dt, device=x.device)
    m = t_rgb @ rot @ t_yiq  # [B, 3, 3]
    return _clip(torch.einsum("bhwc,bdc->bhwd", x, m))


def blur_taps(ksize: torch.Tensor) -> torch.Tensor:
    """[B] odd widths -> float32 [B, 41] normalised Gaussian taps, cv2's
    default sigma, zero outside each width."""
    half = (MAX_BLUR - 1) // 2
    sigma = 0.3 * ((ksize.float() - 1.0) * 0.5 - 1.0) + 0.8
    pos = torch.arange(-half, half + 1, dtype=torch.float32, device=ksize.device)
    active = pos.abs()[None, :] <= ((ksize - 1) / 2)[:, None]
    w = torch.where(active, torch.exp(-0.5 * (pos[None, :] / sigma[:, None]) ** 2), torch.zeros((), device=ksize.device))
    return w / w.sum(dim=1, keepdim=True)


def gaussian_blur(x: torch.Tensor, ksize: torch.Tensor) -> torch.Tensor:
    """Separable blur with per-sample widths: two grouped convolutions over
    the B*3 (sample, channel) planes, zero padding (the JAX SAME)."""
    b, h, w, _ = x.shape
    half = (MAX_BLUR - 1) // 2
    taps = blur_taps(ksize).to(x.dtype).repeat_interleave(3, dim=0)  # [B*3, 41]
    y = x.permute(0, 3, 1, 2).reshape(1, b * 3, h, w)
    y = F.conv2d(y, taps.view(b * 3, 1, MAX_BLUR, 1), padding=(half, 0), groups=b * 3)
    y = F.conv2d(y, taps.view(b * 3, 1, 1, MAX_BLUR), padding=(0, half), groups=b * 3)
    return y.view(b, 3, h, w).permute(0, 2, 3, 1)


def equalize(x: torch.Tensor) -> torch.Tensor:
    """Per-sample, per-channel histogram equalisation: the cv2 LUT from the
    CDF of the [::4, ::4] grid, applied as a 32-segment piecewise-linear
    function of the level (knots at 0, 8, ..., 248 and 255, the last one
    placed at 256 as in JAX), interpolated in float32."""
    b = x.shape[0]
    q = _clip(x).to(torch.int64)  # [B, H, W, 3]
    qs = q[:, ::4, ::4, :]
    plane = torch.arange(b * 3, device=x.device).view(b, 1, 1, 3)
    flat = (plane * 256 + qs).reshape(-1)
    hist = torch.zeros(b * 3 * 256, dtype=torch.float32, device=x.device)
    hist = hist.index_add_(0, flat, torch.ones_like(flat, dtype=torch.float32)).view(b, 3, 256)
    cdf = hist.cumsum(-1)
    first = (hist > 0).to(torch.int32).argmax(-1, keepdim=True)
    cdf_min = cdf.gather(-1, first)
    denom = (cdf[..., -1:] - cdf_min).clamp(min=1.0)
    lut = torch.round((cdf - cdf_min) / denom * 255.0).clamp(0, 255)  # [B, 3, 256]
    knots = torch.cat([lut[..., ::8], lut[..., -1:]], dim=-1)  # [B, 3, 33]
    xk = _clip(x.float()) / 8.0
    j0 = xk.floor().clamp(max=31)
    frac = xk - j0
    j0 = j0.to(torch.int64)
    kn = knots.permute(0, 2, 1)  # [B, 33, 3]: index the knot per channel
    lo = kn.gather(1, j0.view(b, -1, 3)).view_as(xk)
    hi = kn.gather(1, (j0 + 1).view(b, -1, 3)).view_as(xk)
    return (lo * (1.0 - frac) + hi * frac).to(x.dtype)


def apply_color_aug(imgs: torch.Tensor, draws: ColorAugDraws, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[B, H, W, 3] images in [0, 255] (uint8 or float) -> the strong view
    in ``dtype``, NHWC."""
    x = imgs.to(dtype)
    g = draws.gates

    def gate(i: int) -> torch.Tensor:
        return g[:, i, None, None, None]

    if draws.kind == "SCA":
        x = torch.where(gate(0), color_jitter(x, draws.jitter), x)
        return torch.where(gate(1), gaussian_blur(x, draws.ksize), x)
    x = torch.where(gate(0), color_jitter(x, draws.jitter), x)
    x = torch.where(gate(1), gaussian_blur(x, draws.ksize), x)
    mean = _pixel_mean(_gray(x)).to(dtype)
    x = torch.where(gate(2), _clip(mean + _per_sample(draws.alpha, dtype) * (x - mean)), x)
    x = torch.where(gate(3), _clip(x * (1.0 + _per_sample(draws.beta, dtype))), x)
    x = torch.where(gate(4), torch.floor(x / 16.0) * 16.0, x)
    x = torch.where(gate(5), equalize(x), x)
    x = torch.where(gate(6), torch.where(x >= 128.0, 255.0 - x, x), x)
    return torch.where(gate(7), _gray(x)[..., None].expand_as(x), x)


def batched_color_aug(imgs: torch.Tensor, kind: str, generator: torch.Generator,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Draw and apply: the port's ``batched_color_aug``."""
    return apply_color_aug(imgs, draw_color_aug(imgs.shape[0], kind, generator), dtype)
