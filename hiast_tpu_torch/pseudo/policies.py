"""Pseudo-label selection policy math (IAS, CBST), in PyTorch.

The port of the IAS and CBST parts of ``hiast_tpu/pseudo/policies.py``
(reference: code/workflows/pseudo_label_generator.py:67-106,142-213).  Per-class
confidence populations are fixed-shape [C, num_bins] histograms (built by the
``ias_hist`` kernel, ops/cuda/select_kernel.py); quantiles interpolate the
histogram CDF; the IAS threshold vector is state carried across batches.

Logits are NCHW here (class axis = dim 1), the layout the kernels read best;
the JAX package's are NHWC.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

IGNORE = 255


class IASState(NamedTuple):
    """Carried state of the instance-adaptive selector."""

    thresholds: torch.Tensor  # [C] float32, init 0.9
    class_mean_probs: torch.Tensor  # [C] float32, init 0 (EMA of selected-pixel conf)


def confidences(logits: torch.Tensor):
    """Max-softmax confidence and first-max argmax over the class axis (dim 1).

    ``maxprob = exp(m - (m + log(sum(exp(x - m)))))``, the formula of the JAX
    package's ``confidences`` and of the CUDA kernels.  The sum runs in class
    order, as the kernels' loop does (a library reduction may pair terms
    otherwise), so on a card this and the kernels round alike.
    logits: [B, C, ...]; returns (maxprob [B, ...], pred [B, ...] int64).
    """
    x = logits.float()
    m = x.amax(dim=1)
    e = torch.exp(x - m.unsqueeze(1))
    total = e[:, 0]
    for c in range(1, e.shape[1]):
        total = total + e[:, c]
    lse = m + torch.log(total)
    return torch.exp(m - lse), x.argmax(dim=1)


def histogram_quantile(hist: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Per-class quantile via CDF interpolation of bin centers.

    hist: [C, B]; q: [C] in [0, 1].  Empty-class rows return the lowest bin
    center — callers guard with their own fallbacks.
    """
    b = hist.shape[1]
    centers = (torch.arange(b, dtype=torch.float32, device=hist.device) + 0.5) / b
    total = hist.sum(dim=1)
    cdf = torch.cumsum(hist, dim=1)
    # np.quantile(linear): virtual index q*(n-1); find the value whose rank
    # straddles it.  rank of bin i spans [cdf[i-1], cdf[i]-1].
    pos = q * (torch.clamp(total, min=1.0) - 1.0)
    frac = pos - torch.floor(pos)

    def value_at_rank(rank):  # first bin whose cdf exceeds the 0-indexed rank
        return centers[(cdf > rank[:, None]).to(torch.uint8).argmax(dim=1)]

    lo = value_at_rank(torch.floor(pos))
    hi = value_at_rank(torch.ceil(pos))
    return lo + frac * (hi - lo)


def ias_update(
    state: IASState, hist: torch.Tensor, alpha: float, beta: float, gamma: float
) -> torch.Tensor:
    """One IAS threshold update from a batch histogram.

    Mirrors reference pseudo_label_generator.py:171-209: each class's new
    candidate threshold is the ``1 - alpha * theta_old^gamma`` quantile of
    the batch's per-class confidence population seeded with theta_old itself,
    then EMA-blended with beta and clipped to 0.999.
    """
    c, num_bins = hist.shape
    theta = state.thresholds
    seed_bins = torch.clamp((theta * num_bins).to(torch.int64), 0, num_bins - 1)
    hist = hist.clone()
    hist[torch.arange(c, device=hist.device), seed_bins] += 1.0
    q = 1.0 - alpha * theta**gamma
    candidate = histogram_quantile(hist, q)
    new_theta = beta * theta + (1.0 - beta) * candidate
    return torch.where(new_theta >= 1.0, torch.full_like(new_theta, 0.999), new_theta)


def update_class_mean_probs(
    cmp: torch.Tensor, prob_sums: torch.Tensor, counts: torch.Tensor, gamma: float
) -> torch.Tensor:
    """EMA of per-class mean confidence (reference
    pseudo_label_generator.py:96-106): init directly on first observation,
    EMA(gamma) afterwards; classes absent from the batch keep their value."""
    mean = prob_sums / torch.clamp(counts, min=1.0)
    updated = torch.where(cmp == 0.0, mean, cmp * gamma + mean * (1.0 - gamma))
    return torch.where(counts > 0, updated, cmp)


def cbst_thresholds(hist: torch.Tensor, p: float) -> torch.Tensor:
    """CBST: each class's quantile at 1 - p of the whole dataset's histogram
    (reference pseudo_label_generator.py:142-165), float32.  The quantile
    runs in the histogram's dtype (the generator sums float64 counts).
    Classes never predicted keep 1.0."""
    c = hist.shape[0]
    q = torch.full((c,), 1.0 - p, dtype=torch.float32, device=hist.device)
    thr = histogram_quantile(hist, q)
    empty = hist.sum(dim=1) == 0
    return torch.where(empty, torch.ones_like(thr), thr).float()
