"""BatchNorm over the global batch of a data-parallel run.

The counterpart of the synced moments of ``hiast_tpu/models/norm.py:63-66``
(``pmean`` of the moments, the count times ``psum(1)``).  ``nn.SyncBatchNorm``
cannot serve: it refuses tensors on the CPU, where the tests run.

``SyncBatchNorm2d`` is torch's ``BatchNorm2d`` whose train-mode statistics
are the global batch's.  Each rank takes its count, mean and sum of squared
deviations (M2) per channel; one all-gather of ``[count, mean, M2]`` a layer
(an all-reduce of a buffer with a row a rank) brings them together, and
Chan's parallel formula merges them in rank order, so every rank holds
the same moments.  The variance is never E[x^2] - E[x]^2, whose
float32 cancellation costs JAX's BatchNorm digits at large means.  The
running variance moves by the unbiased variance of the global count, as
torch's BatchNorm does.  The backward all-reduces ``sum(dy)`` and
``sum(dy * x_hat)`` a layer; the affine gradients stay this rank's share,
for the step's gradient all-reduce to sum.  It saves the input in its own
dtype and forms x_hat again, so a bf16 layer keeps what cuDNN's keeps.

DeepLab-v3+'s ``PooledBatchNorm`` becomes a ``SyncBatchNorm2d`` too: its
own branch is for a batch of one value, and a synced layer's global count
is at least the world size, above 1 (``check_mesh`` gives every rank an
equal share of at least one sample).

A rerun under remat (``models/remat.py``) issues the same collectives
again, in the same order on every rank.  ``convert_synced`` swaps the
modules in place, keeping their parameters and buffers, and only when the
group has more than one rank: at world size 1 a model is unchanged.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from hiast_tpu_torch.models.deeplab_v3plus import PooledBatchNorm
from hiast_tpu_torch.parallel import mesh


def _global_moments(x: torch.Tensor):
    """(mean [C], biased variance [C]) of float32 NCHW ``x`` over every
    rank's batch, in float64: each rank's ``[count, mean, M2]`` in its own
    row of a zeroed [ranks, 3, C] buffer, summed over the ranks (an
    all-gather through the all-reduce that every backend has), then merged.
    The sums accumulate in float64 over float32 terms, as torch's BatchNorm
    does on the CPU: a channel whose spread is small beside its mean loses
    its digits in a float32 sum, and the backward's cancellation shows it."""
    dims = (0, 2, 3)
    n_local = x.numel() // x.shape[1]
    mean = x.sum(dim=dims, dtype=torch.float64) / n_local
    centred = x - mean.float().view(1, -1, 1, 1)
    shift = mean.float().double() - mean  # sum((x - m')^2) = M2 + n (m' - m)^2
    m2 = centred.square().sum(dim=dims, dtype=torch.float64) - n_local * shift.square()
    stats = torch.zeros((mesh.world_size(), 3, mean.numel()), dtype=torch.float64, device=x.device)
    stats[mesh.rank()] = torch.stack([torch.full_like(mean, float(n_local)), mean, m2])
    dist.all_reduce(stats)
    counts, means, m2s = stats[:, 0], stats[:, 1], stats[:, 2]
    total = counts.sum(0)
    mean = (counts * means).sum(0) / total
    m2 = m2s.sum(0) + (counts * (means - mean).square()).sum(0)
    return mean, m2 / total


def _normalised(x: torch.Tensor, mean: torch.Tensor, invstd: torch.Tensor) -> torch.Tensor:
    return (x.float() - mean.view(1, -1, 1, 1)) * invstd.view(1, -1, 1, 1)


class _SyncedNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, mean, var, eps):
        invstd = torch.rsqrt(var + eps).float()
        mean = mean.float()
        ctx.save_for_backward(x, weight, mean, invstd)
        return (_normalised(x, mean, invstd) * weight.view(1, -1, 1, 1) + bias.view(1, -1, 1, 1)).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, invstd = ctx.saved_tensors
        x_hat = _normalised(x, mean, invstd)
        dy = dy.float()
        dims = (0, 2, 3)
        local = torch.stack([dy.sum(dim=dims, dtype=torch.float64), (dy * x_hat).sum(dim=dims, dtype=torch.float64)])
        total = local.clone()
        dist.all_reduce(total)
        count = x_hat.numel() // x_hat.shape[1] * mesh.world_size()
        mean_dy, mean_dy_xhat = (total / count).float().view(2, 1, -1, 1, 1)
        dx = (dy - mean_dy - x_hat * mean_dy_xhat) * (weight * invstd).view(1, -1, 1, 1)
        dw = local[1].float() if ctx.needs_input_grad[1] else None
        db = local[0].float() if ctx.needs_input_grad[2] else None
        return dx.to(x.dtype), dw, db, None, None, None


class SyncBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with the global batch's train-mode statistics
    (the module docstring).  Eval mode is ``BatchNorm2d``'s."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        # every rank holds the same local batch (check_mesh), so the global
        # count is known on the host without a read from the card
        count = x.numel() // x.shape[1] * mesh.world_size()
        with torch.no_grad():
            mean, var = _global_moments(x.detach().float())
        if self.track_running_stats:
            with torch.no_grad():
                self.num_batches_tracked.add_(1)
                unbiased = var * (count / max(count - 1, 1))
                self.running_mean.lerp_(mean.float(), self.momentum)
                self.running_var.lerp_(unbiased.float(), self.momentum)
        return _SyncedNorm.apply(x, self.weight, self.bias, mean, var, self.eps)


def convert_synced(module: nn.Module) -> nn.Module:
    """Make every ``BatchNorm2d`` of ``module`` (``PooledBatchNorm``
    included) a ``SyncBatchNorm2d``, in place, keeping its parameters,
    buffers and hooks, when the process group has more than one rank."""
    if mesh.world_size() <= 1:
        return module
    for m in module.modules():
        if type(m) in (nn.BatchNorm2d, PooledBatchNorm):
            m.__class__ = SyncBatchNorm2d
    return module

