"""Activation rematerialisation (``runtime.remat``), the port of the JAX
package's ``jax.checkpoint`` wrappers.

``checkpointed(module, *args, save_dots=...)`` runs ``module(*args)`` under
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``: the forward keeps
only the segment's inputs, and the backward reruns the segment to rebuild
what it needs.  With ``save_dots`` a selective-checkpoint policy keeps what
``jax.checkpoint_policies.dots_with_no_batch_dims_saveable`` keeps: the
outputs of matrix products without batch dimensions (``aten.mm`` and
``aten.addmm``, what ``nn.Linear`` lowers to).  Everything else is rerun:
convolutions, ``bmm``, the SRA attention and its ``torch.empty`` output, the
elementwise work.  Parameters and ``state_dict`` keys do not change, as
flax's ``nn.remat`` leaves them.

The rerun goes through train-mode BatchNorm again, which would update its
running statistics a second time a step (``jax.checkpoint`` recomputes
without a state update).  So while the segment is rerun, each train-mode
``_BatchNorm`` in it (``PooledBatchNorm`` included) runs on copies of its
running statistics and ``num_batches_tracked``, and the copies are dropped:
the rerun takes the same code path as the forward, so it saves the same
tensors, and the buffers advance once a step.
"""
from __future__ import annotations

import contextlib

import torch
from torch import nn
from torch.nn.modules.batchnorm import _BatchNorm
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

_SAVED_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
_STATS = ("running_mean", "running_var", "num_batches_tracked")


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return CheckpointPolicy.MUST_SAVE if op in _SAVED_PRODUCTS else CheckpointPolicy.PREFER_RECOMPUTE


@contextlib.contextmanager
def _scratch_running_stats(module: nn.Module):
    """The train-mode BatchNorms of ``module`` update copies of their
    running statistics while inside; the originals come back on exit."""
    swapped = []
    for m in module.modules():
        if isinstance(m, _BatchNorm) and m.training and m.track_running_stats:
            for name in _STATS:
                swapped.append((m, name, m._buffers[name]))
                m._buffers[name] = m._buffers[name].clone()
    try:
        yield
    finally:
        for m, name, buf in swapped:
            m._buffers[name] = buf


def checkpointed(module: nn.Module, *args, save_dots: bool = False):
    """``module(*args)`` with its activations rematerialised in the backward
    (the module docstring); call it only where the result is differentiated."""

    def contexts():
        if save_dots:
            forward, rerun = create_selective_checkpoint_contexts(_save_dots)
        else:
            forward, rerun = contextlib.nullcontext(), contextlib.nullcontext()

        @contextlib.contextmanager
        def recompute():
            # the copies are made outside the selective policy's dispatch mode,
            # which would otherwise look for them among the forward's ops
            with _scratch_running_stats(module), rerun:
                yield

        return forward, recompute()

    return checkpoint(module, *args, use_reentrant=False, context_fn=contexts)
