"""Weights-only loading of reference ``.pth`` files into the port's modules.

Mirrors the partial, prefix-tolerant semantics of the JAX package's
``load_weights`` (and the reference's ``load_model``,
code/utils/utils.py:68-89): checkpoint entries are intersected with the
module's state_dict by name and shape, the counts are logged, and a file that
shares nothing with the module raises.  Full-state checkpoints (optimizer,
step, EMA) come with the training slice.
"""
from __future__ import annotations

import logging
import os

import torch
from torch import nn

from hiast_tpu_torch.models.convert import (
    hf_to_port_state_dict,
    is_hf_segformer_layout,
    reference_to_port_state_dict,
)

log = logging.getLogger("hiast_tpu_torch")


def load_weights(path: str, module: nn.Module) -> nn.Module:
    """Load a torch ``.pth`` state_dict into ``module`` (in place).

    A HuggingFace Segformer checkpoint (``segformer.*`` keys) is renamed
    first, as the JAX package's ``load_weights`` detects it; a mmseg / NVlabs
    SegFormer ``.pth`` already has the port's names."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path!r} is a directory (an Orbax checkpoint of the JAX package); "
            "the port reads .pth files: torch.save the state_dict that "
            "hiast_tpu_torch.models.convert.flax_to_port_state_dict(variables) returns "
            "(any trunk), or for DeepLab write one with "
            "hiast_tpu.utils.checkpoint.export_pth(path, variables)"
        )
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    if is_hf_segformer_layout(state.keys()):
        state = hf_to_port_state_dict(state)
    state = reference_to_port_state_dict(state)
    target = module.state_dict()
    matched, skipped = 0, []
    for key, value in state.items():
        if key not in target:
            continue
        value = torch.as_tensor(value)
        if tuple(value.shape) != tuple(target[key].shape):
            skipped.append((key, tuple(value.shape), tuple(target[key].shape)))
            continue
        target[key] = value.to(target[key].dtype)
        matched += 1
    log.info(
        "load %s: matched %d / %d module entries (%d shape-mismatched)",
        path, matched, len(target), len(skipped),
    )
    for key, got, want in skipped[:10]:
        log.warning("  shape mismatch at %s: ckpt %s vs model %s", key, got, want)
    if not matched:
        raise ValueError(
            f"checkpoint {path!r} shares no parameter with the model "
            f"(0 of {len(target)} entries matched): wrong layout or wrong model"
        )
    module.load_state_dict(target, strict=True)
    return module
