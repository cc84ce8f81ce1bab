"""Checkpoints: reference ``.pth`` weights in, full training state out.

``load_weights`` mirrors the partial, prefix-tolerant semantics of the JAX
package's ``load_weights`` (and the reference's ``load_model``,
code/utils/utils.py:68-89): checkpoint entries are intersected with the
module's state_dict by name and shape, the counts are logged, and a file that
shares nothing with the module raises.

``save_train_state`` writes the trainer's full state as one ``.pth``:
``{'state_dict', 'optimizer', 'step', 'lr_schedule_step'}``, and
``load_step`` reads back only its step (the JAX package's ``load_step``).  The weights
under ``state_dict`` are the reference layout, so ``load_weights`` (and the
generation and validation CLIs) read a trainer checkpoint as it is.  The
file is written beside its target and moved over it with ``os.replace``,
so a crash leaves the previous checkpoint whole (the JAX package deletes
the old directory before it renames the new one).  ``CheckpointPolicy`` is
the JAX package's save policy: ``<name>_last.pth`` every save,
``<name>_best.pth`` on a best mIoU, ``<name>_mid.pth`` once past half the
iterations, and with ``is_save_all`` the newest ``keep``
``<name>_iter_<n>.pth``.
"""
from __future__ import annotations

import logging
import os
import pickle
import re
import shutil

import torch
from torch import nn

from hiast_tpu_torch.models.convert import port_state_dict

log = logging.getLogger("hiast_tpu_torch")


def load_weights(path: str, module: nn.Module) -> nn.Module:
    """Load a torch ``.pth`` state_dict into ``module`` (in place).

    Entries the file lacks keep their values: a DeepLab-v2 ``.pth`` loads
    into DeepLab-v3+'s trunk and leaves its head at its initialisation.

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
    state = port_state_dict(torch.load(path, map_location="cpu", weights_only=True))
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
        "load %s: matched %d / %d module entries (%d shape-mismatched); %d left at their initial values",
        path, matched, len(target), len(skipped), len(target) - matched,
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


def save_train_state(path: str, state: dict) -> None:
    """Write ``state`` (a dict of tensors, state_dicts and numbers) to
    ``path`` atomically."""
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def load_train_state(path: str) -> dict | None:
    """The full state saved by ``save_train_state``, or None when ``path``
    holds weights only."""
    if os.path.isdir(path):
        return None
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and {"state_dict", "optimizer", "step"} <= set(state):
        return state
    return None


def load_step(ckpt_dir: str, name: str = "model_last") -> int | None:
    """The ``step`` saved in ``<ckpt_dir>/<name>.pth``, or None when the file
    is missing, holds weights only or cannot be read.  The round driver
    probes it once a round to decide skip / resume / fresh start
    (``cli/run_rounds.py``); the file is memory-mapped, so the hundreds of
    MB of weights and optimizer moments beside the step are not read."""
    path = os.path.join(ckpt_dir, f"{name}.pth")
    try:
        state = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    except (OSError, RuntimeError, EOFError, ValueError, pickle.UnpicklingError):
        return None
    if isinstance(state, dict) and "step" in state:
        return int(state["step"])
    return None


class CheckpointPolicy:
    """last / best / mid / per-iter save policy (reference
    base_trainer.py:188-198); ``keep`` bounds the per-iteration saves."""

    def __init__(self, ckpt_dir: str, total_iter: int, is_save_all: bool = False, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.total_iter = total_iter
        self.is_save_all = is_save_all
        self.keep = keep
        os.makedirs(ckpt_dir, exist_ok=True)
        self._mid_saved = False

    def path(self, name: str) -> str:
        return os.path.join(self.ckpt_dir, f"{name}.pth")

    def _prune_iter_saves(self, name: str) -> None:
        pat = re.compile(rf"^{re.escape(name)}_iter_(\d+)\.pth$")
        found = sorted(
            (int(m.group(1)), entry)
            for entry in os.listdir(self.ckpt_dir)
            if (m := pat.match(entry))
        )
        for _, entry in found[: max(0, len(found) - self.keep)]:
            os.remove(os.path.join(self.ckpt_dir, entry))

    def _copy_last(self, name: str, to: str) -> None:
        """``<name>_last.pth`` copied to ``<to>.pth``, atomically (a file
        copy: the state is serialised once per save)."""
        tmp = f"{self.path(to)}.{os.getpid()}.tmp"
        shutil.copyfile(self.path(f"{name}_last"), tmp)
        os.replace(tmp, self.path(to))

    def save(self, name: str, state: dict, iteration: int, is_best: bool) -> None:
        save_train_state(self.path(f"{name}_last"), state)
        if self.is_save_all:
            self._copy_last(name, f"{name}_iter_{iteration}")
            if self.keep and self.keep > 0:
                self._prune_iter_saves(name)
        if is_best:
            self._copy_last(name, f"{name}_best")
        if iteration >= self.total_iter // 2 and not self._mid_saved:
            self._copy_last(name, f"{name}_mid")
            self._mid_saved = True
