"""Logger and optional TensorBoard writer (reference code/utils/utils.py:173-183).

The port of ``hiast_tpu/utils/logging_utils.py`` without its ``Profiler``,
which wraps ``jax.profiler``; the port's profiling is ``torch.profiler``
around a run (``chip_smoke.py --profile``).

Under a process group (``parallel/mesh.py``) rank 0 alone writes the log
file and the tensorboard events; every rank logs to its console, the other
ranks' lines prefixed with their rank.
"""
from __future__ import annotations

import logging
import os

from hiast_tpu_torch.parallel import mesh


def init_logger(log_path: str | None, name: str = "hiast_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    for handler in list(logger.handlers):
        handler.close()
        logger.removeHandler(handler)
    fmt = logging.Formatter("[%(asctime)s-%(levelname)s]: %(message)s")
    sh = logging.StreamHandler()
    sh.setFormatter(fmt if mesh.is_main() else
                    logging.Formatter(f"[rank {mesh.rank()}][%(asctime)s-%(levelname)s]: %(message)s"))
    logger.addHandler(sh)
    if log_path and mesh.is_main():
        os.makedirs(os.path.dirname(log_path) or ".", exist_ok=True)
        fh = logging.FileHandler(log_path, mode="a")
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


def init_writer(tensorboard_dir: str | None):
    """A tensorboardX ``SummaryWriter``, or None without a directory,
    without tensorboardX or off rank 0."""
    if not tensorboard_dir or not mesh.is_main():
        return None
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(tensorboard_dir, flush_secs=10)
