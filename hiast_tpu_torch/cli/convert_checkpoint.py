"""Checkpoint conversion of the port: any ``.pth`` the port reads -> a
weights-only ``.pth`` in the reference layout (the JAX package's
``hiast_tpu/cli/convert_checkpoint.py``, torch side only).

    python -m hiast_tpu_torch.cli.convert_checkpoint --input model_last.pth --output weights.pth

The input may be a reference or mmseg state_dict (``module.`` and
``seg_model.`` prefixes stripped, a bare torchvision ResNet moved under
``backbone.``), a HuggingFace SegFormer state_dict (renamed to the mmseg
names), or a train state of the port (its ``state_dict``).  Orbax
directories are the JAX package's: this machine may have no orbax, so the
JAX package's CLI converts them (``python -m hiast_tpu.cli.convert_checkpoint
--input <dir> --output x.pth``).
"""
from __future__ import annotations

import argparse
import os

import torch

from hiast_tpu_torch.models.convert import port_state_dict

_JAX_CLI = "python -m hiast_tpu.cli.convert_checkpoint --input <dir> --output x.pth"


def main(argv=None):
    p = argparse.ArgumentParser(description="hiast_tpu_torch checkpoint converter")
    p.add_argument("--input", required=True, help=".pth file")
    p.add_argument("--output", required=True, help=".pth file (weights only)")
    args = p.parse_args(argv)
    for path in (args.input, args.output):
        if os.path.isdir(path):
            raise ValueError(f"{path!r} is a directory, an Orbax checkpoint of the JAX package: "
                             f"the JAX package's CLI converts it ({_JAX_CLI})")
    if not args.output.endswith(".pth"):
        raise ValueError(f"--output {args.output!r}: the port writes .pth files; Orbax checkpoints are "
                         f"the JAX package's CLI's ({_JAX_CLI})")
    state = port_state_dict(torch.load(args.input, map_location="cpu", weights_only=True))
    weights = {k: torch.as_tensor(v) for k, v in state.items()}
    torch.save(weights, args.output)
    print(f"wrote {len(weights)} tensors in the reference layout to {args.output}")
    return weights


if __name__ == "__main__":
    main()
