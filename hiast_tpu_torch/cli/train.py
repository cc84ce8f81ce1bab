"""Training entry point of the port (reference code/train.py; the JAX
package's ``hiast_tpu/cli/train.py``).

    python -m hiast_tpu_torch.cli.train --config_file configs/segformer_sl_1.yaml \\
        --pseudo_save_dir .../sl_1/pseudo_label/gray_label --work_dir .../segformer_sl_1 \\
        [--resume_from .../model_last.pth] [--device cuda|cpu]

Runs on the card by default and raises without one; ``--device cpu`` runs
the plain PyTorch versions of the kernels (tests).  ``main`` returns the
trainer.  Data-parallel on N GPUs, each rank a share of the global
``train.batch_size`` (``parallel/mesh.py``):

    torchrun --nproc_per_node=N -m hiast_tpu_torch.cli.train ...
"""
from __future__ import annotations

from hiast_tpu_torch.cli.common import build_cfg, standard_parser
from hiast_tpu_torch.parallel import mesh
from hiast_tpu_torch.registry import TRAINER


def main(argv=None):
    args = standard_parser("hiast_tpu_torch trainer").parse_args(argv)
    cfg = build_cfg(args)
    if not cfg.trainer:
        raise ValueError("no trainer configured: set trainer (e.g. SelfTrainingTrainer)")
    with mesh.session(args.device) as device:
        trainer = TRAINER[cfg.trainer](cfg, device=device)
        trainer.run()
    return trainer


if __name__ == "__main__":
    main()
