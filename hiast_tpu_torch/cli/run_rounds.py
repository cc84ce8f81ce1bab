"""The self-training round driver of the port (reference code/train.sh; the
JAX package's ``hiast_tpu/cli/run_rounds.py``).

Round k generates pseudo-labels from round k-1's EMA teacher
(``ema_model_last.pth``), then trains the student from round k-1's
``model_last.pth`` through ``train.init_from``: weights only, a fresh
schedule.  Rounds share nothing but files (checkpoints, the pseudo-label
dir, the round statistics).  Re-running the driver after an interruption
resumes instead of redoing finished work: a round whose ``model_last.pth``
is at ``total_iter`` is skipped; one cut off mid-training (the SIGTERM
checkpoint of ``selftrain/trainers.py``) continues from its full state
through ``--resume_from``; generation skips a complete pseudo-label dir and
clears and regenerates a partial one (``pseudo/generator.py:prepare_dirs``).

    python -m hiast_tpu_torch.cli.run_rounds --work_dir ../log/gtav-to-cityscapes/hiast \\
        --warmup_ckpt ../pretrained/resume_from.pth \\
        --warmup_pseudo_ckpt ../pretrained/pseudo_resume_from.pth [--device cuda|cpu]

The configs default to the port's copies in ``hiast_tpu_torch/configs/``
(``sl_<k>.yaml`` with ``hiast_setting.yaml``), read by the port's own YAML
reader.  Runs on the card by default; ``--device cpu`` runs the plain
PyTorch versions of the kernels (tests).  Data-parallel on N GPUs:

    torchrun --nproc_per_node=N -m hiast_tpu_torch.cli.run_rounds ...

with N a divisor of the rounds' ``train.batch_size`` (1, 2, 3 or 6 for the
shipped 6).  Rank 0 takes the skip and resume decisions and every rank
follows them; generation and training run on every rank, with a barrier
between them.
"""
from __future__ import annotations

import argparse
import os

from hiast_tpu_torch.cli import generate_pseudo_labels, train
from hiast_tpu_torch.config import load_config
from hiast_tpu_torch.parallel import mesh
from hiast_tpu_torch.utils.checkpoint import load_step


def _round_total_iter(cfg_file: str, setting: str) -> int:
    """The round's schedule length, from the same config layering that
    ``train.main`` applies (config file + setting overlay)."""
    return int(load_config(cfg_file, setting, freeze=False).train.total_iter)


def main(argv=None):
    p = argparse.ArgumentParser(description="hiast_tpu_torch round driver")
    p.add_argument("--work_dir", required=True)
    p.add_argument("--warmup_ckpt", required=True, help="student warmup checkpoint (.pth)")
    p.add_argument("--warmup_pseudo_ckpt", required=True, help="EMA/pseudo warmup checkpoint (.pth)")
    p.add_argument(
        "--configs_dir",
        default=os.path.join(os.path.dirname(os.path.dirname(__file__)), "configs"),
    )
    p.add_argument("--setting_file", default=None, help="defaults to hiast_setting.yaml")
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument(
        "--device", default="cuda", choices=("cuda", "cpu"),
        help="where generation and training run (cpu: plain PyTorch versions, for tests)",
    )
    args = p.parse_args(argv)

    with mesh.session(args.device):
        _run(args)


def _run(args):
    setting = args.setting_file or os.path.join(args.configs_dir, "hiast_setting.yaml")
    pseudo_ckpt = args.warmup_pseudo_ckpt
    student_ckpt = args.warmup_ckpt

    for k in range(1, args.rounds + 1):
        cfg_file = os.path.join(args.configs_dir, f"sl_{k}.yaml")
        round_dir = os.path.join(args.work_dir, f"sl_{k}")
        pseudo_dir = os.path.join(round_dir, "pseudo_label", "gray_label")
        ckpt_dir = os.path.join(round_dir, "checkpoints")

        # model_last.pth carries the step it was saved at (the end-of-round
        # save and the SIGTERM checkpoint both write it): at total_iter or
        # later the round is done; below it, training continues from the full
        # state (optimizer, EMA, schedule position); no step: a fresh round
        done_step = mesh.broadcast_object(load_step(ckpt_dir, "model_last") if mesh.is_main() else None)
        total_iter = _round_total_iter(cfg_file, setting)
        if done_step is not None and done_step >= total_iter:
            print(f"%% round {k}: training already complete "
                  f"(model_last at step {done_step} >= {total_iter}); skipping")
        else:
            # generation skips a complete dir and regenerates a partial one;
            # when training is mid-round the labels are complete
            generate_pseudo_labels.main([
                "--config_file", cfg_file,
                "--pseudo_resume_from", pseudo_ckpt,
                "--pseudo_save_dir", pseudo_dir,
                "--device", args.device,
            ])
            mesh.barrier()
            if done_step is not None:
                print(f"%% round {k}: resuming interrupted training from "
                      f"step {done_step} (full state)")
                resume_args = ["--resume_from", os.path.join(ckpt_dir, "model_last.pth")]
            else:
                # train.init_from, not --resume_from: round k-1's model_last
                # is a full state at step == total_iter, and resuming it
                # would start round k past its schedule and train nothing
                resume_args = ["train.init_from", student_ckpt]
            train.main([
                "--config_file", cfg_file,
                "--setting_file", setting,
                "--pseudo_save_dir", pseudo_dir,
                "--work_dir", round_dir,
                "--device", args.device,
            ] + resume_args)

        pseudo_ckpt = os.path.join(ckpt_dir, "ema_model_last.pth")
        student_ckpt = os.path.join(ckpt_dir, "model_last.pth")


if __name__ == "__main__":
    main()
