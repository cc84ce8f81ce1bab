"""Shared CLI plumbing: arg parsing, config layering, device choice."""
from __future__ import annotations

import argparse

import torch

from hiast_tpu_torch.config import apply_cli_overrides, load_config
from hiast_tpu_torch.registry import populate


def standard_parser(description: str) -> argparse.ArgumentParser:
    """The reference's CLI surface (reference code/train.py:18-28) plus
    ``--device``: entry points run on the card unless told otherwise."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--config_file", default=None, help="experiment yaml")
    p.add_argument("--setting_file", default=None, help="overlay yaml (e.g. hiast_setting.yaml)")
    p.add_argument("--resume_from", default=None)
    p.add_argument("--pseudo_resume_from", default=None)
    p.add_argument("--pseudo_save_dir", default=None)
    p.add_argument("--work_dir", default=None)
    p.add_argument("--seg_model", default=None)
    p.add_argument("--validate_resume_from", default=None)
    p.add_argument(
        "--device", default="cuda", choices=("cuda", "cpu"),
        help="where the model and kernels run (cpu: plain PyTorch versions, for tests)",
    )
    p.add_argument("opts", nargs="*", help="extra key value overrides")
    return p


def build_cfg(args):
    populate()
    cfg = load_config(args.config_file, args.setting_file, freeze=False)
    cfg = apply_cli_overrides(cfg, args)
    if args.opts:
        cfg.merge_from_list(args.opts)
    cfg.freeze()
    return cfg


def resolve_device(name: str) -> torch.device:
    """The requested device; a request for the card fails when there is none
    (nothing moves to the CPU unasked)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda was requested but torch sees no CUDA device; "
            "pass --device cpu to run the plain PyTorch path"
        )
    return device
