"""Standalone evaluation entry point of the port (reference code/validate.py;
the JAX package's ``hiast_tpu/cli/validate.py``).

    python -m hiast_tpu_torch.cli.validate --config_file configs/validate.yaml \\
        --validate_resume_from .../HIAST_final.pth [--device cuda|cpu]

Runs on the card by default, the trunk under bf16 autocast as the JAX CLI
builds its module in bf16; ``--device cpu`` runs the plain PyTorch versions
of the kernels (tests).  Prints one report line: mIoU and the per-class IoU,
or the SYNTHIA 16/13-class mIoU when ``dataset.source.type`` is SYNTHIA.
``main`` returns the JAX CLI's result dict plus ``seconds``, the host time of
the batch loop.  Under ``torchrun --nproc_per_node=N`` each rank validates
its share of every batch and the IoU areas are summed over the ranks
(``evaluation.py``); rank 0 prints.
"""
from __future__ import annotations

import torch

from hiast_tpu_torch.cli.common import build_cfg, standard_parser
from hiast_tpu_torch.data.datasets import build_dataset
from hiast_tpu_torch.data.native_ops import host_ops_for
from hiast_tpu_torch.data.pipeline import BatchIterator, prefetched
from hiast_tpu_torch.evaluation import Validator
from hiast_tpu_torch.models.segmentors import build_segmentor
from hiast_tpu_torch.parallel import mesh
from hiast_tpu_torch.utils.checkpoint import load_weights


def main(argv=None):
    args = standard_parser("hiast_tpu_torch validator").parse_args(argv)
    cfg = build_cfg(args)
    with mesh.session(args.device) as device:
        return _validate(cfg, device)


def _validate(cfg, device: torch.device) -> dict:
    mesh.check_mesh(cfg)
    # the trunk runs in bf16 under autocast; the resizes, softmax and fusion
    # around it are meant at full fp32 precision
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    if not cfg.validate.resume_from:
        raise ValueError("--validate_resume_from (or validate.resume_from) required")
    segmentor = build_segmentor(cfg)
    load_weights(cfg.validate.resume_from, segmentor.module)
    segmentor.module.to(device).eval()

    dataset = build_dataset(cfg, "val", aug_type=[], host=host_ops_for(device.type))
    # a daemon thread decodes the next batches while the card runs this one
    batches = BatchIterator(dataset, cfg.validate.batch_size, shuffle=False, drop_last=False, share=mesh.share())
    validator = Validator(cfg, segmentor, device)
    result = validator.run(prefetched(iter(batches), depth=2), target=batches.local_size)
    result["seconds"] = validator.run_seconds
    iou_str = {c: round(float(v), 4) for c, v in enumerate(result["iou"])}
    if mesh.is_main():
        if "miou_16" in result:
            print(f"miou_16: {result['miou_16']:.4f}, miou_13: {result['miou_13']:.4f}, iou: {iou_str}")
        else:
            print(f"miou: {result['miou']:.4f}, iou: {iou_str}")
    return result


if __name__ == "__main__":
    main()
