"""Pseudo-label generation entry point of the port (reference
code/generate_pseudo_labels.py; the JAX package's
``hiast_tpu/cli/generate_pseudo_labels.py``).

    python -m hiast_tpu_torch.cli.generate_pseudo_labels --config_file configs/sl_1.yaml \
        --pseudo_resume_from .../pseudo_resume_from.pth \
        --pseudo_save_dir .../sl_1/pseudo_label/gray_label [--device cuda|cpu]

Runs on the card by default; ``--device cpu`` runs the plain PyTorch
versions of the kernels (tests).
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from hiast_tpu_torch.cli.common import build_cfg, resolve_device, standard_parser
from hiast_tpu_torch.data.datasets import build_dataset
from hiast_tpu_torch.data.png import unfilter_for
from hiast_tpu_torch.data.pipeline import BatchIterator, prefetched
from hiast_tpu_torch.models.segmentors import build_segmentor
from hiast_tpu_torch.ops.resize import bilinear_resize
from hiast_tpu_torch.registry import PSEUDO_POLICY
from hiast_tpu_torch.selftrain.steps import normalize_image
from hiast_tpu_torch.utils.checkpoint import load_weights

INIT_SEED = 0  # random weights when no checkpoint is given


def make_forward(cfg, segmentor, device: torch.device):
    """uint8 [B,H,W,3] numpy -> {'full': full-res fp32 NCHW logits, 'low':
    the trunk's own fp32 logits grid (stride 8 for DeepLab, 4 for SegFormer)}.

    The trunk runs under bf16 autocast, as the JAX CLI builds its module in
    bf16; the logits are cast to fp32 before the align_corners=True bilinear
    upsampling.  The 'low' grid feeds threshold statistics when
    ``pseudo_policy.stats_source`` is 'low'; 'full' feeds the selection.
    """
    if cfg.pseudo_policy.ms_sizes or cfg.pseudo_policy.is_flip:
        raise NotImplementedError(
            "multi-scale / flip generation (pseudo_policy.ms_sizes, is_flip) is "
            "ROADMAP.md item A4: not ported yet"
        )

    @torch.inference_mode()
    def forward(images: np.ndarray) -> dict:
        x = torch.from_numpy(np.ascontiguousarray(images)).to(device, non_blocking=True)
        low = segmentor.raw_apply(normalize_image(x), torch.bfloat16)["logits"].float()
        full = bilinear_resize(low, images.shape[1], images.shape[2]).contiguous()
        return {"full": full, "low": low.contiguous()}

    return forward


def main(argv=None):
    args = standard_parser("hiast_tpu_torch pseudo-label generator").parse_args(argv)
    cfg = build_cfg(args)
    device = resolve_device(args.device)
    # the trunk runs in bf16 under autocast; everything in fp32 around it
    # (resize, policy math) is meant at full fp32 precision
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    segmentor = build_segmentor(cfg)
    if cfg.pseudo_policy.resume_from:
        load_weights(cfg.pseudo_policy.resume_from, segmentor.module)
    else:
        warnings.warn("no --pseudo_resume_from given: generating from RANDOM weights")
        segmentor.module.init_weights(torch.Generator().manual_seed(INIT_SEED))
    segmentor.module.to(device).eval()

    h, w = cfg.pseudo_policy.resize_size
    dataset = build_dataset(cfg, "target", aug_type=[f"PRS-{h}-{w}"], unfilter=unfilter_for(device.type))

    def data_iter_factory():
        # shuffle=True matches the reference IAS pass (online thresholds see
        # a random batch order, pseudo_label_generator.py:36)
        return prefetched(
            iter(
                BatchIterator(
                    dataset,
                    cfg.pseudo_policy.batch_size,
                    shuffle=True,
                    seed=cfg.train.random_seed,
                    drop_last=False,
                )
            ),
            depth=2,
        )

    generator = PSEUDO_POLICY[cfg.pseudo_policy.type](
        cfg, make_forward(cfg, segmentor, device), data_iter_factory,
        expected_count=len(dataset), device=device,
    )
    generator.run()
    return generator


if __name__ == "__main__":
    main()
