"""Pseudo-label generation entry point of the port (reference
code/generate_pseudo_labels.py; the JAX package's
``hiast_tpu/cli/generate_pseudo_labels.py``).

    python -m hiast_tpu_torch.cli.generate_pseudo_labels \
        --config_file hiast_tpu_torch/configs/sl_1.yaml \
        --pseudo_resume_from .../pseudo_resume_from.pth \
        --pseudo_save_dir .../sl_1/pseudo_label/gray_label [--device cuda|cpu]

``pseudo_policy.type`` picks IAS, CT, NT or CBST (``pseudo/generator.py``);
``pseudo_policy.ms_sizes`` / ``is_flip`` fuse scaled and mirrored views.
Runs on the card by default; ``--device cpu`` runs the plain PyTorch
versions of the kernels (tests).  Under ``torchrun --nproc_per_node=N``
each rank takes its share of every batch (``pseudo/generator.py``).
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from hiast_tpu_torch.cli.common import build_cfg, standard_parser
from hiast_tpu_torch.data.datasets import build_dataset
from hiast_tpu_torch.data.native_ops import host_ops_for
from hiast_tpu_torch.data.pipeline import BatchIterator, prefetched
from hiast_tpu_torch.models.segmentors import build_segmentor
from hiast_tpu_torch.ops.resize import bilinear_resize
from hiast_tpu_torch.parallel import mesh
from hiast_tpu_torch.registry import PSEUDO_POLICY
from hiast_tpu_torch.selftrain.steps import normalize_image
from hiast_tpu_torch.utils.checkpoint import load_weights

INIT_SEED = 0  # the initialisation a checkpoint then overwrites, in whole or in part


def make_forward(cfg, segmentor, device: torch.device):
    """uint8 [B,H,W,3] numpy -> {'full': full-res fp32 NCHW logits, 'low':
    the trunk's own fp32 logits grid (stride 8 for DeepLab, 4 for SegFormer)}.

    The trunk runs under bf16 autocast, as the JAX CLI builds its module in
    bf16; the logits are cast to fp32 before the align_corners=True bilinear
    upsampling.  The 'low' grid feeds threshold statistics when
    ``pseudo_policy.stats_source`` is 'low'; 'full' feeds the selection.

    With ``pseudo_policy.ms_sizes`` / ``is_flip`` (the JAX CLI's fusion):
    the normalised image is resized to each size (not where it is the
    native one), each view's logits are resized to its input and softmaxed,
    a flipped view's probabilities are flipped back and added, the sum is
    resized to the native size and divided by the view count, and both
    outputs are ``log(fused + 1e-12)``, 'low' its [::8, ::8] grid (made
    contiguous: the kernels read contiguous NCHW).
    """
    ms_sizes = [tuple(size) for size in (cfg.pseudo_policy.ms_sizes or [])]
    is_flip = bool(cfg.pseudo_policy.is_flip)

    def probs(img: torch.Tensor) -> torch.Tensor:
        logits = segmentor.raw_apply(img, torch.bfloat16)["logits"].float()
        return torch.softmax(bilinear_resize(logits, img.shape[2], img.shape[3]), dim=1)

    @torch.inference_mode()
    def forward(images: np.ndarray) -> dict:
        x = torch.from_numpy(np.ascontiguousarray(images)).to(device, non_blocking=True)
        img = normalize_image(x)
        h, w = images.shape[1], images.shape[2]
        if not (ms_sizes or is_flip):
            low = segmentor.raw_apply(img, torch.bfloat16)["logits"].float()
            full = bilinear_resize(low, h, w).contiguous()
            return {"full": full, "low": low.contiguous()}
        sizes = ms_sizes or [(h, w)]
        fused = None
        for rh, rw in sizes:
            scaled = bilinear_resize(img, rh, rw)  # no resize at the native size
            p = probs(scaled)
            if is_flip:
                p = p + torch.flip(probs(torch.flip(scaled, dims=[3])), dims=[3])
            p = bilinear_resize(p, h, w)
            fused = p if fused is None else fused + p
        # each softmax sums to 1, so the view count renormalises exactly
        logp = torch.log(fused / (len(sizes) * (2 if is_flip else 1)) + 1e-12)
        return {"full": logp, "low": logp[:, :, ::8, ::8].contiguous()}

    return forward


def main(argv=None):
    args = standard_parser("hiast_tpu_torch pseudo-label generator").parse_args(argv)
    cfg = build_cfg(args)
    with mesh.session(args.device) as device:
        return _generate(cfg, device)


def _generate(cfg, device: torch.device):
    mesh.check_mesh(cfg)
    # the trunk runs in bf16 under autocast; everything in fp32 around it
    # (resize, policy math) is meant at full fp32 precision
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    segmentor = build_segmentor(cfg)
    # seeded first, as the JAX CLI initialises before a partial load: a
    # DeepLab-v2 checkpoint fills only DeepLab-v3+'s trunk
    segmentor.module.init_weights(torch.Generator().manual_seed(INIT_SEED))
    if cfg.pseudo_policy.resume_from:
        load_weights(cfg.pseudo_policy.resume_from, segmentor.module)
    else:
        warnings.warn("no --pseudo_resume_from given: generating from RANDOM weights")
    segmentor.module.to(device).eval()

    h, w = cfg.pseudo_policy.resize_size
    dataset = build_dataset(cfg, "target", aug_type=[f"PRS-{h}-{w}"], host=host_ops_for(device.type))

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
                    share=mesh.share(),
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
