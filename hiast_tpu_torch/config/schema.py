"""Default config schema (the port's own copy of ``hiast_tpu/config/schema.py``).

Mirrors the reference yacs tree (reference: code/utils/default_config.py:1-182)
key-for-key so the reference's YAML experiment configs stay loadable, and
keeps the JAX package's ``runtime`` section so one YAML file drives both
packages.  Keys that only steer the TPU build are accepted and ignored by the
port; each says so at its definition.
"""
from __future__ import annotations

from hiast_tpu_torch.config.node import BOOL_OR_BOOL_LIST_KEYS, ConfigNode

# runtime.fused_attention accepts one bool OR a 4-list of per-stage flags
# (see the schema comment at the key); register it so YAML overlays and
# CLI overrides can set either form.
BOOL_OR_BOOL_LIST_KEYS.add("runtime.fused_attention")


def default_config() -> ConfigNode:
    return ConfigNode(
        {
            "trainer": None,
            "work_dir": "./",
            # ==============================================================
            # model and loss
            # ==============================================================
            "model": {
                "type": None,
                "is_freeze_bn": True,  # True after source-only training
                "seg_model": {
                    "type": "DeepLab_V2",
                    "output_dim": 256,  # embedding head dim
                    "pretrained": None,  # path to ImageNet R101 weights (.pth or .npz)
                    "backbone_layers": [3, 4, 23, 3],  # ResNet-101 block depths
                },
                "predictor": {
                    "seg_loss": {
                        "type": "CE",
                        "source_weight": 1.0,
                        "target_pseudo_weight": 1.0,
                    },
                    # KLD-to-uniform smoothing on the confident (pseudo-labeled) region
                    "kld_loss": {"weight": 0.1},
                    # entropy sharpening: all region for adversarial, ignored region for self-training
                    "ent_loss": {"weight": 3.0},
                },
                "discriminator": {
                    "is_enabled": False,
                    "is_entropy_input": False,  # AdvEnt-style entropy map input
                    "lr": 1e-4,
                    "D_loss": {"type": "MSE", "weight": 1.0, "adv_weight": 0.05},
                },
            },
            # ==============================================================
            # dataset
            # ==============================================================
            "dataset": {
                "num_classes": 19,  # 19 for GTAV/SYNTHIA->Cityscapes, 9 for Cityscapes->Oxford
                "num_workers": 2,
                "source": {
                    "type": None,  # 'GTAV', 'SYNTHIA', 'Cityscapes'
                    "json_path": None,
                    "image_dir": None,
                    "aug_type": [],
                },
                "target": {
                    "type": None,  # 'Cityscapes', 'Oxford'
                    "json_path": None,
                    "image_dir": None,
                    "pseudo_dir": None,
                    "aug_type": [],
                },
                "val": {
                    "type": None,
                    "json_path": None,
                    "image_dir": None,
                    "resize_size": None,  # [height, width]
                },
                # fixed train-time crop target [height, width]; the geometric
                # aug resizes every random crop to this static shape so a
                # single XLA compilation covers the whole run.
                "crop_size": [512, 1024],
            },
            # ==============================================================
            # pseudo-label generation
            # ==============================================================
            "pseudo_policy": {
                "resume_from": None,
                "batch_size": 2,
                "resize_size": None,  # [height, width]
                # OPTIONAL multi-scale + flip fusion for generation (no
                # reference analog — its generator is single-scale,
                # pseudo_label_generator.py:30; the validator's MS/flip
                # machinery applied to pseudo-labels): probabilities are
                # softmax-fused over scales (+ mirrored views) before
                # IAS selection.  None/[] = single scale (parity).
                "ms_sizes": None,  # [[height, width], ...]
                "is_flip": False,
                "save_dir": None,
                "type": None,  # 'IAS', 'CBST', 'CT', 'NT'
                "ias": {"alpha": 0.2, "beta": 0.9, "gamma": 8.0},
                # NOTE: the reference's cbst.sample_interval (a memory bound on
                # its host-side sampled probability store) is superseded by the
                # on-device histogram quantiles (num_hist_bins below) and is
                # dropped by the loader with a warning.
                "cbst": {"p": 0.2},
                "ct": {"threshold": 0.9},
                # on-device quantile fidelity: number of histogram bins over
                # [0, 1] for max-probability quantiles (4.9e-4 resolution at
                # 2048 matches the reference's float16 prob storage).
                "num_hist_bins": 2048,
                # where threshold statistics are computed: 'full' = every
                # output pixel (exact reference parity — the DEFAULT, per the
                # project invariant: parity defaults, fast modes opt-in);
                # 'low' = the OS8 logits grid (64x fewer pixels; the full-res
                # probabilities are bilinear interpolations of these, so the
                # per-class quantiles are statistically equivalent — measured
                # in tests/test_pseudo.py low-vs-full equivalence — and the
                # stats pass is ~10x faster).
                "stats_source": "full",
                # JAX package only: route IAS through its Pallas kernels.
                # The port always runs its CUDA kernels (ops/cuda/
                # select_kernel.py) on a card, so this key does nothing here.
                "use_pallas_select": False,
                # JAX package only: 5-bit pack the label maps before the
                # device-to-host fetch.  The port fetches uint8 maps as they
                # are, so this key does nothing here.
                "pack_d2h": True,
            },
            # ==============================================================
            # training
            # ==============================================================
            "train": {
                "batch_size": 4,  # GLOBAL batch, sharded over the data mesh axis
                "lr": 1e-4,  # backbone lr; heads use 10x (DeepLab_V2 convention)
                "optimizer": "Adam",  # 'SGD', 'Adam', 'AdamW'
                "weight_decay": 5e-4,
                # resume_from: FULL-state resume when the path is an Orbax dir
                # carrying step/opt_state (preemption recovery; a superset of
                # the reference), weights-only for .pth files.
                "resume_from": None,
                # init_from: ALWAYS weights-only (params + batch_stats) — the
                # reference's cross-round `resume_from` semantics
                # (code/train.sh hands round k-1's checkpoint to round k,
                # which trains a FRESH total_iter schedule).  run_rounds uses
                # this so a completed round's full-state model_last doesn't
                # resume round k at step == total_iter (zero iterations).
                "init_from": None,
                "random_seed": 888,
                "is_save_all": False,
                # vestigial in the reference too (default_config.py:114 — set,
                # never read); kept so reference YAMLs load, never consumed.
                "is_debug": False,
                "total_iter": 10000,
                "iter_report": 100,
                "iter_val": 400,
                # where the losses are computed: 'full' upsamples logits to
                # input resolution first (exact reference semantics,
                # self_training_segmentor.py:27); 'os8' computes them on the
                # stride-8 logits grid against nearest-downsampled labels
                # (statistically equivalent objective; measured neutral on
                # throughput at batch 8 — XLA fuses the full-res losses —
                # see PERF.md ablation).
                "loss_resolution": "full",
                "lr_scheduler": {
                    "type": "Cosine",  # 'Cosine', 'Poly'
                    "poly": {"power": 0.9},
                },
            },
            # ==============================================================
            # validation
            # ==============================================================
            "validate": {
                "resume_from": None,
                "resize_sizes": [],  # [[height, width], ...] multi-scale
                "is_flip": False,
                "batch_size": 2,
                "color_mask_dir_path": None,
            },
            # ==============================================================
            # consistency (EMA-teacher) training
            # ==============================================================
            "cst_training": {
                "is_enabled": False,
                "ema_model": {"iter_update": 1, "gamma": 0.999},
                "cst_loss": {
                    "type": "SoftCE",
                    "weight": 1.0,
                    "region": "ignored",  # 'confident', 'ignored', 'all'
                },
                # directional consistency on copy-pasted regions (realizes
                # the reference's commented-out surface,
                # self_training_segmentor.py:63-125; off by default — the
                # reference never enables it either)
                "dcst_loss": {"weight": 0.0},
            },
            # ==============================================================
            # mutual training (vestigial in the reference; kept for parity)
            # ==============================================================
            "mut_training": {
                "is_enabled": False,
                "resume_from": None,
                "is_strong_input": False,
                "mut_loss": {"weight": 0.1, "region": "ignored"},
            },
            # ==============================================================
            # preprocessors (hard-aware pseudo-label augmentation)
            # ==============================================================
            "preprocessor": {
                "type": None,  # 'CopyPaste'
                "copy_paste": {
                    "mode": "original",  # only supported mode (asserted, as in the reference)
                    # vestigial in the reference too (default_config.py:174 —
                    # set, never read); kept so reference YAMLs load.
                    "name": "normal",
                    "selected_num_classes": 14,  # number of hard classes per image
                    "gamma": 0.99,  # EMA factor for class mean probabilities
                    "max_donors": 3,  # donor images pasted per sample
                },
            },
            # ==============================================================
            # TPU runtime (new; replaces gpu_num/port/apex_opt).  The port
            # takes its device from the CLI's --device flag and reads
            # checkpoint.keep, precision.compute_dtype (the autocast dtype),
            # skip_nonfinite_updates and remat/remat_mode (models/remat.py,
            # torch.utils.checkpoint), and fused_attention is checked for
            # its shape; the rest is the JAX package's only.
            # ==============================================================
            "runtime": {
                "mesh": {
                    "data": -1,  # -1 = all devices on the data axis
                    # spatial partitioning: shard image ROWS over this many
                    # chips (GSPMD emits the conv halo exchanges) — lets one
                    # global batch train at resolutions beyond one chip's HBM
                    "space": 1,
                    "model": 1,
                },
                "precision": {
                    "compute_dtype": "bfloat16",  # activations / matmuls
                    "param_dtype": "float32",  # master params
                },
                # rematerialize activations in the backward pass
                # (torch.utils.checkpoint): a train step reruns the trunk's
                # forward, or each block's, to hold less activation memory.
                "remat": False,
                # how to remat when enabled: 'full' (whole trunk) | 'dots'
                # (keep the Linear products, rerun the rest) | 'blocks' /
                # 'blocks_dots' (per SegFormer block; 'full' on trunks
                # without blocks).  Peak memory and s/iter of each mode on
                # the card: PERF.md (chip_smoke.py's remat phase).
                "remat_mode": "full",
                # JAX package only: route SegFormer stages through its
                # Pallas attention kernel (one bool, or a 4-list of
                # per-stage flags).  The port checks the shape of the value
                # and selects nothing: on a card every stage runs its CUDA
                # SRA kernel (ops/cuda/attention.py).
                "fused_attention": False,
                # skip the optimizer update (keep params/opt state) on steps
                # whose loss or gradients are non-finite, instead of letting
                # one bad batch poison the run
                "skip_nonfinite_updates": False,
                # log imgs/s + MFU in the training report (one extra
                # cache-hit AOT compile at startup for the FLOPs count)
                "report_mfu": True,
                "checkpoint": {
                    # with train.is_save_all: prune per-iteration checkpoints
                    # beyond the newest `keep` (last/best/mid are always kept)
                    "keep": 3,
                },
                "profile": {
                    "enabled": False,
                    "start_iter": 50,
                    "num_iters": 5,
                },
            },
        }
    )
