"""One rank of tests/test_torch_space_parallel.py's two-rank gloo group at
``data=1, space=2``: each rank holds one slab of every image's rows.

    python tests/torch_space_worker.py RANK STORE IN_DIR OUT_DIR

joins a ``gloo`` group through the ``file://`` store STORE, arranges it as
one data index of two space ranks, runs every scenario on its slab of the
inputs the test writes to IN_DIR (the CLIs' arguments in ``argv.pt``
first, the JAX variables and draws in ``inputs.pt`` when they are ready)
and writes its results to ``OUT_DIR/rank{RANK}.pt``.  It imports the port
only.  The test process calls the same scenario functions without a
process group, on whole images: the world-1 runs.
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_dp_worker as dp  # noqa: E402

from hiast_tpu_torch.data.pipeline import BatchIterator  # noqa: E402
from hiast_tpu_torch.models.norm import convert_synced  # noqa: E402
from hiast_tpu_torch.models.segmentors import build_segmentor  # noqa: E402
from hiast_tpu_torch.parallel import mesh, spatial  # noqa: E402
from hiast_tpu_torch.registry import PSEUDO_POLICY, populate  # noqa: E402
from hiast_tpu_torch.selftrain import steps as S  # noqa: E402
from hiast_tpu_torch.selftrain.train_state import lr_schedule, make_optimizer  # noqa: E402

SPACE = 2
B, H, W = 2, 64, 128  # the consistency step's batch (tests/test_torch_consistency_step.py's)
SEG_H, SEG_W = 64, 128  # SegFormer-B0: 32 rows a slab, the deepest stage's one row
SEGFORMER = {"model.type": "SelfTrainingSegmentor", "model.seg_model.type": "SegFormer_B0",
             "model.is_freeze_bn": False, "train.optimizer": "SGD", "train.lr": 1.0, "train.weight_decay": 0.0,
             "train.total_iter": 50, "train.lr_scheduler.type": "Cosine"}


def rows(t, dim: int = 1):
    """This rank's slab of ``t``'s rows (the whole of it without a group)."""
    return mesh.local_rows(t, dim)


def sharded():
    return spatial.sharded_rows(mesh.space_group())


def _model(cfg, state_dict=None, seed: int = 0):
    segmentor = build_segmentor(cfg)
    if state_dict is None:
        segmentor.module.init_weights(torch.Generator().manual_seed(seed))
    else:
        segmentor.module.load_state_dict(state_dict)
    convert_synced(segmentor.module)
    if mesh.space_size() > 1:
        spatial.convert_spatial(segmentor.module)
    return segmentor


def consistency_step(state_dict: dict, batch: dict, draws) -> dict:
    """One consistency step with CCA on the card's path, its draws
    injected (``draws``: the JAX step's, as ``ColorAugDraws``)."""
    cfg = dp.port_cfg(dp.SELF_TRAINING)
    segmentor = _model(cfg, state_dict)
    ema = _model(cfg, state_dict).module.requires_grad_(False)
    optimizer = make_optimizer(cfg, segmentor.module)
    drawn = S.draw_color_aug
    S.draw_color_aug = lambda b, kind, generator: draws
    try:
        step = S.make_consistency_step(segmentor, ema, optimizer, lr_schedule(cfg), torch.float32, strong_aug="CCA",
                                       generator=torch.Generator())
        with sharded():
            losses = step({k: rows(torch.from_numpy(batch[k])) for k in ("t_img", "t_plbl")}, S.StepCount())
    finally:
        S.draw_color_aug = drawn
    return dp._snapshot({"": segmentor.module, "ema.": ema}, losses, full=("",))


def segformer_forward(state_dict: dict, img: np.ndarray) -> torch.Tensor:
    """The B0 eval forward's logits, this rank's rows."""
    cfg = dp.port_cfg(SEGFORMER)
    segmentor = _model(cfg, state_dict)
    segmentor.module.eval()
    with torch.no_grad(), sharded():
        return S.make_eval_forward(segmentor, torch.float32)(rows(torch.from_numpy(img)))


def segformer_step(batch: dict, remat: bool = False) -> dict:
    """One plain self-training step of a seeded B0 (the plain B3/B4 on the
    CPU); with ``remat`` under 'blocks' remat, each block's halos and
    gather issued again in the backward."""
    cfg = dp.port_cfg({**SEGFORMER, "runtime.remat": remat, "runtime.remat_mode": "blocks"})
    segmentor = _model(cfg)
    optimizer = make_optimizer(cfg, segmentor.module)
    step = S.make_self_training_step(segmentor, optimizer, lr_schedule(cfg), torch.float32)
    with sharded():
        losses = step({k: rows(torch.from_numpy(batch[k])) for k in ("t_img", "t_plbl")}, S.StepCount())
    return dp._snapshot({"": segmentor.module}, losses)


def segformer_batch(seed: int = 5) -> dict:
    rng = np.random.default_rng(seed)
    lbl = rng.integers(0, dp.C, size=(B, SEG_H, SEG_W))
    lbl[rng.random(lbl.shape) < 0.3] = 255
    return {"t_img": rng.integers(0, 256, size=(B, SEG_H, SEG_W, 3)).astype(np.uint8),
            "t_plbl": lbl.astype(np.uint8)}


def generate(save_dir: str) -> dict:
    """IAS over tests/torch_dp_worker.py's index images with injected
    logits, each rank on its slab of their rows."""
    populate()
    table = torch.from_numpy(dp.gen_logits())

    def forward(images):
        full = table[torch.from_numpy(np.ascontiguousarray(images[:, 0, 0, 0])).long()]
        local = rows(full, 2).contiguous()
        return {"full": local, "low": local}

    def batches():
        return iter(BatchIterator(dp.IndexImages(dp.GEN_IMAGES, dp.GEN_H, dp.GEN_W), dp.GEN_BATCH, shuffle=False,
                                  drop_last=False, share=mesh.share()))

    gen = PSEUDO_POLICY["IAS"](dp.generator_cfg("IAS", save_dir), forward, batches, expected_count=dp.GEN_IMAGES,
                               device="cpu")
    with sharded():
        gen.run()
    return {"class_threshold": gen.class_threshold, "class_mean_probs": gen.class_mean_probs}


def validate() -> dict:
    with sharded():
        return dp.validate()


def ms_flip_predictions(state_dict: dict, img: np.ndarray) -> torch.Tensor:
    """The float32 multi-scale/flip validation step's predictions on a tiny
    DeepLab-v2, this rank's rows."""
    from hiast_tpu_torch.evaluation import make_ms_flip_step

    segmentor = _model(dp.port_cfg(dp.SELF_TRAINING), state_dict)
    segmentor.module.eval()
    step = make_ms_flip_step(segmentor, [(64, 128), (32, 64)], True, dp.C, torch.float32)
    labels = torch.zeros(img.shape[:3], dtype=torch.int64)
    with sharded():
        return step(rows(torch.from_numpy(img)), rows(labels))[0]


def cli_runs(argv: dict) -> dict:
    """The generation, validation and training CLIs with ``argv``'s
    arguments (``runtime.mesh.space`` among them at world 2)."""
    from hiast_tpu_torch.cli import generate_pseudo_labels, train
    from hiast_tpu_torch.cli import validate as cli_validate

    gen = generate_pseudo_labels.main(argv["generate"])
    result = cli_validate.main(argv["validate"])
    out = {"thresholds": gen.class_threshold, "cmp": gen.class_mean_probs, "iou": result["iou"]}
    if "train" in argv:
        trainer = train.main(argv["train"])
        out["train"] = {"losses": trainer.loss_log, "step": trainer.step, "sums": dp.sums(trainer.segmentor.module)}
    return out


def wait_for(path: str, seconds: float = 300):
    deadline = time.monotonic() + seconds
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {path}")
        time.sleep(0.05)
    return torch.load(path, weights_only=False)


def main(argv):
    rank, store, in_dir, out_dir = argv
    torch.set_num_threads(2)
    os.environ.update({"RANK": rank, "WORLD_SIZE": str(SPACE), "LOCAL_RANK": rank, "LOCAL_WORLD_SIZE": str(SPACE)})
    mesh.init("cpu", init_method=f"file://{store}")
    mesh.set_space(SPACE)
    out = {
        "space": (mesh.space_index(), mesh.space_size(), mesh.data_index(), mesh.data_size()),
        "ias": generate(os.path.join(out_dir, "ias", "pseudo_label", "gray_label")),
        "validation": validate(),
        "cli": cli_runs(wait_for(os.path.join(in_dir, "argv.pt"))),
        "segformer_step": segformer_step(segformer_batch()),
        "segformer_remat": segformer_step(segformer_batch(), remat=True),
    }
    inputs = wait_for(os.path.join(in_dir, "inputs.pt"))  # the JAX variables and draws
    out["consistency"] = consistency_step(inputs["state_dict"], inputs["batch"], inputs["draws"])
    out["segformer_forward"] = segformer_forward(inputs["b0_state_dict"], inputs["b0_img"])
    out["ms_flip"] = ms_flip_predictions(inputs["state_dict"], inputs["val_img"])
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    mesh.destroy()


if __name__ == "__main__":
    main(sys.argv[1:])
