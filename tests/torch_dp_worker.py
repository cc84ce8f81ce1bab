"""One rank of tests/test_torch_data_parallel.py's two-rank gloo group.

    python tests/torch_dp_worker.py RANK WORLD STORE IN_DIR OUT_DIR

joins a ``gloo`` group through the ``file://`` store STORE, runs every
scenario on its share of the inputs that the test writes to IN_DIR (the
training CLI's arguments in ``train_argv.pt`` first, the JAX variables in
``inputs.pt`` when they are ready) and writes its results to
``OUT_DIR/rank{RANK}.pt``.  It
imports the port only.  The test process calls the same scenario functions
without a process group, on the whole global batch: the world-1 runs.
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from hiast_tpu_torch.config import default_config
from hiast_tpu_torch.data.pipeline import BatchIterator
from hiast_tpu_torch.evaluation import run_validation
from hiast_tpu_torch.models.deeplab_v3plus import PooledBatchNorm
from hiast_tpu_torch.models.norm import SyncBatchNorm2d, convert_synced
from hiast_tpu_torch.models.segmentors import build_segmentor
from hiast_tpu_torch.ops.metrics import intersection_and_union
from hiast_tpu_torch.parallel import mesh
from hiast_tpu_torch.registry import PSEUDO_POLICY, populate
from hiast_tpu_torch.selftrain.steps import (
    StepCount,
    make_adversarial_step,
    make_consistency_step,
    make_mutual_step,
    make_source_only_step,
)
from hiast_tpu_torch.selftrain.train_state import lr_schedule, lr_schedule_for_d, make_d_optimizer, make_optimizer

LAYERS = [1, 1, 1, 1]
GLOBAL_B, H, W = 4, 64, 128
C = 19
GEN_IMAGES, GEN_BATCH, GEN_H, GEN_W = 5, 4, 24, 32  # the last batch leaves rank 1 all padding
VAL_IMAGES, VAL_BATCH, VAL_H, VAL_W = 5, 4, 16, 24

_COMMON = {
    "model.seg_model.backbone_layers": LAYERS,
    "model.predictor.ent_loss.weight": 1.0,
    "train.optimizer": "SGD",
    "train.lr": 1.0,
    "train.weight_decay": 0.0,
    "train.total_iter": 50,
    "train.lr_scheduler.type": "Cosine",
}
# tests/test_torch_warmup_step.py's and tests/test_torch_mutual.py's settings
SOURCE_ONLY = {**_COMMON, "model.type": "SourceOnlySegmentor", "model.is_freeze_bn": False}
ADVERSARIAL = {
    **_COMMON, "model.type": "AdversarialWarmupSegmentor", "model.is_freeze_bn": False,
    "model.discriminator.is_enabled": True, "model.discriminator.lr": 5e-4,
    "model.discriminator.D_loss.type": "MSE", "model.discriminator.D_loss.adv_weight": 0.05,
}
SELF_TRAINING = {
    **_COMMON, "model.type": "SelfTrainingSegmentor", "model.is_freeze_bn": True,
    "cst_training.is_enabled": True, "cst_training.cst_loss.type": "SoftCE",
    "cst_training.cst_loss.weight": 0.5, "cst_training.cst_loss.region": "ignored",
    "cst_training.ema_model.gamma": 0.5,
}
MUTUAL = {**SELF_TRAINING, "mut_training.is_enabled": True, "mut_training.mut_loss.weight": 0.5,
          "mut_training.is_strong_input": True, "runtime.skip_nonfinite_updates": True}


def configure(cfg, settings: dict):
    for key, value in settings.items():
        node = cfg
        *path, leaf = key.split(".")
        for part in path:
            node = getattr(node, part)
        setattr(node, leaf, value)
    return cfg


def port_cfg(settings: dict):
    populate()
    return configure(default_config(), settings)


def local(t):
    """This rank's rows of a global batch."""
    return t[mesh.local_share(t.shape[0])]


def step_batch(seed: int = 3, h: int = H // 2, w: int = W // 2) -> dict:
    """A global batch of every key the steps read (at 32x64 for the steps
    held against the port's own world-1 steps)."""
    rng = np.random.default_rng(seed)
    lbl = rng.integers(0, C, size=(GLOBAL_B, h, w))
    lbl[rng.random((GLOBAL_B, h, w)) < 0.4] = 255
    img = lambda: rng.integers(0, 256, size=(GLOBAL_B, h, w, 3)).astype(np.uint8)  # noqa: E731
    return {"s_img": img(), "t_img": img(), "t_img_strong": img(), "s_lbl": lbl.astype(np.uint8),
            "t_plbl": lbl.astype(np.uint8)}


def sums(module) -> torch.Tensor:
    """The float64 sum of each ``state_dict`` entry: equal on two ranks whose
    weights and buffers are."""
    return torch.stack([t.detach().double().sum() for t in module.state_dict().values()])


def _snapshot(modules: dict, losses: dict, full: tuple = ()) -> dict:
    """The step's losses, every buffer, each module's ``sums`` and, on rank
    0 (the gradients are summed over the ranks), every gradient; the
    parameters only of the modules named in ``full``.  The workers write
    this to disk, so it holds no more than the tests compare."""
    out = {"losses": {k: float(v) for k, v in losses.items()}}
    for prefix, module in modules.items():
        out[f"{prefix}sums"] = sums(module)
        for name, p in module.named_parameters():
            if prefix in full:
                out[f"{prefix}param.{name}"] = p.detach().clone()
            if p.grad is not None and mesh.is_main():
                out[f"{prefix}grad.{name}"] = p.grad.detach().clone()
        for name, b in module.named_buffers():
            out[f"{prefix}buffer.{name}"] = b.clone()
    return out


def consistency_step(settings: dict, state_dict: dict, batch: dict) -> dict:
    """One consistency step (strong view injected) from ``state_dict``."""
    cfg = port_cfg(settings)
    segmentor = build_segmentor(cfg)
    segmentor.module.load_state_dict(state_dict)
    ema = build_segmentor(cfg).module
    ema.load_state_dict(state_dict)
    ema.requires_grad_(False)
    convert_synced(segmentor.module)
    optimizer = make_optimizer(cfg, segmentor.module)
    step = make_consistency_step(segmentor, ema, optimizer, lr_schedule(cfg), torch.float32, strong_aug=None)
    losses = step({k: local(torch.from_numpy(batch[k])) for k in ("t_img", "t_img_strong", "t_plbl")}, StepCount())
    return _snapshot({"": segmentor.module, "ema.": ema}, losses)


def _seeded(cfg, seed: int):
    segmentor = build_segmentor(cfg)
    segmentor.module.init_weights(torch.Generator().manual_seed(seed))
    return segmentor


def source_only_step(batch: dict) -> dict:
    cfg = port_cfg(SOURCE_ONLY)
    segmentor = _seeded(cfg, 0)
    convert_synced(segmentor.module)
    optimizer = make_optimizer(cfg, segmentor.module)
    step = make_source_only_step(segmentor, optimizer, lr_schedule(cfg), torch.float32)
    losses = step({k: local(torch.from_numpy(batch[k])) for k in ("s_img", "s_lbl")}, StepCount())
    return _snapshot({"": segmentor.module}, losses)


def adversarial_step(batch: dict) -> dict:
    cfg = port_cfg(ADVERSARIAL)
    segmentor = _seeded(cfg, 0)
    segmentor.discriminator.init_weights(torch.Generator().manual_seed(7))
    convert_synced(segmentor.module)
    optimizer, d_optimizer = make_optimizer(cfg, segmentor.module), make_d_optimizer(cfg, segmentor.discriminator)
    step = make_adversarial_step(segmentor, optimizer, lr_schedule(cfg), d_optimizer, lr_schedule_for_d(cfg),
                                 torch.float32)
    losses = step({k: local(torch.from_numpy(batch[k])) for k in ("s_img", "s_lbl", "t_img")}, StepCount())
    return _snapshot({"": segmentor.module, "d.": segmentor.discriminator}, losses, full=("d.",))


def mutual_step(batch: dict) -> dict:
    """The mutual step on two CCA strong views drawn on the CPU."""
    cfg = port_cfg(MUTUAL)
    segmentor, peer = _seeded(cfg, 0), _seeded(cfg, 13).module
    for m in (segmentor.module, peer):
        convert_synced(m)
    optimizer, peer_optimizer = make_optimizer(cfg, segmentor.module), make_optimizer(cfg, peer)
    step = make_mutual_step(segmentor, peer, optimizer, peer_optimizer, lr_schedule(cfg), torch.float32,
                            strong_aug="CCA", generator=torch.Generator().manual_seed(5))
    losses = step({k: local(torch.from_numpy(batch[k])) for k in ("t_img", "t_plbl")}, StepCount())
    return _snapshot({"": segmentor.module, "peer.": peer}, losses)


def remat_step(state_dict: dict, batch: dict) -> dict:
    """The consistency step under whole-trunk remat."""
    return consistency_step({**SELF_TRAINING, "runtime.remat": True, "runtime.remat_mode": "full"},
                            state_dict, batch)


def bn_inputs(seed: int = 11) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "x": torch.from_numpy((30.0 + rng.normal(size=(GLOBAL_B, 8, 6, 5))).astype(np.float32)),
        "dy": torch.from_numpy(rng.normal(size=(GLOBAL_B, 8, 6, 5)).astype(np.float32)),
        "pooled": torch.from_numpy(rng.normal(size=(2, 8, 1, 1)).astype(np.float32)),
        "pooled_dy": torch.from_numpy(rng.normal(size=(2, 8, 1, 1)).astype(np.float32)),
        "weight": torch.from_numpy((1.0 + 0.1 * rng.normal(size=8)).astype(np.float32)),
        "bias": torch.from_numpy((0.1 * rng.normal(size=8)).astype(np.float32)),
    }


def batch_norm(cls, x, dy, weight, bias) -> dict:
    """Forward and backward of a train-mode ``cls`` on ``x`` (this rank's
    rows of a synced class): output, input and affine gradients, running
    statistics."""
    bn = cls(x.shape[1], eps=1e-5, momentum=0.1)
    with torch.no_grad():
        bn.weight.copy_(weight)
        bn.bias.copy_(bias)
    x = x.clone().requires_grad_(True)
    y = bn(x)
    (y * dy).sum().backward()
    return {"y": y.detach(), "dx": x.grad, "dw": bn.weight.grad, "db": bn.bias.grad,
            "running_mean": bn.running_mean.clone(), "running_var": bn.running_var.clone()}


def synced_batch_norms() -> dict:
    inp = bn_inputs()
    out = {}
    for name, cls, x, dy in (("bn", SyncBatchNorm2d, inp["x"], inp["dy"]),
                             ("pooled", SyncBatchNorm2d, inp["pooled"], inp["pooled_dy"])):
        res = batch_norm(cls, local(x), local(dy), inp["weight"], inp["bias"])
        mesh.all_reduce_sum([res["dw"], res["db"]])  # the step's gradient sum
        out.update({f"{name}.{k}": v for k, v in res.items()})
    return out


def plain_batch_norms() -> dict:
    """The same on the whole batch, with torch's BatchNorm, in one process."""
    inp = bn_inputs()
    out = {}
    for name, cls, x, dy in (("bn", torch.nn.BatchNorm2d, inp["x"], inp["dy"]),
                             ("pooled", PooledBatchNorm, inp["pooled"], inp["pooled_dy"])):
        out.update({f"{name}.{k}": v for k, v in batch_norm(cls, x, dy, inp["weight"], inp["bias"]).items()})
    return out


# -- generation and validation on injected logits ---------------------------
def gen_logits(seed: int = 2048) -> np.ndarray:
    """NCHW logits by image: row i + 1 for image i, row 0 for the pad rows."""
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(GEN_IMAGES + 1, C, GEN_H, GEN_W)) * 2.5).astype(np.float32)
    logits[:, 0] += 1.0  # an uneven class mix, like a real model's
    return logits


class IndexImages:
    """A dataset whose image i is filled with i + 1 (the pad rows are 0),
    so an injected forward finds each row's logits."""

    def __init__(self, n: int, h: int, w: int, with_labels: bool = False):
        self.n, self.h, self.w, self.with_labels = n, h, w, with_labels

    def __len__(self):
        return self.n

    def get_item(self, i: int, rng):
        img = np.full((self.h, self.w, 3), i + 1, np.uint8)
        if self.with_labels:
            img[..., 1] = np.random.default_rng(i).integers(0, 256, size=(self.h, self.w))
            lbl = np.random.default_rng(100 + i).integers(0, C, size=(self.h, self.w)).astype(np.uint8)
            lbl[: self.h // 4] = 255
            return {"images": img, "labels": lbl, "image_paths": f"/data/val_{i}.png"}
        return {"images": img, "image_paths": f"/data/img_{i}.png"}


def generator_cfg(policy: str, save_dir: str):
    cfg = default_config()
    cfg.pseudo_policy.type = policy
    cfg.pseudo_policy.save_dir = save_dir
    cfg.pseudo_policy.batch_size = GEN_BATCH
    cfg.pseudo_policy.num_hist_bins = 2048
    cfg.pseudo_policy.stats_source = "full"
    return cfg


def generate(policy: str, save_dir: str) -> dict:
    """``policy``'s generator over the index images with injected logits,
    each rank on its share."""
    populate()
    table = torch.from_numpy(gen_logits())

    def forward(images):
        full = table[torch.from_numpy(np.ascontiguousarray(images[:, 0, 0, 0])).long()].contiguous()
        return {"full": full, "low": full}

    def batches():
        return iter(BatchIterator(IndexImages(GEN_IMAGES, GEN_H, GEN_W), GEN_BATCH, shuffle=False,
                                  drop_last=False, share=mesh.share()))

    gen = PSEUDO_POLICY[policy](generator_cfg(policy, save_dir), forward, batches, expected_count=GEN_IMAGES,
                                device="cpu")
    gen.run()
    return {"class_threshold": gen.class_threshold, "class_mean_probs": gen.class_mean_probs}


def validation_step(img: torch.Tensor, lbl: torch.Tensor):
    """A stand-in for the model: class = the image's second channel mod C."""
    return intersection_and_union(img[..., 1].long() % C, lbl, C)


def validate() -> dict:
    batches = BatchIterator(IndexImages(VAL_IMAGES, VAL_H, VAL_W, with_labels=True), VAL_BATCH, shuffle=False,
                            drop_last=False, share=mesh.share())
    iou, miou = run_validation(validation_step, iter(batches), torch.device("cpu"), target=batches.local_size)
    return {"iou": iou, "miou": miou}


def main(argv):
    rank, world, store, in_dir, out_dir = argv
    torch.set_num_threads(2)
    os.environ.update({"RANK": rank, "WORLD_SIZE": world, "LOCAL_RANK": rank, "LOCAL_WORLD_SIZE": world})
    mesh.init("cpu", init_method=f"file://{store}")
    from hiast_tpu_torch.cli import train

    # first what needs nothing from the test process but the training data
    trainer = train.main(torch.load(os.path.join(in_dir, "train_argv.pt")))
    batch = step_batch()
    out = {
        "world": mesh.world_size(),
        "train": {"losses": trainer.loss_log, "step": trainer.step,
                  "sums": sums(trainer.segmentor.module)},
        "source_only": source_only_step(batch),
        "adversarial": adversarial_step(batch),
        "mutual": mutual_step(batch),
        "batch_norm": synced_batch_norms(),
        "ias": generate("IAS", os.path.join(out_dir, "ias", "pseudo_label", "gray_label")),
        "cbst": generate("CBST", os.path.join(out_dir, "cbst", "pseudo_label", "gray_label")),
        "validation": validate(),
    }
    inputs_path = os.path.join(in_dir, "inputs.pt")  # the JAX variables, written while this ran
    deadline = time.monotonic() + 300
    while not os.path.exists(inputs_path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {inputs_path}")
        time.sleep(0.05)
    inputs = torch.load(inputs_path, weights_only=False)
    out["consistency"] = consistency_step(SELF_TRAINING, inputs["state_dict"], inputs["batch"])
    out["remat"] = remat_step(inputs["state_dict"], inputs["batch"])
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    mesh.destroy()

if __name__ == "__main__":
    main(sys.argv[1:])
