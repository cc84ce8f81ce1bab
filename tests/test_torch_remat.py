"""Activation rematerialisation (``runtime.remat``, hiast_tpu_torch/models/
remat.py) in the port, on the CPU.

- Every trainer's step with remat equals the same step without it, from the
  same seeded weights and batch: the self-training step on SegFormer-B0
  under each of 'full', 'dots', 'blocks' and 'blocks_dots'; on DeepLab-v2
  (layers (1, 1, 1, 1)) under 'full' and 'dots'; on DeepLab-v3+ at batch 1,
  where ``PooledBatchNorm`` takes its own path, and at batch 2; the
  source-only step under 'blocks' (a trunk without blocks: whole-trunk
  remat), the adversarial step (two trunk forwards a step) and the mutual
  step (two students).  The consistency step is held against JAX's under
  'full' in tests/test_torch_consistency_step.py, the 'blocks' B0 step
  against JAX's in tests/test_torch_train_step.py.  The rerun repeats the
  forward's float32 operations on the same inputs, so: losses within 1e-6
  relative; each gradient, each parameter after the update and each
  BatchNorm running statistic within 1e-6 of its tensor's scale;
  ``num_batches_tracked`` equal (one per trunk forward, none for the
  rerun); the same ``state_dict`` keys.
- An unknown ``runtime.remat_mode`` raises ``ValueError`` naming it: with
  remat on (at the train forward), and for SegFormer at build with remat
  off too, as the JAX package does.
"""
import numpy as np
import pytest
import torch

from hiast_tpu_torch.config import default_config
from hiast_tpu_torch.models.deeplab_v2 import build_seg_model
from hiast_tpu_torch.models.segmentors import build_segmentor
from hiast_tpu_torch.registry import populate
from hiast_tpu_torch.selftrain import steps as S
from hiast_tpu_torch.selftrain.train_state import lr_schedule, lr_schedule_for_d, make_d_optimizer, make_optimizer

H, W = 32, 64
SEGMENTORS = {"source_only": "SourceOnlySegmentor", "adversarial": "AdversarialWarmupSegmentor"}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    """Two threads: the suite runs several pytest-xdist workers on one host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _cfg(kind: str, seg_model: str, mode: str | None):
    populate()
    cfg = default_config()
    cfg.model.type = SEGMENTORS.get(kind, "SelfTrainingSegmentor")
    cfg.model.seg_model.type = seg_model
    cfg.model.seg_model.backbone_layers = [1, 1, 1, 1]
    cfg.model.is_freeze_bn = False
    cfg.model.predictor.ent_loss.weight = 1.0
    cfg.model.discriminator.is_enabled = kind == "adversarial"
    cfg.mut_training.is_enabled = kind == "mutual"
    cfg.train.optimizer = "SGD"
    cfg.train.lr = 1e-2
    cfg.runtime.remat = mode is not None
    cfg.runtime.remat_mode = mode or "full"
    return cfg


def _batch(b: int) -> dict:
    rng = np.random.default_rng(5)
    plbl = rng.integers(0, 19, size=(b, H, W))
    plbl[:, :, : W // 4] = 255  # an ignored region for the entropy term
    return {
        "s_img": torch.from_numpy(rng.integers(0, 256, size=(b, H, W, 3), dtype=np.uint8)),
        "s_lbl": torch.from_numpy(rng.integers(0, 19, size=(b, H, W)).astype(np.uint8)),
        "t_img": torch.from_numpy(rng.integers(0, 256, size=(b, H, W, 3), dtype=np.uint8)),
        "t_plbl": torch.from_numpy(plbl.astype(np.uint8)),
    }


def _one_step(kind: str, seg_model: str, mode: str | None, b: int) -> dict:
    """One float32 step of ``kind`` from seeded weights: its losses, and the
    gradients, parameters and buffers of every module it updates."""
    cfg = _cfg(kind, seg_model, mode)
    segmentor = build_segmentor(cfg)
    segmentor.module.init_weights(torch.Generator().manual_seed(0))
    modules = {"": segmentor.module}
    optimizer, lr_fn = make_optimizer(cfg, segmentor.module), lr_schedule(cfg)
    f32 = torch.float32
    if kind == "self_training":
        step = S.make_self_training_step(segmentor, optimizer, lr_fn, f32)
    elif kind == "source_only":
        step = S.make_source_only_step(segmentor, optimizer, lr_fn, f32)
    elif kind == "adversarial":
        segmentor.discriminator.init_weights(torch.Generator().manual_seed(1))
        modules["discriminator."] = segmentor.discriminator
        step = S.make_adversarial_step(segmentor, optimizer, lr_fn, make_d_optimizer(cfg, segmentor.discriminator),
                                       lr_schedule_for_d(cfg), f32)
    else:  # mutual
        peer = build_seg_model(cfg)
        peer.init_weights(torch.Generator().manual_seed(1))
        modules["peer."] = peer
        step = S.make_mutual_step(segmentor, peer, optimizer, make_optimizer(cfg, peer), lr_fn, f32)
    losses = step(_batch(b), S.StepCount())
    out = {"losses": {k: float(v) for k, v in losses.items()}, "grads": {}, "params": {}, "buffers": {},
           "keys": []}
    for prefix, module in modules.items():
        for name, p in module.named_parameters():
            out["params"][prefix + name] = p.detach().clone()
            if p.grad is not None:
                out["grads"][prefix + name] = p.grad.clone()
        out["buffers"].update({prefix + n: v.clone() for n, v in module.named_buffers()})
        out["keys"] += [prefix + k for k in module.state_dict()]
    return out


def _assert_same_step(got: dict, want: dict) -> None:
    assert got["keys"] == want["keys"]
    assert sorted(got["losses"]) == sorted(want["losses"])
    for name, value in want["losses"].items():
        np.testing.assert_allclose(got["losses"][name], value, rtol=1e-6, err_msg=name)
    for part in ("grads", "params", "buffers"):
        assert sorted(got[part]) == sorted(want[part]), part
        for name, ref in want[part].items():
            if not ref.is_floating_point():  # num_batches_tracked
                assert torch.equal(got[part][name], ref), name
                continue
            scale = float(ref.abs().max())
            err = float((got[part][name] - ref).abs().max())
            assert err <= 1e-6 * scale, f"{part} {name}: off by {err} at scale {scale}"


CASES = [
    ("self_training", "SegFormer_B0", "full", 2),
    ("self_training", "SegFormer_B0", "dots", 2),
    ("self_training", "SegFormer_B0", "blocks", 2),
    ("self_training", "SegFormer_B0", "blocks_dots", 2),
    ("self_training", "DeepLab_V2", "full", 2),
    ("self_training", "DeepLab_V2", "dots", 2),
    ("self_training", "DeepLab_V3Plus", "full", 1),
    ("self_training", "DeepLab_V3Plus", "dots", 2),
    ("source_only", "DeepLab_V2", "blocks", 2),
    ("adversarial", "DeepLab_V2", "full", 2),
    ("mutual", "DeepLab_V2", "blocks_dots", 2),
]


@pytest.fixture(scope="module")
def without_remat():
    """The steps without remat, each run once for the cases that share it."""
    return {}


@pytest.mark.parametrize("kind,seg_model,mode,b", CASES)
def test_step_with_remat_equals_step_without(without_remat, kind, seg_model, mode, b):
    key = (kind, seg_model, b)
    if key not in without_remat:
        without_remat[key] = _one_step(kind, seg_model, None, b)
    want = without_remat[key]
    got = _one_step(kind, seg_model, mode, b)
    _assert_same_step(got, want)
    counts = {n: int(v) for n, v in got["buffers"].items() if n.endswith("num_batches_tracked")}
    forwards = 2 if kind == "adversarial" else 1  # the adversarial step runs the trunk on source and target
    assert counts and all(c == forwards for c in counts.values()), counts


@pytest.mark.parametrize("seg_model,remat", [("SegFormer_B0", False), ("SegFormer_B0", True), ("DeepLab_V2", True)])
def test_unknown_remat_mode_raises(seg_model, remat):
    cfg = _cfg("self_training", seg_model, "full")
    cfg.runtime.remat = remat
    cfg.runtime.remat_mode = "block"  # the singular, a typo
    with pytest.raises(ValueError, match="remat_mode 'block'"):
        segmentor = build_segmentor(cfg)  # SegFormer validates the mode at build
        segmentor.module.train()
        segmentor.forward(torch.zeros(1, 3, H, W))
