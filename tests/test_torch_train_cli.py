"""The port's training CLI (``python -m hiast_tpu_torch.cli.train``) on the
CPU: SegFormer-B0 self-training on 5 synthetic 96x192 target images with
pseudo-labels, segformer_sl_1's settings (AdamW, Poly, 'MS' crops, KLD and
entropy), float32, crop 48x96, batch 2.

- 3 iterations with validation at the last write ``model_last.pth`` (and
  ``_mid``, ``_best``) holding the full state at step 3;
- resuming from it runs iterations 4 and 5 only, from the saved optimizer;
- the generation CLI reads ``model_last.pth`` as its weights;
- SIGTERM during a run checkpoints after the iteration and stops;
- ``--device cuda`` without a card, ``runtime.remat`` and
  ``runtime.skip_nonfinite_updates`` raise.
"""
import json
import os
import signal

import numpy as np
import pytest
import torch

from hiast_tpu_torch.cli import generate_pseudo_labels, train
from hiast_tpu_torch.data.png import write_png
from hiast_tpu_torch.utils.checkpoint import load_train_state


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Tiny convolutions gain nothing from more threads, and the suite runs
    several test processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("train")
    rng = np.random.default_rng(0)
    os.makedirs(root / "city" / "images")
    os.makedirs(root / "round0" / "pseudo_label" / "gray_label")
    manifest = []
    for i in range(5):
        write_png(str(root / "city" / "images" / f"t_{i}.png"),
                  rng.integers(0, 256, size=(96, 192, 3)).astype(np.uint8))
        lbl = rng.integers(0, 19, size=(96, 192)).astype(np.uint8)
        write_png(str(root / "city" / "images" / f"t_{i}_lbl.png"), lbl)
        lbl[:24] = 255
        write_png(str(root / "round0" / "pseudo_label" / "gray_label" / f"t_{i}_pseudo_label.png"), lbl)
        manifest.append({"image_name": f"images/t_{i}.png", "mask_name": f"images/t_{i}_lbl.png"})
    (root / "t.json").write_text(json.dumps(manifest))
    return root


def _argv(root, work, total_iter, *extra):
    city, manifest = str(root / "city"), str(root / "t.json")
    return [
        "--device", "cpu", "--work_dir", str(work),
        "--pseudo_save_dir", str(root / "round0" / "pseudo_label" / "gray_label"),
        "trainer", "SelfTrainingTrainer",
        "model.type", "SelfTrainingSegmentor", "model.seg_model.type", "SegFormer_B0",
        "model.is_freeze_bn", "False", "model.predictor.ent_loss.weight", "1.0",
        "dataset.target.type", "Cityscapes", "dataset.target.json_path", manifest,
        "dataset.target.image_dir", city, "dataset.target.aug_type", "['MS']",
        "dataset.crop_size", "[48, 96]",
        "dataset.val.type", "Cityscapes", "dataset.val.json_path", manifest,
        "dataset.val.image_dir", city, "dataset.val.resize_size", "[48, 96]",
        "train.batch_size", "2", "train.total_iter", str(total_iter), "train.iter_val", "3",
        "train.iter_report", "1", "train.optimizer", "AdamW", "train.lr", "6e-6",
        "train.weight_decay", "0.01", "train.lr_scheduler.type", "Poly",
        "runtime.precision.compute_dtype", "float32",
        *extra,
    ]


def test_train_writes_resumes_and_reloads(root, tmp_path):
    work = tmp_path / "work"
    trainer = train.main(_argv(root, work, 3))
    assert trainer.step == 3 and len(trainer.loss_log) == 3
    for losses in trainer.loss_log:
        assert sorted(losses) == ["ent_ignored_loss", "kld_confident_loss", "target_seg_loss"]
        assert all(np.isfinite(v) for v in losses.values())
    ckpt = work / "checkpoints"
    assert sorted(os.listdir(ckpt)) == ["model_best.pth", "model_last.pth", "model_mid.pth"]
    state = load_train_state(str(ckpt / "model_last.pth"))
    assert state["step"] == state["lr_schedule_step"] == 3
    saved_weights = {k: v.clone() for k, v in state["state_dict"].items()}
    assert (work / "train.log").exists() and (work / "config.json").exists()

    resumed = train.main(_argv(root, tmp_path / "work2", 5, "--resume_from", str(ckpt / "model_last.pth")))
    assert resumed.step == 5 and len(resumed.loss_log) == 2  # iterations 4 and 5
    adam_step = resumed.optimizer.state_dict()["state"][0]["step"]
    assert float(adam_step) == 5.0  # Adam's count went on from the saved 3
    resumed_state = load_train_state(str(tmp_path / "work2" / "checkpoints" / "model_last.pth"))
    assert resumed_state["step"] == 5
    moved = [k for k, v in resumed_state["state_dict"].items()
             if v.is_floating_point() and not torch.equal(v, saved_weights[k])]
    assert moved

    # the generation CLI reads the trainer's checkpoint as its weights
    save_dir = tmp_path / "round1" / "pseudo_label" / "gray_label"
    generate_pseudo_labels.main([
        "--device", "cpu", "--pseudo_resume_from", str(ckpt / "model_last.pth"),
        "--pseudo_save_dir", str(save_dir),
        "model.type", "SelfTrainingSegmentor", "model.seg_model.type", "SegFormer_B0",
        "dataset.target.type", "Cityscapes", "dataset.target.json_path", str(root / "t.json"),
        "dataset.target.image_dir", str(root / "city"),
        "pseudo_policy.type", "IAS", "pseudo_policy.resize_size", "[48, 96]",
        "pseudo_policy.num_hist_bins", "256",
    ])
    assert sorted(os.listdir(save_dir)) == [f"t_{i}_pseudo_label.png" for i in range(5)]


def test_sigterm_checkpoints_and_stops(root, tmp_path):
    argv = _argv(root, tmp_path / "work", 4, "dataset.val.type", "None")
    from hiast_tpu_torch.cli.common import build_cfg, standard_parser
    from hiast_tpu_torch.registry import TRAINER

    cfg = build_cfg(standard_parser("t").parse_args(argv))
    trainer = TRAINER[cfg.trainer](cfg, device="cpu")
    inner = trainer.step_fn

    def step_then_sigterm(batch, t):
        out = inner(batch, t)
        if t == 1:
            signal.raise_signal(signal.SIGTERM)
        return out

    trainer.step_fn = step_then_sigterm
    trainer.run()
    assert trainer.step == 2
    assert load_train_state(str(tmp_path / "work" / "checkpoints" / "model_last.pth"))["step"] == 2
    assert signal.getsignal(signal.SIGTERM) is not None


@pytest.mark.parametrize("extra,error", [
    (["runtime.remat", "True"], NotImplementedError),
    (["runtime.skip_nonfinite_updates", "True"], NotImplementedError),
])
def test_unported_runtime_options_raise(root, tmp_path, extra, error):
    with pytest.raises(error):
        train.main(_argv(root, tmp_path / "work", 1, *extra))


def test_cuda_without_a_card_raises(root, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    argv = _argv(root, tmp_path / "work", 1)
    argv[argv.index("--device") + 1] = "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(argv)
