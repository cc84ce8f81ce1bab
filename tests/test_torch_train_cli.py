"""The port's training CLI (``python -m hiast_tpu_torch.cli.train``) on the
CPU: SegFormer-B0 self-training on 5 synthetic 96x192 target images with
pseudo-labels, segformer_sl_1's settings (AdamW, Poly, 'MS' crops, KLD and
entropy), float32, crop 48x96, batch 2.

- 3 iterations with validation at the last write ``model_last.pth`` (and
  ``_mid``, ``_best``) holding the full state at step 3;
- resuming from it runs iterations 4 and 5 only, from the saved optimizer;
- the generation CLI reads ``model_last.pth`` as its weights;
- SIGTERM during a run checkpoints after the iteration and stops;
- ``--device cuda`` without a card and ``runtime.remat`` raise (the
  directional-consistency loss is held in tests/test_torch_dcst.py).

And the HIAST round's trainer, ``ConsistencySelfTrainingTrainer``, on
DeepLab-v2 with layers (1, 1, 1, 1): hiast_setting.yaml's overlay (EMA
teacher, SoftCE 0.5 on the ignored region, 'MS' + 'CCA', CopyPaste over 14
hard classes from the round's ``samples_with_class.json`` and
``class_mean_probabilities.npy``) for 2 iterations writes ``model_last.pth``
with the EMA state, ``ema_model_last.pth`` and the EMA validation record;
``train.resume_from`` restores the EMA; the generation CLI runs from
``ema_model_last.pth``; CopyPaste without the stats raises.
"""
import json
import os
import shutil
import signal

import numpy as np
import pytest
import torch

from hiast_tpu_torch.cli import generate_pseudo_labels, train
from hiast_tpu_torch.data.datasets import read_gray
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

    def step_then_sigterm(batch, count):
        out = inner(batch, count)
        if count.iterations == 2:
            signal.raise_signal(signal.SIGTERM)
        return out

    trainer.step_fn = step_then_sigterm
    trainer.run()
    assert trainer.step == 2
    assert load_train_state(str(tmp_path / "work" / "checkpoints" / "model_last.pth"))["step"] == 2
    assert signal.getsignal(signal.SIGTERM) is not None


@pytest.mark.parametrize("extra,error", [
    (["runtime.remat", "True"], NotImplementedError),
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


def _write_round_stats(root, pseudo_dir, classes_per_image=None):
    """``samples_with_class.json`` and ``class_mean_probabilities.npy`` as the
    generator writes them for the round's pseudo-labels."""
    swc = {}
    for name in sorted(os.listdir(pseudo_dir)):
        lbl = read_gray(os.path.join(pseudo_dir, name))
        image = name.replace("_pseudo_label.png", ".png")
        for c, n in zip(*np.unique(lbl[lbl != 255], return_counts=True)):
            swc.setdefault(str(int(c)), []).append([image, int(n)])
    stats = os.path.dirname(pseudo_dir)
    with open(os.path.join(stats, "samples_with_class.json"), "w") as f:
        json.dump(swc, f)
    np.save(os.path.join(stats, "class_mean_probabilities.npy"),
            np.linspace(0.5, 0.95, 19).astype(np.float32))


def _consistency_argv(root, work, total_iter, pseudo_dir, *extra):
    city, manifest = str(root / "city"), str(root / "t.json")
    return [
        "--device", "cpu", "--work_dir", str(work), "--pseudo_save_dir", str(pseudo_dir),
        "trainer", "ConsistencySelfTrainingTrainer",
        "model.type", "SelfTrainingSegmentor", "model.seg_model.type", "DeepLab_V2",
        "model.seg_model.backbone_layers", "[1, 1, 1, 1]", "model.is_freeze_bn", "True",
        "model.predictor.ent_loss.weight", "1.0",
        "dataset.target.type", "Cityscapes", "dataset.target.json_path", manifest,
        "dataset.target.image_dir", city, "dataset.target.aug_type", "['MS', 'CCA']",
        "dataset.crop_size", "[48, 96]",
        "dataset.val.type", "Cityscapes", "dataset.val.json_path", manifest,
        "dataset.val.image_dir", city, "dataset.val.resize_size", "[48, 96]",
        "cst_training.is_enabled", "True", "cst_training.cst_loss.type", "SoftCE",
        "cst_training.cst_loss.weight", "0.5", "cst_training.cst_loss.region", "ignored",
        "preprocessor.type", "CopyPaste", "preprocessor.copy_paste.selected_num_classes", "14",
        "train.batch_size", "2", "train.total_iter", str(total_iter), "train.iter_val", "2",
        "train.iter_report", "1", "train.optimizer", "Adam", "train.lr", "3e-6",
        "train.lr_scheduler.type", "Cosine", "runtime.precision.compute_dtype", "float32",
        *extra,
    ]


def test_consistency_trainer_writes_the_ema_and_hands_it_on(root, tmp_path):
    pseudo_dir = tmp_path / "round0" / "pseudo_label" / "gray_label"
    shutil.copytree(root / "round0" / "pseudo_label" / "gray_label", pseudo_dir)
    _write_round_stats(root, str(pseudo_dir))
    work = tmp_path / "work"
    trainer = train.main(_consistency_argv(root, work, 2, pseudo_dir))
    assert trainer.step == 2 and len(trainer.loss_log) == 2
    for losses in trainer.loss_log:
        assert sorted(losses) == ["cst_loss", "ent_ignored_loss", "kld_confident_loss", "target_seg_loss"]
        assert all(np.isfinite(v) for v in losses.values())
    assert len(trainer.paste_shares) >= 2 and min(trainer.paste_shares) > 0
    ckpt = work / "checkpoints"
    assert {"model_last.pth", "ema_model_last.pth"} <= set(os.listdir(ckpt))
    state = load_train_state(str(ckpt / "model_last.pth"))
    assert state["step"] == state["lr_schedule_step"] == 2
    student = {n: p for n, p in trainer.segmentor.module.named_parameters()}
    assert sorted(state["ema"]) == sorted(student)
    ema_weights = torch.load(str(ckpt / "ema_model_last.pth"), weights_only=True)
    assert sorted(ema_weights) == sorted(trainer.segmentor.module.state_dict())
    for name, value in state["ema"].items():
        torch.testing.assert_close(ema_weights[name], value, rtol=0, atol=0)
    moved = [n for n, v in state["ema"].items() if not torch.equal(v, state["state_dict"][n])]
    assert moved  # the teacher lags the student
    log = (work / "train.log").read_text()
    assert "ema_model, iter: 2, miou:" in log and "model, iter: 2, miou:" in log

    # a full-state resume restores the teacher
    from hiast_tpu_torch.cli.common import build_cfg, standard_parser
    from hiast_tpu_torch.registry import TRAINER

    argv = _consistency_argv(root, tmp_path / "work2", 3, pseudo_dir, "--resume_from", str(ckpt / "model_last.pth"))
    resumed = TRAINER["ConsistencySelfTrainingTrainer"](build_cfg(standard_parser("t").parse_args(argv)), device="cpu")
    assert resumed.step == 2 and resumed.count.updates == 2
    for name, p in resumed.ema_module.named_parameters():
        torch.testing.assert_close(p.detach(), state["ema"][name], rtol=0, atol=0)

    # the round's handoff: the next generation from the teacher
    save_dir = tmp_path / "round1" / "pseudo_label" / "gray_label"
    generate_pseudo_labels.main([
        "--device", "cpu", "--pseudo_resume_from", str(ckpt / "ema_model_last.pth"),
        "--pseudo_save_dir", str(save_dir),
        "model.type", "SelfTrainingSegmentor", "model.seg_model.type", "DeepLab_V2",
        "model.seg_model.backbone_layers", "[1, 1, 1, 1]",
        "dataset.target.type", "Cityscapes", "dataset.target.json_path", str(root / "t.json"),
        "dataset.target.image_dir", str(root / "city"),
        "pseudo_policy.type", "IAS", "pseudo_policy.resize_size", "[48, 96]",
        "pseudo_policy.num_hist_bins", "256",
    ])
    assert sorted(os.listdir(save_dir)) == [f"t_{i}_pseudo_label.png" for i in range(5)]


def test_copy_paste_without_the_round_stats_raises(root, tmp_path):
    with pytest.raises(FileNotFoundError, match="samples_with_class"):
        train.main(_consistency_argv(root, tmp_path / "work", 1, root / "round0" / "pseudo_label" / "gray_label"))
