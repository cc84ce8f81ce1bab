"""The port's warmup trainers (``SourceOnlyTrainer``,
``AdversarialWarmupTrainer``) through ``hiast_tpu_torch.cli.train.main
--device cpu``, and the warmup's checkpoint handed to the round driver.

DeepLab-v2 with layers (1, 1, 1, 1), float32, crops of 32x64, batch 2, on
64x128 PNGs written by the port's encoder: a GTA5 source with palette
labels in GTA ids, a SYNTHIA source with 16-bit RGB labels, Cityscapes
target and val images.  The adversarial run reads the port's shipped
``warmup_adversarial.yaml`` through its own YAML reader, with the data
paths, the trunk's depth and the schedule given as overrides.

1. Both trainers run; their losses are finite and named as in JAX; the
   adversarial run's discriminator moved from its seeded initialisation,
   and ``model_last.pth`` holds its state, its Adam state and its schedule
   count at the last step.
2. A full-state resume (the port's counterpart of tests/test_trainers.py's
   ``test_full_resume_restores_d_opt_state``) restores the
   discriminator's parameters and Adam moments exactly and its schedule
   count, and continues to the longer schedule's end; a file whose
   discriminator schedule disagrees with the trunk's is refused.
3. The adversarial warmup's ``model_last.pth`` starts one HIAST round of
   ``cli.run_rounds --device cpu`` as both ``--warmup_ckpt`` and
   ``--warmup_pseudo_ckpt``.
The step-level numbers against JAX are in tests/test_torch_warmup_step.py.
"""
import json
import os

import numpy as np
import pytest
import torch

from hiast_tpu_torch.cli import run_rounds
from hiast_tpu_torch.cli import train as cli_train
from hiast_tpu_torch.cli.common import build_cfg, standard_parser
from hiast_tpu_torch.data.png import write_png
from hiast_tpu_torch.data.remap import GTAV_ID_MAP, SYNTHIA_ID_MAP
from hiast_tpu_torch.models.deeplab_v2 import FCDiscriminator
from hiast_tpu_torch.registry import TRAINER
from hiast_tpu_torch.utils.checkpoint import load_step, load_train_state
from test_torch_run_rounds import TOTAL_ITER, _configs_dir

PORT_CONFIGS = os.path.join(os.path.dirname(os.path.dirname(__file__)), "hiast_tpu_torch", "configs")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """GTA5 and SYNTHIA sources (4 images each), 4 Cityscapes target and 2
    val images (the names tests/test_torch_run_rounds.py's configs read)."""
    root = tmp_path_factory.mktemp("warmup")
    rng = np.random.default_rng(31)
    palette = rng.integers(0, 256, size=(256, 3)).astype(np.uint8)
    for name in ("gta", "synthia", "city"):
        os.makedirs(root / name / "images")
    manifests = {"gtav": [], "synthia": [], "cityscapes_train": [], "cityscapes_val": []}
    for i in range(4):
        write_png(str(root / "gta" / "images" / f"g_{i}.png"), rng.integers(0, 256, (64, 128, 3)).astype(np.uint8))
        gta_ids = rng.choice(list(GTAV_ID_MAP) + [0], size=(64, 128)).astype(np.uint8)
        write_png(str(root / "gta" / "images" / f"g_{i}_lbl.png"), gta_ids, palette=palette)
        manifests["gtav"].append({"image_name": f"images/g_{i}.png", "mask_name": f"images/g_{i}_lbl.png"})
        write_png(str(root / "synthia" / "images" / f"s_{i}.png"), rng.integers(0, 256, (64, 128, 3)).astype(np.uint8))
        syn = rng.integers(0, 65536, (64, 128, 3)).astype(np.uint16)
        syn[..., 0] = rng.choice(list(SYNTHIA_ID_MAP), size=(64, 128))
        write_png(str(root / "synthia" / "images" / f"s_{i}_lbl.png"), syn)
        manifests["synthia"].append({"image_name": f"images/s_{i}.png", "mask_name": f"images/s_{i}_lbl.png"})
    for i in range(6):
        write_png(str(root / "city" / "images" / f"t_{i}.png"), rng.integers(0, 255, (64, 128, 3)).astype(np.uint8))
        write_png(str(root / "city" / "images" / f"t_{i}_lbl.png"), rng.integers(0, 19, (64, 128)).astype(np.uint8))
        entry = {"image_name": f"images/t_{i}.png", "mask_name": f"images/t_{i}_lbl.png"}
        manifests["cityscapes_train" if i < 4 else "cityscapes_val"].append(entry)
    for name, entries in manifests.items():
        (root / f"{name}.json").write_text(json.dumps(entries))
    return root


def _tiny(total_iter: int) -> list:
    return [
        "model.seg_model.backbone_layers", "[1, 1, 1, 1]", "dataset.crop_size", "[32, 64]",
        "runtime.precision.compute_dtype", "float32", "train.batch_size", "2",
        "train.total_iter", str(total_iter), "train.iter_val", str(total_iter), "train.iter_report", "1",
        "validate.batch_size", "2",
    ]


def _data(root, source: str = "gta") -> list:
    kind, manifest = {"gta": ("GTAV", "gtav"), "synthia": ("SYNTHIA", "synthia")}[source]
    return [
        "dataset.source.type", kind, "dataset.source.json_path", str(root / f"{manifest}.json"),
        "dataset.source.image_dir", str(root / source),
        "dataset.target.json_path", str(root / "cityscapes_train.json"), "dataset.target.image_dir", str(root / "city"),
        "dataset.val.json_path", str(root / "cityscapes_val.json"), "dataset.val.image_dir", str(root / "city"),
        "dataset.val.resize_size", "[32, 64]",
    ]


def _adversarial_argv(root, work_dir, total_iter: int, *extra) -> list:
    return ["--device", "cpu", "--config_file", os.path.join(PORT_CONFIGS, "warmup_adversarial.yaml"),
            "--work_dir", str(work_dir), *_tiny(total_iter), *_data(root), *extra]


def _adversarial(root, work_dir, total_iter: int, *extra):
    """The trainer after ``cli.train.main`` ran it."""
    return cli_train.main(_adversarial_argv(root, work_dir, total_iter, *extra))


def _built(argv):
    """The trainer ``cli.train.main`` would run, built but not run."""
    args = standard_parser("test").parse_args(argv)
    cfg = build_cfg(args)
    return TRAINER[cfg.trainer](cfg, device=args.device)


def test_adversarial_warmup_trains_and_saves_the_discriminator(root, tmp_path):
    trainer = _adversarial(root, tmp_path / "adv", 3)
    assert type(trainer).__name__ == "AdversarialWarmupTrainer"
    assert len(trainer.loss_log) == 3
    for step in trainer.loss_log:
        assert sorted(step) == ["D_loss", "adv_loss", "source_seg_loss"]
        assert all(np.isfinite(v) for v in step.values())
    init = FCDiscriminator(19)
    init.init_weights(torch.Generator().manual_seed(trainer.cfg.train.random_seed + 7))
    moved = [float((p.detach() - q.detach()).abs().max())
             for p, q in zip(trainer.segmentor.discriminator.parameters(), init.parameters())]
    assert min(moved) > 0, moved
    state = load_train_state(str(tmp_path / "adv" / "checkpoints" / "model_last.pth"))
    assert state["step"] == 3 and state["d_lr_schedule_step"] == 3
    for name, value in trainer.segmentor.discriminator.state_dict().items():
        assert torch.equal(state["discriminator"][name], value), name
    assert all(int(s["step"]) == 3 for s in state["d_optimizer"]["state"].values())


def test_source_only_warmup_on_synthia(root, tmp_path):
    trainer = cli_train.main([
        "--device", "cpu", "--work_dir", str(tmp_path / "src"),
        "trainer", "SourceOnlyTrainer", "model.type", "SourceOnlySegmentor",
        "dataset.source.aug_type", "['MS']", *_tiny(3), *_data(root, "synthia"),
        "dataset.val.type", "Cityscapes",
    ])
    assert type(trainer).__name__ == "SourceOnlyTrainer"
    assert [sorted(s) for s in trainer.loss_log] == [["seg_loss"]] * 3
    assert all(np.isfinite(s["seg_loss"]) for s in trainer.loss_log)
    assert load_step(str(tmp_path / "src" / "checkpoints")) == 3


def test_full_resume_restores_the_discriminator(root, tmp_path):
    first = _adversarial(root, tmp_path / "a", 4)
    ckpt = str(tmp_path / "a" / "checkpoints" / "model_last.pth")
    second = _built(_adversarial_argv(root, tmp_path / "b", 6, "--resume_from", ckpt))
    assert second.step == 4 and second.count.updates == 4
    for name, value in first.segmentor.discriminator.state_dict().items():
        assert torch.equal(second.segmentor.discriminator.state_dict()[name], value), name
    want, got = first.d_optimizer.state_dict()["state"], second.d_optimizer.state_dict()["state"]
    assert sorted(want) == sorted(got) and any(float(s["exp_avg"].abs().max()) > 0 for s in want.values())
    for k in want:
        for leaf in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(got[k][leaf], want[k][leaf]), (k, leaf)
    second.run()
    assert load_train_state(str(tmp_path / "b" / "checkpoints" / "model_last.pth"))["d_lr_schedule_step"] == 6
    assert len(second.loss_log) == 2

    state = load_train_state(ckpt)
    state["d_lr_schedule_step"] = 3
    torch.save(state, tmp_path / "bad.pth")
    with pytest.raises(ValueError, match="discriminator schedule"):
        _built(_adversarial_argv(root, tmp_path / "c", 6, "--resume_from", str(tmp_path / "bad.pth")))


def test_warmup_checkpoint_starts_a_round(root, tmp_path):
    _adversarial(root, tmp_path / "warmup", 2)
    warm = str(tmp_path / "warmup" / "checkpoints" / "model_last.pth")
    configs = _configs_dir(root, tmp_path, "[ 'MS' ]")
    run_rounds.main(["--work_dir", str(tmp_path / "rounds"), "--warmup_ckpt", warm, "--warmup_pseudo_ckpt", warm,
                     "--configs_dir", str(configs), "--rounds", "1", "--device", "cpu"])
    round_dir = tmp_path / "rounds" / "sl_1"
    assert len(os.listdir(round_dir / "pseudo_label" / "gray_label")) == 4
    assert load_step(str(round_dir / "checkpoints")) == TOTAL_ITER
    # the round's student started from the warmup's trunk, not from its own seed
    state = load_train_state(str(round_dir / "checkpoints" / "model_last.pth"))
    assert "discriminator" not in state
    warm_trunk = torch.load(warm, map_location="cpu", weights_only=True)["state_dict"]
    diff = float((state["state_dict"]["aspp.conv2d_list.0.weight"] - warm_trunk["aspp.conv2d_list.0.weight"]).abs().max())
    assert 0 < diff < 0.05
