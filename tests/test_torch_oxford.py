"""The Cityscapes -> Oxford RobotCar scenario at 9 classes through the
port's CLIs against the JAX package's, on the CPU with one shared ``.pth``
(DeepLab-v2, layers (1, 1, 1, 1), 9 classes, random weights from a seed):
4 Oxford train images of 96x128 in the unlabelled split and 3 val images
with 9-class labels (8-bit RGBA, 8-bit gray and 16-bit gray), written by
the port's encoder.

- Generation (``oxford_sl_1.yaml``'s IAS settings: alpha 0.5, beta 0.9,
  gamma 8, here at 64x96 and 256 bins; the label files at that size, as
  the shipped setting writes 768x1280 labels of 960x1280 images): the
  same files, 9-entry
  statistics in the JAX dtypes, the same image order; at least 98% of the
  label pixels and every threshold within 0.01 of JAX's, the bound
  tests/test_torch_cli.py set for the 19-class generation (both run their
  trunk in bf16, rounding at other places; measured here: 99.91% and
  0.00078).
- Validation (9 classes, 64x96, flip): per-class IoU within 0.02 and mIoU
  within 0.005 of JAX's, tests/test_torch_validate.py's bound (measured:
  IoU 8e-4, mIoU 1e-4).
"""
import json
import os

import numpy as np
import pytest
import torch

from hiast_tpu_torch.data.png import write_png
from hiast_tpu_torch.data.remap import OXFORD_ID_MAP
from test_torch_cli import _artifacts

RNG = np.random.default_rng(43)
OX_H, OX_W = 96, 128


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    from hiast_tpu_torch.models.deeplab_v2 import DeepLabV2

    root = tmp_path_factory.mktemp("oxford")
    os.makedirs(root / "oxford" / "train")
    os.makedirs(root / "oxford" / "val")
    yy, xx = np.mgrid[0:OX_H, 0:OX_W]
    train, val = [], []
    for i in range(4):
        base = np.stack([(xx * (i + 2)) % 256, (yy * 3) % 256, (xx + yy) % 256], -1)
        img = (base + RNG.integers(0, 40, size=(OX_H, OX_W, 3))).clip(0, 255).astype(np.uint8)
        write_png(str(root / "oxford" / "train" / f"o_{i}.png"), img)
        train.append({"image_name": f"train/o_{i}.png", "mask_name": f"train/o_{i}.png.nolabel"})
    raw_ids = np.asarray(sorted(OXFORD_ID_MAP))
    for i in range(3):
        write_png(str(root / "oxford" / "val" / f"v_{i}.png"), RNG.integers(0, 256, (OX_H, OX_W, 3)).astype(np.uint8))
        ids = raw_ids[(xx // 16 + yy // 16 + i) % len(raw_ids)]
        lbl = [np.concatenate([ids[..., None], RNG.integers(0, 256, (OX_H, OX_W, 3))], -1).astype(np.uint8),
               ids.astype(np.uint8), (ids + 256 * RNG.integers(0, 256, (OX_H, OX_W))).astype(np.uint16)][i]
        write_png(str(root / "oxford" / "val" / f"v_{i}_lbl.png"), lbl)
        val.append({"image_name": f"val/v_{i}.png", "mask_name": f"val/v_{i}_lbl.png"})
    (root / "oxford_train.json").write_text(json.dumps(train))
    (root / "oxford_val.json").write_text(json.dumps(val))
    model = DeepLabV2(num_classes=9, backbone_layers=(1, 1, 1, 1))
    model.init_weights(torch.Generator().manual_seed(9))
    torch.save(model.state_dict(), root / "oxford9.pth")
    return root


def _common(root, package: str):
    """``package``'s own copy of oxford_sl_1.yaml with the fixture's data."""
    return [
        "--config_file", os.path.join(os.path.dirname(os.path.dirname(__file__)), package, "configs",
                                      "oxford_sl_1.yaml"),
        "model.seg_model.backbone_layers", "[1, 1, 1, 1]",
        "dataset.target.json_path", str(root / "oxford_train.json"), "dataset.target.image_dir", str(root / "oxford"),
        "dataset.val.json_path", str(root / "oxford_val.json"), "dataset.val.image_dir", str(root / "oxford"),
    ]


def test_oxford_generation_matches_jax(root, tmp_path):
    from hiast_tpu.cli import generate_pseudo_labels as jax_cli
    from hiast_tpu_torch.cli import generate_pseudo_labels as port_cli

    pth = str(root / "oxford9.pth")
    opts = ["pseudo_policy.resize_size", "[64, 96]", "pseudo_policy.num_hist_bins", "256"]
    dirs = {k: str(tmp_path / k / "pseudo_label" / "gray_label") for k in ("jax", "port")}
    jax_cli.main(["--pseudo_resume_from", pth, "--pseudo_save_dir", dirs["jax"], *_common(root, "hiast_tpu"), *opts])
    port_cli.main(["--device", "cpu", "--pseudo_resume_from", pth, "--pseudo_save_dir", dirs["port"],
                   *_common(root, "hiast_tpu_torch"), *opts])
    want, got = _artifacts(dirs["jax"]), _artifacts(dirs["port"])
    assert list(got["pngs"]) == list(want["pngs"]) == [f"o_{i}_pseudo_label.png" for i in range(4)]
    for name in ("class_threshold", "statics_class", "class_mean_probabilities"):
        assert got[name].shape == want[name].shape == (9,) and got[name].dtype == want[name].dtype, name
    assert [s["file"] for s in got["sample_class_stats"]] == [s["file"] for s in want["sample_class_stats"]]
    assert list(got["samples_with_class"]) == list(want["samples_with_class"]) == [str(c) for c in range(9)]
    for name, arr in got["pngs"].items():
        assert arr.shape == (64, 96) and bool(np.all((arr < 9) | (arr == 255))), name
    agree = np.mean([np.mean(got["pngs"][n] == want["pngs"][n]) for n in want["pngs"]])
    thr_err = float(np.abs(got["class_threshold"] - want["class_threshold"]).max())
    print(f"label agreement {agree:.4f}, max threshold difference {thr_err:.5f}")
    assert agree >= 0.98, agree
    assert thr_err <= 0.01, thr_err


def test_oxford_validation_matches_jax(root, capsys):
    from hiast_tpu.cli import validate as jax_cli
    from hiast_tpu_torch.cli import validate as port_cli

    pth = ["--validate_resume_from", str(root / "oxford9.pth")]
    opts = ["model.type", "SourceOnlySegmentor",
            "validate.resize_sizes", "[[64, 96]]", "validate.is_flip", "True", "validate.batch_size", "2"]
    want = jax_cli.main([*pth, *_common(root, "hiast_tpu"), *opts])
    got = port_cli.main(["--device", "cpu", *pth, *_common(root, "hiast_tpu_torch"), *opts])
    assert np.asarray(got["iou"]).shape == (9,)
    np.testing.assert_allclose(np.asarray(got["iou"]), np.asarray(want["iou"]), rtol=0, atol=0.02)
    assert abs(got["miou"] - want["miou"]) <= 0.005
