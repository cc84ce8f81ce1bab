"""The port's generation CLI against the JAX CLI on the tests/test_cli.py
fixture pattern: a tiny trunk, 64x128 images, 4 target images, 256 bins,
one shared .pth, the port on ``--device cpu``.

The artifact contract must match exactly: file names, array shapes and
dtypes, and the order in which images were processed.  The numbers come
from two bf16 forwards that round at different places (XLA's bf16 convs and
f32 batch-norm vs torch's CPU autocast), so they are held to bounds measured
on this fixture with a margin, not to equality: at least 98% of label pixels
agree and every threshold within 0.01 (measured: 99.8% and 0.001).
"""
import json
import os

import numpy as np
import pytest
import torch

from hiast_tpu_torch.data.datasets import read_gray
from hiast_tpu_torch.data.png import write_png

RNG = np.random.default_rng(21)


@pytest.fixture
def fixture_root(tmp_path):
    img_dir = tmp_path / "city" / "images"
    os.makedirs(img_dir)
    manifest = []
    for i in range(4):
        img = RNG.integers(0, 255, size=(64, 128, 3)).astype(np.uint8)
        lbl = RNG.integers(0, 19, size=(64, 128)).astype(np.uint8)
        write_png(str(img_dir / f"t_{i}.png"), img)
        write_png(str(img_dir / f"t_{i}_lbl.png"), lbl)
        manifest.append({"image_name": f"images/t_{i}.png", "mask_name": f"images/t_{i}_lbl.png"})
    (tmp_path / "cityscapes_train.json").write_text(json.dumps(manifest))
    return tmp_path


def _shared_pth(path):
    from hiast_tpu_torch.models.deeplab_v2 import DeepLabV2, init_weights

    model = DeepLabV2(num_classes=19, backbone_layers=(1, 1, 1, 1))
    init_weights(model, torch.Generator().manual_seed(5))
    torch.save(model.state_dict(), path)


def _overrides(root):
    return [
        "model.type", "SelfTrainingSegmentor",
        "model.seg_model.backbone_layers", "[1, 1, 1, 1]",
        "dataset.target.type", "Cityscapes",
        "dataset.target.json_path", str(root / "cityscapes_train.json"),
        "dataset.target.image_dir", str(root / "city"),
        "pseudo_policy.type", "IAS",
        "pseudo_policy.batch_size", "2",
        "pseudo_policy.resize_size", "[64, 128]",
        "pseudo_policy.num_hist_bins", "256",
        "pseudo_policy.ias.alpha", "0.5",
    ]


def _artifacts(pseudo_dir):
    stats = os.path.dirname(pseudo_dir)
    out = {"pngs": {n: read_gray(os.path.join(pseudo_dir, n)) for n in sorted(os.listdir(pseudo_dir))}}
    for name in ("class_threshold", "statics_class", "class_mean_probabilities"):
        out[name] = np.load(os.path.join(stats, f"{name}.npy"))
    for name in ("sample_class_stats", "samples_with_class"):
        with open(os.path.join(stats, f"{name}.json")) as f:
            out[name] = json.load(f)
    return out


def test_generation_cli_matches_jax_contract(fixture_root, tmp_path):
    from hiast_tpu.cli import generate_pseudo_labels as jax_cli
    from hiast_tpu_torch.cli import generate_pseudo_labels as port_cli
    from hiast_tpu_torch.ops.cuda.select_kernel import launch_counts, reset_launch_counts

    pth = str(tmp_path / "weights.pth")
    _shared_pth(pth)
    jax_dir = str(tmp_path / "jax" / "pseudo_label" / "gray_label")
    port_dir = str(tmp_path / "port" / "pseudo_label" / "gray_label")
    jax_cli.main(["--pseudo_resume_from", pth, "--pseudo_save_dir", jax_dir, *_overrides(fixture_root)])
    reset_launch_counts()
    port_cli.main([
        "--device", "cpu", "--pseudo_resume_from", pth, "--pseudo_save_dir", port_dir,
        *_overrides(fixture_root),
    ])
    assert launch_counts == {"ias_hist": 0, "ias_select": 0}  # CPU: plain versions only

    want, got = _artifacts(jax_dir), _artifacts(port_dir)
    assert list(got["pngs"]) == list(want["pngs"])
    assert len(got["pngs"]) == 4
    for name, arr in got["pngs"].items():
        assert arr.shape == (64, 128) and arr.dtype == np.uint8, name
    for name in ("class_threshold", "statics_class", "class_mean_probabilities"):
        assert got[name].shape == want[name].shape == (19,), name
        assert got[name].dtype == want[name].dtype, name
    assert [s["file"] for s in got["sample_class_stats"]] == [
        s["file"] for s in want["sample_class_stats"]
    ]
    assert list(got["samples_with_class"]) == list(want["samples_with_class"])

    agree = np.mean([
        np.mean(got["pngs"][n] == want["pngs"][n]) for n in want["pngs"]
    ])
    thr_err = np.abs(got["class_threshold"] - want["class_threshold"]).max()
    print(f"label agreement {agree:.4f}, max threshold difference {thr_err:.5f}")
    assert agree >= 0.98
    assert thr_err <= 0.01
    assert np.all(np.isfinite(got["class_mean_probabilities"]))
