"""The port's generation CLI against the JAX CLI on the tests/test_cli.py
fixture pattern: a tiny trunk, 64x128 images, 4 target images, 256 bins,
one shared .pth, the port on ``--device cpu``.

The artifact contract must match exactly: file names, array shapes and
dtypes, and the order in which images were processed.  The numbers come
from two bf16 forwards that round at different places (XLA's bf16 convs and
f32 batch-norm vs torch's CPU autocast), so they are held to bounds measured
on this fixture with a margin, not to equality: at least 98% of label pixels
agree and every threshold within 0.01 (measured: 99.8% and 0.001).  The
SegFormer-B0 case predicts some classes on a handful of pixels only, and
such a class's threshold, a quantile of a few confidences, moves further:
labels agree on 98%, the median threshold within 0.002 and every threshold
within 0.03 (measured on 6 fixtures: labels 99.98% or more, median 0.0004,
largest 0.016).
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


def _shared_pth(path, seg_model="DeepLab_V2"):
    from hiast_tpu_torch.models.deeplab_v2 import DeepLabV2
    from hiast_tpu_torch.models.segformer import SegFormer

    if seg_model == "DeepLab_V2":
        model = DeepLabV2(num_classes=19, backbone_layers=(1, 1, 1, 1))
    else:
        model = SegFormer(num_classes=19, variant=seg_model.split("_")[1])
    model.init_weights(torch.Generator().manual_seed(5))
    torch.save(model.state_dict(), path)


def _overrides(root, seg_model="DeepLab_V2"):
    return [
        "model.type", "SelfTrainingSegmentor",
        "model.seg_model.type", seg_model,
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


def _generate_both(fixture_root, tmp_path, seg_model):
    """Artifacts of the JAX CLI and of the port's CLI on --device cpu."""
    from hiast_tpu.cli import generate_pseudo_labels as jax_cli
    from hiast_tpu_torch.cli import generate_pseudo_labels as port_cli
    from hiast_tpu_torch.ops.cuda import attention
    from hiast_tpu_torch.ops.cuda.select_kernel import launch_counts, reset_launch_counts

    pth = str(tmp_path / "weights.pth")
    _shared_pth(pth, seg_model)
    jax_dir = str(tmp_path / "jax" / "pseudo_label" / "gray_label")
    port_dir = str(tmp_path / "port" / "pseudo_label" / "gray_label")
    overrides = _overrides(fixture_root, seg_model)
    jax_cli.main(["--pseudo_resume_from", pth, "--pseudo_save_dir", jax_dir, *overrides])
    reset_launch_counts()
    attention.reset_launch_counts()
    port_cli.main(["--device", "cpu", "--pseudo_resume_from", pth, "--pseudo_save_dir", port_dir, *overrides])
    # CPU: plain versions only
    assert launch_counts == {"ias_hist": 0, "ias_select": 0}
    assert attention.launch_counts == {"sra_attention": 0}
    return _artifacts(jax_dir), _artifacts(port_dir)


def test_generation_cli_matches_jax_contract(fixture_root, tmp_path):
    want, got = _generate_both(fixture_root, tmp_path, "DeepLab_V2")
    _assert_same_contract(got, want, min_agree=0.98, max_thr_err=0.01)


def test_segformer_generation_cli_matches_jax_contract(fixture_root, tmp_path):
    want, got = _generate_both(fixture_root, tmp_path, "SegFormer_B0")
    _assert_same_contract(got, want, min_agree=0.98, max_thr_err=0.03, max_median_thr_err=0.002)


def _assert_same_contract(got, want, min_agree, max_thr_err, max_median_thr_err=None):
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
    thr_diff = np.abs(got["class_threshold"] - want["class_threshold"])
    thr_err = thr_diff.max()
    print(f"label agreement {agree:.4f}, max threshold difference {thr_err:.5f}")
    assert agree >= min_agree
    assert thr_err <= max_thr_err
    if max_median_thr_err is not None:
        assert np.median(thr_diff) <= max_median_thr_err
    assert np.all(np.isfinite(got["class_mean_probabilities"]))
