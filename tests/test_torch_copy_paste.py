"""The port's hard-aware copy-paste (hiast_tpu_torch/data/copy_paste.py,
HPA) against the JAX package's ``CopyPaste``, on the CPU.

Both read the same synthetic round (target images, their pseudo-labels,
``samples_with_class.json``) and take the same ``class_mean_probabilities``;
each draw comes from one ``np.random.Generator`` seed.  Donors share the
sample's size, so the paste is exact: ``CopyPaste.run`` and a dataset
sample with the preprocessor (image, label and ``copy_paste_mask``) agree
bit for bit, and with the 'MS' crop after it the labels and masks do and
the images within one level (the crop's own tolerance,
tests/test_torch_train_data.py).  Also SYNTHIA's +inf mask of its absent
classes, and degenerate statistics (every mean probability 1).
"""
import json
import os

import numpy as np
import pytest

from hiast_tpu.config import default_config as jax_default_config
from hiast_tpu.data.copy_paste import CopyPaste as JaxCopyPaste
from hiast_tpu.data.datasets import build_dataset as jax_build_dataset
from hiast_tpu_torch.config import default_config
from hiast_tpu_torch.data.copy_paste import CopyPaste
from hiast_tpu_torch.data.datasets import build_dataset
from hiast_tpu_torch.data.native_ops import PLAIN
from hiast_tpu_torch.data.png import write_png
from hiast_tpu_torch.registry import PREPROCESSOR, populate

N_IMAGES, IMG_H, IMG_W, C = 6, 60, 120, 19


@pytest.fixture(scope="module")
def round_root(tmp_path_factory):
    """Target images, full-size pseudo-labels with every class, and the
    round's samples_with_class.json beside gray_label/."""
    root = tmp_path_factory.mktemp("round")
    rng = np.random.default_rng(21)
    os.makedirs(root / "city" / "images")
    pseudo = root / "pseudo_label" / "gray_label"
    os.makedirs(pseudo)
    manifest, swc = [], {}
    for i in range(N_IMAGES):
        write_png(str(root / "city" / "images" / f"t_{i}.png"),
                  rng.integers(0, 256, size=(IMG_H, IMG_W, 3)).astype(np.uint8))
        write_png(str(root / "city" / "images" / f"t_{i}_lbl.png"), np.zeros((IMG_H, IMG_W), np.uint8))
        plbl = (rng.integers(0, C, size=(IMG_H // 10, IMG_W // 10)).repeat(10, 0).repeat(10, 1)).astype(np.uint8)
        plbl[rng.random(plbl.shape) < 0.2] = 255
        write_png(str(pseudo / f"t_{i}_pseudo_label.png"), plbl)
        manifest.append({"image_name": f"images/t_{i}.png", "mask_name": f"images/t_{i}_lbl.png"})
        for c in np.unique(plbl[plbl < C]):
            swc.setdefault(str(int(c)), []).append([f"t_{i}.png", int((plbl == c).sum())])
    (root / "target.json").write_text(json.dumps(manifest))
    (root / "pseudo_label" / "samples_with_class.json").write_text(json.dumps(swc))
    return root


def _pair(root, aug, source="GTAV", class_value=None):
    """(port dataset, JAX dataset), each with its CopyPaste set."""
    populate()
    pseudo = str(root / "pseudo_label" / "gray_label")
    if class_value is None:
        class_value = np.random.default_rng(4).uniform(0.4, 0.99, C).astype(np.float32)
    out = []
    for cfg in (default_config(), jax_default_config()):
        cfg.dataset.source.type = source
        cfg.dataset.target.type = "Cityscapes"
        cfg.dataset.target.json_path = str(root / "target.json")
        cfg.dataset.target.image_dir = str(root / "city")
        cfg.dataset.target.aug_type = aug
        cfg.dataset.crop_size = [30, 60]
        cfg.preprocessor.type = "CopyPaste"
        cfg.preprocessor.copy_paste.selected_num_classes = 14
        out.append(cfg)
    ds = build_dataset(out[0], "target", pseudo_dir=pseudo, host=PLAIN)
    ds.set_preprocessor(PREPROCESSOR["CopyPaste"](out[0], ds, class_value))
    jds = jax_build_dataset(out[1], "target", pseudo_dir=pseudo)
    jds.set_preprocessor(JaxCopyPaste(out[1], jds, class_value))
    return ds, jds


def test_run_matches_jax_bit_for_bit(round_root):
    ds, jds = _pair(round_root, [])
    cp, jcp = ds.preprocessor, jds.preprocessor
    np.testing.assert_array_equal(cp.hard_classes, jcp.hard_classes)
    np.testing.assert_array_equal(cp.class_probs, jcp.class_probs)
    pasted = 0
    for seed in range(8):
        img, lbl, _ = ds.load_data(seed % N_IMAGES)
        got = cp.run(img, lbl, np.random.default_rng(seed))
        want = jcp.run(img, lbl, np.random.default_rng(seed))
        for g, w, what in zip(got, want, ("image", "label", "copy_paste_mask")):
            assert g.dtype == w.dtype and g.shape == w.shape, what
            np.testing.assert_array_equal(g, w, err_msg=f"seed {seed}: {what}")
        pasted += int((got[2] != 255).sum())
        mask = got[2] != 255
        assert np.all(np.isin(got[2][mask], cp.hard_classes))
        np.testing.assert_array_equal(got[1][mask], got[2][mask])
    assert pasted > 0


@pytest.mark.parametrize("aug", [[], ["MS"]])
def test_dataset_sample_matches_jax(round_root, aug):
    ds, jds = _pair(round_root, aug)
    for i in range(N_IMAGES):
        got = ds.get_item(i, np.random.default_rng((7, 0, i)))
        want = jds.get_item(i, np.random.default_rng((7, 0, i)))
        assert sorted(got) == sorted(want) == ["copy_paste_mask", "image_paths", "images", "labels"]
        assert got["image_paths"] == want["image_paths"]
        np.testing.assert_array_equal(got["copy_paste_mask"], want["copy_paste_mask"])
        np.testing.assert_array_equal(got["labels"], want["labels"])
        if aug:
            assert got["images"].shape == (30, 60, 3)
            assert np.abs(got["images"].astype(int) - want["images"].astype(int)).max() <= 1
        else:
            np.testing.assert_array_equal(got["images"], want["images"])


def test_synthia_masks_its_absent_classes(round_root):
    ds, jds = _pair(round_root, [], source="SYNTHIA")
    cp, jcp = ds.preprocessor, jds.preprocessor
    assert np.all(np.isinf(cp.class_value[[9, 14, 16]]))
    assert not set(cp.hard_classes.tolist()) & {9, 14, 16}
    np.testing.assert_array_equal(cp.hard_classes, jcp.hard_classes)
    np.testing.assert_array_equal(cp.class_probs, jcp.class_probs)
    assert np.all(cp.class_probs[[9, 14, 16]] == 0)
    img, lbl, _ = ds.load_data(0)
    for seed in range(4):
        for g, w in zip(cp.run(img, lbl, np.random.default_rng(seed)), jcp.run(img, lbl, np.random.default_rng(seed))):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("source", ["GTAV", "SYNTHIA"])
def test_degenerate_stats_draw_uniformly(round_root, source):
    ds, jds = _pair(round_root, [], source=source, class_value=np.ones(C, np.float32))
    cp, jcp = ds.preprocessor, jds.preprocessor
    np.testing.assert_array_equal(cp.class_probs, jcp.class_probs)
    present = 16 if source == "SYNTHIA" else C
    np.testing.assert_allclose(cp.class_probs[cp.class_probs > 0], 1.0 / present)
    img, lbl, _ = ds.load_data(1)
    for seed in range(3):
        for g, w in zip(cp.run(img, lbl, np.random.default_rng(seed)), jcp.run(img, lbl, np.random.default_rng(seed))):
            np.testing.assert_array_equal(g, w)


def test_other_modes_are_refused(round_root):
    ds, _ = _pair(round_root, [])
    cfg = default_config()
    cfg.preprocessor.copy_paste.mode = "mixed"
    with pytest.raises(ValueError, match="original"):
        CopyPaste(cfg, ds, np.full(C, 0.9, np.float32))
