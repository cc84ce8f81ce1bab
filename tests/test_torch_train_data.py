"""The port's training data path against the JAX package's, on the CPU:
the 'MS' geometric aug, the Cityscapes target set read with pseudo-labels
(``pseudo_dir``), and the ``infinite_batches`` stream.

Tolerances: labels and batch order exactly; MS images within one intensity
level (the JAX package's C++ op, or its cv2 fallback, and the port's numpy
version round the bilinear sums in other orders).
"""
import json
import os

import numpy as np
import pytest

from hiast_tpu.config import default_config as jax_default_config
from hiast_tpu.data import augment as JA
from hiast_tpu.data.datasets import build_dataset as jax_build_dataset
from hiast_tpu.data.pipeline import infinite_batches as jax_infinite_batches
from hiast_tpu_torch.config import default_config
from hiast_tpu_torch.data import augment as A
from hiast_tpu_torch.data.datasets import build_dataset
from hiast_tpu_torch.data.pipeline import infinite_batches
from hiast_tpu_torch.data.png import unfilter_plain, write_png

N_IMAGES, IMG_H, IMG_W = 7, 120, 240


@pytest.mark.parametrize("seed", range(6))
def test_ms_crop_matches_jax(seed):
    rng = np.random.default_rng(100 + seed)
    img = rng.integers(0, 256, size=(512, 1024, 3)).astype(np.uint8)
    lbl = rng.integers(0, 256, size=(512, 1024)).astype(np.uint8)
    want_img, want_lbl = JA.GeometricAug(64, 128, (341, 1000), 2)(img, lbl, np.random.default_rng(seed))
    got_img, got_lbl = A.GeometricAug(64, 128, (341, 1000), 2)(img, lbl, np.random.default_rng(seed))
    assert got_img.shape == (64, 128, 3) and got_img.dtype == np.uint8 and got_lbl.shape == (64, 128)
    np.testing.assert_array_equal(got_lbl, want_lbl)
    assert np.abs(got_img.astype(int) - want_img.astype(int)).max() <= 1


@pytest.mark.parametrize("flip", [False, True])
def test_crop_flip_resize_matches_a_plain_crop(flip):
    """An upscale of a crop: the port's fused op equals cropping, flipping
    and resizing in three steps with the port's own resizes."""
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, size=(50, 80, 3)).astype(np.uint8)
    lbl = rng.integers(0, 19, size=(50, 80)).astype(np.uint8)
    got_img, got_lbl = A.crop_flip_resize(img, lbl, 5, 9, 30, 60, flip, 45, 90)
    ci, cl = img[5:35, 9:69], lbl[5:35, 9:69]
    if flip:
        ci, cl = ci[:, ::-1], cl[:, ::-1]
    np.testing.assert_array_equal(got_lbl, A.resize_nearest(cl, 45, 90))
    assert np.abs(got_img.astype(int) - A.resize_linear(np.ascontiguousarray(ci), 45, 90).astype(int)).max() <= 1


@pytest.fixture(scope="module")
def target_root(tmp_path_factory):
    """Target images, their pseudo-labels at half size (so the dataset
    resizes them), and a samples_with_class.json beside gray_label/."""
    root = tmp_path_factory.mktemp("target")
    rng = np.random.default_rng(3)
    os.makedirs(root / "city" / "images")
    pseudo = root / "pseudo_label" / "gray_label"
    os.makedirs(pseudo)
    manifest, swc = [], {}
    for i in range(N_IMAGES):
        write_png(str(root / "city" / "images" / f"t_{i}.png"),
                  rng.integers(0, 256, size=(IMG_H, IMG_W, 3)).astype(np.uint8))
        write_png(str(root / "city" / "images" / f"t_{i}_lbl.png"),
                  rng.integers(0, 19, size=(IMG_H, IMG_W)).astype(np.uint8))
        plbl = rng.integers(0, 19, size=(IMG_H // 2, IMG_W // 2)).astype(np.uint8)
        plbl[rng.random(plbl.shape) < 0.3] = 255
        write_png(str(pseudo / f"t_{i}_pseudo_label.png"), plbl)
        manifest.append({"image_name": f"images/t_{i}.png", "mask_name": f"images/t_{i}_lbl.png"})
        for c in np.unique(plbl[plbl < 19]):
            swc.setdefault(str(int(c)), []).append([f"t_{i}.png", int((plbl == c).sum())])
    (root / "target.json").write_text(json.dumps(manifest))
    (root / "pseudo_label" / "samples_with_class.json").write_text(json.dumps(swc))
    return root


def _cfgs(root, aug):
    out = []
    for cfg in (jax_default_config(), default_config()):
        cfg.dataset.target.type = "Cityscapes"
        cfg.dataset.target.json_path = str(root / "target.json")
        cfg.dataset.target.image_dir = str(root / "city")
        cfg.dataset.target.aug_type = aug
        cfg.dataset.crop_size = [48, 96]
        out.append(cfg)
    return out


@pytest.mark.parametrize("aug", [[], ["MS"]])
def test_pseudo_label_dataset_matches_jax(target_root, aug):
    jcfg, cfg = _cfgs(target_root, aug)
    pseudo = str(target_root / "pseudo_label" / "gray_label")
    jds = jax_build_dataset(jcfg, "target", pseudo_dir=pseudo)
    ds = build_dataset(cfg, "target", pseudo_dir=pseudo, unfilter=unfilter_plain)
    assert len(ds) == len(jds) == N_IMAGES
    assert ds.get_samples_with_class() == jds.get_samples_with_class()
    assert ds.get_file_to_idx("t_3.png") == jds.get_file_to_idx("t_3.png") == 3
    for i in range(N_IMAGES):
        want = jds.get_item(i, np.random.default_rng((5, 0, i)))
        got = ds.get_item(i, np.random.default_rng((5, 0, i)))
        assert got["image_paths"] == want["image_paths"]
        np.testing.assert_array_equal(got["labels"], want["labels"])
        assert np.abs(got["images"].astype(int) - want["images"].astype(int)).max() <= (1 if aug else 0)
        if not aug:  # the half-size pseudo-label was resized to the image
            assert got["labels"].shape == (IMG_H, IMG_W)


@pytest.mark.parametrize("num_workers", [0, 2])
def test_infinite_batches_order_matches_jax(target_root, num_workers):
    """Three epochs of batches of 3 from 7 images (each epoch drops its
    partial batch): the same files in the same order, the same labels."""
    jcfg, cfg = _cfgs(target_root, ["MS"])
    pseudo = str(target_root / "pseudo_label" / "gray_label")
    jstream = jax_infinite_batches(jax_build_dataset(jcfg, "target", pseudo_dir=pseudo), 3, seed=9,
                                   num_workers=num_workers)
    stream = infinite_batches(build_dataset(cfg, "target", pseudo_dir=pseudo, unfilter=unfilter_plain), 3,
                              seed=9, num_workers=num_workers)
    for _ in range(6):
        want, got = next(jstream), next(stream)
        assert got["image_paths"] == want["image_paths"]
        np.testing.assert_array_equal(got["labels"], want["labels"])
        assert got["images"].shape == (3, 48, 96, 3)


def test_infinite_batches_refuses_a_dataset_smaller_than_a_batch(target_root):
    """The JAX stream would spin without yielding here (every epoch drops its
    one partial batch); the port's raises at once."""
    _, cfg = _cfgs(target_root, ["MS"])
    ds = build_dataset(cfg, "target", pseudo_dir=str(target_root / "pseudo_label" / "gray_label"),
                       unfilter=unfilter_plain)
    with pytest.raises(ValueError, match="fewer than one batch"):
        infinite_batches(ds, N_IMAGES + 1)


def test_unported_augs_raise(target_root):
    """Every aug of the JAX package is ported ('DACS' and 'FDA-*' since the
    source datasets came): an aug type the dataset does not know raises
    ValueError, as the JAX package's does."""
    for aug in (["RandomErase"], ["FDA-Sourc"]):
        jcfg, cfg = _cfgs(target_root, aug)
        with pytest.raises(ValueError, match="invalid aug_type"):
            jax_build_dataset(jcfg, "target")
        with pytest.raises(ValueError, match="invalid aug_type"):
            build_dataset(cfg, "target", unfilter=unfilter_plain)
    _, cfg = _cfgs(target_root, ["DACS"])
    assert len(build_dataset(cfg, "target", unfilter=unfilter_plain).aug_fns) == 1
