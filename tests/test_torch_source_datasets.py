"""The port's source and Oxford datasets and the 'DACS' / 'FDA-*' augs
(hiast_tpu_torch/data/datasets.py, data/augment.py) against the JAX
package's, on synthetic files written by the port's PNG encoder.

- ``read_label``: the same bytes, exactly, for GTA5 palette labels in GTA
  ids, SYNTHIA 16-bit RGB labels, Cityscapes labels remapped to 9 classes
  and Oxford labels of every kind the JAX reader takes apart: 8-bit gray,
  gray+alpha, RGB, RGBA and palette, 16-bit gray, gray+alpha, RGB and RGBA
  (the JAX reader hands 16-bit files to PIL), and the unlabelled train
  split (all 255).
- ``get_item`` with the same ``np.random.Generator`` seed: labels exactly
  equal for every aug; images exactly equal for 'PRS' from a file at the
  target size, and within one intensity level where the port's numpy
  resizes stand in for cv2's ('DACS', 'PRS' that resizes: cv2 rounds its
  weights to 11-bit fixed point) or for the JAX package's C++
  crop-flip-resize ('MS', 'OMS': float sums in another order, as
  tests/test_torch_train_data.py holds them).
- 'FDA-Target' / 'FDA-Source': the same draws taken, and the image within
  one intensity level of JAX's: the target image is resized by the port's
  bilinear resize, and a one-level change in it moves every output value
  by a fraction, so the truncation to uint8 falls on the other side of an
  integer for some values (7-15% measured).  Given the same target pixels,
  the port's FDA gives JAX's bytes exactly.
"""
import json
import os

import numpy as np
import pytest

from hiast_tpu.config import default_config as jax_default_config
from hiast_tpu.data.datasets import build_dataset as jax_build_dataset
from hiast_tpu.registry import populate as jax_populate
from hiast_tpu_torch.config import default_config
from hiast_tpu_torch.data.datasets import build_dataset
from hiast_tpu_torch.data.png import unfilter_plain, write_png
from hiast_tpu_torch.data.remap import GTAV_ID_MAP, OXFORD_ID_MAP, SYNTHIA_ID_MAP
from hiast_tpu_torch.registry import populate

RNG = np.random.default_rng(29)
GTA_H, GTA_W = 130, 240  # GTA5's 1052x1914 shape, cut down
SYN_H, SYN_W = 96, 160
OX_H, OX_W = 120, 160
CITY_H, CITY_W = 64, 128


def _ids(keys, shape):
    """Raw label ids: the dataset's own ids, and some it does not map."""
    return RNG.choice(list(keys) + [0, 1, 250], size=shape)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("source_sets")
    palette = RNG.integers(0, 256, size=(256, 3)).astype(np.uint8)
    manifests = {name: [] for name in ("gtav", "synthia", "city", "oxford_train", "oxford_val")}

    def add(name, image, label_name, label):
        os.makedirs(root / name, exist_ok=True)
        i = len(manifests[name])
        write_png(str(root / name / f"{i}.png"), image)
        if label is not None:
            write = label if callable(label) else (lambda path, arr=label: write_png(path, arr))
            write(str(root / name / label_name))
        manifests[name].append({"image_name": f"{name}/{i}.png", "mask_name": f"{name}/{label_name}"})

    for i in range(3):
        add("gtav", RNG.integers(0, 256, size=(GTA_H, GTA_W, 3)).astype(np.uint8), f"{i}_lbl.png",
            lambda path: write_png(path, _ids(GTAV_ID_MAP, (GTA_H, GTA_W)).astype(np.uint8), palette=palette))
        syn = np.zeros((SYN_H, SYN_W, 3), np.uint16)
        syn[..., 0] = _ids(SYNTHIA_ID_MAP, (SYN_H, SYN_W))
        syn[::7, ::5, 0] = 300 + i  # above 255: clipped
        syn[..., 1:] = RNG.integers(0, 65536, size=(SYN_H, SYN_W, 2))
        add("synthia", RNG.integers(0, 256, size=(SYN_H, SYN_W, 3)).astype(np.uint8), f"{i}_lbl.png", syn)
        add("city", RNG.integers(0, 256, size=(CITY_H, CITY_W, 3)).astype(np.uint8), f"{i}_lbl.png",
            RNG.integers(0, 19, size=(CITY_H, CITY_W)).astype(np.uint8))
        add("oxford_train", RNG.integers(0, 256, size=(OX_H, OX_W, 3)).astype(np.uint8), f"{i}.png.nolabel", None)

    ox = _ids(OXFORD_ID_MAP, (OX_H, OX_W))
    noise = RNG.integers(0, 65536, size=(OX_H, OX_W, 4))
    kinds = {
        "gray8": ox.astype(np.uint8),
        "gray_alpha8": np.stack([ox, noise[..., 0] % 256], -1).astype(np.uint8),
        "rgb8": np.stack([ox, noise[..., 0] % 256, noise[..., 1] % 256], -1).astype(np.uint8),
        "rgba8": np.concatenate([ox[..., None], noise[..., :3] % 256], -1).astype(np.uint8),
        "gray16": (ox + 256 * (noise[..., 0] % 256)).astype(np.uint16),  # PIL keeps the low byte
        "gray_alpha16": np.stack([ox * 256 + noise[..., 0] % 256, noise[..., 1]], -1).astype(np.uint16),
        "rgb16": np.concatenate([(ox * 256 + noise[..., 0] % 256)[..., None], noise[..., 1:3]], -1).astype(np.uint16),
        "rgba16": np.concatenate([(ox * 256 + noise[..., 0] % 256)[..., None], noise[..., 1:]], -1).astype(np.uint16),
    }
    for kind, lbl in kinds.items():
        add("oxford_val", RNG.integers(0, 256, size=(OX_H, OX_W, 3)).astype(np.uint8), f"{kind}.png", lbl)
    add("oxford_val", RNG.integers(0, 256, size=(OX_H, OX_W, 3)).astype(np.uint8), "palette8.png",
        lambda path: write_png(path, ox.astype(np.uint8), palette=palette))
    for name, entries in manifests.items():
        (root / f"{name}.json").write_text(json.dumps(entries))
    return root


SECTIONS = {  # dataset type -> (manifest, number of classes)
    "GTAV": ("gtav", 19),
    "SYNTHIA": ("synthia", 19),
    "Cityscapes": ("city", 9),
    "Oxford": ("oxford_val", 9),
}


def _cfgs(root, source: str, target: str):
    out = []
    for cfg, pop in ((jax_default_config(), jax_populate), (default_config(), populate)):
        pop()
        cfg.dataset.crop_size = [32, 64]
        cfg.dataset.num_classes = SECTIONS[source][1] if source != "Cityscapes" else SECTIONS[target][1]
        for section, kind in (("source", source), ("target", target), ("val", target)):
            node = getattr(cfg.dataset, section)
            node.type = kind
            node.json_path = str(root / f"{SECTIONS[kind][0]}.json")
            node.image_dir = str(root)
        out.append(cfg)
    return out


def _both(root, source, target, section, aug_type):
    jcfg, cfg = _cfgs(root, source, target)
    return (jax_build_dataset(jcfg, section, aug_type=aug_type),
            build_dataset(cfg, section, aug_type=aug_type, unfilter=unfilter_plain))


@pytest.mark.parametrize("kind", ["GTAV", "SYNTHIA", "Cityscapes", "Oxford"])
def test_read_label_matches_jax(root, kind):
    source, target = (kind, "Cityscapes") if kind in ("GTAV", "SYNTHIA") else ("Cityscapes", "Oxford")
    section = "source" if kind == source else "target"
    if kind == "Oxford":
        section = "val"
    want_ds, got_ds = _both(root, source, target, section, [])
    for i, path in enumerate(got_ds.lbl_paths):
        want, got = want_ds.read_label(path), got_ds.read_label(path)
        assert got.dtype == np.uint8 and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=os.path.basename(path))
        n_classes = 9 if kind in ("Oxford", "Cityscapes") else 19
        assert bool(np.all((got < n_classes) | (got == 255))) and bool((got < n_classes).any()), path
    if kind == "SYNTHIA":  # ids above 255 are clipped to 255, which maps to ignore
        assert bool((got_ds.read_label(got_ds.lbl_paths[0])[::7, ::5] == 255).all())


def test_oxford_unlabelled_split_is_ignored(root):
    jcfg, cfg = _cfgs(root, "Cityscapes", "Oxford")
    for c in (jcfg, cfg):
        c.dataset.target.json_path = str(root / "oxford_train.json")
    want_ds = jax_build_dataset(jcfg, "target", aug_type=[])
    ds = build_dataset(cfg, "target", aug_type=[], unfilter=unfilter_plain)
    assert ds.read_label(ds.lbl_paths[0]) is None
    img, lbl, _ = ds.load_data(0)
    assert lbl.shape == img.shape[:2] and bool((lbl == 255).all())
    np.testing.assert_array_equal(img, want_ds.load_data(0)[0])


CASES = [  # (source, target, section, aug_type, image tolerance in levels)
    ("GTAV", "Cityscapes", "source", ["MS"], 1),
    ("GTAV", "Cityscapes", "source", ["DACS"], 1),
    ("GTAV", "Cityscapes", "source", ["PRS-64-128"], 1),
    ("SYNTHIA", "Cityscapes", "source", ["MS"], 1),
    ("SYNTHIA", "Cityscapes", "source", ["DACS"], 1),
    ("Cityscapes", "Oxford", "source", ["DACS"], 1),
    ("Cityscapes", "Oxford", "source", ["OMS"], 1),
    ("Cityscapes", "Oxford", "val", ["OMS"], 1),
    ("Cityscapes", "Oxford", "val", [f"PRS-{OX_H}-{OX_W}"], 0),
]


@pytest.mark.parametrize("source,target,section,aug_type,tol", CASES,
                         ids=[f"{c[0] if c[2] == 'source' else c[1]}-{c[3][0]}" for c in CASES])
def test_get_item_matches_jax(root, source, target, section, aug_type, tol):
    want_ds, got_ds = _both(root, source, target, section, aug_type)
    for i in range(len(got_ds)):
        want = want_ds.get_item(i, np.random.default_rng(100 + i))
        got = got_ds.get_item(i, np.random.default_rng(100 + i))
        assert got["image_paths"] == want["image_paths"]
        assert got["images"].shape == want["images"].shape and got["images"].dtype == np.uint8
        np.testing.assert_array_equal(got["labels"], want["labels"])
        diff = np.abs(got["images"].astype(np.int16) - want["images"].astype(np.int16))
        assert int(diff.max()) <= tol, f"sample {i}: image off by {int(diff.max())} levels"


@pytest.mark.parametrize("source,target,section,aug_type", [
    ("GTAV", "Cityscapes", "source", ["FDA-Target"]),
    ("SYNTHIA", "Cityscapes", "source", ["FDA-Target"]),
    ("Cityscapes", "Oxford", "source", ["FDA-Target"]),
    ("Cityscapes", "Oxford", "val", ["FDA-Source"]),
])
def test_fda_matches_jax(root, source, target, section, aug_type):
    want_ds, got_ds = _both(root, source, target, section, aug_type)
    for i in range(len(got_ds)):
        rng_want, rng_got = np.random.default_rng(7 + i), np.random.default_rng(7 + i)
        want = want_ds.get_item(i, rng_want)
        got = got_ds.get_item(i, rng_got)
        assert rng_got.random() == rng_want.random()  # the same draws taken
        np.testing.assert_array_equal(got["labels"], want["labels"])
        diff = np.abs(got["images"].astype(np.int16) - want["images"].astype(np.int16))
        assert int(diff.max()) <= 1, f"sample {i}: {int(diff.max())} levels"
        img = got_ds.load_data(i)[0]
        assert not np.array_equal(got["images"], img)  # the amplitudes moved
        # the same target pixels: the same bytes
        target = got_ds.aug_fns[0]._load_target(np.random.default_rng(7 + i), img.shape[:2])
        port_fda, jax_fda = got_ds.aug_fns[0], want_ds.aug_fns[0]
        port_fda._load_target = jax_fda._load_target = lambda rng, shape: target
        np.testing.assert_array_equal(port_fda(img, None, None)[0], jax_fda(img, None, None)[0])
