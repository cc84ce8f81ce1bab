"""The port's host data path: PNG codec, PRS resize, dataset and batching.

- ``data/png.py`` round-trips gray/RGB/RGBA exactly, reads what PIL writes
  (declining only what is not a PNG, for PIL to read), and its label
  encoder writes the bytes of the JAX package's layout (first row None,
  then Up, zlib level 1).
- ``Resize`` matches cv2: labels exactly (INTER_NEAREST), images within one
  intensity level (INTER_LINEAR; cv2 rounds its weights to 11 bits).
- The Cityscapes dataset and ``BatchIterator`` give the JAX package's images
  in the JAX package's order, for the same seed, and the val split at its
  native size with its labels.
- An unreadable file loads the neighbouring index in both packages.
"""
import io
import json
import os
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from hiast_tpu_torch.data import augment as A
from hiast_tpu_torch.data import png
from hiast_tpu_torch.data.native_ops import PLAIN
from hiast_tpu_torch.data.pipeline import BatchIterator, pad_batch

RNG = np.random.default_rng(33)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_round_trip(channels):
    shape = (37, 53) if channels == 1 else (37, 53, channels)
    arr = RNG.integers(0, 256, size=shape).astype(np.uint8)
    blob = png.encode_png(arr)
    np.testing.assert_array_equal(png.decode_png(blob), arr)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(blob))), arr)


def test_png_label_layout_is_up_filtered_level_1():
    lbl = RNG.integers(0, 19, size=(20, 30)).astype(np.uint8)
    blob = png.encode_png(lbl)
    raw = np.frombuffer(zlib.decompress(blob[8 + 25 + 8 : -12 - 4]), np.uint8).reshape(20, 31)
    assert raw[0, 0] == 0 and np.all(raw[1:, 0] == 2)
    np.testing.assert_array_equal(raw[1:, 1:], (lbl[1:].astype(int) - lbl[:-1]) % 256)


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
def test_reads_what_pil_writes(tmp_path, mode):
    from hiast_tpu_torch.data.datasets import read_gray, read_rgb

    shape = {"L": (40, 60), "RGB": (40, 60, 3), "RGBA": (40, 60, 4)}[mode]
    arr = RNG.integers(0, 256, size=shape).astype(np.uint8)
    path = str(tmp_path / f"x_{mode}.png")
    Image.fromarray(arr, mode=mode).save(path)
    np.testing.assert_array_equal(png.decode_png_file(path), arr)
    if mode == "L":
        np.testing.assert_array_equal(read_gray(path), arr)
    else:
        np.testing.assert_array_equal(read_rgb(path), arr[..., :3])


def test_declines_what_it_does_not_read(tmp_path):
    """Bytes that are not a PNG, and a file that is not a .png, are left to
    PIL (None); a 16-bit PNG, which the codec once declined, now reads as
    uint16 (tests/test_torch_png.py covers every format)."""
    sixteen = RNG.integers(0, 65535, size=(8, 8)).astype(np.uint16)
    buf = io.BytesIO()
    Image.fromarray(sixteen).save(buf, format="PNG")
    decoded = png.decode_png(buf.getvalue())
    assert decoded.dtype == np.uint16
    np.testing.assert_array_equal(decoded, sixteen)
    assert png.decode_png(b"not a png") is None
    assert png.decode_png_file(str(tmp_path / "x.jpg")) is None


@pytest.mark.parametrize("src,dst", [((64, 128), (32, 64)), ((50, 70), (64, 128)), ((97, 131), (40, 90))])
def test_resize_follows_cv2(src, dst):
    img = RNG.integers(0, 256, size=src + (3,)).astype(np.uint8)
    lbl = RNG.integers(0, 19, size=src).astype(np.uint8)
    got_img, got_lbl = A.Resize(*dst, host=PLAIN)(img, lbl)
    want_img = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR)
    want_lbl = cv2.resize(lbl, dst[::-1], interpolation=cv2.INTER_NEAREST)
    np.testing.assert_array_equal(got_lbl, want_lbl)
    assert np.abs(got_img.astype(int) - want_img).max() <= 1


def test_resize_skips_matching_sizes():
    img = RNG.integers(0, 256, size=(16, 32, 3)).astype(np.uint8)
    lbl = RNG.integers(0, 19, size=(16, 32)).astype(np.uint8)
    got_img, got_lbl = A.Resize(16, 32, host=PLAIN)(img, lbl)
    assert got_img is img and got_lbl is lbl


def test_aug_type_parsing():
    assert A.parse_resize_params("PRS-768-1536") == (768, 1536)
    assert A.split_aug_types(["PRS-8-16", "CCA"]) == (["PRS-8-16"], "CCA")
    with pytest.raises(ValueError):
        A.parse_resize_params("PRS-768")


def test_dataset_and_batches_match_jax(tmp_path):
    from hiast_tpu.config import default_config as jax_default_config
    from hiast_tpu.data.datasets import build_dataset as jax_build_dataset
    from hiast_tpu.data.pipeline import BatchIterator as JaxBatchIterator
    from hiast_tpu_torch.config import default_config
    from hiast_tpu_torch.data.datasets import build_dataset
    from hiast_tpu_torch.registry import populate

    populate()
    os.makedirs(tmp_path / "images")
    manifest = []
    for i in range(5):
        png.write_png(str(tmp_path / "images" / f"c_{i}.png"),
                      RNG.integers(0, 256, size=(32, 48, 3)).astype(np.uint8))
        png.write_png(str(tmp_path / "images" / f"c_{i}_lbl.png"),
                      RNG.integers(0, 19, size=(32, 48)).astype(np.uint8))
        manifest.append({"image_name": f"images/c_{i}.png", "mask_name": f"images/c_{i}_lbl.png"})
    (tmp_path / "m.json").write_text(json.dumps(manifest))

    def configure(cfg):
        cfg.dataset.target.type = "Cityscapes"
        cfg.dataset.target.json_path = str(tmp_path / "m.json")
        cfg.dataset.target.image_dir = str(tmp_path)
        return cfg

    ours = build_dataset(configure(default_config()), "target", aug_type=["PRS-32-48"],
                         host=PLAIN)
    theirs = jax_build_dataset(configure(jax_default_config()), "target", aug_type=["PRS-32-48"])
    got = list(BatchIterator(ours, 2, shuffle=True, seed=888, drop_last=False))
    want = list(JaxBatchIterator(theirs, 2, shuffle=True, seed=888, drop_last=False))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g["image_paths"] == w["image_paths"]
        np.testing.assert_array_equal(g["images"], w["images"])
        np.testing.assert_array_equal(g["labels"], w["labels"])
    tail = pad_batch(got[-1], 2)
    assert tail["n_valid"] == 1 and tail["images"].shape[0] == 2 and np.all(tail["labels"][1] == 255)


def _cityscapes_pair(tmp_path, n, shape=(32, 48)):
    """(port dataset builder, JAX dataset builder) over n written images."""
    from hiast_tpu.config import default_config as jax_default_config
    from hiast_tpu.data.datasets import build_dataset as jax_build_dataset
    from hiast_tpu_torch.config import default_config
    from hiast_tpu_torch.data.datasets import build_dataset
    from hiast_tpu_torch.registry import populate

    populate()
    os.makedirs(tmp_path / "images")
    manifest = []
    for i in range(n):
        png.write_png(str(tmp_path / "images" / f"v_{i}.png"),
                      RNG.integers(0, 256, size=shape + (3,)).astype(np.uint8))
        png.write_png(str(tmp_path / "images" / f"v_{i}_lbl.png"),
                      RNG.integers(0, 19, size=shape).astype(np.uint8))
        manifest.append({"image_name": f"images/v_{i}.png", "mask_name": f"images/v_{i}_lbl.png"})
    (tmp_path / "m.json").write_text(json.dumps(manifest))

    def configure(cfg):
        cfg.dataset.val.type = "Cityscapes"
        cfg.dataset.val.json_path = str(tmp_path / "m.json")
        cfg.dataset.val.image_dir = str(tmp_path)
        return cfg

    return (
        lambda: build_dataset(configure(default_config()), "val", aug_type=[], host=PLAIN),
        lambda: jax_build_dataset(configure(jax_default_config()), "val", aug_type=[]),
    )


def test_val_split_at_native_size_matches_jax(tmp_path):
    ours, theirs = _cityscapes_pair(tmp_path, 3, shape=(40, 72))
    got = list(BatchIterator(ours(), 2, shuffle=False, drop_last=False))
    want = list(BatchIterator(theirs(), 2, shuffle=False, drop_last=False))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g["image_paths"] == w["image_paths"]
        assert g["images"].shape[1:] == (40, 72, 3) and g["labels"].shape[1:] == (40, 72)
        np.testing.assert_array_equal(g["images"], w["images"])
        np.testing.assert_array_equal(g["labels"], w["labels"])


@pytest.mark.parametrize("corrupt", [0, 2])
def test_unreadable_file_loads_the_neighbour_as_in_jax(tmp_path, capsys, corrupt):
    """A corrupt PNG is reported with the JAX package's '## ... loading index'
    line and the neighbouring index (the next one for index 0, else the one
    before) is returned instead, by both packages."""
    ours, theirs = _cityscapes_pair(tmp_path, 4)
    with open(tmp_path / "images" / f"v_{corrupt}.png", "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + b"not a png" * 10)
    rng = np.random.default_rng(0)
    got = ours().get_item(corrupt, rng)
    out = capsys.readouterr().out
    want = theirs().get_item(corrupt, rng)
    neighbour = 1 if corrupt == 0 else corrupt - 1
    assert f"loading index {corrupt}: " in out and out.startswith("## ")
    assert got["image_paths"] == want["image_paths"] == str(tmp_path / "images" / f"v_{neighbour}.png")
    np.testing.assert_array_equal(got["images"], want["images"])
    np.testing.assert_array_equal(got["labels"], want["labels"])
