"""The port's fused host ops (``csrc/host_ops.cpp`` through
``data/native_ops.py``), built here with the host C++ compiler, against
their plain numpy versions and against the JAX package's native library.

- Each native op gives its plain version's bytes, bit for bit: the 'MS'
  crop, flip and resize up and down, at the image's edges, on images of 3
  channels and on labels; the bilinear and nearest resizes on [H, W] and
  [H, W, 3] at odd sizes; the paste with an empty, a full and a partial
  class table; the PNG row unfilter under every filter type.
- The whole ``get_item`` path (CopyPaste or ClassMix, 'MS' and the dcst
  mask replay on a Cityscapes target set; 'DACS' and FDA on GTA5) gives the
  same sample and leaves the generator in the same state with ``NATIVE``
  as with ``PLAIN``.
- Against ``hiast_tpu.data.native_ops`` (the JAX package's C++ library):
  the MS crop's labels and the paste are equal, the MS crop's images within
  one level (that library may fuse a multiply-add where numpy rounds
  twice).
- ``host_ops_for`` picks the set by device type; a missing or failing
  compiler raises; the wrappers refuse what C would read or write out of
  bounds, and outputs written in place that are not C-contiguous uint8.
"""
import json
import os
import shutil

import numpy as np
import pytest

from hiast_tpu.data import native_ops as jax_native_ops
from hiast_tpu_torch.config import default_config
from hiast_tpu_torch.data import augment as A
from hiast_tpu_torch.data import copy_paste, native_ops, png
from hiast_tpu_torch.data.datasets import build_dataset
from hiast_tpu_torch.data.native_ops import NATIVE, PLAIN, host_ops_for
from hiast_tpu_torch.data.png import write_png
from hiast_tpu_torch.ops.cuda import build
from hiast_tpu_torch.registry import PREPROCESSOR, populate


@pytest.fixture(scope="module", autouse=True)
def library():
    """Build (or find built) the port's host library once for the module."""
    cxx = os.environ.get("CXX") or "c++"
    if shutil.which(cxx) is None:
        pytest.skip(f"no host C++ compiler ({cxx!r}) to build csrc/host_ops.cpp")
    return native_ops._library()


def _image(seed, h, w, c=3):
    return np.random.default_rng(seed).integers(0, 256, size=(h, w, c) if c else (h, w)).astype(np.uint8)


# (h, w, y0, x0, ch, cw, oh, ow): down, up, a crop at each corner, the whole image, a 1-pixel crop
CROPS = [
    (120, 240, 10, 20, 90, 180, 37, 61),
    (37, 61, 3, 5, 20, 30, 64, 96),
    (120, 240, 0, 0, 64, 128, 48, 96),
    (120, 240, 56, 112, 64, 128, 80, 160),
    (61, 37, 0, 0, 61, 37, 61, 37),
    (40, 80, 39, 79, 1, 1, 3, 5),
]


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("h,w,y0,x0,ch,cw,oh,ow", CROPS)
def test_crop_flip_resize_native_equals_plain(h, w, y0, x0, ch, cw, oh, ow, flip):
    img, lbl = _image(1, h, w), _image(2, h, w, 0)
    got = native_ops.crop_flip_resize_native(img, lbl, y0, x0, ch, cw, flip, oh, ow)
    want = A.crop_flip_resize(img, lbl, y0, x0, ch, cw, flip, oh, ow)
    for g, w_, what in zip(got, want, ("image", "label")):
        assert g.dtype == np.uint8 and g.shape == w_.shape, what
        np.testing.assert_array_equal(g, w_, err_msg=what)


@pytest.mark.parametrize("channels", [0, 3])
@pytest.mark.parametrize("h,w,oh,ow", [(37, 61, 120, 240), (120, 240, 37, 61), (61, 37, 61, 73), (1, 5, 3, 2),
                                       (99, 101, 99, 101)])
def test_resizes_native_equal_plain(h, w, oh, ow, channels):
    img = _image(3, h, w, channels)
    np.testing.assert_array_equal(native_ops.resize_linear_native(img, oh, ow), A.resize_linear(img, oh, ow))
    np.testing.assert_array_equal(native_ops.resize_nearest_native(img, oh, ow), A.resize_nearest(img, oh, ow))


def test_resize_linear_rounds_half_to_even():
    """Halving [2, 3, 5, 6] lands both taps half-way: 2.5 and 5.5, which
    np.rint (and so the native op) rounds to the even 2 and 6."""
    img = np.array([[2, 3, 5, 6]], np.uint8)
    got = native_ops.resize_linear_native(img, 1, 2)
    np.testing.assert_array_equal(got, A.resize_linear(img, 1, 2))
    np.testing.assert_array_equal(got, [[2, 6]])


def _paste_inputs(seed, h=60, w=120):
    rng = np.random.default_rng(seed)
    img, donor_img = _image(seed, h, w), _image(seed + 1, h, w)
    lbl = rng.integers(0, 19, size=(h, w)).astype(np.uint8)
    donor_lbl = rng.integers(0, 19, size=(h, w)).astype(np.uint8)
    donor_lbl[rng.random((h, w)) < 0.2] = 255
    return img, lbl, np.full((h, w), 255, np.uint8), donor_img, donor_lbl


@pytest.mark.parametrize("classes", ["none", "all", "hard"])
def test_paste_native_equals_plain(classes):
    lut = np.zeros(256, bool)
    if classes == "all":
        lut[:] = True
    elif classes == "hard":
        lut[[1, 4, 5, 11, 17]] = True
    plain = _paste_inputs(5)
    native = tuple(a.copy() for a in plain)
    copy_paste.paste_hard_classes(*plain, lut)
    native_ops.paste_hard_classes_native(*native, lut)
    for g, w, what in zip(native[:3], plain[:3], ("image", "label", "copy_paste_mask")):
        np.testing.assert_array_equal(g, w, err_msg=what)
    pasted = native[2] != 255
    if classes == "none":
        assert not pasted.any()
    elif classes == "all":  # 255 is in the table too: every pixel is the donor's
        np.testing.assert_array_equal(native[0], native[3])
        np.testing.assert_array_equal(native[2], native[4])
    else:
        assert 0 < pasted.sum() < pasted.size


@pytest.mark.parametrize("h,w,channels", [(64, 96, 3), (33, 17, 4), (40, 2048, 1)])
def test_png_unfilter_native_matches_plain(h, w, channels):
    """The C unfilter (the card's path) gives the plain one's bytes on rows
    under every filter type, and names the first row of an unknown one."""
    rng = np.random.default_rng(h)
    raw = rng.integers(0, 256, size=(h, w * channels + 1)).astype(np.uint8)
    raw[:, 0] = np.arange(h) % 5
    np.testing.assert_array_equal(native_ops.unfilter_native(raw, channels), png.unfilter_plain(raw, channels))
    raw[h // 2, 0] = 9
    with pytest.raises(ValueError, match=f"row {h // 2} has filter type 9"):
        native_ops.unfilter_native(raw, channels)


# -- against the JAX package's native library ------------------------------------------
@pytest.fixture(scope="module")
def jax_lib():
    lib = jax_native_ops.get_lib()
    if lib is None:
        pytest.skip("the JAX package's native library did not build here")
    return lib


@pytest.mark.parametrize("seed", range(4))
def test_ms_crop_and_paste_match_the_jax_library(jax_lib, seed):
    rng = np.random.default_rng(40 + seed)
    img, lbl = _image(seed, 120, 240), _image(seed + 9, 120, 240, 0)
    ch = int(rng.integers(20, 120))
    cw = min(2 * ch, 240)
    y0, x0, flip = int(rng.integers(0, 120 - ch + 1)), int(rng.integers(0, 240 - cw + 1)), bool(seed % 2)
    got_img, got_lbl = native_ops.crop_flip_resize_native(img, lbl, y0, x0, ch, cw, flip, 48, 96)
    want_img, want_lbl = jax_native_ops.crop_flip_resize(img, lbl, y0, x0, ch, cw, flip, 48, 96)
    np.testing.assert_array_equal(got_lbl, want_lbl)
    assert np.abs(got_img.astype(int) - want_img.astype(int)).max() <= 1

    lut = np.zeros(256, bool)
    lut[rng.choice(19, size=9, replace=False)] = True
    got = _paste_inputs(seed)
    want = tuple(a.copy() for a in got)
    native_ops.paste_hard_classes_native(*got, lut)
    jax_native_ops.paste_hard_classes(*want, lut)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w)


# -- the switch, the build and the wrappers' checks ---------------------------------------
def test_host_ops_for_picks_by_device_type():
    assert host_ops_for("cuda") is NATIVE
    assert host_ops_for("cpu") is PLAIN
    with pytest.raises(ValueError, match="mps"):
        host_ops_for("mps")
    assert NATIVE.unfilter is native_ops.unfilter_native and PLAIN.unfilter is png.unfilter_plain


def test_a_missing_or_failing_compiler_raises(tmp_path, monkeypatch):
    """No fallback: with no library built yet, a $CXX that does not exist
    raises, and so does one that fails."""
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        build.build(["host_ops"])
    monkeypatch.setenv("CXX", shutil.which("false") or "/bin/false")
    with pytest.raises(RuntimeError, match="failed to build host_ops.cpp"):
        build.build(["host_ops"])
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".so")]


def test_wrappers_refuse_what_c_would_misread():
    img, lbl, cp_mask, donor_img, donor_lbl = _paste_inputs(6)
    lut = np.ones(256, bool)
    with pytest.raises(ValueError, match="cp_mask is written in place"):
        native_ops.paste_hard_classes_native(img, lbl, np.asfortranarray(cp_mask), donor_img, donor_lbl, lut)
    with pytest.raises(ValueError, match="img is written in place"):
        native_ops.paste_hard_classes_native(img[:, ::-1], lbl, cp_mask, donor_img, donor_lbl, lut)
    with pytest.raises(ValueError, match="lbl is written in place"):
        native_ops.paste_hard_classes_native(img, lbl.astype(np.int32), cp_mask, donor_img, donor_lbl, lut)
    with pytest.raises(ValueError, match="shapes differ"):
        native_ops.paste_hard_classes_native(img, lbl, cp_mask, donor_img[:-1], donor_lbl, lut)
    with pytest.raises(ValueError, match="256 entries"):
        native_ops.paste_hard_classes_native(img, lbl, cp_mask, donor_img, donor_lbl, lut[:19])
    assert (cp_mask == 255).all()  # nothing was written by the refused calls
    with pytest.raises(ValueError, match="not inside"):
        native_ops.crop_flip_resize_native(img, lbl, 10, 0, 60, 120, False, 30, 60)
    with pytest.raises(ValueError, match="does not match"):
        native_ops.crop_flip_resize_native(img, lbl[:, :-1], 0, 0, 30, 60, False, 30, 60)
    with pytest.raises(ValueError, match="uint8"):
        native_ops.resize_linear_native(img.astype(np.float32), 30, 60)
    with pytest.raises(ValueError, match="empty"):
        native_ops.resize_nearest_native(lbl, 0, 60)
    # a non-contiguous input is copied, not refused: it is only read
    np.testing.assert_array_equal(native_ops.resize_linear_native(img[:, ::-1], 37, 61),
                                  A.resize_linear(img[:, ::-1], 37, 61))


# -- whole-path parity: get_item with NATIVE against PLAIN ---------------------------------
TARGET_SIZES = [(96, 192), (96, 192), (80, 160), (96, 192)]  # one donor size differs: it is resized
C = 19


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    """A Cityscapes target set with half-size pseudo-labels holding every
    class and its samples_with_class.json, and a GTA5 source set."""
    root = tmp_path_factory.mktemp("host_ops_sets")
    rng = np.random.default_rng(31)
    pseudo = root / "pseudo_label" / "gray_label"
    os.makedirs(pseudo)
    os.makedirs(root / "city")
    os.makedirs(root / "gta")
    target, swc = [], {}
    for i, (h, w) in enumerate(TARGET_SIZES):
        write_png(str(root / "city" / f"t_{i}.png"), _image(50 + i, h, w))
        plbl = rng.integers(0, C, size=(h // 16, w // 16)).repeat(8, 0).repeat(8, 1).astype(np.uint8)
        plbl[rng.random(plbl.shape) < 0.2] = 255
        write_png(str(pseudo / f"t_{i}_pseudo_label.png"), plbl)
        target.append({"image_name": f"t_{i}.png", "mask_name": f"t_{i}.png"})
        for c in np.unique(plbl[plbl < C]):
            swc.setdefault(str(int(c)), []).append([f"t_{i}.png", int((plbl == c).sum())])
    source = []
    for i in range(3):
        write_png(str(root / "gta" / f"g_{i}.png"), _image(60 + i, 65, 120))
        write_png(str(root / "gta" / f"g_{i}_lbl.png"), rng.integers(0, 34, size=(65, 120)).astype(np.uint8))
        source.append({"image_name": f"g_{i}.png", "mask_name": f"g_{i}_lbl.png"})
    (root / "target.json").write_text(json.dumps(target))
    (root / "source.json").write_text(json.dumps(source))
    (root / "pseudo_label" / "samples_with_class.json").write_text(json.dumps(swc))
    return root


def _cfg(root):
    populate()
    cfg = default_config()
    cfg.dataset.source.type = "GTAV"
    cfg.dataset.source.json_path = str(root / "source.json")
    cfg.dataset.source.image_dir = str(root / "gta")
    cfg.dataset.target.type = "Cityscapes"
    cfg.dataset.target.json_path = str(root / "target.json")
    cfg.dataset.target.image_dir = str(root / "city")
    cfg.dataset.crop_size = [48, 96]
    cfg.preprocessor.copy_paste.selected_num_classes = 14
    cfg.cst_training.dcst_loss.weight = 0.5
    return cfg


def _assert_same_samples(datasets, n):
    for i in range(n):
        rngs = [np.random.default_rng((7, 0, i)) for _ in datasets]
        got, want = (ds.get_item(i, rng) for ds, rng in zip(datasets, rngs))
        assert sorted(got) == sorted(want)
        for key in ("images", "labels", "copy_paste_mask"):
            if key in want:
                assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape, key
                np.testing.assert_array_equal(got[key], want[key], err_msg=f"sample {i}: {key}")
        assert rngs[0].bit_generator.state == rngs[1].bit_generator.state


@pytest.mark.parametrize("kind", ["CopyPaste", "ClassMix"])
def test_target_sample_with_replay_native_equals_plain(sets, kind):
    cfg = _cfg(sets)
    cfg.preprocessor.type = kind
    class_value = np.random.default_rng(4).uniform(0.4, 0.99, C).astype(np.float32)
    datasets = []
    for host in (NATIVE, PLAIN):
        ds = build_dataset(cfg, "target", pseudo_dir=str(sets / "pseudo_label" / "gray_label"), aug_type=["MS"],
                           host=host)
        ds.set_preprocessor(PREPROCESSOR[kind](cfg, ds, class_value))
        assert ds.host is host and all(fn.host is host for fn in ds.aug_fns)
        datasets.append(ds)
    _assert_same_samples(datasets, len(TARGET_SIZES))
    pasted = datasets[0].get_item(0, np.random.default_rng(3))["copy_paste_mask"]
    assert pasted.shape == (48, 96) and (pasted != 255).any()


@pytest.mark.parametrize("aug_type", [["DACS"], ["FDA-Target", "DACS"]])
def test_gta5_sample_native_equals_plain(sets, aug_type):
    cfg = _cfg(sets)
    datasets = [build_dataset(cfg, "source", aug_type=aug_type, host=host) for host in (NATIVE, PLAIN)]
    for ds, host in zip(datasets, (NATIVE, PLAIN)):
        assert all(fn.host is host for fn in ds.aug_fns)
    _assert_same_samples(datasets, 3)
