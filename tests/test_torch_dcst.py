"""The directional-consistency loss (dcst) and its inputs in the port,
against the JAX package, on the CPU.

- ``SelfTrainingSegmentor.compute_directional_consistency_loss`` on seeded
  random logits and copy-paste masks, one and both directions: the loss
  rtol 1e-5 and the gradients within 1e-5 of each tensor's largest
  magnitude (the same float32 math in another layout); the gradient
  reaches only the less confident side, and an empty mask gives exactly 0.
- The consistency step with ``dcst_loss.weight`` 0.3 and a
  ``copy_paste_mask`` in the batch, on the OS8 loss grid, at
  tests/test_torch_consistency_step.py's set-up and tolerances
  (``check_one_step``).
- ``get_item`` with CopyPaste and the 'MS' crop, dcst off and on, on
  tests/test_torch_copy_paste.py's round: masks and labels equal, images
  within one level (the crop's tolerance), and the stream's ``rng`` at the
  same next draw, so the replay leaves the stream's draws as they were.
- ``ClassMix`` and ``CutMix`` against JAX's on the same ``rng``, with
  donors of the sample's size (equal bit for bit) and of another size
  (labels and masks equal, images within one level: the port's resize
  against cv2's, as in tests/test_torch_copy_paste.py).
- ``fda_device`` against JAX's at beta 0.05: within 1e-3 on values of
  0..255 (two float32 FFT libraries; measured 6.1e-5).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hiast_tpu.config import default_config as jax_default_config
from hiast_tpu.data import copy_paste as jax_copy_paste
from hiast_tpu.data.datasets import build_dataset as jax_build_dataset
from hiast_tpu.models.segmentors import build_segmentor as jax_build_segmentor
from hiast_tpu.ops.fda import fda_device as jax_fda_device
from hiast_tpu.registry import populate as jax_populate
from hiast_tpu_torch.config import default_config
from hiast_tpu_torch.data import copy_paste
from hiast_tpu_torch.data.datasets import build_dataset
from hiast_tpu_torch.data.native_ops import PLAIN
from hiast_tpu_torch.data.png import write_png
from hiast_tpu_torch.models.segmentors import build_segmentor
from hiast_tpu_torch.ops.fda import fda_device
from hiast_tpu_torch.registry import populate
from test_torch_consistency_step import B, H, LAYERS, W, _batch, _configure, _settings, check_one_step
from test_torch_copy_paste import _pair, round_root  # noqa: F401 (a fixture)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _segmentors(weight: float):
    """(JAX, port) SelfTrainingSegmentor with ``dcst_loss.weight``."""
    jax_populate()
    populate()
    settings = _settings(**{"cst_training.dcst_loss.weight": weight})
    jseg = jax_build_segmentor(_configure(jax_default_config(), settings), dtype=jnp.float32,
                               backbone_layers=LAYERS)
    return jseg, build_segmentor(_configure(default_config(), settings))


def _logits_and_mask(seed: int, empty: bool = False):
    rng = np.random.default_rng(seed)
    a = rng.normal(0.0, 2.0, (2, 19, 16, 24)).astype(np.float32)
    b = rng.normal(0.0, 2.0, (2, 19, 16, 24)).astype(np.float32)
    mask = np.full((2, 16, 24), 255, np.int32)
    if not empty:
        mask[:, 3:13, 5:19] = rng.integers(0, 19, (2, 10, 14))
    return a, b, mask


def _both(a, b, mask, bidirectional):
    """(JAX loss, JAX grads (NCHW), port loss, port grads)."""
    jseg, seg = _segmentors(0.3)

    def jax_loss(la, lb):
        return jseg.compute_directional_consistency_loss(la, lb, jnp.asarray(mask), bidirectional)["dcst_loss"]

    nhwc = [jnp.asarray(x.transpose(0, 2, 3, 1)) for x in (a, b)]
    want, jgrads = jax.value_and_grad(jax_loss, argnums=(0, 1))(*nhwc)
    ta, tb = (torch.from_numpy(x).requires_grad_() for x in (a, b))
    got = seg.compute_directional_consistency_loss(ta, tb, torch.from_numpy(mask), bidirectional)["dcst_loss"]
    got.backward()
    grads = [torch.zeros_like(t) if t.grad is None else t.grad for t in (ta, tb)]
    return float(want), [np.asarray(g).transpose(0, 3, 1, 2) for g in jgrads], float(got.detach()), grads


@pytest.mark.parametrize("bidirectional", [False, True])
def test_loss_and_gradients_match_jax(bidirectional):
    a, b, mask = _logits_and_mask(0)
    want, jgrads, got, grads = _both(a, b, mask, bidirectional)
    assert want > 0
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for g, jg in zip(grads, jgrads):
        np.testing.assert_allclose(g.numpy(), jg, rtol=0, atol=1e-5 * max(float(np.abs(jg).max()), 1e-12))

    # only the less confident view of a pasted pixel takes a gradient
    conf = [torch.softmax(torch.from_numpy(x), dim=1).amax(1) for x in (a, b)]
    pasted = torch.from_numpy(mask != 255)
    worse = [pasted & (conf[0] < conf[1]), pasted & (conf[1] < conf[0])]
    for k, g in enumerate(grads):
        reached = g.abs().sum(1) > 0  # [B, H, W]
        if k == 0 or bidirectional:
            assert reached.any() and not (reached & ~worse[k]).any(), f"view {k}"
        else:
            assert not reached.any(), "the teacher side takes no gradient"


def test_empty_mask_gives_exactly_zero():
    a, b, mask = _logits_and_mask(1, empty=True)
    want, _, got, grads = _both(a, b, mask, True)
    assert got == 0.0 and want == 0.0
    assert all(float(g.abs().max()) == 0.0 for g in grads)


def test_consistency_step_with_dcst_matches_jax():
    batch = _batch()
    rng = np.random.default_rng(8)
    mask = np.full((B, H, W), 255, np.int32)
    mask[:, 16:48, 24:104] = rng.integers(0, 19, (B, 32, 80))
    batch["copy_paste_mask"] = mask
    check_one_step(_settings(**{"cst_training.dcst_loss.weight": 0.3, "train.loss_resolution": "os8"}), batch=batch)


@pytest.mark.parametrize("dcst", [False, True])
def test_get_item_matches_jax(round_root, dcst):  # noqa: F811
    ds, jds = _pair(round_root, ["MS"])
    for i in range(len(ds)):
        for cfg in (ds.cfg, jds.cfg):
            cfg.cst_training.dcst_loss.weight = 0.5 if dcst else 0.0
        rng, jrng = np.random.default_rng((7, 0, i)), np.random.default_rng((7, 0, i))
        got, want = ds.get_item(i, rng), jds.get_item(i, jrng)
        assert got["copy_paste_mask"].shape == ((30, 60) if dcst else (60, 120))
        np.testing.assert_array_equal(got["copy_paste_mask"], want["copy_paste_mask"])
        np.testing.assert_array_equal(got["labels"], want["labels"])
        assert np.abs(got["images"].astype(int) - want["images"].astype(int)).max() <= 1
        next_draw = rng.random()
        assert next_draw == jrng.random()
        if dcst:
            pasted = got["copy_paste_mask"] != 255
            assert pasted.any()
            np.testing.assert_array_equal(got["labels"][pasted], got["copy_paste_mask"][pasted])
            ds.cfg.cst_training.dcst_loss.weight = 0.0  # the stream's draws as without the replay
            plain = np.random.default_rng((7, 0, i))
            np.testing.assert_array_equal(ds.get_item(i, plain)["labels"], got["labels"])
            assert plain.random() == next_draw


# (height, width) of the mix set's images: two sizes, so some donors are resized
MIX_SIZES = [(40, 80), (40, 80), (30, 64), (40, 80)]


@pytest.fixture(scope="module")
def mix_root(tmp_path_factory):
    """Cityscapes-style images with train-id labels in blocks of 8x8 (a
    quarter 255), in two sizes."""
    root = tmp_path_factory.mktemp("mix")
    rng = np.random.default_rng(31)
    os.makedirs(root / "images")
    manifest = []
    for i, (h, w) in enumerate(MIX_SIZES):
        write_png(str(root / "images" / f"m_{i}.png"), rng.integers(0, 256, (h, w, 3)).astype(np.uint8))
        lbl = rng.integers(0, 19, (h // 8 + 1, w // 8 + 1)).repeat(8, 0).repeat(8, 1)[:h, :w].astype(np.uint8)
        lbl[rng.random((h, w)) < 0.25] = 255
        write_png(str(root / "images" / f"m_{i}_lbl.png"), lbl)
        manifest.append({"image_name": f"images/m_{i}.png", "mask_name": f"images/m_{i}_lbl.png"})
    (root / "mix.json").write_text(json.dumps(manifest))
    return root


@pytest.mark.parametrize("kind", ["ClassMix", "CutMix"])
def test_class_mix_and_cut_mix_match_jax(mix_root, kind):
    populate()
    cfgs = []
    for cfg in (default_config(), jax_default_config()):
        cfg.dataset.target.type = "Cityscapes"
        cfg.dataset.target.json_path = str(mix_root / "mix.json")
        cfg.dataset.target.image_dir = str(mix_root)
        cfgs.append(cfg)
    ds = build_dataset(cfgs[0], "target", aug_type=[], host=PLAIN)
    jds = jax_build_dataset(cfgs[1], "target", aug_type=[])
    mix = getattr(copy_paste, kind)(cfgs[0], ds)
    jmix = getattr(jax_copy_paste, kind)(cfgs[1], jds)
    resized = same = 0
    for seed in range(12):
        i = seed % len(ds)
        img, lbl, _ = ds.load_data(i)
        donor = int(np.random.default_rng(seed).integers(0, len(ds)))  # the first draw of both
        got = mix.run(img, lbl, np.random.default_rng(seed))
        want = jmix.run(img, lbl, np.random.default_rng(seed))
        for g, w, what in zip(got, want, ("image", "label", "copy_paste_mask")):
            assert g.dtype == w.dtype and g.shape == w.shape, what
        np.testing.assert_array_equal(got[1], want[1], err_msg=f"seed {seed}: label")
        np.testing.assert_array_equal(got[2], want[2], err_msg=f"seed {seed}: copy_paste_mask")
        if MIX_SIZES[donor] == MIX_SIZES[i]:
            np.testing.assert_array_equal(got[0], want[0], err_msg=f"seed {seed}: image")
            same += 1
        else:
            assert np.abs(got[0].astype(int) - want[0].astype(int)).max() <= 1, f"seed {seed}: image"
            resized += 1
        pasted = got[2] != 255
        assert pasted.any(), f"seed {seed}: nothing pasted"
        np.testing.assert_array_equal(got[1][pasted], got[2][pasted])
        if kind == "ClassMix":  # CutMix's box also carries the donor's 255 pixels
            np.testing.assert_array_equal(got[0][~pasted], img[~pasted])
    assert same > 0 and resized > 0


def test_fda_device_matches_jax():
    rng = np.random.default_rng(5)
    src = rng.integers(0, 256, (2, 32, 48, 3)).astype(np.uint8)
    tgt = rng.integers(0, 256, (2, 32, 48, 3)).astype(np.uint8)
    want = np.asarray(jax_fda_device(jnp.asarray(src), jnp.asarray(tgt), beta=0.05))
    got = fda_device(torch.from_numpy(src), torch.from_numpy(tgt), beta=0.05)
    assert got.dtype == torch.float32 and got.shape == src.shape
    assert float(np.abs(want - src).max()) > 1.0  # the band moved the image
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)
