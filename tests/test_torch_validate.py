"""The port's validation path (ops/metrics.py, evaluation.py,
cli/validate.py) against the JAX package's, on the CPU.

- The metrics are integer counts and the same float formulas: intersection
  and union equal exactly, and ``iou_from_areas`` / ``synthia_mious`` to
  float64 rounding.
- ``make_ms_flip_step`` with two scales and flip on a tiny DeepLab
  (``backbone_layers [1, 1, 1, 1]``) in float32, with the JAX variables
  carried across: the fused probabilities agree to float32 rounding, so at
  most 2 of the 4096 predicted pixels may differ (an argmax near a tie).
- ``make_eval_forward`` and the single-scale ``make_val_step`` likewise:
  logits to 1e-4, areas within the pixels whose argmax may move.
- ``cli.validate.main --device cpu`` against the JAX ``cli.validate.main`` on
  a 3-image manifest (a padded tail batch) with one shared ``.pth``: both run
  their trunk in bf16, rounding at other places, so the IoUs are held to a
  bound measured on this fixture with a margin: per-class IoU within 0.02
  and mIoU within 0.005 (measured: 2e-5 and below 1e-5).
- The colour masks: the port's ``colorize_mask`` (no PIL) against the JAX
  package's, which PIL writes, for 19 and 9 classes with pixel 255 present,
  both files read back by PIL: the same mode, indices, palette and RGB
  (exact).  ``cli.validate --device cpu`` with ``validate.color_mask_dir_path``
  in a process where ``import PIL`` fails writes one mask per val image
  under its basename, holding that image's prediction.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hiast_tpu.config import default_config as jax_default_config
from hiast_tpu.evaluation import make_ms_flip_step as jax_make_ms_flip_step
from hiast_tpu.models.segmentors import build_segmentor as jax_build_segmentor
from hiast_tpu.ops import metrics as jax_metrics
from hiast_tpu.registry import populate as jax_populate
from hiast_tpu_torch.data.png import write_png
from hiast_tpu_torch.ops import metrics

RNG = np.random.default_rng(41)


def test_metrics_match_jax():
    pred = RNG.integers(0, 19, size=(2, 40, 60)).astype(np.int32)
    target = RNG.integers(0, 19, size=(2, 40, 60)).astype(np.int32)
    target[:, :5] = 255  # ignored rows
    target[0, 10, :7] = 25  # outside [0, C): counts for no class
    pred[1, 20] = target[1, 20]  # some agreement in every class
    inter, union = metrics.intersection_and_union(torch.from_numpy(pred), torch.from_numpy(target), 19)
    want_i, want_u = jax_metrics.intersection_and_union(jnp.asarray(pred), jnp.asarray(target), 19)
    assert inter.dtype == union.dtype == torch.float32
    np.testing.assert_array_equal(inter.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(union.numpy(), np.asarray(want_u))
    iou = metrics.iou_from_areas(inter.numpy(), union.numpy())
    np.testing.assert_allclose(iou, jax_metrics.iou_from_areas(np.asarray(want_i), np.asarray(want_u)), rtol=1e-12)
    assert metrics.synthia_mious(iou) == pytest.approx(jax_metrics.synthia_mious(iou), rel=1e-12)


@pytest.fixture(scope="module")
def tiny_deeplab():
    """(JAX segmentor, numpy variables, port segmentor with those weights):
    DeepLab-v2 with backbone_layers [1, 1, 1, 1] in float32."""
    from hiast_tpu_torch.config import default_config
    from hiast_tpu_torch.models.convert import flax_to_port_state_dict
    from hiast_tpu_torch.models.segmentors import build_segmentor
    from hiast_tpu_torch.registry import populate

    jax_populate()
    cfg = jax_default_config()
    cfg.model.type = "SourceOnlySegmentor"
    seg = jax_build_segmentor(cfg, dtype=jnp.float32, backbone_layers=(1, 1, 1, 1))
    v = seg.init_variables(jax.random.PRNGKey(0), (1, 32, 64, 3))
    v = jax.tree.map(np.asarray, {"params": v["params"], "batch_stats": v["batch_stats"]})
    populate()
    cfg = default_config()
    cfg.model.type = "SourceOnlySegmentor"
    cfg.model.seg_model.backbone_layers = [1, 1, 1, 1]
    port = build_segmentor(cfg)
    port.module.load_state_dict(flax_to_port_state_dict(v), strict=True)
    port.module.eval()
    return seg, v, port


def test_ms_flip_step_matches_jax(tiny_deeplab):
    from hiast_tpu_torch.evaluation import make_ms_flip_step

    seg, v, port = tiny_deeplab
    sizes = [(16, 32), (32, 64)]
    img = RNG.integers(0, 255, size=(2, 32, 64, 3)).astype(np.uint8)
    lbl = RNG.integers(0, 19, size=(2, 32, 64)).astype(np.int32)
    lbl[:, :4] = 255
    jstep = jax_make_ms_flip_step(seg, sizes, is_flip=True, num_classes=19)
    want_pred, want_i, want_u = (np.asarray(x) for x in jstep(v["params"], v["batch_stats"], img, lbl))
    step = make_ms_flip_step(port, sizes, is_flip=True, num_classes=19, dtype=torch.float32)
    pred, inter, union = step(torch.from_numpy(img), torch.from_numpy(lbl.astype(np.int64)))
    assert tuple(pred.shape) == (2, 32, 64)
    differ = int((pred.numpy() != want_pred).sum())
    assert differ <= 2
    np.testing.assert_allclose(inter.numpy(), want_i, atol=differ)
    np.testing.assert_allclose(union.numpy(), want_u, atol=2 * differ)
    with pytest.raises(ValueError, match="at least one eval size"):
        make_ms_flip_step(port, [], False, 19)


def test_eval_forward_and_val_step_match_jax(tiny_deeplab):
    """``make_eval_forward`` (full-res logits) and the single-scale
    ``make_val_step`` in float32: logits to 1e-4, areas to the pixels whose
    argmax moves (at most 2)."""
    from hiast_tpu.evaluation import make_val_step as jax_make_val_step
    from hiast_tpu.selftrain.steps import make_eval_forward as jax_make_eval_forward
    from hiast_tpu_torch.evaluation import make_val_step
    from hiast_tpu_torch.selftrain.steps import make_eval_forward

    seg, v, port = tiny_deeplab
    img = RNG.integers(0, 255, size=(2, 32, 64, 3)).astype(np.uint8)
    lbl = RNG.integers(0, 19, size=(2, 32, 64)).astype(np.int32)
    want_logits = np.asarray(jax.jit(jax_make_eval_forward(seg))(v["params"], v["batch_stats"], img))
    want_i, want_u = (np.asarray(x) for x in jax_make_val_step(seg, (16, 32), 19)(v["params"], v["batch_stats"], img, lbl))
    logits = make_eval_forward(port, dtype=torch.float32)(torch.from_numpy(img))
    assert logits.dtype == torch.float32 and tuple(logits.shape) == (2, 19, 32, 64)
    np.testing.assert_allclose(logits.numpy().transpose(0, 2, 3, 1), want_logits, atol=1e-4, rtol=0)
    inter, union = make_val_step(port, (16, 32), 19, dtype=torch.float32)(
        torch.from_numpy(img), torch.from_numpy(lbl.astype(np.int64))
    )
    np.testing.assert_allclose(inter.numpy(), want_i, atol=2)
    np.testing.assert_allclose(union.numpy(), want_u, atol=4)


@pytest.fixture
def val_root(tmp_path):
    img_dir = tmp_path / "city" / "images"
    os.makedirs(img_dir)
    manifest = []
    for i in range(3):  # odd: the second batch of 2 is padded
        write_png(str(img_dir / f"v_{i}.png"), RNG.integers(0, 255, size=(64, 128, 3)).astype(np.uint8))
        lbl = RNG.integers(0, 19, size=(64, 128)).astype(np.uint8)
        lbl[:8] = 255
        write_png(str(img_dir / f"v_{i}_lbl.png"), lbl)
        manifest.append({"image_name": f"images/v_{i}.png", "mask_name": f"images/v_{i}_lbl.png"})
    (tmp_path / "cityscapes_val.json").write_text(json.dumps(manifest))
    return tmp_path


def _val_overrides(root, source="GTAV"):
    return [
        "model.type", "SourceOnlySegmentor",
        "model.seg_model.backbone_layers", "[1, 1, 1, 1]",
        "dataset.source.type", source,
        "dataset.val.type", "Cityscapes",
        "dataset.val.json_path", str(root / "cityscapes_val.json"),
        "dataset.val.image_dir", str(root / "city"),
        "validate.resize_sizes", "[[32, 64]]",
        "validate.is_flip", "True",
        "validate.batch_size", "2",
    ]


def _shared_pth(path):
    from hiast_tpu_torch.models.deeplab_v2 import DeepLabV2, init_weights

    model = DeepLabV2(num_classes=19, backbone_layers=(1, 1, 1, 1))
    init_weights(model, torch.Generator().manual_seed(6))
    torch.save(model.state_dict(), path)


def test_validate_cli_matches_jax(val_root, tmp_path, capsys):
    from hiast_tpu.cli import validate as jax_cli
    from hiast_tpu_torch.cli import validate as port_cli

    pth = str(tmp_path / "w.pth")
    _shared_pth(pth)
    want = jax_cli.main(["--validate_resume_from", pth, *_val_overrides(val_root)])
    jax_out = capsys.readouterr().out
    got = port_cli.main(["--device", "cpu", "--validate_resume_from", pth, *_val_overrides(val_root)])
    port_out = capsys.readouterr().out
    assert jax_out.startswith("miou: ") and port_out.startswith("miou: ")
    assert sorted(want) == ["iou", "miou"] and sorted(got) == ["iou", "miou", "seconds"]
    assert got["iou"].shape == (19,)
    iou_err = np.abs(got["iou"] - np.asarray(want["iou"])).max()
    print(f"max per-class IoU difference {iou_err:.5f}, mIoU difference {abs(got['miou'] - want['miou']):.5f}")
    assert iou_err <= 0.02
    assert abs(got["miou"] - want["miou"]) <= 0.005
    assert 0.0 <= got["miou"] <= 1.0


def test_validate_cli_synthia_report_and_errors(val_root, tmp_path, capsys):
    from hiast_tpu_torch.cli import validate as port_cli
    from hiast_tpu_torch.ops.metrics import synthia_mious

    pth = str(tmp_path / "w.pth")
    _shared_pth(pth)
    result = port_cli.main(["--device", "cpu", "--validate_resume_from", pth, *_val_overrides(val_root, "SYNTHIA")])
    out = capsys.readouterr().out
    assert out.startswith(f"miou_16: {result['miou_16']:.4f}, miou_13: {result['miou_13']:.4f}, iou: ")
    assert (result["miou_16"], result["miou_13"]) == synthia_mious(result["iou"])
    with pytest.raises(ValueError, match="--validate_resume_from"):
        port_cli.main(["--device", "cpu", *_val_overrides(val_root)])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):  # the default is the card
            port_cli.main(["--validate_resume_from", pth, *_val_overrides(val_root)])


@pytest.mark.parametrize("num_classes", [19, 9])
def test_color_mask_matches_pil(num_classes, tmp_path):
    from PIL import Image

    from hiast_tpu.evaluation import colorize_mask as jax_colorize_mask
    from hiast_tpu_torch.data.png import decode_png_file
    from hiast_tpu_torch.evaluation import PALETTE_9, PALETTE_19, colorize_mask

    mask = RNG.integers(0, num_classes, size=(37, 51)).astype(np.uint8)  # odd width: 4-bit rows end mid-byte
    mask[0, :num_classes] = np.arange(num_classes)
    mask[5:9, 7:20] = 255  # ignore
    pil_path, port_path = str(tmp_path / "pil.png"), str(tmp_path / "port.png")
    jax_colorize_mask(mask, num_classes).save(pil_path)
    with open(port_path, "wb") as f:
        f.write(colorize_mask(mask, num_classes))
    pil, port = Image.open(pil_path), Image.open(port_path)
    assert port.mode == pil.mode == "P"
    np.testing.assert_array_equal(np.array(port), np.array(pil))
    assert port.getpalette() == pil.getpalette()
    rgb = np.array(pil.convert("RGB"))
    np.testing.assert_array_equal(np.array(port.convert("RGB")), rgb)
    # the port's decoder reads the same indices; a class pixel has its colour
    idx = decode_png_file(port_path, palette=False)
    np.testing.assert_array_equal(idx, np.array(pil))
    palette = np.asarray({19: PALETTE_19, 9: PALETTE_9}[num_classes], np.uint8).reshape(-1, 3)
    cls = mask != 255
    np.testing.assert_array_equal(idx[cls], mask[cls])
    np.testing.assert_array_equal(rgb[cls], palette[mask[cls]])


def test_validate_cli_writes_color_masks_without_pil(val_root, tmp_path):
    pth = str(tmp_path / "w.pth")
    _shared_pth(pth)
    color_dir = tmp_path / "colors"
    argv = ["--device", "cpu", "--validate_resume_from", pth, *_val_overrides(val_root),
            "validate.color_mask_dir_path", str(color_dir)]
    code = (
        "import sys; sys.modules['PIL'] = None\n"
        "import numpy as np, torch\n"
        "torch.set_num_threads(2)\n"
        "from hiast_tpu_torch import evaluation\n"
        "from hiast_tpu_torch.cli import validate\n"
        "colorize, preds = evaluation.colorize_mask, []\n"
        "evaluation.colorize_mask = lambda m, n: preds.append(m) or colorize(m, n)\n"
        f"validate.main({argv!r})\n"
        f"np.save({str(tmp_path / 'preds.npy')!r}, np.stack(preds))\n"
        "assert sys.modules['PIL'] is None\n"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    from hiast_tpu_torch.data.png import decode_png_file
    from hiast_tpu_torch.evaluation import PALETTE_19

    with open(val_root / "cityscapes_val.json") as f:
        names = [os.path.basename(e["image_name"]) for e in json.load(f)]
    preds = np.load(tmp_path / "preds.npy")
    assert sorted(os.listdir(color_dir)) == sorted(names) and preds.shape == (len(names), 64, 128)
    palette = np.asarray(PALETTE_19, np.uint8).reshape(-1, 3)
    for name, pred in zip(names, preds):
        np.testing.assert_array_equal(decode_png_file(str(color_dir / name), palette=False), pred, err_msg=name)
        np.testing.assert_array_equal(decode_png_file(str(color_dir / name)), palette[pred], err_msg=name)
