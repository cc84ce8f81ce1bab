"""The port's tool CLIs against the JAX package's.

- ``make_manifests`` writes the same JSON bytes as the JAX CLI for each of
  its four scanners, on a fake tree of empty files.
- ``convert_checkpoint`` turns a train state of the port, a reference
  ``.pth`` (DDP and segmentor prefixes) and a HuggingFace SegFormer-B0
  ``.pth`` into weights that load into the port's model equal to the source,
  and refuses an Orbax directory on either side, naming the JAX CLI.
"""
import os

import pytest
import torch

from hiast_tpu.cli import make_manifests as jax_make_manifests
from hiast_tpu_torch.cli import convert_checkpoint, make_manifests
from hiast_tpu_torch.models.deeplab_v2 import DeepLabV2
from hiast_tpu_torch.models.segformer import SegFormer
from test_torch_segformer import _port_to_hf, _random_b0

TREES = {
    "cityscapes": ("train", ["leftImg8bit/train/aachen/a_000000_000019_leftImg8bit.png",
                             "leftImg8bit/train/aachen/a_000001_000019_leftImg8bit.png",
                             "leftImg8bit/train/bremen/b_000000_000019_leftImg8bit.png",
                             "leftImg8bit/train/bremen/notes.txt"]),
    "gtav": ("train", ["images/00001.png", "images/00002.png", "labels/00001.png"]),
    "synthia": ("train", ["RGB/0000001.png", "RGB/0000002.png", "GT/LABELS/0000001.png"]),
    "oxford": ("val", ["val/x_1.png", "val/x_2.png", "val_anno/x_1.png", "train/y.png"]),
}


@pytest.mark.parametrize("dataset", sorted(TREES))
def test_make_manifests_writes_the_jax_clis_bytes(tmp_path, dataset):
    split, files = TREES[dataset]
    root = tmp_path / "root"
    for rel in files:
        os.makedirs((root / rel).parent, exist_ok=True)
        (root / rel).touch()
    outputs = {}
    for name, cli in (("jax", jax_make_manifests), ("port", make_manifests)):
        out = tmp_path / name / "m.json"
        cli.main(["--dataset", dataset, "--root", str(root), "--split", split, "--output", str(out)])
        outputs[name] = out.read_bytes()
    assert outputs["port"] == outputs["jax"] and len(outputs["port"]) > 2


def test_make_manifests_refuses_an_empty_tree(tmp_path):
    with pytest.raises(SystemExit, match="no images found"):
        make_manifests.main(["--dataset", "gtav", "--root", str(tmp_path), "--output", str(tmp_path / "m.json")])


def _deeplab():
    model = DeepLabV2(num_classes=19, backbone_layers=(1, 1, 1, 1))
    model.init_weights(torch.Generator().manual_seed(4))
    return model


def _converted_into(model, tmp_path, source) -> dict:
    src, out = str(tmp_path / "in.pth"), str(tmp_path / "out.pth")
    torch.save(source, src)
    convert_checkpoint.main(["--input", src, "--output", out])
    weights = torch.load(out, map_location="cpu", weights_only=True)
    model.load_state_dict(weights, strict=False)
    return weights


@pytest.mark.parametrize("kind", ["train_state", "reference", "hf_segformer_b0"])
def test_convert_checkpoint_loads_equal_to_the_source(tmp_path, kind):
    if kind == "hf_segformer_b0":
        source_model = _random_b0()
        source = _port_to_hf(source_model.state_dict())
        target = SegFormer(19, "B0")
    else:
        source_model = _deeplab()
        state = source_model.state_dict()
        if kind == "train_state":
            source = {"state_dict": state, "optimizer": {"state": {}, "param_groups": []}, "step": 3,
                      "lr_schedule_step": 3}
        else:  # the reference's DDP-wrapped segmentor
            source = {f"module.seg_model.{k}": v for k, v in state.items()}
        target = DeepLabV2(num_classes=19, backbone_layers=(1, 1, 1, 1))
    weights = _converted_into(target, tmp_path, source)
    assert "step" not in weights and "state_dict" not in weights
    want = source_model.state_dict()
    got = target.state_dict()
    for key, value in want.items():
        if key.endswith("num_batches_tracked"):
            continue  # HF's layout keeps the head's counter only
        assert key in weights, key
        torch.testing.assert_close(got[key], value, rtol=0, atol=0, msg=key)


@pytest.mark.parametrize("side", ["input", "output"])
def test_convert_checkpoint_refuses_an_orbax_dir(tmp_path, side):
    pth = str(tmp_path / "w.pth")
    torch.save(_deeplab().state_dict(), pth)
    orbax = tmp_path / "model_last"
    os.makedirs(orbax)
    argv = {"input": ["--input", str(orbax), "--output", str(tmp_path / "x.pth")],
            "output": ["--input", pth, "--output", str(orbax)]}[side]
    with pytest.raises(ValueError, match="python -m hiast_tpu.cli.convert_checkpoint"):
        convert_checkpoint.main(argv)
