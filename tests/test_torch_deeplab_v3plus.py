"""The port's DeepLab-v3+ (hiast_tpu_torch/models/deeplab_v3plus.py) against
the JAX package's, on the CPU: layers (1, 1, 1, 1), float32, JAX variables
(BatchNorm statistics and affines randomised) carried into the port through
``flax_to_port_state_dict``.

- Eval forward on an odd 65x97 input: logits within 1e-4 of JAX's
  (measured 7e-8; logits up to 0.13), the OS8 feature within 1e-4.
- Train-mode forward at batch 1 and 2 (64x128): logits and every running
  statistic within 1e-3 of the tensor's largest magnitude (measured 2e-5 and
  9e-5).  At batch 1 the image-pooled branch's BatchNorm sees one value a
  channel, where torch's ``batch_norm`` raises and JAX gives the bias.
- ``param_labels`` equal to JAX's ``_param_labels`` on every leaf, with and
  without ``is_freeze_bn``.
- A DeepLab-v2 ``.pth`` (the port's, a train state, the reference's
  ``module.seg_model.`` layout, a bare torchvision ResNet) loads the trunk
  and leaves the head as it was, exactly as JAX's ``load_weights`` does.
- One HIAST consistency step against JAX's ``make_consistency_step``
  (tests/test_torch_consistency_step.py's ``check_one_step``): losses rtol
  1e-4, BatchNorm statistics and the classifier's gradients within 1e-3 of
  each tensor's scale, and every other gradient by cosine at least 0.9999.
  Every conv of the v3+ head feeds a train-mode BatchNorm, as the trunk's
  do, so its gradients are as ill-conditioned in float32 as the trunk's
  (ROADMAP C6): at this size the port's own float32 head gradients lie up
  to 2-8% of a tensor's largest entry off float64, and JAX's up to 17%;
  their directions agree.  PRNGKey 6 gives the widest margin of keys 1-7
  (measured: every cosine at least 0.99994; at least 0.99982 for keys 4
  and 5).
- IAS generation from the v3+ logits through both generators at
  ``stats_source`` 'full' and 'low' (the stride-4 grid): thresholds and
  class-mean probabilities within 1e-6, label PNGs and statistics equal.
- ``cli.run_rounds --rounds 1 --device cpu`` with the shipped
  ``deeplab_v3plus_sl_1.yaml`` as the round's config, from a DeepLab-v2
  warmup ``.pth``.
"""
import json
import logging
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hiast_tpu.config import default_config as jax_default_config
from hiast_tpu.models.deeplab_v3plus import DeepLabV3Plus as JaxDeepLabV3Plus
from hiast_tpu.ops.resize import bilinear_resize as jax_bilinear_resize
from hiast_tpu.pseudo.generator import IASGenerator as JaxIASGenerator
from hiast_tpu.selftrain.train_state import _param_labels as jax_param_labels
from hiast_tpu.utils.checkpoint import load_weights as jax_load_weights
from hiast_tpu_torch.config import default_config
from hiast_tpu_torch.models.convert import flax_to_port_state_dict
from hiast_tpu_torch.models.deeplab_v2 import DeepLabV2
from hiast_tpu_torch.models.deeplab_v3plus import DeepLabV3Plus
from hiast_tpu_torch.ops.resize import bilinear_resize
from hiast_tpu_torch.pseudo.generator import IASGenerator
from hiast_tpu_torch.selftrain.train_state import param_labels
from hiast_tpu_torch.utils.checkpoint import load_weights
from test_torch_cli import _shared_pth, fixture_root  # noqa: F401 (a fixture)
from test_torch_consistency_step import _settings, check_one_step
from test_torch_generator import _configure, _read_artifacts
from test_torch_model import _jax_variables

LAYERS = (1, 1, 1, 1)
HEAD = ("aspp.", "low_proj.", "decoder0.", "decoder1.", "classifier.")
STEP_INIT_KEY = 6  # the widest cosine margin of PRNGKeys 1-7 (module docstring)
GEN_IMAGES, GEN_BATCH, GEN_H, GEN_W = 3, 2, 64, 128
SHIPPED = os.path.join(os.path.dirname(__file__), "..", "hiast_tpu_torch", "configs", "deeplab_v3plus_sl_1.yaml")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_v3plus():
    """(flax model, numpy variables with randomised BatchNorm)."""
    return _jax_variables(LAYERS, 3, JaxDeepLabV3Plus)


def _port_model(variables, train=False):
    model = DeepLabV3Plus(num_classes=19, backbone_layers=LAYERS)
    model.load_state_dict(flax_to_port_state_dict(variables), strict=True)
    return model.train(train)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def test_eval_forward_matches_jax(jax_v3plus):
    model, variables = jax_v3plus
    x = np.random.default_rng(4).normal(size=(1, 65, 97, 3)).astype(np.float32)
    want = jax.jit(lambda v, x: model.apply(v, x, train=False))(variables, jnp.asarray(x))
    with torch.no_grad():
        got = _port_model(variables)(_nchw(x))
    assert tuple(got["logits"].shape) == (1, 19, 17, 25)  # stride 4
    np.testing.assert_allclose(_nhwc(got["logits"]), np.asarray(want["logits"]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(_nhwc(got["backbone"]), np.asarray(want["backbone"]), rtol=0, atol=1e-4)


def _within(got: np.ndarray, want: np.ndarray, name: str, rel: float = 1e-3):
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * float(np.abs(want).max()), err_msg=name)


@pytest.mark.parametrize("batch", [1, 2])
def test_train_forward_matches_jax(jax_v3plus, batch):
    model, variables = jax_v3plus
    x = np.random.default_rng(batch).normal(size=(batch, 64, 128, 3)).astype(np.float32)
    want, stats = jax.jit(lambda v, x: model.apply(v, x, train=True, mutable=["batch_stats"]))(variables,
                                                                                                jnp.asarray(x))
    port = _port_model(variables, train=True)
    got = port(_nchw(x))
    _within(_nhwc(got["logits"]), np.asarray(want["logits"]), "logits")
    want_sd = flax_to_port_state_dict({"params": variables["params"],
                                       "batch_stats": jax.tree.map(np.asarray, stats["batch_stats"])})
    n = 0
    for name, buf in port.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            _within(buf.numpy(), want_sd[name].numpy(), name)
            n += 1
    assert n == len([k for k in want_sd if k.endswith("running_var")]) * 2
    if batch == 1:  # one value a channel: the pooled branch gives its BatchNorm bias
        bn = port.aspp.pool_proj.bn
        torch.testing.assert_close(bn.running_var, 0.9 * flax_to_port_state_dict(variables)[
            "aspp.pool_proj.bn.running_var"])


@pytest.mark.parametrize("freeze_bn", [True, False])
def test_param_labels_match_jax(jax_v3plus, freeze_bn):
    _, variables = jax_v3plus
    codes = {"backbone": 1.0, "head": 2.0, "frozen": 3.0}
    labels = jax_param_labels(variables["params"], freeze_bn)
    coded = jax.tree.map(lambda label, p: np.full(p.shape, codes[label], np.float32), labels, variables["params"])
    want = {name: float(t.flatten()[0]) for name, t in flax_to_port_state_dict({"params": coded}).items()}
    got = param_labels(_port_model(variables), freeze_bn)
    assert sorted(got) == sorted(want)
    assert {name: codes[label] for name, label in got.items()} == want
    head = [name for name in got if name.startswith(HEAD)]
    assert head and all(got[name] in ("head", "frozen") for name in head)
    assert any(got[name] == "frozen" for name in head) == freeze_bn  # the head's BatchNorm affines


def _v2_pth(path, layout: str) -> dict:
    """A seeded DeepLab-v2 (layers 1, 1, 1, 1) saved in ``layout``; returns
    its state_dict."""
    v2 = DeepLabV2(num_classes=19, backbone_layers=LAYERS)
    v2.init_weights(torch.Generator().manual_seed(11))
    sd = v2.state_dict()
    if layout == "train_state":
        saved = {"state_dict": sd, "optimizer": {}, "step": 8}
    elif layout == "reference":
        saved = {f"module.seg_model.{k}": v for k, v in sd.items()}
    elif layout == "torchvision":
        saved = {k[len("backbone."):]: v for k, v in sd.items() if k.startswith("backbone.")}
        saved.update({"fc.weight": torch.zeros(1000, 2048), "fc.bias": torch.zeros(1000)})
    else:
        saved = sd
    torch.save(saved, path)
    return sd


@pytest.mark.parametrize("layout", ["port", "train_state", "reference", "torchvision"])
def test_deeplab_v2_pth_loads_the_trunk_only(jax_v3plus, tmp_path, caplog, layout):
    _, variables = jax_v3plus
    pth = str(tmp_path / "v2.pth")
    v2 = _v2_pth(pth, layout)
    port = _port_model(variables)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    with caplog.at_level(logging.INFO, logger="hiast_tpu_torch"):
        load_weights(pth, port)
    after = port.state_dict()
    trunk = [k for k in after if k.startswith("backbone.")]
    head = [k for k in after if not k.startswith("backbone.")]
    assert trunk and head and all(k.startswith(HEAD) for k in head)
    for k in trunk:
        assert torch.equal(after[k], v2[k]), k
    for k in head:
        assert torch.equal(after[k], before[k]), k
    assert f"matched {len(trunk)} / {len(after)} module entries" in caplog.text
    assert f"{len(head)} left at their initial values" in caplog.text
    # JAX's load_weights fills the same leaves from the same file
    want = flax_to_port_state_dict(jax_load_weights(pth, variables))
    for k, v in after.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, want[k]), k


def test_consistency_step_matches_jax():
    settings = _settings(**{"model.seg_model.type": "DeepLab_V3Plus"})
    check_one_step(settings, STEP_INIT_KEY, by_cosine=("backbone.",) + HEAD[:-1])


@pytest.fixture(scope="module")
def generation_models(jax_v3plus):
    """The JAX and the port forward of one v3+ (classifier scaled by 300, so
    that its confidences spread as a trained model's do): normalised NHWC
    float32 images -> {'full': logits at the input size, 'low': the
    stride-4 grid}, NHWC for JAX and NCHW for the port."""
    model, variables = jax_v3plus
    variables = jax.tree.map(np.copy, variables)
    variables["params"]["classifier"]["kernel"] *= 300.0
    jax_logits = jax.jit(lambda x: model.apply(variables, x, train=False)["logits"])
    port = _port_model(variables)

    def jax_forward(images):
        low = jax_logits(jnp.asarray(images))
        return {"full": jax_bilinear_resize(low, images.shape[1], images.shape[2]), "low": low}

    @torch.no_grad()
    def port_forward(images):
        low = port(_nchw(images))["logits"]
        return {"full": bilinear_resize(low, images.shape[1], images.shape[2]).contiguous(), "low": low}

    return jax_forward, port_forward


@pytest.mark.parametrize("stats_source", ["full", "low"])
def test_generation_matches_jax(generation_models, tmp_path, stats_source):
    jax_forward, port_forward = generation_models
    rng = np.random.default_rng(5)
    images = rng.normal(size=(GEN_IMAGES, GEN_H, GEN_W, 3)).astype(np.float32)
    paths = [f"/data/img_{i}.png" for i in range(GEN_IMAGES)]

    def batches():
        for start in range(0, GEN_IMAGES, GEN_BATCH):
            yield {"images": images[start:start + GEN_BATCH], "image_paths": paths[start:start + GEN_BATCH]}

    dirs = {side: str(tmp_path / side / "pseudo_label" / "gray_label") for side in ("jax", "port")}
    jax_gen = JaxIASGenerator(_configure(jax_default_config(), dirs["jax"], 256, stats_source),
                              jax_forward, batches, expected_count=GEN_IMAGES)
    jax_gen.run()
    port_gen = IASGenerator(_configure(default_config(), dirs["port"], 256, stats_source),
                            port_forward, batches, expected_count=GEN_IMAGES, device="cpu")
    port_gen.run()
    np.testing.assert_allclose(port_gen.class_threshold, jax_gen.class_threshold, rtol=0, atol=1e-6)
    np.testing.assert_allclose(port_gen.class_mean_probs, jax_gen.class_mean_probs, rtol=0, atol=1e-6)
    want_pngs, want_jsons, want_arrays = _read_artifacts(dirs["jax"])
    got_pngs, got_jsons, got_arrays = _read_artifacts(dirs["port"])
    assert list(got_pngs) == list(want_pngs) and len(got_pngs) == GEN_IMAGES
    for name in want_pngs:
        np.testing.assert_array_equal(got_pngs[name], want_pngs[name], err_msg=name)
    assert got_jsons == want_jsons
    np.testing.assert_array_equal(got_arrays["statics_class"], want_arrays["statics_class"])
    selected = np.concatenate([p.ravel() for p in got_pngs.values()])
    assert 0.05 < np.mean(selected != 255) < 0.95 and len(np.unique(selected)) > 2  # two classes and 255


def _shipped_with(changes: dict) -> str:
    """The shipped deeplab_v3plus_sl_1.yaml's text with the dotted keys of
    ``changes`` set: an existing line's value replaced, a missing key
    written under its parent (or, with no parent in the file, at the end)."""
    keyed, path = [], []  # (line, dotted key or None)
    with open(SHIPPED) as f:
        for line in f.read().splitlines():
            key = line.split("#")[0].rstrip()
            if ":" in key:
                path = path[:(len(line) - len(line.lstrip())) // 2] + [key.strip().split(":")[0]]
            keyed.append((line, ".".join(path) if ":" in key else None))
    changes, out = dict(changes), []
    missing = set(changes) - {dotted for _, dotted in keyed}
    for line, dotted in keyed:
        depth = dotted.count(".") if dotted else 0
        out.append(f"{'  ' * depth}{dotted.rsplit('.', 1)[-1]}: {changes.pop(dotted)}" if dotted in changes else line)
        for child in sorted(k for k in missing if dotted and k.rsplit(".", 1)[0] == dotted):
            out.append(f"{'  ' * (depth + 1)}{child.rsplit('.', 1)[1]}: {changes.pop(child)}")
    for dotted, value in changes.items():
        *parents, leaf = dotted.split(".")
        out += [f"{'  ' * i}{p}:" for i, p in enumerate(parents)] + [f"{'  ' * len(parents)}{leaf}: {value}"]
    return "\n".join(out) + "\n"


def test_run_rounds_with_the_shipped_config(fixture_root, tmp_path):  # noqa: F811 (the fixture)
    """One HIAST round through ``cli.run_rounds`` with the shipped
    deeplab_v3plus_sl_1.yaml as sl_1.yaml, only its data paths, sizes and
    schedule changed (and held to read as the shipped file with those keys
    set), and the shipped hiast_setting.yaml, from a DeepLab-v2 warmup .pth."""
    from hiast_tpu_torch.cli import run_rounds
    from hiast_tpu_torch.config import load_config
    from hiast_tpu_torch.utils.checkpoint import load_step

    manifest, images = f"'{fixture_root / 'cityscapes_train.json'}'", f"'{fixture_root / 'city'}'"
    changes = {
        "model.seg_model.backbone_layers": "[1, 1, 1, 1]", "dataset.crop_size": "[32, 64]",
        "dataset.target.json_path": manifest, "dataset.target.image_dir": images,
        "dataset.val.json_path": manifest, "dataset.val.image_dir": images, "dataset.val.resize_size": "[32, 64]",
        "pseudo_policy.resize_size": "[32, 64]", "pseudo_policy.num_hist_bins": "256",
        "train.batch_size": "2", "train.total_iter": "1", "train.iter_val": "1", "train.iter_report": "1",
        "validate.batch_size": "2", "runtime.precision.compute_dtype": "float32",
    }
    configs = tmp_path / "configs"
    os.makedirs(configs)
    (configs / "sl_1.yaml").write_text(_shipped_with(changes))
    shutil.copy(os.path.join(os.path.dirname(SHIPPED), "hiast_setting.yaml"), configs)
    overrides = [item.strip("'") for pair in changes.items() for item in pair]
    assert load_config(str(configs / "sl_1.yaml")).to_dict() == load_config(SHIPPED, overrides=overrides).to_dict()

    warm = str(tmp_path / "warmup.pth")
    _shared_pth(warm)
    try:  # the round's full-state checkpoints take about 1.3 GB: removed after the test
        run_rounds.main(["--work_dir", str(tmp_path / "rounds"), "--warmup_ckpt", warm, "--warmup_pseudo_ckpt",
                         warm, "--configs_dir", str(configs), "--rounds", "1", "--device", "cpu"])
        round_dir = tmp_path / "rounds" / "sl_1"
        assert len(os.listdir(round_dir / "pseudo_label" / "gray_label")) == 4
        assert load_step(str(round_dir / "checkpoints")) == 1
        with open(round_dir / "config.json") as f:
            cfg = json.load(f)
        assert cfg["model"]["seg_model"]["type"] == "DeepLab_V3Plus"
        assert cfg["trainer"] == "ConsistencySelfTrainingTrainer"
        student = torch.load(round_dir / "checkpoints" / "model_last.pth", weights_only=True)["state_dict"]
        ema = torch.load(round_dir / "checkpoints" / "ema_model_last.pth", weights_only=True)
        assert sorted(student) == sorted(ema) == sorted(DeepLabV3Plus(backbone_layers=LAYERS).state_dict())
        assert all(torch.isfinite(v.float()).all() for v in student.values())
    finally:
        shutil.rmtree(tmp_path, ignore_errors=True)
