"""The port's DeepLab-v2/ResNet-101 (hiast_tpu_torch/models) against the JAX
package's, with weights carried across.

JAX variables (random parameters, randomised BatchNorm statistics) go
through ``flax_to_port_state_dict`` into the port with ``strict=True``; both
run in float32 on the CPU and the logits are compared with the tolerances
of tests/test_model.py (atol 2e-3 on the one-block trunk, 2e-3 times the
logit scale at full depth).  A ``.pth`` written by the JAX package's
``export_pth`` loads into the port with ``strict=True`` and gives the same
tensors.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hiast_tpu.models.deeplab_v2 import DeepLabV2 as JaxDeepLabV2
from hiast_tpu.utils.checkpoint import export_pth
from hiast_tpu_torch.models.convert import (
    flax_to_port_state_dict,
    is_torchvision_resnet_layout,
    reference_to_port_state_dict,
)
from hiast_tpu_torch.models.deeplab_v2 import DeepLabV2, init_weights
from hiast_tpu_torch.utils.checkpoint import load_weights


def _jax_variables(layers, seed, model_cls=JaxDeepLabV2):
    """JAX DeepLab variables (v2 unless ``model_cls`` says otherwise) as
    numpy, with non-trivial BatchNorm."""
    model = model_cls(num_classes=19, backbone_layers=layers)
    variables = jax.jit(
        lambda k: model.init(k, jnp.zeros((1, 33, 33, 3)), train=False, return_representation=True)
    )(jax.random.PRNGKey(seed))
    variables = jax.tree.map(np.asarray, {"params": variables["params"], "batch_stats": variables["batch_stats"]})
    rng = np.random.default_rng(seed)

    def randomise(tree, path=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                randomise(v, path + (k,))
            elif k == "mean":
                tree[k] = rng.normal(0, 0.2, v.shape).astype(np.float32)
            elif k == "var":
                tree[k] = rng.uniform(0.8, 1.5, v.shape).astype(np.float32)
            elif k == "scale":
                tree[k] = rng.normal(1.0, 0.1, v.shape).astype(np.float32)
            elif k == "bias" and "bn" in path[-1]:
                tree[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)

    randomise(variables)
    return model, variables


def _port_model(layers, variables):
    model = DeepLabV2(num_classes=19, backbone_layers=layers).eval()
    model.load_state_dict(flax_to_port_state_dict(variables), strict=True)
    return model


@pytest.mark.parametrize(
    "layers,shape,seed",
    [((1, 1, 1, 1), (1, 65, 97, 3), 1), ((3, 4, 23, 3), (1, 33, 49, 3), 3)],
    ids=["one-block", "resnet101"],
)
def test_forward_matches_jax(layers, shape, seed):
    jax_model, variables = _jax_variables(layers, seed)
    port = _port_model(layers, variables)
    x = np.random.default_rng(seed + 1).normal(size=shape).astype(np.float32)
    want = jax_model.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = port(torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1))))
    want_logits = np.moveaxis(np.asarray(want["logits"]), -1, 1)
    assert tuple(got["logits"].shape) == want_logits.shape  # output stride 8
    scale = max(float(np.abs(want_logits).max()), 1.0) if layers != (1, 1, 1, 1) else 1.0
    np.testing.assert_allclose(got["logits"].numpy(), want_logits, atol=2e-3 * scale)
    if layers == (1, 1, 1, 1):
        np.testing.assert_allclose(
            got["backbone"].numpy(), np.moveaxis(np.asarray(want["backbone"]), -1, 1), atol=2e-3
        )


def test_port_state_dict_is_the_reference_layout():
    names = DeepLabV2(num_classes=19).state_dict().keys()
    for key in (
        "backbone.conv1.weight", "backbone.bn1.running_var",
        "backbone.layer3.5.conv2.weight", "backbone.layer1.0.downsample.1.running_mean",
        "aspp.conv2d_list.3.bias", "representation.0.weight",
    ):
        assert key in names
    assert sum(v.numel() for k, v in DeepLabV2(num_classes=19).state_dict().items()
               if not k.endswith("num_batches_tracked")) > 40_000_000


def test_export_pth_loads_strict_with_the_same_tensors(tmp_path):
    _, variables = _jax_variables((1, 1, 1, 1), 5)
    path = str(tmp_path / "jax_export.pth")
    export_pth(path, variables)
    state = torch.load(path, weights_only=True)
    port = DeepLabV2(num_classes=19, backbone_layers=(1, 1, 1, 1))
    port.load_state_dict(reference_to_port_state_dict(state), strict=True)
    want = flax_to_port_state_dict(variables)
    got = port.state_dict()
    assert set(got) == set(want)
    for key, value in want.items():
        torch.testing.assert_close(got[key], value, rtol=0, atol=0, msg=key)
    # and through the loader the CLI uses
    fresh = DeepLabV2(num_classes=19, backbone_layers=(1, 1, 1, 1))
    load_weights(path, fresh)
    for key, value in want.items():
        torch.testing.assert_close(fresh.state_dict()[key], value, rtol=0, atol=0, msg=key)


def test_reference_key_rewrites():
    tv = {"conv1.weight": 1, "layer1.0.conv1.weight": 2, "fc.weight": 3, "fc.bias": 4}
    assert is_torchvision_resnet_layout(tv)
    assert reference_to_port_state_dict(tv) == {
        "backbone.conv1.weight": 1, "backbone.layer1.0.conv1.weight": 2,
    }
    ddp = {"module.seg_model.backbone.conv1.weight": 1, "module.aspp.conv2d_list.0.bias": 2}
    assert not is_torchvision_resnet_layout(ddp)
    assert reference_to_port_state_dict(ddp) == {
        "backbone.conv1.weight": 1, "aspp.conv2d_list.0.bias": 2,
    }


def test_load_weights_refuses_foreign_files(tmp_path):
    model = DeepLabV2(num_classes=19, backbone_layers=(1, 1, 1, 1))
    with pytest.raises(ValueError, match="export_pth"):
        load_weights(str(tmp_path), model)  # an Orbax checkpoint is a directory
    torch.save({"D.conv1.weight": torch.zeros(3)}, tmp_path / "d.pth")
    with pytest.raises(ValueError, match="shares no parameter"):
        load_weights(str(tmp_path / "d.pth"), model)


@pytest.mark.parametrize("src,dst", [((9, 13), (65, 97)), ((12, 16), (12, 16)), ((40, 30), (17, 23))])
def test_bilinear_resize_matches_jax(src, dst):
    from hiast_tpu.ops.resize import bilinear_resize as jax_resize
    from hiast_tpu_torch.ops.resize import bilinear_resize

    x = np.random.default_rng(7).normal(size=(2,) + src + (19,)).astype(np.float32)
    want = np.moveaxis(np.asarray(jax_resize(jnp.asarray(x), *dst)), -1, 1)
    got = bilinear_resize(torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1))), *dst)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_segmentor_forward_upsamples_fp32_logits():
    from hiast_tpu_torch.config import default_config
    from hiast_tpu_torch.models.segmentors import build_segmentor
    from hiast_tpu_torch.ops.resize import bilinear_resize
    from hiast_tpu_torch.registry import populate

    populate()
    cfg = default_config()
    cfg.model.type = "SelfTrainingSegmentor"
    cfg.model.seg_model.backbone_layers = [1, 1, 1, 1]
    segmentor = build_segmentor(cfg)
    segmentor.module.eval()
    x = torch.from_numpy(np.random.default_rng(8).normal(size=(1, 3, 41, 57)).astype(np.float32))
    with torch.no_grad():
        out = segmentor.forward(x)
        low = segmentor.module(x)["logits"]
    assert out["logits"].dtype == torch.float32 and tuple(out["logits"].shape) == (1, 19, 41, 57)
    torch.testing.assert_close(out["logits"], bilinear_resize(low, 41, 57), rtol=0, atol=0)


def test_init_weights_is_seeded():
    a = DeepLabV2(num_classes=19, backbone_layers=(1, 1, 1, 1))
    b = DeepLabV2(num_classes=19, backbone_layers=(1, 1, 1, 1))
    init_weights(a, torch.Generator().manual_seed(3))
    init_weights(b, torch.Generator().manual_seed(3))
    for (key, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(va, vb, rtol=0, atol=0, msg=key)
