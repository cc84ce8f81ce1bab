"""The port's SegFormer (hiast_tpu_torch/models/segformer.py) and its weight
conversions against the JAX package's, on the CPU.

- JAX ``SegFormer_B0`` variables (random init, randomised BatchNorm
  statistics) go through ``flax_to_port_state_dict`` into the port with
  ``strict=True``; both run the same seeded 64x128 input in float32 and the
  logits agree to atol 1e-4 (measured: 4e-6; the two sum in other orders).
- The JAX package's mmseg reader (``mit_state_dict_to_flax``) maps the
  port's own state_dict back onto the JAX variables exactly, so the port's
  names are the mmseg ``.pth`` layout.
- An HF-named state_dict goes through the port's ``hf_to_port_state_dict``
  and the JAX ``hf_segformer_state_dict_to_flax`` to the same weights, and
  ``load_weights`` reads it, and an mmseg ``.pth``, into the port.
- B5 built on the meta device has the JAX B5's parameter count.
- ``bilinear_resize(align_corners=False)`` matches the JAX function to 1e-5
  at the head's power-of-two scales and to 1e-4 at others (float32 against
  float64 source coordinates).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hiast_tpu.models.convert_segformer import hf_segformer_state_dict_to_flax, mit_state_dict_to_flax
from hiast_tpu.models.segformer import SegFormer as JaxSegFormer
from hiast_tpu.ops.resize import bilinear_resize as jax_resize
from hiast_tpu_torch.models.convert import flax_to_port_state_dict, hf_to_port_state_dict
from hiast_tpu_torch.models.segformer import SegFormer
from hiast_tpu_torch.ops.resize import bilinear_resize
from hiast_tpu_torch.utils.checkpoint import load_weights

H, W = 64, 128


@pytest.fixture(scope="module")
def jax_b0():
    """(module, numpy variables, NHWC input) of a JAX B0 with non-trivial
    BatchNorm statistics."""
    model = JaxSegFormer(num_classes=19, variant="B0")
    x = np.random.default_rng(0).normal(size=(2, H, W, 3)).astype(np.float32)
    v = jax.jit(lambda key: model.init(key, jnp.zeros((1, H, W, 3)), train=False))(jax.random.PRNGKey(0))
    v = jax.tree.map(np.asarray, {"params": v["params"], "batch_stats": v["batch_stats"]})
    rng = np.random.default_rng(1)
    bn = v["batch_stats"]["decode_head"]["fuse_bn"]
    bn["mean"] = rng.normal(0, 0.2, bn["mean"].shape).astype(np.float32)
    bn["var"] = rng.uniform(0.5, 1.5, bn["var"].shape).astype(np.float32)
    return model, v, x


def _leaves(tree, prefix=()):
    for k, val in tree.items():
        if isinstance(val, dict):
            yield from _leaves(val, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(val)


def _assert_same_tree(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(got) == sorted(want)
    for key, val in want.items():
        np.testing.assert_array_equal(got[key], val, err_msg="/".join(key))


def test_b0_logits_match_jax(jax_b0):
    model, v, x = jax_b0
    want = np.asarray(jax.jit(lambda v, x: model.apply(v, x, train=False)["logits"])(v, x))
    port = SegFormer(19, "B0").eval()
    port.load_state_dict(flax_to_port_state_dict(v), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))))["logits"]
    assert tuple(got.shape) == (2, 19, H // 4, W // 4)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want, atol=1e-4, rtol=0)


def test_port_state_dict_is_the_mmseg_layout(jax_b0):
    _, v, _ = jax_b0
    port = SegFormer(19, "B0")
    port.load_state_dict(flax_to_port_state_dict(v), strict=True)
    _assert_same_tree(mit_state_dict_to_flax(port.state_dict()), v)


def _port_to_hf(state):
    """Test-only inverse of the HF renames: the port's names -> HF's."""
    renames = {
        "norm1": "layer_norm_1", "norm2": "layer_norm_2", "attn.q": "attention.self.query",
        "attn.sr": "attention.self.sr", "attn.norm": "attention.self.layer_norm",
        "attn.proj": "attention.output.dense", "mlp.fc1": "mlp.dense1", "mlp.fc2": "mlp.dense2",
        "mlp.dwconv.dwconv": "mlp.dwconv.dwconv",
    }
    out = {}
    for key, val in state.items():
        parts = key.split(".")
        if key.endswith("num_batches_tracked"):
            out["decode_head.batch_norm.num_batches_tracked"] = val
        elif parts[1].startswith("patch_embed"):
            sub = "proj" if parts[2] == "proj" else "layer_norm"
            out[f"segformer.encoder.patch_embeddings.{int(parts[1][-1]) - 1}.{sub}.{parts[3]}"] = val
        elif parts[1].startswith("block"):
            base = f"segformer.encoder.block.{int(parts[1][-1]) - 1}.{parts[2]}"
            sub, leaf = ".".join(parts[3:-1]), parts[-1]
            if sub == "attn.kv":
                half = val.shape[0] // 2
                out[f"{base}.attention.self.key.{leaf}"] = val[:half].clone()
                out[f"{base}.attention.self.value.{leaf}"] = val[half:].clone()
            else:
                out[f"{base}.{renames[sub]}.{leaf}"] = val
        elif parts[1].startswith("norm"):
            out[f"segformer.encoder.layer_norm.{int(parts[1][-1]) - 1}.{parts[2]}"] = val
        elif parts[1].startswith("linear_c"):
            out[f"decode_head.linear_c.{int(parts[1][-1]) - 1}.proj.{parts[3]}"] = val
        elif parts[1] == "linear_fuse":
            out["decode_head.linear_fuse.weight" if parts[2] == "conv" else f"decode_head.batch_norm.{parts[3]}"] = val
        elif parts[1] == "linear_pred":
            out[f"decode_head.classifier.{parts[2]}"] = val
        else:
            raise KeyError(key)
    return out


def _random_b0():
    port = SegFormer(19, "B0")
    port.init_weights(torch.Generator().manual_seed(2))
    with torch.no_grad():
        port.decode_head.linear_fuse.bn.running_mean.normal_(0, 0.2, generator=torch.Generator().manual_seed(3))
    return port


def test_hf_layout_converts_like_jax():
    port = _random_b0()
    hf = _port_to_hf(port.state_dict())
    assert any(k.startswith("segformer.encoder.block.2.1.attention.self.key") for k in hf)
    got = hf_to_port_state_dict(hf)
    want = {k: v for k, v in port.state_dict().items() if not k.endswith("num_batches_tracked")}
    assert sorted(got) == sorted(want)
    for key, val in want.items():
        torch.testing.assert_close(got[key], val, rtol=0, atol=0, msg=key)
    _assert_same_tree(mit_state_dict_to_flax(got), hf_segformer_state_dict_to_flax(hf))


@pytest.mark.parametrize("layout", ["mmseg", "hf"])
def test_load_weights_reads_segformer_checkpoints(tmp_path, layout):
    port = _random_b0()
    state = port.state_dict() if layout == "mmseg" else _port_to_hf(port.state_dict())
    path = str(tmp_path / "w.pth")
    torch.save({"state_dict": {f"module.{k}": v for k, v in state.items()}}, path)
    fresh = SegFormer(19, "B0")
    load_weights(path, fresh)
    for key, val in port.state_dict().items():
        torch.testing.assert_close(fresh.state_dict()[key], val, rtol=0, atol=0, msg=key)


def test_b5_parameter_count_matches_jax():
    with torch.device("meta"):
        port = SegFormer(19, "B5")
    n_port = sum(p.numel() for p in port.parameters())
    shapes = jax.eval_shape(
        lambda: JaxSegFormer(num_classes=19, variant="B5").init(
            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False
        )["params"]
    )
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert n_port == n_jax == 84_607_955
    assert len(port.backbone.block3) == 40


def test_init_weights_is_seeded_and_confident():
    a, b = _random_b0(), _random_b0()
    for (key, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(va, vb, rtol=0, atol=0, msg=key)
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(1, 3, H, W)).astype(np.float32))
    with torch.no_grad():
        logits = a.eval()(x)["logits"]
    conf = logits.softmax(1).max(1).values.mean()
    assert torch.isfinite(logits).all() and 0.2 < float(conf) < 0.95  # far from uniform (1/19)


@pytest.mark.parametrize("src,dst,atol", [
    ((16, 32), (64, 128), 1e-5),  # the head's upsamplings: scales 1/2, 1/4, 1/8
    ((8, 16), (64, 128), 1e-5),
    # other scales: torch computes source coordinates in float32 and the JAX
    # matrices in float64, so weights differ in the 7th digit (measured 2.5e-5)
    ((48, 96), (20, 40), 1e-4),
    ((1, 5), (4, 9), 1e-4),
])
def test_bilinear_half_pixel_matches_jax(src, dst, atol):
    x = np.random.default_rng(5).normal(size=(2,) + src + (7,)).astype(np.float32)
    want = np.moveaxis(np.asarray(jax_resize(jnp.asarray(x), *dst, align_corners=False)), -1, 1)
    got = bilinear_resize(torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1))), *dst, align_corners=False)
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0)


def test_build_seg_model_checks_fused_attention():
    from hiast_tpu_torch.config import default_config
    from hiast_tpu_torch.models.deeplab_v2 import build_seg_model
    from hiast_tpu_torch.registry import populate

    populate()
    cfg = default_config()
    cfg.model.seg_model.type = "SegFormer_B0"
    cfg.model.seg_model.backbone_layers = [1, 1, 1, 1]  # accepted and ignored
    cfg.runtime.fused_attention = [True, True, True, False]
    model = build_seg_model(cfg)
    assert isinstance(model, SegFormer) and len(model.backbone.block1) == 2
    cfg.runtime.fused_attention = [True, False]
    with pytest.raises(ValueError, match="4 per-stage flags"):
        build_seg_model(cfg)
