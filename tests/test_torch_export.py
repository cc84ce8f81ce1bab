"""The port's serving export (hiast_tpu_torch/cli/export_model.py) on the
CPU, against the JAX package's StableHLO export.

- A tiny DeepLab-v2 (layers (1, 1, 1, 1), 32x64) exported through the
  port's ``main``, on the weights of JAX's ``build_exported`` (its
  ``PRNGKey(0)`` initialisation, carried across by
  ``flax_to_port_state_dict`` into a ``.pth``), loaded back with
  ``load_exported`` and called at batch 1 and 3 from the one export: held
  against JAX's deserialised artifact within JAX's own tolerance
  (tests/test_export.py: atol 2e-2 of the logits' scale; the two bf16
  trunks round in other places), against the port's live eval forward
  within 1e-5 of the scale (the same operations on the same device), and
  unlike the un-normalised forward (more than 2e-2 of the scale apart, as
  tests/test_export.py checks).
- A SegFormer-B0 artifact keeps the registered SRA op through ``save`` and
  ``load_exported``: the loaded program names it, runs it once per block
  (its CPU body, ``sra_attention_plain``, counted) and equals the live
  eval forward within 1e-5 of the scale.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hiast_tpu.cli.export_model import build_exported as jax_build_exported
from hiast_tpu.config import default_config as jax_default_config
from hiast_tpu.models.segmentors import build_segmentor as jax_build_segmentor
from hiast_tpu.registry import populate as jax_populate
from hiast_tpu_torch.cli import export_model
from hiast_tpu_torch.config import default_config
from hiast_tpu_torch.models.convert import flax_to_port_state_dict
from hiast_tpu_torch.models.segmentors import build_segmentor
from hiast_tpu_torch.ops.cuda import attention as A
from hiast_tpu_torch.registry import populate
from hiast_tpu_torch.selftrain.steps import make_eval_forward
from hiast_tpu_torch.utils.checkpoint import load_weights

H, W = 32, 64
TINY = ["model.type", "SourceOnlySegmentor", "model.seg_model.backbone_layers", "[1, 1, 1, 1]"]


@pytest.fixture(scope="module", autouse=True)
def _threads():
    """Two threads: the suite runs several pytest-xdist workers on one host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _images(batch: int, h: int = H, w: int = W) -> np.ndarray:
    return np.random.default_rng(batch).integers(0, 255, size=(batch, h, w, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def deeplab(tmp_path_factory):
    """(JAX's deserialised artifact, the port's program written by ``main``
    and loaded back, the .pth of JAX's weights)."""
    from jax import export

    jax_populate()
    cfg = jax_default_config()
    cfg.model.type = "SourceOnlySegmentor"
    cfg.model.seg_model.backbone_layers = [1, 1, 1, 1]
    jax_artifact = export.deserialize(jax_build_exported(cfg, H, W, platforms=("cpu",)).serialize())
    variables = jax_build_segmentor(cfg, dtype=jnp.bfloat16).init_variables(jax.random.PRNGKey(0), (1, H, W, 3))
    root = tmp_path_factory.mktemp("export")
    pth = str(root / "jax_weights.pth")
    torch.save(flax_to_port_state_dict({"params": variables["params"], "batch_stats": variables["batch_stats"]}), pth)
    out = root / "artifacts" / "model.pt2"
    export_model.main(["--device", "cpu", "--validate_resume_from", pth, "--output", str(out),
                       "--height", str(H), "--width", str(W), *TINY])
    return jax_artifact, export_model.load_exported(str(out)), pth


def _live(cfg_argv: list, pth: str | None = None):
    populate()
    cfg = default_config()
    cfg.merge_from_list(cfg_argv)
    segmentor = build_segmentor(cfg)
    segmentor.module.init_weights(torch.Generator().manual_seed(export_model.INIT_SEED))
    if pth:
        load_weights(pth, segmentor.module)
    segmentor.module.eval()
    return segmentor


@pytest.mark.parametrize("batch", [1, 3])
def test_deeplab_artifact_matches_jax(deeplab, batch):
    jax_artifact, program, _ = deeplab
    img = _images(batch)
    got = program.module()(torch.from_numpy(img)).numpy()
    want = np.asarray(jax_artifact.call(jnp.asarray(img)))
    assert got.shape == want.shape == (batch, H, W, 19) and got.dtype == np.float32
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, atol=2e-2)


def test_deeplab_artifact_matches_the_live_eval_forward(deeplab):
    _, program, pth = deeplab
    segmentor = _live(TINY, pth)
    eval_fwd = make_eval_forward(segmentor)
    for batch in (1, 3):  # two batch sizes, one export
        img = torch.from_numpy(_images(batch))
        got = program.module()(img)
        want = eval_fwd(img).permute(0, 2, 3, 1)
        with torch.no_grad():
            raw = segmentor.forward(img.float().permute(0, 3, 1, 2), torch.bfloat16)["logits"].permute(0, 2, 3, 1)
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-5 * scale
        # ... and not the un-normalised forward (a program without normalize_image)
        assert float((got - raw).abs().max()) > 2e-2 * scale


def test_segformer_artifact_runs_the_registered_op(tmp_path, monkeypatch):
    h, w = 64, 128
    argv = ["model.type", "SourceOnlySegmentor", "model.seg_model.type", "SegFormer_B0"]
    path = str(tmp_path / "b0.pt2")
    export_model.main(["--device", "cpu", "--output", path, "--height", str(h), "--width", str(w), *argv])
    program = export_model.load_exported(path)
    op = torch.ops.hiast_tpu_torch.sra_attention_kv.default
    graphs = [m.graph for m in program.graph_module.modules() if isinstance(m, torch.fx.GraphModule)]
    assert sum(n.target is op for g in graphs for n in g.nodes) == 8  # B0: 2 + 2 + 2 + 2 blocks

    calls = []
    plain = A.sra_attention_plain
    monkeypatch.setattr(A, "sra_attention_plain", lambda *a: calls.append(a[0].shape) or plain(*a))
    img = torch.from_numpy(_images(3, h, w))
    got = program.module()(img)
    assert len(calls) == 8 and all(s[0] == 3 for s in calls)
    want = make_eval_forward(_live(argv))(img).permute(0, 2, 3, 1)
    assert got.shape == (3, h, w, 19)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
