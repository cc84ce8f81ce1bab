"""The port's CT, NT and CBST generators and its multi-scale/flip generation
against the JAX package's.

- Generators on injected logits (the pattern of tests/test_torch_generator.py:
  5 images at batch 2, so the last batch carries a pad sample; CBST's two
  passes see the same logits): label PNGs, ``statics_class.npy`` and both
  JSON files identical, thresholds and ``class_mean_probabilities`` within
  1e-6, and NT writes no ``class_threshold.npy`` in either package.
- ``cbst_thresholds`` equals JAX's on random float32 histograms with empty
  classes; on the same counts in float64 (the port's generator sums float64)
  within 1e-6.
- The multi-scale/flip forward against JAX's ``make_forward`` on one shared
  ``.pth`` (DeepLab-v2 layers (1, 1, 1, 1), 64x128 images, ms_sizes
  [[32, 64], [48, 96]], with and without flip), both trunks in bf16 as the
  CLIs run them: the fused probabilities (``exp`` of the log-probabilities)
  within 0.02 and the argmax equal on 98% of the pixels, full and low grid
  (measured: 0.0026-0.0052 and 99.36% or more).  The two bf16 trunks round
  at different places, so log-probabilities of near-zero probabilities
  differ by more; they are not compared.
- The generation CLI with ms_sizes and flip meets tests/test_torch_cli.py's
  contract bounds against the JAX CLI: at least 98% of label pixels equal,
  every threshold within 0.01.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hiast_tpu.config import default_config as jax_default_config
from hiast_tpu.pseudo import generator as jax_generator
from hiast_tpu.pseudo import policies as jax_policies
from hiast_tpu_torch.config import default_config
from hiast_tpu_torch.pseudo import generator
from hiast_tpu_torch.pseudo import policies
from test_torch_cli import _artifacts, _assert_same_contract, _overrides, _shared_pth, fixture_root  # noqa: F401
from test_torch_generator import BATCH, C, N_IMAGES, _batches, _data_iter_factory, _read_artifacts

torch.exp(torch.zeros(16))  # see tests/test_torch_generator.py: spend the first exp

POLICIES = {
    "CT": (jax_generator.ConstantThresholdGenerator, generator.ConstantThresholdGenerator),
    "NT": (jax_generator.NoThresholdGenerator, generator.NoThresholdGenerator),
    "CBST": (jax_generator.CBSTGenerator, generator.CBSTGenerator),
}


def _configure(cfg, policy, save_dir, stats_source):
    cfg.pseudo_policy.type = policy
    cfg.pseudo_policy.save_dir = save_dir
    cfg.pseudo_policy.batch_size = BATCH
    cfg.pseudo_policy.num_hist_bins = 256
    cfg.pseudo_policy.stats_source = stats_source
    cfg.pseudo_policy.ct.threshold = 0.5
    cfg.pseudo_policy.cbst.p = 0.3
    return cfg


def _cycling(logits, low):
    """forward(images): the batches' logits in turn, again from the first
    after the last (CBST's second pass)."""
    state = {"i": 0}

    def forward(images):
        x = logits[state["i"] % len(logits)]
        state["i"] += 1
        return {"full": x, "low": low(x)}

    forward.calls = state
    return forward


@pytest.mark.parametrize("policy,stats_source", [("CT", "full"), ("NT", "full"), ("CBST", "full"), ("CBST", "low")])
def test_generator_matches_jax_on_injected_logits(tmp_path, policy, stats_source):
    batches = _batches(seed=7)
    jax_cls, port_cls = POLICIES[policy]
    jax_dir = str(tmp_path / "jax" / "pseudo_label" / "gray_label")
    port_dir = str(tmp_path / "port" / "pseudo_label" / "gray_label")
    jax_forward = _cycling([jnp.asarray(b[1]) for b in batches], lambda x: x[:, ::8, ::8])
    port_forward = _cycling(
        [torch.from_numpy(np.ascontiguousarray(np.moveaxis(b[1], -1, 1))) for b in batches],
        lambda x: x[:, :, ::8, ::8].contiguous(),
    )
    jax_gen = jax_cls(_configure(jax_default_config(), policy, jax_dir, stats_source),
                      jax_forward, _data_iter_factory(batches), expected_count=N_IMAGES)
    jax_gen.run()
    port_gen = port_cls(_configure(default_config(), policy, port_dir, stats_source),
                        port_forward, _data_iter_factory(batches), expected_count=N_IMAGES, device="cpu")
    port_gen.run()

    passes = 2 if policy == "CBST" else 1
    assert jax_forward.calls["i"] == port_forward.calls["i"] == passes * len(batches)
    stats = os.path.dirname(port_dir)
    if policy == "NT":
        assert port_gen.class_threshold is None and jax_gen.class_threshold is None
        assert not os.path.exists(os.path.join(stats, "class_threshold.npy"))
        assert not os.path.exists(os.path.join(os.path.dirname(jax_dir), "class_threshold.npy"))
        np.save(os.path.join(stats, "class_threshold.npy"), np.zeros(C, np.float32))  # for the reader
        np.save(os.path.join(os.path.dirname(jax_dir), "class_threshold.npy"), np.zeros(C, np.float32))
    else:
        np.testing.assert_allclose(port_gen.class_threshold, jax_gen.class_threshold, atol=1e-6)
    np.testing.assert_allclose(port_gen.class_mean_probs, jax_gen.class_mean_probs, atol=1e-6)
    want_pngs, want_jsons, want_arrays = _read_artifacts(jax_dir)
    got_pngs, got_jsons, got_arrays = _read_artifacts(port_dir)
    assert list(got_pngs) == list(want_pngs) and len(got_pngs) == N_IMAGES
    for name in want_pngs:
        np.testing.assert_array_equal(got_pngs[name], want_pngs[name], err_msg=name)
    assert got_jsons == want_jsons
    np.testing.assert_array_equal(got_arrays["statics_class"], want_arrays["statics_class"])
    assert got_arrays["class_mean_probabilities"].dtype == np.float32
    selected = sum(int((p != 255).sum()) for p in got_pngs.values())
    if policy == "NT":
        assert selected == N_IMAGES * got_pngs[next(iter(got_pngs))].size
    else:
        assert 0 < selected
    assert port_gen.run_seconds is not None


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("p", [0.2, 0.5])
def test_cbst_thresholds_match_jax(seed, p):
    rng = np.random.default_rng(seed)
    hist = rng.integers(0, 50, size=(C, 256)).astype(np.float32)
    hist[rng.choice(C, 4, replace=False)] = 0  # classes never predicted
    hist[:, rng.random(256) < 0.5] = 0  # sparse bins
    want = np.asarray(jax_policies.cbst_thresholds(jnp.asarray(hist), p))
    got = policies.cbst_thresholds(torch.from_numpy(hist), p)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    got64 = policies.cbst_thresholds(torch.from_numpy(hist).double(), p)
    assert got64.dtype == torch.float32
    np.testing.assert_allclose(got64.numpy(), want, atol=1e-6)
    assert np.all(want[hist.sum(1) == 0] == 1.0)


def _ms_cfgs(root, ms_sizes, is_flip):
    from hiast_tpu.config import load_config as jax_load_config
    from hiast_tpu_torch.config import load_config

    opts = _overrides(root) + ["pseudo_policy.ms_sizes", repr(ms_sizes), "pseudo_policy.is_flip", str(is_flip)]
    return jax_load_config(overrides=opts), load_config(overrides=opts)


MS_SIZES = [[32, 64], [48, 96]]


@pytest.mark.parametrize("is_flip", [False, True])
def test_ms_flip_forward_matches_jax(fixture_root, tmp_path, is_flip):
    import jax

    from hiast_tpu.cli.generate_pseudo_labels import make_forward as jax_make_forward
    from hiast_tpu.models.segmentors import build_segmentor as jax_build_segmentor
    from hiast_tpu.utils.checkpoint import load_weights as jax_load_weights
    from hiast_tpu_torch.cli.generate_pseudo_labels import make_forward
    from hiast_tpu_torch.models.segmentors import build_segmentor
    from hiast_tpu_torch.registry import populate
    from hiast_tpu_torch.utils.checkpoint import load_weights

    populate()
    pth = str(tmp_path / "weights.pth")
    _shared_pth(pth)
    jax_cfg, cfg = _ms_cfgs(fixture_root, MS_SIZES, is_flip)
    seg = jax_build_segmentor(jax_cfg, dtype=jnp.bfloat16)
    v = seg.init_variables(jax.random.PRNGKey(0))
    v = jax_load_weights(pth, {"params": v["params"], "batch_stats": v["batch_stats"]})
    jax_forward = jax_make_forward(jax_cfg, seg, v)
    port = build_segmentor(cfg)
    load_weights(pth, port.module)
    port.module.eval()
    forward = make_forward(cfg, port, torch.device("cpu"))

    images = np.random.default_rng(3).integers(0, 256, size=(2, 64, 128, 3), dtype=np.uint8)
    want = {k: np.moveaxis(np.asarray(x), -1, 1) for k, x in jax_forward(images).items()}
    got = forward(images)
    for key, shape in (("full", (2, 19, 64, 128)), ("low", (2, 19, 8, 16))):
        assert tuple(got[key].shape) == shape and got[key].is_contiguous() and got[key].dtype == torch.float32
        prob_err = float(np.abs(np.exp(got[key].numpy()) - np.exp(want[key])).max())
        agree = float(np.mean(got[key].numpy().argmax(1) == want[key].argmax(1)))
        sums = np.exp(got[key].numpy()).sum(1)
        print(f"{key}: max |prob diff| {prob_err:.5f}, argmax agreement {agree:.5f}")
        assert prob_err <= 0.02 and agree >= 0.98
        np.testing.assert_allclose(sums, 1.0, atol=1e-5)


def test_ms_flip_generation_cli_matches_jax_contract(fixture_root, tmp_path):
    from hiast_tpu.cli import generate_pseudo_labels as jax_cli
    from hiast_tpu_torch.cli import generate_pseudo_labels as port_cli
    from hiast_tpu_torch.ops.cuda.select_kernel import launch_counts, reset_launch_counts

    pth = str(tmp_path / "weights.pth")
    _shared_pth(pth)
    jax_dir = str(tmp_path / "jax" / "pseudo_label" / "gray_label")
    port_dir = str(tmp_path / "port" / "pseudo_label" / "gray_label")
    opts = _overrides(fixture_root) + ["pseudo_policy.ms_sizes", repr(MS_SIZES), "pseudo_policy.is_flip", "True"]
    jax_cli.main(["--pseudo_resume_from", pth, "--pseudo_save_dir", jax_dir, *opts])
    reset_launch_counts()
    port_cli.main(["--device", "cpu", "--pseudo_resume_from", pth, "--pseudo_save_dir", port_dir, *opts])
    assert launch_counts == {"ias_hist": 0, "ias_select": 0}  # CPU: the plain versions
    _assert_same_contract(_artifacts(port_dir), _artifacts(jax_dir), min_agree=0.98, max_thr_err=0.01)
