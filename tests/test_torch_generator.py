"""The port's IASGenerator against the JAX package's, fed the same logits.

Both generators get the same injected per-batch logits (NHWC to JAX, NCHW
to the port) for 5 images at batch 2, so the last batch carries one pad
sample.  The carried thresholds and class-mean probabilities must agree to
1e-6; the label PNGs, ``statics_class.npy`` and both JSON files must be
identical.  The port's directory handling (skip a finished dir, clear a
partial one, refuse foreign files) is checked on its own.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hiast_tpu.config import default_config as jax_default_config
from hiast_tpu.pseudo.generator import IASGenerator as JaxIASGenerator
from hiast_tpu_torch.config import default_config
from hiast_tpu_torch.data.datasets import read_gray
from hiast_tpu_torch.pseudo.generator import IASGenerator

# Seen rarely in a process that also runs JAX on the CPU: the FIRST torch.exp
# call loses precision (1.5e-4 relative) while later calls are exact.  Spend
# that first call here, so the comparisons below hold to the ulp.
torch.exp(torch.zeros(16))

N_IMAGES, BATCH, H, W, C = 5, 2, 24, 32, 19


def _batches(seed):
    """Per-batch (paths, logits NHWC for the padded batch)."""
    rng = np.random.default_rng(seed)
    out = []
    for start in range(0, N_IMAGES, BATCH):
        paths = [f"/data/img_{i}.png" for i in range(start, min(start + BATCH, N_IMAGES))]
        logits = (rng.normal(size=(BATCH, H, W, C)) * 2.5).astype(np.float32)
        logits[..., 0] += 1.0  # an uneven class mix, like a real model's
        out.append((paths, logits))
    return out


def _data_iter_factory(batches):
    def factory():
        for paths, _ in batches:
            yield {"images": np.zeros((len(paths), H, W, 3), np.uint8), "image_paths": paths}

    return factory


def _configure(cfg, save_dir, num_bins, stats_source):
    cfg.pseudo_policy.type = "IAS"
    cfg.pseudo_policy.save_dir = save_dir
    cfg.pseudo_policy.batch_size = BATCH
    cfg.pseudo_policy.num_hist_bins = num_bins
    cfg.pseudo_policy.stats_source = stats_source
    return cfg


def _read_artifacts(save_dir):
    stats = os.path.dirname(save_dir)
    pngs = {n: read_gray(os.path.join(save_dir, n)) for n in sorted(os.listdir(save_dir))}
    jsons = {}
    for name in ("sample_class_stats", "samples_with_class"):
        with open(os.path.join(stats, f"{name}.json")) as f:
            jsons[name] = json.load(f)
    arrays = {
        name: np.load(os.path.join(stats, f"{name}.npy"))
        for name in ("class_threshold", "statics_class", "class_mean_probabilities")
    }
    return pngs, jsons, arrays


@pytest.mark.parametrize("num_bins,stats_source", [(2048, "full"), (256, "low")])
def test_generator_matches_jax_on_injected_logits(tmp_path, num_bins, stats_source):
    batches = _batches(seed=num_bins)
    jax_dir = str(tmp_path / "jax" / "pseudo_label" / "gray_label")
    port_dir = str(tmp_path / "port" / "pseudo_label" / "gray_label")

    jax_logits = iter([jnp.asarray(b[1]) for b in batches])
    port_logits = iter([torch.from_numpy(np.ascontiguousarray(np.moveaxis(b[1], -1, 1))) for b in batches])

    def jax_forward(images):
        x = next(jax_logits)
        return {"full": x, "low": x[:, ::8, ::8]}

    def port_forward(images):
        x = next(port_logits)
        return {"full": x, "low": x[:, :, ::8, ::8].contiguous()}

    jax_gen = JaxIASGenerator(
        _configure(jax_default_config(), jax_dir, num_bins, stats_source),
        jax_forward, _data_iter_factory(batches), expected_count=N_IMAGES,
    )
    jax_gen.run()
    port_gen = IASGenerator(
        _configure(default_config(), port_dir, num_bins, stats_source),
        port_forward, _data_iter_factory(batches), expected_count=N_IMAGES, device="cpu",
    )
    port_gen.run()

    np.testing.assert_allclose(port_gen.class_threshold, jax_gen.class_threshold, atol=1e-6)
    np.testing.assert_allclose(port_gen.class_mean_probs, jax_gen.class_mean_probs, atol=1e-6)
    want_pngs, want_jsons, want_arrays = _read_artifacts(jax_dir)
    got_pngs, got_jsons, got_arrays = _read_artifacts(port_dir)
    assert list(got_pngs) == list(want_pngs) and len(got_pngs) == N_IMAGES
    for name in want_pngs:
        np.testing.assert_array_equal(got_pngs[name], want_pngs[name], err_msg=name)
    assert got_jsons == want_jsons
    np.testing.assert_array_equal(got_arrays["statics_class"], want_arrays["statics_class"])
    for name in ("class_threshold", "class_mean_probabilities"):
        assert got_arrays[name].dtype == want_arrays[name].dtype == np.float32
        np.testing.assert_allclose(got_arrays[name], want_arrays[name], atol=1e-6)


def _port_generator(save_dir, logits_seed=0):
    cfg = _configure(default_config(), save_dir, 256, "full")
    rng = np.random.default_rng(logits_seed)
    paths = [f"/data/img_{i}.png" for i in range(BATCH)]

    def forward(images):
        return torch.from_numpy(rng.normal(size=(BATCH, C, H, W)).astype(np.float32))

    return IASGenerator(
        cfg, forward, lambda: iter([{"images": np.zeros((BATCH, H, W, 3), np.uint8), "image_paths": paths}]),
        expected_count=BATCH, device="cpu",
    )


def test_finished_dir_is_skipped_and_partial_dir_regenerated(tmp_path, capsys):
    save_dir = str(tmp_path / "pseudo_label" / "gray_label")
    _port_generator(save_dir).run()
    first = sorted(os.listdir(save_dir))
    assert len(first) == BATCH

    _port_generator(save_dir).run()  # complete: skipped
    assert "already exist" in capsys.readouterr().out

    os.unlink(os.path.join(save_dir, first[0]))  # interrupted run
    gen = _port_generator(save_dir)
    gen.run()
    assert "clearing and regenerating" in capsys.readouterr().out
    assert sorted(os.listdir(save_dir)) == first and gen.run_seconds is not None


def test_foreign_files_are_never_cleared(tmp_path):
    save_dir = tmp_path / "pseudo_label" / "gray_label"
    os.makedirs(save_dir)
    (save_dir / "notes.txt").write_text("mine")
    with pytest.raises(RuntimeError, match="refusing to clear"):
        _port_generator(str(save_dir)).run()
    assert (save_dir / "notes.txt").exists()
