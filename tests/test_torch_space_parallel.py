"""The port's ``space`` mesh axis (``hiast_tpu_torch/parallel/spatial.py``)
at ``data=1, space=2`` on the CPU: each of two ranks holds one slab of
every image's rows.  Held against the JAX package on a mesh of 2 of its 8
virtual devices at ``data=1, space=2`` (``tests/test_multichip.py``'s
paths) and against the port at world size 1.

A module fixture spawns ONE pair of worker processes
(``tests/torch_space_worker.py``, the port only) in a ``gloo`` group
through a ``file://`` store under ``tmp_path``; the tests here read their
results, and run the JAX side and the port's world-1 runs meanwhile.

- The HIAST consistency step (tests/test_torch_consistency_step.py's tiny
  DeepLab-v2: layers (1, 1, 1, 1), 64x128, batch 2, float32, SGD at lr 1,
  PRNGKey 1) with the CCA strong view made on the slabs from the JAX
  step's own draws (tests/test_torch_color_aug.py's ``jax_draws``):
  against JAX's step on the mesh, losses rtol 1e-4, the head's gradients
  and the BatchNorm statistics within 1e-3 of each tensor's scale, the
  backbone's by cosine at least 0.9999 (ROADMAP C6); against the port's
  world-1 step, losses rtol 1e-5, the head's gradients, every buffer and
  the head's parameters after the step within 1e-5 of each tensor's scale,
  the backbone's gradients by cosine at least 0.99999; the two ranks'
  weights bit-equal.
- IAS on injected logits (tests/torch_dp_worker.py's 5 images, batch 4,
  rows sharded): labels, counts and every artifact equal to JAX's on the
  mesh, thresholds and class-mean probabilities within 1e-6.
- The generation, validation (two scales' worth of flip) and consistency
  training CLIs on a tiny DeepLab-v2 with ``runtime.mesh.space 2``
  against the same CLIs at world size 1: the label PNGs and JSON files
  equal, thresholds within 1e-6, IoU within 1e-4 (bf16), the training
  losses rtol 1e-5 and the ranks' weights equal; the multi-scale/flip
  validation step in float32: predictions equal.
- Validation's IoU areas (a stand-in step on each slab) against JAX's on
  the mesh: exact.
- SegFormer-B0's eval forward at 64x128 (32 rows a slab; K/V gathered
  for each rank's queries) against JAX's on the mesh within 1e-4, and its
  self-training step, with and without 'blocks' remat, against the
  port's world-1 step: losses rtol 1e-5,
  each gradient's cosine at least 0.99999 (the five biases that are zero
  in exact arithmetic left out, tests/test_torch_kernels_cuda.py).
- ``check_mesh`` with a ``space`` axis, and every path outside the slice
  refusing it (ROADMAP A20).
"""
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hiast_tpu.config import default_config as jax_default_config
from hiast_tpu.data.pipeline import BatchIterator as JaxBatchIterator
from hiast_tpu.evaluation import run_validation as jax_run_validation
from hiast_tpu.models.segmentors import build_segmentor as jax_build_segmentor
from hiast_tpu.ops.metrics import intersection_and_union as jax_intersection_and_union
from hiast_tpu.parallel.mesh import make_mesh, replicate, shard_batch, spatial_sharding
from hiast_tpu.pseudo.generator import IASGenerator as JaxIASGenerator
from hiast_tpu.registry import populate as jax_populate
from hiast_tpu.selftrain.steps import make_consistency_step as jax_make_consistency_step
from hiast_tpu.selftrain.steps import normalize_image as jax_normalize_image
from hiast_tpu.selftrain.train_state import TrainState
from hiast_tpu.selftrain.train_state import make_optimizer as jax_make_optimizer
from hiast_tpu_torch.cli import export_model, generate_pseudo_labels, train
from hiast_tpu_torch.config import default_config
from hiast_tpu_torch.models.convert import flax_to_port_state_dict
from hiast_tpu_torch.models.deeplab_v2 import DeepLabV2
from hiast_tpu_torch.parallel import mesh
from tests import torch_dp_worker as dp
from tests import torch_space_worker as sw
from tests.test_torch_color_aug import jax_draws
from tests.test_torch_data_parallel import _cosine, _train_root, _within
from tests.test_torch_generator import _read_artifacts
from tests.test_torch_train_cli import _consistency_argv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INIT_KEY = 1
STEP_KEY = 1
WORLD_1_BOUND = 1e-5
BACKBONE_COSINE = 0.99999

# tests/test_torch_generator.py: the first torch.exp of a process that also
# runs JAX may lose precision; spend it here
torch.exp(torch.zeros(16))


@pytest.fixture(scope="module", autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _jax_mesh(cfg):
    """The JAX mesh at data=1, space=2 on 2 of the 8 devices."""
    cfg.runtime.mesh.data, cfg.runtime.mesh.space = 1, 2
    m = make_mesh(cfg, devices=jax.devices()[:2])
    assert m.shape == {"data": 1, "space": 2, "model": 1}
    return m


def _cli_argv(root, pth: str, tag: str, space: bool) -> dict:
    """The CLIs' arguments on ``_train_root``'s images, writing under ``tag``."""
    city, manifest = str(root / "city"), str(root / "t.json")
    extra = ["runtime.mesh.space", "2"] if space else []
    model = ["model.seg_model.backbone_layers", "[1, 1, 1, 1]"]
    return {
        "generate": ["--device", "cpu", "--pseudo_resume_from", pth, "--pseudo_save_dir",
                     str(root / tag / "pseudo_label" / "gray_label"), "model.type", "SelfTrainingSegmentor", *model,
                     "dataset.target.type", "Cityscapes", "dataset.target.json_path", manifest,
                     "dataset.target.image_dir", city, "pseudo_policy.type", "IAS", "pseudo_policy.batch_size", "2",
                     "pseudo_policy.resize_size", "[64, 128]", "pseudo_policy.stats_source", "full", *extra],
        "validate": ["--device", "cpu", "--validate_resume_from", pth, "model.type", "SourceOnlySegmentor", *model,
                     "dataset.val.type", "Cityscapes", "dataset.val.json_path", manifest, "dataset.val.image_dir",
                     city, "validate.resize_sizes", "[[64, 128], [32, 64]]", "validate.is_flip", "True",
                     "validate.batch_size", "2", *extra],
        "train": _consistency_argv(root, root / tag / "work", 2, root / "round0" / "pseudo_label" / "gray_label",
                                   "train.iter_val", "2", *extra),
    }


class Workers:
    def __init__(self, procs, root):
        self.procs, self.root, self._results = procs, root, None

    def results(self) -> list:
        if self._results is None:
            for p in self.procs:
                out, _ = p.communicate(timeout=300)
                assert p.returncode == 0, out.decode()[-4000:]
            self._results = [torch.load(self.root / f"rank{r}.pt", weights_only=False) for r in range(2)]
        return self._results

    def close(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """_train_root's images, pseudo-labels and statistics and a seeded tiny
    DeepLab-v2 ``.pth``."""
    root = tmp_path_factory.mktemp("space_parallel")
    _train_root(root)
    model = DeepLabV2(backbone_layers=(1, 1, 1, 1))
    model.init_weights(torch.Generator().manual_seed(3))
    torch.save(model.state_dict(), root / "deeplab.pth")
    return root


@pytest.fixture(scope="module")
def cli_argv(root):
    """The CLIs' arguments at world 1 and, handed to the workers, at world 2."""
    argv = {tag: _cli_argv(root, str(root / "deeplab.pth"), tag, space) for tag, space in
            (("world1", False), ("world2", True))}
    torch.save(argv["world2"], root / "argv.pt")
    return argv


@pytest.fixture(scope="module")
def world2(root, cli_argv):
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "2"}
    env.pop("WORLD_SIZE", None)
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "torch_space_worker.py"), str(r), str(root / "store"),
         str(root), str(root)], cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(2)]
    workers = Workers(procs, root)
    yield workers
    workers.close()
    for tag in ("world1", "world2"):
        shutil.rmtree(root / tag / "work", ignore_errors=True)  # the checkpoints


@pytest.fixture(scope="module")
def jax_init():
    """The tiny DeepLab's JAX variables at PRNGKey 1, and B0's at PRNGKey 0."""
    jax_populate()
    cfg = dp.configure(jax_default_config(), dp.SELF_TRAINING)
    seg = jax_build_segmentor(cfg, dtype=jnp.float32, backbone_layers=tuple(dp.LAYERS))
    v = seg.init_variables(jax.random.PRNGKey(INIT_KEY), (1, sw.H, sw.W, 3))
    b0_cfg = dp.configure(jax_default_config(), sw.SEGFORMER)
    b0 = jax_build_segmentor(b0_cfg, dtype=jnp.float32)
    v0 = b0.init_variables(jax.random.PRNGKey(0), (1, sw.SEG_H, sw.SEG_W, 3))
    pick = lambda v: jax.tree.map(np.asarray, {"params": v["params"], "batch_stats": v["batch_stats"]})  # noqa: E731
    return {"deeplab": pick(v), "b0": pick(v0)}


@pytest.fixture(scope="module")
def inputs(world2, jax_init):
    """The consistency step's batch, variables and CCA draws, and B0's
    variables and image, handed to the workers."""
    batch = dp.step_batch(seed=7, h=sw.H, w=sw.W)
    batch = {k: batch[k][:sw.B] for k in ("t_img", "t_plbl")}
    img = np.random.default_rng(9).integers(0, 256, size=(sw.B, sw.SEG_H, sw.SEG_W, 3)).astype(np.uint8)
    val_img = np.random.default_rng(10).integers(0, 256, size=(sw.B, 96, 192, 3)).astype(np.uint8)
    out = {"val_img": val_img,"state_dict": flax_to_port_state_dict(jax_init["deeplab"]), "batch": batch,
           "draws": jax_draws(jax.random.PRNGKey(STEP_KEY), sw.B, "CCA"),
           "b0_state_dict": flax_to_port_state_dict(jax_init["b0"]), "b0_img": img}
    torch.save(out, world2.root / "inputs.tmp")
    os.replace(world2.root / "inputs.tmp", world2.root / "inputs.pt")
    return out


def _world_1_runs(argv, inputs) -> dict:
    return {
        "consistency": sw.consistency_step(inputs["state_dict"], inputs["batch"], inputs["draws"]),
        "segformer_step": sw.segformer_step(sw.segformer_batch()),
        "segformer_remat": sw.segformer_step(sw.segformer_batch(), remat=True),
        "ms_flip": sw.ms_flip_predictions(inputs["state_dict"], inputs["val_img"]),
        "cli": sw.cli_runs(argv),
    }


@pytest.fixture(scope="module")
def world1(cli_argv, inputs):
    """The port's world-1 runs, on a thread beside the JAX steps."""
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(_world_1_runs, cli_argv["world1"], inputs)


def test_consistency_step_matches_the_jax_mesh(world2, inputs, world1, jax_init):
    """The JAX step, CCA on, runs while the workers do."""
    jax_populate()
    cfg = dp.configure(jax_default_config(), dp.SELF_TRAINING)
    m = _jax_mesh(cfg)
    seg = jax_build_segmentor(cfg, dtype=jnp.float32, backbone_layers=tuple(dp.LAYERS))
    init = jax_init["deeplab"]
    tx = jax_make_optimizer(cfg, init["params"])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=init["params"], batch_stats=init["batch_stats"],
                       opt_state=tx.init(init["params"]), ema_params=jax.tree.map(jnp.copy, init["params"]))
    batch = {"t_img": inputs["batch"]["t_img"], "t_plbl": inputs["batch"]["t_plbl"].astype(np.int32)}
    step = jax.jit(jax_make_consistency_step(seg, tx, strong_aug="CCA"))
    new_state, want_losses = step(replicate(m, state), shard_batch(m, batch), jax.random.PRNGKey(STEP_KEY))
    new_state = jax.tree.map(np.asarray, new_state)

    got, other = (r["consistency"] for r in world2.results())
    for name, value in want_losses.items():
        np.testing.assert_allclose(got["losses"][name], float(value), rtol=1e-4, err_msg=name)
    for name in ("sums", "ema.sums"):
        assert torch.equal(got[name], other[name]), name

    def grad(path, p0, p1):
        return (p0 - p1) / (1.0 if path[0].key == "backbone" else 10.0)

    jgrads = flax_to_port_state_dict(
        {"params": jax.tree_util.tree_map_with_path(grad, init["params"], new_state.params)})
    n_cosine = 0
    for name, want in jgrads.items():
        if f"grad.{name}" not in got:  # frozen BatchNorm affine
            assert float(want.abs().max()) == 0.0, name
        elif name.startswith("backbone."):
            _cosine(got[f"grad.{name}"], want, f"grad {name}", 0.9999)
            n_cosine += 1
        else:
            _within(got[f"grad.{name}"], want, f"grad {name}", 1e-3)
    assert n_cosine > 0
    stats = flax_to_port_state_dict({"params": new_state.params, "batch_stats": new_state.batch_stats})
    for name, want in stats.items():
        if name.endswith(("running_mean", "running_var")):
            _within(got[f"buffer.{name}"], want, name, 1e-3)


def test_ranks_form_one_data_index_of_two_slabs(world2, inputs):
    assert [r["space"] for r in world2.results()] == [(0, 2, 0, 1), (1, 2, 0, 1)]


def test_consistency_step_matches_world_1(world2, inputs, world1):
    want = world1.result()["consistency"]
    got = world2.results()[0]["consistency"]
    assert sorted(got) == sorted(want)
    for name, value in want["losses"].items():
        np.testing.assert_allclose(got["losses"][name], value, rtol=1e-5, err_msg=name)
    for name in want:
        if name == "losses" or name.endswith("sums"):
            continue
        if name.startswith("grad.backbone"):
            _cosine(got[name], want[name], name, BACKBONE_COSINE)
        elif not name.startswith("param.backbone"):  # SGD at lr 1: the backbone's gradients, by cosine
            _within(got[name], want[name], name, WORLD_1_BOUND)


def _jax_ias(save_dir: str):
    cfg = jax_default_config()
    cfg.pseudo_policy.type = "IAS"
    cfg.pseudo_policy.save_dir = save_dir
    cfg.pseudo_policy.batch_size = dp.GEN_BATCH
    cfg.pseudo_policy.num_hist_bins = 2048
    cfg.pseudo_policy.stats_source = "full"
    m = _jax_mesh(cfg)
    table = np.moveaxis(dp.gen_logits(), 1, -1)

    def forward(images):
        full = jax.device_put(jnp.asarray(table[np.asarray(images)[:, 0, 0, 0]]), spatial_sharding(m))
        return {"full": full, "low": full}

    def batches():
        return iter(JaxBatchIterator(dp.IndexImages(dp.GEN_IMAGES, dp.GEN_H, dp.GEN_W), dp.GEN_BATCH,
                                     shuffle=False, drop_last=False))

    gen = JaxIASGenerator(cfg, forward, batches, expected_count=dp.GEN_IMAGES)
    gen.run()
    return gen


def test_ias_matches_the_jax_mesh(world2, inputs, tmp_path):
    jax_dir = str(tmp_path / "pseudo_label" / "gray_label")
    want = _jax_ias(jax_dir)
    for got in (r["ias"] for r in world2.results()):
        np.testing.assert_allclose(got["class_threshold"], want.class_threshold, atol=1e-6)
        np.testing.assert_allclose(got["class_mean_probs"], want.class_mean_probs, atol=1e-6)
    want_pngs, want_jsons, want_arrays = _read_artifacts(jax_dir)
    got_pngs, got_jsons, got_arrays = _read_artifacts(str(world2.root / "ias" / "pseudo_label" / "gray_label"))
    assert list(got_pngs) == list(want_pngs) and len(got_pngs) == dp.GEN_IMAGES
    for name in want_pngs:
        np.testing.assert_array_equal(got_pngs[name], want_pngs[name], err_msg=name)
    assert got_jsons == want_jsons
    np.testing.assert_array_equal(got_arrays["statics_class"], want_arrays["statics_class"])
    for name in ("class_threshold", "class_mean_probabilities"):
        np.testing.assert_allclose(got_arrays[name], want_arrays[name], atol=1e-6)


def test_validation_areas_match_the_jax_mesh(world2, inputs):
    cfg = jax_default_config()
    m = _jax_mesh(cfg)

    @jax.jit
    def step(params, batch_stats, img, lbl):
        return jax_intersection_and_union(img[..., 1].astype(jnp.int32) % dp.C, lbl, dp.C)

    batches = JaxBatchIterator(dp.IndexImages(dp.VAL_IMAGES, dp.VAL_H, dp.VAL_W, with_labels=True), dp.VAL_BATCH,
                               shuffle=False, drop_last=False)
    want_iou, want_miou = jax_run_validation(step, None, None, iter(batches), mesh=m)
    for r in world2.results():
        np.testing.assert_array_equal(r["validation"]["iou"], want_iou)
        assert r["validation"]["miou"] == want_miou
    assert np.asarray(want_iou).max() > 0


def test_clis_match_world_1(root, world2, inputs, world1):
    """Generation, validation and consistency training under
    ``runtime.mesh.space 2`` against world size 1."""
    want = world1.result()["cli"]
    ranks = [r["cli"] for r in world2.results()]
    want_pngs, want_jsons, want_arrays = _read_artifacts(str(root / "world1" / "pseudo_label" / "gray_label"))
    got_pngs, got_jsons, got_arrays = _read_artifacts(str(root / "world2" / "pseudo_label" / "gray_label"))
    assert list(got_pngs) == list(want_pngs) and len(got_pngs) == 5
    for name in want_pngs:
        np.testing.assert_array_equal(got_pngs[name], want_pngs[name], err_msg=name)
    assert got_jsons == want_jsons
    np.testing.assert_array_equal(got_arrays["statics_class"], want_arrays["statics_class"])
    for got in ranks:
        np.testing.assert_allclose(got["thresholds"], want["thresholds"], atol=1e-6)
        np.testing.assert_allclose(got["cmp"], want["cmp"], atol=1e-6)
        # the validator's trunk runs under bf16 autocast, where a slab's
        # convolutions and resizes round apart from the whole image's and a
        # random model's near-ties flip a few pixels (measured: 3 classes off
        # by at most 3.5e-6); in float32 the predictions are equal
        # (test_ms_flip_predictions_match_world_1)
        np.testing.assert_allclose(got["iou"], want["iou"], rtol=0, atol=1e-4)
    assert ranks[0]["train"]["step"] == ranks[1]["train"]["step"] == want["train"]["step"] == 2
    assert ranks[0]["train"]["losses"] == ranks[1]["train"]["losses"]  # the global losses
    assert torch.equal(ranks[0]["train"]["sums"], ranks[1]["train"]["sums"])
    for got_step, want_step in zip(ranks[0]["train"]["losses"], want["train"]["losses"]):
        for name, value in want_step.items():
            np.testing.assert_allclose(got_step[name], value, rtol=1e-5, err_msg=name)
    work = root / "world2" / "work"
    assert sorted(os.listdir(work / "checkpoints")) == [
        "ema_model_last.pth", "model_best.pth", "model_last.pth", "model_mid.pth"]
    assert "[rank 1]" not in (work / "train.log").read_text()


def test_ms_flip_predictions_match_world_1(world2, inputs, world1):
    """The multi-scale (64x128 and 32x64 from 96x192) and flip validation
    step in float32: the slabs' predictions are the whole image's."""
    got = torch.cat([r["ms_flip"] for r in world2.results()], 1)
    assert torch.equal(got, world1.result()["ms_flip"])


def test_segformer_forward_matches_the_jax_mesh(world2, inputs, jax_init):
    jax_populate()
    cfg = dp.configure(jax_default_config(), sw.SEGFORMER)
    seg = jax_build_segmentor(cfg, dtype=jnp.float32)
    m = _jax_mesh(cfg)
    img = inputs["b0_img"]
    fwd = jax.jit(lambda v, x: seg.forward(v, jax_normalize_image(x), train=False)["logits"])
    want = np.asarray(fwd(replicate(m, jax_init["b0"]), jax.device_put(jnp.asarray(img), spatial_sharding(m))))
    got = torch.cat([r["segformer_forward"] for r in world2.results()], 2).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("scenario", ["segformer_step", "segformer_remat"])
def test_segformer_step_matches_world_1(world2, inputs, world1, scenario):
    """Also under 'blocks' remat, whose rerun issues each block's halos
    and gather again in the backward."""
    want = world1.result()[scenario]
    got, other = (r[scenario] for r in world2.results())
    assert torch.equal(got["sums"], other["sums"])
    for name, value in want["losses"].items():
        np.testing.assert_allclose(got["losses"][name], value, rtol=1e-5, err_msg=name)
    zero = {"grad.backbone.norm4.bias"} | {f"grad.decode_head.linear_c{i}.proj.bias" for i in range(1, 5)}
    grads = [n for n in want if n.startswith("grad.")]
    assert zero <= set(grads) and len(grads) > 100
    for name in grads:
        if name not in zero:
            _cosine(got[name], want[name], name, BACKBONE_COSINE)
    for name in want:
        if name.startswith("buffer."):
            _within(got[name], want[name], name, WORLD_1_BOUND)


@pytest.mark.parametrize("rank", range(4))
def test_grid_places_rank_d_times_space_plus_s(monkeypatch, rank):
    """World 4 at space 2, as JAX's ``devs.reshape(data, space, model)``:
    ranks 2d and 2d + 1 share data index d (its samples, their stream and
    their CCA draws) and take slab ``rank % 2`` of the rows."""
    monkeypatch.setattr(mesh, "initialized", lambda: True)
    monkeypatch.setattr(mesh, "rank", lambda: rank)
    monkeypatch.setattr(mesh, "world_size", lambda: 4)
    monkeypatch.setitem(mesh._space, "size", 2)
    d, s = rank // 2, rank % 2
    assert (mesh.data_index(), mesh.data_size(), mesh.space_index(), mesh.space_size()) == (d, 2, s, 2)
    assert mesh.share() == (d, 2) and mesh.local_share(6) == slice(3 * d, 3 * d + 3)
    assert mesh.stream_seed(5, 1) == 6 + mesh.STREAM_SEED_STRIDE * d
    img = np.arange(2 * 8 * 3 * 3).reshape(2, 8, 3, 3)
    np.testing.assert_array_equal(mesh.local_rows(img), img[:, 4 * s:4 * s + 4])
    with pytest.raises(ValueError, match="7 image rows do not split"):
        mesh.local_rows(img[:, :7])


@pytest.mark.parametrize("n,h,above,below", [(2, 4, 24, 24), (4, 2, 5, 3), (4, 2, 0, 7), (3, 5, 1, 0)])
def test_halo_plan_takes_rows_from_as_many_ranks_as_it_needs(n, h, above, below):
    """Each rank's halo, assembled from every rank's border rows as
    ``_Halo`` assembles it, is the image's rows around the slab (pad rows,
    -1 here, beyond it), also where the halo is deeper than a slab."""
    from hiast_tpu_torch.parallel.spatial import _halo_plan

    image = np.arange(n * h)
    for s in range(n):
        top, bottom, rows_above, rows_below = _halo_plan(h, s, n, above, below)
        borders = [np.concatenate([image[r * h:r * h + top], image[(r + 1) * h - bottom:(r + 1) * h]])
                   for r in range(n)]
        got = np.concatenate([np.full(j - i, -1) if owner is None else borders[owner][i:j]
                              for owner, i, j in rows_above + [(None, 0, 0)] + rows_below])
        want = np.array([g if 0 <= g < n * h else -1 for g in range(s * h - above, (s + 1) * h + below)
                         if not s * h <= g < (s + 1) * h])
        np.testing.assert_array_equal(got, want, err_msg=f"rank {s}")


@pytest.mark.parametrize("world,space,batch,rows,stride", [
    (2, 2, 6, [512, 512], 8), (4, 2, 6, [768], 8), (2, 2, 2, [64], 32), (4, 4, 1, [1024], 8)])
def test_check_mesh_takes_the_space_axis(world, space, batch, rows, stride):
    cfg = default_config()
    cfg.runtime.mesh.space = space
    mesh.check_mesh(cfg, batch, world=world, rows=rows, stride=stride)
    cfg.runtime.mesh.data = world // space
    mesh.check_mesh(cfg, batch, world=world, rows=rows, stride=stride)


@pytest.mark.parametrize("settings,world,batch,rows,stride,message", [
    ({"model": 2}, 2, None, None, 8, "ROADMAP item A17"),
    ({"space": 2, "model": 2}, 4, None, [512], 8, "ROADMAP item A17"),
    ({"space": 2}, 2, None, None, 8, "ROADMAP item A20"),
    ({"space": 3}, 4, None, [768], 8, "does not divide the process group's 4 ranks"),
    ({"space": 2, "data": 2}, 2, None, [512], 8, r"runtime.mesh.data=2 .* set it to -1 or to 1"),
    ({"space": 2}, 4, 3, [512], 8, r"world sizes that fit it: \[2, 6\]"),
    ({"space": 2}, 2, 2, [520], 8, "rows that fit are multiples of 16, e.g. 512 or 528"),
    ({"space": 2}, 2, 2, [96], 32, "rows that fit are multiples of 64, e.g. 64 or 128"),
])
def test_check_mesh_refuses_a_space_axis_it_cannot_run(settings, world, batch, rows, stride, message):
    cfg = default_config()
    for key, value in settings.items():
        setattr(cfg.runtime.mesh, key, value)
    with pytest.raises(ValueError, match=message):
        mesh.check_mesh(cfg, batch, world=world, rows=rows, stride=stride)


_TRAINERS = {
    "SourceOnlyTrainer": ["trainer", "SourceOnlyTrainer", "model.type", "SourceOnlySegmentor"],
    "AdversarialWarmupTrainer": ["trainer", "AdversarialWarmupTrainer", "model.type", "AdversarialWarmupSegmentor",
                                 "model.discriminator.is_enabled", "True"],
    "MutualLearningTrainer": ["--pseudo_save_dir", "p", "trainer", "MutualLearningTrainer", "model.type",
                              "SelfTrainingSegmentor", "mut_training.is_enabled", "True",
                              "mut_training.mut_loss.weight", "0.5"],
}


@pytest.mark.parametrize("path,main,argv", [
    *[(name, train.main, argv) for name, argv in _TRAINERS.items()],
    ("DeepLab_V3Plus", train.main, ["--pseudo_save_dir", "p", "trainer", "SelfTrainingTrainer", "model.type",
                                    "SelfTrainingSegmentor", "model.seg_model.type", "DeepLab_V3Plus"]),
    *[(policy, generate_pseudo_labels.main, ["pseudo_policy.type", policy]) for policy in ("CT", "NT", "CBST")],
    ("multi-scale/flip", generate_pseudo_labels.main, ["pseudo_policy.is_flip", "True"]),
    ("the serving export", export_model.main, ["--output", "m.pt2"]),
])
def test_paths_outside_the_slice_refuse_the_space_axis(path, main, argv):
    """Before they build anything, naming the ROADMAP item."""
    with pytest.raises(ValueError, match=f"runtime.mesh.space=2: .*{path}.*ROADMAP item A20"):
        main(["--device", "cpu", *argv, "runtime.mesh.space", "2"])
