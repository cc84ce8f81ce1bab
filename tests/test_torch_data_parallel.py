"""The port's data parallelism (``hiast_tpu_torch/parallel/mesh.py``) at
world size 2 on the CPU, against the JAX package on a ``data=2`` mesh and
against the port at world size 1.

A module fixture spawns ONE pair of worker processes
(``tests/torch_dp_worker.py``, the port only), joined in a ``gloo`` group
through a ``file://`` store under ``tmp_path``.  Each runs every scenario
on its share of the global batch and saves its results; the tests here
read them, and run the JAX side and the port's world-1 runs meanwhile.

- The consistency step (tests/test_torch_consistency_step.py's tiny
  DeepLab: layers (1, 1, 1, 1), 64x128, float32, PRNGKey 1, the strong view
  injected) on a global batch of 4 against JAX's on ``make_mesh`` with
  ``runtime.mesh.data`` 2 (``replicate``, ``shard_batch``), with that
  file's tolerances: losses rtol 1e-4, the head's gradients and the
  BatchNorm running statistics within 1e-3 of each tensor's largest
  magnitude, the backbone's gradients by cosine (at least 0.9999; ROADMAP
  C6).  Against the port's world-1 step, and with whole-trunk remat: the
  losses rtol 1e-6, the head's gradients and every buffer within 1e-5 of
  each tensor's largest magnitude (measured: under 3.4e-6), the
  backbone's gradients by cosine at least 0.99999 (measured 0.999995: at
  this batch some backbone gradients are ill-conditioned in float32, the
  port's own world-1 step lying up to 3.4e-2 of a tensor's scale off its
  float64 one); the two ranks' weights after the step bit-equal.
- The source-only, adversarial and mutual steps (the mutual one on two
  CCA views, each rank taking its rows of the global batch's draws)
  against the port's world-1 steps, with the same bounds (the
  discriminator's Adam parameters within 1e-4; measured 6.9e-5).
- The synced BatchNorm against one ``nn.BatchNorm2d`` on the whole batch
  (inputs of mean 30, where E[x^2] - E[x]^2 in float32 is off by more than
  this bound), and it at a local batch of 1 of the pooled branch's one
  value a channel against ``PooledBatchNorm`` at 2: output, input and affine gradients, running
  statistics within 1e-5 of each tensor's largest magnitude.
- IAS and CBST generation on injected logits (5 images, global batch 4:
  the last batch leaves rank 1 nothing valid) against JAX's generators on
  the ``data=2`` mesh, with tests/test_torch_generator.py's tolerances:
  thresholds and class-mean probabilities to 1e-6, the label PNGs, the
  JSON files and ``statics_class.npy`` identical.
- Validation's IoU areas (a stand-in step, 5 images, batch 4) against
  JAX's ``run_validation`` on the mesh: exact.
- ``cli.train --device cpu`` of the consistency trainer, 2 iterations at a
  global batch of 2 (one sample a rank): one ``train.log``, one
  tensorboard event file, one set of checkpoints, and the checkpoint loads
  and holds both ranks' weights.
- ``check_mesh``'s refusals, in this process, and the generator's and
  the validator's CLIs refusing a ``model`` axis.
"""
import json
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
from hiast_tpu.parallel.mesh import batch_sharding, make_mesh, replicate, shard_batch
from hiast_tpu.pseudo.generator import CBSTGenerator as JaxCBSTGenerator
from hiast_tpu.pseudo.generator import IASGenerator as JaxIASGenerator
from hiast_tpu.registry import populate as jax_populate
from hiast_tpu.selftrain.steps import make_consistency_step as jax_make_consistency_step
from hiast_tpu.selftrain.train_state import TrainState
from hiast_tpu.selftrain.train_state import make_optimizer as jax_make_optimizer
from hiast_tpu_torch.cli import generate_pseudo_labels, validate
from hiast_tpu_torch.config import default_config
from hiast_tpu_torch.data.png import write_png
from hiast_tpu_torch.models.convert import flax_to_port_state_dict
from hiast_tpu_torch.parallel import mesh
from hiast_tpu_torch.utils.checkpoint import load_train_state
from tests import torch_dp_worker as dp
from tests.test_torch_generator import _read_artifacts
from tests.test_torch_train_cli import _consistency_argv, _write_round_stats

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INIT_KEY = 1
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


@pytest.fixture(scope="module")
def jax_init():
    """The JAX variables of the tiny DeepLab at PRNGKey 1."""
    jax_populate()
    cfg = dp.configure(jax_default_config(), dp.SELF_TRAINING)
    segmentor = jax_build_segmentor(cfg, dtype=jnp.float32, backbone_layers=tuple(dp.LAYERS))
    variables = segmentor.init_variables(jax.random.PRNGKey(INIT_KEY), (1, dp.H, dp.W, 3))
    return jax.tree.map(np.asarray, {"params": variables["params"], "batch_stats": variables["batch_stats"]})


def _train_root(root):
    """5 synthetic 96x192 target images with pseudo-labels and the round's
    statistics (tests/test_torch_train_cli.py's)."""
    rng = np.random.default_rng(0)
    pseudo = root / "round0" / "pseudo_label" / "gray_label"
    os.makedirs(root / "city" / "images")
    os.makedirs(pseudo)
    manifest = []
    for i in range(5):
        write_png(str(root / "city" / "images" / f"t_{i}.png"),
                  rng.integers(0, 256, size=(96, 192, 3)).astype(np.uint8))
        lbl = rng.integers(0, 19, size=(96, 192)).astype(np.uint8)
        write_png(str(root / "city" / "images" / f"t_{i}_lbl.png"), lbl)
        lbl[:24] = 255
        write_png(str(pseudo / f"t_{i}_pseudo_label.png"), lbl)
        manifest.append({"image_name": f"images/t_{i}.png", "mask_name": f"images/t_{i}_lbl.png"})
    (root / "t.json").write_text(json.dumps(manifest))
    _write_round_stats(root, str(pseudo))
    return pseudo


class Workers:
    def __init__(self, procs, out_dir):
        self.procs, self.out_dir, self._results = procs, out_dir, None

    def results(self) -> list:
        """Both ranks' results, once both exited (their files removed)."""
        if self._results is None:
            for p in self.procs:
                out, _ = p.communicate(timeout=300)
                assert p.returncode == 0, out.decode()[-4000:]
            self._results = []
            for r in range(2):
                path = os.path.join(self.out_dir, f"rank{r}.pt")
                self._results.append(torch.load(path, weights_only=False))
                os.remove(path)
        return self._results

    def close(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """The workers, started before the JAX variables they wait for."""
    root = tmp_path_factory.mktemp("data_parallel")
    pseudo = _train_root(root)
    torch.save(_consistency_argv(root, root / "work", 2, pseudo, "train.iter_val", "2"), root / "train_argv.pt")
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "2"}
    env.pop("WORLD_SIZE", None)
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "torch_dp_worker.py"), str(r), "2",
         str(root / "store"), str(root), str(root)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(2)]
    workers = Workers(procs, str(root))
    workers.root = root
    yield workers
    workers.close()
    shutil.rmtree(root / "work", ignore_errors=True)  # the checkpoints, some 500 MB


@pytest.fixture(scope="module")
def inputs(world2, jax_init):
    """The consistency step's inputs, handed to the workers."""
    out = {"state_dict": flax_to_port_state_dict(jax_init), "batch": dp.step_batch(seed=7, h=dp.H, w=dp.W)}
    torch.save(out, world2.root / "inputs.tmp")
    os.replace(world2.root / "inputs.tmp", world2.root / "inputs.pt")
    return out


def _world_1_runs(inputs) -> dict:
    batch = dp.step_batch()
    return {
        "consistency": dp.consistency_step(dp.SELF_TRAINING, inputs["state_dict"], inputs["batch"]),
        "remat": dp.remat_step(inputs["state_dict"], inputs["batch"]),
        **{name: getattr(dp, f"{name}_step")(batch) for name in ("source_only", "adversarial", "mutual")},
        "batch_norm": dp.plain_batch_norms(),
    }


@pytest.fixture(scope="module")
def world1(inputs):
    """The port's world-1 runs, in this process, on a thread beside the
    JAX step."""
    with ThreadPoolExecutor(1) as pool:
        future = pool.submit(_world_1_runs, inputs)
        yield future


def _within(got, want, name, rel, floor=0.0):
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    assert got.shape == want.shape, name
    scale = max(float(want.abs().max()) if want.numel() else 0.0, floor)
    err = float((got - want).abs().max()) if want.numel() else 0.0
    assert err <= rel * scale, f"{name}: off by {err:.3g}, {rel} of its scale {scale:.3g}"


def _cosine(got, want, name, bound):
    cos = torch.nn.functional.cosine_similarity(got.double().flatten(), want.double().flatten(), dim=0)
    assert float(cos) >= bound, f"{name}: cosine {float(cos)}"


def _same_step(got: dict, want: dict):
    """Two snapshots of one step (the module docstring's bounds): the
    losses; the head's gradients, every buffer and the discriminator
    within ``WORLD_1_BOUND`` of each tensor's scale (the discriminator's
    Adam parameters 1e-4); the backbone's gradients by cosine.  The SGD
    parameters follow from the gradients."""
    assert sorted(got) == sorted(want)
    for name, value in want["losses"].items():
        np.testing.assert_allclose(got["losses"][name], value, rtol=1e-6, err_msg=name)
    for name in want:
        if name == "losses" or name.endswith("sums"):
            continue
        if "grad.backbone" in name:
            _cosine(got[name], want[name], name, BACKBONE_COSINE)
        else:
            _within(got[name], want[name], name, 1e-4 if name.startswith("d.param") else WORLD_1_BOUND)


def test_consistency_step_matches_the_jax_mesh(world2, inputs, world1, jax_init):
    """The JAX step runs while the workers do (the first test to ask for them)."""
    jax_populate()
    cfg = dp.configure(jax_default_config(), dp.SELF_TRAINING)
    cfg.runtime.mesh.data = 2
    m = make_mesh(cfg)
    assert m.shape["data"] == 2
    segmentor = jax_build_segmentor(cfg, dtype=jnp.float32, backbone_layers=tuple(dp.LAYERS))
    tx = jax_make_optimizer(cfg, jax_init["params"])
    state = TrainState(
        step=jnp.zeros((), jnp.int32), params=jax_init["params"], batch_stats=jax_init["batch_stats"],
        opt_state=tx.init(jax_init["params"]), ema_params=jax.tree.map(jnp.copy, jax_init["params"]),
    )
    batch = inputs["batch"]
    jax_batch = {"t_img": batch["t_img"], "t_img_strong": batch["t_img_strong"],
                 "t_plbl": batch["t_plbl"].astype(np.int32)}
    step = jax.jit(jax_make_consistency_step(segmentor, tx, strong_aug=None))
    new_state, want_losses = step(replicate(m, state), shard_batch(m, jax_batch), jax.random.PRNGKey(1))
    new_state = jax.tree.map(np.asarray, new_state)

    got, other = (r["consistency"] for r in world2.results())
    for name, value in want_losses.items():
        np.testing.assert_allclose(got["losses"][name], float(value), rtol=1e-4, err_msg=name)
    for name in ("sums", "ema.sums"):  # the ranks step alike
        assert torch.equal(got[name], other[name]), name

    def grad(path, p0, p1):
        return (p0 - p1) / (1.0 if path[0].key == "backbone" else 10.0)

    jgrads = flax_to_port_state_dict(
        {"params": jax.tree_util.tree_map_with_path(grad, jax_init["params"], new_state.params)})
    n_frozen = n_cosine = 0
    for name, want in jgrads.items():
        if name.endswith(("running_mean", "running_var", "num_batches_tracked")):
            continue
        if f"grad.{name}" not in got:  # frozen BatchNorm affine
            assert float(want.abs().max()) == 0.0, name
            n_frozen += 1
        elif name.startswith("backbone."):
            cos = torch.nn.functional.cosine_similarity(got[f"grad.{name}"].double().flatten(),
                                                        want.double().flatten(), dim=0)
            assert float(cos) >= 0.9999, f"grad {name}: cosine {float(cos)}"
            n_cosine += 1
        else:
            _within(got[f"grad.{name}"], want, f"grad {name}", 1e-3)
    assert n_frozen > 0 and n_cosine > 0
    stats = flax_to_port_state_dict({"params": new_state.params, "batch_stats": new_state.batch_stats})
    n_stats = 0
    for name, want in stats.items():
        if name.endswith(("running_mean", "running_var")):
            _within(got[f"buffer.{name}"], want, name, 1e-3)
            n_stats += 1
    assert n_stats > 0


@pytest.mark.parametrize("scenario", ["consistency", "remat"])
def test_consistency_step_matches_world_1(world2, world1, scenario):
    want = world1.result()[scenario]
    got = world2.results()[0][scenario]
    _same_step(got, want)
    counts = {int(v) for k, v in got.items() if k.endswith("num_batches_tracked") and k.startswith("buffer.")}
    assert counts == {1}  # one update a step, the remat rerun's collectives included


@pytest.mark.parametrize("scenario", ["source_only", "adversarial", "mutual"])
def test_step_matches_world_1(world2, world1, scenario):
    want = world1.result()[scenario]
    got, other = (r[scenario] for r in world2.results())
    _same_step(got, want)
    assert any(k.startswith("grad.backbone") for k in got)
    for name in got:
        if name.endswith("sums") or "param." in name or "buffer." in name:
            assert torch.equal(got[name], other[name]), name


def test_synced_batch_norm_matches_batch_norm_2d(world2, world1):
    want = world1.result()["batch_norm"]
    ranks = [r["batch_norm"] for r in world2.results()]
    for name, value in want.items():
        if name.endswith(("y", "dx")):  # each rank holds its rows
            got = torch.cat([r[name] for r in ranks])
        else:
            got = ranks[0][name]
            assert torch.equal(got, ranks[1][name]), name
        # the pooled input gradient is 0 but for rounding (two values a
        # channel normalise to +-1): held on the scale of dy
        _within(got, value, name, WORLD_1_BOUND, floor=1.0 if name == "pooled.dx" else 0.0)
    # at mean 30 the cancelling form's variance is off by more than the bound
    x = dp.bn_inputs()["x"]
    naive = (x.square().mean(dim=(0, 2, 3)) - x.mean(dim=(0, 2, 3)).square())
    exact = x.double().var(dim=(0, 2, 3), unbiased=False)
    assert float(((naive.double() - exact).abs() / exact).max()) > WORLD_1_BOUND


def _jax_generator(cls, policy, save_dir):
    cfg = jax_default_config()
    cfg.pseudo_policy.type = policy
    cfg.pseudo_policy.save_dir = save_dir
    cfg.pseudo_policy.batch_size = dp.GEN_BATCH
    cfg.pseudo_policy.num_hist_bins = 2048
    cfg.pseudo_policy.stats_source = "full"
    cfg.runtime.mesh.data = 2
    m = make_mesh(cfg, batch_size=dp.GEN_BATCH)
    table = np.moveaxis(dp.gen_logits(), 1, -1)

    def forward(images):
        full = jax.device_put(jnp.asarray(table[np.asarray(images)[:, 0, 0, 0]]), batch_sharding(m))
        return {"full": full, "low": full}

    def batches():
        return iter(JaxBatchIterator(dp.IndexImages(dp.GEN_IMAGES, dp.GEN_H, dp.GEN_W), dp.GEN_BATCH,
                                     shuffle=False, drop_last=False))

    gen = cls(cfg, forward, batches, expected_count=dp.GEN_IMAGES)
    gen.run()
    return gen


@pytest.mark.parametrize("policy,cls", [("IAS", JaxIASGenerator), ("CBST", JaxCBSTGenerator)])
def test_generation_matches_the_jax_mesh(world2, tmp_path, policy, cls):
    jax_dir = str(tmp_path / "pseudo_label" / "gray_label")
    want = _jax_generator(cls, policy, jax_dir)
    ranks = [r[policy.lower()] for r in world2.results()]
    for got in ranks:  # the carried state is the same on both ranks
        np.testing.assert_allclose(got["class_threshold"], want.class_threshold, atol=1e-6)
        np.testing.assert_allclose(got["class_mean_probs"], want.class_mean_probs, atol=1e-6)
    want_pngs, want_jsons, want_arrays = _read_artifacts(jax_dir)
    got_pngs, got_jsons, got_arrays = _read_artifacts(
        str(world2.root / policy.lower() / "pseudo_label" / "gray_label"))
    assert list(got_pngs) == list(want_pngs) and len(got_pngs) == dp.GEN_IMAGES
    for name in want_pngs:
        np.testing.assert_array_equal(got_pngs[name], want_pngs[name], err_msg=name)
    assert got_jsons == want_jsons
    np.testing.assert_array_equal(got_arrays["statics_class"], want_arrays["statics_class"])
    for name in ("class_threshold", "class_mean_probabilities"):
        np.testing.assert_allclose(got_arrays[name], want_arrays[name], atol=1e-6)


def test_validation_areas_match_the_jax_mesh(world2):
    cfg = jax_default_config()
    cfg.runtime.mesh.data = 2
    m = make_mesh(cfg, batch_size=dp.VAL_BATCH)

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


def test_train_cli_writes_on_rank_0_only(world2):
    work = world2.root / "work"
    results = world2.results()
    assert [r["train"]["step"] for r in results] == [2, 2]
    assert results[0]["train"]["losses"] == results[1]["train"]["losses"]  # the global losses
    found = [os.path.relpath(os.path.join(d, f), work) for d, _, files in os.walk(work) for f in files]
    assert sorted(f for f in found if not f.startswith(("checkpoints", "tensorboard"))) == [
        "config.json", "train.log"]
    assert len([f for f in found if f.startswith("tensorboard")]) == 1
    assert sorted(os.listdir(work / "checkpoints")) == [
        "ema_model_last.pth", "model_best.pth", "model_last.pth", "model_mid.pth"]
    state = load_train_state(str(work / "checkpoints" / "model_last.pth"))
    assert state["step"] == 2
    saved = torch.stack([t.double().sum() for t in state["state_dict"].values()])
    for r in results:
        assert torch.equal(r["train"]["sums"], saved)
    log = (work / "train.log").read_text()
    assert "model, iter: 2, miou:" in log and "[rank 1]" not in log


@pytest.mark.parametrize("key,value,world,batch,message", [
    ("space", 2, 2, None, "ROADMAP item A20"),  # a path that shards no rows (tests/test_torch_space_parallel.py)
    ("model", 2, 2, None, "ROADMAP item A17"),
    ("data", 3, 2, None, "runtime.mesh.data=3 but the process group has 2 ranks"),
    ("data", -1, 4, 6, r"world sizes that fit it: \[1, 2, 3, 6\]"),
])
def test_check_mesh_refuses(key, value, world, batch, message):
    cfg = default_config()
    setattr(cfg.runtime.mesh, key, value)
    with pytest.raises(ValueError, match=message):
        mesh.check_mesh(cfg, batch, world=world)
    cfg = default_config()
    mesh.check_mesh(cfg, 6, world=2)  # data -1 at a world size that divides the batch


@pytest.mark.parametrize("cli", [generate_pseudo_labels, validate], ids=["generate_pseudo_labels", "validate"])
def test_entry_points_check_the_mesh(cli):
    """The generator's and the validator's CLIs refuse an axis the port
    lacks before they build anything."""
    with pytest.raises(ValueError, match="ROADMAP item A17"):
        cli.main(["--device", "cpu", "runtime.mesh.model", "2"])
