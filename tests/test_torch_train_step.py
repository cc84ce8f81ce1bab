"""One SegFormer-B0 self-training step of the port (hiast_tpu_torch/
selftrain/steps.py) against the JAX package's make_self_training_step, on
the CPU.

The JAX step runs through tests/helpers.run_b0_self_training_step (64x128,
batch 2, float32, fixed seeds); its variables, rebuilt with the same seed,
go into the port's B0 through ``flax_to_port_state_dict``, and the port's
step takes the same uint8 batch.  The port runs segformer_sl_1's settings
(AdamW 6e-6 with weight decay 0.01, Poly, BatchNorm not frozen, entropy at
1.0).  The JAX step runs them too, but with SGD at lr 1 and no weight decay,
so that its one update is minus the gradient (times 10 for the head): the
gradients are read off the JAX step's own update, from one compile.
(Optimizer parity is tests/test_torch_train_state.py's.)  The JAX step
runs under 'blocks' remat (``jax.checkpoint`` around each MiT block, which
reruns the same operations and changes no value), and one compile of it
serves two port steps: without remat, and under 'blocks' (each block rerun
by ``torch.utils.checkpoint``).

Tolerances: both run the same float32 math in other operation orders (the
port's attention backward is the JAX kernel's; XLA fuses, torch does not):
losses rtol 1e-4; gradients and the BatchNorm running statistics within
1e-3 of each tensor's largest magnitude.  A few biases have a gradient that
is zero in exact arithmetic (norm4 and the head's linear_c* biases add a
per-channel constant that the head's train-mode BatchNorm subtracts again),
so both sides hold rounding noise of about 1e-9 there: a tensor's scale is
floored at 1e-3 of the largest gradient in the model.  The 'os8' label grid
is checked against the JAX ``_labels_for_loss`` alone.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import make_b0_batch, run_b0_self_training_step
from hiast_tpu_torch.config import default_config
from hiast_tpu_torch.models.convert import flax_to_port_state_dict
from hiast_tpu_torch.models.segmentors import build_segmentor
from hiast_tpu_torch.registry import populate
from hiast_tpu_torch.selftrain.steps import StepCount, make_self_training_step
from hiast_tpu_torch.selftrain.train_state import lr_schedule, make_optimizer

SETTINGS = {
    "model.is_freeze_bn": False,
    "model.predictor.ent_loss.weight": 1.0,
    "train.optimizer": "AdamW",
    "train.lr": 6e-6,
    "train.weight_decay": 0.01,
    "train.lr_scheduler.type": "Poly",
}
BLOCKS = {"runtime.remat": True, "runtime.remat_mode": "blocks"}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    """Two threads: the suite runs several pytest-xdist workers on one host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _apply(cfg, settings=SETTINGS):
    for key, value in settings.items():
        node = cfg
        *path, leaf = key.split(".")
        for part in path:
            node = getattr(node, part)
        setattr(node, leaf, value)


def _jax_reference(batch, monkeypatch):
    """(new variables, losses, initial variables, gradients) of the JAX
    step, under 'blocks' remat (``BLOCKS``); the initial variables are the
    helper's own, caught on their way out of ``init_variables``."""
    from hiast_tpu.models import segmentors as jax_segmentors

    def mutate(cfg):
        _apply(cfg)
        _apply(cfg, BLOCKS)
        cfg.train.optimizer = "SGD"
        cfg.train.lr = 1.0
        cfg.train.weight_decay = 0.0

    caught = {}
    init_variables = jax_segmentors.BaseSegmentor.init_variables

    def catch(self, *args, **kwargs):
        caught["variables"] = init_variables(self, *args, **kwargs)
        return caught["variables"]

    monkeypatch.setattr(jax_segmentors.BaseSegmentor, "init_variables", catch)
    state, losses = run_b0_self_training_step(batch, mutate)
    to_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    init, new_params = to_np(caught["variables"]), to_np(state.params)

    def grad(path, p0, p1):
        mult = 1.0 if path[0].key == "backbone" else 10.0
        return (p0 - p1) / mult

    grads = jax.tree_util.tree_map_with_path(grad, init["params"], new_params)
    return ({"batch_stats": to_np(state.batch_stats)}, {k: float(v) for k, v in losses.items()},
            {"params": init["params"], "batch_stats": init["batch_stats"]}, grads)


def _within(got: torch.Tensor, want, name: str, floor: float = 0.0, rel: float = 1e-3):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), floor)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=rel * scale, err_msg=name)


@pytest.fixture(scope="module")
def jax_step():
    """The batch and the JAX step, run once for both tests below."""
    batch = make_b0_batch()
    with pytest.MonkeyPatch.context() as monkeypatch:
        return batch, _jax_reference(batch, monkeypatch)


def test_b0_step_matches_jax(jax_step):
    check_b0_step(jax_step)


def test_b0_blocks_step_matches_jax(jax_step):
    """The port's step with each block rerun in the backward."""
    check_b0_step(jax_step, BLOCKS)


def check_b0_step(jax_step, extra=None):
    """One B0 step of the port, with the settings ``extra`` on top of
    ``SETTINGS``, against the JAX step (the module docstring's
    tolerances)."""
    batch, (new_vars, want_losses, init_vars, jgrads) = jax_step

    populate()
    cfg = default_config()
    cfg.model.type = "SelfTrainingSegmentor"
    cfg.model.seg_model.type = "SegFormer_B0"
    _apply(cfg)
    _apply(cfg, extra or {})
    segmentor = build_segmentor(cfg)
    module = segmentor.module
    module.load_state_dict(flax_to_port_state_dict(init_vars), strict=True)
    optimizer = make_optimizer(cfg, module)
    step = make_self_training_step(segmentor, optimizer, lr_schedule(cfg), torch.float32)
    losses = step({
        "t_img": torch.from_numpy(batch["t_img"]),
        "t_plbl": torch.from_numpy(batch["t_plbl"].astype(np.uint8)),
    }, count := StepCount())
    assert count == StepCount(iterations=1, updates=1)

    assert sorted(losses) == sorted(want_losses) == ["ent_ignored_loss", "kld_confident_loss", "target_seg_loss"]
    for name, value in want_losses.items():
        np.testing.assert_allclose(float(losses[name]), value, rtol=1e-4, err_msg=name)

    want_grads = flax_to_port_state_dict({"params": jgrads})
    want_stats = flax_to_port_state_dict(new_vars)
    params = dict(module.named_parameters())
    assert sorted(params) == sorted(want_grads)
    floor = 1e-3 * max(float(g.abs().max()) for g in want_grads.values())
    for name, p in params.items():
        assert p.grad is not None, name
        _within(p.grad, want_grads[name].numpy(), f"grad {name}", floor)
    n_stats = 0
    for name, buf in module.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            _within(buf, want_stats[name].numpy(), f"buffer {name}")
            n_stats += 1
    assert n_stats == 2  # the head's BatchNorm


@pytest.mark.parametrize("hw,grid", [((64, 128), (16, 32)), ((65, 131), (17, 33))])
def test_os8_labels_match_jax(hw, grid):
    """Under loss_resolution 'os8' the labels are nearest-downsampled to the
    logits' grid as the JAX step does it."""
    from hiast_tpu.selftrain.steps import _labels_for_loss as jax_labels_for_loss
    from hiast_tpu_torch.selftrain.steps import _labels_for_loss

    class _Seg:
        def __init__(self, cfg):
            self.cfg = cfg

    lbl = np.random.default_rng(4).integers(0, 256, size=(2, *hw)).astype(np.int32)
    cfg = default_config()
    cfg.train.loss_resolution = "os8"
    got = _labels_for_loss(_Seg(cfg), torch.from_numpy(lbl).long(), torch.zeros(2, 19, *grid))

    from hiast_tpu.config import default_config as jax_default_config

    jcfg = jax_default_config()
    jcfg.train.loss_resolution = "os8"
    want = jax_labels_for_loss(_Seg(jcfg), jnp.asarray(lbl), jnp.zeros((2, *grid, 19)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
