"""The port's HIAST consistency step (hiast_tpu_torch/selftrain/steps.py:
make_consistency_step) against the JAX package's, on the CPU.

DeepLab-v2 with layers (1, 1, 1, 1), 64x128, batch 2, float32, sl_1's
frozen BatchNorm affine, SoftCE at 0.5 on the ignored region, with the
JAX variables carried into the port through ``flax_to_port_state_dict``
and the strong view injected (``strong_aug=None``, ``t_img_strong``):
torch cannot draw ``jax.random``'s colour-aug numbers
(tests/test_torch_color_aug.py holds the strong view itself).  Both steps
run SGD at lr 1 without weight decay, so the JAX update is minus the
gradient (times 10 for the head) and the gradients are read off it, as in
tests/test_torch_train_step.py.

Tolerances: the same float32 math in other operation orders: losses rtol
1e-4; the head's (ASPP) gradients and the BatchNorm running statistics
within 1e-3 of each tensor's largest magnitude.  Also a NaN step under
``runtime.skip_nonfinite_updates``.  ``ema_model.iter_update`` 2 over two
steps (the EMA against JAX's, within 1e-3 of each tensor's largest
magnitude) and the hard ('CE') teacher are in
tests/test_torch_consistency_ema.py, on this file's helpers.

The backbone's gradients are held by direction: cosine similarity with
JAX's at least 0.9999 per tensor (measured: at least 0.99993 for the JAX
variables of PRNGKeys 0, 1 and 2).  A 1e-3 bound on their entries cannot
hold, for two measured reasons.  JAX's train-mode BatchNorm
(``hiast_tpu/models/norm.py``) takes the variance as E[x^2] - E[x]^2 in
float32, and its gradient loses digits to that cancellation (5e-4 of the
gradient's scale for one BatchNorm whose input has mean 30 and unit
spread; torch's BatchNorm 2e-7); through DeepLab's BatchNorms that grows to
1-12% of a backbone tensor's scale against the float64 gradient.  And at
this size the gradient is ill-conditioned in float32 for some weights
(with the JAX variables of PRNGKeys 0 and 2 even the port's float32
gradient is 2-4% off its float64 one).  The test takes PRNGKey 1, and
first checks the port's float32 gradients within 1e-4 of their float64
values (trunks, image and losses in float64).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hiast_tpu.config import default_config as jax_default_config
from hiast_tpu.models.segmentors import build_segmentor as jax_build_segmentor
from hiast_tpu.registry import populate as jax_populate
from hiast_tpu.selftrain.steps import make_consistency_step as jax_make_consistency_step
from hiast_tpu.selftrain.train_state import TrainState
from hiast_tpu.selftrain.train_state import make_optimizer as jax_make_optimizer
from hiast_tpu_torch.config import default_config
from hiast_tpu_torch.models.convert import flax_to_port_state_dict
from hiast_tpu_torch.models.segmentors import build_segmentor
from hiast_tpu_torch.registry import populate
from hiast_tpu_torch.selftrain.steps import StepCount, make_consistency_step
from hiast_tpu_torch.selftrain.train_state import lr_schedule, make_optimizer

LAYERS = (1, 1, 1, 1)
B, H, W = 2, 64, 128
INIT_KEY = 1  # a float32-well-conditioned gradient (module docstring; checked below)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _settings(**extra):
    settings = {
        "model.type": "SelfTrainingSegmentor",
        "model.is_freeze_bn": True,
        "model.predictor.ent_loss.weight": 1.0,
        "model.seg_model.backbone_layers": list(LAYERS),
        "cst_training.is_enabled": True,
        "cst_training.cst_loss.type": "SoftCE",
        "cst_training.cst_loss.weight": 0.5,
        "cst_training.cst_loss.region": "ignored",
        "cst_training.ema_model.gamma": 0.5,
        "train.optimizer": "SGD",
        "train.lr": 1.0,
        "train.weight_decay": 0.0,
        "train.lr_scheduler.type": "Cosine",
    }
    settings.update(extra)
    return settings


def _configure(cfg, settings):
    for key, value in settings.items():
        node = cfg
        *path, leaf = key.split(".")
        for part in path:
            node = getattr(node, part)
        setattr(node, leaf, value)
    return cfg


def _batch(seed=3):
    rng = np.random.default_rng(seed)
    lbl = rng.integers(0, 19, size=(B, H, W))
    lbl[rng.random((B, H, W)) < 0.4] = 255  # an ignored region for the consistency loss
    return {
        "t_img": rng.integers(0, 256, size=(B, H, W, 3)).astype(np.uint8),
        "t_img_strong": rng.integers(0, 256, size=(B, H, W, 3)).astype(np.uint8),
        "t_plbl": lbl.astype(np.int32),
    }


def _jax_run(settings, batches, init_key=INIT_KEY):
    """(initial variables, [(state, losses) after each step]) of the JAX step."""
    jax_populate()
    cfg = _configure(jax_default_config(), settings)
    segmentor = jax_build_segmentor(cfg, dtype=jnp.float32, backbone_layers=LAYERS)
    variables = segmentor.init_variables(jax.random.PRNGKey(init_key), (1, H, W, 3))
    tx = jax_make_optimizer(cfg, variables["params"])
    state = TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"], batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]), ema_params=jax.tree.map(jnp.copy, variables["params"]),
    )
    step = jax.jit(jax_make_consistency_step(segmentor, tx, strong_aug=None))
    out = []
    for batch in batches:
        state, losses = step(state, batch, jax.random.PRNGKey(1))
        out.append((jax.tree.map(np.asarray, state), {k: float(v) for k, v in losses.items()}))
    init = jax.tree.map(np.asarray, {"params": variables["params"], "batch_stats": variables["batch_stats"]})
    return init, out


def _port(settings, init, dtype=torch.float32):
    """(segmentor, EMA module, optimizer, step) of the port from the JAX
    variables; ``dtype`` float64 runs the trunks in float64."""
    populate()
    cfg = _configure(default_config(), settings)
    segmentor = build_segmentor(cfg)
    segmentor.module.load_state_dict(flax_to_port_state_dict(init), strict=True)
    ema = build_segmentor(cfg).module
    ema.load_state_dict(segmentor.module.state_dict())
    ema.requires_grad_(False)
    segmentor.module.to(dtype)
    ema.to(dtype)
    optimizer = make_optimizer(cfg, segmentor.module)
    step = make_consistency_step(segmentor, ema, optimizer, lr_schedule(cfg), torch.float32, strong_aug=None)
    return segmentor, ema, optimizer, step


def test_float32_gradient_is_well_conditioned(monkeypatch):
    """The precondition of the gradient comparison: the port's float32
    gradients within 1e-4 (of each tensor's scale) of the same step in
    float64 (trunks, image and losses)."""
    from hiast_tpu_torch.ops import losses as L
    from hiast_tpu_torch.selftrain import steps as S

    settings = _settings()
    init, _ = _jax_run(settings, [])
    grads = {}
    for dtype in (torch.float32, torch.float64):
        normalize = S.normalize_image
        with monkeypatch.context() as m:
            if dtype == torch.float64:
                m.setattr(S, "normalize_image", lambda x: normalize(x).double())
                m.setattr(L, "_log_softmax", lambda logits: torch.log_softmax(logits.double(), dim=1))
            segmentor, _, _, step = _port(settings, init, dtype)
            step(_to_torch(_batch()), StepCount())
        grads[dtype] = {n: p.grad.double() for n, p in segmentor.module.named_parameters() if p.grad is not None}
    floor = 1e-3 * max(float(g.abs().max()) for g in grads[torch.float64].values())
    for name, want in grads[torch.float64].items():
        scale = max(float(want.abs().max()), floor)
        err = float((grads[torch.float32][name] - want).abs().max())
        assert err <= 1e-4 * scale, f"{name}: float32 off float64 by {err / scale:.3g} of its scale"


def _to_torch(batch):
    out = {
        "t_img": torch.from_numpy(batch["t_img"]),
        "t_img_strong": torch.from_numpy(batch["t_img_strong"]),
        "t_plbl": torch.from_numpy(batch["t_plbl"].astype(np.uint8)),
    }
    if "copy_paste_mask" in batch:
        out["copy_paste_mask"] = torch.from_numpy(batch["copy_paste_mask"].astype(np.uint8))
    return out


def _within(got: torch.Tensor, want, name: str, floor: float = 0.0, rel: float = 1e-3):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), floor)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=rel * scale, err_msg=name)


def _check_losses(got, want):
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        np.testing.assert_allclose(float(got[name]), value, rtol=1e-4, err_msg=name)


def test_one_step_matches_jax():
    check_one_step(_settings())


def check_one_step(settings, init_key=INIT_KEY, by_cosine=("backbone.",), batch=None):
    """One consistency step of the port against JAX's from the same
    variables: the losses, every gradient, the BatchNorm statistics and
    the EMA (the module docstring's tolerances).  The gradients of the
    parameters named with a prefix in ``by_cosine`` are held by cosine.
    ``batch`` defaults to ``_batch()``; one with a ``copy_paste_mask``
    adds ``dcst_loss`` to the losses."""
    batch = _batch() if batch is None else batch
    init, [(state, want_losses)] = _jax_run(settings, [batch], init_key)
    segmentor, ema, _, step = _port(settings, init)
    count = StepCount()
    losses = step(_to_torch(batch), count)
    assert count == StepCount(iterations=1, updates=1)
    names = ["cst_loss", "ent_ignored_loss", "kld_confident_loss", "target_seg_loss"]
    assert sorted(losses) == sorted(names + ["dcst_loss"] * ("copy_paste_mask" in batch))
    _check_losses(losses, want_losses)

    check_update(segmentor.module, init["params"], state.params, state.batch_stats, by_cosine)
    params = dict(segmentor.module.named_parameters())
    # the EMA (gamma 0.5) sits half-way between the initial and the updated
    # parameters, in both packages (held against JAX's EMA in the two-step
    # test, at an lr where the backbone's gradient differences stay small)
    p0 = flax_to_port_state_dict(init)
    jax_p1 = flax_to_port_state_dict({"params": state.params})
    want_ema = flax_to_port_state_dict({"params": state.ema_params})
    for name, p in ema.named_parameters():
        torch.testing.assert_close(p, 0.5 * (params[name].detach() + p0[name]))
        torch.testing.assert_close(want_ema[name], 0.5 * (jax_p1[name] + p0[name]))


def check_update(module, init_params, new_params, new_batch_stats, by_cosine=("backbone.",)):
    """``module``'s gradients and BatchNorm running statistics after one
    step against a JAX SGD step at lr 1 from ``init_params`` to
    ``new_params`` and ``new_batch_stats`` (the update is minus the
    gradient, times 10 for the head), at the module docstring's
    tolerances; the gradients of the parameters named with a prefix in
    ``by_cosine`` are held by cosine."""

    def grad(path, p0, p1):
        return (p0 - p1) / (1.0 if path[0].key == "backbone" else 10.0)

    jgrads = flax_to_port_state_dict({"params": jax.tree_util.tree_map_with_path(grad, init_params, new_params)})
    n_frozen = n_cosine = 0
    for name, p in module.named_parameters():
        if not p.requires_grad:  # frozen BatchNorm affine: no update on either side
            assert p.grad is None and float(jgrads[name].abs().max()) == 0.0, name
            n_frozen += 1
        elif name.startswith(by_cosine):
            cos = torch.nn.functional.cosine_similarity(p.grad.double().flatten(), jgrads[name].double().flatten(), dim=0)
            assert float(cos) >= 0.9999, f"grad {name}: cosine {float(cos)}"
            n_cosine += 1
        else:
            _within(p.grad, jgrads[name].numpy(), f"grad {name}")
    assert n_frozen > 0 and n_cosine > 0

    want_stats = flax_to_port_state_dict({"params": new_params, "batch_stats": new_batch_stats})
    n_stats = 0
    for name, buf in module.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            _within(buf, want_stats[name].numpy(), f"buffer {name}")
            n_stats += 1
    assert n_stats > 0


def test_nonfinite_step_is_skipped():
    """A NaN in the strong view poisons the student's loss, gradients and
    batch statistics: under runtime.skip_nonfinite_updates the parameters,
    the optimizer's state and the BatchNorm buffers keep their values, the
    EMA still moves (toward the unchanged parameters), and the lr count
    lags the step count, as in the JAX ``_guard_nonfinite``."""
    settings = _settings(**{"runtime.skip_nonfinite_updates": True, "train.lr": 1e-2, "train.total_iter": 10})
    batch = _batch(6)
    init, _ = _jax_run(settings, [])
    segmentor, ema, optimizer, step = _port(settings, init)
    module = segmentor.module
    count = StepCount()
    step(_to_torch(batch), count)  # a finite step: the EMA now lags the student
    assert count == StepCount(iterations=1, updates=1)
    params = {k: v.detach().clone() for k, v in module.named_parameters()}
    buffers = {k: v.clone() for k, v in module.named_buffers()}
    ema1 = {k: v.clone() for k, v in ema.named_parameters()}
    momentum = {k: v["momentum_buffer"].clone() for k, v in optimizer.state_dict()["state"].items()}
    poisoned = _to_torch(batch)
    strong = poisoned["t_img_strong"].float()
    strong[0, 5, 7, 1] = float("nan")
    poisoned["t_img_strong"] = strong
    losses = step(poisoned, count)
    assert not all(bool(torch.isfinite(v)) for v in losses.values())
    assert count == StepCount(iterations=2, updates=1)  # the next update takes the lr of count 1
    for name, p in module.named_parameters():
        assert torch.equal(p, params[name]), name
    for name, b in module.named_buffers():
        assert torch.equal(b, buffers[name]), name
    for k, v in optimizer.state_dict()["state"].items():
        assert torch.equal(v["momentum_buffer"], momentum[k])
    moved = 0
    for name, p in ema.named_parameters():
        torch.testing.assert_close(p, 0.5 * (ema1[name] + params[name]))
        moved += not torch.equal(p, ema1[name])
    assert moved > 0
    step(_to_torch(batch), count)  # a finite step applies again
    assert count == StepCount(iterations=3, updates=2)
    assert not torch.equal(module.state_dict()["backbone.conv1.weight"], params["backbone.conv1.weight"])
