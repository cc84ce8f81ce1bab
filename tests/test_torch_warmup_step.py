"""The port's warmup steps (hiast_tpu_torch/selftrain/steps.py:
make_source_only_step, make_adversarial_step), the discriminator, its
optimizer and schedule, and the entropy losses against the JAX package's,
on the CPU.

DeepLab-v2 with layers (1, 1, 1, 1), 64x128, batch 2, float32, the JAX
variables (trunk and ``FCDiscriminator``) carried into the port through
``flax_to_port_state_dict`` and ``flax_to_discriminator_state_dict``.

Tolerances:
- ``FCDiscriminator`` forward, ``prob_to_entropy``, ``mean_entropy`` and
  ``lr_schedule_for_d``: float32 math in other orders, rtol 1e-5 (the
  forward within 1e-5 of its largest magnitude).
- Losses at step 0: rtol 1e-5 (and 1e-10 absolute, for an adversarial
  loss of a few 1e-6).
- The generator's gradients, read off one SGD update at lr 1 as in
  tests/test_torch_consistency_step.py: the head's within 1e-3 of each
  tensor's largest magnitude, the backbone's by cosine (at least 0.9995),
  because JAX's train-mode BatchNorm gradient loses digits in float32
  (ROADMAP C6): on the source-only step JAX's backbone gradients lie at a
  cosine of 0.99982 from the float64 gradient, the port's at 0.99997
  (measured; the precondition test holds the port's at 0.99995).  The
  BatchNorm running statistics after the source and the target forwards
  within 1e-3 of each tensor's largest magnitude.
- The discriminator's parameters, in units of the D lr (5e-4).  Adam's
  first step moves each entry by lr * g / (|g| + eps): +-lr wherever |g|
  is far above eps, whatever g's rounding, but an entry whose gradient is
  a near-cancelled sum may flip sign between the two packages and land 2
  lr away.  After one step each tensor's mean |diff| is within 1e-3 lr and
  at most 1% of its entries lie more than 1e-3 lr off (measured: 2.6e-4
  lr and 0.21%).  After five steps (the generator on Adam at 1e-4, the
  settings of tests/test_train_parity.py's adversarial test) each
  tensor's mean |diff| is within 0.05 lr and its max within 6 lr
  (measured: 0.0136 and 4.23).  The reference's own JAX-vs-torch test
  (ROADMAP C1) measures a mean of 0.26-0.27 lr on the D biases against its
  torch harness (which adds weight decay), above the 1e-4 (0.2 lr) it
  asks.  The five steps' losses: rtol 1e-2 after step 0 (measured 4e-3 at
  most, on an adversarial loss of 1e-3).
- The non-finite guard: a NaN source image leaves the trunk, the
  discriminator, both optimizers' moments and the BatchNorm buffers
  bit-identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hiast_tpu.config import default_config as jax_default_config
from hiast_tpu.models.segmentors import build_segmentor as jax_build_segmentor
from hiast_tpu.ops import losses as jax_losses
from hiast_tpu.registry import populate as jax_populate
from hiast_tpu.selftrain.steps import make_adversarial_step as jax_make_adversarial_step
from hiast_tpu.selftrain.steps import make_source_only_step as jax_make_source_only_step
from hiast_tpu.selftrain.train_state import TrainState
from hiast_tpu.selftrain.train_state import lr_schedule_for_d as jax_lr_schedule_for_d
from hiast_tpu.selftrain.train_state import make_d_optimizer as jax_make_d_optimizer
from hiast_tpu.selftrain.train_state import make_optimizer as jax_make_optimizer
from hiast_tpu_torch.config import default_config
from hiast_tpu_torch.models.convert import flax_to_discriminator_state_dict, flax_to_port_state_dict
from hiast_tpu_torch.models.deeplab_v2 import FCDiscriminator
from hiast_tpu_torch.models.segmentors import build_segmentor
from hiast_tpu_torch.ops import losses as L
from hiast_tpu_torch.registry import populate
from hiast_tpu_torch.selftrain.steps import StepCount, make_adversarial_step, make_source_only_step
from hiast_tpu_torch.selftrain.train_state import lr_schedule, lr_schedule_for_d, make_d_optimizer, make_optimizer

LAYERS = (1, 1, 1, 1)
B, H, W = 2, 64, 128
INIT_KEY = 1  # a float32-well-conditioned gradient (tests/test_torch_consistency_step.py)
D_LR = 5e-4


@pytest.fixture(scope="module", autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _settings(**extra):
    settings = {
        "model.type": "AdversarialWarmupSegmentor",
        "model.is_freeze_bn": False,
        "model.seg_model.backbone_layers": list(LAYERS),
        "model.predictor.ent_loss.weight": 1.0,  # MinEnt on the target
        "model.discriminator.is_enabled": True,
        "model.discriminator.lr": D_LR,
        "model.discriminator.D_loss.type": "MSE",
        "model.discriminator.D_loss.adv_weight": 0.05,
        "train.optimizer": "SGD",
        "train.lr": 1.0,
        "train.weight_decay": 0.0,
        "train.total_iter": 50,
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
    lbl[rng.random((B, H, W)) < 0.2] = 255
    return {
        "s_img": rng.integers(0, 256, size=(B, H, W, 3)).astype(np.uint8),
        "t_img": rng.integers(0, 256, size=(B, H, W, 3)).astype(np.uint8),
        "s_lbl": lbl.astype(np.uint8),
    }


def _to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax_segmentor(settings):
    jax_populate()
    cfg = _configure(jax_default_config(), settings)
    return cfg, jax_build_segmentor(cfg, dtype=jnp.float32, backbone_layers=LAYERS)


def _jax_run(settings, batches, adversarial=True):
    """(initial variables, initial D variables, [(state, losses) after each step])."""
    cfg, segmentor = _jax_segmentor(settings)
    variables = segmentor.init_variables(jax.random.PRNGKey(INIT_KEY), (1, H, W, 3))
    tx = jax_make_optimizer(cfg, variables["params"])
    kwargs = {}
    d_vars = None
    if adversarial:
        d_vars = segmentor.init_d_variables(jax.random.PRNGKey(7), (1, H, W, None))
        d_tx = jax_make_d_optimizer(cfg)
        kwargs = {"d_params": d_vars, "d_opt_state": d_tx.init(d_vars)}
        step = jax.jit(jax_make_adversarial_step(segmentor, tx, d_tx))
    else:
        step = jax.jit(jax_make_source_only_step(segmentor, tx))
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"], opt_state=tx.init(variables["params"]), **kwargs)
    out = []
    for batch in batches:
        state, losses = step(state, batch, jax.random.PRNGKey(0))
        out.append((jax.tree.map(np.asarray, state), {k: float(v) for k, v in losses.items()}))
    init = jax.tree.map(np.asarray, {"params": variables["params"], "batch_stats": variables["batch_stats"]})
    return init, (jax.tree.map(np.asarray, d_vars) if d_vars is not None else None), out


def _port(settings, init, d_init=None):
    """(segmentor, G optimizer, D optimizer or None, step) of the port from
    the JAX variables."""
    populate()
    cfg = _configure(default_config(), settings)
    segmentor = build_segmentor(cfg)
    segmentor.module.load_state_dict(flax_to_port_state_dict(init), strict=True)
    optimizer = make_optimizer(cfg, segmentor.module)
    if d_init is None:
        return segmentor, optimizer, None, make_source_only_step(segmentor, optimizer, lr_schedule(cfg), torch.float32)
    segmentor.discriminator.load_state_dict(flax_to_discriminator_state_dict(d_init), strict=True)
    d_optimizer = make_d_optimizer(cfg, segmentor.discriminator)
    step = make_adversarial_step(segmentor, optimizer, lr_schedule(cfg), d_optimizer, lr_schedule_for_d(cfg),
                                 torch.float32)
    return segmentor, optimizer, d_optimizer, step


def _within(got: torch.Tensor, want, name: str, rel: float = 1e-3):
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=rel * scale, err_msg=name)


def _check_losses(got, want):
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        np.testing.assert_allclose(float(got[name]), value, rtol=1e-5, atol=1e-10, err_msg=name)


def _check_g_gradients(module, init, state):
    """The port's gradients (``p.grad`` after the step) against those read
    off JAX's SGD update at lr 1 (10x for the head)."""

    def grad(path, p0, p1):
        return (p0 - p1) / (1.0 if path[0].key == "backbone" else 10.0)

    jgrads = flax_to_port_state_dict({"params": jax.tree_util.tree_map_with_path(grad, init["params"], state.params)})
    n_backbone = n_head = 0
    for name, p in module.named_parameters():
        if not p.requires_grad:  # the vestigial representation head
            assert p.grad is None and float(jgrads[name].abs().max()) == 0.0, name
        elif name.startswith("backbone."):
            cos = torch.nn.functional.cosine_similarity(p.grad.double().flatten(),
                                                        jgrads[name].double().flatten(), dim=0)
            assert float(cos) >= 0.9995, f"grad {name}: cosine {float(cos)}"
            n_backbone += 1
        else:
            _within(p.grad, jgrads[name].numpy(), f"grad {name}")
            n_head += 1
    assert n_backbone > 0 and n_head > 0
    want_stats = flax_to_port_state_dict({"params": state.params, "batch_stats": state.batch_stats})
    n_stats = 0
    for name, buf in module.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            _within(buf, want_stats[name].numpy(), f"buffer {name}")
            n_stats += 1
    assert n_stats > 0


# -- modules -------------------------------------------------------------------


def test_discriminator_forward_matches_flax():
    from hiast_tpu.models.deeplab_v2 import FCDiscriminator as JaxFCDiscriminator

    rng = np.random.default_rng(0)
    x = rng.random((2, 64, 96, 19), dtype=np.float32)
    disc = JaxFCDiscriminator(dtype=jnp.float32)
    variables = disc.init(jax.random.PRNGKey(3), jnp.zeros((1, 64, 96, 19)))
    want = np.asarray(disc.apply(variables, jnp.asarray(x))).transpose(0, 3, 1, 2)
    port = FCDiscriminator(19)
    port.load_state_dict(flax_to_discriminator_state_dict(jax.tree.map(np.asarray, variables)), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    assert got.shape == (2, 1, 2, 3)
    _within(got, want, "FCDiscriminator", rel=1e-5)
    # the reference's parameter names, and a seeded initialisation
    assert [n for n, _ in port.named_parameters()] == [
        f"{layer}.{leaf}" for layer in ("conv1", "conv2", "conv3", "conv4", "classifier") for leaf in ("weight", "bias")]
    a, b = FCDiscriminator(19), FCDiscriminator(19)
    a.init_weights(torch.Generator().manual_seed(7))
    b.init_weights(torch.Generator().manual_seed(7))
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))


def test_entropy_losses_match_jax():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((2, 19, 8, 12)).astype(np.float32) * 3
    prob = torch.softmax(torch.from_numpy(logits), dim=1)
    jprob = jnp.asarray(prob.numpy().transpose(0, 2, 3, 1))
    np.testing.assert_allclose(L.prob_to_entropy(prob).numpy().transpose(0, 2, 3, 1),
                               np.asarray(jax_losses.prob_to_entropy(jprob)), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(L.mean_entropy(prob)), float(jax_losses.mean_entropy(jprob)), rtol=1e-5)


@pytest.mark.parametrize("kind", ["Cosine", "Poly"])
def test_d_schedule_matches_jax(kind):
    settings = _settings(**{"train.lr": 2.5e-4, "train.lr_scheduler.type": kind, "train.total_iter": 40})
    jcfg = _configure(jax_default_config(), settings)
    cfg = _configure(default_config(), settings)
    want, got = jax_lr_schedule_for_d(jcfg), lr_schedule_for_d(cfg)
    for t in (0, 20, 39):
        np.testing.assert_allclose(got(t), float(want(t)), rtol=1e-5, err_msg=f"{kind} t={t}")
    assert got(0) == pytest.approx(D_LR)
    if kind == "Cosine":  # the floor is the generator's lr * 1e-3
        assert got(40) == pytest.approx(2.5e-7)
    else:
        assert got(40) == 0.0


# -- steps ---------------------------------------------------------------------


def test_float32_gradient_is_well_conditioned(monkeypatch):
    """The precondition of the gradient comparisons: the port's float32
    backbone gradients of the source-only step at a cosine of at least
    0.99995 from the same step in float64 (trunk, image and losses)."""
    from hiast_tpu_torch.selftrain import steps as S

    settings = _settings(**{"model.type": "SourceOnlySegmentor", "model.discriminator.is_enabled": False})
    init, _, _ = _jax_run(settings, [], adversarial=False)
    grads = {}
    for dtype in (torch.float32, torch.float64):
        normalize = S.normalize_image
        with monkeypatch.context() as m:
            if dtype == torch.float64:
                m.setattr(S, "normalize_image", lambda x: normalize(x).double())
                m.setattr(L, "_log_softmax", lambda logits: torch.log_softmax(logits.double(), dim=1))
            segmentor, _, _, step = _port(settings, init)
            segmentor.module.to(dtype)
            step(_to_torch(_batch()), StepCount())
        grads[dtype] = {n: p.grad.double() for n, p in segmentor.module.named_parameters() if p.grad is not None}
    for name, want in grads[torch.float64].items():
        cos = torch.nn.functional.cosine_similarity(grads[torch.float32][name].flatten(), want.flatten(), dim=0)
        assert float(cos) >= 0.99995, f"{name}: float32 at cosine {float(cos)} from float64"


def test_source_only_step_matches_jax():
    settings = _settings(**{"model.type": "SourceOnlySegmentor", "model.discriminator.is_enabled": False})
    batch = _batch()
    init, _, [(state, want_losses)] = _jax_run(settings, [batch], adversarial=False)
    segmentor, _, _, step = _port(settings, init)
    count = StepCount()
    losses = step(_to_torch(batch), count)
    assert count == StepCount(iterations=1, updates=1)
    _check_losses(losses, want_losses)
    assert sorted(losses) == ["seg_loss"]
    _check_g_gradients(segmentor.module, init, state)


@pytest.mark.parametrize("d_loss,entropy_input", [("MSE", False), ("BCEWithLogits", True)])
def test_adversarial_step_matches_jax(d_loss, entropy_input):
    settings = _settings(**{"model.discriminator.D_loss.type": d_loss,
                            "model.discriminator.is_entropy_input": entropy_input})
    batch = _batch()
    init, d_init, [(state, want_losses)] = _jax_run(settings, [batch])
    segmentor, _, d_optimizer, step = _port(settings, init, d_init)
    count = StepCount()
    losses = step(_to_torch(batch), count)
    assert count == StepCount(iterations=1, updates=1)
    assert sorted(losses) == ["D_loss", "adv_loss", "source_seg_loss", "target_ent_loss"]
    _check_losses(losses, want_losses)
    _check_g_gradients(segmentor.module, init, state)
    # the discriminator after one Adam step; its gradient is the D loss's only
    want_d = flax_to_discriminator_state_dict(state.d_params)
    d0 = flax_to_discriminator_state_dict(d_init)
    for name, p in segmentor.discriminator.named_parameters():
        diff = (p.detach() - want_d[name]).abs() / D_LR
        assert float(diff.mean()) <= 1e-3, f"{name}: mean {float(diff.mean()):.3g} lr off JAX"
        assert float((diff > 1e-3).float().mean()) <= 0.01, f"{name}: {int((diff > 1e-3).sum())} entries off"
        assert float((p.detach() - d0[name]).abs().max()) > 0.5 * D_LR, f"{name} did not move"
    assert d_optimizer.state_dict()["state"][0]["step"] == 1


def test_generator_backward_leaves_no_gradient_in_the_discriminator():
    """The adversarial loss alone reaches the discriminator's update only
    through its own backward: with the D loss weight 0 the discriminator
    takes no gradient, and Adam leaves it where it was."""
    settings = _settings(**{"model.discriminator.D_loss.weight": 0.0})
    init, d_init, _ = _jax_run(settings, [])
    segmentor, _, _, step = _port(settings, init, d_init)
    d0 = {k: v.clone() for k, v in segmentor.discriminator.state_dict().items()}
    losses = step(_to_torch(_batch()), StepCount())
    assert float(losses["adv_loss"]) > 0 and float(losses["D_loss"]) == 0.0
    for name, p in segmentor.discriminator.named_parameters():
        assert p.requires_grad and not bool(p.grad.any()), name
        assert torch.equal(p.detach(), d0[name]), name


def test_five_adversarial_steps_track_jax():
    settings = _settings(**{"train.optimizer": "Adam", "train.lr": 1e-4, "model.is_freeze_bn": True})
    batches = [_batch(17 + i) for i in range(5)]
    init, d_init, trajectory = _jax_run(settings, batches)
    segmentor, _, _, step = _port(settings, init, d_init)
    count = StepCount()
    for i, batch in enumerate(batches):
        losses = step(_to_torch(batch), count)
        for name, value in trajectory[i][1].items():
            np.testing.assert_allclose(float(losses[name]), value, rtol=1e-5 if i == 0 else 1e-2,
                                       atol=1e-10, err_msg=f"step {i} {name}")
    assert count == StepCount(iterations=5, updates=5)
    want_d = flax_to_discriminator_state_dict(trajectory[-1][0].d_params)
    for name, p in segmentor.discriminator.named_parameters():
        diff = (p.detach() - want_d[name]).abs()
        assert float(diff.max()) <= 6 * D_LR, f"{name}: max {float(diff.max()) / D_LR:.3g} lr"
        assert float(diff.mean()) <= 0.05 * D_LR, f"{name}: mean {float(diff.mean()) / D_LR:.3g} lr"


def test_nonfinite_step_skips_both_models():
    settings = _settings(**{"runtime.skip_nonfinite_updates": True, "train.lr": 1e-2})
    batch = _batch(6)
    init, d_init, _ = _jax_run(settings, [])
    segmentor, optimizer, d_optimizer, step = _port(settings, init, d_init)
    module, disc = segmentor.module, segmentor.discriminator
    count = StepCount()
    step(_to_torch(batch), count)  # a finite step: both optimizers hold moments
    before = [{k: v.clone() for k, v in m.state_dict().items()} for m in (module, disc)]
    d_moments = {k: {n: t.clone() for n, t in v.items()} for k, v in d_optimizer.state_dict()["state"].items()}
    g_moments = {k: v["momentum_buffer"].clone() for k, v in optimizer.state_dict()["state"].items()}
    poisoned = _to_torch(batch)
    s_img = poisoned["s_img"].float()
    s_img[0, 5, 7, 1] = float("nan")
    poisoned["s_img"] = s_img
    losses = step(poisoned, count)
    assert not all(bool(torch.isfinite(v)) for v in losses.values())
    assert count == StepCount(iterations=2, updates=1)
    for m, want in zip((module, disc), before):
        for k, v in m.state_dict().items():
            assert torch.equal(v, want[k]), k
    for k, v in d_optimizer.state_dict()["state"].items():
        for n, t in v.items():
            assert torch.equal(t, d_moments[k][n]), (k, n)
    for k, v in optimizer.state_dict()["state"].items():
        assert torch.equal(v["momentum_buffer"], g_moments[k])
    step(_to_torch(batch), count)  # a finite step applies again
    assert count == StepCount(iterations=3, updates=2)
    assert not torch.equal(disc.conv1.weight, before[1]["conv1.weight"])
