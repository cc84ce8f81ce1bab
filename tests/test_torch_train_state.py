"""The port's optimizer and lr schedule (hiast_tpu_torch/selftrain/
train_state.py) against the JAX package's optax chain, on the CPU.

A small module named as the trunks are (``backbone.*``, a head with a
``*_bn`` BatchNorm, DeepLab's ``representation``) and its JAX parameter tree
hold the same seeded values.  Five updates with the gradient g = 0.01 + 0.1 p
run on both, for Adam, AdamW and SGD, Cosine and Poly, with and without
frozen BatchNorm.  The parameters agree to rtol 1e-6 plus atol 2e-7: both
run the same update rule at the lr of the update count before the step,
but optax forms Adam's bias correction 1 - 0.999^t in float32 (1.3e-5
relative error at t = 1, so about 6e-6 of each update, which is at most
3e-3 here) where torch forms it in float64.  Frozen parameters and the
vestigial representation stay exactly as they were.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from hiast_tpu.config import default_config as jax_default_config
from hiast_tpu.selftrain.train_state import lr_schedule as jax_lr_schedule
from hiast_tpu.selftrain.train_state import make_optimizer as jax_make_optimizer
from hiast_tpu_torch.config import default_config
from hiast_tpu_torch.selftrain.train_state import lr_schedule, make_optimizer, param_labels, set_lr

STEPS, TOTAL, LR = 5, 8, 3e-4


class _Part(nn.Module):
    def __init__(self, lin: str, bn: str, n_in: int, n_out: int):
        super().__init__()
        self.add_module(lin, nn.Linear(n_in, n_out))
        self.add_module(bn, nn.BatchNorm2d(n_out))


class Tiny(nn.Module):
    def __init__(self):
        super().__init__()
        self.backbone = _Part("conv1", "bn1", 4, 4)
        self.decode_head = _Part("linear_pred", "fuse_bn", 4, 3)
        self.representation = nn.Sequential(nn.Linear(4, 2))


def _module_and_tree(seed):
    torch.manual_seed(seed)
    m = Tiny()
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.randn(p.shape))
    sd = {k: v.numpy().copy() for k, v in m.state_dict().items()}

    def lin(prefix):
        return {"kernel": sd[f"{prefix}.weight"].T.copy(), "bias": sd[f"{prefix}.bias"]}

    def bn(prefix):
        return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}

    tree = {
        "backbone": {"conv1": lin("backbone.conv1"), "bn1": bn("backbone.bn1")},
        "decode_head": {"linear_pred": lin("decode_head.linear_pred"), "fuse_bn": bn("decode_head.fuse_bn")},
        "representation": lin("representation.0"),
    }
    return m, tree


def _tree_as_port(tree):
    def lin(node, prefix):
        return {f"{prefix}.weight": node["kernel"].T, f"{prefix}.bias": node["bias"]}

    def bn(node, prefix):
        return {f"{prefix}.weight": node["scale"], f"{prefix}.bias": node["bias"]}

    return {
        **lin(tree["backbone"]["conv1"], "backbone.conv1"), **bn(tree["backbone"]["bn1"], "backbone.bn1"),
        **lin(tree["decode_head"]["linear_pred"], "decode_head.linear_pred"),
        **bn(tree["decode_head"]["fuse_bn"], "decode_head.fuse_bn"),
        **lin(tree["representation"], "representation.0"),
    }


def _configure(cfg, opt, sched, freeze_bn):
    cfg.train.lr = LR
    cfg.train.total_iter = TOTAL
    cfg.train.optimizer = opt
    cfg.train.weight_decay = 5e-2
    cfg.train.lr_scheduler.type = sched
    cfg.model.is_freeze_bn = freeze_bn
    return cfg


@pytest.mark.parametrize("freeze_bn", [True, False])
@pytest.mark.parametrize("sched", ["Cosine", "Poly"])
@pytest.mark.parametrize("opt", ["Adam", "AdamW", "SGD"])
def test_updates_match_optax(opt, sched, freeze_bn):
    module, tree = _module_and_tree(7)
    start = {k: v.detach().clone() for k, v in module.named_parameters()}

    jcfg = _configure(jax_default_config(), opt, sched, freeze_bn)
    params = jax.tree.map(jnp.asarray, tree)
    tx = jax_make_optimizer(jcfg, params)
    state = tx.init(params)
    for _ in range(STEPS):
        grads = jax.tree.map(lambda p: 0.01 + 0.1 * p, params)
        updates, state = tx.update(grads, state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
    want = _tree_as_port(jax.tree.map(np.asarray, params))

    cfg = _configure(default_config(), opt, sched, freeze_bn)
    optimizer = make_optimizer(cfg, module)
    fn = lr_schedule(cfg)
    for t in range(STEPS):
        for p in module.parameters():
            p.grad = (0.01 + 0.1 * p.detach()) if p.requires_grad else None
        set_lr(optimizer, fn(t))
        optimizer.step()

    labels = param_labels(module, freeze_bn)
    for name, p in module.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=1e-6, atol=2e-7, err_msg=name)
        if labels[name] == "frozen":
            assert not p.requires_grad
            torch.testing.assert_close(p.detach(), start[name], rtol=0, atol=0)
        else:
            assert not torch.equal(p.detach(), start[name]), name


def test_labels_and_groups():
    module, _ = _module_and_tree(8)
    labels = param_labels(module, freeze_bn=True)
    assert labels["backbone.conv1.weight"] == "backbone"
    assert labels["decode_head.linear_pred.weight"] == "head"
    assert labels["backbone.bn1.weight"] == labels["decode_head.fuse_bn.bias"] == "frozen"
    assert labels["representation.0.weight"] == "frozen"
    assert param_labels(module, freeze_bn=False)["backbone.bn1.weight"] == "backbone"
    cfg = _configure(default_config(), "AdamW", "Poly", True)
    optimizer = make_optimizer(cfg, module)
    assert [g["lr_mult"] for g in optimizer.param_groups] == [1.0, 10.0]
    set_lr(optimizer, 2e-6)
    assert [g["lr"] for g in optimizer.param_groups] == pytest.approx([2e-6, 2e-5], rel=1e-12)
    with pytest.raises(ValueError):
        make_optimizer(_configure(default_config(), "RMSprop", "Poly", True), Tiny())


@pytest.mark.parametrize("sched", ["Cosine", "Poly"])
def test_schedule_matches_jax(sched):
    cfg = _configure(default_config(), "AdamW", sched, False)
    jcfg = _configure(jax_default_config(), "AdamW", sched, False)
    fn, jfn = lr_schedule(cfg), jax_lr_schedule(jcfg)
    for t in range(TOTAL + 1):
        np.testing.assert_allclose(fn(t), float(jfn(t)), rtol=1e-6, atol=1e-12)
    cfg.train.lr_scheduler.type = "Step"
    with pytest.raises(ValueError):
        lr_schedule(cfg)
