"""The port's mutual-learning step with ``mut_training.is_strong_input``
against the JAX package's, on the CPU, at tests/test_torch_mutual.py's
set-up and tolerances: each student trains on its own CCA view.  JAX's two
views (``batched_color_aug`` at the split keys of the step's key, in bf16)
reach the port through its ``apply_color_aug``, A's first, so the port's
API stays JAX's.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hiast_tpu.ops.color_aug import batched_color_aug
from hiast_tpu_torch.selftrain import steps as S
from hiast_tpu_torch.selftrain.steps import StepCount
from test_torch_consistency_step import _batch, _to_torch
from test_torch_mutual import _check_step, _jax_step, _mutual_settings, _port_step, variables  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def test_strong_input_step_matches_jax(variables, monkeypatch):
    settings = _mutual_settings(strong=True)
    batch = _batch()
    inits, state0, jax_step = _jax_step(settings, variables, strong=True)
    state1, want_losses = jax_step(state0, batch, jax.random.PRNGKey(1))
    aug = jax.jit(functools.partial(batched_color_aug, kind="CCA", dtype=jnp.bfloat16))
    views = [torch.from_numpy(np.array(aug(jnp.asarray(batch["t_img"]), key).astype(jnp.float32))).bfloat16()
             for key in jax.random.split(jax.random.PRNGKey(1))]
    assert not torch.equal(views[0], views[1])
    calls = []

    def injected(imgs, draws, dtype):
        assert draws.kind == "CCA" and dtype == torch.bfloat16
        calls.append(imgs)
        return views[len(calls) - 1]

    monkeypatch.setattr(S, "apply_color_aug", injected)
    modules, _, step = _port_step(settings, inits, strong=True)
    losses = step(_to_torch(batch), StepCount())
    assert len(calls) == 2
    _check_step(losses, want_losses, modules, inits, state1)
