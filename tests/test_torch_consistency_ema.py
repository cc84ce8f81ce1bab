"""The EMA teacher of the port's HIAST consistency step against the JAX
package's, on the CPU, on tests/test_torch_consistency_step.py's set-up
(DeepLab-v2 with layers (1, 1, 1, 1), 64x128, batch 2, float32, the strong
view injected; the tolerances are that file's): ``ema_model.iter_update``
2 over two SGD steps at lr 1e-3 (no move at step 1, then the EMA within
1e-3 of each tensor's largest magnitude of JAX's), and the hard ('CE')
teacher's losses (rtol 1e-4).
"""
import pytest
import torch

from hiast_tpu_torch.models.convert import flax_to_port_state_dict
from hiast_tpu_torch.selftrain.steps import StepCount
from test_torch_consistency_step import _batch, _check_losses, _jax_run, _port, _settings, _to_torch, _within


@pytest.fixture(scope="module", autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def test_ema_iter_update_2_over_two_steps_matches_jax():
    settings = _settings(**{"cst_training.ema_model.iter_update": 2, "train.lr": 1e-3})
    batches = [_batch(3), _batch(4)]
    init, jax_out = _jax_run(settings, batches)
    segmentor, ema, _, step = _port(settings, init)
    ema0 = {k: v.clone() for k, v in ema.named_parameters()}
    count = StepCount()
    for batch, (state, want_losses) in zip(batches, jax_out):
        losses = step(_to_torch(batch), count)
        _check_losses(losses, want_losses)
        if count.iterations == 1:  # no EMA move at step 1
            for name, p in ema.named_parameters():
                assert torch.equal(p, ema0[name]), name
            jax_ema1 = flax_to_port_state_dict({"params": state.ema_params})
            for name, p in ema0.items():
                assert torch.equal(jax_ema1[name], p), name
    want_ema = flax_to_port_state_dict({"params": jax_out[-1][0].ema_params})
    moved = 0
    for name, p in ema.named_parameters():
        _within(p, want_ema[name].numpy(), f"ema {name}")
        moved += not torch.equal(p, ema0[name])
    assert moved > 0 and count == StepCount(iterations=2, updates=2)


def test_hard_teacher_matches_jax():
    settings = _settings(**{"cst_training.cst_loss.type": "CE"})
    batch = _batch(5)
    init, [(_, want_losses)] = _jax_run(settings, [batch])
    _, _, _, step = _port(settings, init)
    _check_losses(step(_to_torch(batch), StepCount()), want_losses)
