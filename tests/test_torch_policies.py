"""The port's IAS policy math (hiast_tpu_torch/pseudo/policies.py) against
hiast_tpu/pseudo/policies.py on the same seeded numpy inputs, atol 1e-6
(float32 pow/log/exp implementations may differ in the last ulp)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hiast_tpu.pseudo import policies as JP
from hiast_tpu_torch.pseudo import policies as TP

# Seen rarely in a process that also runs JAX on the CPU: the FIRST torch.exp
# call loses precision (1.5e-4 relative) while later calls are exact.  Spend
# that first call here, so the comparisons below hold to the ulp.
torch.exp(torch.zeros(16))

RNG = np.random.default_rng(17)


def _hist(num_bins, empty_rows=()):
    hist = RNG.integers(0, 40, size=(19, num_bins)).astype(np.float32)
    hist *= RNG.random((19, num_bins)) < 0.3  # sparse rows, like real ones
    for r in empty_rows:
        hist[r] = 0
    return hist


def test_confidences_match_jax():
    x = (RNG.normal(size=(2, 12, 20, 19)) * 3).astype(np.float32)
    mp_j, pred_j = JP.confidences(jnp.asarray(x))
    mp_t, pred_t = TP.confidences(torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1))))
    np.testing.assert_allclose(mp_t.numpy(), np.asarray(mp_j), atol=1e-6)
    np.testing.assert_array_equal(pred_t.numpy(), np.asarray(pred_j))


def test_confidences_ties_take_the_smallest_class():
    x = np.zeros((1, 19, 1, 2), np.float32)
    x[0, [3, 7], 0, 0] = 2.0
    x[0, [5, 18], 0, 1] = 1.0
    _, pred = TP.confidences(torch.from_numpy(x))
    assert pred.tolist() == [[[3, 5]]]


@pytest.mark.parametrize("num_bins", [256, 2048])
def test_histogram_quantile_matches_jax(num_bins):
    hist = _hist(num_bins, empty_rows=(4,))
    q = RNG.uniform(0.0, 1.0, size=19).astype(np.float32)
    want = JP.histogram_quantile(jnp.asarray(hist), jnp.asarray(q))
    got = TP.histogram_quantile(torch.from_numpy(hist), torch.from_numpy(q))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("alpha,beta,gamma", [(0.2, 0.9, 8.0), (0.5, 0.9, 8.0), (0.2, 0.5, 2.0)])
def test_ias_update_matches_jax_over_several_batches(alpha, beta, gamma):
    """The thresholds are carried state: chain five updates on both sides."""
    thr_j = JP.IASState(jnp.full((19,), 0.9, jnp.float32), jnp.zeros((19,), jnp.float32))
    thr_t = TP.IASState(torch.full((19,), 0.9), torch.zeros(19))
    for _ in range(5):
        hist = _hist(2048, empty_rows=(2,))
        new_j = JP.ias_update(thr_j, jnp.asarray(hist), alpha, beta, gamma)
        new_t = TP.ias_update(thr_t, torch.from_numpy(hist), alpha, beta, gamma)
        np.testing.assert_allclose(new_t.numpy(), np.asarray(new_j), atol=1e-6)
        assert new_t.dtype == torch.float32 and float(new_t.max()) <= 0.999
        thr_j = JP.IASState(new_j, thr_j.class_mean_probs)
        thr_t = TP.IASState(new_t, thr_t.class_mean_probs)


def test_ias_update_leaves_its_input_histogram_alone():
    hist = torch.from_numpy(_hist(256))
    before = hist.clone()
    TP.ias_update(TP.IASState(torch.full((19,), 0.9), torch.zeros(19)), hist, 0.2, 0.9, 8.0)
    torch.testing.assert_close(hist, before, rtol=0, atol=0)


def test_update_class_mean_probs_matches_jax():
    cmp = RNG.uniform(0.5, 1.0, size=19).astype(np.float32)
    cmp[[0, 5]] = 0.0  # first observation initialises directly
    counts = RNG.integers(0, 50, size=19).astype(np.float32)
    counts[[1, 5]] = 0.0  # absent classes keep their value
    sums = (counts * RNG.uniform(0.5, 1.0, size=19)).astype(np.float32)
    want = JP.update_class_mean_probs(jnp.asarray(cmp), jnp.asarray(sums), jnp.asarray(counts), 0.99)
    got = TP.update_class_mean_probs(
        torch.from_numpy(cmp), torch.from_numpy(sums), torch.from_numpy(counts), 0.99
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
