"""The port's IAS selection kernels (hiast_tpu_torch/ops/cuda/select_kernel.py).

On the CPU the wrappers run their plain PyTorch versions; those are held
against the JAX package on the same seeded logits (NHWC for JAX, the same
values moved to NCHW for the port):

- against the XLA policies (``class_prob_histogram``,
  ``select_pseudo_labels``, ``per_sample_class_counts``,
  ``class_prob_sums``): counts and labels exact, sums to rtol 1e-5 (float
  sums in another order);
- against the Pallas kernels in interpret mode (``fused_hist``,
  ``fused_select_batched``): those compute the confidence as 1/sum(exp(x-m))
  rather than exp(m - lse), which can move a pixel lying within 1e-6 of a
  bin edge or a threshold, so only such pixels may differ.

The kernels themselves are held against the plain versions on a card by
tests/test_torch_kernels_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hiast_tpu.ops.pallas.select_kernel import fused_hist, fused_select_batched
from hiast_tpu.pseudo import policies as JP
from hiast_tpu_torch.ops.cuda import select_kernel as K
from hiast_tpu_torch.pseudo import policies as TP

# Seen rarely in a process that also runs JAX on the CPU: the FIRST torch.exp
# call loses precision (1.5e-4 relative) while later calls are exact.  Spend
# that first call here, so the comparisons below hold to the ulp.
torch.exp(torch.zeros(16))

SHAPE = (2, 24, 40, 19)  # [B, H, W, C] on the JAX side
PIXELS = SHAPE[1] * SHAPE[2]


def _logits(seed):
    x = (np.random.default_rng(seed).normal(size=SHAPE) * 3).astype(np.float32)
    return x, torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _valid(n_samples):
    return np.arange(SHAPE[0]) < n_samples


@pytest.mark.parametrize("num_bins", [256, 2048])
@pytest.mark.parametrize("n_samples", [2, 1])
def test_hist_plain_matches_xla(num_bins, n_samples):
    x, xt = _logits(1)
    mp, pred = JP.confidences(jnp.asarray(x))
    w = jnp.broadcast_to(jnp.asarray(_valid(n_samples), jnp.float32)[:, None, None], pred.shape)
    want = np.asarray(JP.class_prob_histogram(mp, pred, 19, num_bins, w))
    got = K.ias_hist(xt, n_samples * PIXELS, num_bins)
    assert got.dtype == torch.float32 and tuple(got.shape) == (19, num_bins)
    np.testing.assert_array_equal(got.numpy(), want)
    assert float(got.sum()) == n_samples * PIXELS


@pytest.mark.parametrize("num_bins", [256, 2048])
@pytest.mark.parametrize("n_samples", [2, 1])
def test_hist_plain_matches_pallas_interpret(num_bins, n_samples):
    x, xt = _logits(2)
    _, _, want = fused_hist(
        jnp.asarray(x), jnp.asarray(n_samples * PIXELS), num_bins=num_bins,
        interpret=True, with_pixels=False,
    )
    got = K.ias_hist(xt, n_samples * PIXELS, num_bins).numpy()
    np.testing.assert_array_equal(got.sum(1), np.asarray(want).sum(1))
    # pixels within 1e-6 of a bin edge may land in the neighbouring bin
    mp, _ = TP.confidences(xt)
    s = mp.numpy().reshape(-1)[: n_samples * PIXELS] * num_bins
    near_edge = int(np.sum(np.abs(s - np.rint(s)) <= 1e-6 * num_bins))
    assert np.abs(got - np.asarray(want)).sum() <= 2 * near_edge


@pytest.mark.parametrize("n_samples", [2, 1])
def test_select_plain_matches_xla(n_samples):
    x, xt = _logits(3)
    thr = np.random.default_rng(4).uniform(0.3, 0.95, size=19).astype(np.float32)
    mp, pred = JP.confidences(jnp.asarray(x))
    plbl = JP.select_pseudo_labels(mp, pred, jnp.asarray(thr))
    plbl = jnp.where(jnp.asarray(_valid(n_samples))[:, None, None], plbl, JP.IGNORE)
    want_counts = JP.per_sample_class_counts(plbl, 19)
    want_sums, want_totals = JP.class_prob_sums(plbl, mp, 19)

    labels, counts, sums, maxprob = K.ias_select(xt, torch.from_numpy(thr), n_samples * PIXELS)
    assert labels.dtype == torch.uint8 and counts.dtype == torch.int32 and maxprob is None
    np.testing.assert_array_equal(labels.numpy(), np.asarray(plbl).astype(np.uint8))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_counts))
    np.testing.assert_array_equal(counts.numpy().sum(0), np.asarray(want_totals))
    np.testing.assert_allclose(sums.numpy(), np.asarray(want_sums), rtol=1e-5)


@pytest.mark.parametrize("n_samples", [2, 1])
def test_select_plain_matches_pallas_interpret(n_samples):
    x, xt = _logits(5)
    thr = np.random.default_rng(6).uniform(0.2, 0.8, size=19).astype(np.float32)
    plbl, mp, per_sample, sums, _ = fused_select_batched(
        jnp.asarray(x), jnp.asarray(thr), nvalid=jnp.asarray(n_samples * PIXELS), interpret=True
    )
    labels, counts, got_sums, maxprob = K.ias_select(
        xt, torch.from_numpy(thr), n_samples * PIXELS, with_maxprob=True
    )
    np.testing.assert_allclose(maxprob.numpy(), np.asarray(mp), atol=1e-6)
    _, pred = TP.confidences(xt)
    near_thr = np.abs(maxprob.numpy() - thr[pred.numpy()]) <= 1e-6
    differ = labels.numpy() != np.asarray(plbl).astype(np.uint8)
    assert not np.any(differ & ~near_thr)
    assert np.abs(counts.numpy() - np.asarray(per_sample)).sum() <= differ.sum()
    np.testing.assert_allclose(got_sums.numpy(), np.asarray(sums), rtol=1e-5, atol=float(differ.sum()))


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    _, xt = _logits(7)
    thr = torch.full((19,), 0.5)
    K.reset_launch_counts()
    torch.testing.assert_close(K.ias_hist(xt, 2 * PIXELS, 256), K.ias_hist_plain(xt, 2 * PIXELS, 256))
    got, want = K.ias_select(xt, thr, PIXELS), K.ias_select_plain(xt, thr, PIXELS)
    for g, w in zip(got[:3], want[:3]):
        torch.testing.assert_close(g, w)
    assert K.launch_counts == {"ias_hist": 0, "ias_select": 0}


def test_wrappers_reject_what_the_kernels_do_not_take():
    _, xt = _logits(8)
    with pytest.raises(ValueError):
        K.ias_hist(xt[0], PIXELS, 256)  # not NCHW
    with pytest.raises(ValueError):
        K.ias_hist(xt, PIXELS, 0)
    with pytest.raises(ValueError):
        K.ias_select(xt, torch.full((18,), 0.5), PIXELS)  # wrong class count
