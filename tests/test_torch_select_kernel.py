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

Both comparisons also run on peaked logits shaped like a trained model's
(most pixels at p >= 0.99, many at p == 1.0 exactly, so the clamp into the
last bin is reached), with exact ties between the two largest logits
(first-max argmax) and thresholds set to some pixels' own confidences (a
pixel exactly at its threshold is selected).

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


def _peaked_logits(seed):
    """Logits shaped like a trained model's (NHWC for JAX, NCHW for the
    port): 8x8 blocks of one class over N(0, 1), that class +6 plus an
    exponential margin of mean 6, so most pixels have p >= 0.99 and many
    p == 1.0 exactly (the clamp into bin nb - 1).  Some pixels get an exact
    tie between their two largest logits (first-max argmax)."""
    rng = np.random.default_rng(seed)
    b, h, w, c = SHAPE
    x = rng.normal(size=SHAPE).astype(np.float32)
    cls = np.repeat(np.repeat(rng.integers(0, c, size=(b, h // 8, w // 8)), 8, 1), 8, 2)
    margin = (6.0 + rng.exponential(6.0, size=(b, h, w))).astype(np.float32)
    np.put_along_axis(x, cls[..., None], np.take_along_axis(x, cls[..., None], -1) + margin[..., None], -1)
    tie = rng.random((b, h, w)) < 0.05
    other = (cls + 1 + rng.integers(0, c - 1, size=(b, h, w))) % c
    top = np.take_along_axis(x, cls[..., None], -1)
    cur = np.take_along_axis(x, other[..., None], -1)
    np.put_along_axis(x, other[..., None], np.where(tie[..., None], top, cur), -1)
    return x, torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1))), tie


def _thresholds_at_pixels(maxprob, pred, seed):
    """Per class, the confidence of one of its pixels (so that pixel sits
    exactly at its threshold), else 0.9."""
    rng = np.random.default_rng(seed)
    mp, pr = maxprob.numpy().reshape(-1), pred.numpy().reshape(-1)
    thr = np.full(SHAPE[-1], 0.9, np.float32)
    for c in np.unique(pr):
        idx = np.flatnonzero(pr == c)
        thr[c] = min(mp[rng.choice(idx)], 0.999)
    return thr


def _near_bin_edge(p, num_bins):
    """Pixels whose confidence lies within 1e-6 of an inner bin edge.  The
    clamp at p * num_bins == num_bins is no edge: an ulp below 1 still lands
    in the last bin."""
    s = p.astype(np.float64) * num_bins
    edge = np.rint(s)
    return int(np.sum((np.abs(s - edge) <= 1e-6 * num_bins) & (edge > 0) & (edge < num_bins)))


@pytest.mark.parametrize("n_samples", [2, 1])
def test_plain_versions_match_xla_on_peaked_logits(n_samples):
    """XLA's confidence can differ from the port's by an ulp (1e-6 near 1),
    so, as against the Pallas kernels, only a pixel within 1e-6 of a bin
    edge or of its threshold may move."""
    x, xt, tie = _peaked_logits(11)
    mp_t, pred_t = TP.confidences(xt)
    assert int((mp_t == 1.0).sum()) > 0 and tie.any()
    mp, pred = JP.confidences(jnp.asarray(x))
    np.testing.assert_allclose(mp_t.numpy(), np.asarray(mp), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(pred_t.numpy(), np.asarray(pred))
    nchw = np.moveaxis(x, -1, 1)
    first_max = np.argmax(nchw == nchw.max(1, keepdims=True), axis=1)  # ties: the smaller class id
    np.testing.assert_array_equal(pred_t.numpy(), first_max)

    nvalid = n_samples * PIXELS
    w = jnp.broadcast_to(jnp.asarray(_valid(n_samples), jnp.float32)[:, None, None], pred.shape)
    want_hist = np.asarray(JP.class_prob_histogram(mp, pred, 19, 2048, w))
    got_hist = K.ias_hist(xt, nvalid, 2048).numpy()
    np.testing.assert_array_equal(got_hist.sum(1), want_hist.sum(1))
    near_edge = _near_bin_edge(mp_t.numpy().reshape(-1)[:nvalid], 2048)
    assert np.abs(got_hist - want_hist).sum() <= 2 * near_edge
    assert got_hist[:, -1].sum() >= int((mp_t.reshape(-1)[:nvalid] == 1.0).sum()) > 0

    thr = _thresholds_at_pixels(mp_t, pred_t, 12)
    plbl = JP.select_pseudo_labels(mp, pred, jnp.asarray(thr))
    plbl = jnp.where(jnp.asarray(_valid(n_samples))[:, None, None], plbl, JP.IGNORE)
    labels, counts, sums, _ = K.ias_select(xt, torch.from_numpy(thr), nvalid)
    at_thr = (mp_t.numpy() == thr[pred_t.numpy()]) & (labels.numpy() != 255)
    assert at_thr.any()  # pixels exactly at their threshold are selected
    near_thr = np.abs(mp_t.numpy() - thr[pred_t.numpy()]) <= 1e-6
    differ = labels.numpy() != np.asarray(plbl).astype(np.uint8)
    assert not np.any(differ & ~near_thr)
    want_counts = np.asarray(JP.per_sample_class_counts(plbl, 19))
    assert np.abs(counts.numpy() - want_counts).sum() <= differ.sum()
    want_sums, _ = JP.class_prob_sums(plbl, mp, 19)
    np.testing.assert_allclose(sums.numpy(), np.asarray(want_sums), rtol=1e-5, atol=float(differ.sum()))


def test_plain_versions_match_pallas_interpret_on_peaked_logits():
    x, xt, _ = _peaked_logits(13)
    nvalid = 2 * PIXELS
    _, _, want_hist = fused_hist(
        jnp.asarray(x), jnp.asarray(nvalid), num_bins=2048, interpret=True, with_pixels=False,
    )
    got_hist = K.ias_hist(xt, nvalid, 2048).numpy()
    np.testing.assert_array_equal(got_hist.sum(1), np.asarray(want_hist).sum(1))
    mp_t, pred_t = TP.confidences(xt)
    near_edge = _near_bin_edge(mp_t.numpy().reshape(-1), 2048)
    assert np.abs(got_hist - np.asarray(want_hist)).sum() <= 2 * near_edge
    assert got_hist[:, -1].sum() >= int((mp_t == 1.0).sum()) > 0

    thr = _thresholds_at_pixels(mp_t, pred_t, 14)
    plbl, mp, per_sample, sums, _ = fused_select_batched(
        jnp.asarray(x), jnp.asarray(thr), nvalid=jnp.asarray(nvalid), interpret=True
    )
    labels, counts, got_sums, maxprob = K.ias_select(xt, torch.from_numpy(thr), nvalid, with_maxprob=True)
    np.testing.assert_allclose(maxprob.numpy(), np.asarray(mp), atol=1e-6)
    near_thr = np.abs(maxprob.numpy() - thr[pred_t.numpy()]) <= 1e-6
    differ = labels.numpy() != np.asarray(plbl).astype(np.uint8)
    assert not np.any(differ & ~near_thr)
    assert np.abs(counts.numpy() - np.asarray(per_sample)).sum() <= differ.sum()
    np.testing.assert_allclose(got_sums.numpy(), np.asarray(sums), rtol=1e-5, atol=float(differ.sum()))


def test_select_plain_sums_in_float64():
    """The plain ``ias_select``'s per-class confidence sums (the CPU path's
    ``class_mean_probabilities.npy``, which picks the next round's hard
    classes) are taken and returned in float64: within 1e-6 relative of numpy's
    float64 sum of the selected confidences, on peaked logits of 2 x 19 x
    256 x 512 (a float32 running sum over this many confidences near 1
    drifts past that)."""
    rng = np.random.default_rng(23)
    b, c, h, w = 2, 19, 256, 512
    x = rng.normal(size=(b, c, h, w)).astype(np.float32)
    cls = np.repeat(np.repeat(rng.integers(0, c, size=(b, 1, h // 16, w // 16)), 16, 2), 16, 3)
    margin = (6.0 + rng.exponential(6.0, size=(b, 1, h, w))).astype(np.float32)
    np.put_along_axis(x, cls, np.take_along_axis(x, cls, 1) + margin, 1)
    logits = torch.from_numpy(x)
    thresholds = torch.full((c,), 0.5, dtype=torch.float32)
    labels, _, sums, maxprob = K.ias_select_plain(logits, thresholds, b * h * w, with_maxprob=True)
    sel = labels.numpy() != 255
    want = np.bincount(labels.numpy()[sel].astype(np.int64), weights=maxprob.numpy()[sel].astype(np.float64),
                       minlength=c)
    assert sums.dtype == torch.float64 and sel.mean() > 0.9
    np.testing.assert_allclose(sums.numpy(), want, rtol=1e-6)
