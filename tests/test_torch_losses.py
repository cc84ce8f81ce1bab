"""The port's self-training losses (hiast_tpu_torch/ops/losses.py) against
the JAX package's (hiast_tpu/ops/losses.py), on the CPU: CE, SoftCE, KLDIV,
MSE and BCEWithLogits over every region, and the region regularisers.

Seeded numpy logits go to both, NHWC to JAX and NCHW to the port (each
package's layout), with labels that include ignored pixels.  Both reduce in
float32 from the same formula and differ only in summation order: rtol 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hiast_tpu.ops import losses as JL
from hiast_tpu_torch.ops import losses as L
from hiast_tpu_torch.registry import LOSS

B, C, H, W = 2, 19, 24, 40


def _inputs(seed, ignore_share=0.3):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(B, H, W, C)) * 3).astype(np.float32)
    labels = rng.integers(0, C, size=(B, H, W)).astype(np.int64)
    labels[rng.random(size=labels.shape) < ignore_share] = 255
    return logits, labels


def _port(logits):
    return torch.from_numpy(np.ascontiguousarray(logits.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("with_weights", [False, True])
@pytest.mark.parametrize("region", [None, "confident", "ignored", "all"])
def test_cross_entropy_matches_jax(with_weights, region):
    logits, labels = _inputs(1)
    refer = _inputs(2)[1]
    weights = np.random.default_rng(3).uniform(0.5, 2.0, C).astype(np.float32) if with_weights else None
    kw = {} if region is None else {"region": region}
    want = JL.cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels), weights=weights,
        refer_labels=None if region is None else jnp.asarray(refer), **kw,
    )
    got = LOSS["CE"](
        _port(logits), torch.from_numpy(labels), weights=weights,
        refer_labels=None if region is None else torch.from_numpy(refer), **kw,
    )
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("ignore_share", [0.0, 0.3, 1.0])
def test_region_regularisers_match_jax(ignore_share):
    """KLD-to-uniform on the confident region and entropy on the ignored
    region, with the reference's x C normalisation; an empty region gives 0."""
    logits, labels = _inputs(4, ignore_share)
    jconf, jign = JL.build_region_weight(jnp.asarray(labels))
    conf, ign = L.build_region_weight(torch.from_numpy(labels))
    np.testing.assert_array_equal(conf.numpy(), np.asarray(jconf))
    np.testing.assert_array_equal(ign.numpy(), np.asarray(jign))
    np.testing.assert_allclose(
        float(L.kld_to_uniform(_port(logits), conf)),
        float(JL.kld_to_uniform(jnp.asarray(logits), jconf)), rtol=1e-5)
    np.testing.assert_allclose(
        float(L.entropy_sharpen(_port(logits), ign)),
        float(JL.entropy_sharpen(jnp.asarray(logits), jign)), rtol=1e-5)


def test_masked_nonzero_mean_and_regions_match_jax():
    logits, labels = _inputs(5)
    loss = np.abs(logits[..., 0])
    loss[0, :4] = 0.0  # zeros in the region do not count
    for region in ("confident", "ignored", "all"):
        jmask = JL.region_mask(jnp.asarray(labels), region)
        mask = L.region_mask(torch.from_numpy(labels), region)
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
        np.testing.assert_allclose(
            float(L._masked_nonzero_mean(torch.from_numpy(loss), mask)),
            float(JL._masked_nonzero_mean(jnp.asarray(loss), jmask)), rtol=1e-5)
    with pytest.raises(ValueError):
        L.region_mask(torch.from_numpy(labels), "somewhere")


def test_bfloat16_logits_reduce_in_float32():
    """bf16 logits give the loss of their float32 values (the reductions
    run in float32)."""
    logits, labels = _inputs(6)
    x = _port(logits).bfloat16()
    lbl = torch.from_numpy(labels)
    got = L.cross_entropy(x, lbl)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, L.cross_entropy(x.float(), lbl), rtol=0, atol=0)


def _probs(seed):
    """A teacher-like probability map, NHWC."""
    x = np.random.default_rng(seed).normal(size=(B, H, W, C)).astype(np.float32) * 2
    e = np.exp(x - x.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("name", ["SoftCE", "KLDIV", "MSE"])
@pytest.mark.parametrize("region", [None, "confident", "ignored", "all"])
def test_soft_losses_match_jax(name, region):
    """SoftCE on a teacher's probabilities (with class weights too), KLDIV
    between two logit maps, MSE between logits and a target map; each
    plain or region-masked with the nonzero-mean protocol."""
    logits = _inputs(5)[0]
    refer = _inputs(6)[1]
    target = _probs(7) if name == "SoftCE" else _inputs(8)[0]
    kw = {} if region is None else {"region": region}
    refer_j = None if region is None else jnp.asarray(refer)
    refer_t = None if region is None else torch.from_numpy(refer)
    weight_sets = [None, np.random.default_rng(9).uniform(0.5, 2.0, C).astype(np.float32)] if name == "SoftCE" else [None]
    for weights in weight_sets:
        want = JL.LOSS[name](jnp.asarray(logits), jnp.asarray(target), weights=weights, refer_labels=refer_j, **kw)
        got = LOSS[name](_port(logits), _port(target), weights=weights, refer_labels=refer_t, **kw)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5, err_msg=f"{name} {region} {weights is not None}")


def test_bce_with_logits_matches_jax():
    logits = _inputs(10)[0]
    labels = (np.random.default_rng(11).random(logits.shape) < 0.3).astype(np.float32)
    want = JL.LOSS["BCEWithLogits"](jnp.asarray(logits), jnp.asarray(labels))
    got = LOSS["BCEWithLogits"](_port(logits), _port(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    torch.testing.assert_close(got, torch.nn.functional.binary_cross_entropy_with_logits(_port(logits), _port(labels)))
