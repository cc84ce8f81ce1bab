"""The port's strong view (hiast_tpu_torch/ops/color_aug.py) against the
JAX package's ``batched_color_aug``, on the CPU.

Torch cannot draw ``jax.random``'s numbers, so each test rebuilds, from
the same key, the draws that the JAX function makes (the same
``jax.random.split`` tree) and hands them to the port's
``apply_color_aug``.  Images are 4 x 32 x 64 uint8, the chain in float32.

Tolerance: at most 1e-3 intensity levels everywhere, except at pixels that
sit on an edge of a ``floor`` (posterize, the equalize's level), a
``round`` (the equalize's LUT) or the solarize's ``>= 128``, where float32
sums taken in another order may fall on the other side; those may be at
most 0.1% of the pixels.  The bf16 chain against the float32 one: the
bounds of the JAX package's own ``test_bf16_matches_fp32``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hiast_tpu.ops import color_aug as J
from hiast_tpu_torch.ops import color_aug as P

B, H, W = 4, 32, 64
N_POOL = 8


@pytest.fixture(scope="module", autouse=True)
def _threads():
    """Two threads: the suite runs several pytest-xdist workers on one host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _images(seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=(B, H, W, 3)).astype(np.uint8)


def _jitter_draws(key, b):
    kb, kc, ks, kh = jax.random.split(key, 4)
    factors = [jax.random.uniform(k, (b, 1, 1, 1), minval=0.8, maxval=1.2).reshape(b) for k in (kb, kc, ks)]
    hue = jax.random.uniform(kh, (b,), minval=-0.2, maxval=0.2)
    return torch.from_numpy(np.stack([np.asarray(v) for v in (*factors, hue)], 1))


def _ksize(key, b):
    return torch.from_numpy(np.array(3 + 2 * jax.random.randint(key, (b,), 0, (J._MAX_BLUR - 3) // 2 + 1))).long()


def jax_draws(key, b, kind):
    """``batched_color_aug``'s draws for ``key``, as the port's ColorAugDraws."""
    if kind == "SCA":
        k1, k2, kg = jax.random.split(key, 3)
        gates = np.asarray(jax.random.bernoulli(kg, 0.5, (2, b))).T
        return P.ColorAugDraws("SCA", torch.from_numpy(gates.copy()), _jitter_draws(k1, b), _ksize(k2, b))
    k_perm, k_gate, kj, kb_, kc, kbr = jax.random.split(key, 6)
    perm = jax.vmap(lambda k: jax.random.permutation(k, N_POOL))(jax.random.split(k_perm, b))
    chosen = np.any(np.asarray(perm)[:, :3, None] == np.arange(N_POOL)[None, None, :], axis=1)
    gates = chosen & np.asarray(jax.random.bernoulli(k_gate, 0.5, (b, N_POOL)))
    alpha = 1.0 + np.array(jax.random.uniform(kc, (b, 1, 1, 1), minval=0.0, maxval=3.0)).reshape(b)
    beta = np.array(jax.random.uniform(kbr, (b, 1, 1, 1), minval=-0.5, maxval=0.5)).reshape(b)
    return P.ColorAugDraws("CCA", torch.from_numpy(gates), _jitter_draws(kj, b), _ksize(kb_, b),
                           torch.from_numpy(alpha), torch.from_numpy(beta))


def _assert_close_levels(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    off = np.abs(got - want) > 1e-3
    assert off.mean() <= 1e-3, f"{what}: {off.sum()} of {off.size} values off by more than 1e-3 " \
                               f"(max {np.abs(got - want).max()})"


@pytest.mark.parametrize("key", [0, 1])
def test_color_jitter_matches_jax(key):
    imgs = _images(key).astype(np.float32)
    k = jax.random.PRNGKey(key)
    want = J._batched_color_jitter(jnp.asarray(imgs), k)
    got = P.color_jitter(torch.from_numpy(imgs), _jitter_draws(k, B))
    _assert_close_levels(got.numpy(), want, "color jitter")


@pytest.mark.parametrize("key", [0, 1])
def test_blur_matches_jax(key):
    imgs = _images(key).astype(np.float32)
    k = jax.random.PRNGKey(key)
    ksize = _ksize(k, B)
    assert len(set(ksize.tolist())) > 1  # per-sample widths
    want = J._batched_blur(jnp.asarray(imgs), k)
    got = P.gaussian_blur(torch.from_numpy(imgs), ksize)
    _assert_close_levels(got.numpy(), want, "blur")


@pytest.mark.parametrize("seed", [0, 1])
def test_equalize_matches_jax(seed):
    imgs = _images(seed).astype(np.float32)
    imgs[1] = imgs[1] * 0.3 + 40  # a narrow histogram: the LUT stretches it
    want = J._batched_equalize(jnp.asarray(imgs))
    got = P.equalize(torch.from_numpy(imgs))
    _assert_close_levels(got.numpy(), want, "equalize")


# (key, sample, transform): the first key of 0..399 whose draws put exactly
# that transform on for that sample (the test asserts it), for each of the
# 8 transforms, so each runs alone in the chain
SINGLE_GATE_CASES = [(13, 0, 0), (0, 3, 1), (1, 3, 2), (20, 0, 3), (2, 0, 4), (1, 1, 5), (4, 0, 6), (8, 0, 7)]


@pytest.mark.parametrize("key,sample,transform", SINGLE_GATE_CASES)
def test_each_transform_alone_in_the_chain_matches_jax(key, sample, transform):
    imgs = _images(key)
    k = jax.random.PRNGKey(key)
    draws = jax_draws(k, B, "CCA")
    assert draws.gates[sample].tolist() == [i == transform for i in range(N_POOL)]
    want = np.asarray(J.batched_color_aug(jnp.asarray(imgs), k, kind="CCA"))
    got = P.apply_color_aug(torch.from_numpy(imgs), draws).numpy()
    _assert_close_levels(got[sample], want[sample], f"transform {transform} alone")
    if transform >= 4:  # posterize, equalize, solarize, gray change every pixel they touch
        assert np.abs(want[sample] - imgs[sample]).max() > 0


@pytest.mark.parametrize("kind", ["CCA", "SCA"])
@pytest.mark.parametrize("key", [0, 1, 2, 3])
def test_chain_matches_jax(kind, key):
    imgs = _images(10 + key)
    k = jax.random.PRNGKey(key)
    want = np.asarray(J.batched_color_aug(jnp.asarray(imgs), k, kind=kind))
    got = P.apply_color_aug(torch.from_numpy(imgs), jax_draws(k, B, kind))
    assert got.dtype == torch.float32 and got.shape == (B, H, W, 3)
    _assert_close_levels(got.numpy(), want, f"{kind} chain")


def test_bf16_matches_fp32():
    """The step runs the chain in bf16: the same draws, pixels apart only by
    quantisation (the JAX package's bounds: mean below 1.5 levels, the 99th
    percentile below 16, for the flips at posterize/equalize/solarize)."""
    imgs = torch.from_numpy(_images(5))
    gen = torch.Generator().manual_seed(0)
    for _ in range(3):
        draws = P.draw_color_aug(B, "CCA", gen)
        f32 = P.apply_color_aug(imgs, draws)
        bf16 = P.apply_color_aug(imgs, draws, torch.bfloat16)
        assert bf16.dtype == torch.bfloat16
        diff = (bf16.float() - f32).abs()
        assert float(diff.mean()) < 1.5 and float(torch.quantile(diff.flatten(), 0.99)) < 16.0


@pytest.mark.parametrize("kind", ["CCA", "SCA"])
def test_draws_follow_the_contract(kind):
    gen = torch.Generator().manual_seed(1)
    draws = P.draw_color_aug(64, kind, gen)
    gates = draws.gates
    assert gates.dtype == torch.bool and gates.shape == (64, 8 if kind == "CCA" else 2)
    if kind == "CCA":
        assert int(gates.sum(1).max()) <= 3 and 0 < float(gates.float().mean()) < 3 / 8
    k = draws.ksize
    assert bool(((k % 2 == 1) & (k >= 3) & (k <= 41)).all())
    j = draws.jitter
    assert bool(((j[:, :3] >= 0.8) & (j[:, :3] <= 1.2)).all()) and bool((j[:, 3].abs() <= 0.2).all())
    out = P.batched_color_aug(torch.from_numpy(_images(2)), kind, gen)
    assert float(out.min()) >= 0 and float(out.max()) <= 255
