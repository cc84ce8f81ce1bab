"""The port's SRA attention (hiast_tpu_torch/ops/cuda/attention.py) against
the JAX package's, on the CPU.

Seeded numpy q, k, v in the JAX layout [B, N, H, D] go to JAX's
``sra_attention_reference`` and ``sra_attention(interpret=True)`` (the
Pallas kernel in interpret mode, as tests/test_pallas_attention.py runs it)
and to the port's ``sra_attention_plain`` and ``sra_attention`` wrapper,
which on CPU tensors runs the plain version.  Shapes are those of
tests/test_pallas_attention.py: both tile fits and pads, several heads, and
N_kv above 1024 with D = 32.

Tolerances: float32 at atol = rtol = 1e-5, the JAX test's own (both sides
compute f32 products and an f32 softmax; only the summation order differs).
bf16 at atol = rtol = 2e-2, the JAX bf16 test's: P is cast to bf16 at the
same place on both sides, but the f32 scores it is cast from may differ in
their last bits, and one bf16 ulp of P is 2^-8 relative.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hiast_tpu.ops.pallas.attention import sra_attention as jax_sra_attention
from hiast_tpu.ops.pallas.attention import sra_attention_reference
from hiast_tpu_torch.ops.cuda.attention import launch_counts, sra_attention, sra_attention_plain

SHAPES = [
    (2, 512, 128, 1, 64),    # exact tile fit
    (1, 700, 96, 2, 64),     # N_q and N_kv off every tile
    (2, 1024, 512, 5, 64),   # stage-3-like multi-head
    (1, 300, 1200, 2, 32),   # N_kv > 1024, D = 32
]


def _qkv(seed, b, nq, nkv, h, d):
    rng = np.random.default_rng(seed)
    return tuple(
        rng.normal(size=s).astype(np.float32) for s in ((b, nq, h, d), (b, nkv, h, d), (b, nkv, h, d))
    )


@pytest.mark.parametrize("b,nq,nkv,h,d", SHAPES)
def test_float32_matches_jax(b, nq, nkv, h, d):
    q, k, v = _qkv(11, b, nq, nkv, h, d)
    want_ref = np.asarray(sra_attention_reference(*map(jnp.asarray, (q, k, v))))
    want_kernel = np.asarray(jax_sra_attention(*map(jnp.asarray, (q, k, v)), interpret=True))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    before = launch_counts["sra_attention"]
    got_plain = sra_attention_plain(tq, tk, tv).numpy()
    got = sra_attention(tq, tk, tv)
    assert launch_counts["sra_attention"] == before  # the CPU runs the plain version
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, nq, h, d)
    for want in (want_ref, want_kernel):
        np.testing.assert_allclose(got_plain, want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,nq,nkv,h,d", [(2, 640, 160, 2, 64), (1, 700, 96, 2, 32)])
def test_bfloat16_matches_jax(b, nq, nkv, h, d):
    q, k, v = _qkv(12, b, nq, nkv, h, d)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want_ref = np.asarray(sra_attention_reference(jq, jk, jv), np.float32)
    want_kernel = np.asarray(jax_sra_attention(jq, jk, jv, interpret=True), np.float32)
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    got = sra_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    for want in (want_ref, want_kernel):
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2, atol=2e-2)


def test_plain_version_ignores_autocast():
    """Under CPU autocast the plain version still multiplies in float32."""
    q, k, v = map(torch.from_numpy, _qkv(13, 1, 64, 32, 1, 64))
    with torch.autocast("cpu", dtype=torch.bfloat16):
        got = sra_attention_plain(q, k, v)
    torch.testing.assert_close(got, sra_attention_plain(q, k, v), rtol=0, atol=0)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    q, k, v = map(torch.from_numpy, _qkv(14, 1, 32, 16, 2, 64))
    with pytest.raises(TypeError):
        sra_attention(q.half(), k.half(), v.half())  # neither f32 nor bf16
    with pytest.raises(TypeError):
        sra_attention(q, k.bfloat16(), v)  # mixed dtypes
    with pytest.raises(ValueError):
        sra_attention(q[..., :16], k[..., :16], v[..., :16])  # D = 16: no kernel instance
    with pytest.raises(ValueError):
        sra_attention(q, k[:, :, :1], v[:, :, :1])  # heads differ
    with pytest.raises(RuntimeError, match="no backward"):
        sra_attention(q.requires_grad_(), k, v)  # B4 is not ported: no silent autograd
