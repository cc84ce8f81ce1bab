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

The backward (``sra_attention_bwd_plain`` and the autograd Function, which
runs it on the CPU) is held against ``jax.vjp`` of the Pallas kernel in
interpret mode and of the reference einsum at the shapes of
tests/test_pallas_attention.py:57: float32 at rtol = atol = 2e-4, the JAX
gradient test's; bf16 at |g - r| <= 0.03 max|r| + 0.1 |r|, the JAX bf16
gradient test's (:95), since dS and the gradients round to bf16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hiast_tpu.ops.pallas.attention import sra_attention as jax_sra_attention
from hiast_tpu.ops.pallas.attention import sra_attention_reference
from hiast_tpu_torch.ops.cuda.attention import (
    launch_counts,
    sra_attention,
    sra_attention_bwd_plain,
    sra_attention_kv,
    sra_attention_plain,
    sra_attention_stats_plain,
    split_kv,
    tiles_per_chunk,
)

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
    with pytest.raises(ValueError):
        sra_attention_kv(q, torch.cat([k, v], -1).flatten(2)[..., :100])  # kv is not [B, N, 2 H D]
    # inputs that require grad are taken: autograd runs the backward (the
    # plain version on the CPU, the kernel on a card)
    qg = q.clone().requires_grad_()
    sra_attention(qg, k, v).sum().backward()
    assert qg.grad is not None and qg.grad.shape == q.shape


def _jax_vjp(attn, q, k, v, do, dtype):
    jq, jk, jv, jdo = (jnp.asarray(x, dtype) for x in (q, k, v, do))
    _, vjp = jax.vjp(attn, jq, jk, jv)
    return [np.asarray(g, np.float32) for g in vjp(jdo)]


def _jax_grads(q, k, v, do, dtype):
    """(Pallas kernel in interpret mode, reference einsum) VJPs."""
    fused = _jax_vjp(lambda a, b, c: jax_sra_attention(a, b, c, interpret=True), q, k, v, do, dtype)
    return fused, _jax_vjp(sra_attention_reference, q, k, v, do, dtype)


def _assert_bf16_grad_bound(got, want, name):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, atol=0.03 * np.abs(want).max(), rtol=0.1, err_msg=name)


@pytest.mark.parametrize("b,nq,nkv,h,d", [(1, 512, 128, 1, 64), (2, 700, 96, 2, 32)])
def test_backward_float32_matches_jax(b, nq, nkv, h, d):
    q, k, v = _qkv(15, b, nq, nkv, h, d)
    do = np.random.default_rng(16).normal(size=q.shape).astype(np.float32)
    fused, ref = _jax_grads(q, k, v, do, jnp.float32)
    got = sra_attention_bwd_plain(*map(torch.from_numpy, (q, k, v, do)))
    for name, g, w_fused, w_ref in zip("qkv", got, fused, ref):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w_fused, rtol=2e-4, atol=2e-4, err_msg=name)
        np.testing.assert_allclose(g.numpy(), w_ref, rtol=2e-4, atol=2e-4, err_msg=name)


@pytest.mark.parametrize("b,nq,nkv,h,d", [(1, 512, 128, 2, 64), (2, 700, 96, 2, 32)])
def test_backward_bfloat16_matches_jax(b, nq, nkv, h, d):
    q, k, v = _qkv(17, b, nq, nkv, h, d)
    do = np.random.default_rng(18).normal(size=q.shape).astype(np.float32)
    fused, ref = _jax_grads(q, k, v, do, jnp.bfloat16)
    got = sra_attention_bwd_plain(*(torch.from_numpy(x).bfloat16() for x in (q, k, v, do)))
    for name, g, w_fused, w_ref in zip("qkv", got, fused, ref):
        assert g.dtype == torch.bfloat16
        _assert_bf16_grad_bound(g.float().numpy(), w_fused, name)
        _assert_bf16_grad_bound(g.float().numpy(), w_ref, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_function_writes_one_kv_gradient(dtype):
    """Through the autograd Function (the model's path): dq and the k and v
    halves of d(kv) against the JAX VJP, and separate k and v get their
    gradients as the halves of one buffer too."""
    b, nq, nkv, h, d = 2, 700, 96, 2, 32
    q, k, v = _qkv(19, b, nq, nkv, h, d)
    do = np.random.default_rng(20).normal(size=q.shape).astype(np.float32)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    fused, _ = _jax_grads(q, k, v, do, jdtype)
    tq, tk, tv, tdo = (torch.from_numpy(x).to(dtype) for x in (q, k, v, do))
    qg = tq.clone().requires_grad_()
    kv = torch.cat([tk.reshape(b, nkv, h * d), tv.reshape(b, nkv, h * d)], -1).requires_grad_()
    before = dict(launch_counts)
    out = sra_attention_kv(qg, kv)
    out.backward(tdo)
    assert launch_counts == before  # the CPU runs the plain versions
    assert kv.grad.shape == kv.shape and kv.grad.is_contiguous()
    dk, dv = split_kv(kv.grad, h)
    for name, g, w in zip("qkv", (qg.grad, dk, dv), fused):
        if dtype == torch.float32:
            np.testing.assert_allclose(g.numpy(), w, rtol=2e-4, atol=2e-4, err_msg=name)
        else:
            _assert_bf16_grad_bound(g.float().numpy(), w, name)
    kg, vg = tk.clone().requires_grad_(), tv.clone().requires_grad_()
    sra_attention(tq, kg, vg).backward(tdo)
    torch.testing.assert_close(kg.grad, dk, rtol=0, atol=0)
    torch.testing.assert_close(vg.grad, dv, rtol=0, atol=0)


def test_row_statistics_plain():
    """The residuals the forward kernel saves, in their plain form: the row
    max of the scaled scores and the sum of exp(s - max); softmax rebuilt
    from them is the forward's."""
    b, nq, nkv, h, d = 2, 100, 40, 2, 32
    q, k, v = map(torch.from_numpy, _qkv(21, b, nq, nkv, h, d))
    m, lsum = sra_attention_stats_plain(q, k)
    assert m.shape == lsum.shape == (b * h, nq)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).reshape(b * h, nq, nkv) / d ** 0.5
    torch.testing.assert_close(torch.exp(s - m[..., None]) / lsum[..., None], torch.softmax(s, -1))


def test_query_chunks_fill_the_card():
    """The dK/dV kernel's query chunks: only where the 64-row K/V tiles of
    all heads are fewer than the SMs (a training step's stages 1 and 2: 48
    and 96 tiles for 132) is the query range cut, into the chunk count whose
    work items (128 K/V rows each, one per SM at a time) leave the fewest
    query tiles on the busiest SM; elsewhere one chunk takes all."""
    assert tiles_per_chunk(6, 32768, 512, 132) == 47   # stage 1: 11 chunks, 264 items in 2 rounds
    assert tiles_per_chunk(12, 8192, 512, 132) == 16   # stage 2: 8 chunks, 384 items in 3 rounds
    assert tiles_per_chunk(30, 2048, 512, 132) == 32   # stage 3: 240 tiles, one chunk of all 32
    assert tiles_per_chunk(48, 512, 512, 132) == 8     # stage 4: one chunk of all 8
    assert tiles_per_chunk(1, 100, 96, 132) == 1       # 2 query tiles, 2 chunks
