"""The port's CUDA kernels against their plain versions, on a card, and
the strong view on the card.  (The host C++ of csrc/host_ops.cpp, the PNG
unfilter among it, builds and is tested on the CPU:
tests/test_torch_host_ops.py.)

Every test here is marked ``cuda`` and skips without a CUDA device.  The
file imports neither JAX nor the JAX package, so on the card's machine
(which has no JAX) it runs with

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest

Tolerances: the kernels and the plain versions use one formula and sum the
classes in one order, so labels and histogram counts should agree exactly;
a pixel within an ulp of a bin edge or a threshold may still move, so each
test allows the one or two pixels its size makes likely.  The per-class
confidence sums run in another order than the plain version's (per warp,
per block, then a fixed reduce): rtol 1e-4; two calls give the same bits.  The SRA
attention kernel rounds P to bf16 at the plain version's place, from f32
scores summed in another order: max |diff| <= 1e-2 on bf16 outputs of
magnitude ~1 (the JAX bf16 test allows 2e-2).  Its row statistics m and l
are f32 sums over the same scores: rtol 1e-5.  The backward kernels are held
to the JAX bf16 gradient test's bound (tests/test_pallas_attention.py:95),
|g - r| <= 0.03 max|r| + 0.1 |r| per gradient: they round dS and the
outputs to bf16 where the plain version does, but take delta from the bf16
output O (FlashAttention-2's form) and sum in another order.  They add
every sum in a fixed order, so two calls give the same bits.
"""
import json
import os

import numpy as np
import pytest
import torch

from hiast_tpu_torch.ops.cuda import attention as A
from hiast_tpu_torch.ops.cuda import select_kernel as K

pytestmark = pytest.mark.cuda

B, C, H, W = 2, 19, 48, 80


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _logits(seed, device):
    x = (np.random.default_rng(seed).normal(size=(B, C, H, W)) * 3).astype(np.float32)
    return torch.from_numpy(x).to(device)


@pytest.mark.parametrize("num_bins", [256, 2048, 4096])  # clusters of 1, 8 and 16 blocks
@pytest.mark.parametrize("nvalid", [B * H * W, H * W + 7])
def test_hist_kernel_matches_plain(cuda_device, num_bins, nvalid):
    x = _logits(1, cuda_device)
    K.reset_launch_counts()
    got = K.ias_hist(x, nvalid, num_bins)
    want = K.ias_hist_plain(x, nvalid, num_bins)
    torch.cuda.synchronize()
    assert K.launch_counts["ias_hist"] == 1
    torch.testing.assert_close(got.sum(1), want.sum(1), rtol=0, atol=0)
    assert float(got.sum()) == nvalid
    assert float((got - want).abs().sum()) <= 2


@pytest.mark.parametrize("nvalid", [B * H * W, H * W])
def test_select_kernel_matches_plain(cuda_device, nvalid):
    x = _logits(2, cuda_device)
    thr = torch.from_numpy(np.random.default_rng(3).uniform(0.3, 0.9, C).astype(np.float32)).to(cuda_device)
    K.reset_launch_counts()
    labels, counts, sums, maxprob = K.ias_select(x, thr, nvalid, with_maxprob=True)
    want = K.ias_select_plain(x, thr, nvalid, with_maxprob=True)
    torch.cuda.synchronize()
    assert K.launch_counts["ias_select"] == 1
    assert labels.dtype == torch.uint8 and counts.dtype == torch.int32
    differ = int((labels != want[0]).sum())
    assert differ <= 1
    assert int((counts - want[1]).abs().sum()) <= differ
    torch.testing.assert_close(sums, want[2], rtol=1e-4, atol=float(differ))
    torch.testing.assert_close(maxprob, want[3], rtol=0, atol=1e-6)
    if nvalid == H * W:
        assert bool((labels[1] == 255).all()) and int(counts[1].sum()) == 0


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    x = _logits(4, cuda_device)
    thr = torch.full((C,), 0.5, device=cuda_device)
    with pytest.raises(TypeError):
        K.ias_hist(x.half(), B * H * W, 256)
    with pytest.raises(ValueError):
        K.ias_hist(x.transpose(2, 3), B * H * W, 256)  # not contiguous
    with pytest.raises(ValueError):
        K.ias_select(x, thr.cpu(), B * H * W)  # thresholds on another device
    with pytest.raises(ValueError):
        K.ias_select(torch.zeros(1, 33, 4, 4, device=cuda_device), torch.zeros(33, device=cuda_device), 16)


def _peaked(seed, device, b=B, c=C, h=H, w=W):
    """Logits shaped like a trained model's: 8x8 blocks of one class over
    N(0, 1), that class +6 plus an exponential margin of mean 6, so most
    pixels have p >= 0.99 and many p == 1.0 exactly."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, c, h, w)).astype(np.float32)
    cls = np.repeat(np.repeat(rng.integers(0, c, size=(b, 1, -(-h // 8), -(-w // 8))), 8, 2), 8, 3)[..., :h, :w]
    margin = (6.0 + rng.exponential(6.0, size=(b, 1, h, w))).astype(np.float32)
    np.put_along_axis(x, cls, np.take_along_axis(x, cls, 1) + margin, 1)
    return torch.from_numpy(x).to(device)


def _check_hist(x, nvalid, num_bins):
    got = K.ias_hist(x, nvalid, num_bins)
    want = K.ias_hist_plain(x, nvalid, num_bins)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.sum(1), want.sum(1), rtol=0, atol=0)
    assert float(got.sum()) == nvalid
    assert float((got - want).abs().sum()) <= 2


def _check_select(x, thr, nvalid):
    labels, counts, sums, maxprob = K.ias_select(x, thr, nvalid, with_maxprob=True)
    want = K.ias_select_plain(x, thr, nvalid, with_maxprob=True)
    torch.cuda.synchronize()
    differ = int((labels != want[0]).sum())
    assert differ <= 1
    assert int((counts - want[1]).abs().sum()) <= differ
    torch.testing.assert_close(sums, want[2], rtol=1e-4, atol=float(differ))
    torch.testing.assert_close(maxprob, want[3], rtol=0, atol=1e-6)


@pytest.mark.parametrize("nvalid", [B * H * W, H * W + 7])
def test_kernels_match_plain_on_peaked_logits(cuda_device, nvalid):
    x = _peaked(6, cuda_device)
    assert float((K.ias_select_plain(x, torch.zeros(C, device=cuda_device), nvalid, True)[3] == 1.0)
                 .float().mean()) > 0.05
    _check_hist(x, nvalid, 2048)
    thr = torch.full((C,), 0.999, device=cuda_device)
    thr[::2] = 0.99
    _check_select(x, thr, nvalid)


@pytest.mark.parametrize("nvalid", [B * H * W, H * W + 7])
def test_select_kernel_with_zero_thresholds_takes_every_valid_pixel(cuda_device, nvalid):
    """NT: all-zero thresholds select every valid pixel, as the plain version
    does (and JAX's thresholds=None)."""
    x = _logits(8, cuda_device)
    zeros = torch.zeros(C, device=cuda_device)
    labels, counts, sums, _ = K.ias_select(x, zeros, nvalid)
    want = K.ias_select_plain(x, zeros, nvalid)
    torch.cuda.synchronize()
    assert torch.equal(labels, want[0]) and torch.equal(counts, want[1])
    assert int(counts.sum()) == nvalid and int((labels != 255).sum()) == nvalid
    torch.testing.assert_close(sums, want[2], rtol=1e-4, atol=0)


@pytest.mark.parametrize("nvalid", [0, H * W // 2])  # a rank's share all padding, and part of one sample
def test_kernels_at_a_data_parallel_share(cuda_device, nvalid):
    """B1 and B2 on a rank's share of a ragged last batch: nothing valid
    (an empty histogram, every label 255, zero counts and sums), or part of
    the first sample; the sums are the kernel's fixed-point total (units of
    2^-26), unrounded, in float64."""
    x = _peaked(40, cuda_device)
    thr = torch.full((C,), 0.99, device=cuda_device)
    _check_hist(x, nvalid, 2048)
    _check_select(x, thr, nvalid)
    labels, counts, sums, _ = K.ias_select(x, thr, nvalid)
    torch.cuda.synchronize()
    assert sums.dtype == torch.float64 and torch.equal(sums, torch.round(sums * 2.0**26) / 2.0**26)
    if nvalid == 0:
        assert float(K.ias_hist(x, 0, 2048).abs().sum()) == 0.0
        assert bool((labels == 255).all()) and int(counts.abs().sum()) == 0 and float(sums.abs().sum()) == 0.0


def test_synced_batch_norm_over_nccl_at_world_1(cuda_device, tmp_path):
    """``SyncBatchNorm2d`` in a one-rank NCCL group equals ``nn.BatchNorm2d``
    on the card (inputs of mean 30): output, input and affine gradients,
    running statistics, within 1e-5 of each tensor's scale."""
    import torch.distributed as dist

    from hiast_tpu_torch.models.norm import SyncBatchNorm2d

    gen = torch.Generator().manual_seed(0)
    x = (30.0 + torch.randn(4, 64, 24, 40, generator=gen)).to(cuda_device)
    dy = torch.randn(4, 64, 24, 40, generator=gen).to(cuda_device)
    weight = (0.5 + torch.rand(64, generator=gen)).to(cuda_device)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'store'}", world_size=1, rank=0)
    try:
        out = []
        for cls in (torch.nn.BatchNorm2d, SyncBatchNorm2d):
            bn = cls(64).to(cuda_device)
            with torch.no_grad():
                bn.weight.copy_(weight)
            xi = x.clone().requires_grad_(True)
            y = bn(xi)
            (y * dy).sum().backward()
            out.append([y.detach(), xi.grad, bn.weight.grad, bn.bias.grad, bn.running_mean, bn.running_var])
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    for want, got in zip(*out):
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-5 * scale


def test_cbst_float64_sum_of_hist_kernels_matches_plain(cuda_device):
    """CBST's dataset pass: the float64 sum of several ``ias_hist`` calls (the
    last batch cut by nvalid) against the plain histograms' sum, and the
    CBST thresholds of both within one bin."""
    from hiast_tpu_torch.pseudo.policies import cbst_thresholds

    num_bins = 2048
    got = torch.zeros(C, num_bins, dtype=torch.float64, device=cuda_device)
    want = torch.zeros_like(got)
    calls = [(_peaked(20 + i, cuda_device) if i % 2 else _logits(20 + i, cuda_device), B * H * W) for i in range(3)]
    calls.append((_peaked(30, cuda_device), H * W))
    K.reset_launch_counts()
    for x, nvalid in calls:
        got += K.ias_hist(x, nvalid, num_bins)
        want += K.ias_hist_plain(x, nvalid, num_bins)
    torch.cuda.synchronize()
    assert K.launch_counts["ias_hist"] == len(calls)
    torch.testing.assert_close(got.sum(1), want.sum(1), rtol=0, atol=0)
    assert float(got.sum()) == sum(n for _, n in calls)
    assert float((got - want).abs().sum()) <= 2 * len(calls)
    thr_diff = float((cbst_thresholds(got, 0.2) - cbst_thresholds(want, 0.2)).abs().max())
    assert thr_diff <= 1.0 / num_bins


@pytest.mark.parametrize("c", [9, 19])
# every cluster size the launcher picks (1, 4, 8, 16), and at 19 x 8192 a
# 16-block cluster whose slices (38,912 B) outgrow 24 KB
@pytest.mark.parametrize("num_bins", [256, 2048, 4096, 8192])
def test_hist_kernel_cluster_sizes(cuda_device, c, num_bins):
    for x in (_peaked(7, cuda_device, c=c), _logits(8, cuda_device)[:, :c].contiguous()):
        _check_hist(x, B * H * W, num_bins)


@pytest.mark.parametrize("c", [9, 7])  # 9: the Oxford scenario's instantiation; 7: the generic one (up to 32)
@pytest.mark.parametrize("nvalid", [B * H * W, H * W + 7])
def test_kernels_match_plain_at_other_class_counts(cuda_device, c, nvalid):
    thr = torch.from_numpy(np.random.default_rng(16).uniform(0.3, 0.999, c).astype(np.float32)).to(cuda_device)
    for x in (_peaked(14, cuda_device, c=c), _logits(15, cuda_device)[:, :c].contiguous()):
        _check_hist(x, nvalid, 2048)
        _check_select(x, thr, nvalid)
        first = K.ias_select(x, thr, nvalid, with_maxprob=True)
        again = K.ias_select(x, thr, nvalid, with_maxprob=True)
        for a, b in zip(first, again):
            assert torch.equal(a, b)


@pytest.mark.parametrize("h,w", [(37, 51), (5, 3)])  # H*W odd: scalar loads and stores
def test_kernels_take_any_pixel_count(cuda_device, h, w):
    x = _peaked(9, cuda_device, h=h, w=w)
    for nvalid in (B * h * w, h * w + 1):
        _check_hist(x, nvalid, 2048)
        _check_select(x, torch.full((C,), 0.995, device=cuda_device), nvalid)


def test_kernels_take_logits_off_16_byte_alignment(cuda_device):
    base = _peaked(10, cuda_device)
    buf = torch.empty(base.numel() + 1, device=cuda_device)
    x = buf[1:].view(base.shape)  # contiguous, 4 bytes past an aligned start
    x.copy_(base)
    _check_hist(x, B * H * W, 2048)
    _check_select(x, torch.full((C,), 0.995, device=cuda_device), B * H * W)


@pytest.mark.parametrize("peaked", [False, True])
def test_select_kernel_gives_the_same_bits(cuda_device, peaked):
    x = _peaked(11, cuda_device, h=96, w=160) if peaked else _logits(12, cuda_device)
    thr = torch.from_numpy(np.random.default_rng(13).uniform(0.3, 0.999, C).astype(np.float32)).to(cuda_device)
    first = K.ias_select(x, thr, x.numel() // C, with_maxprob=True)
    for _ in range(3):
        again = K.ias_select(x, thr, x.numel() // C, with_maxprob=True)
        for a, b in zip(first, again):
            assert torch.equal(a, b)


def test_generator_on_the_card_matches_the_cpu(cuda_device, tmp_path):
    """The IAS generator on injected logits: kernels on the card, plain
    versions on the CPU.  Thresholds within one bin, labels equal but for an
    ulp-edge pixel, and one launch of each kernel per batch."""
    from hiast_tpu_torch.config import default_config
    from hiast_tpu_torch.data.png import decode_png_file
    from hiast_tpu_torch.pseudo.generator import IASGenerator

    rng = np.random.default_rng(5)
    batches = [(rng.normal(size=(B, C, H, W)) * 2.5).astype(np.float32) for _ in range(3)]
    paths = [[f"/d/img_{2 * k + i}.png" for i in range(B)] for k in range(3)]
    paths[-1] = paths[-1][:1]  # a partial tail batch: one pad sample

    def run(device, tag):
        cfg = default_config()
        cfg.pseudo_policy.type = "IAS"
        cfg.pseudo_policy.save_dir = str(tmp_path / tag / "pseudo_label" / "gray_label")
        logits = iter([torch.from_numpy(b).to(device) for b in batches])
        gen = IASGenerator(
            cfg, lambda images: next(logits),
            lambda: ({"images": np.zeros((len(p), H, W, 3), np.uint8), "image_paths": p} for p in paths),
            expected_count=5, device=device,
        )
        gen.run()
        return gen, cfg.pseudo_policy.save_dir

    K.reset_launch_counts()
    card, card_dir = run(cuda_device, "card")
    assert K.launch_counts == {"ias_hist": 3, "ias_select": 3}
    cpu, cpu_dir = run(torch.device("cpu"), "cpu")
    assert np.abs(card.class_threshold - cpu.class_threshold).max() <= 1 / 2048
    np.testing.assert_allclose(card.class_mean_probs, cpu.class_mean_probs, atol=1e-5)
    names = sorted(os.listdir(cpu_dir))
    assert sorted(os.listdir(card_dir)) == names and len(names) == 5
    differ = sum(
        int((decode_png_file(os.path.join(card_dir, n)) != decode_png_file(os.path.join(cpu_dir, n))).sum())
        for n in names
    )
    assert differ <= 2
    with open(os.path.join(os.path.dirname(card_dir), "sample_class_stats.json")) as f:
        assert [s["file"] for s in json.load(f)] == [p for batch in paths for p in batch]


def _qkv(seed, b, nq, nkv, h, d, device):
    rng = np.random.default_rng(seed)
    return tuple(
        torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(device).bfloat16()
        for s in ((b, nq, h, d), (b, nkv, h, d), (b, nkv, h, d))
    )


@pytest.mark.parametrize("b,nq,nkv,h,d", [
    (2, 4608, 1152, 1, 64),  # stage 1 of B5 at 768x1536, cut to 1/16 of its queries
    (2, 1152, 1152, 8, 64),  # stage 4 (sr 1)
    (1, 700, 96, 2, 32),     # ragged: N_q and N_kv off every tile, D = 32
    (1, 1, 1, 1, 64),        # one query, one key
])
def test_sra_attention_matches_plain(cuda_device, b, nq, nkv, h, d):
    q, k, v = _qkv(6, b, nq, nkv, h, d, cuda_device)
    A.reset_launch_counts()
    got = A.sra_attention(q, k, v)
    want = A.sra_attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert A.launch_counts["sra_attention"] == 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert float((got.float() - want.float()).abs().max()) <= 1e-2


def test_sra_attention_reads_the_kv_halves_in_place(cuda_device):
    """k and v as the model passes them: strided views of one [B, N, 2C]
    projection, read without a copy."""
    b, nq, nkv, h, d = 2, 300, 200, 5, 64
    q, _, _ = _qkv(7, b, nq, nkv, h, d, cuda_device)
    kv = torch.randn(b, nkv, 2 * h * d, device=cuda_device).bfloat16()
    k = kv[..., : h * d].reshape(b, nkv, h, d)
    v = kv[..., h * d:].reshape(b, nkv, h, d)
    got = A.sra_attention(q, k, v)
    want = A.sra_attention_plain(q, k.contiguous(), v.contiguous())
    assert float((got.float() - want.float()).abs().max()) <= 1e-2


def test_sra_attention_refuses_what_the_kernel_does_not_take(cuda_device):
    q, k, v = _qkv(8, 1, 64, 64, 2, 64, cuda_device)
    with pytest.raises(TypeError):
        A.sra_attention(q.float(), k.float(), v.float())  # the card takes bf16 only
    with pytest.raises(ValueError):
        A.sra_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))  # heads not D apart
    with pytest.raises(TypeError):  # autograd takes the same inputs as the forward
        A.sra_attention(q.float().requires_grad_(), k.float(), v.float())


def _within_bf16_grad_bound(got: torch.Tensor, want: torch.Tensor) -> bool:
    got, want = got.float(), want.float()
    return bool(((got - want).abs() <= 0.03 * want.abs().max() + 0.1 * want.abs()).all())


def test_sra_attention_saves_the_row_statistics(cuda_device):
    """Under autograd the forward writes each row's max m and sum l of the
    scaled scores; without autograd it writes none and returns the same
    output."""
    b, nq, nkv, h, d = 2, 700, 200, 2, 64
    q, k, v = _qkv(9, b, nq, nkv, h, d, cuda_device)
    out, stats = A._forward_cuda(q, k, v, with_stats=True)
    plain_out, _ = A._forward_cuda(q, k, v, with_stats=False)
    m, l = A.sra_attention_stats_plain(q, k)
    torch.cuda.synchronize()
    assert torch.equal(out, plain_out)
    torch.testing.assert_close(stats[0], m, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(stats[1], l, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,nq,nkv,h,d", [
    (6, 8192, 512, 2, 64),   # stage 2 of a B5 training step (batch 6, 512x1024)
    (6, 512, 512, 8, 64),    # stage 4
    (1, 700, 96, 2, 32),     # ragged: N_q and N_kv off every tile, D = 32
])
def test_sra_attention_backward_matches_plain(cuda_device, b, nq, nkv, h, d):
    """dq and d(kv) through the autograd Function (the kernels) against
    sra_attention_bwd_plain, with k and v the halves of one kv."""
    rng = np.random.default_rng(10)
    q = torch.from_numpy(rng.normal(size=(b, nq, h, d)).astype(np.float32)).to(cuda_device).bfloat16()
    kv = torch.from_numpy(rng.normal(size=(b, nkv, 2 * h * d)).astype(np.float32)).to(cuda_device).bfloat16()
    do = torch.from_numpy(rng.normal(size=(b, nq, h, d)).astype(np.float32)).to(cuda_device).bfloat16()
    qg, kvg = q.clone().requires_grad_(), kv.clone().requires_grad_()
    A.reset_launch_counts()
    A.sra_attention_kv(qg, kvg).backward(do)
    torch.cuda.synchronize()
    assert A.launch_counts == {"sra_attention": 1, "sra_attention_bwd": 1}
    dq, dk, dv = A.sra_attention_bwd_plain(q, *A.split_kv(kv, h), do)
    got_dk, got_dv = A.split_kv(kvg.grad, h)
    for name, got, want in (("dq", qg.grad, dq), ("dk", got_dk, dk), ("dv", got_dv, dv)):
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        assert _within_bf16_grad_bound(got, want), (name, float((got.float() - want.float()).abs().max()))


def test_sra_attention_backward_takes_a_strided_cotangent(cuda_device):
    """dO in another layout than the output's is copied into one the kernel
    reads; separate k and v get their gradients as views of one d(kv)."""
    b, nq, nkv, h, d = 1, 300, 128, 2, 64
    q, k, v = (x.requires_grad_() for x in _qkv(11, b, nq, nkv, h, d, cuda_device))
    do = torch.randn(b, h, nq, d, device=cuda_device).bfloat16().transpose(1, 2)
    A.sra_attention(q, k, v).backward(do)
    dq, dk, dv = A.sra_attention_bwd_plain(q.detach(), k.detach(), v.detach(), do)
    for got, want in ((q.grad, dq), (k.grad, dk), (v.grad, dv)):
        assert _within_bf16_grad_bound(got, want)


def _bwd_inputs(seed, b, nq, nkv, h, d, device):
    rng = np.random.default_rng(seed)
    return tuple(
        torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(device).bfloat16()
        for s in ((b, nq, h, d), (b, nkv, 2 * h * d), (b, nq, h, d))
    )


@pytest.mark.parametrize("b,nq,nkv,h,d", [
    (1, 129, 130, 3, 64),    # N_q one past the 128-row query tile, N_kv two past the forward's 128-row K/V tile
    (2, 200, 65, 2, 32),     # D = 32; N_kv one past the backward's 64-row tile
    (150, 256, 64, 2, 64),   # B*H 300: 600 forward items, so the persistent grid wraps on 132 SMs
    (65535, 2, 3, 1, 32),    # the largest B*H the kernels take
])
def test_sra_attention_crosses_the_tile_edges(cuda_device, b, nq, nkv, h, d):
    """The forward, its row statistics and the backward at the edges of the
    wgmma design's tiles and of its persistent grid."""
    q, kv, do = _bwd_inputs(12, b, nq, nkv, h, d, cuda_device)
    k, v = A.split_kv(kv, h)
    out, stats = A._forward_cuda(q, k, v, with_stats=True)
    want = A.sra_attention_plain(q, k, v)
    m, lsum = A.sra_attention_stats_plain(q, k)
    torch.cuda.synchronize()
    assert float((out.float() - want.float()).abs().max()) <= 1e-2
    torch.testing.assert_close(stats[0], m, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(stats[1], lsum, rtol=1e-5, atol=1e-5)
    dkv = torch.empty_like(kv)
    dk, dv = A.split_kv(dkv, h)
    dq = A._backward_cuda(q, k, v, out, stats, do, dk, dv)
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), A.sra_attention_bwd_plain(q, k, v, do)):
        assert _within_bf16_grad_bound(got, ref), (name, float((got.float() - ref.float()).abs().max()))


@pytest.mark.parametrize("b,nq,nkv,h,chunks", [
    (2, 4096, 512, 1, True),    # 16 K/V tiles of 64 rows for 132 SMs: f32 chunk partials and their sum
    (6, 1024, 512, 5, False),   # 240 tiles: dK and dV written straight into d(kv)
])
def test_sra_attention_backward_chunked_and_direct(cuda_device, b, nq, nkv, h, chunks):
    """The dK/dV kernel on both sides of the chunking rule."""
    n_sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert (A.tiles_per_chunk(b * h, nq, nkv, n_sms) < -(-nq // A.TILE)) == chunks
    q, kv, do = _bwd_inputs(13, b, nq, nkv, h, 64, cuda_device)
    qg, kvg = q.clone().requires_grad_(), kv.clone().requires_grad_()
    A.sra_attention_kv(qg, kvg).backward(do)
    dq, dk, dv = A.sra_attention_bwd_plain(q, *A.split_kv(kv, h), do)
    got_dk, got_dv = A.split_kv(kvg.grad, h)
    for name, got, want in (("dq", qg.grad, dq), ("dk", got_dk, dk), ("dv", got_dv, dv)):
        assert _within_bf16_grad_bound(got, want), (name, float((got.float() - want.float()).abs().max()))


@pytest.mark.parametrize("b,nq,nkv,h", [(6, 8192, 512, 2), (6, 2048, 512, 5)])  # chunked, direct
def test_sra_attention_backward_gives_the_same_bits(cuda_device, b, nq, nkv, h):
    """Two backward calls on the same inputs: identical dq and d(kv)."""
    q, kv, do = _bwd_inputs(14, b, nq, nkv, h, 64, cuda_device)
    k, v = A.split_kv(kv, h)
    out, stats = A._forward_cuda(q, k, v, with_stats=True)
    grads = []
    for _ in range(2):
        dkv = torch.empty_like(kv)
        dq = A._backward_cuda(q, k, v, out, stats, do, *A.split_kv(dkv, h))
        grads.append((dq, dkv))
    torch.cuda.synchronize()
    assert torch.equal(grads[0][0], grads[1][0]) and torch.equal(grads[0][1], grads[1][1])


@pytest.mark.parametrize("kind", ["CCA", "SCA"])
def test_color_aug_on_the_card_matches_the_cpu(cuda_device, kind):
    """The strong view in bf16 on the card against the same draws on the CPU,
    within the JAX package's bf16 bounds (mean below 1.5 levels, the 99th
    percentile below 16): bf16 rounds the sums of the gray, mean and blur
    in other orders, which flips a few pixels at posterize, equalize and
    solarize edges."""
    from hiast_tpu_torch.ops import color_aug as P

    imgs = torch.from_numpy(np.random.default_rng(3).integers(0, 256, size=(6, 128, 256, 3)).astype(np.uint8))
    draws = P.draw_color_aug(6, kind, torch.Generator(cuda_device).manual_seed(0))
    draws.gates[:] = True  # every transform
    cpu = P.ColorAugDraws(**{k: (v.cpu() if torch.is_tensor(v) else v) for k, v in vars(draws).items()})
    got = P.apply_color_aug(imgs.to(cuda_device), draws, torch.bfloat16)
    want = P.apply_color_aug(imgs, cpu, torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.device.type == "cuda"
    diff = (got.float().cpu() - want.float()).abs()
    assert float(diff.mean()) < 1.5 and float(torch.quantile(diff.flatten(), 0.99)) < 16.0


def test_registered_op_runs_the_kernel(cuda_device):
    """``torch.ops.hiast_tpu_torch.sra_attention_kv``, the serving path's and
    the exported program's entry: the forward kernel on the card, one launch,
    against the plain version; it raises where the kernel does not take a
    tensor, as the wrapper does."""
    b, nq, nkv, h, d = 2, 1200, 288, 5, 64
    q, _, _ = _qkv(10, b, nq, nkv, h, d, cuda_device)
    kv = torch.randn(b, nkv, 2 * h * d, device=cuda_device).bfloat16()
    A.reset_launch_counts()
    got = torch.ops.hiast_tpu_torch.sra_attention_kv(q, kv)
    want = A.sra_attention_kv_plain(q, kv)
    torch.cuda.synchronize()
    assert A.launch_counts == {"sra_attention": 1, "sra_attention_bwd": 0}
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert float((got.float() - want.float()).abs().max()) <= 1e-2
    with pytest.raises(TypeError):
        torch.ops.hiast_tpu_torch.sra_attention_kv(q.float(), kv.float())
    with pytest.raises(ValueError):
        torch.ops.hiast_tpu_torch.sra_attention_kv(q.transpose(1, 2), kv)


def _b0_step(mode, cuda_device):
    """One bf16 self-training step of a seeded SegFormer-B0 on the card,
    with ``runtime.remat_mode`` ``mode`` (None: remat off): its losses,
    gradients and launch counts."""
    from hiast_tpu_torch.config import default_config
    from hiast_tpu_torch.models.segmentors import build_segmentor
    from hiast_tpu_torch.registry import populate
    from hiast_tpu_torch.selftrain.steps import StepCount, make_self_training_step
    from hiast_tpu_torch.selftrain.train_state import lr_schedule, make_optimizer

    populate()
    cfg = default_config()
    cfg.model.type = "SelfTrainingSegmentor"
    cfg.model.seg_model.type = "SegFormer_B0"
    cfg.model.is_freeze_bn = False
    cfg.runtime.remat = mode is not None
    cfg.runtime.remat_mode = mode or "full"
    segmentor = build_segmentor(cfg)
    segmentor.module.init_weights(torch.Generator().manual_seed(0))
    segmentor.module.to(cuda_device)
    step = make_self_training_step(segmentor, make_optimizer(cfg, segmentor.module), lr_schedule(cfg))
    rng = np.random.default_rng(11)
    batch = {"t_img": torch.from_numpy(rng.integers(0, 256, size=(2, 256, 512, 3), dtype=np.uint8)),
             "t_plbl": torch.from_numpy(rng.integers(0, 19, size=(2, 256, 512)).astype(np.uint8))}
    A.reset_launch_counts()
    losses = step({k: v.to(cuda_device) for k, v in batch.items()}, StepCount())
    torch.cuda.synchronize()
    grads = {n: p.grad.float().clone() for n, p in segmentor.module.named_parameters() if p.grad is not None}
    return {k: float(v) for k, v in losses.items()}, grads, dict(A.launch_counts)


def test_blocks_remat_step_equals_the_step_without(cuda_device):
    """Under 'blocks' the backward reruns each of B0's 8 blocks, so the
    forward kernel launches twice per block and the backward kernels once;
    the rerun repeats the same kernels on the same inputs: losses within
    1e-5 relative, each gradient's cosine with the step without remat at
    least 0.9999 (some of cuDNN's backward kernels sum in no fixed order).
    The biases whose gradient is zero in exact arithmetic are left out:
    norm4's and the head's linear_c* biases add a per-channel constant that
    the head's train-mode BatchNorm subtracts again, so both steps hold
    rounding noise there (tests/test_torch_train_step.py)."""
    want_losses, want_grads, want_counts = _b0_step(None, cuda_device)
    losses, grads, counts = _b0_step("blocks", cuda_device)
    assert want_counts == {"sra_attention": 8, "sra_attention_bwd": 8}
    assert counts == {"sra_attention": 16, "sra_attention_bwd": 8}
    for name, value in want_losses.items():
        assert abs(losses[name] - value) <= 1e-5 * abs(value), name
    assert sorted(grads) == sorted(want_grads)
    zero = [n for n in want_grads if n == "backbone.norm4.bias"
            or (n.startswith("decode_head.linear_c") and n.endswith(".bias"))]
    assert len(zero) == 5
    cosines = {name: float(torch.nn.functional.cosine_similarity(grads[name].flatten(), g.flatten(), dim=0))
               for name, g in want_grads.items() if name not in zero}
    low = {name: cos for name, cos in cosines.items() if cos < 0.9999}
    assert not low, f"gradients off the step without remat: {low}"


def test_b0_export_round_trip(cuda_device, tmp_path):
    """A SegFormer-B0 program exported on the card, saved and loaded back:
    at batch 1 and 2 it launches the forward kernel once per block and
    equals the live eval forward within 2e-2 of the logits' scale (JAX's
    export tolerance), with argmax agreement at least 0.999."""
    from hiast_tpu_torch.cli import export_model
    from hiast_tpu_torch.cli.common import build_cfg, standard_parser
    from hiast_tpu_torch.models.segmentors import build_segmentor
    from hiast_tpu_torch.selftrain.steps import make_eval_forward

    h, w = 128, 256
    opts = ["model.type", "SourceOnlySegmentor", "model.seg_model.type", "SegFormer_B0"]
    path = str(tmp_path / "b0.pt2")
    export_model.main(["--device", "cuda", "--output", path, "--height", str(h), "--width", str(w), *opts])
    program = export_model.load_exported(path).module()
    segmentor = build_segmentor(build_cfg(standard_parser("t").parse_args(opts)))
    segmentor.module.init_weights(torch.Generator().manual_seed(export_model.INIT_SEED))
    segmentor.module.to(cuda_device).eval()
    eval_fwd = make_eval_forward(segmentor)
    for b in (1, 2):
        img = torch.from_numpy(np.random.default_rng(b).integers(0, 256, size=(b, h, w, 3), dtype=np.uint8))
        img = img.to(cuda_device)
        A.reset_launch_counts()
        got = program(img)
        torch.cuda.synchronize()
        assert A.launch_counts["sra_attention"] == 8
        want = eval_fwd(img).permute(0, 2, 3, 1)
        assert got.shape == (b, h, w, 19) and got.dtype == torch.float32
        assert float((got - want).abs().max()) <= 2e-2 * float(want.abs().max())
        assert float((got.argmax(-1) == want.argmax(-1)).float().mean()) >= 0.999
