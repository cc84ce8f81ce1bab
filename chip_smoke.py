#!/usr/bin/env python3
"""Smoke run of the PyTorch port (hiast_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py [--profile]

1. Prints the card's name and power limit, then builds every CUDA kernel of
   the port from hiast_tpu_torch/csrc/ with nvcc (sm_90a), one nvcc per
   source, all started together.
2. IAS kernel phase: holds ``ias_hist`` and ``ias_select`` against their
   plain PyTorch versions on seeded logits at the main path's shapes
   ([2, 19, 768, 1536] float32; the [2, 19, 96, 192] OS8 grid for the
   histogram too), with and without the second sample cut off by ``nvalid``,
   and times each (median of 20 runs, CUDA events) beside its plain version
   and its memory bound.
3. DeepLab slice: writes 4 synthetic 768x1536 target images, runs IAS
   pseudo-label generation through the port's CLI ``main`` on full-width
   DeepLab-v2/ResNet-101 (random weights from a seed, batch 2, 2048 bins,
   stats_source full), checks the six artifacts and that each kernel was
   launched once per batch, and reports images per second.
4. SRA attention kernel phase: holds ``sra_attention`` against
   ``sra_attention_plain`` on seeded bf16 q, k, v at the four MiT-B5 stage
   shapes of a 768x1536 batch of 2 (B*H, N_q, N_kv = (2, 73728, 1152),
   (4, 18432, 1152), (10, 4608, 1152), (16, 1152, 1152); k and v are the two
   halves of one kv projection, as the model passes them) and a ragged case
   (N_q 700, N_kv 96, H 2, D 32), and times the kernel, the plain version and
   ``scaled_dot_product_attention`` (the yardstick; the port never calls it)
   beside the bound.
5. SegFormer-B5 slice: saves seeded random B5 weights as a mmseg-layout
   ``.pth``, runs IAS generation through the CLI on the same 4 images
   (``--pseudo_resume_from``, batch 2) and checks the six artifacts and the
   launches (ias_hist 2, ias_select 2, sra_attention 104 = 52 blocks x 2
   batches); then writes 4 synthetic 1024x2048 val images with labels and
   runs ``cli.validate.main`` at resize 768x1536, batch 2, no flip, and
   checks the mIoU and the 104 launches.  Each reports images per second.
   Before the CLIs, the B5 forward with the kernel is held against float32
   as closely as the plain bf16 forward is (``check_b5_forward``).
   ``--profile`` adds, for the DeepLab and both B5 runs, a torch.profiler
   breakdown by CUDA kernel, the device's idle share, the forward's FLOPs
   and the host's PNG costs.
6. Prints one JSON line of the kernels, the card line again, and last
   ``{"ok": true, "device": {...}}``.  A kernel's ``launches`` are those of
   the SegFormer-B5 generation run (the path that runs all three).  For
   ``sra_attention`` the times are per batch of the main path: each stage's
   time times its launches per forward (3, 6, 40, 3), summed.

Any failed check raises, so the script exits non-zero and prints no ok
line.  Without a CUDA device it exits with code 2 before doing anything.
Tolerances (the kernels and the plain versions round exp/log differently by
an ulp or two, and float atomics add in no fixed order):
  ias_hist   row sums exact; bin-level L1 <= max(2, 1e-4 * N) (pixels within
             an ulp of a bin edge may move); the IAS thresholds computed from
             the two histograms agree within 1/num_bins.
  ias_select labels equal except at most 1e-4 * N pixels, each within 1e-6 of
             its threshold; per-sample counts differ by at most the number of
             such pixels; per-class confidence sums agree to rtol 1e-4 plus
             one unit per differing pixel.
  sra_attention  max |diff| <= 1e-2 on bf16 outputs of magnitude ~1: both
             round P to bf16 after the f32 softmax, from f32 scores summed in
             another order, and round O to bf16 once (one bf16 ulp at 1 is
             2^-7; the JAX bf16 test allows 2e-2).  The mean |diff| is printed.
"""
from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
B, C, H, W = 2, 19, 768, 1536
LOW_H, LOW_W = 96, 192
NUM_BINS = 2048
N_IMAGES = 4
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor cores
MUFU_EXP_PER_SM_CLOCK = 16  # exponentials per SM per clock (special function units)
N_SMS = 132
VAL_H, VAL_W = 1024, 2048
B5_DEPTHS = (3, 6, 40, 3)
# (name, B, N_q, N_kv, H, D): the MiT-B5 stages at 768x1536, batch 2, and a ragged case
ATTN_SHAPES = (
    ("stage1", B, (H // 4) * (W // 4), (H // 32) * (W // 32), 1, 64),
    ("stage2", B, (H // 8) * (W // 8), (H // 32) * (W // 32), 2, 64),
    ("stage3", B, (H // 16) * (W // 16), (H // 32) * (W // 32), 5, 64),
    ("stage4", B, (H // 32) * (W // 32), (H // 32) * (W // 32), 8, 64),
    ("ragged", 1, 700, 96, 2, 32),
)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def sm_clock_hz() -> float:
    """The card's highest SM clock, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    )
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def reset_counts() -> None:
    from hiast_tpu_torch.ops.cuda import attention, select_kernel

    select_kernel.reset_launch_counts()
    attention.reset_launch_counts()


def read_counts() -> dict:
    from hiast_tpu_torch.ops.cuda import attention, select_kernel

    return {**select_kernel.launch_counts, **attention.launch_counts}


def device_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of fn() in ms.  A spin kernel queued before each
    run keeps the card busy while the host enqueues fn's launches, so the
    events time the device work only."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(5_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(bytes_moved: float, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def kernel_phase(torch):
    from hiast_tpu_torch.ops.cuda.select_kernel import (
        ias_hist, ias_hist_plain, ias_select, ias_select_plain,
    )
    from hiast_tpu_torch.pseudo import policies as P

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    full = torch.from_numpy(rng.standard_normal((B, C, H, W), dtype=np.float32) * 3).to(dev)
    low = torch.from_numpy(rng.standard_normal((B, C, LOW_H, LOW_W), dtype=np.float32) * 3).to(dev)
    hw, n = H * W, B * H * W
    state = P.IASState(
        torch.full((C,), 0.9, dtype=torch.float32, device=dev),
        torch.zeros(C, dtype=torch.float32, device=dev),
    )
    results = {}

    # -- ias_hist ---------------------------------------------------------
    hist_err, thr_main = 0.0, None
    for label, logits, nvalid in (
        ("full", full, n), ("full, 2nd sample cut", full, hw), ("low", low, B * LOW_H * LOW_W),
    ):
        got = ias_hist(logits, nvalid, NUM_BINS)
        want = ias_hist_plain(logits, nvalid, NUM_BINS)
        torch.cuda.synchronize()
        check(torch.equal(got.sum(1), want.sum(1)), f"ias_hist {label}: row sums differ")
        check(float(got.sum()) == min(nvalid, logits.numel() // C), f"ias_hist {label}: total")
        l1 = float((got - want).abs().sum())
        check(l1 <= max(2.0, 1e-4 * nvalid), f"ias_hist {label}: bin L1 {l1}")
        thr_got = P.ias_update(state, got, 0.2, 0.9, 8.0)
        thr_want = P.ias_update(state, want, 0.2, 0.9, 8.0)
        thr_diff = float((thr_got - thr_want).abs().max())
        check(thr_diff <= 1.0 / NUM_BINS, f"ias_hist {label}: threshold diff {thr_diff}")
        hist_err = max(hist_err, float((got - want).abs().max()))
        print(f"ias_hist   [{label}] nvalid={nvalid} bin L1={l1:g} threshold diff={thr_diff:g}")
        if label == "full":
            thr_main = thr_want

    ms = device_ms(torch, lambda: ias_hist(full, n, NUM_BINS))
    plain = device_ms(torch, lambda: ias_hist_plain(full, n, NUM_BINS))
    b_ms, b_by = bound_ms(n * C * 4 + C * NUM_BINS * 4, n * C * 4.0)
    low_n = B * LOW_H * LOW_W
    low_ms = device_ms(torch, lambda: ias_hist(low, low_n, NUM_BINS))
    low_bound, _ = bound_ms(low_n * C * 4 + C * NUM_BINS * 4, low_n * C * 4.0)
    print(f"ias_hist   [full] {ms:.4f} ms, plain {plain:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    print(f"ias_hist   [low]  {low_ms:.4f} ms, bound {low_bound:.4f} ms")
    results["ias_hist"] = dict(max_abs_err=hist_err, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by)

    # -- ias_select -------------------------------------------------------
    sel_err = 0.0
    for label, nvalid in (("full", n), ("full, 2nd sample cut", hw)):
        lab, cnt, sums, _ = ias_select(full, thr_main, nvalid)
        lab_p, cnt_p, sums_p, maxprob = ias_select_plain(full, thr_main, nvalid, with_maxprob=True)
        torch.cuda.synchronize()
        _, pred = P.confidences(full)
        differ = lab != lab_p
        n_diff = int(differ.sum())
        near = (maxprob - thr_main[pred]).abs() <= 1e-6
        check(n_diff <= 1e-4 * n, f"ias_select {label}: {n_diff} labels differ")
        check(not bool((differ & ~near).any()), f"ias_select {label}: a label differs away from its threshold")
        cnt_diff = int((cnt - cnt_p).abs().sum())
        check(cnt_diff <= n_diff, f"ias_select {label}: counts differ by {cnt_diff}")
        if nvalid == hw:
            check(int(cnt[1:].sum()) == 0 and bool((lab[1:] == 255).all()),
                  f"ias_select {label}: the cut sample was selected")
        err = float((sums - sums_p).abs().max())
        check(bool(((sums - sums_p).abs() <= 1e-4 * sums_p.abs() + n_diff).all()), f"ias_select {label}: sums")
        sel_err = max(sel_err, err)
        print(f"ias_select [{label}] nvalid={nvalid} labels differing={n_diff} count diff={cnt_diff} sums max err={err:g}")

    ms = device_ms(torch, lambda: ias_select(full, thr_main, n))
    plain = device_ms(torch, lambda: ias_select_plain(full, thr_main, n))
    b_ms, b_by = bound_ms(n * C * 4 + C * 4 + n + B * C * 4 + C * 4, n * C * 4.0)
    print(f"ias_select [full] {ms:.4f} ms, plain {plain:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    results["ias_select"] = dict(max_abs_err=sel_err, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by)
    del full, low
    torch.cuda.empty_cache()
    return results


def write_target_set(root: str) -> tuple[str, str]:
    from hiast_tpu_torch.data.png import write_png

    rng = np.random.default_rng(1)
    img_dir = os.path.join(root, "city", "images")
    os.makedirs(img_dir)
    manifest = []
    yy, xx = np.mgrid[0:H, 0:W]
    for i in range(N_IMAGES):
        # smooth colour fields plus noise: deflates like a photo, not like noise
        base = np.stack([(xx * (i + 1) // 7) % 256, (yy * 3 // (i + 2)) % 256, (xx + yy) // 9 % 256], -1)
        img = (base + rng.integers(0, 32, size=(H, W, 3))).clip(0, 255).astype(np.uint8)
        lbl = ((xx // 96 + yy // 96 + i) % C).astype(np.uint8)
        write_png(os.path.join(img_dir, f"t_{i}.png"), img)
        write_png(os.path.join(img_dir, f"t_{i}_lbl.png"), lbl)
        manifest.append({"image_name": f"images/t_{i}.png", "mask_name": f"images/t_{i}_lbl.png"})
    json_path = os.path.join(root, "target.json")
    with open(json_path, "w") as f:
        json.dump(manifest, f)
    return json_path, os.path.join(root, "city")


def check_artifacts(save_dir: str) -> None:
    from hiast_tpu_torch.data.png import decode_png_file

    names = sorted(os.listdir(save_dir))
    check(names == [f"t_{i}_pseudo_label.png" for i in range(N_IMAGES)], f"label files {names}")
    for name in names:
        lbl = decode_png_file(os.path.join(save_dir, name))
        check(lbl is not None and lbl.shape == (H, W) and lbl.dtype == np.uint8, f"{name} shape")
        check(bool(np.all((lbl < C) | (lbl == 255))), f"{name} values")
    stats = os.path.dirname(save_dir)
    thr = np.load(os.path.join(stats, "class_threshold.npy"))
    check(thr.shape == (C,) and np.all(np.isfinite(thr)) and np.all((thr > 0) & (thr <= 0.999)),
          f"class_threshold {thr}")
    statics = np.load(os.path.join(stats, "statics_class.npy"))
    check(statics.shape == (C,) and statics.min() >= 0, "statics_class")
    cmp = np.load(os.path.join(stats, "class_mean_probabilities.npy"))
    check(cmp.shape == (C,) and np.all(np.isfinite(cmp)) and np.all((cmp >= 0) & (cmp <= 1)),
          "class_mean_probabilities")
    with open(os.path.join(stats, "sample_class_stats.json")) as f:
        sample_stats = json.load(f)
    check(len(sample_stats) == N_IMAGES, "sample_class_stats.json")
    check(sum(v for s in sample_stats for k, v in s.items() if k != "file") == int(statics.sum()),
          "sample_class_stats.json totals")
    with open(os.path.join(stats, "samples_with_class.json")) as f:
        check(sorted(json.load(f)) == sorted(str(c) for c in range(C)), "samples_with_class.json")


def generation_run(torch, work: str, tag: str, json_path: str, image_dir: str,
                   model_argv: list, expected: dict) -> tuple[float, dict]:
    """One generation through the CLI; returns (seconds of the generator's
    batch loop, launch counts of this run)."""
    from hiast_tpu_torch.cli import generate_pseudo_labels as cli

    save_dir = os.path.join(work, tag, "pseudo_label", "gray_label")
    options, overrides = model_argv
    argv = [
        "--device", "cuda", "--pseudo_save_dir", save_dir, *options,
        "model.type", "SelfTrainingSegmentor",
        *overrides,
        "dataset.num_classes", str(C),
        "dataset.target.type", "Cityscapes",
        "dataset.target.json_path", json_path,
        "dataset.target.image_dir", image_dir,
        "pseudo_policy.type", "IAS",
        "pseudo_policy.batch_size", str(B),
        "pseudo_policy.resize_size", f"[{H}, {W}]",
        "pseudo_policy.num_hist_bins", str(NUM_BINS),
        "pseudo_policy.stats_source", "full",
    ]
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    generator = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    check(counts == expected, f"generation [{tag}] launch counts {counts}, expected {expected}")
    check_artifacts(save_dir)
    loop = generator.run_seconds
    print(f"generation [{tag}] {N_IMAGES} images: main {wall:.3f} s, batch loop "
          f"{loop:.3f} s ({N_IMAGES / loop:.3f} images/s), launches {counts}")
    return loop, counts


def slice_phase(torch, work: str, profile: bool) -> float:
    """DeepLab-v2/R101 generation, cold then warm; returns warm images/s."""
    json_path, image_dir = write_target_set(work)
    n_batches = -(-N_IMAGES // B)
    expected = {"ias_hist": n_batches, "ias_select": n_batches, "sra_attention": 0}
    model_argv = ([], ["model.seg_model.type", "DeepLab_V2", "model.seg_model.backbone_layers", "[3, 4, 23, 3]"])

    def run(tag: str):
        return generation_run(torch, work, tag, json_path, image_dir, model_argv, expected)

    run("cold")
    loop, _ = run("warm")
    if profile:
        profile_run(torch, "DeepLab generation", lambda: run("profiled")[0])
        print_flops(forward_flops(torch, "DeepLab_V2"), "DeepLab-v2/R101")
        host_costs(os.path.join(image_dir, "images", "t_0.png"))
    return N_IMAGES / loop


def attention_phase(torch, clock_hz: float) -> dict:
    """sra_attention against its plain version and SDPA at the B5 stage
    shapes; returns its JSON row's numbers, per batch of the main path."""
    import torch.nn.functional as F

    from hiast_tpu_torch.ops.cuda.attention import sra_attention, sra_attention_plain

    dev = torch.device("cuda")
    rng = np.random.default_rng(2)
    row = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    t_bytes_sum = t_ops_sum = 0.0
    for (name, b, nq, nkv, h, d), depth in zip(ATTN_SHAPES, B5_DEPTHS + (0,)):
        q = torch.from_numpy(rng.standard_normal((b, nq, h, d), dtype=np.float32)).to(dev).bfloat16()
        # k and v: the two halves of one kv projection, as the model passes them
        kv = torch.from_numpy(rng.standard_normal((b, nkv, 2 * h * d), dtype=np.float32)).to(dev).bfloat16()
        k = kv[..., : h * d].reshape(b, nkv, h, d)
        v = kv[..., h * d:].reshape(b, nkv, h, d)
        got = sra_attention(q, k, v)
        want = sra_attention_plain(q, k, v)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        err, mean_err = float(diff.max()), float(diff.mean())
        check(bool(torch.isfinite(got).all()) and err <= 1e-2, f"sra_attention [{name}]: max |diff| {err}")
        row["max_abs_err"] = max(row["max_abs_err"], err)
        qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))  # SDPA's [B, H, N, D]
        ms = device_ms(torch, lambda: sra_attention(q, k, v))
        plain = device_ms(torch, lambda: sra_attention_plain(q, k, v), reps=5)
        lib = device_ms(torch, lambda: F.scaled_dot_product_attention(qh, kh, vh))
        bh = b * h
        t_bytes = 4 * bh * (nq + nkv) * d / HBM_BYTES_PER_S  # q, k, v read and o written once, bf16
        t_mma = 4 * bh * nq * nkv * d / BF16_FLOPS_PER_S
        t_exp = bh * nq * nkv / (MUFU_EXP_PER_SM_CLOCK * N_SMS * clock_hz)
        bound = max(t_bytes, t_mma, t_exp) * 1e3
        print(f"sra_attention [{name}] B*H={bh} N_q={nq} N_kv={nkv} D={d}: max |diff| {err:.4g}, "
              f"mean |diff| {mean_err:.4g}; {ms:.4f} ms, plain {plain:.4f} ms, sdpa {lib:.4f} ms, "
              f"bound {bound:.4f} ms (bytes {t_bytes * 1e3:.4f}, matmul {t_mma * 1e3:.4f}, "
              f"exp {t_exp * 1e3:.4f}); {depth} launches per forward")
        for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib), ("bound_ms", bound)):
            row[key] += depth * val
        t_bytes_sum += depth * t_bytes
        t_ops_sum += depth * max(t_mma, t_exp)
        del q, kv, k, v, got, want, diff, qh, kh, vh
        torch.cuda.empty_cache()
    row["bound_by"] = "bytes" if t_bytes_sum >= t_ops_sum else "operations"
    print(f"sra_attention per batch ({B}x{H}x{W}, {sum(B5_DEPTHS)} launches): {row['ms']:.4f} ms, "
          f"plain {row['plain_ms']:.4f} ms, sdpa {row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']}; SM clock {clock_hz / 1e6:.0f} MHz)")
    return row


def check_b5_forward(torch, pth: str) -> None:
    """The B5 forward at 256x512 on the card in bf16 with the kernel, and
    with the plain attention, each against the float32 forward (plain
    attention, no autocast).  The 52 random-weight blocks amplify one-ulp
    differences in P, so the two bf16 forwards differ at a few near-tie
    pixels (measured: 0.991 argmax agreement).  The check is that the
    kernel's forward is as close to float32 as the plain bf16 forward (its
    argmax agreement with float32 at most 0.005 lower, logits finite)."""
    from hiast_tpu_torch.models import segformer
    from hiast_tpu_torch.ops.cuda.attention import sra_attention_plain

    model = segformer.SegFormer(num_classes=C, variant="B5")
    model.load_state_dict(torch.load(pth, map_location="cpu", weights_only=True))
    model = model.cuda().eval()
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 3, 256, 512), dtype=np.float32)).cuda()
    with torch.inference_mode():
        with torch.autocast("cuda", dtype=torch.bfloat16):
            got = model(x)["logits"].float()
        kernel = segformer.sra_attention
        segformer.sra_attention = sra_attention_plain
        try:
            with torch.autocast("cuda", dtype=torch.bfloat16):
                plain = model(x)["logits"].float()
            ref = model(x)["logits"]
        finally:
            segformer.sra_attention = kernel

    def agreement(a, b) -> float:
        return float((a.argmax(1) == b.argmax(1)).float().mean())

    check(bool(torch.isfinite(got).all()) and tuple(got.shape) == (2, C, 64, 128), "B5 logits")
    agree_kernel, agree_plain = agreement(got, ref), agreement(plain, ref)
    check(agree_kernel >= agree_plain - 0.005,
          f"B5 forward: argmax agreement with float32 {agree_kernel:.4f} (kernel) vs {agree_plain:.4f} (plain)")
    print(f"B5 forward 256x512 (logit std {float(ref.std()):.3f}): argmax agreement with float32: "
          f"kernel {agree_kernel:.5f}, plain attention {agree_plain:.5f}; kernel vs plain "
          f"{agreement(got, plain):.5f}; max |logit diff| to float32: kernel "
          f"{float((got - ref).abs().max()):.4g}, plain {float((plain - ref).abs().max()):.4g}")
    del model
    torch.cuda.empty_cache()


def write_val_set(root: str) -> tuple[str, str]:
    from hiast_tpu_torch.data.png import write_png

    rng = np.random.default_rng(4)
    img_dir = os.path.join(root, "val", "images")
    os.makedirs(img_dir)
    manifest = []
    yy, xx = np.mgrid[0:VAL_H, 0:VAL_W]
    for i in range(N_IMAGES):
        base = np.stack([(xx * (i + 2) // 9) % 256, (yy * 5 // (i + 3)) % 256, (xx + 2 * yy) // 11 % 256], -1)
        img = (base + rng.integers(0, 32, size=(VAL_H, VAL_W, 3))).clip(0, 255).astype(np.uint8)
        lbl = ((xx // 128 + yy // 128 + i) % C).astype(np.uint8)
        lbl[: VAL_H // 8] = 255  # an ignored band, as Cityscapes' ego vehicle
        write_png(os.path.join(img_dir, f"v_{i}.png"), img)
        write_png(os.path.join(img_dir, f"v_{i}_lbl.png"), lbl)
        manifest.append({"image_name": f"images/v_{i}.png", "mask_name": f"images/v_{i}_lbl.png"})
    json_path = os.path.join(root, "val.json")
    with open(json_path, "w") as f:
        json.dump(manifest, f)
    return json_path, os.path.join(root, "val")


def validation_run(torch, tag: str, pth: str, json_path: str, image_dir: str) -> float:
    """One validation through the CLI; returns seconds of its batch loop."""
    from hiast_tpu_torch.cli import validate as cli

    argv = [
        "--device", "cuda", "--validate_resume_from", pth,
        "model.type", "SourceOnlySegmentor",
        "model.seg_model.type", "SegFormer_B5",
        "dataset.num_classes", str(C),
        "dataset.val.type", "Cityscapes",
        "dataset.val.json_path", json_path,
        "dataset.val.image_dir", image_dir,
        "validate.resize_sizes", f"[[{H}, {W}]]",
        "validate.is_flip", "False",
        "validate.batch_size", str(B),
    ]
    reset_counts()
    torch.cuda.synchronize()
    result = cli.main(argv)
    torch.cuda.synchronize()
    counts = read_counts()
    expected = {"ias_hist": 0, "ias_select": 0, "sra_attention": sum(B5_DEPTHS) * (N_IMAGES // B)}
    check(counts == expected, f"validation [{tag}] launch counts {counts}, expected {expected}")
    iou = np.asarray(result["iou"])
    check(iou.shape == (C,) and bool(np.all(np.isfinite(iou))), f"validation [{tag}] iou {iou}")
    check(0.0 <= result["miou"] <= 1.0, f"validation [{tag}] miou {result['miou']}")
    loop = result["seconds"]
    print(f"validation [{tag}] {N_IMAGES} images {VAL_H}x{VAL_W} at {H}x{W}: miou {result['miou']:.4f}, "
          f"batch loop {loop:.3f} s ({N_IMAGES / loop:.3f} images/s), launches {counts}")
    return loop


def segformer_phase(torch, work: str, profile: bool) -> tuple[dict, float, float]:
    """SegFormer-B5 generation and validation through the CLIs; returns the
    warm generation's launch counts and the warm images/s of both."""
    from hiast_tpu_torch.models.segformer import SegFormer

    pth = os.path.join(work, "segformer_b5.pth")
    model = SegFormer(num_classes=C, variant="B5")
    model.init_weights(torch.Generator().manual_seed(0))
    torch.save(model.state_dict(), pth)  # the mmseg .pth layout
    del model
    check_b5_forward(torch, pth)

    json_path, image_dir = os.path.join(work, "target.json"), os.path.join(work, "city")
    n_batches = -(-N_IMAGES // B)
    expected = {"ias_hist": n_batches, "ias_select": n_batches, "sra_attention": sum(B5_DEPTHS) * n_batches}
    model_argv = (["--pseudo_resume_from", pth], ["model.seg_model.type", "SegFormer_B5"])
    def generate(tag: str):
        return generation_run(torch, work, tag, json_path, image_dir, model_argv, expected)

    generate("b5_cold")
    loop, counts = generate("b5_warm")

    val_json, val_dir = write_val_set(work)
    validation_run(torch, "b5_cold", pth, val_json, val_dir)
    val_loop = validation_run(torch, "b5_warm", pth, val_json, val_dir)
    if profile:
        profile_run(torch, "SegFormer-B5 generation", lambda: generate("b5_profiled")[0])
        profile_run(torch, "SegFormer-B5 validation",
                    lambda: validation_run(torch, "b5_profiled", pth, val_json, val_dir))
        print_flops(forward_flops(torch, "SegFormer_B5"), "SegFormer-B5")
        host_costs(os.path.join(val_dir, "images", "v_0.png"))
    return counts, N_IMAGES / loop, N_IMAGES / val_loop


def profile_run(torch, tag: str, run) -> None:
    """Where one warm run's device time goes: device time by CUDA kernel
    (torch.profiler) and the device's idle share of the batch loop.
    ``run()`` returns the seconds of its batch loop."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as prof

    with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        loop = run()
    events = p.key_averages()
    print(f"profile [{tag}]")
    print(events.table(sort_by="self_cuda_time_total", row_limit=25))
    on_device = [e for e in events if e.device_type == DeviceType.CUDA]
    copies = sum(e.self_device_time_total for e in on_device if e.key.startswith("Memcpy")) / 1e3
    kernels = sum(e.self_device_time_total for e in on_device) / 1e3 - copies
    # the profiler spans the whole main() (model build, weight upload); the
    # kernels inside the batch loop take at most all of it
    print(f"profile [{tag}]: over main(), device kernels {kernels:.3f} ms and copies {copies:.3f} ms; "
          f"batch loop {loop * 1e3:.3f} ms, so the device idles at least "
          f"{1 - kernels / 1e3 / loop:.3f} of the loop (the profiler slows the host)")


def forward_flops(torch, seg_model: str) -> float:
    """FLOPs of one forward of a batch of B at HxW (FlopCounterMode).  The
    counter does not see the SRA kernel, so SegFormer-B5's attention,
    4 B*H N_q N_kv D per block, is added from the stage shapes."""
    from torch.utils.flop_counter import FlopCounterMode

    from hiast_tpu_torch.models.deeplab_v2 import DeepLabV2
    from hiast_tpu_torch.models.segformer import SegFormer

    if seg_model == "DeepLab_V2":
        with torch.device("meta"):
            model = DeepLabV2(num_classes=C).eval()
            with FlopCounterMode(display=False) as flops:
                model(torch.empty(B, 3, H, W))
        return flops.get_total_flops()
    with torch.device("cuda"):
        model = SegFormer(num_classes=C, variant="B5").eval()  # uninitialised: only shapes count
    with torch.inference_mode(), torch.autocast("cuda", dtype=torch.bfloat16), \
            FlopCounterMode(display=False) as flops:
        model(torch.zeros(B, 3, H, W, device="cuda"))
    attention = sum(
        depth * 4 * b * h * nq * nkv * d
        for (_, b, nq, nkv, h, d), depth in zip(ATTN_SHAPES, B5_DEPTHS)
    )
    del model
    torch.cuda.empty_cache()
    return flops.get_total_flops() + attention


def print_flops(total: float, what: str) -> None:
    print(f"forward [{what}]: {total / 1e12:.3f} TFLOP per batch of {B} at {H}x{W} "
          f"({total / B / 1e12:.3f} per image; at the 989 TFLOP/s bf16 peak "
          f"{total / BF16_FLOPS_PER_S * 1e3:.3f} ms per batch)")


def host_costs(image_path: str) -> None:
    """Host clock: decode one input PNG, encode one label PNG."""
    from hiast_tpu_torch.data.datasets import read_rgb
    from hiast_tpu_torch.data.png import encode_png

    t0 = time.perf_counter()
    img = read_rgb(image_path)
    decode = time.perf_counter() - t0
    lbl = np.zeros(img.shape[:2], np.uint8)
    lbl[:, img.shape[1] // 2:] = 7
    t0 = time.perf_counter()
    encode_png(lbl)
    encode = time.perf_counter() - t0
    print(f"host: decode one {img.shape[0]}x{img.shape[1]} RGB PNG {decode * 1e3:.2f} ms, "
          f"encode one label PNG of that size {encode * 1e3:.2f} ms")


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch; nothing was run", file=sys.stderr)
        return 2
    profile = "--profile" in argv
    card = card_line()
    clock_hz = sm_clock_hz()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    from hiast_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    libs = build.build(build.source_names())
    print(f"built {len(libs)} kernel libraries in {time.perf_counter() - t0:.2f} s")
    for lib in libs:
        with open(lib + ".log") as f:
            for line in f:
                if "registers" in line or "Compiling entry" in line:
                    print("  ptxas:", line.strip())

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    work = os.path.join(REPO, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    kernels = kernel_phase(torch)
    deeplab_rate = slice_phase(torch, work, profile)
    print(f"generation warm: {deeplab_rate:.3f} images/s (batch {B}, {H}x{W}, R101, on {card})")
    kernels["sra_attention"] = attention_phase(torch, clock_hz)
    counts, b5_gen_rate, b5_val_rate = segformer_phase(torch, work, profile)
    print(f"generation warm: {b5_gen_rate:.3f} images/s (batch {B}, {H}x{W}, SegFormer-B5, on {card})")
    print(f"validation warm: {b5_val_rate:.3f} images/s (batch {B}, {VAL_H}x{VAL_W} at {H}x{W}, "
          f"SegFormer-B5, no flip, on {card})")

    rows = []
    sources = {
        "ias_hist": ("hiast_tpu_torch/csrc/select_kernel.cu", "hiast_tpu/ops/pallas/select_kernel.py:172"),
        "ias_select": ("hiast_tpu_torch/csrc/select_kernel.cu", "hiast_tpu/ops/pallas/select_kernel.py:52"),
        "sra_attention": ("hiast_tpu_torch/csrc/sra_attention.cu", "hiast_tpu/ops/pallas/attention.py:113"),
    }
    for name, r in kernels.items():
        source, replaces = sources[name]
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r.get("library_ms"),
        })
    print(json.dumps({"kernels": rows}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
