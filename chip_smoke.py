#!/usr/bin/env python3
"""Smoke run of the PyTorch port (hiast_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py [--profile]

1. Prints the card's name and power limit, then builds every CUDA kernel of
   the port from hiast_tpu_torch/csrc/ with nvcc (sm_90a), one nvcc per
   source, all started together, and prints the registers and spill bytes
   of each attention kernel from the ptxas report (a spill fails the run).
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
5. SRA attention backward phase: holds the backward kernels (dq and the k/v
   halves of one d(kv), from the forward's saved row statistics) against
   ``sra_attention_bwd_plain`` on seeded bf16 inputs at the four MiT-B5
   stage shapes of a 512x1024 training batch of 6 (B*H, N_q, N_kv =
   (6, 32768, 512), (12, 8192, 512), (30, 2048, 512), (48, 512, 512)) and
   the ragged case, checks the saved statistics against their plain form,
   and times the backward, the plain backward and the backward of
   ``scaled_dot_product_attention`` (the yardstick) beside the bound, and
   the forward at these shapes with and without its statistics.  Two
   calls of the backward on the same inputs must give the same bits.  Each
   stage prints the kernel's time over SDPA's (forward and backward).
6. SegFormer-B5 slice: saves seeded random B5 weights as a mmseg-layout
   ``.pth``, runs IAS generation through the CLI on the same 4 images
   (``--pseudo_resume_from``, batch 2) and checks the six artifacts and the
   launches (ias_hist 2, ias_select 2, sra_attention 104 = 52 blocks x 2
   batches); then writes 4 synthetic 1024x2048 val images with labels and
   runs ``cli.validate.main`` at resize 768x1536, batch 2, no flip, and
   checks the mIoU and the 104 launches.  Each reports images per second.
   Before the CLIs, the B5 forward with the kernel is held against float32
   as closely as the plain bf16 forward is (``check_b5_forward``), and so
   are the B5 gradients with the kernels (``check_b5_backward``).
7. SegFormer-B5 self-training (segformer_sl_1's settings, given as
   overrides): writes 12 synthetic 1024x2048 target images, makes their
   pseudo-labels with the B5 generation CLI (768x1536), runs
   ``cli.train.main`` for 8 iterations (batch 6, 'MS' crops of 512x1024,
   AdamW 6e-6, Poly, CE + KLD + entropy) with validation on the 4 val
   images at the last, checks the losses, the launches (per step 52 of
   ``sra_attention`` and 52 of ``sra_attention_bwd``, plus the validation's
   forwards) and the checkpoint, then drives one more generation from its
   ``model_last.pth``.  Reports s/iter over the run's iterations 3-8 and,
   steady, over 8 more steps of the trainer after 4 that drain the batches
   its stream stocked ahead; images/s, peak memory and MFU at the steady
   rate (FlopCounterMode over a step's forward and backward, convolution
   backward as twice the forward, plus the attention's 4 + 8 N_q N_kv D per
   (b, h) and block, over 989 TFLOP/s).
8. Prints one JSON line of the kernels, the card line again, and last
   ``{"ok": true, "device": {...}}``.  A kernel's ``launches`` are those of
   the path it serves in this run: ``ias_hist``/``ias_select`` from the
   SegFormer-B5 generation run, ``sra_attention`` and
   ``sra_attention_bwd`` from the training run.  For ``sra_attention`` the
   times are per batch of the serving path (each stage's time times its
   launches per forward, 3, 6, 40, 3, summed), for ``sra_attention_bwd``
   per training step.

``--profile`` adds, for the DeepLab and both B5 serving runs and a short
training run, a torch.profiler breakdown by CUDA kernel, the device's idle
share, the forward's FLOPs and the host's PNG costs.

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
             Its saved row statistics m, l: rtol 1e-5.
  sra_attention_bwd  per gradient |g - r| <= 0.03 max|r| + 0.1 |r|, the JAX
             bf16 gradient test's bound (tests/test_pallas_attention.py:95):
             dS and the gradients round to bf16 at the plain version's
             places, but delta comes from the bf16 output (FlashAttention-2's
             form) and the sums run in another order.  Max and mean |diff|
             are printed.
  B5 backward  every gradient tensor's cosine similarity with float32 no
             lower with the kernels than with the plain attention, less 0.01.
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
TRAIN_B, TRAIN_H, TRAIN_W = 6, 512, 1024  # segformer_sl_1: batch 6, 'MS' crops of 512x1024
TRAIN_ITERS, N_TRAIN_IMAGES = 8, 12
# (name, B, N_q, N_kv, H, D): the MiT-B5 stages of a training step, and a ragged case
TRAIN_ATTN_SHAPES = (
    ("stage1", TRAIN_B, (TRAIN_H // 4) * (TRAIN_W // 4), (TRAIN_H // 32) * (TRAIN_W // 32), 1, 64),
    ("stage2", TRAIN_B, (TRAIN_H // 8) * (TRAIN_W // 8), (TRAIN_H // 32) * (TRAIN_W // 32), 2, 64),
    ("stage3", TRAIN_B, (TRAIN_H // 16) * (TRAIN_W // 16), (TRAIN_H // 32) * (TRAIN_W // 32), 5, 64),
    ("stage4", TRAIN_B, (TRAIN_H // 32) * (TRAIN_W // 32), (TRAIN_H // 32) * (TRAIN_W // 32), 8, 64),
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


def attention_resources(log_path: str) -> list:
    """(kernel, registers at launch, spill bytes) of each SRA attention
    kernel in a library's ``-Xptxas -v`` report."""
    import re

    rows = []
    for line in open(log_path):
        entry = re.search(r"\d+(sra_attn_[a-z_]+)ILi(\d+)E", line) if "Compiling entry" in line else None
        if entry:
            rows.append([f"{entry.group(1)}<{entry.group(2)}>", None, 0])
        elif rows and "spill stores" in line:
            rows[-1][2] = sum(int(n) for n in re.findall(r"(\d+) bytes spill (?:stores|loads)", line))
        elif rows and rows[-1][1] is None and "Used" in line:
            rows[-1][1] = int(re.search(r"Used (\d+) registers", line).group(1))
    return rows


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
    expected = {"ias_hist": n_batches, "ias_select": n_batches, "sra_attention": 0, "sra_attention_bwd": 0}
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
              f"mean |diff| {mean_err:.4g}; {ms:.4f} ms, plain {plain:.4f} ms, sdpa {lib:.4f} ms "
              f"(kernel/sdpa {ms / lib:.3f}), "
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
          f"plain {row['plain_ms']:.4f} ms, sdpa {row['library_ms']:.4f} ms "
          f"(kernel/sdpa {row['ms'] / row['library_ms']:.3f}), bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']}; SM clock {clock_hz / 1e6:.0f} MHz)")
    return row


def attention_bwd_phase(torch, clock_hz: float) -> dict:
    """The backward kernels against their plain version and SDPA's backward
    at the B5 training stage shapes; returns their JSON row's numbers, per
    training step (each stage's time times its blocks: 3, 6, 40, 3)."""
    import torch.nn.functional as F

    from hiast_tpu_torch.ops.cuda import attention as A

    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    row = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    fwd_ms = fwd_stats_ms = 0.0
    t_bytes_sum = t_ops_sum = 0.0
    for (name, b, nq, nkv, h, d), depth in zip(TRAIN_ATTN_SHAPES, B5_DEPTHS + (0,)):
        def randn(*shape):
            return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev).bfloat16()

        q, kv, do = randn(b, nq, h, d), randn(b, nkv, 2 * h * d), randn(b, nq, h, d)
        k, v = A.split_kv(kv, h)
        out, stats = A._forward_cuda(q, k, v, with_stats=True)
        dkv = torch.empty_like(kv)
        dk, dv = A.split_kv(dkv, h)
        dq = A._backward_cuda(q, k, v, out, stats, do, dk, dv)
        want = A.sra_attention_bwd_plain(q, k, v, do)
        m, lsum = A.sra_attention_stats_plain(q, k)
        torch.cuda.synchronize()
        stat_err = max(float(((stats[0] - m).abs() / (m.abs() + 1e-6)).max()),
                       float(((stats[1] - lsum).abs() / lsum.abs()).max()))
        check(stat_err <= 1e-5, f"sra_attention [{name}] saved row statistics: rel err {stat_err}")
        errs = []
        for gname, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
            got, ref = got.float(), ref.float()
            diff = (got - ref).abs()
            bound = 0.03 * ref.abs().max() + 0.1 * ref.abs()
            check(bool(torch.isfinite(got).all()) and bool((diff <= bound).all()),
                  f"sra_attention_bwd [{name}] {gname}: max |diff| {float(diff.max())}, "
                  f"max|ref| {float(ref.abs().max())}")
            errs.append(f"{gname} max {float(diff.max()):.4g} mean {float(diff.mean()):.4g} "
                        f"(max|ref| {float(ref.abs().max()):.4g})")
            row["max_abs_err"] = max(row["max_abs_err"], float(diff.max()))
        dkv_again = torch.empty_like(kv)
        dq_again = A._backward_cuda(q, k, v, out, stats, do, *A.split_kv(dkv_again, h))
        torch.cuda.synchronize()
        check(torch.equal(dq, dq_again) and torch.equal(dkv, dkv_again),
              f"sra_attention_bwd [{name}]: two calls on the same inputs differ")
        del dkv_again, dq_again
        ms = device_ms(torch, lambda: A._backward_cuda(q, k, v, out, stats, do, dk, dv))
        plain = device_ms(torch, lambda: A.sra_attention_bwd_plain(q, k, v, do), reps=5)
        f_ms = device_ms(torch, lambda: A._forward_cuda(q, k, v, with_stats=False))
        fs_ms = device_ms(torch, lambda: A._forward_cuda(q, k, v, with_stats=True))
        qh, kh, vh = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))  # SDPA's [B, H, N, D]
        oh = F.scaled_dot_product_attention(qh, kh, vh)
        doh = do.transpose(1, 2).contiguous()
        lib = device_ms(torch, lambda: torch.autograd.grad(oh, (qh, kh, vh), doh, retain_graph=True))
        bh = b * h
        # q, k, v, dO read and dq, dk, dv written once, bf16
        t_bytes = 2 * bh * (3 * nq + 4 * nkv) * d / HBM_BYTES_PER_S
        t_mma = 10 * bh * nq * nkv * d / BF16_FLOPS_PER_S  # the recomputed S and four products
        t_exp = bh * nq * nkv / (MUFU_EXP_PER_SM_CLOCK * N_SMS * clock_hz)
        bound = max(t_bytes, t_mma, t_exp) * 1e3
        print(f"sra_attention_bwd [{name}] B*H={bh} N_q={nq} N_kv={nkv} D={d}: {'; '.join(errs)}; "
              f"{ms:.4f} ms, plain {plain:.4f} ms, sdpa backward {lib:.4f} ms (kernel/sdpa {ms / lib:.3f}), "
              f"bound {bound:.4f} ms (bytes {t_bytes * 1e3:.4f}, matmul {t_mma * 1e3:.4f}, exp "
              f"{t_exp * 1e3:.4f}); same bits on a second call; forward {f_ms:.4f} ms, with its statistics "
              f"{fs_ms:.4f} ms; {depth} launches per step")
        for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib), ("bound_ms", bound)):
            row[key] += depth * val
        fwd_ms += depth * f_ms
        fwd_stats_ms += depth * fs_ms
        t_bytes_sum += depth * t_bytes
        t_ops_sum += depth * max(t_mma, t_exp)
        del q, kv, do, k, v, out, stats, dkv, dk, dv, dq, want, m, lsum, qh, kh, vh, oh, doh
        torch.cuda.empty_cache()
    row["bound_by"] = "bytes" if t_bytes_sum >= t_ops_sum else "operations"
    print(f"sra_attention_bwd per training step ({TRAIN_B}x{TRAIN_H}x{TRAIN_W}, {sum(B5_DEPTHS)} launches): "
          f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, sdpa backward {row['library_ms']:.4f} ms "
          f"(kernel/sdpa {row['ms'] / row['library_ms']:.3f}), "
          f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}); the forward at these shapes "
          f"{fwd_ms:.4f} ms per step, {fwd_stats_ms:.4f} ms with its statistics")
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
    from hiast_tpu_torch.ops.cuda.attention import sra_attention_kv_plain

    model = segformer.SegFormer(num_classes=C, variant="B5")
    model.load_state_dict(torch.load(pth, map_location="cpu", weights_only=True))
    model = model.cuda().eval()
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 3, 256, 512), dtype=np.float32)).cuda()
    with torch.inference_mode():
        with torch.autocast("cuda", dtype=torch.bfloat16):
            got = model(x)["logits"].float()
        kernel = segformer.sra_attention_kv
        segformer.sra_attention_kv = sra_attention_kv_plain
        try:
            with torch.autocast("cuda", dtype=torch.bfloat16):
                plain = model(x)["logits"].float()
            ref = model(x)["logits"]
        finally:
            segformer.sra_attention_kv = kernel

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


def check_b5_backward(torch, pth: str) -> None:
    """The B5 gradients at 256x512, batch 2, train mode, of a CE loss on
    seeded labels: in bf16 with the kernels and in bf16 with the plain
    attention (autograd through its einsums), each against float32 (plain
    attention, no autocast).  Per parameter tensor, the cosine similarity
    with float32 must be no lower with the kernels than with the plain
    attention, less 0.01.  Tensors whose float32 gradient is at rounding
    level (norm below 1e-4 of the largest; biases that add a constant ahead
    of the head's train-mode BatchNorm) are left out and counted."""
    import torch.nn.functional as F

    from hiast_tpu_torch.models import segformer
    from hiast_tpu_torch.ops.cuda import attention as A
    from hiast_tpu_torch.ops.losses import cross_entropy

    model = segformer.SegFormer(num_classes=C, variant="B5")
    model.load_state_dict(torch.load(pth, map_location="cpu", weights_only=True))
    model = model.cuda().train()
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((2, 3, 256, 512), dtype=np.float32)).cuda()
    lbl = torch.from_numpy(rng.integers(0, C, size=(2, 256, 512))).cuda()

    def grads(dtype, attention):
        kernel = segformer.sra_attention_kv
        segformer.sra_attention_kv = attention
        try:
            model.zero_grad(set_to_none=True)
            with torch.autocast("cuda", dtype=torch.bfloat16, enabled=dtype == torch.bfloat16):
                logits = model(x)["logits"]
            logits = F.interpolate(logits.float(), size=x.shape[2:], mode="bilinear", align_corners=True)
            cross_entropy(logits, lbl).backward()
        finally:
            segformer.sra_attention_kv = kernel
        return {n: p.grad.float().clone() for n, p in model.named_parameters()}

    A.reset_launch_counts()
    got = grads(torch.bfloat16, A.sra_attention_kv)
    counts = dict(A.launch_counts)
    check(counts == {"sra_attention": sum(B5_DEPTHS), "sra_attention_bwd": sum(B5_DEPTHS)},
          f"B5 backward launch counts {counts}")
    plain = grads(torch.bfloat16, A.sra_attention_kv_plain)
    ref = grads(torch.float32, A.sra_attention_kv_plain)
    norms = {n: float(g.norm()) for n, g in ref.items()}
    floor = 1e-4 * max(norms.values())
    worst = (2.0, None, 0.0)
    min_kernel = min_plain = 1.0
    skipped = 0
    for n, r in ref.items():
        if norms[n] < floor:
            skipped += 1
            continue
        cos_k = float(F.cosine_similarity(got[n].flatten(), r.flatten(), dim=0))
        cos_p = float(F.cosine_similarity(plain[n].flatten(), r.flatten(), dim=0))
        min_kernel, min_plain = min(min_kernel, cos_k), min(min_plain, cos_p)
        if cos_k - cos_p < worst[0]:
            worst = (cos_k - cos_p, n, cos_k)
        check(cos_k >= cos_p - 0.01, f"B5 backward {n}: cosine with float32 {cos_k:.5f} (kernels) "
                                     f"vs {cos_p:.5f} (plain attention)")
    print(f"B5 backward 256x512 batch 2: {len(ref) - skipped} gradient tensors, lowest cosine with float32: "
          f"kernels {min_kernel:.5f}, plain attention {min_plain:.5f}; largest shortfall of the kernels "
          f"{-worst[0]:.5f} at {worst[1]} ({worst[2]:.5f}); {skipped} tensors at rounding level left out")
    del model, got, plain, ref
    torch.cuda.empty_cache()


def write_image_set(root: str, split: str, n: int, seed: int) -> tuple[str, str]:
    """n synthetic 1024x2048 images with label PNGs under <root>/<split>;
    returns (manifest path, image dir)."""
    from hiast_tpu_torch.data.png import write_png

    rng = np.random.default_rng(seed)
    img_dir = os.path.join(root, split, "images")
    os.makedirs(img_dir)
    manifest = []
    yy, xx = np.mgrid[0:VAL_H, 0:VAL_W]
    for i in range(n):
        base = np.stack([(xx * (i + 2) // 9) % 256, (yy * 5 // (i + 3)) % 256, (xx + 2 * yy) // 11 % 256], -1)
        img = (base + rng.integers(0, 32, size=(VAL_H, VAL_W, 3))).clip(0, 255).astype(np.uint8)
        lbl = ((xx // 128 + yy // 128 + i) % C).astype(np.uint8)
        lbl[: VAL_H // 8] = 255  # an ignored band, as Cityscapes' ego vehicle
        write_png(os.path.join(img_dir, f"{split}_{i}.png"), img)
        write_png(os.path.join(img_dir, f"{split}_{i}_lbl.png"), lbl)
        manifest.append({"image_name": f"images/{split}_{i}.png", "mask_name": f"images/{split}_{i}_lbl.png"})
    json_path = os.path.join(root, f"{split}.json")
    with open(json_path, "w") as f:
        json.dump(manifest, f)
    return json_path, os.path.join(root, split)


def write_val_set(root: str) -> tuple[str, str]:
    return write_image_set(root, "val", N_IMAGES, 4)


def b5_generation(torch, pth: str, save_dir: str, json_path: str, image_dir: str, n_images: int) -> dict:
    """B5 IAS generation through the CLI (768x1536, batch 2) from ``pth``
    into ``save_dir``; checks the label files and the launches."""
    from hiast_tpu_torch.cli import generate_pseudo_labels as cli
    from hiast_tpu_torch.data.png import decode_png_file

    argv = [
        "--device", "cuda", "--pseudo_resume_from", pth, "--pseudo_save_dir", save_dir,
        "model.type", "SelfTrainingSegmentor", "model.seg_model.type", "SegFormer_B5",
        "dataset.num_classes", str(C), "dataset.target.type", "Cityscapes",
        "dataset.target.json_path", json_path, "dataset.target.image_dir", image_dir,
        "pseudo_policy.type", "IAS", "pseudo_policy.batch_size", str(B),
        "pseudo_policy.resize_size", f"[{H}, {W}]", "pseudo_policy.num_hist_bins", str(NUM_BINS),
    ]
    reset_counts()
    generator = cli.main(argv)
    torch.cuda.synchronize()
    counts = read_counts()
    n_batches = -(-n_images // B)
    expected = {"ias_hist": n_batches, "ias_select": n_batches, "sra_attention": sum(B5_DEPTHS) * n_batches,
                "sra_attention_bwd": 0}
    check(counts == expected, f"generation into {save_dir}: launch counts {counts}, expected {expected}")
    names = sorted(os.listdir(save_dir))
    check(len(names) == n_images and all(n.endswith("_pseudo_label.png") for n in names), f"label files {names}")
    lbl = decode_png_file(os.path.join(save_dir, names[0]))
    check(lbl.shape == (H, W) and bool(np.all((lbl < C) | (lbl == 255))), f"{names[0]}")
    print(f"generation [{os.path.relpath(save_dir, REPO)}] {n_images} images: batch loop "
          f"{generator.run_seconds:.3f} s, launches {counts}, selected share {float((lbl < C).mean()):.3f}")
    return counts


def train_argv(work_dir: str, pseudo_dir: str, json_path: str, image_dir: str, val_json: str, val_dir: str,
               init_from: str, total_iter: int, iter_val: int) -> list:
    """cli.train arguments: hiast_tpu/configs/segformer_sl_1.yaml's settings
    as overrides (this machine reads no YAML), the data and iterations of
    this run."""
    return [
        "--device", "cuda", "--work_dir", work_dir, "--pseudo_save_dir", pseudo_dir,
        "trainer", "SelfTrainingTrainer",
        "runtime.fused_attention", "True",
        "model.type", "SelfTrainingSegmentor", "model.is_freeze_bn", "False",
        "model.seg_model.type", "SegFormer_B5",
        "model.predictor.seg_loss.type", "CE", "model.predictor.seg_loss.target_pseudo_weight", "1.0",
        "model.predictor.kld_loss.weight", "0.1", "model.predictor.ent_loss.weight", "1.0",
        "dataset.num_classes", str(C),
        "dataset.target.type", "Cityscapes", "dataset.target.json_path", json_path,
        "dataset.target.image_dir", image_dir, "dataset.target.aug_type", "['MS']",
        "dataset.val.type", "Cityscapes", "dataset.val.json_path", val_json, "dataset.val.image_dir", val_dir,
        "dataset.val.resize_size", f"[{H}, {W}]",
        "dataset.crop_size", f"[{TRAIN_H}, {TRAIN_W}]",
        "train.batch_size", str(TRAIN_B), "train.lr", "6e-6", "train.optimizer", "AdamW",
        "train.weight_decay", "0.01", "train.lr_scheduler.type", "Poly",
        "train.total_iter", str(total_iter), "train.iter_val", str(iter_val), "train.iter_report", "1",
        "train.init_from", init_from,
        "validate.batch_size", str(B),
    ]


def train_step_flops(torch, segmentor) -> float:
    """FLOPs of one training step's forward and backward at batch 6 and
    512x1024 (FlopCounterMode over the trunk, the upsample and the losses)
    plus the attention, which the counter does not see: 4 N_q N_kv D per
    (b, h) and block forward, 8 backward (the kernels' recompute left out).
    The counter's ``convolution_backward`` ignores groups in the weight
    gradient (a depthwise conv counts as dense: 256x too many at 256
    channels), so each convolution's backward is taken as twice its
    forward (input and weight gradients)."""
    from torch.utils.flop_counter import FlopCounterMode

    from hiast_tpu_torch.selftrain.steps import _total_loss

    img = torch.zeros(TRAIN_B, 3, TRAIN_H, TRAIN_W, device="cuda")
    lbl = torch.zeros(TRAIN_B, TRAIN_H, TRAIN_W, dtype=torch.long, device="cuda")
    segmentor.module.train()
    with FlopCounterMode(display=False) as flops:
        out = segmentor.forward(img, torch.bfloat16)
        _total_loss(segmentor.compute_loss(out["logits"], lbl)).backward()
    segmentor.module.zero_grad(set_to_none=True)
    by_op = flops.get_flop_counts()["Global"]
    conv = by_op.get(torch.ops.aten.convolution, 0)
    conv_backward = by_op.get(torch.ops.aten.convolution_backward, 0)
    attention = sum(
        depth * 12 * b * h * nq * nkv * d
        for (_, b, nq, nkv, h, d), depth in zip(TRAIN_ATTN_SHAPES, B5_DEPTHS)
    )
    return flops.get_total_flops() - conv_backward + 2 * conv + attention


def training_phase(torch, work: str, profile: bool) -> dict:
    """SegFormer-B5 self-training through cli.train (see the module
    docstring); returns its launch counts and rates."""
    from hiast_tpu_torch.cli import train as cli_train
    from hiast_tpu_torch.utils.checkpoint import load_train_state

    pth = os.path.join(work, "segformer_b5.pth")
    val_json, val_dir = os.path.join(work, "val.json"), os.path.join(work, "val")
    t0 = time.perf_counter()
    json_path, image_dir = write_image_set(work, "train", N_TRAIN_IMAGES, 7)
    print(f"wrote {N_TRAIN_IMAGES} target images of {VAL_H}x{VAL_W} in {time.perf_counter() - t0:.2f} s")
    pseudo_dir = os.path.join(work, "round0", "pseudo_label", "gray_label")
    b5_generation(torch, pth, pseudo_dir, json_path, image_dir, N_TRAIN_IMAGES)

    train_dir = os.path.join(work, "train_run")
    argv = train_argv(train_dir, pseudo_dir, json_path, image_dir, val_json, val_dir, pth,
                      TRAIN_ITERS, TRAIN_ITERS)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer = cli_train.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    val_batches = -(-N_IMAGES // B)
    expected = {"ias_hist": 0, "ias_select": 0,
                "sra_attention": sum(B5_DEPTHS) * (TRAIN_ITERS + val_batches),
                "sra_attention_bwd": sum(B5_DEPTHS) * TRAIN_ITERS}
    check(counts == expected, f"training launch counts {counts}, expected {expected}")
    losses = trainer.loss_log
    check(len(losses) == TRAIN_ITERS and all(np.isfinite(v) for step in losses for v in step.values())
          and sorted(losses[0]) == ["ent_ignored_loss", "kld_confident_loss", "target_seg_loss"],
          f"training losses {losses}")
    ckpt = os.path.join(train_dir, "checkpoints", "model_last.pth")
    state = load_train_state(ckpt)
    check(state is not None and state["step"] == TRAIN_ITERS, f"{ckpt}: full state at step {TRAIN_ITERS}")
    times = trainer.iter_times
    run_s_per_iter = (times[-1] - times[1]) / (len(times) - 2)  # iterations 3..8

    def steps(n: int) -> float:
        """n more steps as the trainer's loop takes them (step, next batch
        from its stream, losses to the host); returns their seconds."""
        batch = trainer._upload(trainer.next_batch())
        t0 = time.perf_counter()
        for t in range(n):
            step_losses = trainer.step_fn(batch, t % TRAIN_ITERS)  # an lr of the schedule
            batch = trainer._upload(trainer.next_batch())
            trainer.model_recorder.record_losses(step_losses)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    # The stream assembles batches ahead while the first (cold) iteration,
    # the validation and the saves run, and the run's later iterations draw
    # on that stock.  The steady rate is taken after 4 steps drain it.
    steps(4)
    s_per_iter = steps(8) / 8
    flops = train_step_flops(torch, trainer.segmentor)
    mfu = flops / s_per_iter / BF16_FLOPS_PER_S
    for i, step in enumerate(losses, 1):
        print(f"train iter {i}: " + ", ".join(f"{k} {v:.5f}" for k, v in step.items())
              + (f", {times[i - 1] - times[i - 2]:.3f} s" if i > 1 else ""))
    print(f"training [{TRAIN_ITERS} iterations, batch {TRAIN_B}, {TRAIN_H}x{TRAIN_W}]: main {wall:.3f} s, "
          f"iterations 3-{TRAIN_ITERS} {run_s_per_iter:.4f} s/iter; steady (8 steps after 4 more) "
          f"{s_per_iter:.4f} s/iter ({TRAIN_B / s_per_iter:.3f} images/s), peak memory {peak_gb:.3f} GB, "
          f"{flops / 1e12:.3f} TFLOP per step, MFU {mfu:.4f} of 989 TFLOP/s; launches {counts}")

    if profile:
        profile_run(torch, "SegFormer-B5 training, 3 steps", lambda: steps(3))
        host_ms_aug(trainer.t_dataset)
    del trainer
    torch.cuda.empty_cache()

    # the checkpoint drives the next round's generation
    b5_generation(torch, ckpt, os.path.join(work, "round1", "pseudo_label", "gray_label"),
                  json_path, image_dir, N_TRAIN_IMAGES)
    return {"counts": counts, "s_per_iter": s_per_iter, "peak_gb": peak_gb, "mfu": mfu}


def host_ms_aug(dataset) -> None:
    """Host clock: one training sample (decode of a 1024x2048 PNG and its
    pseudo-label, 'MS' crop and resize to 512x1024)."""
    t0 = time.perf_counter()
    dataset.get_item(0, np.random.default_rng(0))
    print(f"host: one training sample (decode, pseudo-label, MS) {1e3 * (time.perf_counter() - t0):.2f} ms")


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
    expected = {"ias_hist": 0, "ias_select": 0, "sra_attention": sum(B5_DEPTHS) * (N_IMAGES // B),
                "sra_attention_bwd": 0}
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
    check_b5_backward(torch, pth)

    json_path, image_dir = os.path.join(work, "target.json"), os.path.join(work, "city")
    n_batches = -(-N_IMAGES // B)
    expected = {"ias_hist": n_batches, "ias_select": n_batches, "sra_attention": sum(B5_DEPTHS) * n_batches,
                "sra_attention_bwd": 0}
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
        host_costs(os.path.join(val_dir, "images", "val_0.png"))
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
    # a user annotation's device span (the optimizer step's) covers kernels counted on their own
    on_device = [e for e in events if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    copies = sum(e.self_device_time_total for e in on_device if e.key.startswith("Memcpy")) / 1e3
    kernels = sum(e.self_device_time_total for e in on_device) / 1e3 - copies
    # the profiler spans all of run() (for a CLI: model build, weight
    # upload); the kernels inside the loop take at most all of it
    print(f"profile [{tag}]: over the run, device kernels {kernels:.3f} ms and copies {copies:.3f} ms; "
          f"loop {loop * 1e3:.3f} ms, so the device idles at least "
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
        for kernel, regs, spill in attention_resources(lib + ".log"):
            print(f"ptxas {kernel}: {regs} registers at launch, {spill} spill bytes")
            check(spill == 0, f"{kernel} spills {spill} bytes")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    work = os.path.join(REPO, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    kernels = kernel_phase(torch)
    deeplab_rate = slice_phase(torch, work, profile)
    print(f"generation warm: {deeplab_rate:.3f} images/s (batch {B}, {H}x{W}, R101, on {card})")
    kernels["sra_attention"] = attention_phase(torch, clock_hz)
    kernels["sra_attention_bwd"] = attention_bwd_phase(torch, clock_hz)
    counts, b5_gen_rate, b5_val_rate = segformer_phase(torch, work, profile)
    print(f"generation warm: {b5_gen_rate:.3f} images/s (batch {B}, {H}x{W}, SegFormer-B5, on {card})")
    print(f"validation warm: {b5_val_rate:.3f} images/s (batch {B}, {VAL_H}x{VAL_W} at {H}x{W}, "
          f"SegFormer-B5, no flip, on {card})")
    train = training_phase(torch, work, profile)
    print(f"training warm: {train['s_per_iter']:.4f} s/iter, {TRAIN_B / train['s_per_iter']:.3f} images/s, "
          f"peak memory {train['peak_gb']:.3f} GB, MFU {train['mfu']:.4f} (batch {TRAIN_B}, "
          f"{TRAIN_H}x{TRAIN_W}, SegFormer-B5, on {card})")
    for name in ("sra_attention", "sra_attention_bwd"):  # the training path runs both
        counts[name] = train["counts"][name]

    rows = []
    sources = {
        "ias_hist": ("hiast_tpu_torch/csrc/select_kernel.cu", "hiast_tpu/ops/pallas/select_kernel.py:172"),
        "ias_select": ("hiast_tpu_torch/csrc/select_kernel.cu", "hiast_tpu/ops/pallas/select_kernel.py:52"),
        "sra_attention": ("hiast_tpu_torch/csrc/sra_attention.cu", "hiast_tpu/ops/pallas/attention.py:113"),
        "sra_attention_bwd": ("hiast_tpu_torch/csrc/sra_attention.cu", "hiast_tpu/ops/pallas/attention.py:123"),
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
