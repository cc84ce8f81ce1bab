#!/usr/bin/env python3
"""Smoke run of the PyTorch port (hiast_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py [--profile]

1. Prints the card's name and power limit, then builds every CUDA kernel of
   the port from hiast_tpu_torch/csrc/ with nvcc (sm_90a).
2. Kernel phase: holds ``ias_hist`` and ``ias_select`` against their plain
   PyTorch versions on seeded logits at the main path's shapes
   ([2, 19, 768, 1536] float32; the [2, 19, 96, 192] OS8 grid for the
   histogram too), with and without the second sample cut off by ``nvalid``,
   and times each (median of 20 runs, CUDA events) beside its plain version
   and its memory bound.
3. Slice phase: writes 4 synthetic 768x1536 target images, runs IAS
   pseudo-label generation through the port's CLI ``main`` on full-width
   DeepLab-v2/ResNet-101 (random weights from a seed, batch 2, 2048 bins,
   stats_source full), checks the six artifacts and that each kernel was
   launched once per batch, and reports images per second.  ``--profile``
   adds a torch.profiler breakdown of one generation run by CUDA kernel.
4. Prints one JSON line of the kernels, the card line again, and last
   ``{"ok": true, "device": {...}}``.

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


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


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


def slice_phase(torch, profile: bool):
    from hiast_tpu_torch.cli import generate_pseudo_labels as cli
    from hiast_tpu_torch.ops.cuda.select_kernel import launch_counts, reset_launch_counts

    work = os.path.join(REPO, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    json_path, image_dir = write_target_set(work)
    n_batches = -(-N_IMAGES // B)

    def run(tag: str) -> tuple[float, dict]:
        """One generation through the CLI; returns (seconds of the
        generator's batch loop, launch counts of this run)."""
        save_dir = os.path.join(work, tag, "pseudo_label", "gray_label")
        argv = [
            "--device", "cuda", "--pseudo_save_dir", save_dir,
            "model.type", "SelfTrainingSegmentor",
            "model.seg_model.type", "DeepLab_V2",
            "model.seg_model.backbone_layers", "[3, 4, 23, 3]",
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
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        generator = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(launch_counts)
        check(counts == {"ias_hist": n_batches, "ias_select": n_batches},
              f"launch counts {counts}, expected {n_batches} each")
        check_artifacts(save_dir)
        loop = generator.run_seconds
        print(f"generation [{tag}] {N_IMAGES} images: main {wall:.3f} s, batch loop "
              f"{loop:.3f} s ({N_IMAGES / loop:.3f} images/s), launches {counts}")
        return loop, counts

    _, counts = run("cold")
    loop, _ = run("warm")
    if profile:
        profile_generation(torch, run, image_dir)
    return counts, N_IMAGES / loop


def profile_generation(torch, run, image_dir: str) -> None:
    """Where one warm generation's time goes: device time by CUDA kernel
    (torch.profiler), the device's idle share of the batch loop, and the
    host's per-image PNG costs (host clock)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as prof

    from hiast_tpu_torch.data.datasets import read_rgb
    from hiast_tpu_torch.data.png import encode_png

    with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        loop, _ = run("profiled")
    from torch.autograd import DeviceType

    events = p.key_averages()
    print(events.table(sort_by="self_cuda_time_total", row_limit=20))
    on_device = [e for e in events if e.device_type == DeviceType.CUDA]
    copies = sum(e.self_device_time_total for e in on_device if e.key.startswith("Memcpy")) / 1e3
    kernels = sum(e.self_device_time_total for e in on_device) / 1e3 - copies
    # the profiler spans the whole main() (model build, weight upload); the
    # kernels inside the batch loop take at most all of it
    print(f"profile: over main(), device kernels {kernels:.3f} ms and copies {copies:.3f} ms; "
          f"batch loop {loop * 1e3:.3f} ms, so the device idles at least "
          f"{1 - kernels / 1e3 / loop:.3f} of the loop (the profiler slows the host)")

    from torch.utils.flop_counter import FlopCounterMode

    from hiast_tpu_torch.models.deeplab_v2 import DeepLabV2

    with torch.device("meta"):
        model = DeepLabV2(num_classes=C).eval()
        with FlopCounterMode(display=False) as flops:
            model(torch.empty(B, 3, H, W))
    total = flops.get_total_flops()
    print(f"forward: {total / 1e12:.3f} TFLOP per batch of {B} at {H}x{W} "
          f"({total / B / 1e12:.3f} per image; at the 989 TFLOP/s bf16 peak "
          f"{total / 989e12 * 1e3:.3f} ms per batch)")

    path = os.path.join(image_dir, "images", "t_0.png")
    t0 = time.perf_counter()
    img = read_rgb(path)
    decode = time.perf_counter() - t0
    lbl = np.zeros((H, W), np.uint8)
    lbl[:, W // 2:] = 7
    t0 = time.perf_counter()
    encode_png(lbl)
    encode = time.perf_counter() - t0
    print(f"host: decode one {img.shape[0]}x{img.shape[1]} RGB PNG {decode * 1e3:.2f} ms, "
          f"encode one label PNG {encode * 1e3:.2f} ms")


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch; nothing was run", file=sys.stderr)
        return 2
    profile = "--profile" in argv
    card = card_line()
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
    kernels = kernel_phase(torch)
    counts, images_per_s = slice_phase(torch, profile)
    print(f"generation warm: {images_per_s:.3f} images/s (batch {B}, {H}x{W}, R101, on {card})")

    rows = []
    sources = {
        "ias_hist": "hiast_tpu/ops/pallas/select_kernel.py:172",
        "ias_select": "hiast_tpu/ops/pallas/select_kernel.py:52",
    }
    for name, r in kernels.items():
        rows.append({
            "name": name, "route": "cuda", "source": "hiast_tpu_torch/csrc/select_kernel.cu",
            "replaces": sources[name], "launches": counts[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
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
