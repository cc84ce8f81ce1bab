#!/usr/bin/env python3
"""Where the IAS kernels' time goes (ias_hist, ias_select), on one H100.

    python3 scripts/profile_select_kernel.py [--tree DIR] [--times-only]

Times ``ias_hist`` and ``ias_select`` (median of 20 runs, CUDA events, as
``chip_smoke.py`` times them) on two inputs at the main path's shapes,
[2, 19, 768, 1536] float32: ``chip_smoke.gaussian_logits`` (N(0, 9), almost
no confident pixel) and ``chip_smoke.peaked_logits`` (a trained model's
confidences), and ``ias_hist`` on the [2, 19, 96, 192] grid as well, each
beside its memory bound, and splits each wrapper's device time by CUDA
kernel with torch.profiler.  Then, unless ``--times-only``, builds
``hiast_tpu_torch/csrc/select_kernel.cu`` with ``-DIAS_PROF`` (each kernel
then sums clock64 cycles by phase over every warp; see the head of that
file) and prints, per kernel and input, the share of a warp's cycles in
each phase.

``--tree DIR`` times the wrappers of another checkout's ``hiast_tpu_torch``
(a ``git archive`` of an earlier commit, say) with this checkout's inputs,
so two versions can be compared in one call; it implies ``--times-only``.
Needs a CUDA device and nvcc; prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# counter slots of select_kernel.cu's g_ias_prof: [base + i] for phase i,
# [base + 5] the whole kernel, [base + 6] the number of warps summed
HIST_PHASES = ("zero the histogram (and cluster barrier)", "loads (to the max)", "confidence arithmetic",
               "binning and atomics", "(cluster barrier and) flush")
SELECT_PHASES = ("set-up", "loads (to the max)", "confidence arithmetic",
                 "label stores and stat accumulation", "block sums and flush")


def build_profiling(build) -> str:
    """select_kernel.cu built with -DIAS_PROF into build/kernels/."""
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(build.BUILD_DIR, "libselect_kernel_prof.so")
    src = os.path.join(build.CSRC, "select_kernel.cu")
    subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-DIAS_PROF", "-o", lib_path, src], check=True,
                   capture_output=True)
    return lib_path


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def inputs(torch, cs):
    dev = torch.device("cuda")
    shape, low = (cs.B, cs.C, cs.H, cs.W), (cs.B, cs.C, cs.LOW_H, cs.LOW_W)
    return {
        "gaussian": (torch.from_numpy(cs.gaussian_logits(shape, 0)).to(dev),
                     torch.from_numpy(cs.gaussian_logits(low, 1)).to(dev)),
        "peaked": (torch.from_numpy(cs.peaked_logits(shape, 0)).to(dev),
                   torch.from_numpy(cs.peaked_logits(low, 1)).to(dev)),
    }


def thresholds(torch, K, logits, num_bins):
    """The IAS thresholds one generator batch would select with."""
    from hiast_tpu_torch.pseudo import policies as P

    c = logits.shape[1]
    state = P.IASState(torch.full((c,), 0.9, device=logits.device), torch.zeros(c, device=logits.device))
    return P.ias_update(state, K.ias_hist(logits, logits.numel() // c, num_bins), 0.2, 0.9, 8.0)


def kernel_us(torch, fn, reps: int = 10) -> dict:
    """Device time per call of each CUDA kernel fn() launches (torch.profiler),
    in us: the wrapper's own kernels beside its allocations' memsets and
    casts."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / reps for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=REPO, help="checkout whose hiast_tpu_torch is timed")
    ap.add_argument("--times-only", action="store_true", help="skip the clock64 phase split")
    args = ap.parse_args(argv)
    args.times_only = args.times_only or os.path.abspath(args.tree) != REPO

    import torch

    if not torch.cuda.is_available():
        print("profile_select_kernel: no CUDA device", file=sys.stderr)
        return 2
    cs = load_chip_smoke()
    sys.path.insert(0, os.path.abspath(args.tree))
    from hiast_tpu_torch.ops.cuda import build
    from hiast_tpu_torch.ops.cuda import select_kernel as K

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    print(f"tree: {os.path.abspath(args.tree)}")
    nb = cs.NUM_BINS
    data = inputs(torch, cs)
    times = {}
    for name, (full, low) in data.items():
        n, low_n = full.numel() // cs.C, low.numel() // cs.C
        thr = thresholds(torch, K, full, nb)
        hist_ms = cs.device_ms(torch, lambda: K.ias_hist(full, n, nb))
        low_ms = cs.device_ms(torch, lambda: K.ias_hist(low, low_n, nb))
        sel_ms = cs.device_ms(torch, lambda: K.ias_select(full, thr, n))
        hist_bound, _ = cs.bound_ms(n * cs.C * 4 + cs.C * nb * 4, n * cs.C * 4.0)
        low_bound, _ = cs.bound_ms(low_n * cs.C * 4 + cs.C * nb * 4, low_n * cs.C * 4.0)
        sel_bound, _ = cs.bound_ms(n * cs.C * 4 + cs.C * 4 + n + cs.B * cs.C * 4 + cs.C * 8, n * cs.C * 4.0)
        times[name] = {"ias_hist": hist_ms, "ias_hist_low": low_ms, "ias_select": sel_ms}
        print(f"[{name}] ias_hist {hist_ms:.4f} ms (bound {hist_bound:.4f}, {hist_bound / hist_ms:.3f} of it); "
              f"[low] {low_ms:.4f} ms (bound {low_bound:.4f}); "
              f"ias_select {sel_ms:.4f} ms (bound {sel_bound:.4f}, {sel_bound / sel_ms:.3f} of it)")
        for kernel, run in (("ias_hist", lambda: K.ias_hist(full, n, nb)),
                            ("ias_select", lambda: K.ias_select(full, thr, n))):
            split = ", ".join(f"{key[:60]} {us:.2f} us" for key, us in kernel_us(torch, run).items())
            print(f"[{name}] {kernel} by CUDA kernel (torch.profiler): {split}")
    print(json.dumps({"tree": os.path.abspath(args.tree), "card": card, "ms": times}))
    if args.times_only:
        return 0

    lib = ctypes.CDLL(build_profiling(build))
    K.bind(lib)  # the wrappers launch the profiling build from here on
    counters = (ctypes.c_ulonglong * 16)()
    for name, (full, _) in data.items():
        n = full.numel() // cs.C
        thr = thresholds(torch, K, full, nb)
        for kernel, base, phases, run in (
            ("ias_hist", 0, HIST_PHASES, lambda: K.ias_hist(full, n, nb)),
            ("ias_select", 8, SELECT_PHASES, lambda: K.ias_select(full, thr, n)),
        ):
            run()  # warm-up
            lib.ias_prof_read(counters)
            for _ in range(5):
                run()
            lib.ias_prof_read(counters)
            whole, warps = counters[base + 5], counters[base + 6]
            print(f"[{name}] {kernel}: {whole / warps:.0f} cycles per warp on average")
            for i, phase in enumerate(phases):
                print(f"  {phase:42s} {counters[base + i] / warps:10.0f}  ({counters[base + i] / whole:.3f})")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
