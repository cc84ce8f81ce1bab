#!/usr/bin/env python3
"""Where the SRA attention forward kernel's time goes, on one H100.

    python3 scripts/profile_sra_attention.py

Builds ``hiast_tpu_torch/csrc/sra_attention.cu`` with ``-DSRA_PROF`` (the
forward then counts clock64 cycles by phase; see the head of that file)
into ``build/kernels/``, runs the forward at the four MiT-B5 stage shapes
of a 768x1536 serving batch of 2, and prints, per stage, the cycles one
consumer warpgroup spends in each phase of one launch, beside the MUFU's
floor for the exponentials it shares its SM with.  Needs a CUDA device and
nvcc; prints the card's name and power limit first.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

PHASES = ("pass 1: wait for K", "pass 1: S = Q K^T", "pass 1: max, exp, sum",
          "pass 2: wait for K, V", "pass 2: issue S and P V, wait for S", "pass 2: exp, scale, cast",
          "pass 2: wait for P V")
STAGES = ((2, 73728, 1152, 1), (2, 18432, 1152, 2), (2, 4608, 1152, 5), (2, 1152, 1152, 8))  # B, N_q, N_kv, H


def main() -> int:
    import torch

    from hiast_tpu_torch.ops.cuda import attention as A
    from hiast_tpu_torch.ops.cuda import build

    if not torch.cuda.is_available():
        print("profile_sra_attention: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(build.BUILD_DIR, "libsra_attention_prof.so")
    src = os.path.join(build.CSRC, "sra_attention.cu")
    subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-DSRA_PROF", "-o", lib_path, src], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(lib_path)
    A._bound.clear()  # the wrappers launch the profiling build from here on
    for name, sig in A._SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = sig, ctypes.c_int
        A._bound[name] = fn
    counters = (ctypes.c_ulonglong * 16)()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for b, nq, nkv, h in STAGES:
        q = torch.randn(b, nq, h, 64, device=dev, generator=gen).bfloat16()
        kv = torch.randn(b, nkv, 2 * h * 64, device=dev, generator=gen).bfloat16()
        k, v = A.split_kv(kv, h)
        A._forward_cuda(q, k, v, with_stats=False)  # warm-up
        lib.sra_prof_read(counters)
        reps = 5
        for _ in range(reps):
            A._forward_cuda(q, k, v, with_stats=False)
        lib.sra_prof_read(counters)
        n = counters[9]
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        # one launch's exponentials (2 per score) over 16 per SM per clock, on every SM
        mufu = 2 * b * h * nq * nkv / (16 * sms)
        print(f"stage B*H={b * h} N_q={nq} N_kv={nkv}: cycles per warpgroup per launch, "
              f"whole kernel {counters[8] / n:.0f} (MUFU floor {mufu:.0f})")
        for i, phase in enumerate(PHASES):
            print(f"  {phase:40s} {counters[i] / n:10.0f}  ({counters[i] / counters[8]:.3f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
