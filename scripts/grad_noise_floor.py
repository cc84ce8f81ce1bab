"""The noise floor of a training step's gradients on the card: the same
step run twice against itself.

    python3 scripts/grad_noise_floor.py [--deterministic | --cudnn] [--cpu]

Runs ``tests/test_torch_kernels_cuda.py``'s seeded SegFormer-B0 bf16
self-training step (batch 2, 256x512) three times without remat and once
under 'blocks' remat, each from the same seed, and prints each gradient's
cosine (in float64, and in float32 as the test took it) between the first
run and each other run: the lowest ten, and every one below 0.9999.  ``--deterministic`` runs all four under
``torch.use_deterministic_algorithms(True)`` (``CUBLAS_WORKSPACE_CONFIG``
set first), the bilinear resizes as matmuls (the test's
``deterministic_resizes``); ``--cudnn`` sets only
``torch.backends.cudnn.deterministic``.  Prints the card and its power limit.
"""
from __future__ import annotations

import contextlib
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOUND = 0.9999


def main(argv: list[str]) -> int:
    deterministic = "--deterministic" in argv
    if deterministic:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path.insert(0, REPO)
    import importlib.util

    import torch

    spec = importlib.util.spec_from_file_location("kernel_tests", os.path.join(REPO, "tests", "test_torch_kernels_cuda.py"))
    kernel_tests = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(kernel_tests)
    _b0_step = kernel_tests._b0_step

    if "--cpu" in argv:  # a rehearsal of the script's own logic
        device, card = torch.device("cpu"), "the CPU"
        torch.cuda.synchronize = lambda: None
    elif not torch.cuda.is_available():
        print("grad_noise_floor: no CUDA device", file=sys.stderr)
        return 2
    else:
        device = torch.device("cuda")
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True).stdout.strip()
    torch.backends.cudnn.deterministic = "--cudnn" in argv
    with kernel_tests.deterministic_resizes() if deterministic else contextlib.nullcontext():
        runs = [_b0_step(None, device) for _ in range(3)] + [_b0_step("blocks", device)]
    (want_losses, want, _), others = runs[0], runs[1:]
    tag = ("deterministic algorithms" if deterministic else "cuDNN deterministic only" if "--cudnn" in argv
           else "default algorithms")
    for i, (losses, grads, counts) in enumerate(others, 2):
        name = f"run {i}" if i < 4 else "run 4 ('blocks' remat)"
        cos = {n: float(torch.nn.functional.cosine_similarity(grads[n].double().flatten(), g.double().flatten(), dim=0))
               for n, g in want.items()}
        cos32 = {n: float(torch.nn.functional.cosine_similarity(grads[n].flatten(), g.flatten(), dim=0))
                 for n, g in want.items()}
        equal = sum(torch.equal(grads[n], g) for n, g in want.items())
        loss_rel = max(abs(losses[k] - v) / max(abs(v), 1e-30) for k, v in want_losses.items())
        low = sorted(cos.items(), key=lambda kv: kv[1])
        print(f"{tag}, {name} against run 1: {equal} of {len(want)} gradients bit-equal, losses within "
              f"{loss_rel:.3g} relative, launches {counts}; lowest cosines "
              + ", ".join(f"{n} {c:.7f}" for n, c in low[:10]))
        below = {n: c for n, c in low if c < BOUND}
        print(f"  below {BOUND} (cosine in float64): {below}")
        print(f"  below {BOUND} (cosine in float32, as the test took it): "
              f"{ {n: c for n, c in cos32.items() if c < BOUND} }; lowest "
              + ", ".join(f"{n} {c:.7f}" for n, c in sorted(cos32.items(), key=lambda kv: kv[1])[:5]))
        for n, _ in low[:3]:
            g, w = grads[n], want[n]
            print(f"  {n}: shape {list(w.shape)}, norm {float(w.norm()):.6g}, max |diff| "
                  f"{float((g - w).abs().max()):.3g}, max |g| {float(w.abs().max()):.3g}")
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
