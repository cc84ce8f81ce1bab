"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file compiles with nvcc into its own shared library with
a plain C interface, loaded with ctypes (no PyTorch headers, so a build
takes seconds).  Libraries go to ``build/kernels/`` at the repository root,
named by a hash of their source and flags, and are built at first use: in
the process that first launches a kernel, never at import.  A missing nvcc
or a failed build raises; nothing falls back to the plain versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = os.path.join(home, "bin", "nvcc")
    found = candidate if os.path.exists(candidate) else shutil.which("nvcc")
    if not found:
        raise RuntimeError(
            f"nvcc not found (looked in {candidate} and on PATH): the CUDA kernels "
            "cannot be built"
        )
    return found


def source_names() -> list[str]:
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def library_path(name: str) -> str:
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")


def build(names: list[str]) -> list[str]:
    """Compile each ``csrc/<name>.cu`` whose library is not built yet, one
    nvcc per file, all started together; returns the library paths.  The
    compiler's resource report (``-Xptxas -v``) is kept in ``<library>.log``."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = find_nvcc()
    running = []
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        running.append((name, cmd, tmp, out, proc))
    failed = []
    for name, cmd, tmp, out, proc in running:
        stdout, stderr = proc.communicate()
        with open(out + ".log", "w") as f:
            f.write(" ".join(cmd) + "\n" + stdout + stderr)
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(f"{name}.cu:\n{stderr[-4000:]}")
    if failed:
        raise RuntimeError("nvcc failed to build " + "\n".join(failed))
    return [library_path(n) for n in names]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        if name not in _loaded:
            (path,) = build([name])
            _loaded[name] = ctypes.CDLL(path)
        return _loaded[name]
