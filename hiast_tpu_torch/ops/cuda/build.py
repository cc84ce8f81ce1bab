"""Build and load the port's native libraries.

Each ``csrc/*.cu`` file compiles with nvcc into its own shared library with
a plain C interface, loaded with ctypes (no PyTorch headers, so a build
takes seconds); each ``csrc/*.cpp`` file (host code only) compiles the same
way with the host C++ compiler, ``$CXX`` or else ``c++``.  Libraries go to
``build/kernels/`` at the repository root, named by a hash of their source
and flags, and are built at first use: in the process that first calls
into one, never at import.  A missing compiler or a failed build raises;
nothing falls back to the plain versions.
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
# No -march=native and no -ffast-math; -ffp-contract=off keeps a*(1-f) + b*f
# two roundings, as numpy computes it, so the host ops match their plain
# versions bit for bit on any host.
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off")
FLAGS = {".cu": NVCC_FLAGS, ".cpp": CXX_FLAGS}

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


def find_cxx() -> str:
    """The host C++ compiler: ``$CXX`` when it is set (and then only it),
    else ``c++`` on PATH."""
    name = os.environ.get("CXX") or "c++"
    found = shutil.which(name)
    if not found:
        raise RuntimeError(f"the host C++ compiler {name!r} (from $CXX, else c++) was not found: "
                           "the host ops cannot be built")
    return found


def cxx_version() -> str:
    """The first line of the host compiler's ``--version``."""
    out = subprocess.run([find_cxx(), "--version"], capture_output=True, text=True, check=True).stdout
    return out.splitlines()[0] if out else "unknown"


def _source(name: str) -> str:
    for ext in FLAGS:
        path = os.path.join(CSRC, name + ext)
        if os.path.exists(path):
            return path
    raise FileNotFoundError(f"no csrc/{name}.cu or csrc/{name}.cpp")


def source_names() -> list[str]:
    return sorted(os.path.splitext(f)[0] for f in os.listdir(CSRC) if os.path.splitext(f)[1] in FLAGS)


def library_path(name: str) -> str:
    src = _source(name)
    flags = FLAGS[os.path.splitext(src)[1]]
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")


def build(names: list[str]) -> list[str]:
    """Compile each ``csrc/<name>.cu`` or ``.cpp`` whose library is not
    built yet, one compiler per file, all started together; returns the
    library paths.  The compiler's output (for nvcc the resource report of
    ``-Xptxas -v``) is kept in ``<library>.log``.  Each library is written
    to a temporary file first and renamed into place, so processes that
    build the same one at once each leave a whole file."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    sources = {name: _source(name) for name in names}
    exts = {os.path.splitext(src)[1] for src in sources.values()}
    compilers = {ext: (find_nvcc() if ext == ".cu" else find_cxx()) for ext in exts}
    running = []
    for name, src in sources.items():
        out = library_path(name)
        if os.path.exists(out):
            continue
        ext = os.path.splitext(src)[1]
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [compilers[ext], *FLAGS[ext], "-o", tmp, src]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        running.append((src, cmd, tmp, out, proc))
    failed = []
    for src, cmd, tmp, out, proc in running:
        stdout, stderr = proc.communicate()
        with open(out + ".log", "w") as f:
            f.write(" ".join(cmd) + "\n" + stdout + stderr)
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(f"{os.path.basename(src)}:\n{stderr[-4000:]}")
    if failed:
        raise RuntimeError("failed to build " + "\n".join(failed))
    return [library_path(n) for n in names]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` or ``.cpp``, built first if
    needed."""
    with _lock:
        if name not in _loaded:
            (path,) = build([name])
            _loaded[name] = ctypes.CDLL(path)
        return _loaded[name]
