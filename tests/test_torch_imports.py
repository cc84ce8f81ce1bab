"""Import hygiene of the port: it stands alone beside the JAX package.

- No module of hiast_tpu_torch/, no line of chip_smoke.py and no line of
  tests/torch_dp_worker.py (the data-parallel test's workers) imports jax,
  flax, optax, orbax or anything of hiast_tpu (its numpy-only modules
  included: the port keeps its own copies).
- yaml, PIL and cv2, which the card's machine may lack, are imported only
  inside the functions that need them, never at module level.
- Importing the port's CLIs in a fresh interpreter leaves jax unloaded,
  and builds or loads no native library (the host ops of
  ``csrc/host_ops.cpp`` load at their first call, with the C signatures
  that ``data/native_ops.py`` declares).
- No file of the port (its Python, its C++ and CUDA sources and
  chip_smoke.py) names the JAX package's native library: the port builds
  its own.
"""
import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "hiast_tpu")
LAZY_ONLY = ("yaml", "PIL", "cv2")


def _port_files():
    # the data-parallel test's worker processes run the port alone
    files = [os.path.join(REPO, "chip_smoke.py"), os.path.join(REPO, "tests", "torch_dp_worker.py")]
    for root, _dirs, names in os.walk(os.path.join(REPO, "hiast_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _packages(node):
    if isinstance(node, ast.Import):
        return [alias.name.split(".")[0] for alias in node.names]
    if isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
        return [node.module.split(".")[0]]
    return []


def _all_imports(tree):
    return [(pkg, n.lineno) for n in ast.walk(tree) for pkg in _packages(n)]


def _module_level_imports(tree):
    """Imports that run when the module is imported: outside any def/class."""
    found, stack = [], list(tree.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.Lambda)):
            continue
        found += [(pkg, node.lineno) for pkg in _packages(node)]
        stack.extend(ast.iter_child_nodes(node))
    return found


def test_the_port_has_files_to_check():
    files = _port_files()
    assert len(files) > 20
    for module in (("ops", "cuda", "select_kernel.py"), ("ops", "cuda", "attention.py"),
                   ("models", "segformer.py"), ("evaluation.py",), ("cli", "validate.py"),
                   ("ops", "losses.py"), ("selftrain", "train_state.py"), ("selftrain", "trainers.py"),
                   ("utils", "recorder.py"), ("utils", "logging_utils.py"), ("cli", "train.py"),
                   ("ops", "color_aug.py"), ("data", "copy_paste.py"), ("data", "png.py"),
                   ("data", "native_ops.py"), ("cli", "export_model.py"), ("models", "remat.py"),
                   ("parallel", "__init__.py"), ("parallel", "mesh.py"), ("models", "norm.py")):
        assert os.path.join(REPO, "hiast_tpu_torch", *module) in files


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_reference_package_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    bad = [(pkg, line) for pkg, line in _all_imports(tree) if pkg in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"
    eager = [(pkg, line) for pkg, line in _module_level_imports(tree) if pkg in LAZY_ONLY]
    assert not eager, f"{path} imports {eager} at module level"


def test_importing_the_cli_loads_no_jax():
    code = (
        "import sys; import hiast_tpu_torch.cli.generate_pseudo_labels, hiast_tpu_torch.cli.validate,"
        " hiast_tpu_torch.cli.train, hiast_tpu_torch.cli.export_model,"
        " hiast_tpu_torch.registry as r;"
        " r.populate();"
        " bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'hiast_tpu', 'yaml', 'PIL', 'cv2'));"
        " from hiast_tpu_torch.data import native_ops; from hiast_tpu_torch.ops.cuda import build;"
        " bad += ['a native library loaded'] if native_ops._lib or build._loaded else [];"
        " print(bad); sys.exit(1 if bad else 0)"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_png_unfilter_source_matches_its_loader():
    """csrc/host_ops.cpp is one of the sources the build compiles, host code
    only, and each of its C functions takes what ``data/native_ops.py``
    passes through ctypes: the unfilter two pointers, two 64-bit counts and
    an int, returning an int; the pixel ops pointers and int64 sizes."""
    import re

    from hiast_tpu_torch.data import native_ops
    from hiast_tpu_torch.ops.cuda import build

    assert "host_ops" in build.source_names() and "png_unfilter" not in build.source_names()
    with open(os.path.join(build.CSRC, "host_ops.cpp")) as f:
        source = f.read()
    assert re.search(r'int png_unfilter\(const uint8_t\* raw, uint8_t\* out, long long h, '
                     r'long long stride, int bpp\)', source)
    assert "__global__" not in source and 'extern "C" {' in source
    c_types = {"const uint8_t*": "c_void_p", "uint8_t*": "c_void_p", "int64_t": "c_long", "int": "c_int",
               "long long": "c_long"}
    for name, (argtypes, restype) in native_ops._SIGNATURES.items():
        match = re.search(rf"\n(void|int) {name}\(([^)]*)\)", source)
        assert match, name
        params = [" ".join(p.split()[:-1]) for p in match.group(2).split(",")]
        assert [c_types[p] for p in params] == [t.__name__ for t in argtypes], name
        assert (restype is None) == (match.group(1) == "void"), name


def test_no_port_file_names_the_jax_native_library():
    files = _port_files()
    files += [os.path.join(REPO, "hiast_tpu_torch", "csrc", n)
              for n in os.listdir(os.path.join(REPO, "hiast_tpu_torch", "csrc"))]
    for path in files:
        with open(path) as f:
            text = f.read()
        for word in ("native/", "libhiast_host_ops"):
            assert word not in text, f"{os.path.relpath(path, REPO)} names {word!r}"
