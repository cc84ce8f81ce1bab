"""Import hygiene of the port: it stands alone beside the JAX package.

- No module of hiast_tpu_torch/ and no line of chip_smoke.py imports jax,
  flax, optax, orbax or anything of hiast_tpu (its numpy-only modules
  included: the port keeps its own copies).
- yaml, PIL and cv2, which the card's machine may lack, are imported only
  inside the functions that need them, never at module level.
- Importing the port's CLIs in a fresh interpreter leaves jax unloaded.
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
    files = [os.path.join(REPO, "chip_smoke.py")]
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
                   ("models", "segformer.py"), ("evaluation.py",), ("cli", "validate.py")):
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
        " hiast_tpu_torch.registry as r;"
        " r.populate();"
        " bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'hiast_tpu', 'yaml', 'PIL', 'cv2'));"
        " print(bad); sys.exit(1 if bad else 0)"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
