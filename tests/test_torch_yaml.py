"""The port's reader of the YAML subset the configs use, against PyYAML.

``hiast_tpu_torch/config/yaml_subset.py`` must return what ``yaml.safe_load``
returns (YAML 1.1 resolution: ``3e-6`` a string, ``True`` a bool, quoted
numbers strings, an empty value None) on every config of the JAX package,
on the YAML strings of tests/test_cli.py and on a string of edge cases; the
port's loader must build the same config as the JAX loader from each file;
the port's copies of the configs must read as the JAX package's files; a
construct outside the subset raises ``ValueError`` naming the line; and the
loader must read every shipped config in a process where ``import yaml``
fails, as on the card's machine.
"""
import glob
import json
import math
import os
import subprocess
import sys

import pytest
import yaml

from hiast_tpu.config import load_config as jax_load_config
from hiast_tpu_torch.config import load_config
from hiast_tpu_torch.config import yaml_subset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_CONFIGS = sorted(glob.glob(os.path.join(REPO, "hiast_tpu", "configs", "*.yaml")))
PORT_CONFIGS = os.path.join(REPO, "hiast_tpu_torch", "configs")
NAMES = [os.path.basename(p) for p in JAX_CONFIGS]

EDGE_CASES = """\
---
# a comment line
a: 1e-3            # no dot: a string in YAML 1.1
b: 3e-6
c: 1.0e-3
d: 1.5
e: True
f: ~
g:
h: '1'
i: "x\\ty \\u00e9"
j: [[768, 1536], [960, 1920]]
k: [ 'MS', 'CCA' ]
l: 0x1F
m: 017
n: 08
o: 1:30
p: .inf
q: -.5
r: yes
s: 'it''s'
t: a#b
u: http://x.y/z # c
v: []
w: [1, 2, ]
x: 1_000
y: +12
z: .NaN
aa: 1e3
ab: 1.0e3
ac: 190:20:30.15
ad: off
ae: Null
af: 0b101
ag: -0x1A
ah: "a 'b' # c"
ai: [a b, 'c, d', "e]", [], [[]]]
nest:
  deep:
    deeper: 1
    empty:
  back: [null, ~, true, FALSE]
top: 3
"""


def _same(a, b) -> bool:
    """Equal, of the same types all the way down (NaN equals NaN)."""
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


def test_there_are_nine_configs_and_the_port_ships_each():
    assert len(NAMES) == 9
    assert sorted(os.listdir(PORT_CONFIGS)) == NAMES


@pytest.mark.parametrize("path", JAX_CONFIGS, ids=NAMES)
def test_reader_equals_safe_load_on_each_config(path):
    with open(path) as f:
        want = yaml.safe_load(f)
    assert _same(yaml_subset.load(path), want)


def _test_cli_strings(tmp_path):
    from test_cli import write_round_config

    files = write_round_config(tmp_path, "/data/fixture")
    out = {}
    for path in files:
        with open(path) as f:
            out[os.path.basename(path)] = f.read()
    return out


@pytest.mark.parametrize("which", ["round.yaml", "setting.yaml", "edge cases"])
def test_reader_equals_safe_load_on_strings(tmp_path, which):
    text = EDGE_CASES if which == "edge cases" else _test_cli_strings(tmp_path)[which]
    got, want = yaml_subset.parse(text), yaml.safe_load(text)
    assert _same(got, want), (got, want)
    if which == "edge cases":  # the traps, spelled out
        assert got["a"] == "1e-3" and got["b"] == "3e-6" and got["c"] == 0.001 and got["aa"] == "1e3"
        assert got["e"] is True and got["f"] is None and got["g"] is None and got["h"] == "1"
        assert got["m"] == 15 and got["n"] == "08" and got["o"] == 90 and got["nest"]["deep"]["empty"] is None


@pytest.mark.parametrize("path", JAX_CONFIGS, ids=NAMES)
def test_loader_builds_the_jax_loaders_config(path):
    setting = os.path.join(os.path.dirname(path), "hiast_setting.yaml")
    assert load_config(path).to_dict() == jax_load_config(path).to_dict()
    assert load_config(path, setting).to_dict() == jax_load_config(path, setting).to_dict()


@pytest.mark.parametrize("name", NAMES)
def test_port_copy_reads_as_the_jax_file(name):
    with open(os.path.join(REPO, "hiast_tpu", "configs", name)) as f:
        want = yaml.safe_load(f)
    assert _same(yaml_subset.load(os.path.join(PORT_CONFIGS, name)), want)


@pytest.mark.parametrize("text,line,what", [
    ("a: 1\nb: &anchor 2\n", 2, "'&'"),
    ("a: 1\nb: *alias\n", 2, "'*'"),
    ("a: |\n  text\n", 1, "'|'"),
    ("a: >\n  text\n", 1, "'>'"),
    ("a: 1\n---\nb: 2\n", 2, "more than one document"),
    ("a:\n\tb: 1\n", 2, "a tab"),
    ("a:\n  - 1\n", 2, "'-'"),
    ("a: {b: 1}\n", 1, "'{'"),
    ("a: [1,\n  2]\n", 1, "close on its line"),
    ("a: !!str 1\n", 1, "'!'"),
    ("a: 2001-12-14\n", 1, "timestamp"),
    ("a: b: c\n", 1, "mapping value"),
    ("a:\n  b: 1\n c: 2\n", 3, "indentation"),
    ("a: 'open\n", 1, "quoted scalar"),
])
def test_outside_the_subset_raises_with_its_line(text, line, what):
    with pytest.raises(ValueError, match=rf"^cfg\.yaml:{line}: .*{what}"):
        yaml_subset.parse(text, "cfg.yaml")


def test_loader_reads_every_config_without_yaml():
    """In a fresh interpreter where ``import yaml`` fails, the port's loader
    reads the nine shipped configs (and sl_1 with hiast_setting) into the
    configs that the JAX loader builds from the JAX package's files."""
    pairs = [[os.path.join(PORT_CONFIGS, n), None] for n in NAMES]
    pairs.append([os.path.join(PORT_CONFIGS, "sl_1.yaml"), os.path.join(PORT_CONFIGS, "hiast_setting.yaml")])
    code = (
        "import json, sys; sys.modules['yaml'] = None\n"
        "from hiast_tpu_torch.config import load_config\n"
        f"pairs = {pairs!r}\n"
        "print(json.dumps([load_config(c, s).to_dict() for c, s in pairs]))\n"
        "assert sys.modules['yaml'] is None\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout)
    jax_dir = os.path.join(REPO, "hiast_tpu", "configs")
    want = [jax_load_config(os.path.join(jax_dir, n)).to_dict() for n in NAMES]
    want.append(jax_load_config(os.path.join(jax_dir, "sl_1.yaml"),
                                os.path.join(jax_dir, "hiast_setting.yaml")).to_dict())
    assert got == json.loads(json.dumps(want))
