"""The benchmark loads nothing of JAX or of the JAX package, and its
yardstick (generator, reference, comparison, trace arithmetic, metric
readers) nothing of the program either."""

import ast
import os
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
FILES = sorted(os.path.join(r, f) for r, _, fs in os.walk(BENCH)
               for f in fs if f.endswith(".py"))
NEVER = {"jax", "jaxlib", "flax", "real_tpu", "benchmarks"}
# the files that drive or test the program; every other file is the yardstick
PROGRAM_USERS = {os.path.join(BENCH, "run.py")}


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _top(name):
    return name.split(".")[0]


@pytest.mark.parametrize("path", FILES,
                         ids=[os.path.relpath(p, BENCH) for p in FILES])
def test_no_jax_or_jax_package_import(path):
    bad = [m for m in _imports(path) if _top(m) in NEVER]
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize(
    "path", [p for p in FILES if p not in PROGRAM_USERS
             and os.sep + "tests" + os.sep not in p],
    ids=lambda p: os.path.relpath(p, BENCH))
def test_yardstick_imports_nothing_of_the_program(path):
    bad = [m for m in _imports(path) if _top(m) == "real_tpu_torch"]
    assert not bad, f"{path} imports {bad}"


def test_whole_top_level_names_are_compared():
    sys.path.insert(0, ROOT)
    from portbench import run
    assert "real_tpu" in run.FORBIDDEN
    assert "real_tpu_torch".split(".")[0] not in run.FORBIDDEN


def test_modules_import_with_jax_and_real_tpu_poisoned():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'real_tpu', 'benchmarks'):\n"
        "    sys.modules[m] = None\n"
        "import importlib, importlib.util, glob\n"
        "from portbench import run\n"
        "for m in ('gen', 'check', 'trace', 'reference_unique'):\n"
        "    importlib.import_module('portbench.' + m)\n"
        "import real_tpu_torch.cli.main\n"
        "for p in glob.glob('portbench/metrics/*.py'):\n"
        "    spec = importlib.util.spec_from_file_location('m', p)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "assert not run.forbidden_modules(), run.forbidden_modules()\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_no_card_no_result():
    """Without a CUDA card the run exits non-zero and prints nothing on
    standard output."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "chr21.u.100k",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout == ""
