"""real_tpu_torch imports nothing of JAX or real_tpu, and its entry points
run on the CPU only when asked to."""

import ast
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import real_tpu_torch
from real_tpu_torch.cli import main as t_main
from real_tpu_torch.config import RealConfig
from real_tpu_torch.engine import driver
from real_tpu_torch.io import reads as reads_io
from tests import ab_util

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_FILES = [os.path.join(root, f)
              for root, _, files in os.walk(os.path.join(REPO,
                                                         "real_tpu_torch"))
              for f in files if f.endswith(".py")] \
    + [os.path.join(REPO, "chip_smoke.py")]


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        real_tpu_torch.__path__, "real_tpu_torch."))


def test_every_module_imports_with_jax_and_real_tpu_poisoned():
    mods = _port_modules()
    assert len(mods) >= 15
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'real_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import importlib\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'real_tpu') and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[os.path.relpath(p, REPO) for p in PORT_FILES])
def test_no_jax_or_real_tpu_import_in_source(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "real_tpu"), (path, n)


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without CUDA")


def test_entry_points_without_device_raise_without_cuda(tmp_path, no_cuda):
    genome, reads = ab_util.make_inputs(tmp_path, n=5000, numpat=20)
    cfg = RealConfig(textfilename=genome, patternfilename=reads,
                     outputfilename="-", batch_size=512)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        driver.load_texts(cfg)
    texts = driver.load_texts(cfg, "cpu")
    rs = reads_io.parse_reads(reads)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        driver.run_match_unique(cfg, rs, texts)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_main.main(["-t", genome, "-p", reads,
                     "-o", str(tmp_path / "o.txt")])
    assert not (tmp_path / "o.txt").exists()
