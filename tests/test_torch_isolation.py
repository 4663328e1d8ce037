"""real_tpu_torch imports nothing of JAX or real_tpu, and its entry points
run on the CPU only when asked to."""

import ast
import dataclasses
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
from real_tpu_torch.parallel import multihost
from real_tpu_torch.tools import gatherbench
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
    assert {"real_tpu_torch.native", "real_tpu_torch.io.native_io",
            "real_tpu_torch.io.readstore"} <= set(mods)
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
        driver.run_match_all(cfg, rs, texts, as_arrays=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gatherbench.main(["--m", "5000", "--n", "64"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_main.main(["-t", genome, "-p", reads,
                     "-o", str(tmp_path / "o.txt")])
    assert not (tmp_path / "o.txt").exists()
    # a run with -exchange names no device either
    x_cfg = dataclasses.replace(cfg, build_exchange_dir=str(tmp_path / "xdir"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        driver.run_match_unique(x_cfg, rs, texts)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        driver.run_match_all(x_cfg, rs, texts, as_arrays=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        multihost.main(["-t", genome, "-p", reads, "-o",
                        str(tmp_path / "x.txt"), "-exchange",
                        str(tmp_path / "xdir")])
    assert not (tmp_path / "x.txt.0").exists()
    assert not (tmp_path / "xdir").exists()


NATIVE_MODULES = ["real_tpu_torch/native/__init__.py",
                  "real_tpu_torch/io/native_io.py",
                  "real_tpu_torch/io/readstore.py"]


PLANNER_MODULES = ["parallel/plan.py", "engine/checkpoint.py",
                   "utils/watchdog.py", "io/pipeline.py"]


@pytest.mark.parametrize("rel", PLANNER_MODULES)
def test_planner_and_run_control_modules_are_walked(rel):
    """The modules of the shard planner, the checkpoints and the watchdog
    are among the imported modules and the checked sources."""
    assert os.path.join(REPO, "real_tpu_torch", rel) in PORT_FILES
    name = "real_tpu_torch." + rel[:-3].replace("/", ".")
    assert name in _port_modules()


SLICE_MODULES = ["parallel/multihost.py", "tools/cli.py"]


@pytest.mark.parametrize("rel", SLICE_MODULES)
def test_multihost_and_tools_modules_are_walked(rel):
    """The multi-process run and the helper tools are among the imported
    modules and the checked sources."""
    assert os.path.join(REPO, "real_tpu_torch", rel) in PORT_FILES
    name = "real_tpu_torch." + rel[:-3].replace("/", ".")
    assert name in _port_modules()


GENOME_SCALE_MODULES = ["tools/gendata.py", "tools/graft_entry.py"]


@pytest.mark.parametrize("rel", GENOME_SCALE_MODULES)
def test_genome_scale_tools_are_walked_and_import_no_benchmarks(rel):
    """The data generator and the driver entry points are among the
    imported modules and the checked sources, and neither imports the
    repository's benchmarks (whose generator they copy)."""
    path = os.path.join(REPO, "real_tpu_torch", rel)
    assert path in PORT_FILES
    assert "real_tpu_torch." + rel[:-3].replace("/", ".") in _port_modules()
    for node in ast.walk(ast.parse(open(path).read(), filename=path)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        assert all(n.split(".")[0] not in ("jax", "real_tpu", "benchmarks")
                   for n in names), (rel, names)


@pytest.mark.parametrize("rel", NATIVE_MODULES)
def test_native_host_modules_are_checked_sources(rel):
    """The modules of the native host pipeline are among the files whose
    imports are checked above."""
    assert os.path.join(REPO, rel) in PORT_FILES


def test_native_host_path_runs_with_jax_and_real_tpu_poisoned(tmp_path):
    """The host library builds, loads and parses in a process where jax
    and real_tpu cannot be imported, and the read store round-trips."""
    reads = tmp_path / "r.fa"
    reads.write_text(">r0\nACGTACGTAC\n>r1\nGGTTNACC\n")
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'real_tpu'):\n"
        "    sys.modules[m] = None\n"
        "from real_tpu_torch import native\n"
        "from real_tpu_torch.io import readstore\n"
        "assert native.get_lib() is not None\n"
        f"a = readstore.parse_reads_cached({str(reads)!r})\n"
        f"b = readstore.parse_reads_cached({str(reads)!r})\n"
        "assert a.num_reads == b.num_reads == 2\n"
        "assert list(a.lengths) == [10, 8] == list(b.lengths)\n"
        "assert type(b.codes_flat).__name__ == 'memmap'\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'real_tpu') and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
