"""Build and load the port's CUDA kernels (plain C interface, ctypes).

Each kernel source `real_tpu_torch/csrc/<name>.cu` is compiled with nvcc
for sm_90a into `real_tpu_torch/csrc/build/lib<name>-<hash>.so` at first
use, keyed by a hash of the source and the flags, and loaded with ctypes.
No PyTorch headers are included, so a build takes seconds. A missing
nvcc or a failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
# ptxas register/spill report of each kernel built by this process
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build with the "
                       "CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> Path:
    """Build csrc/<name>.cu if its hashed library is missing."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
    os.replace(tmp, out)
    build_logs[name] = proc.stderr
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library csrc/<name>.cu (built on first use)."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib
