"""Build, load and launch the port's CUDA kernels (plain C interface,
ctypes).

Each kernel source `real_tpu_torch/csrc/<name>.cu` is compiled with nvcc
for sm_90a into `real_tpu_torch/csrc/build/lib<name>-<hash>.so` at first
use, keyed by a hash of the source and the flags, and loaded with ctypes.
No PyTorch headers are included, so a build takes seconds. A missing
nvcc or a failed build raises: there is no fallback. `launch` calls an
entry point on a device's current stream; `all_on_cpu` is the wrappers'
dispatch rule (the plain version for CPU tensors, the kernel for one CUDA
device, anything else raises).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_ENTRIES: Dict[tuple, object] = {}
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


def launch(name: str, entry: str, argtypes: List, device: torch.device,
           *args) -> None:
    """Call the C entry point `entry` of csrc/<name>.cu (built and bound on
    first use; `argtypes` end with the stream's) with `args` and
    `device`'s current stream; raises if the launch is refused."""
    fn = _ENTRIES.get((name, entry))
    if fn is None:
        fn = getattr(load(name), entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _ENTRIES[(name, entry)] = fn
    index = device.index
    current = torch.cuda.current_device()
    if index is None:
        index = current
    raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    stream = raw_stream(index) if raw_stream is not None \
        else torch.cuda.current_stream(index).cuda_stream
    if index == current:
        rc = fn(*args, stream)
    else:
        with torch.cuda.device(index):
            rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")


def all_on_cpu(name: str, *tensors: torch.Tensor) -> bool:
    """True when every tensor is on the CPU (the plain version serves
    them), False when all are on one CUDA device; anything else raises."""
    devices = {t.device for t in tensors}
    if all(d.type == "cpu" for d in devices):
        return True
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(
            f"{name}: tensors on {sorted(str(d) for d in devices)}; all "
            "must be on one CUDA device (or the CPU)")
    return False
