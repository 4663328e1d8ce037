"""Native (C++) host pipeline of the port, built at first use and loaded
with ctypes.

`readpack.cpp` is compiled with `$CXX` (default `g++`) `-O3 -march=native
-shared -fPIC` into `real_tpu_torch/native/build/libreadpack-<hash>.so`,
keyed by a hash of the source, the flags and the host CPU's instruction-set
flags (`-march=native` binds the library to them, and a checkout may be
shared between machines), written through a temporary name and
`os.replace` so that concurrent first uses do not collide. No library is
committed. A missing compiler, a failed build or a failed load
raises: the host entry points never step down to their NumPy versions on
their own. The NumPy versions stay in the package as the plain versions and
are reached only by an explicit `use_native=False`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
from pathlib import Path
from typing import Optional

SRC = Path(__file__).resolve().parent / "readpack.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "build"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_lib: Optional[ctypes.CDLL] = None


def _compiler() -> str:
    cxx = os.environ.get("CXX") or "g++"
    found = shutil.which(cxx)
    if found is None:
        raise RuntimeError(
            f"C++ compiler {cxx!r} not found: the native host library "
            "builds with g++ (or $CXX) at first use")
    return found


def _host_cpu() -> str:
    """What -march=native resolves to on this host, as far as it can be
    read: the CPU's flags line, else the machine name."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    return line
    except OSError:
        pass
    return platform.machine()


def library_path(src: Optional[Path] = None,
                 build_dir: Optional[Path] = None) -> Path:
    """Build `src` (default SRC, into BUILD_DIR) if its hashed library is
    missing; raises on failure."""
    src = SRC if src is None else src
    build_dir = BUILD_DIR if build_dir is None else build_dir
    cxx = _compiler()
    digest = hashlib.sha256(
        src.read_bytes()
        + " ".join((cxx, *CXX_FLAGS, _host_cpu())).encode()).hexdigest()[:16]
    out = build_dir / f"libreadpack-{digest}.so"
    if out.exists():
        return out
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed for {src}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load_library(path: Path) -> ctypes.CDLL:
    """ctypes handle of a built readpack library with every entry's
    argument and result types declared."""
    lib = ctypes.CDLL(str(path))
    i64, i32 = ctypes.c_int64, ctypes.c_int32
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i8p = ctypes.POINTER(ctypes.c_int8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    sigs = {
        "fasta_reads_count": ([u8p, i64, i64p, i64p, i64p], None),
        "fasta_reads_fill": ([u8p, i64, u8p, i64p, u8p, i64p], None),
        "fastq_reads_count": ([u8p, i64, i64p, i64p, i64p], ctypes.c_int),
        "fastq_reads_fill": ([u8p, i64, u8p, i8p, i64p, u8p, i64p, i32],
                             ctypes.c_int),
        "genome_count": ([u8p, i64, i64p, i64p, i64p], None),
        "genome_fill": ([u8p, i64, u8p, i64p, u8p, i64p], None),
        "pack_rows_2bit": ([u8p, i64, i64, u32p, i64], None),
        "format_records_bound": ([i64, i64p, i64p, i64p, i64p, i64p], i64),
        "format_records": ([i64, u8p, i64p, u8p, i64p, i64p, u8p, f32p, u8p,
                            i64p, i64p, i64p, i32p, u8p, i64], i64),
        "radix_argsort3": ([i64, u64p, u64p, u64p, i64p], None),
    }
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def get_lib() -> ctypes.CDLL:
    """The loaded library (built on first use). Raises when the compiler
    is missing or the build or the load fails; never returns None."""
    global _lib
    if _lib is None:
        _lib = load_library(library_path())
    return _lib
