"""What bounds the port's random fetches on the card, measured.

    python -m real_tpu_torch.tools.gathertune [--sweeps constants,table,rowsum]

Each line is one device time (tools/cudatime, CUDA events behind a sleep
kernel). Two sweeps over tables of random words at the yeast batch shape
(32,768 reads: 393,216 probes or lanes):

  constants  csrc/gather_windows.cu rebuilt with other values of kThreads,
             kLanes (lanes per thread of the generic gather) and kProbes
             (probes per thread of probe_candidates): probe_candidates and
             the gather at w = 2 and w = 4 over a 403 MB bucket table and
             a 288 MB signature table (every lane misses L2)
  table size the shipped gather at w = 2 over tables from 16 MB (inside the
             50 MB L2) to 1 GB, the lane count fixed

and one at the gather micro-benchmark's shape (262,144 lanes, w = 8, an
11.7 MB table inside the L2 and a 110 MB table past it):

  rowsum     csrc/rowsum_tune.cu: an empty kernel of the same grid, index
             load + store, one table word per lane (the floor of a
             scattered gather of that grid), the earlier row-gather-sum
             (run-time w, scalar loads), the shipped one, the designs
             weighed against it, and the shipped one under an L2
             access-policy window; every variant's lane sums must equal
             gather_rowsum_ref's

Needs a CUDA card and nvcc; prints the card's name and power limit last.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch

from real_tpu_torch.ops import cuda_build, gather, rowsum
from real_tpu_torch.tools import gatherbench
from real_tpu_torch.tools.cudatime import time_ms

# (kThreads, kLanes, kProbes); the first is the shipped setting
VARIANTS = [(128, 4, 2), (128, 1, 1), (256, 1, 1), (512, 1, 1), (128, 2, 1),
            (128, 8, 4), (128, 4, 4), (64, 4, 2), (256, 4, 2), (256, 2, 2)]
M, NBUCK, B = 11_999_984, (1 << 24) + 1, 32_768      # the yeast index
TABLE_MB = (16, 64, 128, 256, 403, 1024)
# rowsum sweep: the micro-benchmark's default table and the size of the
# matchUnique signature table (110 MB); variants of csrc/rowsum_tune.cu
ROWSUM_M = (2_920_000, 27_599_904)
ROWSUM_N, ROWSUM_W = 262_144, 8
ROWSUM_VARIANTS = ("empty", "idx_store", "one_word", "scalar_rt", "subwarp_8")
# (threads per block, lanes per thread) of the grid kernel, each with
# scalar loads, with uint4 loads through and past L1, and as an empty kernel
ROWSUM_GRID = [(t, l) for l in (1, 2, 4, 8) for t in (64, 128, 256, 512, 1024)
               if t * l <= 2048]
ROWSUM_GRID_MODES = ("scalar", "uint4", "uint4_ldcg", "empty")
ROWSUM_EXACT_FROM = 3       # variants from here on compute the lane sums


def _build_variant(variant) -> ctypes.CDLL:
    """gather_windows.cu with its three constants replaced, built beside
    the shipped library."""
    src = (cuda_build.CSRC / f"{gather.KERNEL}.cu").read_text()
    for name, shipped, value in zip(("kThreads", "kLanes", "kProbes"),
                                    VARIANTS[0], variant):
        old = f"constexpr int {name} = {shipped};"
        if src.count(old) != 1:
            raise RuntimeError(f"{old!r} not found once in the source")
        src = src.replace(old, f"constexpr int {name} = {value};")
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = cuda_build.BUILD_DIR / "tune_{}_{}_{}".format(*variant)
    stem.with_suffix(".cu").write_text(src)
    flags = [f for f in cuda_build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([cuda_build._nvcc(), *flags, "-o",
                    str(stem.with_suffix(".so")),
                    str(stem.with_suffix(".cu"))], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(stem.with_suffix(".so")))
    for entry in ("probe_candidates_i32", "gather_windows_i32"):
        getattr(lib, entry).argtypes = gather._ARGTYPES[entry]
        getattr(lib, entry).restype = ctypes.c_int
    return lib


def _random_i32(n: int, gen) -> torch.Tensor:
    return torch.randint(-2**31, 2**31 - 1, (n,), device="cuda",
                         generator=gen).to(torch.int32)


def constants_sweep(gen) -> None:
    with ThreadPoolExecutor(len(VARIANTS)) as ex:
        libs = list(ex.map(_build_variant, VARIANTS))
    sig = _random_i32(6 * M, gen)
    bb = torch.randint(0, M, (6 * NBUCK,), device="cuda",
                       generator=gen).to(torch.int32)
    probe = torch.randint(0, 2**32, (B, 12), device="cuda", generator=gen)
    valid = torch.ones(B, dtype=torch.bool, device="cuda")
    idx_b = torch.randint(0, 6 * NBUCK - 2, (12 * B,), device="cuda",
                          generator=gen).to(torch.int32)
    idx_c = torch.randint(0, 6 * M - 4, (12 * B,), device="cuda",
                          generator=gen).to(torch.int32)
    begin = torch.empty((B, 12), dtype=torch.int32, device="cuda")
    count = torch.empty_like(begin)
    lanes = torch.empty((B, 12, 4), dtype=torch.int32, device="cuda")
    cand = torch.empty((B, 12, 4), dtype=torch.bool, device="cuda")
    out = torch.empty((4, 12 * B), dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    first = None
    for variant, lib in zip(VARIANTS, libs):
        def probes():
            return lib.probe_candidates_i32(
                sig.data_ptr(), M, bb.data_ptr(), NBUCK, probe.data_ptr(),
                valid.data_ptr(), 12 * B, 8, 4, begin.data_ptr(),
                count.data_ptr(), lanes.data_ptr(), cand.data_ptr(), stream)

        def bounds():
            return lib.gather_windows_i32(
                bb.data_ptr(), bb.numel(), idx_b.data_ptr(), idx_b.numel(),
                2, out.data_ptr(), stream)

        def tier1():
            return lib.gather_windows_i32(
                sig.data_ptr(), sig.numel(), idx_c.data_ptr(), idx_c.numel(),
                4, out.data_ptr(), stream)

        if probes() or bounds() or tier1():
            raise RuntimeError(f"variant {variant}: a launch was refused")
        torch.cuda.synchronize()
        sums = (int(begin.sum()), int(count.sum()),
                int(lanes.to(torch.int64).sum()), int(cand.sum()))
        first = first or sums
        if sums != first:
            raise RuntimeError(f"variant {variant} computes other values")
        us = [time_ms(f)[0] * 1e3 for f in (probes, bounds, tier1)]
        print("[constants] kThreads {:3d} kLanes {} kProbes {}: "
              "probe_candidates {:.2f} us, gather w=2 {:.2f} us, "
              "gather w=4 {:.2f} us".format(*variant, *us), flush=True)


def table_size_sweep(gen) -> None:
    n = 12 * B
    for mb in TABLE_MB:
        table = _random_i32(mb * 250_000, gen)
        idx = torch.randint(0, table.numel() - 2, (n,), device="cuda",
                            generator=gen).to(torch.int32)
        us = time_ms(lambda: gather.gather_word_windows(table, idx, 2))[0] \
            * 1e3
        print(f"[table size] gather w=2, {n} lanes, {mb} MB table: "
              f"{us:.2f} us = {n / us / 1e3:.1f} G lanes/s", flush=True)
        del table


def _build_rowsum_tune() -> ctypes.CDLL:
    """csrc/rowsum_tune.cu (which includes gather_rowsum.cu), built anew
    beside the shipped libraries."""
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = cuda_build.BUILD_DIR / "tune_rowsum.so"
    flags = [f for f in cuda_build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    proc = subprocess.run([cuda_build._nvcc(), *flags, "-o", str(out),
                           str(cuda_build.CSRC / "rowsum_tune.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for rowsum_tune.cu:\n{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.rowsum_tune_i32.argtypes = [ctypes.c_int, p, i64, p, i64, p, p]
    lib.rowsum_tune_i32.restype = ctypes.c_int
    lib.gather_rowsum_i32.argtypes = [p, i64, p, i64, ctypes.c_int, p, p]
    lib.gather_rowsum_i32.restype = ctypes.c_int
    lib.rowsum_tune_grid_i32.argtypes = [ctypes.c_int] * 3 + [p, i64, p, i64,
                                                              p, p]
    lib.rowsum_tune_grid_i32.restype = ctypes.c_int
    lib.rowsum_tune_l2_window.argtypes = [p, i64, ctypes.POINTER(i64), p]
    lib.rowsum_tune_l2_window.restype = ctypes.c_int
    return lib


def rowsum_sweep() -> None:
    lib = _build_rowsum_tune()
    n, w = ROWSUM_N, ROWSUM_W
    for m in ROWSUM_M:
        table, idx = gatherbench.make_inputs(m, n, "cuda")
        want = rowsum.gather_rowsum_ref(table, idx, w)
        out = torch.empty(n, dtype=torch.int32, device="cuda")
        tag = f"[rowsum] {table.numel() * 4 / 1e6:.1f} MB table, {n} lanes"

        def call(variant, stream):
            if isinstance(variant, tuple):
                mode, threads, lanes = variant
                return lib.rowsum_tune_grid_i32(
                    ROWSUM_GRID_MODES.index(mode), threads, lanes,
                    table.data_ptr(), table.numel(), idx.data_ptr(), n,
                    out.data_ptr(), stream)
            if variant == "shipped":
                return lib.gather_rowsum_i32(
                    table.data_ptr(), table.numel(), idx.data_ptr(), n, w,
                    out.data_ptr(), stream)
            return lib.rowsum_tune_i32(
                ROWSUM_VARIANTS.index(variant), table.data_ptr(),
                table.numel(), idx.data_ptr(), n, out.data_ptr(), stream)

        def timed(variant, note=""):
            stream = torch.cuda.current_stream().cuda_stream
            out.zero_()
            if call(variant, stream):
                raise RuntimeError(f"{variant}: the launch was refused")
            torch.cuda.synchronize()
            if isinstance(variant, tuple):
                exact = variant[0] != "empty"
            else:
                exact = (variant == "shipped" or ROWSUM_VARIANTS.index(variant)
                         >= ROWSUM_EXACT_FROM)
            if exact and not torch.equal(out, want):
                raise RuntimeError(f"{variant} computes other lane sums")
            us = time_ms(lambda: call(variant, stream))[0] * 1e3
            if not isinstance(variant, tuple):
                print(f"{tag}, w={w}: {variant}{note} {us:.2f} us",
                      flush=True)
            return us

        # the shipped kernel first and last: drift inside the sweep shows
        for variant in ("shipped", *ROWSUM_VARIANTS, "shipped"):
            timed(variant)
        for threads, lanes in ROWSUM_GRID:
            us = [timed((mode, threads, lanes)) for mode in ROWSUM_GRID_MODES]
            print(f"{tag}, w={w}: grid {threads:4d} threads x {lanes} lanes "
                  "per thread: scalar {:.2f} us, uint4 {:.2f} us, uint4 "
                  "past L1 {:.2f} us, empty {:.2f} us".format(*us),
                  flush=True)
        timed("shipped")
        # the access-policy window belongs to a stream of its own (the
        # legacy default stream takes no attributes)
        side = torch.cuda.Stream()
        with torch.cuda.stream(side):
            carve = ctypes.c_int64(0)
            rc = lib.rowsum_tune_l2_window(table.data_ptr(),
                                           table.numel() * 4,
                                           ctypes.byref(carve),
                                           side.cuda_stream)
            if rc:
                print(f"{tag}: L2 access-policy window refused (CUDA error "
                      f"{rc})", flush=True)
            else:
                timed("shipped", f" + L2 window (persisting carve "
                                 f"{carve.value / 2**20:.1f} MiB)")
            rc = lib.rowsum_tune_l2_window(None, 0, ctypes.byref(carve),
                                           side.cuda_stream)
            if rc:
                raise RuntimeError(f"clearing the L2 window: CUDA error {rc}")
        torch.cuda.synchronize()
        del table, idx, want


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sweeps", default="constants,table,rowsum",
                    help="comma-separated: constants, table, rowsum")
    sweeps = ap.parse_args(argv).sweeps.split(",")
    if set(sweeps) - {"constants", "table", "rowsum"}:
        raise SystemExit(f"gathertune: unknown sweep in {sweeps}")
    if not torch.cuda.is_available():
        raise SystemExit("gathertune: CUDA is not available")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    if "constants" in sweeps:
        constants_sweep(gen)
    if "table" in sweeps:
        table_size_sweep(gen)
    if "rowsum" in sweeps:
        rowsum_sweep()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())


if __name__ == "__main__":
    main()
