"""What bounds the match step's random fetches on the card, measured.

    python -m real_tpu_torch.tools.gathertune

Two sweeps over tables of random words at the yeast batch shape (32,768
reads: 393,216 probes or lanes), each line one device time (tools/cudatime,
CUDA events behind a sleep kernel):

  constants  csrc/gather_windows.cu rebuilt with other values of kThreads,
             kLanes (lanes per thread of the generic gather) and kProbes
             (probes per thread of probe_candidates): probe_candidates and
             the gather at w = 2 and w = 4 over a 403 MB bucket table and
             a 288 MB signature table (every lane misses L2)
  table size the shipped gather at w = 2 over tables from 16 MB (inside the
             50 MB L2) to 1 GB, the lane count fixed

Needs a CUDA card and nvcc; prints the card's name and power limit last.
"""

from __future__ import annotations

import ctypes
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch

from real_tpu_torch.ops import cuda_build, gather
from real_tpu_torch.tools.cudatime import time_ms

# (kThreads, kLanes, kProbes); the first is the shipped setting
VARIANTS = [(128, 4, 2), (128, 1, 1), (256, 1, 1), (512, 1, 1), (128, 2, 1),
            (128, 8, 4), (128, 4, 4), (64, 4, 2), (256, 4, 2), (256, 2, 2)]
M, NBUCK, B = 11_999_984, (1 << 24) + 1, 32_768      # the yeast index
TABLE_MB = (16, 64, 128, 256, 403, 1024)


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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("gathertune: CUDA is not available")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    constants_sweep(gen)
    table_size_sweep(gen)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())


if __name__ == "__main__":
    main()
