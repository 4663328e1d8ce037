"""The record formatter's score digits against snprintf, over float32 bit
patterns.

native/readpack.cpp writes a record's score, "%.6g" of the float32 widened
to double, in 64-bit integer arithmetic for 0 and 1e-3 <= |f| < 1e9, and
leaves every other value to snprintf. `check` compares the integer path's
bytes with snprintf's for every `stride`-th float32 bit pattern of a range,
both signs, on several threads (the native entry releases the interpreter
lock).

    python -m real_tpu_torch.tools.scorecheck

checks every pattern on one thread a core (about a minute on 8 cores) and
prints one JSON line: the patterns, those that took the integer path and
were compared, and those that differ (the exit code is 1 if any do).
"""

from __future__ import annotations

import ctypes
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

from real_tpu_torch import native

PATTERNS = 1 << 32


def check(stride: int = 1, threads: Optional[int] = None,
          lo: int = 0, hi: int = PATTERNS) -> Tuple[int, int]:
    """(patterns that differ, patterns compared) among lo, lo + stride,
    ... below hi; thread i of T takes every T-th of them."""
    lib = native.get_lib()
    threads = threads or os.cpu_count() or 1

    def part(i: int) -> Tuple[int, int]:
        seen = ctypes.c_int64()
        bad = lib.format_score_check(lo + i * stride, hi, stride * threads,
                                     ctypes.byref(seen))
        return bad, seen.value

    with ThreadPoolExecutor(max_workers=threads) as ex:
        parts = list(ex.map(part, range(threads)))
    return sum(p[0] for p in parts), sum(p[1] for p in parts)


def main() -> int:
    t = time.perf_counter()
    bad, seen = check()
    print(json.dumps({
        "patterns": PATTERNS, "compared": seen, "differ": bad,
        "seconds": round(time.perf_counter() - t, 1)}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
