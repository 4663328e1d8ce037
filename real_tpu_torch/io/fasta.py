"""Host-side genome FASTA parsing (vectorized NumPy).

Semantics mirror the reference exactly (countReads.cpp):
  * only the uppercase characters A,C,G,T,N are counted/kept — everything
    else (lowercase soft-masked bases, gaps, '\\r', digits) is silently
    dropped (countReads.cpp:67-70,110-117);
  * each '>' header contributes a fragment range (full header text after
    '>', up to but excluding the newline; cumulative ACGTN count at that
    point) (countReads.cpp:46-59);
  * a terminal range ("terminal", total_count) is appended
    (countReads.cpp:81).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

# A,C,G,T,N -> 0..4 (acgtnMap.hpp:39-49); everything else -> 255 (dropped)
_CODE_TABLE = np.full(256, 255, dtype=np.uint8)
for _i, _c in enumerate(b"ACGTN"):
    _CODE_TABLE[_c] = _i


def parse_genome(path: str) -> Tuple[np.ndarray, List[Tuple[str, int]]]:
    """Parse a genome FASTA file.

    Returns (codes, ranges): codes is a uint8 array of 0..4 base codes
    (concatenation of all fragments, no separators — exactly like the
    reference's AutoTextArray input), and ranges is a list of
    (fragment_id, cumulative_offset) pairs ending with ("terminal", n).
    """
    with open(path, "rb") as f:
        buf = np.frombuffer(f.read(), dtype=np.uint8)
    return parse_genome_bytes(buf)


def parse_genome_bytes(
        buf: np.ndarray) -> Tuple[np.ndarray, List[Tuple[str, int]]]:
    n = buf.shape[0]
    if n == 0:
        return np.zeros(0, dtype=np.uint8), [("terminal", 0)]

    nl = np.flatnonzero(buf == ord("\n"))
    line_starts = np.concatenate([[0], nl + 1])
    if line_starts[-1] >= n:
        line_starts = line_starts[:-1]
    line_ends = np.concatenate([nl, [n]])[: len(line_starts)]

    is_header = buf[line_starts] == ord(">")

    # keep-mask: data characters on non-header lines
    keep = np.ones(n, dtype=bool)
    for s, e in zip(line_starts[is_header], line_ends[is_header]):
        keep[s:e] = False
    data = buf[keep]
    codes_all = _CODE_TABLE[data]
    codes = codes_all[codes_all != 255]

    # cumulative ACGTN count before each byte position (for header offsets)
    counted = np.zeros(n, dtype=np.uint8)
    counted[keep] = (_CODE_TABLE[buf[keep]] != 255)
    cum = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counted, out=cum[1:])

    ranges: List[Tuple[str, int]] = []
    for s, e in zip(line_starts[is_header], line_ends[is_header]):
        if e == n and buf[-1] != ord("\n"):
            # reference only records a fragment when its header line is
            # newline-terminated (countReads.cpp:53-62)
            continue
        # header id: everything after '>' up to newline (includes spaces and
        # any '\r' — the reference keeps the raw tail of the line,
        # countReads.cpp:74)
        hdr = buf[s + 1:e].tobytes().decode("latin-1")
        ranges.append((hdr, int(cum[s])))
    ranges.append(("terminal", int(cum[n])))
    return codes, ranges
