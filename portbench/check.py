"""The comparison that decides `correct`: a job's records against the
reference's, read by read, on a sample of reads drawn from the seed.

A job's output is the bytes the program wrote to its standard output. Its
records are found by read id (the generator's fixed-width 'r%09d'), so a
reordered read file is compared read for read like its draw. A sampled
read differs when its record is not the reference's, byte for byte, or
when one of them has a record and the other none, or when the output holds
the read twice. Every line that is not a record of a read of the file
counts as one difference more.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from portbench.gen import ID_WIDTH


def _lines(a: np.ndarray, num_reads: int):
    """(starts, ends, read number) of the complete lines of `a` that are
    records of a read of the file, and how many complete lines are not."""
    nl = np.flatnonzero(a == ord("\n"))
    starts = (np.concatenate([[0], nl[:-1] + 1]) if len(nl)
              else np.zeros(0)).astype(np.int64)
    ends = nl.astype(np.int64) + 1
    ok = ends - starts > ID_WIDTH + 1
    s = starts[ok]
    ok[ok] = (a[s] == ord("r")) & (a[s + ID_WIDTH] == ord("\t"))
    s = starts[ok]
    num = np.zeros(len(s), np.int32)         # 9 digits fit
    good = np.ones(len(s), bool)
    for k in range(1, ID_WIDTH):
        digit = a[s + k] - np.uint8(ord("0"))  # wraps past '9' either way
        good &= digit < 10
        num = num * 10 + digit
    good &= num < num_reads
    bad = int((~ok).sum() + (~good).sum())
    lines = np.flatnonzero(ok)[good]
    return starts[lines], ends[lines], num[good], bad


def sampled_lines(chunks: List[bytes], num_reads: int,
                  keep: np.ndarray) -> Tuple[bytes, int]:
    """What the comparison needs of an output written as `chunks`: the
    lines that are records of the reads with keep[read] True, in order,
    and how many lines are no record of a read of the file (a cut last
    line among them). A line may span chunks."""
    kept: List[bytes] = []
    bad, tail = 0, b""
    for chunk in chunks:
        blob = tail + chunk if tail else chunk
        last = blob.rfind(b"\n") + 1
        starts, ends, num, b = _lines(np.frombuffer(blob, np.uint8, last),
                                      num_reads)
        bad += b
        for i in np.flatnonzero(keep[num]).tolist():
            kept.append(blob[starts[i]:ends[i]])
        tail = blob[last:]
    return b"".join(kept), bad + int(len(tail) > 0)


def differing(blob: bytes, num_reads: int, rows: np.ndarray,
              expected: List[Optional[bytes]]) -> int:
    """How many of the reads `rows` have another record in `blob` than
    `expected` (None: no record), plus the lines of `blob` that are no
    read's record."""
    a = np.frombuffer(blob, np.uint8)
    bad = int(len(a) > 0 and a[-1] != ord("\n"))   # a cut last line
    starts, ends, num, b = _lines(a, num_reads)
    bad += b
    count = np.bincount(num, minlength=num_reads)
    line_of = np.full(num_reads, -1, np.int64)
    line_of[num] = np.arange(len(num))
    for r, want in zip(rows.tolist(), expected):
        i = line_of[r]
        got = None if i < 0 else blob[starts[i]:ends[i]]
        bad += int(got != want or count[r] > 1)
    return bad
