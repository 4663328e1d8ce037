"""The comparison that decides `correct`: a job's records against the
reference's, read by read, on a sample of reads drawn from the seed.

A job's output is the bytes the program wrote to its standard output. Its
records are found by read id (the generator's fixed-width 'r%09d'), so a
reordered read file is compared read for read like its draw. A read may
have any number of records (matchAll prints one a hit, in no fixed order),
so a sampled read's records are compared as a multiset of lines: the read
differs when the sorted list of its lines in the output is not the sorted
list of the reference's, byte for byte. That catches a record missing,
one more, one printed twice and one with a byte changed, and is blind to
order. Every line that is not a record of a read of the file counts as
one difference more, and so does a cut last line.
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


def _records(want: Optional[bytes]) -> List[bytes]:
    """The reference's entry for one read as its sorted lines, each with
    its newline (a last line without one kept as it is)."""
    if not want:
        return []
    lines = want.split(b"\n")
    out = [line + b"\n" for line in lines[:-1]]
    return sorted(out + [lines[-1]] if lines[-1] else out)


def differing(blob: bytes, num_reads: int, rows: np.ndarray,
              expected: List[Optional[bytes]]) -> int:
    """How many of the reads `rows` have other records in `blob` than
    `expected` (None: no record; else that read's record lines in any
    order), compared as multisets of lines, plus the lines of `blob` that
    are no read's record and a cut last line."""
    a = np.frombuffer(blob, np.uint8)
    bad = int(len(a) > 0 and a[-1] != ord("\n"))   # a cut last line
    starts, ends, num, b = _lines(a, num_reads)
    bad += b
    # the sampled reads' lines, grouped by read number in one stable sort
    sampled = np.zeros(num_reads, bool)
    sampled[rows] = True
    sel = np.flatnonzero(sampled[num])
    sel = sel[np.argsort(num[sel], kind="stable")]
    grouped = num[sel]
    first = np.searchsorted(grouped, rows)
    last = np.searchsorted(grouped, rows, side="right")
    s, e = starts[sel].tolist(), ends[sel].tolist()
    for i, j, want in zip(first.tolist(), last.tolist(), expected):
        # most reads have no record or one, on both sides: equal as bytes
        if (i == j and want is None) or (
                j - i == 1 and blob[s[i]:e[i]] == want):
            continue
        got = sorted(blob[s[k]:e[k]] for k in range(i, j))
        bad += got != _records(want)
    return bad
