"""Host-side read (pattern) parsing: FASTA and FASTQ (vectorized NumPy).

Mirrors the reference parsers:
  * FastAReader.hpp — id = full header line after '>', sequence = all
    non-whitespace characters until the next '>' (multi-line allowed);
  * FastQReader.hpp — 4-field records; quality chars have the quality
    offset subtracted (FastQReader.hpp:166-173); offset autodetect: first
    quality char <= 54 ('6') => Sanger 33, >= 94 => Illumina 64
    (FastQReader.hpp:219-239);
  * base mapping: uppercase A,C,G,T -> 0..3, anything else -> 4 (N)
    (Pattern.hpp:105-128, acgtnMap.hpp:39-49). Reads containing code 4 are
    skipped by the matcher (matchUniqueImplementation.cpp:385-394).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

_MAP_TABLE = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _MAP_TABLE[_c] = _i

_WHITESPACE = np.zeros(256, dtype=bool)
for _c in b" \t\r\n\v\f":
    _WHITESPACE[_c] = True


class IdView:
    """Lazy sequence of read id strings over one byte blob (a flat array
    like the reference's binary id streams, FastIDDecoder.hpp)."""

    __slots__ = ("blob", "off")

    def __init__(self, blob: np.ndarray, off: np.ndarray):
        self.blob = blob                # uint8 concatenated id bytes
        self.off = off                  # int64 [N+1]

    def __len__(self) -> int:
        return len(self.off) - 1

    def bytes_at(self, i: int) -> bytes:
        return self.blob[self.off[i]:self.off[i + 1]].tobytes()

    def __getitem__(self, i: int) -> str:
        return self.bytes_at(int(i)).decode("latin-1")

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


@dataclasses.dataclass
class ReadSet:
    """All reads of one input file, in input order (patid = index)."""
    ids: "IdView | List[str]"           # full header line per read
    lengths: np.ndarray                 # int32 [N]
    codes_flat: np.ndarray              # uint8, concatenated mapped codes
    offsets: np.ndarray                 # int64 [N+1] into codes_flat
    quals_flat: Optional[np.ndarray]    # int8 qualities (offset-subtracted)
    fastq: bool
    quality_offset: int = 0

    @property
    def num_reads(self) -> int:
        return len(self.ids)

    def length_buckets(self) -> Dict[int, np.ndarray]:
        """patids grouped by read length (ascending patid within bucket)."""
        buckets: Dict[int, np.ndarray] = {}
        for length in np.unique(self.lengths):
            buckets[int(length)] = np.flatnonzero(
                self.lengths == length).astype(np.int64)
        return buckets

    def dense_batch(self, patids: np.ndarray):
        """Dense [B, L] uint8 code matrix (+ qualities) for same-length
        reads."""
        length = int(self.lengths[patids[0]])
        if not (self.lengths[patids] == length).all():
            raise ValueError("dense_batch needs reads of one length")
        idx = self.offsets[patids][:, None] \
            + np.arange(length, dtype=np.int64)[None, :]
        codes = self.codes_flat[idx]
        quals = None
        if self.quals_flat is not None:
            quals = self.quals_flat[idx]
        return codes, quals


def parse_reads(path: str, quality_offset: int = 0) -> ReadSet:
    """Parse a read file ('-' = stdin, RealOptions.cpp:418-426)."""
    if path == "-":
        import sys
        buf = np.frombuffer(sys.stdin.buffer.read(), dtype=np.uint8)
    else:
        with open(path, "rb") as f:
            buf = np.frombuffer(f.read(), dtype=np.uint8)
    fastq = bool(buf.size) and _first_nonspace(buf) == ord("@")
    if fastq:
        return parse_fastq_bytes(buf, quality_offset)
    return parse_fasta_reads_bytes(buf)


def _first_nonspace(buf: np.ndarray) -> int:
    for i in range(0, len(buf), 4096):
        chunk = buf[i:i + 4096]
        idx = np.flatnonzero(~_WHITESPACE[chunk])
        if len(idx):
            return int(chunk[idx[0]])
    return 0


def _line_table(buf: np.ndarray):
    n = buf.shape[0]
    nl = np.flatnonzero(buf == ord("\n"))
    starts = np.concatenate([[0], nl + 1])
    if len(starts) and starts[-1] >= n:
        starts = starts[:-1]
    ends = np.concatenate([nl, [n]])[: len(starts)]
    return starts.astype(np.int64), ends.astype(np.int64)


def parse_fasta_reads_bytes(buf: np.ndarray) -> ReadSet:
    starts, ends = _line_table(buf)
    if len(starts) == 0:
        return ReadSet([], np.zeros(0, np.int32),
                       np.zeros(0, np.uint8), np.zeros(1, np.int64),
                       None, False)
    is_header = buf[starts] == ord(">")

    hs, he = starts[is_header] + 1, ends[is_header]
    id_off = np.zeros(len(hs) + 1, np.int64)
    np.cumsum(he - hs, out=id_off[1:])
    ids = IdView(buf[_concat_ranges(hs, he)], id_off)

    # record id per line: number of headers seen so far - 1
    rec_of_line = np.cumsum(is_header) - 1
    data_lines = ~is_header & (rec_of_line >= 0)

    line_lens = ends - starts
    rec_per_char = np.repeat(rec_of_line[data_lines], line_lens[data_lines])
    # character stream of data lines
    char_idx = _concat_ranges(starts[data_lines], ends[data_lines])
    chars = buf[char_idx]
    keep = ~_WHITESPACE[chars]
    chars = chars[keep]
    rec_per_char = rec_per_char[keep]

    codes_flat = _MAP_TABLE[chars]
    lengths = np.bincount(rec_per_char, minlength=len(ids)).astype(np.int32)
    offsets = np.zeros(len(ids) + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    return ReadSet(ids, lengths, codes_flat, offsets, None, False)


def parse_fastq_bytes(buf: np.ndarray, quality_offset: int = 0) -> ReadSet:
    starts, ends = _line_table(buf)
    nlines = len(starts)
    nrec = nlines // 4
    if nrec == 0:
        return ReadSet([], np.zeros(0, np.int32), np.zeros(0, np.uint8),
                       np.zeros(1, np.int64), np.zeros(0, np.int8), True,
                       quality_offset)
    s4 = starts[: nrec * 4].reshape(nrec, 4)
    e4 = ends[: nrec * 4].reshape(nrec, 4)
    ok = (buf[s4[:, 0]] == ord("@")).all() and (buf[s4[:, 2]] == ord("+")).all()
    if not ok:
        raise ValueError(
            "non 4-line FASTQ records are not supported by the fast parser")

    hs, he = s4[:, 0] + 1, e4[:, 0]
    id_off = np.zeros(len(hs) + 1, np.int64)
    np.cumsum(he - hs, out=id_off[1:])
    ids = IdView(buf[_concat_ranges(hs, he)], id_off)

    # sequences (strip internal whitespace e.g. '\r')
    seq_idx = _concat_ranges(s4[:, 1], e4[:, 1])
    seq_chars = buf[seq_idx]
    seq_rec = np.repeat(np.arange(nrec), e4[:, 1] - s4[:, 1])
    keep = ~_WHITESPACE[seq_chars]
    seq_chars, seq_rec = seq_chars[keep], seq_rec[keep]
    codes_flat = _MAP_TABLE[seq_chars]
    lengths = np.bincount(seq_rec, minlength=nrec).astype(np.int32)
    offsets = np.zeros(nrec + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])

    qual_idx = _concat_ranges(s4[:, 3], e4[:, 3])
    qual_chars = buf[qual_idx]
    qual_rec = np.repeat(np.arange(nrec), e4[:, 3] - s4[:, 3])
    keep = ~_WHITESPACE[qual_chars]
    qual_chars, qual_rec = qual_chars[keep], qual_rec[keep]
    qlen = np.bincount(qual_rec, minlength=nrec)
    if not (qlen == lengths).all():
        raise ValueError("quality string length mismatch")

    if quality_offset == 0:
        quality_offset = autodetect_quality_offset(qual_chars)
        if quality_offset == 0:
            raise RuntimeError(
                "Unable to automatically detect FastQ quality format.")
    quals_flat = (qual_chars.astype(np.int16)
                  - quality_offset).astype(np.int8)
    return ReadSet(ids, lengths, codes_flat, offsets, quals_flat, True,
                   quality_offset)


def autodetect_quality_offset(qual_chars: np.ndarray) -> int:
    """First decisive quality char wins (FastQReader.hpp:221-239)."""
    sanger = qual_chars <= 54
    illumina = qual_chars >= 94
    decisive = np.flatnonzero(sanger | illumina)
    if len(decisive) == 0:
        return 0
    return 33 if sanger[decisive[0]] else 64


def _concat_ranges(starts: np.ndarray, ends: np.ndarray) -> np.ndarray:
    """Vectorized concatenation of index ranges [s_i, e_i)."""
    lens = ends - starts
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    nonempty = lens > 0
    if not nonempty.all():
        return np.concatenate([np.arange(s, e, dtype=np.int64)
                               for s, e in zip(starts, ends)])
    out = np.ones(total, dtype=np.int64)
    heads = np.zeros(len(starts), dtype=np.int64)
    heads[0] = starts[0]
    heads[1:] = starts[1:] - ends[:-1] + 1
    pos = np.concatenate([[0], np.cumsum(lens)[:-1]])
    out[pos] = heads
    return np.cumsum(out)


def reverse_complement(codes: np.ndarray) -> np.ndarray:
    """RC of mapped codes: 3-x for x<4, N stays N (acgtnMap.hpp invertN)."""
    rc = codes[..., ::-1].copy()
    mask = rc < 4
    rc[mask] = 3 - rc[mask]
    return rc
