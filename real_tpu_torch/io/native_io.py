"""ctypes front-end of the native (C++) parsers in real_tpu_torch/native.

Counterpart of real_tpu/io/native_io.py. Same results as the NumPy parsers
in reads.py and fasta.py, array for array (tests/test_torch_native.py holds
them together). A library that does not build or load raises
(native.get_lib); the only `None` these functions return is the FASTQ
parser's for a buffer that is not 4-line regular, which is a property of
the data: the caller then takes the general NumPy parser.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np

from real_tpu_torch import native
from real_tpu_torch.io.reads import (IdView, ReadSet,
                                     autodetect_quality_offset)


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int8))


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _input(buf: np.ndarray) -> np.ndarray:
    if buf.dtype != np.uint8 or buf.ndim != 1:
        raise TypeError("the native parsers take a 1-D uint8 buffer")
    return np.ascontiguousarray(buf)


def parse_fasta_reads_native(buf: np.ndarray) -> ReadSet:
    lib = native.get_lib()
    buf = _input(buf)
    counts = np.zeros(3, np.int64)       # reads, bases, id bytes
    lib.fasta_reads_count(_u8p(buf), buf.size, _i64p(counts[0:]),
                          _i64p(counts[1:]), _i64p(counts[2:]))
    n = int(counts[0])
    codes = np.empty(int(counts[1]), np.uint8)
    offsets = np.zeros(n + 1, np.int64)
    ids_buf = np.empty(int(counts[2]), np.uint8)
    id_offsets = np.zeros(n + 1, np.int64)
    lib.fasta_reads_fill(_u8p(buf), buf.size, _u8p(codes), _i64p(offsets),
                         _u8p(ids_buf), _i64p(id_offsets))
    lengths = np.diff(offsets).astype(np.int32)
    return ReadSet(IdView(ids_buf, id_offsets), lengths, codes,
                   offsets, None, False)


def parse_fastq_native(buf: np.ndarray,
                       quality_offset: int = 0) -> Optional[ReadSet]:
    """None when the buffer is not made of 4-line records (decided by the
    data, never by the library's state)."""
    lib = native.get_lib()
    buf = _input(buf)
    counts = np.zeros(3, np.int64)
    rc = lib.fastq_reads_count(_u8p(buf), buf.size, _i64p(counts[0:]),
                               _i64p(counts[1:]), _i64p(counts[2:]))
    if rc != 0:
        return None
    n = int(counts[0])
    codes = np.empty(int(counts[1]), np.uint8)
    quals = np.empty(int(counts[1]), np.int8)
    offsets = np.zeros(n + 1, np.int64)
    ids_buf = np.empty(int(counts[2]), np.uint8)
    id_offsets = np.zeros(n + 1, np.int64)
    # with quality_offset 0 the fill keeps the raw quality characters,
    # which the autodetection below needs
    rc = lib.fastq_reads_fill(_u8p(buf), buf.size, _u8p(codes), _i8p(quals),
                              _i64p(offsets), _u8p(ids_buf),
                              _i64p(id_offsets), quality_offset)
    if rc != 0:
        return None
    if quality_offset == 0:
        quality_offset = autodetect_quality_offset(quals.view(np.uint8))
        if quality_offset == 0:
            raise RuntimeError(
                "Unable to automatically detect FastQ quality format.")
        quals = (quals.view(np.uint8).astype(np.int16)
                 - quality_offset).astype(np.int8)
    lengths = np.diff(offsets).astype(np.int32)
    return ReadSet(IdView(ids_buf, id_offsets), lengths, codes,
                   offsets, quals, True, quality_offset)


def parse_genome_native(
        buf: np.ndarray) -> Tuple[np.ndarray, List[Tuple[str, int]]]:
    lib = native.get_lib()
    buf = _input(buf)
    counts = np.zeros(3, np.int64)       # bases, fragments, id bytes
    lib.genome_count(_u8p(buf), buf.size, _i64p(counts[0:]),
                     _i64p(counts[1:]), _i64p(counts[2:]))
    total, f = int(counts[0]), int(counts[1])
    codes = np.empty(total, np.uint8)
    frag_offsets = np.zeros(max(f, 1), np.int64)
    ids_buf = np.empty(int(counts[2]), np.uint8)
    id_offsets = np.zeros(f + 1, np.int64)
    lib.genome_fill(_u8p(buf), buf.size, _u8p(codes), _i64p(frag_offsets),
                    _u8p(ids_buf), _i64p(id_offsets))
    raw = ids_buf.tobytes()
    ranges = [(raw[id_offsets[i]:id_offsets[i + 1]].decode("latin-1"),
               int(frag_offsets[i])) for i in range(f)]
    ranges.append(("terminal", total))
    return codes, ranges
