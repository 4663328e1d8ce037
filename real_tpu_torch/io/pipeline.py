"""Host->device read batches (counterpart of real_tpu/io/pipeline.py).

Reads cross to the device 2-BIT PACKED ([rows, ceil(patl/16)] 32-bit words,
the reference's TemporaryFile.hpp:231-268 byte packing widened to words)
and are unpacked to [rows, patl] uint8 codes on the device per batch.

This slice ports the resident mode: the packed reads of each length bucket
are uploaded once and stay on the device; each pass re-derives the uint8
codes batch by batch. real_tpu's streaming prefetch mode (reads larger than
the device budget) waits for a later slice.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Iterator, List, Optional

import numpy as np
import torch

from real_tpu_torch import bitpack, native
from real_tpu_torch.io import reads as reads_io
from real_tpu_torch.text.packed import as_i32_tensor, u32


@dataclasses.dataclass
class BatchPlan:
    """Host-side description of one fixed-shape batch."""
    patids: np.ndarray     # int64 [n] (n <= rows)
    patl: int
    rows: int              # padded row count (static batch shape)


@dataclasses.dataclass
class Batch:
    patids: np.ndarray     # int64 [n] (n <= rows)
    patl: int
    codes: torch.Tensor    # uint8 [rows, patl] (padded rows zero)
    quals: Optional[torch.Tensor]  # int8 [rows, patl]; None = FASTA const 30
    valid: torch.Tensor    # bool  [rows]


def _unpack_rows(words: torch.Tensor, patl: int) -> torch.Tensor:
    """[B, KW] int32 words (MSB-first 16 bases/word, pack_rows_2bit)
    -> [B, patl] uint8 codes."""
    shifts = 2 * (15 - torch.arange(16, device=words.device))
    c = ((u32(words)[:, :, None] >> shifts) & 3).to(torch.uint8)
    return c.reshape(words.shape[0], -1)[:, :patl]


def _round_b(n: int, bmax: int) -> int:
    """Pad batch rows to the next power of two, floored at 512."""
    b = 512
    while b < n:
        b *= 2
    return min(b, bmax)


def make_plans(rs: reads_io.ReadSet, batch_size: int, seedl: int,
               patid_filter: Optional[np.ndarray] = None,
               warn=None, max_rows: int = 0) -> List[BatchPlan]:
    """Length-bucketed fixed-shape batch plans: tail batches pad to the
    same row count as full batches of their bucket. max_rows caps the
    batch shape below batch_size (overflow reruns use 512-row batches)."""
    plans: List[BatchPlan] = []
    warned_short = False
    B = min(batch_size, max_rows) if max_rows else batch_size
    fmask = None
    if patid_filter is not None:
        fmask = np.zeros(rs.num_reads, bool)
        fmask[patid_filter] = True
    for patl, patids in sorted(rs.length_buckets().items()):
        if fmask is not None:
            patids = patids[fmask[patids]]
            if len(patids) == 0:
                continue
        if patl < seedl:
            if not warned_short and warn is not None:
                warn(f"Skipping {len(patids)} patterns shorter than seed "
                     "length.")
                warned_short = True
            continue
        bucket_rows = B if len(patids) > B else _round_b(len(patids), B)
        nb = -(-len(patids) // bucket_rows)
        for k in range(nb):
            plans.append(BatchPlan(
                patids=patids[k * bucket_rows:(k + 1) * bucket_rows],
                patl=patl, rows=bucket_rows))
    return plans


def _pack_host(rs: reads_io.ReadSet, plan: BatchPlan,
               use_native: bool = True, chunk: int = 1 << 21):
    """One plan's reads as fixed-shape PACKED host arrays:
    (words uint32 [rows, KW], quals int8 | None, valid bool). Codes 4 (N)
    pack as their low bits and are masked via `valid`, like the reference
    (AutoTextArray.hpp:27-43).

    The resident upload hands this a whole length bucket as one plan, so
    the rows go through in bounded chunks straight into the preallocated
    outputs. The native row packer (native/readpack.cpp pack_rows_2bit)
    does the shift work; bitpack.pack_rows_2bit is its plain version
    (use_native=False)."""
    n = len(plan.patids)
    kw = (plan.patl + 15) // 16
    words = np.zeros((plan.rows, kw), np.uint32)
    valid = np.zeros(plan.rows, bool)
    has_q = rs.quals_flat is not None
    quals = np.full((plan.rows, plan.patl), 30, np.int8) if has_q else None
    lib = native.get_lib() if use_native else None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        codes_all, quals_all = rs.dense_batch(plan.patids[lo:hi])
        valid[lo:hi] = (codes_all <= 3).all(axis=1)
        if lib is not None:
            c = np.ascontiguousarray(codes_all)
            lib.pack_rows_2bit(c.ctypes.data_as(u8p), hi - lo, plan.patl,
                               words[lo:hi].ctypes.data_as(u32p), kw)
        else:
            words[lo:hi] = bitpack.pack_rows_2bit(codes_all)
        if has_q:
            quals[lo:hi] = quals_all
    return words, quals, valid


class ResidentSource:
    """Re-iterable batch sequence over device-resident packed reads: one
    upload per length bucket, sliced per batch on the device; the uint8
    codes are re-derived per batch on every pass."""

    def __init__(self, rs: reads_io.ReadSet, plans: List[BatchPlan],
                 device, use_native: bool = True):
        self._slices = []
        by_bucket: dict = {}
        for p in plans:
            by_bucket.setdefault((p.patl, p.rows), []).append(p)
        for (patl, rows), group in by_bucket.items():
            big = BatchPlan(patids=np.concatenate([p.patids for p in group]),
                            patl=patl, rows=rows * len(group))
            words, quals, valid = _pack_host(rs, big, use_native)
            dw = as_i32_tensor(words, device)
            dq = None if quals is None else torch.from_numpy(quals).to(device)
            dv = torch.from_numpy(valid).to(device)
            for k, p in enumerate(group):
                o = k * rows
                self._slices.append((p, dw[o:o + rows],
                                     None if dq is None else dq[o:o + rows],
                                     dv[o:o + rows]))
        # iteration order (bucket-grouped) is the order of self.plans
        self.plans = [s[0] for s in self._slices]

    def __len__(self) -> int:
        return len(self.plans)

    def __iter__(self) -> Iterator[Batch]:
        for p, w, q, v in self._slices:
            yield Batch(patids=p.patids, patl=p.patl,
                        codes=_unpack_rows(w, p.patl), quals=q, valid=v)
