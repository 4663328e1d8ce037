"""Host->device read batches (counterpart of real_tpu/io/pipeline.py).

The card's equivalent of the reference's async I/O layer: a producer thread
and a bounded queue feeding the matcher (AsynchronousReader.hpp:181-259,
AsynchronousBufferReader.hpp double buffering).

Reads cross to the device 2-BIT PACKED ([rows, ceil(patl/16)] 32-bit words,
the reference's TemporaryFile.hpp:231-268 byte packing widened to words)
and are unpacked to [rows, patl] uint8 codes on the device per batch.

Two modes, chosen by a device-memory budget over the PACKED bytes:

* resident: the packed reads of each length bucket are uploaded once and
  stay on the device across index-shard passes; each pass re-derives the
  uint8 codes batch by batch.
* streaming: a background thread packs and uploads batches at most
  `prefetch` ahead of the match loop; the packed host arrays are cached
  (up to _HOST_CACHE_MAX) so later passes skip the repacking. Each
  index-shard pass re-streams the batches — the reference's "re-stream all
  reads per block" outer product (matchUniqueImplementation.cpp:1260-1262).
  On the card the packed arrays live in pinned host memory and the
  producer copies them non_blocking on a stream of its own; an event
  recorded after the copies is what the consumer's stream waits on before
  the match loop reads a batch, and the device tensors are handed over to
  that stream (record_stream) so their memory is not reused under it. No
  pinned buffer is ever written twice: each batch packs into fresh pinned
  tensors, and torch's pinned allocator holds a freed one back until the
  copy that read it has finished.
"""

from __future__ import annotations

import ctypes
import dataclasses
import queue
import threading
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from real_tpu_torch import bitpack, native
from real_tpu_torch.io import reads as reads_io
from real_tpu_torch.text.packed import u32

# host-side packed-batch cache cap (streaming mode): 4 GB covers ~150M
# 100bp reads; beyond that later passes re-pack from the read set
_HOST_CACHE_MAX = 4 << 30


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


def packed_batch_bytes(rows: int, patl: int, has_quals: bool) -> int:
    """Device bytes of one packed batch (codes words + quals + valid)."""
    kw = (patl + 15) // 16
    return rows * (4 * kw + (patl if has_quals else 0) + 1)


def _pack_host_tensors(rs: reads_io.ReadSet, plan: BatchPlan,
                       use_native: bool = True, pinned: bool = False,
                       chunk: int = 1 << 21):
    """One plan's reads as fixed-shape PACKED host tensors: (words int32
    bit patterns [rows, KW], quals int8 | None, valid bool), in pinned
    memory when asked. Codes 4 (N) pack as their low bits and are masked
    via `valid`, like the reference (AutoTextArray.hpp:27-43).

    The resident upload hands this a whole length bucket as one plan, so
    the rows go through in bounded chunks straight into the preallocated
    outputs. The native row packer (native/readpack.cpp pack_rows_2bit)
    does the shift work; bitpack.pack_rows_2bit is its plain version
    (use_native=False)."""
    n = len(plan.patids)
    kw = (plan.patl + 15) // 16
    has_q = rs.quals_flat is not None
    t_words = torch.zeros((plan.rows, kw), dtype=torch.int32,
                          pin_memory=pinned)
    t_valid = torch.zeros(plan.rows, dtype=torch.bool, pin_memory=pinned)
    t_quals = torch.full((plan.rows, plan.patl), 30, dtype=torch.int8,
                         pin_memory=pinned) if has_q else None
    words = t_words.numpy().view(np.uint32)
    valid = t_valid.numpy()
    quals = t_quals.numpy() if has_q else None
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
    return t_words, t_quals, t_valid


def _pack_host(rs: reads_io.ReadSet, plan: BatchPlan,
               use_native: bool = True, chunk: int = 1 << 21):
    """_pack_host_tensors as numpy arrays: (words uint32 [rows, KW], quals
    int8 | None, valid bool)."""
    w, q, v = _pack_host_tensors(rs, plan, use_native, chunk=chunk)
    return (w.numpy().view(np.uint32), None if q is None else q.numpy(),
            v.numpy())


def _to_batch(plan: BatchPlan, words, quals, valid) -> Batch:
    return Batch(patids=plan.patids, patl=plan.patl,
                 codes=_unpack_rows(words, plan.patl), quals=quals,
                 valid=valid)


class BatchSource:
    """Re-iterable batch sequence; resident or streaming (module doc).

    len() and .plans are host metadata; iteration yields Batches of
    tensors on `device`. `resident_device_bytes` reports the packed bytes
    held on the device across passes (0 in streaming mode) so the shard
    planner can reserve them; `streamed_batches` counts what the producer
    thread has handed over."""

    def __init__(self, rs: reads_io.ReadSet, plans: List[BatchPlan],
                 device, use_native: bool = True,
                 resident_budget_bytes: int = 1 << 30, prefetch: int = 3):
        self.rs = rs
        self.plans = plans
        self.device = torch.device(device)
        self.use_native = use_native
        self.prefetch = prefetch
        has_q = rs.quals_flat is not None
        total = sum(packed_batch_bytes(p.rows, p.patl, has_q)
                    for p in plans)
        self.resident = total <= resident_budget_bytes
        self.resident_device_bytes = total if self.resident else 0
        self.streamed_batches = 0
        self._host_cache: Dict[int, tuple] = {}     # streaming passes > 1
        self._host_cache_bytes = 0
        # resident: the packed device slices, uploaded here (the driver's
        # setup phase) so that the planner's reserve is real when it plans
        self._cache = self._upload_resident() if self.resident else None

    def __len__(self) -> int:
        return len(self.plans)

    def __iter__(self) -> Iterator[Batch]:
        if self.resident:
            return (_to_batch(p, w, q, v) for p, w, q, v in self._cache)
        return self._stream()

    def _upload_resident(self) -> List:
        """One bulk packed transfer per length bucket, sliced per batch on
        the device. Only the PACKED words persist; uint8 codes are
        re-derived per batch each pass and freed after use. make_plans
        emits a bucket's plans side by side, so the slices come out in the
        order of self.plans."""
        out: List = []
        by_bucket: dict = {}
        for p in self.plans:
            by_bucket.setdefault((p.patl, p.rows), []).append(p)
        for (patl, rows), group in by_bucket.items():
            big = BatchPlan(patids=np.concatenate([p.patids for p in group]),
                            patl=patl, rows=rows * len(group))
            words, quals, valid = _pack_host_tensors(self.rs, big,
                                                     self.use_native)
            dw = words.to(self.device)
            dq = None if quals is None else quals.to(self.device)
            dv = valid.to(self.device)
            for k, p in enumerate(group):
                o = k * rows
                out.append((p, dw[o:o + rows],
                            None if dq is None else dq[o:o + rows],
                            dv[o:o + rows]))
        return out

    def _packed(self, i: int, plan: BatchPlan, pinned: bool) -> tuple:
        """Plan i's packed host tensors, from the host cache when there."""
        hp = self._host_cache.get(i)
        if hp is None:
            hp = _pack_host_tensors(self.rs, plan, self.use_native, pinned)
            nbytes = sum(t.numel() * t.element_size() for t in hp
                         if t is not None)
            if self._host_cache_bytes + nbytes <= _HOST_CACHE_MAX:
                self._host_cache[i] = hp
                self._host_cache_bytes += nbytes
        return hp

    def _stream(self) -> Iterator[Batch]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        on_card = self.device.type == "cuda"
        upload = torch.cuda.Stream(self.device) if on_card else None

        def put(item) -> bool:
            """Hand `item` to the consumer unless it has gone away."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for i, plan in enumerate(self.plans):
                    if stop.is_set():
                        return
                    hp = self._packed(i, plan, pinned=on_card)
                    if on_card:
                        with torch.cuda.stream(upload):
                            dev = tuple(
                                None if t is None else
                                t.to(self.device, non_blocking=True)
                                for t in hp)
                            ready = torch.cuda.Event()
                            ready.record(upload)
                    else:
                        dev, ready = hp, None
                    if not put((plan, dev, ready)):
                        return
                put(None)
            except BaseException as e:   # surfaces in the consumer
                put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                plan, (words, quals, valid), ready = item
                if ready is not None:
                    current = torch.cuda.current_stream(self.device)
                    current.wait_event(ready)
                    for x in (words, quals, valid):
                        if x is not None:
                            x.record_stream(current)
                self.streamed_batches += 1
                yield _to_batch(plan, words, quals, valid)
        finally:
            stop.set()
            t.join(timeout=30)


def make_source(rs: reads_io.ReadSet, batch_size: int, seedl: int, device,
                patid_filter: Optional[np.ndarray] = None, warn=None,
                resident_budget_bytes: int = 1 << 30, max_rows: int = 0,
                use_native: bool = True) -> BatchSource:
    plans = make_plans(rs, batch_size, seedl, patid_filter, warn,
                       max_rows=max_rows)
    return BatchSource(rs, plans, device, use_native,
                       resident_budget_bytes=resident_budget_bytes)
