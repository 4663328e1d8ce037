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
  copy that read it has finished. The match loop's time blocked waiting
  for the producer adds up in the job's counter `stream_wait_s`
  (utils/spans.py; -metrics).

An in-process mesh (parallel/mesh.py LocalMesh) splits every batch over
its dp rows: make_plans(row_align=cells) keeps each batch's row count
divisible, and BatchSource.rows() hands each row's slice to each device
of the row, in either mode.
"""

from __future__ import annotations

import ctypes
import dataclasses
import queue
import threading
import time
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from real_tpu_torch import bitpack, native
from real_tpu_torch.io import reads as reads_io
from real_tpu_torch.text.packed import u32
from real_tpu_torch.utils import spans

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
               warn=None, max_rows: int = 0,
               row_align: int = 1) -> List[BatchPlan]:
    """Length-bucketed fixed-shape batch plans: tail batches pad to the
    same row count as full batches of their bucket. max_rows caps the
    batch shape below batch_size (overflow reruns use 512-row batches).
    row_align makes every batch's row count divisible by it (an
    in-process mesh splits each batch over its dp rows)."""
    plans: List[BatchPlan] = []
    warned_short = False
    B = min(batch_size, max_rows) if max_rows else batch_size
    B = -(-B // row_align) * row_align
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
        bucket_rows = -(-bucket_rows // row_align) * row_align
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


def row_plan(plan: BatchPlan, n_dp: int, d: int) -> BatchPlan:
    """dp row d's slice of a batch split over n_dp rows: rows
    [d * R, (d + 1) * R) with R = plan.rows / n_dp, and the real reads
    among them (none in a row wholly in the padding)."""
    r = plan.rows // n_dp
    return BatchPlan(patids=plan.patids[d * r:(d + 1) * r], patl=plan.patl,
                     rows=r)


def _row_slice(t: Optional[torch.Tensor], n_dp: int, d: int):
    if t is None:
        return None
    r = t.shape[0] // n_dp
    return t[d * r:(d + 1) * r]


class BatchSource:
    """Re-iterable batch sequence; resident or streaming (module doc).

    len() and .plans are host metadata; iteration yields Batches of
    tensors on `device`. `resident_device_bytes` reports the packed bytes
    held on the device across passes (0 in streaming mode) so the shard
    planner can reserve them; `streamed_batches` counts what the producer
    thread has handed over.

    A source made with device=None serves an in-process mesh through
    rows() instead: each batch split over the mesh's dp rows, every row's
    slice on each device of the row. Its resident_device_bytes is the
    whole set's, which bounds what any one device holds."""

    def __init__(self, rs: reads_io.ReadSet, plans: List[BatchPlan],
                 device, use_native: bool = True,
                 resident_budget_bytes: int = 1 << 30, prefetch: int = 3):
        self.rs = rs
        self.plans = plans
        self.device = None if device is None else torch.device(device)
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
        # setup phase) so that the planner's reserve is real when it plans;
        # a mesh source uploads at its first rows() of a row layout
        self._cache = None
        self._rows_cache = None         # (row layout, slices per plan)
        if self.resident and self.device is not None:
            self._cache = [(p, *parts[0][self.device]) for p, parts in
                           zip(self.plans, self._upload(((self.device,),)))]

    def __len__(self) -> int:
        return len(self.plans)

    def __iter__(self) -> Iterator[Batch]:
        if self.resident:
            return (_to_batch(p, w, q, v) for p, w, q, v in self._cache)
        return (rows[0][self.device]
                for rows in self._stream(((self.device,),)))

    def rows(self, layout) -> Iterator[List[Dict[torch.device, Batch]]]:
        """The batches of an in-process mesh: layout[d] lists the distinct
        devices of dp row d's cells, and each item's [d][device] is row
        d's slice of the batch (row_plan) on that device. A row's slice
        goes once to each device of the row, which is what real_tpu's
        P("dp") in_specs give: a resident source keeps the slices across
        passes (and uploads anew for another layout, after freeing the
        old one), a streaming one uploads them per batch."""
        layout = tuple(tuple(torch.device(x) for x in row) for row in layout)
        if not self.resident:
            return self._stream(layout)
        if self._rows_cache is None or self._rows_cache[0] != layout:
            self._rows_cache = None
            self._rows_cache = (layout, self._upload(layout))
        n = len(layout)
        return ([{dev: _to_batch(row_plan(p, n, d), *parts[d][dev])
                  for dev in layout[d]} for d in range(n)]
                for p, parts in zip(self.plans, self._rows_cache[1]))

    def _upload(self, layout) -> List:
        """One packed host array per length bucket, each dp row's rows of
        it in one transfer to each device of the row, sliced per batch on
        the device. Only the PACKED words persist; uint8 codes are
        re-derived per batch each pass and freed after use. Returns, per
        plan, [row][device] -> (words, quals, valid)."""
        n = len(layout)
        out: List = [[{} for _ in range(n)] for _ in self.plans]
        by_bucket: dict = {}
        for i, p in enumerate(self.plans):
            by_bucket.setdefault((p.patl, p.rows), []).append(i)
        for (patl, rows), group in by_bucket.items():
            big = BatchPlan(
                patids=np.concatenate([self.plans[i].patids for i in group]),
                patl=patl, rows=rows * len(group))
            host = _pack_host_tensors(self.rs, big, self.use_native)
            r = rows // n
            for d in range(n):
                # row d of every batch of the bucket, side by side
                sl = [None if t is None else
                      t.view(len(group), n, r, *t.shape[1:])[:, d]
                      .reshape(len(group) * r, *t.shape[1:])
                      for t in host]
                for dev in layout[d]:
                    dt = [None if t is None else t.to(dev) for t in sl]
                    for k, i in enumerate(group):
                        out[i][d][dev] = tuple(
                            None if t is None else t[k * r:(k + 1) * r]
                            for t in dt)
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

    def _stream(self, layout) -> Iterator[List[Dict[torch.device, Batch]]]:
        """Per batch, each dp row's slice on each device of the row
        (layout as in rows(); one row of one device for a one-device
        source), packed once on the host by the producer thread."""
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        n = len(layout)
        devices = list(dict.fromkeys(dev for row in layout for dev in row))
        on_card = any(dev.type == "cuda" for dev in devices)
        upload = {dev: torch.cuda.Stream(dev) for dev in devices
                  if dev.type == "cuda"}

        def put(item) -> bool:
            """Hand `item` to the consumer unless it has gone away."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def to_device(hp, d, dev):
            """Row d's slice of the packed batch `hp` on `dev`, and the
            event its copies are ready at (None off the card)."""
            sl = tuple(_row_slice(t, n, d) for t in hp)
            if dev.type != "cuda":
                return sl, None
            with torch.cuda.stream(upload[dev]):
                out = tuple(None if t is None else
                            t.to(dev, non_blocking=True) for t in sl)
                ready = torch.cuda.Event()
                ready.record(upload[dev])
            return out, ready

        def producer():
            try:
                for i, plan in enumerate(self.plans):
                    if stop.is_set():
                        return
                    hp = self._packed(i, plan, pinned=on_card)
                    item = [{dev: to_device(hp, d, dev) for dev in row}
                            for d, row in enumerate(layout)]
                    if not put((plan, item)):
                        return
                put(None)
            except BaseException as e:   # surfaces in the consumer
                put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                t0 = time.perf_counter()
                item = q.get()
                spans.add("stream_wait_s", time.perf_counter() - t0)
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                plan, parts = item
                out = []
                for d, row in enumerate(parts):
                    got = {}
                    for dev, (tensors, ready) in row.items():
                        if ready is not None:
                            current = torch.cuda.current_stream(dev)
                            current.wait_event(ready)
                            for x in tensors:
                                if x is not None:
                                    x.record_stream(current)
                        got[dev] = _to_batch(row_plan(plan, n, d), *tensors)
                    out.append(got)
                self.streamed_batches += 1
                yield out
        finally:
            stop.set()
            t.join(timeout=30)


def make_source(rs: reads_io.ReadSet, batch_size: int, seedl: int, device,
                patid_filter: Optional[np.ndarray] = None, warn=None,
                resident_budget_bytes: int = 1 << 30, max_rows: int = 0,
                use_native: bool = True, row_align: int = 1) -> BatchSource:
    """device=None: a source for an in-process mesh (BatchSource.rows),
    its batches' rows divisible by row_align (the mesh's cell count, so
    that every grid of those cells splits them evenly)."""
    plans = make_plans(rs, batch_size, seedl, patid_filter, warn,
                       max_rows=max_rows, row_align=row_align)
    return BatchSource(rs, plans, device, use_native,
                       resident_budget_bytes=resident_budget_bytes)
