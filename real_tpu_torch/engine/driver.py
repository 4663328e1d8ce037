"""End-to-end matchUnique and matchAll drivers: one device, one index
shard per text.

Counterpart of real_tpu/engine/driver.py (run_match_unique and
run_match_all on their sequential single-device path). Loop structure
mirrors the reference (matchUniqueImplementation.cpp:1082-1489):

    for each text file:                 (getFileList, ".fa" suffix)
      build packed text + fragment ranges
      build sorted signature lists      (one shard over the whole text)
      for each read length-bucket batch:
        match_step(...)                 (state persists per read)
    final pass: format records in read order

matchUnique keeps per-read best-hit state on the device across files;
matchAll compacts each step's hits on the device and sorts and dedups all
of them on the host. Reads whose candidates overflow the caps are rerun
from scratch with 16x caps against the cached index — the fixed-shape
answer to std::equal_range's unbounded ranges. Index sharding, the memory
planner, streaming reads, checkpoints and several devices wait for later
slices of the port.

Entry points run on the card: `device` defaults to "cuda" and raises
without CUDA; only an explicit device="cpu" runs on the CPU.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from real_tpu_torch import native
from real_tpu_torch.config import RealConfig
from real_tpu_torch.engine.matchstep import (CompactHits, initial_state,
                                             match_step)
from real_tpu_torch.index.build import build_index, pick_bucket_bits
from real_tpu_torch.io import fasta, pipeline, reads as reads_io
from real_tpu_torch.scoring.scoring import Scoring, score_tables
from real_tpu_torch.text.packed import PackedText, build_packed_text

MAX_FRAGMENTS_PER_FILE = 1 << 16   # UniqueMatchInfo fragmentbits
# bucket-table width cap of a single resident shard (real_tpu's plan for
# one shard, parallel/plan.py)
BUCKET_BITS_CAP = 25
# largest per-text base count: positions are int32 on the device
TEXT_SPLIT_LIMIT = 2**31 - 64


def resolve_device(device) -> torch.device:
    """torch.device for an entry point; CUDA without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: real_tpu_torch runs on the card unless "
            "asked for the CPU (device='cpu', or -device cpu on the CLI)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


@dataclasses.dataclass
class TextFile:
    name: str
    packed: PackedText


def split_oversized(name: str, codes: np.ndarray,
                    ranges: List[Tuple[str, int]],
                    limit: int = TEXT_SPLIT_LIMIT):
    """Split one parsed text file into sub-texts of < limit bases at
    FRAGMENT boundaries (alignments never cross them,
    RangeVector.hpp:63-80); records keep (fragment_id, local position)."""
    if len(codes) < limit:
        return [(name, codes, ranges)]
    names = [nm for nm, _ in ranges[:-1]]
    offs = [off for _, off in ranges]           # F+1 entries, last = n
    out = []
    i = 0
    while i < len(names):
        base = offs[i]
        j = i
        while j < len(names) and offs[j + 1] - base <= limit:
            j += 1
        if j == i:
            raise ValueError(
                f"fragment {names[i]!r} alone exceeds {limit} bases")
        sub = [(names[k], offs[k] - base) for k in range(i, j)]
        sub.append(("terminal", offs[j] - base))
        out.append((f"{name}#{len(out)}", codes[base:offs[j]], sub))
        i = j
    return out


def load_texts(cfg: RealConfig, device="cuda",
               split_limit: int = TEXT_SPLIT_LIMIT) -> List[TextFile]:
    """-t may be a file or a directory of *.fa files (getFileList.cpp).
    Files over 2^31 bases are split at fragment boundaries."""
    dev = resolve_device(device)
    paths: List[str] = []
    if os.path.isdir(cfg.textfilename):
        for root, _dirs, files in sorted(os.walk(cfg.textfilename)):
            for f in sorted(files):
                if f.endswith(".fa"):
                    paths.append(os.path.join(root, f))
    else:
        paths.append(cfg.textfilename)
    out = []
    for p in paths:
        codes, ranges = fasta.parse_genome(p, cfg.native_host)
        for name, c, r in split_oversized(p, codes, ranges, split_limit):
            out.append(TextFile(name=name,
                                packed=build_packed_text(c, r, dev)))
    return out


def _bsearch_steps_static(num_windows: int, cand_cap: int,
                          bucket_bits: int, extra: int = 0) -> int:
    """In-bucket binary-search depth for find_survivors, chosen on the
    host from the shard's window count and bucket width (real_tpu's rule).
    0 = the bucket range is the candidate range (two-tier lane path);
    escalated caps always bisect. An unconverged bisection only
    over-approximates its range, which at worst raises an overflow."""
    occ = num_windows / float(1 << bucket_bits)
    if extra == 0 and cand_cap <= 16 and occ <= 2.0 * max(cand_cap / 8.0, 1.0):
        return 0
    occ = max(8.0 * max(occ, 1.0), float(2 * cand_cap))
    steps = int(np.ceil(np.log2(occ + 1)))
    return min(-(-steps // 4) * 4 + extra, 30)


@dataclasses.dataclass
class MatchResult:
    """Final per-read state (host) and the run's metrics."""
    st: np.ndarray
    pos: np.ndarray
    frag: np.ndarray
    fileid: np.ndarray
    errs: np.ndarray
    score: np.ndarray
    # phase_s (seconds per phase), overflow_rerun_reads
    metrics: Dict[str, object] = dataclasses.field(default_factory=dict)


def _text_usable(cfg: RealConfig, tf: TextFile) -> bool:
    text = tf.packed
    if text.n < cfg.seedl:
        print(f"File {tf.name} is too small for seed length, skipping it.",
              file=sys.stderr)
        return False
    if text.num_fragments > MAX_FRAGMENTS_PER_FILE:
        print(f"Number of fragments {text.num_fragments + 1} in file is "
              "larger than limit we can handle, skipping it.",
              file=sys.stderr)
        return False
    return True


class _Progress:
    """stderr progress (with -v) + per-phase host-clock timers."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.t0 = time.perf_counter()
        self.phase_s: Dict[str, float] = {}

    def event(self, msg: str) -> None:
        if self.enabled:
            print(f"[{time.perf_counter() - self.t0:8.2f}s] {msg}",
                  file=sys.stderr, flush=True)

    @contextlib.contextmanager
    def phase(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.phase_s[name] = (self.phase_s.get(name, 0.0)
                                  + time.perf_counter() - t)


def _check_run(cfg: RealConfig, texts: List[TextFile],
               device) -> torch.device:
    """The run's device, after the checks every entry point shares."""
    dev = resolve_device(device)
    if cfg.seedl > 32:
        raise NotImplementedError("seeds over 32 bases are not ported yet")
    if cfg.index_shards > 1:
        raise NotImplementedError("index sharding is not ported yet")
    for tf in texts:
        if tf.packed.words.device.type != dev.type:
            raise ValueError(f"text {tf.name} is on {tf.packed.words.device},"
                             f" the run on {dev}")
    return dev


def _step_kwargs(cfg: RealConfig, cand_cap: int, survivor_cap: int) -> dict:
    scoring = Scoring(cfg.similarity, cfg.gc, cfg.trans, cfg.err,
                      cfg.gcmut_bias)
    return dict(tables=score_tables(scoring) if cfg.scores else None,
                seedl=cfg.seedl, seedkmax=cfg.seedkmax,
                totalkmax=cfg.totalkmax, cand_cap=cand_cap,
                survivor_cap=survivor_cap, scores=cfg.scores)


def _make_source(cfg: RealConfig, rs: reads_io.ReadSet,
                 patid_filter: Optional[np.ndarray], depth: int,
                 dev: torch.device) -> pipeline.ResidentSource:
    """Device-resident read batches; overflow reruns use 512-row batches."""
    return pipeline.ResidentSource(
        rs, pipeline.make_plans(
            rs, cfg.batch_size, cfg.seedl, patid_filter,
            warn=lambda m: print(m, file=sys.stderr),
            max_rows=512 if depth else 0), dev, cfg.native_host)


def _text_units(cfg: RealConfig, texts: List[TextFile], num_reads: int,
                cand_cap: int, prog: _Progress, index_cache: Dict):
    """Yield (fileid, text, index, bsearch_steps) for every usable text,
    one index shard each. A single-text run parks its index in
    index_cache, so the overflow reruns reuse it instead of rebuilding."""
    usable = [(fi, tf.packed) for fi, tf in enumerate(texts)
              if _text_usable(cfg, tf)]
    for fi, text in usable:
        num_windows = text.n - cfg.seedl + 1
        ck = (fi, 0, num_windows, cfg.seedl)
        index = index_cache.get(ck)
        if index is None:
            # bucket-width hint: the FULL read-set size, so overflow
            # reruns build (and reuse) the same table as the first pass
            bbits = pick_bucket_bits(cfg.seedl, num_windows, num_reads,
                                     cap=BUCKET_BITS_CAP)
            with prog.phase("index_build"):
                index = build_index(text, cfg.seedl, start=0,
                                    num_windows=num_windows,
                                    bucket_bits=bbits)
            if len(usable) == 1:
                index_cache[ck] = index
        steps = _bsearch_steps_static(num_windows, cand_cap,
                                      index.bucket_bits)
        prog.event(f"file {fi}: index dispatched ({num_windows} windows, "
                   f"bsearch={steps}, bbits={index.bucket_bits})")
        yield fi, text, index, steps


def run_match_unique(cfg: RealConfig, rs: reads_io.ReadSet,
                     texts: List[TextFile], device="cuda",
                     patid_filter: Optional[np.ndarray] = None,
                     cand_cap: Optional[int] = None,
                     survivor_cap: Optional[int] = None,
                     _depth: int = 0,
                     _index_cache: Optional[Dict] = None) -> MatchResult:
    """matchUnique over all texts; `texts` must live on `device`."""
    dev = _check_run(cfg, texts, device)
    if _index_cache is None:
        _index_cache = {}
    cand_cap = cand_cap or cfg.cand_cap
    survivor_cap = survivor_cap or cfg.survivor_cap
    numpat = rs.num_reads
    kw = _step_kwargs(cfg, cand_cap, survivor_cap)

    result = MatchResult(
        st=np.zeros(numpat, np.int32), pos=np.zeros(numpat, np.int32),
        frag=np.zeros(numpat, np.int32), fileid=np.zeros(numpat, np.int32),
        errs=np.zeros(numpat, np.int32),
        score=np.full(numpat, -np.finfo(np.float32).max, np.float32))

    prog = _Progress(cfg.verbose)
    with prog.phase("setup"):
        source = _make_source(cfg, rs, patid_filter, _depth, dev)
    plans = source.plans
    states = {bi: initial_state(p.rows, dev) for bi, p in enumerate(plans)}
    overflow_dev = {bi: torch.zeros(p.rows, dtype=torch.bool, device=dev)
                    for bi, p in enumerate(plans)}

    for fi, text, index, steps in _text_units(cfg, texts, numpat, cand_cap,
                                              prog, _index_cache):
        with prog.phase("match"):
            for bi, b in enumerate(source):
                states[bi], surv = match_step(
                    index.sig, index.pos, index.bb,
                    text.words, text.nbits, text.ncum, text.frag_offsets,
                    b.codes, b.quals, b.valid,
                    states[bi], fi, np.float32(cfg.filter_value(b.patl)),
                    bsearch_steps=steps, text_has_n=text.has_n, **kw)
                overflow_dev[bi] |= surv.overflow

    # the match loop only dispatches; its device work completes here
    with prog.phase("drain"):
        host = [[t.cpu().numpy() for t in states[bi]]
                + [overflow_dev[bi].cpu().numpy()]
                for bi in range(len(plans))]
    overflow = np.zeros(numpat, bool)
    with prog.phase("collect"):
        for bi, p in enumerate(plans):
            n = len(p.patids)
            st, pos, frag, fileid, errs, score, over = host[bi]
            result.st[p.patids] = st[:n]
            result.pos[p.patids] = pos[:n]
            result.frag[p.patids] = frag[:n]
            result.fileid[p.patids] = fileid[:n]
            result.errs[p.patids] = errs[:n]
            result.score[p.patids] = score[:n]
            overflow[p.patids[over[:n]]] = True

    over_ids = np.flatnonzero(overflow)
    result.metrics = {"phase_s": dict(prog.phase_s),
                      "overflow_rerun_reads": int(len(over_ids))}
    if len(over_ids):
        if _depth >= 4:
            raise RuntimeError(
                f"{len(over_ids)} reads overflow candidate caps even at "
                f"cand_cap={cand_cap}")
        print(f"rerunning {len(over_ids)} overflowing reads with "
              f"cand_cap={cand_cap * 16}", file=sys.stderr)
        sub = run_match_unique(
            cfg, rs, texts, device=dev, patid_filter=over_ids,
            cand_cap=cand_cap * 16, survivor_cap=survivor_cap * 16,
            _depth=_depth + 1, _index_cache=_index_cache)
        for f in ("st", "pos", "frag", "fileid", "errs", "score"):
            getattr(result, f)[over_ids] = getattr(sub, f)[over_ids]
        _add_rerun_phases(result.metrics["phase_s"], sub.metrics["phase_s"])
    _print_phases(cfg, result.metrics["phase_s"])
    return result


def _add_rerun_phases(phase_s: Dict[str, float],
                      sub: Dict[str, float]) -> None:
    for k, v in sub.items():
        phase_s[f"rerun.{k}"] = phase_s.get(f"rerun.{k}", 0.0) + v


def _print_phases(cfg: RealConfig, phase_s: Dict[str, float]) -> None:
    if cfg.verbose:
        print("phase timers: " + " ".join(
            f"{k}={v:.2f}s" for k, v in sorted(phase_s.items())),
            file=sys.stderr)


# ---------------------------------------------------------------------------
# matchAll
# ---------------------------------------------------------------------------

HIT_DTYPES = (np.int64, np.int64, np.int64, np.int64, np.int64,
               np.float32, bool)


@dataclasses.dataclass
class MatchAllResult:
    """Every qualifying hit of a matchAll run as columns (one entry per
    record), sorted by (pid; k, pos, fileid, frag, score, inv) — the
    reference's MatchPosAndError order, matchAllImplementation.cpp:121-148
    — and deduped (unifyMatches, :150-161), and the run's metrics."""
    pid: np.ndarray      # int64
    k: np.ndarray        # int64
    pos: np.ndarray      # int64
    fileid: np.ndarray   # int64
    frag: np.ndarray     # int64
    score: np.ndarray    # float32
    inv: np.ndarray      # bool
    # phase_s (seconds per phase), overflow_rerun_reads,
    # batch_hit_overflow_steps
    metrics: Dict[str, object] = dataclasses.field(default_factory=dict)

    @property
    def cols(self) -> tuple:
        return (self.pid, self.k, self.pos, self.fileid, self.frag,
                self.score, self.inv)

    def by_read(self) -> Dict[int, List[tuple]]:
        """{pid: [(k, pos, fileid, frag, score, inverted), ...]}."""
        out: Dict[int, List[tuple]] = {}
        if len(self.pid) == 0:
            return out
        bounds = np.flatnonzero(np.diff(self.pid)) + 1
        starts = np.concatenate([[0], bounds])
        ends = np.concatenate([bounds, [len(self.pid)]])
        for s, e in zip(starts, ends):
            out[int(self.pid[s])] = [
                (int(self.k[i]), int(self.pos[i]), int(self.fileid[i]),
                 int(self.frag[i]), float(self.score[i]), bool(self.inv[i]))
                for i in range(s, e)]
        return out


def _radix_argsort3(p1: np.ndarray, p2: np.ndarray,
                    p3: np.ndarray) -> np.ndarray:
    """Native stable LSD radix argsort by the composite order (p3, p2, p1)
    (native/readpack.cpp radix_argsort3): the same permutation as three
    stable np.argsort passes over p1, p2, p3."""
    lib = native.get_lib()
    n = len(p1)
    out = np.empty(n, np.int64)
    # the contiguous buffers stay alive across the call
    keys = [np.ascontiguousarray(p, np.uint64) for p in (p1, p2, p3)]
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.radix_argsort3(n, *(a.ctypes.data_as(u64p) for a in keys),
                       out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return out


def _stable_argsort3(p1: np.ndarray, p2: np.ndarray,
                     p3: np.ndarray) -> np.ndarray:
    """Plain version of _radix_argsort3: three stable np.argsort passes in
    LSD order."""
    order = np.argsort(p1, kind="stable")
    order = order[np.argsort(p2[order], kind="stable")]
    return order[np.argsort(p3[order], kind="stable")]


def _composite_keys(cols: tuple) -> Optional[tuple]:
    """The seven sort keys of hit columns folded into three uint64 keys
    (p1 least significant): p3 = pid, k; p2 = pos, fileid; p1 = score,
    inv. frag is a function of (fileid, pos), so it never decides, and
    score and inv only decide between the strands of one (pid, k, pos,
    fileid). None when a key is out of the composites' range."""
    pid, k, pos, fid, _, score, inv = cols
    if len(pid) and (int(pid.max()) >= 1 << 60 or int(fid.max()) >= 1 << 16
                     or int(pos.max()) >= 1 << 31):
        return None
    # +0.0 so -0.0 keys equal to +0.0 (float compare semantics);
    # order-preserving f32->u32: flip sign bit (+) / all bits (-)
    u32 = (score.astype(np.float32) + np.float32(0.0)).view(np.uint32)
    flip = ((u32.view(np.int32) >> 31).view(np.uint32)
            & np.uint32(0x7FFFFFFF)) | np.uint32(0x80000000)
    p1 = (u32 ^ flip).astype(np.uint64)
    p1 <<= 1
    p1 |= inv
    p2 = pos.astype(np.uint64, copy=True)
    p2 <<= 16
    p2 |= fid.astype(np.uint64, copy=False)
    p3 = pid.astype(np.uint64, copy=True)
    p3 <<= 4
    p3 |= k.astype(np.uint64, copy=False)
    return p1, p2, p3


def _sort_dedup_hits(cols: tuple, use_native: bool = True) -> tuple:
    """Sort hit columns (pid, k, pos, fileid, frag, score, inv) by all
    seven keys in that order and drop identical neighbours
    (real_tpu/engine/driver.py _sort_dedup_hits).

    The 7-key comparator collapses to three composite-uint64 keys sorted
    stably in LSD order (_composite_keys). The native radix sort takes
    the three keys in one call; three stable np.argsort passes are its
    plain version (use_native=False). Keys out of the composites' range
    take a 7-key lexsort."""
    pid, k, pos, fid, frag, score, inv = cols
    keys = _composite_keys(cols)
    if keys is None:
        order = np.lexsort((inv, score, frag, fid, pos, k, pid))
    elif use_native:
        order = _radix_argsort3(*keys)
    else:
        order = _stable_argsort3(*keys)
    pid, k, pos, fid, frag, score, inv = (
        a[order] for a in (pid, k, pos, fid, frag, score, inv))
    keep = np.ones(len(pid), bool)
    if len(pid) > 1:
        same = ((pid[1:] == pid[:-1]) & (k[1:] == k[:-1])
                & (pos[1:] == pos[:-1]) & (fid[1:] == fid[:-1])
                & (frag[1:] == frag[:-1]) & (score[1:] == score[:-1])
                & (inv[1:] == inv[:-1]))
        keep[1:] = ~same
    return tuple(a[keep] for a in (pid, k, pos, fid, frag, score, inv))


class _HitFetch:
    """One step's CompactHits on their way to the host: packed into one
    int32 buffer [pos | m1 | m2 | score bits | count | overflow]. On the
    card the copy goes non_blocking into pinned memory and an event marks
    its arrival, so the host waits only when it decodes the step."""

    def __init__(self, ch: CompactHits):
        self.h = ch.pos.shape[0]
        flat = torch.cat([ch.pos, ch.m1, ch.m2, ch.score.view(torch.int32),
                          ch.count.reshape(1), ch.overflow.to(torch.int32)])
        self.event = None
        if flat.device.type == "cuda":
            self.host = torch.empty(flat.shape, dtype=torch.int32,
                                    pin_memory=True)
            self.host.copy_(flat, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = flat

    def numpy(self) -> CompactHits:
        """The step's CompactHits as numpy arrays (waits for the copy)."""
        if self.event is not None:
            self.event.synchronize()
        a, h = self.host.numpy(), self.h
        return CompactHits(pos=a[:h], m1=a[h:2 * h], m2=a[2 * h:3 * h],
                           score=a[3 * h:4 * h].view(np.float32),
                           count=int(a[4 * h]),
                           overflow=a[4 * h + 1:].astype(bool))


class _HitAccumulator:
    """Hit columns decoded step by step from the compacted prefixes,
    sorted and deduped once at the end (matchAllImplementation.cpp:99-161
    unifyMatches semantics)."""

    def __init__(self) -> None:
        self.cols: List[Tuple[np.ndarray, ...]] = []
        # steps whose TOTAL hit count exceeded the device buffer H: the
        # whole batch is rerun (compact_hits)
        self.batch_overflow_steps = 0

    def add_compact(self, ch: CompactHits, patids: np.ndarray, fi: int,
                    n: int, overflow_out: np.ndarray) -> None:
        """Decode one step's CompactHits (numpy) for its n real reads."""
        overflow_out[patids[ch.overflow[:n]]] = True
        h = len(ch.pos)
        self.batch_overflow_steps += int(ch.count > h)
        c = min(ch.count, h)
        rows = ch.m1[:c] >> 4
        keep = rows < n            # padded rows never produce hits
        rows = rows[keep]
        if rows.size == 0:
            return
        self.cols.append((
            patids[rows].astype(np.int64),
            (ch.m1[:c][keep] & 15).astype(np.int64),
            ch.pos[:c][keep].astype(np.int64),
            np.full(rows.size, fi, np.int64),
            (ch.m2[:c][keep] >> 1).astype(np.int64),
            ch.score[:c][keep].astype(np.float32),
            (ch.m2[:c][keep] & 1).astype(bool)))

    def finalize(self, use_native: bool = True) -> tuple:
        """Sorted + deduped hit columns (pid, k, pos, fileid, frag,
        score, inv)."""
        if not self.cols:
            return tuple(np.zeros(0, dt) for dt in HIT_DTYPES)
        return _sort_dedup_hits(tuple(
            np.concatenate([c[i] for c in self.cols]) for i in range(7)),
            use_native)


# steps whose hits may be on their way to the host at once (real_tpu keeps
# the same depth of pending fetches)
_PENDING_MAX = 8


def run_match_all(cfg: RealConfig, rs: reads_io.ReadSet,
                  texts: List[TextFile], device="cuda",
                  patid_filter: Optional[np.ndarray] = None,
                  cand_cap: Optional[int] = None,
                  survivor_cap: Optional[int] = None,
                  as_arrays: bool = False,
                  _depth: int = 0,
                  _index_cache: Optional[Dict] = None):
    """Every qualifying hit per read; `texts` must live on `device`.

    Returns {patid: [(k, pos, fileid, frag, score, inverted), ...]} sorted
    and deduped in the reference's order — or, with as_arrays=True, the
    same records as a MatchAllResult of columns with the run's metrics
    (no per-hit Python objects; cli.output.write_all_arrays prints it).

    Each step's compacted hits start for the host right after the step is
    dispatched and are decoded once _PENDING_MAX newer steps are queued, so
    the copies overlap device work and device memory stays bounded. Reads
    that overflow a cap, or whose batch overflows the hit buffer, are
    rerun with 16x caps; their first-pass hits are dropped before the
    rerun's are merged."""
    dev = _check_run(cfg, texts, device)
    if _index_cache is None:
        _index_cache = {}
    cand_cap = cand_cap or cfg.cand_cap
    survivor_cap = survivor_cap or cfg.survivor_cap
    kw = _step_kwargs(cfg, cand_cap, survivor_cap)

    prog = _Progress(cfg.verbose)
    with prog.phase("setup"):
        source = _make_source(cfg, rs, patid_filter, _depth, dev)
    overflow = np.zeros(rs.num_reads, bool)
    acc = _HitAccumulator()
    pending: List[tuple] = []

    def drain(to_len: int) -> None:
        while len(pending) > to_len:
            fetch, patids, fi = pending.pop(0)
            acc.add_compact(fetch.numpy(), patids, fi, len(patids), overflow)

    for fi, text, index, steps in _text_units(cfg, texts, rs.num_reads,
                                              cand_cap, prog, _index_cache):
        with prog.phase("match"):
            for b in source:
                _, ch = match_step(
                    index.sig, index.pos, index.bb,
                    text.words, text.nbits, text.ncum, text.frag_offsets,
                    b.codes, b.quals, b.valid,
                    None, fi, np.float32(cfg.filter_value(b.patl)),
                    matchall=True, bsearch_steps=steps,
                    text_has_n=text.has_n, **kw)
                pending.append((_HitFetch(ch), b.patids, fi))
                drain(_PENDING_MAX)

    with prog.phase("drain"):
        drain(0)
    with prog.phase("finalize"):
        cols = acc.finalize(cfg.native_host)

    over_ids = np.flatnonzero(overflow)
    metrics = {"phase_s": dict(prog.phase_s),
               "overflow_rerun_reads": int(len(over_ids)),
               "batch_hit_overflow_steps": acc.batch_overflow_steps}
    if len(over_ids):
        if _depth >= 4:
            raise RuntimeError(
                f"{len(over_ids)} reads overflow matchAll caps even at "
                f"cand_cap={cand_cap}")
        print(f"rerunning {len(over_ids)} overflowing reads with "
              f"cand_cap={cand_cap * 16}", file=sys.stderr)
        sub = run_match_all(
            cfg, rs, texts, device=dev, patid_filter=over_ids,
            cand_cap=cand_cap * 16, survivor_cap=survivor_cap * 16,
            as_arrays=True, _depth=_depth + 1, _index_cache=_index_cache)
        keep = ~np.isin(cols[0], over_ids)
        cols = _sort_dedup_hits(tuple(
            np.concatenate([a[keep], b]) for a, b in zip(cols, sub.cols)),
            cfg.native_host)
        _add_rerun_phases(metrics["phase_s"], sub.metrics["phase_s"])
    _print_phases(cfg, metrics["phase_s"])
    result = MatchAllResult(*cols, metrics=metrics)
    return result if as_arrays else result.by_read()
