"""End-to-end matchUnique driver: one device, one index shard per text.

Counterpart of real_tpu/engine/driver.py (run_match_unique on its
sequential single-device path). Loop structure mirrors the reference
(matchUniqueImplementation.cpp:1082-1489):

    for each text file:                 (getFileList, ".fa" suffix)
      build packed text + fragment ranges
      build sorted signature lists      (one shard over the whole text)
      for each read length-bucket batch:
        match_step(...)                 (state persists per read)
    final pass: format records in read order

Per-read best-hit state lives on the device across files. Reads whose
candidates overflow the caps are rerun from scratch with 16x caps against
the cached index — the fixed-shape answer to std::equal_range's unbounded
ranges. Index sharding, the memory planner, streaming reads, checkpoints
and several devices wait for later slices of the port.

Entry points run on the card: `device` defaults to "cuda" and raises
without CUDA; only an explicit device="cpu" runs on the CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from real_tpu_torch.config import RealConfig
from real_tpu_torch.engine.matchstep import initial_state, match_step
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
        codes, ranges = fasta.parse_genome(p)
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


def run_match_unique(cfg: RealConfig, rs: reads_io.ReadSet,
                     texts: List[TextFile], device="cuda",
                     patid_filter: Optional[np.ndarray] = None,
                     cand_cap: Optional[int] = None,
                     survivor_cap: Optional[int] = None,
                     _depth: int = 0,
                     _index_cache: Optional[Dict] = None) -> MatchResult:
    """matchUnique over all texts; `texts` must live on `device`."""
    dev = resolve_device(device)
    if cfg.seedl > 32:
        raise NotImplementedError("seeds over 32 bases are not ported yet")
    if cfg.index_shards > 1:
        raise NotImplementedError("index sharding is not ported yet")
    for tf in texts:
        if tf.packed.words.device.type != dev.type:
            raise ValueError(f"text {tf.name} is on {tf.packed.words.device},"
                             f" the run on {dev}")
    if _index_cache is None:
        _index_cache = {}
    cand_cap = cand_cap or cfg.cand_cap
    survivor_cap = survivor_cap or cfg.survivor_cap
    numpat = rs.num_reads
    scoring = Scoring(cfg.similarity, cfg.gc, cfg.trans, cfg.err,
                      cfg.gcmut_bias)
    tables = score_tables(scoring) if cfg.scores else None

    result = MatchResult(
        st=np.zeros(numpat, np.int32), pos=np.zeros(numpat, np.int32),
        frag=np.zeros(numpat, np.int32), fileid=np.zeros(numpat, np.int32),
        errs=np.zeros(numpat, np.int32),
        score=np.full(numpat, -np.finfo(np.float32).max, np.float32))

    prog = _Progress(cfg.verbose)
    with prog.phase("setup"):
        source = pipeline.ResidentSource(
            rs, pipeline.make_plans(
                rs, cfg.batch_size, cfg.seedl, patid_filter,
                warn=lambda m: print(m, file=sys.stderr),
                max_rows=512 if _depth else 0), dev)
    plans = source.plans
    states = {bi: initial_state(p.rows, dev) for bi, p in enumerate(plans)}
    overflow_dev = {bi: torch.zeros(p.rows, dtype=torch.bool, device=dev)
                    for bi, p in enumerate(plans)}

    usable = [(fi, tf.packed) for fi, tf in enumerate(texts)
              if _text_usable(cfg, tf)]
    for fi, text in usable:
        num_windows = text.n - cfg.seedl + 1
        ck = (fi, 0, num_windows, cfg.seedl)
        index = _index_cache.get(ck)
        if index is None:
            # bucket-width hint: the FULL read-set size, so overflow
            # reruns build (and reuse) the same table as the first pass
            bbits = pick_bucket_bits(cfg.seedl, num_windows, rs.num_reads,
                                     cap=BUCKET_BITS_CAP)
            with prog.phase("index_build"):
                index = build_index(text, cfg.seedl, start=0,
                                    num_windows=num_windows,
                                    bucket_bits=bbits)
            if len(usable) == 1:
                _index_cache[ck] = index
        steps = _bsearch_steps_static(num_windows, cand_cap,
                                      index.bucket_bits)
        prog.event(f"file {fi}: index dispatched ({num_windows} windows, "
                   f"bsearch={steps}, bbits={index.bucket_bits})")
        with prog.phase("match"):
            for bi, b in enumerate(source):
                states[bi], surv = match_step(
                    index.sig, index.pos, index.bb,
                    text.words, text.nbits, text.ncum, text.frag_offsets,
                    b.codes, b.quals, b.valid,
                    states[bi], fi, np.float32(cfg.filter_value(b.patl)),
                    tables=tables, seedl=cfg.seedl, seedkmax=cfg.seedkmax,
                    totalkmax=cfg.totalkmax, cand_cap=cand_cap,
                    survivor_cap=survivor_cap, scores=cfg.scores,
                    bsearch_steps=steps, text_has_n=text.has_n)
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
        for k, v in sub.metrics["phase_s"].items():
            result.metrics["phase_s"][f"rerun.{k}"] = (
                result.metrics["phase_s"].get(f"rerun.{k}", 0.0) + v)
    if cfg.verbose:
        print("phase timers: " + " ".join(
            f"{k}={v:.2f}s" for k, v in sorted(
                result.metrics["phase_s"].items())), file=sys.stderr)
    return result
