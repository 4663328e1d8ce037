"""End-to-end matchUnique and matchAll drivers, on one device or on a mesh.

Counterpart of real_tpu/engine/driver.py (run_match_unique and
run_match_all). Loop structure mirrors the reference
(matchUniqueImplementation.cpp:1082-1489):

    for each text file:                 (getFileList, ".fa" suffix)
      build packed text + fragment ranges
      plan index shards from the -f memory budget (parallel/plan.py)
      for each shard (a "unit"):        (memory-bounded block streaming)
        build sorted signature lists
        for each read length-bucket batch:
          match_step(...)               (state persists per read)
    final pass: format records in read order

A job is one skeleton (_run) over a route, in a mode. The route is how the
run spreads its work, chosen in one place (_route): one device
(SeqLayout; with -exchange the ranks of a multi-process run, each on its
own read slice (parallel/multihost.py), split the index build and load
each other's shards); a rank of a rank mesh (MeshPlan, plan_mesh;
cfg.use_mesh, parallel/mesh.py), whose ranks form a dp x shard grid: each
dp row matches one read slice, and in each pass every rank of a row builds
its own shard and the row gathers and folds its survivors shard-major
after every step; or an in-process mesh (LocalLayout over
local_mesh_cells: real_tpu's default on a host of several devices), the
same grid driven by one process, one mesh per text shaped by its plan,
each batch split over the dp rows (a rank of a multi-process job drives
such a mesh of its own cards over its read slice, real_tpu's multi-host
design). Every route's units (shards, or passes) run through one loop
(_foreach_unit) in ascending window order into the same per-batch states:
the scored matchUnique fold is order-defined, so any other order could
change records. Shard windows are disjoint, so matchAll sees each hit
once. At most two units are in flight (one when the plan serializes
builds, which frees a unit's lists before the next build). Reads stay on
the device across units when their packed bytes fit the resident budget;
otherwise io/pipeline.py streams them once per unit.

The mode is what matchUnique and matchAll do differently: _UniqueMode
keeps per-read best-hit state on the device across files and units;
_AllMode compacts each step's hits on the device and sorts and dedups all
of them on the host. Reads whose candidates overflow the caps are rerun
from scratch with 16x caps — the fixed-shape answer to std::equal_range's
unbounded ranges; a single-unit run of one device keeps its index for
those reruns. With -ckpt the state goes to disk after completed units and
a later run skips them (engine/checkpoint.py); every blocking device fetch
sits under the watchdog (utils/watchdog.py).

Entry points run on the card: `device` defaults to "cuda" and raises
without CUDA; only an explicit device="cpu" runs on the CPU.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import os
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from real_tpu_torch import native
from real_tpu_torch.config import RealConfig
from real_tpu_torch.engine import checkpoint as ckpt_mod
from real_tpu_torch.engine.matchstep import (CompactHits, MatchState,
                                             Survivors, initial_state,
                                             match_step)
from real_tpu_torch.index.build import (SignatureIndex, build_index,
                                        pick_bucket_bits, shard_windows)
from real_tpu_torch.io import fasta, pipeline, reads as reads_io
from real_tpu_torch.parallel import mesh as mesh_mod
from real_tpu_torch.parallel import multihost, plan
from real_tpu_torch.parallel.mesh import sharded_match_step
from real_tpu_torch.scoring.scoring import Scoring, score_tables
from real_tpu_torch.text.packed import PackedText, build_packed_text
from real_tpu_torch.utils import spans
from real_tpu_torch.utils.watchdog import watchdog

MAX_FRAGMENTS_PER_FILE = 1 << 16   # UniqueMatchInfo fragmentbits
# bucket-table width cap of a pipelined shard plan (parallel/plan.py)
BUCKET_BITS_CAP = 25
# share of the device's memory that packed reads may hold resident when
# cfg.resident_reads_bytes is 0 — real_tpu's share, a policy and not a
# measurement: a FASTQ read of 100 bases packs to 129 B, so an 80 GB card
# keeps ~79M of them and streams only beyond that
RESIDENT_READS_SHARE = 0.12
# A match step's transient device bytes per survivor lane and read base:
# tools/planprobe.py measured 51.9-54.0 on an NVIDIA H100 80GB HBM3 (peak
# of a scored step over the bytes live before it, 32,768 reads of 50, 75
# and 100 bases, 8 lanes; PERF.md); kept with a margin. The planner
# reserves them beside the texts and the resident reads.
STEP_BYTES_PER_LANE_BASE = 60
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


@spans.traced("genome.load")
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
                          bucket_bits: int) -> int:
    """In-bucket binary-search depth for find_survivors, chosen on the
    host from the shard's window count and bucket width (real_tpu's rule).
    0 = the bucket range is the candidate range (two-tier lane path);
    escalated caps always bisect. An unconverged bisection only
    over-approximates its range, which at worst raises an overflow."""
    occ = num_windows / float(1 << bucket_bits)
    if cand_cap <= 16 and occ <= 2.0 * max(cand_cap / 8.0, 1.0):
        return 0
    occ = max(8.0 * max(occ, 1.0), float(2 * cand_cap))
    steps = int(np.ceil(np.log2(occ + 1)))
    return min(-(-steps // 4) * 4, 30)


def _build(cfg: RealConfig, text: PackedText, start: int, num_windows: int,
           reads: int, splan: plan.StreamShardPlan) -> SignatureIndex:
    """The index over windows [start, start+num_windows). Its bucket width
    comes from the FULL read-set size, so that overflow reruns build (and
    reuse) the same table as the first pass."""
    bbits = pick_bucket_bits(cfg.seedl, num_windows, reads,
                             cap=splan.bucket_bits_cap)
    return build_index(text, cfg.seedl, start=start, num_windows=num_windows,
                       bucket_bits=bbits)


def _shard_bounds(num_windows: int, num_shards: int) -> List[Tuple[int, int]]:
    """[start, end) window ranges of a text's shards, 16-aligned starts."""
    per = shard_windows(num_windows, num_shards)
    return [(s, min(s + per, num_windows))
            for s in range(0, num_windows, per)]


def _text_bytes(text: PackedText) -> int:
    return sum(t.numel() * t.element_size() for t in
               (text.words, text.nbits, text.ncum, text.nb16, text.ncum16))


def _step_workspace_bytes(plans, survivor_cap: int) -> int:
    """Transient device bytes of the largest match step of `plans`."""
    lanes = max((p.rows * p.patl for p in plans), default=0) * survivor_cap
    return lanes * STEP_BYTES_PER_LANE_BASE


def _plan_shards(cfg: RealConfig, text: PackedText, dev: torch.device,
                 reserved_bytes: int = 0, streaming: bool = False,
                 reads: int = 0, cells: int = 1) -> plan.StreamShardPlan:
    """-shards override or the -f fracmem memory planner. reserved_bytes
    must cover ALL device-resident texts (split oversized files keep every
    sub-text uploaded for the whole run), the resident reads and the match
    step's workspace. `cells` of an in-process mesh that share `dev` each
    plan against 1/cells of its memory and of reserved_bytes
    (plan.device_cells).

    The pass-minimizing serial-build plan (plan_index_shards_streaming)
    applies when passes are expensive relative to builds — always when
    reads re-stream per pass (streaming=True), and for resident reads when
    the estimated per-pass match time dwarfs a serial shard's build time."""
    if cfg.index_shards > 0:
        return plan.StreamShardPlan(shards=cfg.index_shards,
                                    serial_build=False,
                                    bucket_bits_cap=BUCKET_BITS_CAP)
    num_windows = max(text.n - cfg.seedl + 1, 0)
    reserved = (reserved_bytes or _text_bytes(text)) // cells
    model = plan.model_for(cfg.seedl)
    hbm = plan.hbm_bytes_per_device(dev) // cells
    splan = plan.plan_index_shards_streaming(
        num_windows, cfg.fracmem, reserved_bytes=reserved, hbm_bytes=hbm,
        model=model)
    if splan.serial_build and not streaming:
        match_pass_s = reads * plan.MATCH_S_PER_READ_PASS
        build_shard_s = (num_windows / max(splan.shards, 1)) \
            * plan.BUILD_S_PER_WINDOW
        if match_pass_s <= 3 * build_shard_s:
            splan = None
    elif not splan.serial_build:
        splan = None
    if splan is not None:
        return splan
    return plan.StreamShardPlan(
        shards=plan.plan_index_shards(num_windows, cfg.fracmem,
                                      reserved_bytes=reserved,
                                      hbm_bytes=hbm, model=model),
        serial_build=False, bucket_bits_cap=BUCKET_BITS_CAP)


@dataclasses.dataclass
class MatchResult:
    """Final per-read state (host) and the run's metrics."""
    st: np.ndarray
    pos: np.ndarray
    frag: np.ndarray
    fileid: np.ndarray
    errs: np.ndarray
    score: np.ndarray
    # phase_s (seconds per phase), overflow_rerun_reads, and the loop's
    # account of itself (_loop_metrics)
    metrics: Dict[str, object] = dataclasses.field(default_factory=dict)


class _Progress:
    """stderr progress (with -v) + per-phase host-clock timers: a phase
    is a span of the job (utils/spans.py), and phase_s sums their
    lengths."""

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
        with spans.span(name) as s:
            yield
        self.phase_s[name] = self.phase_s.get(name, 0.0) + s.ns / 1e9


def _check_run(cfg: RealConfig, texts: List[TextFile],
               device) -> torch.device:
    """The run's device, after the checks every entry point shares."""
    dev = resolve_device(device)
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
                 dev: torch.device,
                 cells: Optional[List[torch.device]] = None
                 ) -> pipeline.BatchSource:
    """Length-bucketed batch source: resident (one bulk upload, reused
    across shard passes) when the packed reads fit the budget, else the
    streaming pipeline (io/pipeline.py). Overflow reruns use 512-row
    batches. For an in-process mesh (`cells`) every batch's rows are
    divisible by the cell count, so that any grid of the cells splits it
    over its dp rows (BatchSource.rows)."""
    return pipeline.make_source(
        rs, cfg.batch_size, cfg.seedl, None if cells else dev, patid_filter,
        warn=lambda m: print(m, file=sys.stderr),
        resident_budget_bytes=_resident_budget(cfg, cells or [dev]),
        max_rows=512 if depth else 0, use_native=cfg.native_host,
        row_align=len(cells) if cells else 1)


def _resident_budget(cfg: RealConfig, devices) -> int:
    """Packed read bytes the batch source may keep on each of `devices`
    (the tightest of them)."""
    if cfg.resident_reads_bytes > 0:
        return cfg.resident_reads_bytes
    return min(int(RESIDENT_READS_SHARE * plan.hbm_bytes_per_device(d))
               for d in dict.fromkeys(devices))


def _record_events(devices) -> List["torch.cuda.Event"]:
    """An event after everything queued so far on the current stream of
    each distinct CUDA device of `devices`; none on the CPU, where every
    call has finished on return."""
    out = []
    for dev in dict.fromkeys(devices):
        if dev.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            out.append(ev)
    return out


def _wait_events(cfg: RealConfig, evs, what: str) -> None:
    for ev in evs:
        with watchdog(cfg.watchdog_s, what):
            ev.synchronize()


class _DispatchWindow:
    """Bounds the dispatched batches in flight in streaming-read mode:
    without it the host queues a whole unit ahead of the device, and every
    uploaded batch stays allocated until its steps have run, defeating the
    streaming source's memory bound (io/pipeline.py). Waiting for the
    event recorded `depth` batches ago keeps (depth + prefetch) batches
    alive at most while upload, compute and the host loop still overlap."""

    def __init__(self, cfg: RealConfig, devices, enabled: bool,
                 depth: int = 4):
        self.cfg, self.devices = cfg, list(devices)
        self.enabled = enabled and any(d.type == "cuda" for d in devices)
        self.depth = depth
        self._window: List = []

    def push(self) -> None:
        if not self.enabled:
            return
        self._window.append(_record_events(self.devices))
        if len(self._window) > self.depth:
            _wait_events(self.cfg, self._window.pop(0), "dispatch window")


@dataclasses.dataclass
class _Unit:
    """A unit of the unit loop: an index shard of a text on one device, or
    a pass of a mesh (every shard of it built at once). build() makes its
    index (an in-process mesh's pass: its cells' indexes); rows(source,
    index) yields each batch's rows: per dp row (patids, step), step(state,
    fileid, epsilon, **kw) the row's match step bound to its rows and to
    the unit's index and text. `devices` are those whose events bound the
    units in flight, `homes` each dp row's home (None: the run's
    device)."""
    fi: int
    text: PackedText
    windows: int                  # windows of its shard (of each shard)
    serial: bool                  # its plan serializes the builds
    build: Callable[[], object]
    rows: Callable
    what: str                     # progress line: "shard 1/3", "pass 1/2"
    sizes: str                    # progress line: the shards' size
    bbits: Optional[int] = None   # bucket width; None: the built index's
    key: Optional[tuple] = None   # in the single-unit index cache
    devices: Optional[List[torch.device]] = None
    homes: Optional[List[torch.device]] = None


class _BuildClock:
    """The seconds the index builds of one depth occupy their devices: a
    timing event before and after each build on the current stream of
    each of its CUDA devices, read after the depth's drain, so that
    reading them waits for nothing (a unit on several devices counts its
    longest); a build on the CPU has finished on return and is timed on
    the host."""

    def __init__(self, dev: torch.device) -> None:
        self.dev = dev
        self.builds = 0
        self._pairs: List[List[Tuple]] = []
        self._host_s = 0.0

    @staticmethod
    def _event(dev: torch.device) -> "torch.cuda.Event":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(dev))
        return ev

    def build(self, u: _Unit):
        self.builds += 1
        devs = [d for d in dict.fromkeys(u.devices or [self.dev])
                if d.type == "cuda"]
        if not devs:
            t = time.perf_counter()
            index = u.build()
            self._host_s += time.perf_counter() - t
            return index
        starts = [self._event(d) for d in devs]
        index = u.build()
        self._pairs.append([(a, self._event(d))
                            for a, d in zip(starts, devs)])
        return index

    def seconds(self) -> float:
        dev_s = 0.0
        for pairs in self._pairs:
            for _, b in pairs:
                b.synchronize()
            dev_s += max(a.elapsed_time(b) for a, b in pairs) / 1e3
        return self._host_s + dev_s


def _device_rows(step, t: PackedText, source: pipeline.BatchSource, index):
    """One device's (one rank's) rows: the whole batch, and `step`
    (match_step, sharded_match_step)."""
    for b in source:
        yield [(b.patids, functools.partial(
            step, index.sig, index.pos, index.bb, t.words, t.nbits, t.ncum,
            t.frag_offsets, b.codes, b.quals, b.valid))]


class _Route:
    """A way a run spreads its work (SeqLayout, MeshPlan, LocalLayout) as
    the job and the unit loop see it: tag() keys the checkpoint, units()
    lists the units, meshes() are those whose gathers the loop's account
    adds (`mesh`, `mesh_gathers`, the `mesh_gather` phase)."""
    exchange = None

    def meshes(self) -> Optional[list]:
        return None

    def agree_resume(self, units_done: int) -> bool:
        return True


def _usable_texts(cfg: RealConfig, texts: List[TextFile],
                  extra_reserved: int):
    """The texts a run matches, as (fi, packed), and the bytes a planner
    reserves: ALL of them (split oversized files keep every sub-text
    uploaded for the whole run) plus extra_reserved (resident reads, the
    match step's workspace). A text too small or of too many fragments is
    skipped with a message."""
    usable = []
    for fi, tf in enumerate(texts):
        if tf.packed.n < cfg.seedl:
            print(f"File {tf.name} is too small for seed length, skipping "
                  "it.", file=sys.stderr)
        elif tf.packed.num_fragments > MAX_FRAGMENTS_PER_FILE:
            print(f"Number of fragments {tf.packed.num_fragments + 1} in file"
                  " is larger than limit we can handle, skipping it.",
                  file=sys.stderr)
        else:
            usable.append((fi, tf.packed))
    return usable, sum(_text_bytes(t) for _, t in usable) + extra_reserved


@dataclasses.dataclass
class SeqLayout(_Route):
    """A one-device run's layout: for each usable text, its shard bounds
    and shard plan, the bytes the plans reserved, the read count of the
    bucket widths and the exchange the plan was agreed through. The run's
    checkpoint is keyed by it (tag): units are counted in this layout, so
    a checkpoint of another plan would skip other windows."""
    texts: List[Tuple[int, PackedText, List[Tuple[int, int]],
                      plan.StreamShardPlan]]
    reserved_bytes: int
    reads: int
    exchange: Optional[multihost.BuildExchange] = None

    def tag(self) -> str:
        """A checkpoint belongs to each text's shard count and build
        mode."""
        return "seq:" + str([(fi, sp.shards, sp.serial_build)
                             for fi, _, _, sp in self.texts]) + "-"

    def units(self, cfg: RealConfig, texts) -> List[_Unit]:
        return [_Unit(fi, text, e - s, splan.serial_build,
                      functools.partial(_build, cfg, text, s, e - s,
                                        self.reads, splan),
                      functools.partial(_device_rows, match_step, text),
                      f"shard {si + 1}/{len(bounds)}", f"{e - s} windows",
                      key=(fi, s, e, cfg.seedl))
                for fi, text, bounds, splan in self.texts
                for si, (s, e) in enumerate(bounds)]

    def plan_accounts(self, cfg: RealConfig, cand_cap: int) -> list:
        return [_plan_account(cfg, sp, bounds, self.reads, cand_cap)
                for _, _, bounds, sp in self.texts]


@spans.traced("plan")
def _seq_layout(cfg: RealConfig, texts: List[TextFile], dev: torch.device,
                source: pipeline.BatchSource, survivor_cap: int, *,
                reads: int = 0, exchange=None) -> SeqLayout:
    """Plan every usable text against ALL resident texts' bytes, the
    resident reads and the step's workspace. With an exchange (a
    multihost.BuildExchange) every rank takes rank 0's plan: its read
    slice, and so its budget, may differ from the others'."""
    usable, reserved = _usable_texts(
        cfg, texts, source.resident_device_bytes
        + _step_workspace_bytes(source.plans, survivor_cap))
    per_text = []
    for fi, text in usable:
        num_windows = text.n - cfg.seedl + 1
        splan = _plan_shards(cfg, text, dev, reserved_bytes=reserved,
                             streaming=not source.resident, reads=reads)
        per_text.append((fi, text, _shard_bounds(num_windows, splan.shards),
                         splan))
    if exchange is not None:
        texts_by_fi = dict(usable)
        per_text = [(fi, texts_by_fi[fi], bounds, splan)
                    for fi, bounds, splan in exchange.agree(
                        [(fi, b, sp) for fi, _, b, sp in per_text])]
    return SeqLayout(per_text, int(reserved), reads, exchange)


def _plan_account(cfg: RealConfig, splan: plan.StreamShardPlan,
                  bounds: List[Tuple[int, int]], reads: int,
                  cand_cap: int) -> Dict[str, object]:
    """A text's shard plan with, for each of its shards, the windows, the
    bucket width (_build's) and the in-bucket bisection depth."""
    windows = [e - s for s, e in bounds]
    bbits = [pick_bucket_bits(cfg.seedl, w, reads, cap=splan.bucket_bits_cap)
             for w in windows]
    return dict(dataclasses.asdict(splan), windows=windows,
                bucket_bits=bbits,
                bsearch_steps=[_bsearch_steps_static(w, cand_cap, b)
                               for w, b in zip(windows, bbits)])


@dataclasses.dataclass
class MeshPlan(_Route):
    """A mesh run's layout, agreed by every rank before the run
    (plan_mesh): this rank's Mesh, its row's read slice [lo, hi) of the
    whole read set, the whole set's read count (the bucket-width hint, so
    that every shard and every row builds the same table width), and rank
    0's shard plan of each usable text with the bytes it reserved. The
    overflow reruns keep it: they run no collective over the whole job.
    A unit is a pass: this rank builds its shard, each step gathers."""
    mesh: mesh_mod.Mesh
    lo: int
    hi: int
    num_reads: int
    plans: Dict[int, plan.StreamShardPlan]
    reserved_bytes: int

    def tag(self) -> str:
        """A checkpoint belongs to its grid and each text's shards."""
        m = self.mesh
        return (f"mesh{m.n_dp}x{m.n_shard}.{m.dp}.{m.shard}:"
                f"{sorted((fi, p.shards) for fi, p in self.plans.items())}"
                "-")

    def units(self, cfg: RealConfig, texts) -> List[_Unit]:
        m = self.mesh
        step = functools.partial(sharded_match_step, mesh=m)
        return [_Unit(fi, texts[fi].packed, per, serial, functools.partial(
                    mesh_mod.build_sharded_index, texts[fi].packed,
                    cfg.seedl, r * m.n_shard * per, per, m, bbits),
                    functools.partial(_device_rows, step, texts[fi].packed),
                    f"pass {r + 1}/{rounds}",
                    f"shard {m.shard} of {m.n_shard} x {per} windows", bbits)
                for fi, splan in self.plans.items()
                for r, rounds, per, bbits, serial in _mesh_passes(
                    cfg, texts[fi].packed, splan, m.n_shard, self.num_reads)]

    def plan_accounts(self, cfg: RealConfig, cand_cap: int) -> list:
        return [dataclasses.asdict(sp) for sp in self.plans.values()]

    def meshes(self) -> list:
        return [self.mesh]

    def mesh_account(self) -> dict:
        m = self.mesh
        return {"n_dp": m.n_dp, "n_shard": m.n_shard, "dp": m.dp,
                "shard": m.shard}

    def agree_resume(self, units_done: int) -> bool:
        """Only when every rank of the row holds the same unit count."""
        return bool(mesh_mod.agree_resume(self.mesh, units_done))


@spans.traced("plan")
def plan_mesh(cfg: RealConfig, rs: reads_io.ReadSet,
              texts: List[TextFile], device="cuda") -> MeshPlan:
    """Lay out a mesh run of the whole read set `rs`; every rank of the
    job calls this with the same arguments, and then matches
    rs.records(lo, hi).

    The plan, the slice and the mesh shape depend on one another (the
    planner's budget needs the resident read bytes, those the slice, the
    slice n_dp, and n_dp the shard count). So rank 0 plans every text
    against the WHOLE set's packed bytes, which bound every slice's, and
    broadcasts its plans; every rank then takes the mesh shape
    (multihost.dp_shard_axes over its node's ranks), joins its shard row
    and takes its row's slice (multihost.host_read_slice). One mesh serves
    every text, its shard axis chosen for the text with the most shards;
    a text with fewer runs as more, narrower shards. Without a process
    group this raises."""
    cfg.validate()
    dev = _check_run(cfg, texts, device)
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("use_mesh needs an initialized process group "
                           "(parallel/multihost.initialize)")
    topo = multihost.current_topology()
    batches = pipeline.make_plans(rs, cfg.batch_size, cfg.seedl)
    read_bytes = sum(pipeline.packed_batch_bytes(
        p.rows, p.patl, rs.quals_flat is not None) for p in batches)
    resident = read_bytes <= _resident_budget(cfg, [dev])
    usable, reserved = _usable_texts(
        cfg, texts, (read_bytes if resident else 0)
        + _step_workspace_bytes(batches, cfg.survivor_cap))
    box = [None]
    if topo.process_index == 0:
        box[0] = {fi: _plan_shards(cfg, text, dev, reserved_bytes=reserved,
                                   streaming=not resident,
                                   reads=rs.num_reads)
                  for fi, text in usable}
    dist.broadcast_object_list(box, src=0)
    shard_plans = box[0]
    n_local = multihost.local_rank_count(topo)
    if topo.process_count % n_local:
        raise ValueError(f"{topo.process_count} ranks are not whole nodes "
                         f"of {n_local}")
    n_dp, n_shard = multihost.dp_shard_axes(
        n_local, topo.process_count // n_local,
        max((p.shards for p in shard_plans.values()), default=1))
    mesh = mesh_mod.make_mesh(n_dp, n_shard)
    lo, hi = multihost.host_read_slice(
        rs.num_reads, multihost.HostTopology(mesh.dp, n_dp))
    return MeshPlan(mesh, lo, hi, rs.num_reads, shard_plans, reserved)


def _mesh_passes(cfg: RealConfig, text: PackedText,
                 splan: plan.StreamShardPlan, n_shard: int, reads: int):
    """A text's passes on a mesh of n_shard shards (real_tpu/engine/
    driver.py _foreach_shard_mesh): its plan of `shards` runs as
    rounds = ceil(shards / n_shard) passes of n_shard shards of
    per_shard = round16(ceil(windows / (rounds * n_shard))) windows, one
    bucket width for every shard; a pass that would start at or past the
    last window is skipped. Returns (r, rounds, per_shard, bucket_bits,
    serial_build) per pass."""
    nw = text.n - cfg.seedl + 1
    rounds = -(-splan.shards // n_shard)
    per_shard = shard_windows(nw, rounds * n_shard)
    bbits = pick_bucket_bits(cfg.seedl, per_shard, reads,
                             cap=splan.bucket_bits_cap)
    return [(r, rounds, per_shard, bbits, splan.serial_build)
            for r in range(rounds) if r * n_shard * per_shard < nw]


def local_mesh_cells(cfg: RealConfig,
                     device) -> Optional[List[torch.device]]:
    """The cells of an in-process mesh run, or None for a run of one
    device. real_tpu meshes a process's local devices whenever it sees
    more than one (use_mesh None), in a job of several processes too; so
    here use_mesh None meshes the cells cfg.mesh_devices names (under a
    job: this rank's cells), else, when `device` is the unqualified
    "cuda", every card the process sees, or in a job of several ranks the
    rank's own cards (multihost.rank_cells) when they are more than one.
    `-device cuda:K` pins one card, `-device cpu` runs one cell; use_mesh
    True is the rank mesh (plan_mesh), False one device. A cell that
    cannot be reached raises (mesh.check_cells), and so does a rank's
    mesh with -exchange (real_tpu ignores the exchange on its mesh path;
    the port raises where real_tpu falls back)."""
    if cfg.use_mesh is not None:
        return None
    topo = multihost.current_topology()
    dev = torch.device(device)
    if cfg.mesh_devices:
        cells = mesh_mod.check_cells(cfg.mesh_devices)
    elif dev.type != "cuda" or dev.index is not None:
        return None
    elif topo.process_count > 1:
        cells = mesh_mod.check_cells(multihost.rank_cells(
            "cuda", topo, torch.cuda.device_count()))
        if len(cells) == 1:
            return None
    elif torch.cuda.device_count() > 1:
        cells = mesh_mod.local_devices()
    else:
        return None
    if topo.process_count > 1 and cfg.build_exchange_dir:
        raise ValueError("-exchange and a rank's in-process mesh exclude "
                         "each other: the mesh builds every shard of its "
                         "cells itself (pin one card with -device cuda:K "
                         "to exchange shards)")
    return cells


@dataclasses.dataclass
class LocalLayout(_Route):
    """An in-process mesh run's layout: for each usable text, its shard
    plan and its own LocalMesh over the cells (real_tpu re-meshes per
    text), the bytes the plans reserved on each device, the rank of the
    job that runs it (0 of 1 outside a job) and the read count of the
    bucket widths. A unit is a pass on its text's mesh: every cell's shard
    is built, each row's survivors fold on the row's home."""
    cells: List[torch.device]
    texts: List[Tuple[int, plan.StreamShardPlan, mesh_mod.LocalMesh]]
    reserved_bytes: int
    topo: multihost.HostTopology
    reads: int

    def tag(self) -> str:
        """A checkpoint belongs to its rank, its cells and each text's
        grid."""
        grids = [(fi, m.n_dp, m.n_shard, p.shards)
                 for fi, p, m in self.texts]
        rank = (f"rank{self.topo.process_index}of"
                f"{self.topo.process_count}." if self.topo.process_count > 1
                else "")
        return f"{rank}local{len(self.cells)}:{grids}-"

    def units(self, cfg: RealConfig, texts) -> List[_Unit]:
        replicas: Dict[int, Dict] = {}          # one text's at a time
        return [_Unit(fi, texts[fi].packed, per, serial, functools.partial(
                    _build_local, replicas, cfg, fi, texts[fi].packed, m,
                    r * m.n_shard * per, per, bbits),
                    functools.partial(_local_rows, m, replicas, fi),
                    f"pass {r + 1}/{rounds}",
                    f"{m.n_dp} x {m.n_shard} cells, {per} windows per shard",
                    bbits, devices=m.devices,
                    homes=[m.home(d) for d in range(m.n_dp)])
                for fi, splan, m in self.texts
                for r, rounds, per, bbits, serial in _mesh_passes(
                    cfg, texts[fi].packed, splan, m.n_shard, self.reads)]

    def plan_accounts(self, cfg: RealConfig, cand_cap: int) -> list:
        return [dataclasses.asdict(sp) for _, sp, _ in self.texts]

    def meshes(self) -> list:
        return [m for _, _, m in self.texts]

    def mesh_account(self) -> dict:
        """The cells, each text's grid and each cell's kernel launches."""
        meshes = self.meshes()
        launches: Dict[int, Dict[str, int]] = {}
        for m in meshes:
            for c, counts in m.launches.items():
                tot = launches.setdefault(c, dict.fromkeys(counts, 0))
                for k, v in counts.items():
                    tot[k] += v
        return {"rank": self.topo.process_index,
                "ranks": self.topo.process_count,
                "n_dp": meshes[0].n_dp if meshes else 0,
                "n_shard": meshes[0].n_shard if meshes else 0,
                "devices": [str(d) for d in self.cells],
                "grids": [[fi, m.n_dp, m.n_shard] for fi, _, m in self.texts],
                "cell_launches": [launches.get(c, {}) for c in
                                  range(len(self.cells))]}


def _build_local(replicas: Dict[int, Dict], cfg: RealConfig, fi: int,
                 text: PackedText, m: mesh_mod.LocalMesh, start: int,
                 per_shard: int, bbits: int):
    """Every cell's shard of a pass, from the text's replicas."""
    if fi not in replicas:
        replicas.clear()
        replicas[fi] = mesh_mod.replicate_text(text, m.devices)
    return mesh_mod.build_local_shards(replicas[fi], cfg.seedl, start,
                                       per_shard, m, bbits)


def _local_rows(m: mesh_mod.LocalMesh, replicas: Dict[int, Dict], fi: int,
                source: pipeline.BatchSource, indexes):
    """Each dp row's slice of the batch, and local_row_step on its cells."""
    for p, parts in zip(source.plans, source.rows(m.layout())):
        yield [(pipeline.row_plan(p, m.n_dp, d).patids,
                functools.partial(mesh_mod.local_row_step, m, d, indexes,
                                  replicas[fi], parts[d]))
               for d in range(m.n_dp)]


@spans.traced("plan")
def _local_layout(cfg: RealConfig, texts: List[TextFile],
                  cells: List[torch.device], source: pipeline.BatchSource,
                  reads: int, survivor_cap: int) -> LocalLayout:
    """Plan each usable text on every distinct device of `cells`, each
    cell against its share of its device (plan.device_cells), and take the
    plan of the most shards; the text's mesh is choose_mesh_shape(cells,
    shards) (real_tpu/engine/driver.py _foreach_shard_mesh). Reserved on
    each device: every text, the whole read set when resident (it bounds
    the slices of the rows there) and one step's workspace."""
    usable, reserved = _usable_texts(
        cfg, texts, source.resident_device_bytes
        + _step_workspace_bytes(source.plans, survivor_cap))
    per_text = []
    for fi, text in usable:
        splan = max((_plan_shards(cfg, text, dev, reserved_bytes=reserved,
                                  streaming=not source.resident, reads=reads,
                                  cells=k)
                     for dev, k in plan.device_cells(cells).items()),
                    key=lambda sp: sp.shards)
        n_dp, n_shard = plan.choose_mesh_shape(len(cells), splan.shards)
        per_text.append((fi, splan,
                         mesh_mod.make_local_mesh(n_dp, n_shard, cells)))
    return LocalLayout(cells, per_text, reserved,
                       multihost.current_topology(), reads)


def _foreach_unit(cfg: RealConfig, route: _Route, texts: List[TextFile],
                  cand_cap: int, visit, prog: _Progress, *,
                  skip_units: int = 0,
                  index_cache: Optional[Dict] = None,
                  clock: Optional[_BuildClock] = None) -> Dict[str, object]:
    """The unit loop of every route: for each unit in order, take its
    index from index_cache, the exchange or a build, and call visit(unit,
    index, bsearch_steps). The first skip_units units are skipped entirely
    (checkpoint resume): their index builds never run. Returns the loop's
    account of itself.

    Under an exchange (the BuildExchange a one-device layout was agreed
    through) every rank builds and publishes the units it owns, then loads
    every unit, its own included, from the exchange.

    visit returns the events recorded after its last dispatch (none on
    the CPU); at most 2 units are kept in flight, and 1 under a
    serial_build plan, which also drops the previous unit's lists BEFORE
    the next build so that the peak is one build and not lists plus a
    build. Each wait for a unit in flight is a span `index.unit_wait`;
    each build adds 1 to the job's counter `index.units_built` and the
    unit's windows (a mesh pass: its shard width) to
    `index.windows_built`, at every depth; a cache hit or an exchange load
    adds nothing. A `clock` (_BuildClock) times each build.

    index_cache: a SINGLE-unit run of one device parks its built index
    there so the overflow rerun (driver recursion) reuses it instead of
    re-sorting. Multi-unit runs never cache: extra shards held alive
    through the pass loop are what the plan did not budget for."""
    units = route.units(cfg, texts)
    account = {"units": len(units), "units_skipped": 0,
               "units_dispatched": 0, "reserved_bytes": route.reserved_bytes,
               "plans": route.plan_accounts(cfg, cand_cap)}
    meshes = route.meshes()
    if meshes is not None:
        gathers0 = (sum(m.gather_s for m in meshes),
                    sum(m.gathers for m in meshes))
    exchange = route.exchange

    def build(u: _Unit):
        spans.add("index.units_built", 1)
        spans.add("index.windows_built", u.windows)
        return u.build() if clock is None else clock.build(u)

    if exchange is not None:
        with prog.phase("index_build"):
            for i, u in enumerate(units[skip_units:], skip_units):
                if exchange.owns(i):
                    exchange.save(i, build(u))
    index_cache = {} if index_cache is None else index_cache
    inflight: List = []
    index = None
    for i, u in enumerate(units):
        if i < skip_units:
            account["units_skipped"] += 1
            continue
        while len(inflight) >= (1 if u.serial else 2):
            with spans.span("index.unit_wait"):
                _wait_events(cfg, inflight.pop(0), "index unit in flight")
        if u.serial:
            index = None
        if index_cache.get(u.key) is not None:
            index = index_cache[u.key]
        elif exchange is not None:
            with prog.phase("index_load"):
                index = exchange.load(i)
        else:
            with prog.phase("index_build"):
                index = build(u)
            if u.key is not None and len(units) == 1:
                index_cache[u.key] = index
        bbits = index.bucket_bits if u.bbits is None else u.bbits
        steps = _bsearch_steps_static(u.windows, cand_cap, bbits)
        prog.event(f"file {u.fi}: index {u.what} dispatched ({u.sizes}, "
                   f"bsearch={steps}, bbits={bbits})")
        with prog.phase("match"):
            handle = visit(u, index, steps)
        account["units_dispatched"] += 1
        if handle is not None:
            inflight.append(handle)
    if meshes is not None:
        account["mesh"] = route.mesh_account()
        prog.phase_s["mesh_gather"] = (prog.phase_s.get("mesh_gather", 0.0)
                                       + sum(m.gather_s for m in meshes)
                                       - gathers0[0])
        account["mesh_gathers"] = sum(m.gathers for m in meshes) - gathers0[1]
    return account


def _require(ok, what: str) -> None:
    if not bool(ok):
        raise AssertionError(what)


def validate_result(cfg: RealConfig, result: "MatchResult", texts) -> None:
    """Invariants of a finished matchUnique result (-debug 1); raises
    AssertionError on the first one broken."""
    st = result.st
    _require(((st >= 0) & (st <= 4)).all(), "state out of range")
    matched = (st == 1) | (st == 2)
    _require((result.errs[matched] <= cfg.totalkmax).all(),
             "matched read exceeds totalkmax")
    _require((result.pos[matched] >= 0).all(), "negative match position")
    for fi in np.unique(result.fileid[matched]):
        sel = matched & (result.fileid == fi)
        _require((result.pos[sel] < texts[int(fi)].packed.n).all(),
                 "position beyond text")
    if cfg.scores:
        _require(np.isfinite(result.score[matched]).all(),
                 "non-finite score on matched read")


def validate_hits(cfg: RealConfig, cols) -> None:
    """Invariants of finished matchAll hit columns (-debug 1)."""
    _pid, k, pos, _fid, _frag, score, _inv = cols
    _require((k <= cfg.totalkmax).all(), "hit exceeds totalkmax")
    _require((pos >= 0).all(), "negative hit position")
    if cfg.scores:
        _require(np.isfinite(score).all(), "non-finite hit score")


def _mesh_of(cfg: RealConfig,
             mesh_plan: Optional[MeshPlan]) -> Optional[mesh_mod.Mesh]:
    """The run's Mesh, or None for a run of one device; use_mesh without
    a layout raises (a run of one rank's slice on one device would print
    a part of the records as if it were all of them)."""
    if mesh_plan is None and cfg.use_mesh:
        raise RuntimeError("use_mesh: pass the run's layout from "
                           "driver.plan_mesh (every rank of the job calls "
                           "it) as mesh_plan")
    return mesh_plan.mesh if mesh_plan is not None else None


def _make_exchange(cfg: RealConfig, depth: int, dev: torch.device):
    """A BuildExchange when -exchange <dir> is set in a multi-process run
    (torch.distributed initialized, more than one rank); top-level pass
    only: overflow reruns build their small shards locally."""
    if not cfg.build_exchange_dir or depth:
        return None
    topo = multihost.current_topology()
    if topo.process_count <= 1:
        return None
    return multihost.BuildExchange(cfg.build_exchange_dir, topo, dev)


def _route(cfg: RealConfig, rs: reads_io.ReadSet, texts: List[TextFile],
           dev: torch.device, mesh_plan: Optional[MeshPlan], patid_filter,
           depth: int, survivor_cap: int, prog: _Progress):
    """The run's route, its batch source (the `setup` phase) and its
    devices: the rank mesh of mesh_plan, else an in-process mesh over
    local_mesh_cells, else one device (under -exchange with a
    BuildExchange)."""
    mesh = _mesh_of(cfg, mesh_plan)
    cells = local_mesh_cells(cfg, dev) if mesh is None else None
    with prog.phase("setup"):
        source = _make_source(cfg, rs, patid_filter, depth, dev, cells)
    if mesh is not None:
        route = mesh_plan
    elif cells is not None:
        route = _local_layout(cfg, texts, cells, source, rs.num_reads,
                              survivor_cap)
    else:
        route = _seq_layout(cfg, texts, dev, source, survivor_cap,
                            reads=rs.num_reads,
                            exchange=_make_exchange(cfg, depth, dev))
    return route, source, cells or [dev]


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


@spans.traced("allhits.sort")
def _sort_dedup_hits(cols: tuple, use_native: bool = True) -> tuple:
    """Sort hit columns (pid, k, pos, fileid, frag, score, inv) by all
    seven keys in that order and drop identical neighbours
    (real_tpu/engine/driver.py _sort_dedup_hits). Each call is a span
    `allhits.sort` of the job.

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
            self.event.record(torch.cuda.current_stream(flat.device))
        else:
            self.host = flat

    def numpy(self, watchdog_s: float = 0) -> CompactHits:
        """The step's CompactHits as numpy arrays (waits for the copy,
        under the watchdog, in a span `allhits.wait`)."""
        with spans.span("allhits.wait"):
            if self.event is not None:
                with watchdog(watchdog_s, "matchAll hit drain"):
                    self.event.synchronize()
        a, h = self.host.numpy(), self.h
        return CompactHits(pos=a[:h], m1=a[h:2 * h], m2=a[2 * h:3 * h],
                           score=a[3 * h:4 * h].view(np.float32),
                           count=int(a[4 * h]),
                           overflow=a[4 * h + 1:].astype(bool))


# steps whose hits may be on their way to the host at once (real_tpu keeps
# the same depth of pending fetches)
_PENDING_MAX = 8


# ---------------------------------------------------------------------------
# the job: one skeleton over a route, in one of two modes
# ---------------------------------------------------------------------------

_STATE_FIELDS = MatchState._fields


class _UniqueMode:
    """matchUnique's part of the job: each batch's per-read states and
    overflow flags, in one chunk per dp row on the row's home device (one
    chunk on the run's device for a run of one device, one per row of the
    current text's mesh for an in-process mesh: begin_unit moves them when
    a text's mesh has other rows), folded step by step and collected into
    a MatchResult; a rerun's reads overwrite theirs."""
    checkpoint, tag, caps = ckpt_mod.Checkpoint, "", "candidate"

    def __init__(self, cfg: RealConfig, numpat: int):
        # the result's host arrays are made before the setup's host
        # buffers come and go: made after them, they leave the host
        # allocator in another state, which moved a fly.u.4m job's drain
        # by +10-40 ms and its rerun's collect by -10 ms (H100 runs)
        self.cfg = cfg
        self.result = MatchResult(
            *(np.zeros(numpat, np.int32) for _ in range(5)),
            np.full(numpat, -np.finfo(np.float32).max, np.float32))

    def place(self, plans, home: torch.device) -> None:
        """Every batch's initial state and overflow flags on `home`."""
        self.plans, self.homes = plans, [home]
        self.state = {bi: [initial_state(p.rows, home)]
                      for bi, p in enumerate(plans)}
        self.over = {bi: [torch.zeros(p.rows, dtype=torch.bool, device=home)]
                     for bi, p in enumerate(plans)}

    def _split(self, bi: int, full: MatchState, over: torch.Tensor) -> None:
        n = len(self.homes)
        r = self.plans[bi].rows // n
        self.state[bi] = [MatchState(*(t[d * r:(d + 1) * r].to(h)
                                       for t in full))
                          for d, h in enumerate(self.homes)]
        self.over[bi] = [over[d * r:(d + 1) * r].to(h)
                         for d, h in enumerate(self.homes)]

    def resume(self, data: dict) -> None:
        """A checkpoint's whole-batch states and overflow flags."""
        for bi in range(len(self.plans)):
            self._split(bi, MatchState(**{
                f: torch.from_numpy(data["states"][bi][f])
                for f in _STATE_FIELDS}),
                torch.from_numpy(data["overflow"][bi]))

    def begin_unit(self, homes: List[torch.device]) -> None:
        """Re-chunk every batch over the rows of `homes` (stream-ordered
        copies between devices; nothing moves when the rows are the
        same)."""
        if list(homes) == self.homes:
            return
        h0 = homes[0]
        full = {bi: (MatchState(*(torch.cat([c[i].to(h0) for c in chunks])
                                  for i in range(len(_STATE_FIELDS)))),
                     torch.cat([o.to(h0) for o in self.over[bi]]))
                for bi, chunks in self.state.items()}
        self.homes = list(homes)
        for bi, (st, over) in full.items():
            self._split(bi, st, over)

    def _fetch(self, what: str) -> List[list]:
        """Every batch's state fields and overflow flags as numpy arrays,
        the rows concatenated; the queued device work completes inside
        this fetch."""
        with watchdog(self.cfg.watchdog_s, what):
            return [[np.concatenate([c[i].cpu().numpy() for c in chunks])
                     for i in range(len(_STATE_FIELDS))]
                    + [np.concatenate([o.cpu().numpy()
                                       for o in self.over[bi]])]
                    for bi, chunks in self.state.items()]

    def save(self, ck, units_done: int) -> None:
        host = self._fetch("checkpoint state fetch")
        ck.save(units_done, [dict(zip(_STATE_FIELDS, h[:-1])) for h in host],
                [h[-1] for h in host])

    def row(self, step, bi: int, d: int, patids, fi: int, eps, kw) -> None:
        state, out = step(self.state[bi][d], fi, eps, **kw)
        self.state[bi][d] = state
        if isinstance(out, Survivors):        # one device: match_step's
            # -debug 1: a NaN score on a valid lane raises at the step that
            # made it (one device sync per step, like jax_debug_nans)
            if self.cfg.debug_checks and self.cfg.scores and bool(
                    (out.valid & torch.isnan(out.score)).any()):
                raise FloatingPointError(
                    f"NaN score on a valid lane in file {fi}, batch {bi}")
            out = out.overflow
        self.over[bi][d] |= out

    def end_batch(self, n_rows: int) -> None:
        pass

    def finish(self, prog: _Progress):
        """The result and the overflowing reads."""
        # the match loop only dispatches; its device work completes here
        with prog.phase("drain"):
            host = self._fetch("matchUnique result drain")
        result = self.result
        overflow = np.zeros(len(result.st), bool)
        with prog.phase("collect"):
            for p, (*fields, over) in zip(self.plans, host):
                n = len(p.patids)
                for f, a in zip(_STATE_FIELDS, fields):
                    getattr(result, f)[p.patids] = a[:n]
                overflow[p.patids[over[:n]]] = True
        return result, np.flatnonzero(overflow)

    def rerun(self, result: MatchResult, over_ids: np.ndarray, *args, **kw):
        sub = run_match_unique(*args, **kw)
        for f in _STATE_FIELDS:
            getattr(result, f)[over_ids] = getattr(sub, f)[over_ids]
        return result, sub

    def validate(self, result: MatchResult, texts) -> None:
        validate_result(self.cfg, result, texts)


class _AllMode:
    """matchAll's part of the job: hit columns decoded step by step from the
    compacted prefixes, sorted and deduped once at the end
    (matchAllImplementation.cpp:99-161 unifyMatches semantics). Each
    step's hits start for the host right after its dispatch (_HitFetch)
    and are decoded once _PENDING_MAX newer steps of rows are queued, so
    the copies overlap device work and device memory stays bounded. A
    rerun's hits replace its reads' first-pass hits."""
    checkpoint, tag, caps = ckpt_mod.AllCheckpoint, "all-", "matchAll"

    def __init__(self, cfg: RealConfig, numpat: int):
        self.cfg, self.numpat = cfg, numpat

    def place(self, plans, home: torch.device) -> None:
        self.overflow = np.zeros(self.numpat, bool)
        self.pending: List[tuple] = []
        self.cols: List[Tuple[np.ndarray, ...]] = []
        # steps whose TOTAL hit count exceeded the device buffer H: the
        # whole batch is rerun (compact_hits)
        self.batch_overflow_steps = 0

    def drain(self, to_len: int) -> None:
        while len(self.pending) > to_len:
            fetch, patids, fi = self.pending.pop(0)
            self.add_compact(fetch.numpy(self.cfg.watchdog_s), patids, fi,
                             len(patids))

    @spans.traced("allhits.decode")
    def add_compact(self, ch: CompactHits, patids: np.ndarray, fi: int,
                    n: int) -> None:
        """Decode one step's CompactHits (numpy) for its n real reads (a
        span `allhits.decode`; the rows decoded add to the job's counter
        `allhits.decoded`)."""
        self.overflow[patids[ch.overflow[:n]]] = True
        h = len(ch.pos)
        self.batch_overflow_steps += int(ch.count > h)
        c = min(ch.count, h)
        rows = ch.m1[:c] >> 4
        keep = rows < n            # padded rows never produce hits
        rows = rows[keep]
        spans.add("allhits.decoded", rows.size)
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

    def compact(self) -> tuple:
        """The accumulated columns concatenated in place (no sort, no
        dedup): the checkpoint's payload; the state stays equivalent."""
        if not self.cols:
            return tuple(np.zeros(0, dt) for dt in HIT_DTYPES)
        cols = tuple(np.concatenate([c[i] for c in self.cols])
                     for i in range(7))
        self.cols = [cols]
        return cols

    def resume(self, data: dict) -> None:
        """Hits of completed units are independent of later units (shards
        are disjoint window ranges)."""
        self.overflow |= data["overflow"]
        self.cols.append(data["cols"])

    def save(self, ck, units_done: int) -> None:
        self.drain(0)
        ck.save(units_done, self.overflow, self.compact())

    def begin_unit(self, homes) -> None:
        pass

    def row(self, step, bi: int, d: int, patids, fi: int, eps, kw) -> None:
        _, ch = step(None, fi, eps, matchall=True, **kw)
        if self.cfg.debug_checks and self.cfg.scores:
            if bool(torch.isnan(ch.score[:int(ch.count)]).any()):
                raise FloatingPointError(
                    f"NaN score on a hit in file {fi}, batch {bi}")
        self.pending.append((_HitFetch(ch), patids, fi))

    def end_batch(self, n_rows: int) -> None:
        self.drain(_PENDING_MAX * n_rows)

    def finish(self, prog: _Progress):
        with prog.phase("drain"):
            self.drain(0)
        with prog.phase("finalize"):       # sorted + deduped
            cols = self.compact()
            if self.cols:
                cols = _sort_dedup_hits(cols, self.cfg.native_host)
        return (MatchAllResult(*cols, metrics={
            "batch_hit_overflow_steps": self.batch_overflow_steps}),
            np.flatnonzero(self.overflow))

    def rerun(self, result: MatchAllResult, over_ids: np.ndarray, *args,
              **kw):
        sub = run_match_all(*args, as_arrays=True, **kw)
        keep = ~np.isin(result.pid, over_ids)
        return MatchAllResult(*_sort_dedup_hits(tuple(
            np.concatenate([a[keep], b])
            for a, b in zip(result.cols, sub.cols)), self.cfg.native_host),
            metrics=result.metrics), sub

    def validate(self, result: MatchAllResult, texts) -> None:
        validate_hits(self.cfg, result.cols)


def _run(mode_cls, cfg: RealConfig, rs: reads_io.ReadSet,
         texts: List[TextFile], device, patid_filter, cand_cap,
         survivor_cap, mesh_plan, depth: int, index_cache):
    """The job of a mode (_UniqueMode, _AllMode) on any route: setup and
    the route (_route), the checkpoint's open and resume, the unit loop,
    the drain, the builds' device seconds (the job's counter
    `index.build_device_s`, at a rerun's depths
    `rerun.index.build_device_s`), the result, the rerun of overflowing
    reads with 16x caps, the phase timers, the checkpoint's delete, the
    -debug validation."""
    dev = _check_run(cfg, texts, device)
    index_cache = {} if index_cache is None else index_cache
    cand_cap = cand_cap or cfg.cand_cap
    survivor_cap = survivor_cap or cfg.survivor_cap
    step_kw = _step_kwargs(cfg, cand_cap, survivor_cap)
    mode = mode_cls(cfg, rs.num_reads)
    prog = _Progress(cfg.verbose)
    route, source, devices = _route(cfg, rs, texts, dev, mesh_plan,
                                    patid_filter, depth, survivor_cap, prog)
    mode.place(source.plans, devices[0])

    # checkpoint/resume: the mode's state + completed-unit cursor; only
    # the top-level pass checkpoints (escalation reruns are cheap
    # re-derivations)
    ck = None
    skip_units = 0
    unit_done = [0]
    if cfg.checkpoint and depth == 0 and patid_filter is None:
        ck = mode.checkpoint(
            cfg.checkpoint, mode.tag + route.tag()
            + ckpt_mod.fingerprint(cfg, texts, rs.num_reads,
                                   len(source.plans), cand_cap,
                                   survivor_cap))
        data = ck.load()
        if not route.agree_resume(data["units_done"] if data else 0):
            data = None
        if data:
            skip_units = unit_done[0] = data["units_done"]
            mode.resume(data)
            prog.event(f"resumed from checkpoint: {skip_units} units done")

    def checkpoint_unit():
        unit_done[0] += 1
        if ck is None or unit_done[0] % max(cfg.checkpoint_every, 1):
            return
        mode.save(ck, unit_done[0])
        prog.event(f"checkpoint saved ({unit_done[0]} units)")

    win = _DispatchWindow(cfg, devices, enabled=not source.resident)

    def visit(u: _Unit, index, steps: int):
        mode.begin_unit(u.homes or [dev])
        kw = dict(step_kw, bsearch_steps=steps, text_has_n=u.text.has_n)
        for bi, rows in enumerate(u.rows(source, index)):
            eps = np.float32(cfg.filter_value(source.plans[bi].patl))
            for d, (patids, step) in enumerate(rows):
                mode.row(step, bi, d, patids, u.fi, eps, kw)
            mode.end_batch(len(rows))
            win.push()
        checkpoint_unit()
        return _record_events(u.devices or [dev])

    clock = _BuildClock(dev)
    account = _foreach_unit(cfg, route, texts, cand_cap, visit, prog,
                            skip_units=skip_units, index_cache=index_cache,
                            clock=clock)
    result, over_ids = mode.finish(prog)
    if clock.builds:
        spans.add("rerun.index.build_device_s" if depth
                  else "index.build_device_s", clock.seconds())
    result.metrics = {"phase_s": dict(prog.phase_s),
                      "overflow_rerun_reads": int(len(over_ids)),
                      **result.metrics, **account,
                      "source_resident": source.resident,
                      "resident_read_bytes": source.resident_device_bytes,
                      "streamed_batches": source.streamed_batches}
    phase_s = result.metrics["phase_s"]
    if len(over_ids):
        if depth >= 4:
            raise RuntimeError(
                f"{len(over_ids)} reads overflow {mode.caps} caps even at "
                f"cand_cap={cand_cap}")
        print(f"rerunning {len(over_ids)} overflowing reads with "
              f"cand_cap={cand_cap * 16}", file=sys.stderr)
        result, sub = mode.rerun(
            result, over_ids, cfg, rs, texts, device=dev,
            patid_filter=over_ids, cand_cap=cand_cap * 16,
            survivor_cap=survivor_cap * 16, mesh_plan=mesh_plan,
            _depth=depth + 1, _index_cache=index_cache)
        for k, v in sub.metrics["phase_s"].items():
            phase_s[f"rerun.{k}"] = phase_s.get(f"rerun.{k}", 0.0) + v
    if cfg.verbose:
        print("phase timers: " + " ".join(
            f"{k}={v:.2f}s" for k, v in sorted(phase_s.items())),
            file=sys.stderr)
    if ck is not None:
        ck.delete()
    if cfg.debug_checks and depth == 0:
        mode.validate(result, texts)
    return result


@spans.traced("driver")
def run_match_unique(cfg: RealConfig, rs: reads_io.ReadSet,
                     texts: List[TextFile], device="cuda",
                     patid_filter: Optional[np.ndarray] = None,
                     cand_cap: Optional[int] = None,
                     survivor_cap: Optional[int] = None,
                     mesh_plan: Optional[MeshPlan] = None,
                     _depth: int = 0,
                     _index_cache: Optional[Dict] = None) -> MatchResult:
    """matchUnique over all texts; `texts` must live on `device`. In a
    rank mesh run (cfg.use_mesh) `rs` is this rank's row slice and
    mesh_plan its layout (plan_mesh); an in-process mesh run
    (local_mesh_cells) matches all of `rs` on its cells. The per-step
    -debug scan is the one-device path's, a mesh run checks the finished
    result."""
    return _run(_UniqueMode, cfg, rs, texts, device, patid_filter, cand_cap,
                survivor_cap, mesh_plan, _depth, _index_cache)


@spans.traced("driver")
def run_match_all(cfg: RealConfig, rs: reads_io.ReadSet,
                  texts: List[TextFile], device="cuda",
                  patid_filter: Optional[np.ndarray] = None,
                  cand_cap: Optional[int] = None,
                  survivor_cap: Optional[int] = None,
                  as_arrays: bool = False,
                  mesh_plan: Optional[MeshPlan] = None,
                  _depth: int = 0,
                  _index_cache: Optional[Dict] = None):
    """Every qualifying hit per read; `texts` must live on `device`.

    Returns {patid: [(k, pos, fileid, frag, score, inverted), ...]} sorted
    and deduped in the reference's order — or, with as_arrays=True, the
    same records as a MatchAllResult of columns with the run's metrics
    (no per-hit Python objects; cli.output.write_all_arrays prints it).

    Reads that overflow a cap, or whose batch overflows the hit buffer,
    are rerun with 16x caps (_AllMode). A mesh run takes `rs` and
    `mesh_plan` as run_match_unique does; every rank of a row holds the
    row's hits. An in-process mesh decodes one CompactHits per dp row of
    each step, its row ids local to the row (real_tpu's enqueue)."""
    result = _run(_AllMode, cfg, rs, texts, device, patid_filter, cand_cap,
                  survivor_cap, mesh_plan, _depth, _index_cache)
    return result if as_arrays else result.by_read()
