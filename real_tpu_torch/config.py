"""Run configuration, mirroring the reference CLI semantics.

Reference: RealOptions.{hpp,cpp}. Defaults RealOptions.hpp:27-38; clamps and
filter_mult derivation RealOptions.cpp:434-463.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import List, Optional


@dataclasses.dataclass
class RealConfig:
    textfilename: str = ""
    patternfilename: str = ""
    outputfilename: str = ""
    seedkmax: int = 2            # -s, max mismatches in seed (hard cap 2)
    totalkmax: int = 5           # -e, max total mismatches (cap 15)
    seedl: int = 32              # -l, seed length (<=64, multiple of 4)
    match_unique: bool = True    # -u 1 unique-best / -u 0 all hits
    fracmem: float = 0.75        # -f, fraction of the device's memory that
                                 # the shard planner may fill
    scores: bool = True          # -q, quality/odds-ratio scoring
    quality_offset: int = 0      # -Q, 0 = autodetect
    rewritepatterns: bool = True # -R, cached packed read store
    sort_threads: int = 2        # -m (unused; kept for CLI parity)
    filter_level: int = 2        # -filter_level 0..4
    gaps: bool = False           # -g (experimental, disabled in reference too)

    # scoring parameters (Scoring.cpp:204-208 defaults)
    similarity: float = 0.995
    err: float = 0.0
    trans: float = 0.71
    gc: float = 0.41
    gcmut_bias: float = 2.0

    fastq: bool = False          # sniffed from the pattern file

    # --- engine knobs (no reference equivalent) ---
    batch_size: int = 32768      # reads per device batch
    # Candidate/survivor caps size the fixed-shape verify lanes; reads
    # that overflow are rerun with 16x caps (engine/driver.py), which
    # keeps the result exact.
    cand_cap: int = 8            # max candidates examined per (read, probe)
    survivor_cap: int = 8        # max verified hits folded per read per step
    # keep packed reads device-resident across shard passes up to this
    # many bytes (0 = a share of the device's memory, engine/driver.py
    # _make_source); above it the streaming source (io/pipeline.py)
    # re-uploads the reads for every index shard
    resident_reads_bytes: int = 0
    index_shards: int = 0        # -shards: 0 = plan from the -f memory
                                 # budget (parallel/plan.py); shards run as
                                 # sequential passes over all reads
    checkpoint: str = ""         # -ckpt <path>: save (state or hits, unit
                                 # cursor) after completed index units and
                                 # resume from it
    checkpoint_every: int = 1    # -ckpt_every: units between saves (a save
                                 # fetches the per-batch state to the host)
    debug_checks: bool = False   # -debug 1: scan every step's scores for
                                 # NaN (a device sync per step) and check
                                 # the finished result's invariants
    verbose: bool = False        # -v: stderr progress + phase timers
    watchdog_s: int = 900        # -watchdog <s>: abort loudly if one
                                 # blocking device fetch exceeds this many
                                 # seconds (utils/watchdog.py); 0 disables
    trace: str = ""              # -trace <dir>: torch.profiler trace of
                                 # the whole job (cli/main.py)
    metrics_json: str = ""       # -metrics <path>: the run's metrics as
                                 # JSON (phase seconds, counts, reads/s)
    build_exchange_dir: str = "" # -exchange <dir>: in a multi-process run
                                 # each rank builds the index shards it
                                 # owns and loads the others' from this
                                 # shared directory (parallel/multihost.py)
    # index shards over a dp x shard grid (parallel/mesh.py). None (the
    # default, real_tpu's "more than one local device" of each process):
    # the in-process mesh of the cells in mesh_devices, else, when
    # `device` is the unqualified "cuda", of every card the process sees
    # (more than one), or in a job of several ranks of the rank's own
    # cards (parallel/multihost.py rank_cells, when more than one); else
    # one device. True: the rank mesh of a multi-process job (the
    # runner's -mesh; without a process group it raises). False: one
    # device.
    use_mesh: Optional[bool] = None
    # the in-process mesh's cells, one device string each ("cuda:0",
    # "cpu"; a device may hold several cells); no CLI flag. Under a
    # process group of several ranks it names THIS rank's cells. The
    # port's counterpart of the forced host-device count of real_tpu's
    # tests (per process in tests/multihost_worker.py): ["cpu"] * 8 runs
    # 8 CPU cells, ["cuda:0"] * 4 four cells on one card.
    mesh_devices: Optional[List[str]] = None
    device: str = "cuda"         # -device cuda|cpu
    # -native 0: the host phases (parsing, row packing, hit sort, record
    # formatting) take their plain NumPy versions, not native/readpack.cpp
    native_host: bool = True

    filter_mult: float = dataclasses.field(init=False, default=0.0)

    def __post_init__(self) -> None:
        self.validate()

    def validate(self) -> None:
        """Apply the reference's clamping rules (RealOptions.cpp:434-463)."""
        if self.seedl > 64:
            self.seedl = 64
            print(f"reduced seed size to {self.seedl} to not exceed 64.",
                  file=sys.stderr)
        if self.seedl % 4:
            self.seedl -= self.seedl % 4
            print(f"reduced seed size to {self.seedl} to have a multiple of 4.",
                  file=sys.stderr)
        if self.seedl < 4:
            raise ValueError("cannot handle seed length < 4")
        if self.mesh_devices and self.use_mesh is not None:
            raise ValueError("mesh_devices names the cells of the "
                             "in-process mesh, which use_mesh=None selects")
        if self.use_mesh and self.build_exchange_dir:
            # real_tpu ignores the exchange on its mesh path; the port
            # raises where real_tpu falls back
            raise ValueError("-mesh and -exchange exclude each other: a "
                             "mesh rank builds only its own shard")
        if self.seedkmax > 2:
            self.seedkmax = 2
            print(f"reduced number of mismatches in seed to {self.seedkmax} "
                  "as we cannot handle more.", file=sys.stderr)
        if self.totalkmax > 15:
            # reference clamps to the 4-bit error field with a warning
            # (RealOptions.cpp:176-180, UniqueMatchInfo.hpp:58-61)
            self.totalkmax = 15
            print("Warning: reducing maximum amount of errors to 15",
                  file=sys.stderr)
        # filter_mult (RealOptions.cpp:455-463)
        mult = {1: 0.5, 2: 1.0, 3: 2.0, 4: 3.0}.get(self.filter_level, 0.0)
        self.filter_mult = mult * self.totalkmax / 70.0

    def filter_value(self, patl: int) -> float:
        """Epsilon for score-tie detection (RealOptions.hpp:74-77)."""
        return self.filter_mult * patl
