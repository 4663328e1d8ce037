"""Run configuration, mirroring the reference CLI semantics.

Reference: RealOptions.{hpp,cpp}. Defaults RealOptions.hpp:27-38; clamps and
filter_mult derivation RealOptions.cpp:434-463.
"""

from __future__ import annotations

import dataclasses
import sys


@dataclasses.dataclass
class RealConfig:
    textfilename: str = ""
    patternfilename: str = ""
    outputfilename: str = ""
    seedkmax: int = 2            # -s, max mismatches in seed (hard cap 2)
    totalkmax: int = 5           # -e, max total mismatches (cap 15)
    seedl: int = 32              # -l, seed length (<=64, multiple of 4)
    match_unique: bool = True    # -u 1 unique-best / -u 0 all hits
    fracmem: float = 0.75        # -f, fraction of memory budget
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
    # Flags the CLI parses for parity with real_tpu's; this port raises
    # NotImplementedError for the ones it does not run yet (cli/main.py).
    index_shards: int = 0        # index shards (0 = plan; only 1 is run)
    checkpoint: str = ""         # -ckpt <path>
    checkpoint_every: int = 1
    trace: str = ""              # -trace <dir>
    metrics_json: str = ""       # -metrics <path>
    debug_checks: bool = False   # -debug 1
    verbose: bool = False        # -v: stderr progress + phase timers
    build_exchange_dir: str = "" # -exchange <dir>
    watchdog_s: int = 900        # -watchdog <s>
    device: str = "cuda"         # -device cuda|cpu

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
