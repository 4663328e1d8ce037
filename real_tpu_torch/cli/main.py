"""`real`-compatible command line interface of the PyTorch/CUDA port.

Flags mirror real_tpu's CLI (RealOptions.cpp:142-396), plus -device:

  python -m real_tpu_torch.cli.main -t <text.fa|dir> -p <reads> -o <out|->
           [-s k_seed] [-e k_total] [-l seedl] [-u 0|1] [-q 0|1]
           [-Q offset] [-f fracmem] [-T threads] [-m sortthreads] [-R 0|1]
           [-g 0|1] [-similarity x] [-err x] [-trans x] [-gc x]
           [-gcmut_bias x] [-filter_level 0..4] [-v 0|1]
           [-B batch] [-K cand_cap] [-S survivor_cap] [-device cuda|cpu]

This slice runs matchUnique (-u 1) with seeds up to 32 bases on one device
and one index shard. -u 0, -shards N>1, -l over 32, -ckpt, -trace,
-metrics, -exchange and -debug 1 raise NotImplementedError.
"""

from __future__ import annotations

import sys
from typing import List, Optional

from real_tpu_torch.config import RealConfig


def parse_args(argv: List[str]) -> RealConfig:
    cfg = RealConfig()
    i = 0
    flags_with_arg = {
        "-t": ("textfilename", str), "-p": ("patternfilename", str),
        "-o": ("outputfilename", str), "-s": ("seedkmax", int),
        "-e": ("totalkmax", int), "-l": ("seedl", int),
        "-f": ("fracmem", float), "-Q": ("quality_offset", int),
        "-m": ("sort_threads", int),
        "-similarity": ("similarity", float), "-err": ("err", float),
        "-trans": ("trans", float), "-gc": ("gc", float),
        "-gcmut_bias": ("gcmut_bias", float),
        "-filter_level": ("filter_level", int),
        # engine knobs
        "-B": ("batch_size", int), "-K": ("cand_cap", int),
        "-S": ("survivor_cap", int), "-shards": ("index_shards", int),
        "-ckpt": ("checkpoint", str), "-ckpt_every": ("checkpoint_every",
                                                      int),
        "-trace": ("trace", str), "-metrics": ("metrics_json", str),
        "-watchdog": ("watchdog_s", int),
        "-exchange": ("build_exchange_dir", str),
        "-device": ("device", str),
    }
    bool_flags = {"-u": "match_unique", "-q": "scores",
                  "-R": "rewritepatterns", "-g": "gaps", "-v": "verbose",
                  "-debug": "debug_checks"}
    while i < len(argv):
        a = argv[i]
        if a in flags_with_arg:
            attr, typ = flags_with_arg[a]
            setattr(cfg, attr, typ(argv[i + 1]))
            i += 2
        elif a in bool_flags:
            setattr(cfg, bool_flags[a], bool(int(argv[i + 1])))
            i += 2
        elif a == "-T":
            i += 2   # thread count: no-op, kept for CLI parity
        elif a in ("-h", "--help"):
            print(__doc__, file=sys.stderr)
            sys.exit(0)
        else:
            print(f"Ignoring argument {a}", file=sys.stderr)
            i += 1
    if not (cfg.textfilename and cfg.patternfilename and cfg.outputfilename):
        print(__doc__, file=sys.stderr)
        raise SystemExit("Mandatory arguments -t/-p/-o missing")
    cfg.validate()
    _check_supported(cfg)
    return cfg


def _check_supported(cfg: RealConfig) -> None:
    """Raise for the options this slice of the port does not run yet."""
    missing = []
    if not cfg.match_unique:
        missing.append("-u 0 (matchAll)")
    if cfg.index_shards > 1:
        missing.append("-shards N>1 (index sharding)")
    if cfg.seedl > 32:
        missing.append("-l over 32 (wide seeds)")
    if cfg.checkpoint:
        missing.append("-ckpt (checkpoint/resume)")
    if cfg.trace:
        missing.append("-trace (profiler trace)")
    if cfg.metrics_json:
        missing.append("-metrics (run metrics file)")
    if cfg.build_exchange_dir:
        missing.append("-exchange (multi-process build)")
    if cfg.debug_checks:
        missing.append("-debug 1 (invariant checks)")
    if missing:
        raise NotImplementedError(
            "not ported to real_tpu_torch yet: " + ", ".join(missing))


def main(argv: Optional[List[str]] = None) -> int:
    from real_tpu_torch.cli.output import write_unique
    from real_tpu_torch.engine import driver
    from real_tpu_torch.io import reads as reads_io

    cfg = parse_args(sys.argv[1:] if argv is None else argv)
    device = driver.resolve_device(cfg.device)
    rs = reads_io.parse_reads(cfg.patternfilename, cfg.quality_offset)
    cfg.fastq = rs.fastq
    print(f"pattern file is {'FASTQ' if rs.fastq else 'FASTA'}",
          file=sys.stderr)
    texts = driver.load_texts(cfg, device)
    if cfg.gaps:
        # the reference ships gapped matching compiled out (real.cpp:23)
        print("Warning: gapped matching (-g) is experimental and disabled "
              "in the reference (real.cpp:23); ignoring it.",
              file=sys.stderr)
    result = driver.run_match_unique(cfg, rs, texts, device)
    if cfg.outputfilename == "-":
        unique = write_unique(sys.stdout, rs, result, texts, cfg.scores)
    else:
        with open(cfg.outputfilename, "w") as out:
            unique = write_unique(out, rs, result, texts, cfg.scores)
    print(f"unique: {unique}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
