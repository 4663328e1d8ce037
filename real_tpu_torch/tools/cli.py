"""Command-line entry points of the helper tools (counterpart of
real_tpu/tools/cli.py; the reference's genpat.cpp, randstr.cpp,
reorderPat.cpp, printScores.cpp). Their output is byte-equal to
real_tpu's for the same arguments.

  real-tpu-torch-randstr <length> [seed]
  real-tpu-torch-genpat <text.fa> <numpat> <patlen> <errprob> <1|0> [seed]
  real-tpu-torch-reorder <reads file>
  real-tpu-torch-print-scores
"""

from __future__ import annotations

import sys

import numpy as np


def randstr_main(argv=None) -> int:
    """random ACGT FASTA: randstr <length> [seed] (randstr.cpp)."""
    args = sys.argv[1:] if argv is None else argv
    if not args:
        print("usage: real-tpu-torch-randstr <length> [seed]",
              file=sys.stderr)
        return 1
    from real_tpu_torch.tools.simulate import random_genome
    n = int(args[0])
    seed = int(args[1]) if len(args) > 1 else 0
    sys.stdout.write(random_genome(n, seed=seed, name=f"random_{n}"))
    return 0


def genpat_main(argv=None) -> int:
    """read simulator: genpat <text.fa> <numpat> <patlen> <errprob>
    <1|0[FASTQ|FASTA]> [seed] (genpat.cpp:64-166)."""
    args = sys.argv[1:] if argv is None else argv
    if len(args) < 5:
        print("usage: real-tpu-torch-genpat <filename> <numpat> <patlen> "
              "<errprob> <1|0[FASTQ|FASTA]> [seed]", file=sys.stderr)
        return 1
    from real_tpu_torch.io import fasta
    from real_tpu_torch.tools.simulate import generate_reads
    codes, _ = fasta.parse_genome(args[0])
    fastq = bool(int(args[4]))
    seed = int(args[5]) if len(args) > 5 else 1
    for r in generate_reads(codes, int(args[1]), int(args[2]),
                            float(args[3]), fastq, seed=seed):
        if fastq:
            sys.stdout.write(f"@{r.name}\n{r.seq}\n+\n{r.qual}\n")
        else:
            sys.stdout.write(f">{r.name}\n{r.seq}\n")
    return 0


def reorder_main(argv=None) -> int:
    """read-store round trip: parse, store and decode every read
    (reorderPat.cpp's pack/unpack identity check)."""
    args = sys.argv[1:] if argv is None else argv
    if not args:
        print("usage: real-tpu-torch-reorder <reads file>", file=sys.stderr)
        return 1
    from real_tpu_torch.io.readstore import parse_reads_cached
    rs = parse_reads_cached(args[0])
    remap = np.frombuffer(b"ACGTN", np.uint8)
    for i in range(rs.num_reads):
        lo, hi = rs.offsets[i], rs.offsets[i + 1]
        seq = remap[rs.codes_flat[lo:hi]].tobytes().decode()
        sys.stdout.write(f"{rs.ids[i]}\t{seq}")
        if rs.quals_flat is not None:
            sys.stdout.write("\t" + " ".join(
                str(int(x)) for x in rs.quals_flat[lo:hi]))
        sys.stdout.write("\n")
    return 0


def print_scores_main(argv=None) -> int:
    """dump the 4x4x64 scoring table (printScores.cpp via
    Scoring::operator<<, Scoring.cpp:182-202 — same format)."""
    from real_tpu_torch.scoring.scoring import Scoring
    sc = Scoring()
    out = sys.stdout
    out.write("Scoring(\n oddsRatio(\n")
    for i in range(4):
        out.write("  " + "\t".join(f"{sc.odds_ratio[i][j]:.6g}"
                                   for j in range(4)) + "\n")
    out.write(" )\n RawLogScoreTable(\n")
    remap = "ACGT"
    for i in range(4):
        for j in range(4):
            for q in range(63):
                out.write(f" refBase={remap[i]} readBase={remap[j]} "
                          f"quality={q} "
                          f"entry={sc.raw_log_score(i, j, q):.6g}\n")
    out.write(" )\n)\n")
    return 0
