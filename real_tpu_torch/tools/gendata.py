"""Chunked data generators for genome-scale runs (the port's copy of
benchmarks/gendata.py, over the port's own io.fasta).

tools/simulate.py is the correctness harness (truth encoded in every read
name, a Python loop per read: fine up to ~1M reads). These generators are
the scale harness: vectorized, fixed-width read ids, constant FASTQ
quality, written to disk in bounded chunks, so that a 3.1 Gbp genome and
millions of reads take minutes. At the same arguments they write the same
bytes as benchmarks/gendata.py. The read ids carry no truth; read_truth
replays the generator's random draws to recover it.

    python -m real_tpu_torch.tools.gendata DIR --genome-bp 3100000000 \\
        --fragments 24 --reads 2000000 --seed 55      # GRCH below

Everything here runs on the host.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Iterator, Tuple

import numpy as np

_REMAP = np.frombuffer(b"ACGTN", dtype=np.uint8)


@dataclasses.dataclass(frozen=True)
class ScaleConfig:
    """A genome-scale configuration (benchmarks/scale.py): the genome is
    made with `seed`, the reads with seed + 1."""
    name: str
    genome_n: int
    fragments: int
    numpat: int
    patl: int
    errprob: float
    totalkmax: int
    seed: int
    fastq: bool = False


# BASELINE.md row 5 (benchmarks/scale.py "grch"): a human-genome-sized
# file of 24 fragments, over 2^31 bases, so the driver splits it
GRCH = ScaleConfig("grch", 3_100_000_000, 24, 2_000_000, 100, 0.02, 5, 55)
# BASELINE.md row 4 (benchmarks/scale.py "fly"): Drosophila scale
FLY = ScaleConfig("fly", 140_000_000, 1, 50_000_000, 100, 0.02, 5, 44)


def write_random_genome(path: str, n: int, seed: int = 0,
                        name: str = "random", num_fragments: int = 1,
                        chunk: int = 60 * 2_000_000) -> None:
    """Random ACGT FASTA, 60 columns, written in bounded chunks; fragment
    f is named `<name>_<f>_<its length>`."""
    rng = np.random.default_rng(seed)
    per = n // num_fragments
    nl = np.uint8(ord("\n"))
    with open(path, "wb") as f:
        for frag in range(num_fragments):
            m = per if frag < num_fragments - 1 else \
                n - per * (num_fragments - 1)
            f.write(f">{name}_{frag}_{m}\n".encode())
            done = 0
            while done < m:
                c = min(chunk, m - done)
                # whole 60-character lines except at the fragment's end
                c -= c % 60 if done + c < m else 0
                seq = _REMAP[rng.integers(0, 4, c, dtype=np.uint8)]
                full = c // 60
                mat = np.empty((full, 61), np.uint8)
                mat[:, :60] = seq[:full * 60].reshape(full, 60)
                mat[:, 60] = nl
                blob = mat.tobytes()
                if c % 60:
                    blob += seq[full * 60:].tobytes() + b"\n"
                f.write(blob)
                done += c
    sys.stderr.write(f"genome {path}: {n} bp\n")


def _chunk_draws(rng, c: int, numpos: int, patl: int, errprob: float):
    """One chunk's random draws, in the order write_reads_fast makes them:
    start positions, strands, mutated bases, mutation deltas."""
    pos = rng.integers(0, numpos, c)
    inv = rng.integers(0, 2, c, dtype=np.uint8).astype(bool)
    mut = rng.random((c, patl)) <= errprob
    delta = rng.integers(1, 4, (c, patl), dtype=np.uint8)
    return pos, inv, mut, delta


def write_reads_fast(path: str, codes: np.ndarray, numpat: int, patl: int,
                     errprob: float, fastq: bool, seed: int = 1,
                     chunk: int = 250_000) -> None:
    """Reads at uniform start positions of `codes` (ACGT regions assumed),
    half of them reverse-complemented, each base mutated with probability
    errprob to one of the other three. Ids are 'r%09d', so every record
    has the same length and a chunk is one byte matrix."""
    rng = np.random.default_rng(seed)
    numpos = len(codes) - patl + 1
    idw = 10                   # 'r' + 9 digits
    nl = np.uint8(ord("\n"))
    with open(path, "wb") as f:
        for lo in range(0, numpat, chunk):
            c = min(chunk, numpat - lo)
            pos, inv, mut, delta = _chunk_draws(rng, c, numpos, patl,
                                                errprob)
            win = codes[pos[:, None] + np.arange(patl)]
            win = np.where(inv[:, None], 3 - win[:, ::-1],
                           win).astype(np.uint8)
            win = np.where(mut, (win + delta) & 3, win)
            seq = _REMAP[win]                       # [c, patl] bytes
            ids = np.frombuffer(
                b"".join(b"r%09d" % i for i in range(lo, lo + c)),
                np.uint8).reshape(c, idw)
            if fastq:
                # @id\nseq\n+\nqual\n with the constant quality '5'
                w = 1 + idw + 1 + patl + 1 + 2 + patl + 1
                mat = np.empty((c, w), np.uint8)
                mat[:, 0] = ord("@")
                mat[:, 1:1 + idw] = ids
                mat[:, 1 + idw] = nl
                s0 = 2 + idw
                mat[:, s0:s0 + patl] = seq
                mat[:, s0 + patl] = nl
                mat[:, s0 + patl + 1] = ord("+")
                mat[:, s0 + patl + 2] = nl
                q0 = s0 + patl + 3
                mat[:, q0:q0 + patl] = ord("5")
                mat[:, q0 + patl] = nl
            else:
                w = 1 + idw + 1 + patl + 1
                mat = np.empty((c, w), np.uint8)
                mat[:, 0] = ord(">")
                mat[:, 1:1 + idw] = ids
                mat[:, 1 + idw] = nl
                mat[:, 2 + idw:2 + idw + patl] = seq
                mat[:, -1] = nl
            f.write(mat.tobytes())
    sys.stderr.write(f"reads {path}: {numpat} x {patl}bp\n")


def read_truth(genome_n: int, numpat: int, patl: int, errprob: float,
               seed: int = 1, chunk: int = 250_000, seedl: int = 32
               ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray,
                                   np.ndarray]]:
    """The truth of write_reads_fast's reads over a genome of genome_n
    bases, chunk by chunk, from the same random draws and without the
    genome: (start int64, reverse bool, seed mismatches, mismatches) per
    read, in read order. `start` is the read's window in the concatenated
    text (a record's position for both strands); the mismatches are those
    among the read's first seedl bases (the seed of either strand) and
    among all of them."""
    rng = np.random.default_rng(seed)
    numpos = genome_n - patl + 1
    for lo in range(0, numpat, chunk):
        pos, inv, mut, _ = _chunk_draws(rng, min(chunk, numpat - lo),
                                        numpos, patl, errprob)
        yield (pos, inv, mut[:, :seedl].sum(axis=1, dtype=np.int32),
               mut.sum(axis=1, dtype=np.int32))


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="Write DIR/genome.fa and DIR/reads.fa (or reads.fq) "
                    "unless they exist; the reads are made with seed + 1.")
    ap.add_argument("outdir")
    ap.add_argument("--genome-bp", type=int, required=True)
    ap.add_argument("--reads", type=int, required=True)
    ap.add_argument("--patl", type=int, default=100)
    ap.add_argument("--errprob", type=float, default=0.02)
    ap.add_argument("--fastq", action="store_true")
    ap.add_argument("--fragments", type=int, default=1)
    ap.add_argument("--seed", type=int, default=4)
    args = ap.parse_args(argv)
    os.makedirs(args.outdir, exist_ok=True)
    g = os.path.join(args.outdir, "genome.fa")
    r = os.path.join(args.outdir, "reads.fq" if args.fastq else "reads.fa")
    if not os.path.exists(g):
        write_random_genome(g, args.genome_bp, seed=args.seed,
                            num_fragments=args.fragments)
    if not os.path.exists(r):
        from real_tpu_torch.io import fasta
        codes, _ = fasta.parse_genome(g)
        write_reads_fast(r, codes, args.reads, args.patl, args.errprob,
                         args.fastq, seed=args.seed + 1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
