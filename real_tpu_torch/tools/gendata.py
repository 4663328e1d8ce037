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
    python -m real_tpu_torch.tools.gendata DIR --genome-bp 140000000 \\
        --reads 50000000 --seed 44                    # FLY below

It prints the seconds of each step it ran (genome_s, genome_parse_s,
reads_s) on stderr.

Everything here runs on the host.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Tuple

import numpy as np

_REMAP = np.frombuffer(b"ACGTN", dtype=np.uint8)
# write_reads_fast's record formatters (NumPy releases the interpreter
# lock in their array work; the draws stay on the calling thread)
_FORMAT_THREADS = 4


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
    # rng.random((c, patl)) <= errprob, in cache-sized blocks: one double
    # per 64-bit draw either way, so the stream is the same
    mut = np.empty(c * patl, bool)
    buf = np.empty(min(1 << 20, c * patl))
    for s in range(0, c * patl, len(buf)):
        u = buf[:min(len(buf), c * patl - s)]
        rng.random(out=u)
        np.less_equal(u, errprob, out=mut[s:s + len(u)])
    delta = rng.integers(1, 4, (c, patl), dtype=np.uint8)
    return pos, inv, mut.reshape(c, patl), delta


def _format_reads(codes: np.ndarray, lo: int, draws, patl: int,
                  fastq: bool) -> bytes:
    """One chunk of records from its draws: reads lo, lo+1, ... as one
    byte matrix of fixed-width records."""
    pos, inv, mut, delta = draws
    c = len(pos)
    win = np.lib.stride_tricks.sliding_window_view(codes, patl)[pos]
    win = np.where(inv[:, None], 3 - win[:, ::-1], win).astype(np.uint8)
    win = np.where(mut, (win + delta) & 3, win)
    seq = _REMAP[win]                               # [c, patl] bytes
    idw = 10                   # 'r' + 9 digits
    nl = np.uint8(ord("\n"))
    digits = (np.arange(lo, lo + c, dtype=np.int64)[:, None]
              // 10 ** np.arange(8, -1, -1, dtype=np.int64)) % 10
    if fastq:
        # @id\nseq\n+\nqual\n with the constant quality '5'
        w = 1 + idw + 1 + patl + 1 + 2 + patl + 1
        mat = np.empty((c, w), np.uint8)
        mat[:, 0] = ord("@")
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
        mat[:, 2 + idw:2 + idw + patl] = seq
        mat[:, -1] = nl
    mat[:, 1] = ord("r")
    mat[:, 2:1 + idw] = digits + ord("0")
    mat[:, 1 + idw] = nl
    return mat.tobytes()


def write_reads_fast(path: str, codes: np.ndarray, numpat: int, patl: int,
                     errprob: float, fastq: bool, seed: int = 1,
                     chunk: int = 250_000) -> None:
    """Reads at uniform start positions of `codes` (ACGT regions assumed),
    half of them reverse-complemented, each base mutated with probability
    errprob to one of the other three. Ids are 'r%09d', so every record
    has the same length and a chunk is one byte matrix.

    The random draws are one sequential stream (they fix the bytes); the
    calling thread makes them chunk by chunk while _FORMAT_THREADS workers
    turn earlier chunks into records, which are written in read order."""
    if numpat > 10**9:
        raise ValueError("read ids have 9 digits: at most 10^9 reads")
    rng = np.random.default_rng(seed)
    numpos = len(codes) - patl + 1
    codes = np.ascontiguousarray(codes)
    with open(path, "wb") as f, \
            ThreadPoolExecutor(max_workers=_FORMAT_THREADS) as ex:
        pending: collections.deque = collections.deque()
        for lo in range(0, numpat, chunk):
            draws = _chunk_draws(rng, min(chunk, numpat - lo), numpos, patl,
                                 errprob)
            pending.append(ex.submit(_format_reads, codes, lo, draws, patl,
                                     fastq))
            while len(pending) > _FORMAT_THREADS:
                f.write(pending.popleft().result())
        while pending:
            f.write(pending.popleft().result())
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
        t = time.perf_counter()
        write_random_genome(g, args.genome_bp, seed=args.seed,
                            num_fragments=args.fragments)
        sys.stderr.write(f"genome_s {time.perf_counter() - t:.3f}\n")
    if not os.path.exists(r):
        from real_tpu_torch.io import fasta
        t = time.perf_counter()
        codes, _ = fasta.parse_genome(g)
        sys.stderr.write(f"genome_parse_s {time.perf_counter() - t:.3f}\n")
        t = time.perf_counter()
        write_reads_fast(r, codes, args.reads, args.patl, args.errprob,
                         args.fastq, seed=args.seed + 1)
        sys.stderr.write(f"reads_s {time.perf_counter() - t:.3f}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
