"""The benchmark's data generator: a random genome FASTA and read files.

A frozen copy of the vectorised generators of real_tpu_torch/tools/gendata.py
(random ACGT genome in 60 columns; reads at uniform start positions, half of
them reverse-complemented, each base mutated with probability `errprob` to
one of the other three; ids 'r%09d'), with genpat's FASTQ qualities: 'D'
for a base as drawn and '*' for a mutated one (genpat.cpp:148-158, as
real_tpu_torch/tools/simulate.py has them), since scores read qualities.

A configuration may plant repeat families into the genome (`repeats`:
the share of the genome its copies cover, the length of a family's
segment, how many instances a family has, and the range each pasted
copy's divergence is drawn from; half the copies reverse-complemented),
so that reads have several hits, ties and non-unique states.

Everything is drawn from one integer seed, each stream with a key of its
own, so the same seed gives the same bytes. The arrays the files were
formatted from are returned, so the reference takes the very inputs the
program reads.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple

import numpy as np

_ACGT = np.frombuffer(b"ACGTN", dtype=np.uint8)
QUAL_KEPT, QUAL_MUTATED = ord("D"), ord("*")
ID_WIDTH = 10                          # 'r' + 9 digits
_CHUNK = 1 << 19                       # records formatted at once
# stream keys under the seed
_GENOME, _DRAW, _SAMPLE, _ORDER, _REPEATS = 0, 1, 2, 3, 4


def rng(seed: int, *key: int) -> np.random.Generator:
    """The generator of stream `key` under `seed` (any integer)."""
    return np.random.default_rng([seed % (1 << 64), *key])


@dataclasses.dataclass
class Genome:
    codes: np.ndarray          # uint8 [n], 0..3
    names: List[bytes]         # fragment headers, without '>'
    offsets: np.ndarray        # int64 [F + 1], fragment starts and n


def make_genome(seed: int, n: int, fragments: int = 1,
                repeats: Optional[dict] = None) -> Genome:
    """A random ACGT genome of n bases in `fragments` fragments, fragment
    f named `random_<f>_<its length>` (gendata's names), with the repeat
    families `repeats` planted (see plant_repeats) when given."""
    codes = rng(seed, _GENOME).integers(0, 4, n, dtype=np.uint8)
    if repeats:
        plant_repeats(seed, codes, repeats)
    per = n // fragments
    lens = [per] * (fragments - 1) + [n - per * (fragments - 1)]
    offsets = np.zeros(fragments + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    names = [f"random_{f}_{m}".encode() for f, m in enumerate(lens)]
    return Genome(codes, names, offsets)


def plant_repeats(seed: int, codes: np.ndarray, spec: dict) -> np.ndarray:
    """Paste repeat families into `codes` in place. A family is a segment
    of spec["length"] bases at a random place and copies of it, as many
    that the family has spec["copies"] = [lo, hi] instances (drawn
    uniformly, the segment included), each copy pasted at a random place,
    reverse-complemented with probability 1/2, with each base changed with
    a probability drawn uniformly from spec["divergence"] = [lo, hi]. The
    number of families is such that the instances cover about
    spec["share"] of the genome. Copies take the segments' bases as drawn,
    before any paste. Returns the pasted copies' starts."""
    n, length = len(codes), int(spec["length"])
    lo, hi = spec["copies"]
    fams = max(1, round(spec["share"] * n / (length * (lo + hi) / 2)))
    r = rng(seed, _REPEATS)
    count = r.integers(lo, hi + 1, fams)
    src = r.integers(0, n - length + 1, fams)
    fam = np.repeat(np.arange(fams), count - 1)
    m = len(fam)
    dst = r.integers(0, n - length + 1, m)
    span = np.arange(length)
    block = codes[src[fam][:, None] + span]
    rc = r.random(m) < 0.5
    block[rc] = 3 - block[rc][:, ::-1]
    div = r.uniform(*spec["divergence"], m)
    mut = r.random((m, length)) < div[:, None]
    block[mut] = (block[mut]
                  + r.integers(1, 4, int(mut.sum()), dtype=np.uint8)) & 3
    codes[dst[:, None] + span] = block
    return dst


def cell_genome(seed: int, cfg: dict) -> Genome:
    """The genome of a configuration's file under `seed`."""
    return make_genome(seed, cfg["genome_bp"], cfg["fragments"],
                       cfg.get("repeats"))


def write_genome(path: str, g: Genome) -> None:
    """FASTA in 60 columns, one header per fragment."""
    with open(path, "wb") as f:
        for name, a, b in zip(g.names, g.offsets[:-1], g.offsets[1:]):
            f.write(b">" + name + b"\n")
            seq = _ACGT[g.codes[a:b]]
            full = len(seq) // 60
            mat = np.empty((full, 61), np.uint8)
            mat[:, :60] = seq[:full * 60].reshape(full, 60)
            mat[:, 60] = ord("\n")
            f.write(mat)
            if len(seq) % 60:
                f.write(seq[full * 60:].tobytes() + b"\n")


@dataclasses.dataclass
class Draw:
    """One drawn read set: the reads as sequenced (codes in read order,
    0..3) and, for FASTQ, their quality characters."""
    codes: np.ndarray          # uint8 [N, L]
    quals: np.ndarray          # uint8 [N, L] quality characters, or None
    start: np.ndarray          # int64 [N], the window each read came from
    reverse: np.ndarray        # bool [N]


def draw_reads(seed: int, draw: int, g: Genome, num: int, length: int,
               errprob: float, fastq: bool) -> Draw:
    """`num` reads of `length` bases (gendata's draws: uniform starts over
    the concatenated text, half reverse-complemented, each base mutated
    with probability errprob to one of the other three)."""
    r = rng(seed, _DRAW, draw)
    numpos = len(g.codes) - length + 1
    start = r.integers(0, numpos, num)
    reverse = r.integers(0, 2, num, dtype=np.uint8).astype(bool)
    codes = np.lib.stride_tricks.sliding_window_view(g.codes, length)[start]
    codes[reverse] = 3 - codes[reverse][:, ::-1]
    mut = bernoulli_positions(r, num * length, errprob)
    flat = codes.reshape(-1)
    flat[mut] = (flat[mut] + r.integers(1, 4, len(mut), dtype=np.uint8)) & 3
    quals = None
    if fastq:
        quals = np.full((num, length), QUAL_KEPT, np.uint8)
        quals.reshape(-1)[mut] = QUAL_MUTATED
    return Draw(codes, quals, start, reverse)


def bernoulli_positions(r: np.random.Generator, n: int,
                        p: float) -> np.ndarray:
    """The ascending positions of the successes among n independent
    Bernoulli(p) trials, drawn as geometric gaps between them."""
    if p <= 0:
        return np.zeros(0, np.int64)
    parts, last = [], -1
    while last < n:
        gaps = r.geometric(p, int(n * p + 6 * (n * p) ** 0.5) + 16)
        pos = last + np.cumsum(gaps)
        parts.append(pos)
        last = int(pos[-1])
    pos = np.concatenate(parts)
    return pos[:np.searchsorted(pos, n)]


def read_ids(rows: np.ndarray) -> np.ndarray:
    """[len(rows), ID_WIDTH] uint8: 'r%09d' of each read number."""
    digits = (rows.astype(np.int64)[:, None]
              // 10 ** np.arange(8, -1, -1, dtype=np.int64)) % 10
    out = np.empty((len(rows), ID_WIDTH), np.uint8)
    out[:, 0] = ord("r")
    out[:, 1:] = digits + ord("0")
    return out


def format_reads(d: Draw, order: np.ndarray) -> np.ndarray:
    """The records of reads `order` (read numbers), in that order, as
    fixed-width FASTA or 4-line FASTQ records: one byte row each."""
    c, length = len(order), d.codes.shape[1]
    seq = _ACGT[d.codes[order]]
    ids = read_ids(order)
    nl = ord("\n")
    if d.quals is not None:
        mat = np.empty((c, 1 + ID_WIDTH + 1 + length + 3 + length + 1),
                       np.uint8)
        mat[:, 0] = ord("@")
        s = 2 + ID_WIDTH
        mat[:, s:s + length] = seq
        mat[:, s + length] = nl
        mat[:, s + length + 1] = ord("+")
        mat[:, s + length + 2] = nl
        mat[:, s + length + 3:-1] = d.quals[order]
    else:
        mat = np.empty((c, 1 + ID_WIDTH + 1 + length + 1), np.uint8)
        mat[:, 0] = ord(">")
        mat[:, 2 + ID_WIDTH:-1] = seq
    mat[:, 1:1 + ID_WIDTH] = ids
    mat[:, 1 + ID_WIDTH] = nl
    mat[:, -1] = nl
    return mat


def write_reads(path: str, d: Draw, order: np.ndarray) -> None:
    with open(path, "wb") as f:
        for lo in range(0, len(order), _CHUNK):
            f.write(format_reads(d, order[lo:lo + _CHUNK]))


def file_order(seed: int, index: int, num: int, spec: dict) -> np.ndarray:
    """The read numbers of read file `index`, in file order: a draw's own
    order, or a seeded reordering of it (`{"reorder_of": i}`)."""
    if "reorder_of" in spec:
        return rng(seed, _ORDER, index).permutation(num)
    return np.arange(num)


def sample(seed: int, draw: int, num: int, size: int) -> np.ndarray:
    """The read numbers of a draw whose records the check compares: `size`
    distinct ones (all when size >= num), ascending."""
    if size >= num:
        return np.arange(num)
    return np.sort(rng(seed, _SAMPLE, draw).choice(num, size, replace=False))


def file_draws(files: List[dict]) -> List[int]:
    """The draw behind each entry of a traffic's `files` list: `{"draw":
    d}` is draw d, `{"reorder_of": i}` the draw of entry i."""
    out: List[int] = []
    for spec in files:
        out.append(out[spec["reorder_of"]] if "reorder_of" in spec
                   else spec["draw"])
    return out


def make_draws(seed: int, g: Genome, cfg: dict, traffic: dict) -> dict:
    """{draw: Draw} of every draw the traffic's read files take."""
    return {d: draw_reads(seed, d, g, traffic["reads_per_job"],
                          cfg["read_length"], cfg["errprob"],
                          cfg["read_format"] == "fastq")
            for d in sorted(set(file_draws(traffic["files"])))}


def make_files(seed: int, dirpath: str, cfg: dict, traffic: dict
               ) -> Tuple[Genome, str, List[str], dict]:
    """Write the genome and the traffic's read files into `dirpath`:
    (genome, genome path, read file paths, {draw: Draw})."""
    g = cell_genome(seed, cfg)
    gpath = os.path.join(dirpath, "genome.fa")
    write_genome(gpath, g)
    draws = make_draws(seed, g, cfg, traffic)
    ext = "fq" if cfg["read_format"] == "fastq" else "fa"
    paths = []
    for i, (spec, d) in enumerate(zip(traffic["files"],
                                      file_draws(traffic["files"]))):
        paths.append(os.path.join(dirpath, f"reads{i}.{ext}"))
        write_reads(paths[-1], draws[d],
                    file_order(seed, i, traffic["reads_per_job"], spec))
    return g, gpath, paths, draws
