"""Test-data generators, equivalents of the reference tools
randstr.cpp (random genome) and genpat.cpp (read simulator with ground
truth encoded in the read name: p<pos>[_inv][_<j><from><to>...]).

These are the correctness harness: reads carry their origin position,
strand and injected mutations in their names (genpat.cpp:119-137), so
alignments can be verified against truth without an oracle.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
_REMAP = np.frombuffer(b"ACGTN", dtype=np.uint8)


def random_genome(n: int, seed: int = 0, name: str = "random",
                  n_prob: float = 0.0,
                  num_fragments: int = 1) -> str:
    """Random ACGT(N) FASTA text, 60 columns (randstr.cpp)."""
    rng = np.random.default_rng(seed)
    out = []
    per = n // num_fragments
    for f in range(num_fragments):
        m = per if f < num_fragments - 1 else n - per * (num_fragments - 1)
        codes = rng.integers(0, 4, m)
        if n_prob > 0:
            codes[rng.random(m) < n_prob] = 4
        seq = _REMAP[codes].tobytes().decode()
        out.append(f">{name}_{f}_{m}")
        out.extend(seq[i:i + 60] for i in range(0, m, 60))
    return "\n".join(out) + "\n"


@dataclasses.dataclass
class TruthRead:
    name: str
    seq: str
    pos: int          # 0-based origin in the concatenated file text
    inverted: bool
    nmut: int
    qual: Optional[str] = None


def generate_reads(codes: np.ndarray, numpat: int, patlen: int,
                   errprob: float, fastq: bool,
                   seed: int = 1) -> List[TruthRead]:
    """genpat.cpp equivalent: sample positions, reverse-complement half,
    mutate per-base with errprob, encode truth in the name. FASTQ mode
    emits 'D' (match) / '*' (mutated) qualities (genpat.cpp:148-158)."""
    rng = np.random.default_rng(seed)
    n = len(codes)
    numpos = n - patlen + 1
    assert numpos > 0
    positions = np.sort(rng.integers(0, numpos, numpat))
    out: List[TruthRead] = []
    for p in positions:
        sub = codes[p:p + patlen].copy()
        inv = bool(rng.integers(0, 2))
        if inv:
            sub = sub[::-1].copy()
            m = sub < 4
            sub[m] = 3 - sub[m]
        name = f"p{p}" + ("_inv" if inv else "")
        orig = sub.copy()
        muts = np.flatnonzero(rng.random(patlen) <= errprob)
        for j in muts:
            old = sub[j]
            new = old
            while new == old:
                new = rng.integers(0, 4)
            name += f"_{j}{chr(_REMAP[old])}{chr(_REMAP[new])}"
            sub[j] = new
        qual = None
        if fastq:
            name += f" length={patlen}"
            qual = "".join("D" if sub[j] == orig[j] else "*"
                           for j in range(patlen))
        out.append(TruthRead(name=name,
                             seq=_REMAP[sub].tobytes().decode(),
                             pos=int(p), inverted=inv, nmut=len(muts),
                             qual=qual))
    return out


def write_reads(reads: List[TruthRead], path: str, fastq: bool) -> None:
    with open(path, "w") as f:
        for r in reads:
            if fastq:
                f.write(f"@{r.name}\n{r.seq}\n+\n{r.qual}\n")
            else:
                f.write(f">{r.name}\n{r.seq}\n")
