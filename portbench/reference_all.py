"""Plain reference of real's matchAll with quality scores (-u 0 -q 1).

Written from real's semantics, independently of the program under test:
it imports torch and numpy only, and takes nothing the program made. It
shares with reference_unique.py what a hit is and how it is scored.

What a read's records are, for a read of length L (no base N):

* A hit is a window `pos` of one fragment, straight or reverse. The
  pattern P is the read (straight) or its reverse complement (reverse);
  the seed is P[0:32] (straight) or P[L-32:L] (reverse), i.e. the read's
  own first 32 bases either way. The window holds no N, has at most 2
  mismatches against P inside the seed (real's hard cap on -s) and at most
  k (-e) over all L bases.
* Every hit is a record: matchAll keeps each placement within the limits,
  however many a read has, and ranks none of them. A hit is one (strand,
  window): met through several of the six lists of pairs of seed
  segments, it is still one record (unifyMatches drops the identical
  ones, matchAllImplementation.cpp:150-161). A window met on both strands
  is two records.
* A hit's score is float32(1.0 + sum over i of LL[genome_i, P_i, Q_i]),
  summed in float64 in base order, as reference_unique.py scores it (Q is
  the read's quality, reversed for a reverse hit; FASTA reads: 30).
* A record is id, P, score (%.6g), 1, a, L, +/-, fragment name, 1-based
  position in the fragment, an empty field, mismatches; tab-separated.
  real prints a read's records in no fixed order, so neither does this.

Candidates come from reference_unique.find_hits: three sorted arrays of
spaced 16-base keys over the whole genome, searched with the reads'
probes, in plain torch on the device it is given. With at most 2
mismatches in the seed's four 8-base segments, two segments match
exactly, so every hit is met through at least one list.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from portbench.reference_unique import (FASTA_QUALITY, _ACGT, find_hits,
                                        quality_offset, score_hits)

__all__ = ["records", "quality_offset"]


def records(genome, ids: List[bytes], reads: np.ndarray,
            quals: Optional[np.ndarray], cfg: dict, device,
            dtype=np.float64) -> List[Optional[bytes]]:
    """The records real prints for each read, as one `bytes` of lines
    (None: no record). `genome` is a gen.Genome; `reads` the reads' codes
    [R, L]; `quals` their quality values (characters less the file's
    offset) or None for FASTA; cfg the configuration's file; `dtype` the
    precision the scores are summed in (float64 as real; float32 is the
    benchmark's control)."""
    if cfg["mode"] != "all" or not cfg["scores"]:
        raise ValueError("this reference is of matchAll with scores")
    k = cfg["max_mismatches"]
    R, L = reads.shape
    q = (np.full(reads.shape, FASTA_QUALITY, np.int64) if quals is None
         else np.clip(quals.astype(np.int64), 0, 63))
    h = find_hits(genome.codes, genome.offsets, reads, k, device)
    # one row a distinct (read, strand, window), grouped by read
    key = (h["read"] * 2 + h["strand"]) * len(genome.codes) + h["pos"]
    _, first = np.unique(key, return_index=True)
    read, strand, pos, mm = (h[c][first] for c in
                             ("read", "strand", "pos", "mismatches"))
    score = score_hits(genome.codes, reads.astype(np.int64), q, read,
                       strand, pos, dtype)
    frag = np.searchsorted(genome.offsets, pos, side="right") - 1
    local = pos - genome.offsets[frag] + 1
    seqs = [_ACGT[reads].tobytes(), _ACGT[3 - reads[:, ::-1]].tobytes()]
    lines: List[List[bytes]] = [[] for _ in range(R)]
    for i, s, f, p, m, sc in zip(read.tolist(), strand.tolist(),
                                 frag.tolist(), local.tolist(), mm.tolist(),
                                 score.tolist()):
        lines[i].append(b"\t".join([
            ids[i], seqs[s][i * L:(i + 1) * L], b"%.6g" % sc, b"1", b"a",
            b"%d" % L, b"-" if s else b"+", genome.names[f], b"%d" % p, b"",
            b"%d" % m]) + b"\n")
    return [b"".join(x) if x else None for x in lines]
