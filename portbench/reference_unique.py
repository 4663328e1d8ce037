"""Plain reference of real's matchUnique with quality scores (-u 1 -q 1).

Written from real's semantics, independently of the program under test:
it imports torch and numpy only, and takes nothing the program made.

What a record is, for a read of length L (no base N):

* A hit is a window `pos` of one fragment, straight or reverse. The
  pattern P is the read (straight) or its reverse complement (reverse);
  the seed is P[0:32] (straight) or P[L-32:L] (reverse), i.e. the read's
  own first 32 bases either way. The window holds no N, has at most 2
  mismatches against P inside the seed (real's hard cap on -s) and at most
  k (-e) over all L bases.
* The seed is cut into four 8-base segments; list j of the six pairs
  (0,1) (0,2) (0,3) (1,2) (1,3) (2,3) reports a hit when both its segments
  match exactly. Hits are met in real's merge order: straight lists 0..5,
  then reverse lists 0..5, each list in ascending window position. A hit
  with two exact pairs is met once in each.
* A hit's score is float32(1.0 + sum over i of LL[genome_i, P_i, Q_i]),
  summed in float64 in base order, where LL[ref, read, q] =
  log2(odds[ref][read]) * (1 - 10^(-q/10) rounded to 7 decimals)
  (Scoring.cpp) and Q is the read's quality, reversed for a reverse hit
  (FASTA reads: 30).
* The hits fold, one at a time, into the read's state (UpdateUniqueInfo
  with scores): the first hit is taken; later a hit whose score exceeds
  the state's by more than eps is taken; one that is not better but lies
  within eps at another position makes the state non-unique. eps =
  float32(mult * k / 70 * L), mult = 1 at real's default filter level 2;
  the sums score +- eps are float32.
* A read whose final state is a unique hit prints
  id, P, score (%.6g), 1, a, L, +/-, fragment name, 1-based position in
  the fragment, an empty field, mismatches; tab-separated.

Candidates come from three sorted arrays of spaced 16-base keys over the
whole genome (the two 8-base segments d*8 apart, d = 1, 2, 3), searched
with the reads' probes: plain torch, on the device it is given.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

SEEDL, SEG, SEED_MISMATCHES = 32, 8, 2
PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))
FILTER_MULT = 1.0        # real's default filter level 2
FASTA_QUALITY = 30
_ACGT = np.frombuffer(b"ACGTN", dtype=np.uint8)


def log_odds() -> np.ndarray:
    """LL [ref 4, read 4, quality 64] in float64 (real's Scoring.cpp with
    its defaults). Bases A C G T = 0 1 2 3."""
    similarity, gc, trans, err, gcmut_bias = 0.995, 0.41, 0.71, 0.0, 2.0
    A, C, G, T = range(4)
    transit = trans * (1.0 - similarity)
    transver = (1.0 - trans) * (1.0 - similarity)
    gcmut = gcmut_bias * (1.0 - gc) / gc
    bg = [(1.0 - gc) / 2.0, gc / 2.0, gc / 2.0, (1.0 - gc) / 2.0]
    odds = [[0.0] * 4 for _ in range(4)]
    odds[A][G] = odds[T][C] = transit / (gcmut + 1.0) / (1.0 - gc)
    odds[G][A] = odds[C][T] = transit / (gcmut + 1.0) / gc * gcmut
    at = transver / 2.0 / (gcmut + 1.0) / (1.0 - gc)
    odds[A][C] = odds[T][G] = odds[A][T] = odds[T][A] = at
    cg = transver / 2.0 / (gcmut + 1.0) / gc * gcmut
    odds[C][A] = odds[G][T] = odds[C][G] = odds[G][C] = cg
    for x in (A, T, G, C):
        others = [y for y in range(4) if y != x]
        odds[x][x] = 1.0 - odds[x][others[0]] - odds[x][others[1]] \
            - odds[x][others[2]]
    for x in range(4):
        for y in range(4):
            odds[x][y] = odds[x][y] * (1.0 - err) / bg[y]
    prb = [float(f"{0.1 ** (q / 10.0):.7f}") for q in range(64)]
    ll = np.empty((4, 4, 64), np.float64)
    for x in range(4):
        for y in range(4):
            base = math.log(odds[x][y]) / math.log(2.0)
            for q in range(64):
                ll[x, y, q] = base * (1.0 - prb[q])
    return ll


def quality_offset(quals: np.ndarray) -> int:
    """real's FASTQ offset rule over the quality characters in file order:
    the first character <= '6' means 33, >= '^' means 64."""
    flat = quals.reshape(-1)
    decisive = np.flatnonzero((flat <= 54) | (flat >= 94))
    if not len(decisive):
        raise ValueError("no quality character decides the offset")
    return 33 if flat[decisive[0]] <= 54 else 64


def _kmers(codes: torch.Tensor) -> torch.Tensor:
    """int32 [n - 7]: the 16-bit code of the 8 bases from each start."""
    n = codes.shape[0]
    k = torch.zeros(n - SEG + 1, dtype=torch.int32, device=codes.device)
    for i in range(SEG):
        k = (k << 2) | (codes[i:n - SEG + 1 + i].to(torch.int32) & 3)
    return k


def _read_kmers(p: torch.Tensor, at: int) -> torch.Tensor:
    k = torch.zeros(p.shape[0], dtype=torch.int32, device=p.device)
    for i in range(SEG):
        k = (k << 2) | (p[:, at + i].to(torch.int32) & 3)
    return k


def find_hits(genome: np.ndarray, offsets: np.ndarray, reads: np.ndarray,
              k: int, device) -> dict:
    """Every hit of every read, one row per (list, hit) in which it is met:
    numpy columns read, strand (0/1), list, pos, mismatches."""
    dev = torch.device(device)
    g = torch.from_numpy(np.ascontiguousarray(genome)).to(dev)
    n = g.shape[0]
    R, L = reads.shape
    r = torch.from_numpy(np.ascontiguousarray(reads)).to(dev).to(torch.int64)
    pats = torch.stack([r, (3 - r.flip(1)) & 3])           # [2, R, L]
    seed_at = (0, L - SEEDL)
    kmer = _kmers(g)
    segs = [[_read_kmers(pats[s], seed_at[s] + SEG * a) for a in range(4)]
            for s in range(2)]
    cols = {c: [] for c in ("read", "strand", "list", "pos")}
    for d in (1, 2, 3):
        m = n - SEG + 1 - SEG * d
        if m <= 0:
            continue
        keys, where = torch.sort(
            (kmer[:m].to(torch.int64) << 16) | kmer[SEG * d:SEG * d + m])
        for j, (a, b) in enumerate(PAIRS):
            if b - a != d:
                continue
            for s in range(2):
                probe = (segs[s][a].to(torch.int64) << 16) | segs[s][b]
                lo = torch.searchsorted(keys, probe)
                cnt = torch.searchsorted(keys, probe, right=True) - lo
                row = torch.repeat_interleave(
                    torch.arange(R, device=dev), cnt)
                first = torch.repeat_interleave(lo - cnt.cumsum(0) + cnt,
                                                cnt)
                q = where[first + torch.arange(row.shape[0], device=dev)]
                cols["read"].append(row)
                cols["strand"].append(torch.full_like(row, s))
                cols["list"].append(torch.full_like(row, j))
                cols["pos"].append(q - SEG * a - seed_at[s])
        del keys, where
    read, strand, lst, pos = (torch.cat(cols[c]) for c in
                              ("read", "strand", "list", "pos"))
    offs = torch.from_numpy(np.asarray(offsets, np.int64)).to(dev)
    frag = torch.searchsorted(offs, pos, right=True) - 1
    ok = (pos >= 0) & (frag < offs.shape[0] - 1)
    frag = frag.clamp(0, offs.shape[0] - 2)
    ok &= pos + L <= offs[frag + 1]
    ar = torch.arange(L, device=dev)
    win = g[(pos.clamp(0, n - L)[:, None] + ar)].to(torch.int64)
    diff = win != pats[strand, read]
    at = torch.tensor(seed_at, device=dev)[strand][:, None]
    seed = (ar[None, :] >= at) & (ar[None, :] < at + SEEDL)
    total = diff.sum(1)
    ok &= (win < 4).all(1) & (r < 4).all(1)[read]
    ok &= ((diff & seed).sum(1) <= SEED_MISMATCHES) & (total <= k)
    out = {"read": read[ok], "strand": strand[ok], "list": lst[ok],
           "pos": pos[ok], "mismatches": total[ok]}
    return {c: v.cpu().numpy() for c, v in out.items()}


def score_hits(genome: np.ndarray, reads: np.ndarray, quals: np.ndarray,
               read: np.ndarray, strand: np.ndarray, pos: np.ndarray,
               dtype=np.float64) -> np.ndarray:
    """float32 scores of the hits (read, strand, pos): the sum in `dtype`
    (float64 as real; float32 is the benchmark's control), in base order."""
    L = reads.shape[1]
    ll = log_odds().astype(dtype)
    pat = reads[read]
    q = quals[read]
    rev = strand == 1
    pat = np.where(rev[:, None], 3 - pat[:, ::-1], pat)
    q = np.where(rev[:, None], q[:, ::-1], q)
    ref = genome[pos[:, None] + np.arange(L)]
    total = np.full(len(read), 1.0, dtype)
    for i in range(L):
        total = total + ll[ref[:, i], pat[:, i] & 3, q[:, i]]
    return total.astype(np.float32)


def _fold(events, eps: np.float32):
    """real's scores automaton over one read's hits in merge order;
    events: (strand, pos, mismatches, score). Returns the unique hit, or
    None (no hit, or not unique)."""
    unique, cur = None, None          # cur: (strand, pos, mm, score)
    for ev in events:
        s = ev[3]
        if cur is None:
            unique, cur = True, ev
            continue
        better = s > np.float32(cur[3] + eps)
        within = s > np.float32(cur[3] - eps)
        if better:
            unique, cur = True, ev
        elif unique and within and ev[1] != cur[1]:
            unique = False
    return cur if unique else None


def records(genome, ids: List[bytes], reads: np.ndarray,
            quals: Optional[np.ndarray], cfg: dict, device,
            dtype=np.float64) -> List[Optional[bytes]]:
    """The record real prints for each read (None: no record). `genome` is
    a gen.Genome; `reads` the reads' codes [R, L]; `quals` their quality
    values (characters less the file's offset) or None for FASTA; cfg the
    configuration's file."""
    if cfg["mode"] != "unique" or not cfg["scores"]:
        raise ValueError("this reference is of matchUnique with scores")
    k = cfg["max_mismatches"]
    R, L = reads.shape
    q = (np.full(reads.shape, FASTA_QUALITY, np.int64) if quals is None
         else np.clip(quals.astype(np.int64), 0, 63))
    h = find_hits(genome.codes, genome.offsets, reads, k, device)
    score = score_hits(genome.codes, reads.astype(np.int64), q, h["read"],
                       h["strand"], h["pos"], dtype)
    order = np.lexsort((h["pos"], h["strand"] * 6 + h["list"], h["read"]))
    eps = np.float32(FILTER_MULT * k / 70.0 * L)
    bounds = np.searchsorted(h["read"][order], np.arange(R + 1))
    out: List[Optional[bytes]] = [None] * R
    for i in range(R):
        sel = order[bounds[i]:bounds[i + 1]]
        if not len(sel):
            continue
        hit = _fold(zip(h["strand"][sel].tolist(), h["pos"][sel].tolist(),
                        h["mismatches"][sel].tolist(), score[sel]), eps)
        if hit is None:
            continue
        strand, pos, mm, s = hit
        pat = reads[i] if strand == 0 else 3 - reads[i][::-1]
        f = int(np.searchsorted(genome.offsets, pos, side="right")) - 1
        out[i] = b"\t".join([
            ids[i], _ACGT[pat].tobytes(), b"%.6g" % float(s), b"1", b"a",
            b"%d" % L, b"-" if strand else b"+", genome.names[f],
            b"%d" % (pos - int(genome.offsets[f]) + 1), b"",
            b"%d" % mm]) + b"\n"
    return out
