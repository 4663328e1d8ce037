"""Plain reference of real's matchUnique with quality scores (-u 1 -q 1),
for genomes whose keys do not fit the card at once.

reference_unique.py finds a read's candidates in sorted arrays of the
spaced 16-base keys of the whole genome. At the human genome's 3.1 Gbp
one distance d of those arrays holds 3.1 G int32 k-mers, int64 keys and
int64 positions (12.4 + 24.8 + 24.8 GB) and the sort's scratch on top:
more than the card's 80 GB. This module's find_hits finds the same hits
with the roles turned round: it sorts the reads' probes (six lists, two
strands, one probe a read each) and goes over the genome in blocks of
`block` key starts, looking each block's keys up among the sorted probes.
A block takes the bases its keys reach past its last start (8 d + 7, at
most 31), so every key is whole in the block it starts in and is met
there alone; a hit's window is read from the whole genome, so a window
that crosses a block's edge is checked as reference_unique checks it.
A block holds about 30 bytes a key start on the device at once, beside
the genome's one byte a base.

What the blocking changes: the order of the rows find_hits returns, and
the memory. What it does not change: which rows there are (every (read,
strand, list, window) in which a hit is met, held to the same limits:
no N in the window or the read, at most 2 mismatches in the seed and k
in all, inside one fragment), and everything after the search. records()
is reference_unique.records itself, its candidate search bound to this
module's: the scores (float64 in base order), real's merge order (which
it sorts the rows into before it reads their order), the fold, eps and
the record's bytes are reference_unique.py's, not copies of them.

Index units. A text whose index exceeds the memory budget is indexed in
units of consecutive seed windows, and real folds every hit of a unit,
in its merge order, before any hit of the next. The fold is
order-defined (two hits within eps of each other make a read non-unique
until a later hit beats the one taken), so a read whose hits lie in
several units can get another record than in one unit: on the grch
configuration's 12 units, about one read in four million. A
configuration indexed in several units names each unit's first seed
window (`index_unit_starts`, in the genome's coordinates); find_hits
adds 12 times a hit's unit, the unit that holds its seed window, to its
list, so that records() sorts the hits unit after unit. Without it there
is one unit, and the records are reference_unique's.

Plain torch and numpy on the device it is given; it imports nothing of
the program under test.
"""

from __future__ import annotations

import functools
import types
from typing import List, Optional

import numpy as np
import torch

from portbench import reference_unique as ru
from portbench.reference_unique import PAIRS, SEED_MISMATCHES, SEEDL, SEG
# the harness reads a configuration's FASTQ offset through its reference
from portbench.reference_unique import quality_offset  # noqa: F401

# key starts a block of the search covers: on a card ~8 GB at once, on
# the CPU ~0.5 GB
BLOCK_CUDA = 1 << 28
BLOCK_CPU = 1 << 24
# bases the keys of a block reach past its last start: the second segment
# of the widest pair (d = 3) ends 8 * 3 + 7 bases after the key's start
REACH = SEG * 3 + SEG - 1


def _probes(pats: torch.Tensor, seed_at, d: int):
    """The probe keys of every (list, strand) whose two segments lie d
    segments apart, sorted, with each probe's read, strand, list and the
    offset of its key's first base in the window."""
    R = pats.shape[1]
    rows = torch.arange(R, device=pats.device)
    cols = {c: [] for c in ("key", "read", "strand", "list", "off")}
    for j, (a, b) in enumerate(PAIRS):
        if b - a != d:
            continue
        for s in range(2):
            at = seed_at[s]
            cols["key"].append(
                (ru._read_kmers(pats[s], at + SEG * a).to(torch.int64) << 16)
                | ru._read_kmers(pats[s], at + SEG * b))
            cols["read"].append(rows)
            for c, v in (("strand", s), ("list", j), ("off", at + SEG * a)):
                cols[c].append(torch.full_like(rows, v))
    key, order = torch.sort(torch.cat(cols["key"]))
    return key, {c: torch.cat(cols[c])[order]
                 for c in ("read", "strand", "list", "off")}


def _lookup(keys: torch.Tensor, probes: torch.Tensor):
    """(key index, probe index) of every pair of equal values."""
    lo = torch.searchsorted(probes, keys)
    at = lo.clamp(max=probes.shape[0] - 1)
    met = torch.nonzero(probes[at] == keys).squeeze(1)
    lo = lo[met]
    cnt = torch.searchsorted(probes, keys[met], right=True) - lo
    key_i = torch.repeat_interleave(met, cnt)
    first = torch.repeat_interleave(lo - cnt.cumsum(0) + cnt, cnt)
    return key_i, first + torch.arange(key_i.shape[0], device=keys.device)


def find_hits(genome: np.ndarray, offsets: np.ndarray, reads: np.ndarray,
              k: int, device, block: Optional[int] = None,
              unit_starts=None) -> dict:
    """reference_unique.find_hits's rows, one per (list, hit) in which a
    hit is met, in another order, found block by block: numpy columns
    read, strand (0/1), list, pos, mismatches. `block`: the key starts a
    block covers (None: BLOCK_CUDA on a card, BLOCK_CPU on the CPU).

    `unit_starts`: the first seed window of each index unit, ascending
    from 0, in the genome's coordinates (None: one unit). A hit is met in
    the unit that holds its seed window (pos, or pos + L - 32 on the
    reverse strand), and its `list` is its list plus 12 times that unit,
    so that the (strand, list) order records() sorts by is real's merge
    order over units met one after another (see module docstring)."""
    dev = torch.device(device)
    block = block or (BLOCK_CUDA if dev.type == "cuda" else BLOCK_CPU)
    g = torch.from_numpy(np.ascontiguousarray(genome)).to(dev)
    n = g.shape[0]
    R, L = reads.shape
    r = torch.from_numpy(np.ascontiguousarray(reads)).to(dev).to(torch.int64)
    pats = torch.stack([r, (3 - r.flip(1)) & 3])           # [2, R, L]
    read_ok = (r < 4).all(1)
    seed_at = (0, L - SEEDL)
    at_of = torch.tensor(seed_at, device=dev)
    offs = torch.from_numpy(np.asarray(offsets, np.int64)).to(dev)
    ar = torch.arange(L, device=dev)
    probes = {d: _probes(pats, seed_at, d) for d in (1, 2, 3)}
    units = torch.tensor([0] if unit_starts is None else unit_starts,
                         dtype=torch.int64, device=dev)
    cols = {c: [] for c in ("read", "strand", "list", "pos", "mismatches")}
    starts = n - SEG + 1                     # k-mer starts of the genome
    for b0 in range(0, max(starts, 0), block):
        b1 = min(b0 + block, starts)
        kmer = ru._kmers(g[b0:min(n, b1 + REACH)])
        for d, (pkey, p) in probes.items():
            m = min(b1, starts - SEG * d) - b0   # this block's key starts
            if m <= 0:
                continue
            keys = (kmer[:m].to(torch.int64) << 16) | kmer[SEG * d:SEG * d + m]
            key_i, probe_i = _lookup(keys, pkey)
            del keys
            read, strand = p["read"][probe_i], p["strand"][probe_i]
            pos = b0 + key_i - p["off"][probe_i]
            # reference_unique.find_hits's checks, on this block's rows
            frag = torch.searchsorted(offs, pos, right=True) - 1
            ok = (pos >= 0) & (frag < offs.shape[0] - 1)
            frag = frag.clamp(0, offs.shape[0] - 2)
            ok &= pos + L <= offs[frag + 1]
            win = g[(pos.clamp(0, n - L)[:, None] + ar)].to(torch.int64)
            diff = win != pats[strand, read]
            at = at_of[strand][:, None]
            seed = (ar[None, :] >= at) & (ar[None, :] < at + SEEDL)
            total = diff.sum(1)
            ok &= (win < 4).all(1) & read_ok[read]
            ok &= ((diff & seed).sum(1) <= SEED_MISMATCHES) & (total <= k)
            unit = torch.searchsorted(units, pos + at[:, 0], right=True) - 1
            lst = p["list"][probe_i] + len(PAIRS) * 2 * unit
            for c, v in (("read", read), ("strand", strand), ("list", lst),
                         ("pos", pos), ("mismatches", total)):
                cols[c].append(v[ok].cpu())
        del kmer
    return {c: (torch.cat(v) if v else torch.zeros(0, dtype=torch.int64)
                ).numpy() for c, v in cols.items()}


def records(genome, ids: List[bytes], reads: np.ndarray,
            quals: Optional[np.ndarray], cfg: dict, device,
            dtype=np.float64,
            block: Optional[int] = None) -> List[Optional[bytes]]:
    """reference_unique.records (the same arguments; the same records
    where cfg names no `index_unit_starts`) with find_hits above as its
    candidate search, in blocks of `block` key starts, over the units
    that cfg names. The function is reference_unique's own code, run with
    its module's names but for find_hits."""
    names = dict(vars(ru), find_hits=functools.partial(
        find_hits, block=block, unit_starts=cfg.get("index_unit_starts")))
    bound = types.FunctionType(ru.records.__code__, names, "records")
    return bound(genome, ids, reads, quals, cfg, device, dtype)
