"""Device-side index construction (narrow signatures, seedl <= 32).

Counterpart of real_tpu/index/build.py: one vectorized pass computes all
windows' four segments, composes the six pair signatures, and a sort
produces the six sorted lists, each row (signature, position) only
(MapTextFile.hpp:181-230, ListSet.hpp:41-63).

Windows are processed in position order: real_tpu's phase-major layout
exists to keep the TPU on static slices, and the entry order before the
sort is free anyway — within an equal signature the list order is free
(the matcher imposes reference merge order on its compacted lanes), so
`sig` and `bb` equal real_tpu's and `pos` equals it up to a permutation
inside each run of equal signatures.

Sentinels: invalid windows (containing N / past the range) get signature
0xFFFFFFFF and position 0x7FFFFFFF, and must sort AFTER every real entry
(bucket counts and the matcher's real-end clamp rely on it). That is
automatic unless a real pair signature can equal 0xFFFFFFFF — an all-T
segment pair at seedl 32 (PackedText.order_sentinels). real_tpu then adds
a stable pre-sort pass on the sentinel flag; here the flag is the minor
digit of one composed int64 sort key, the same LSD order in one pass.

A per-list bucket table over the top `bucket_bits` signature bits
(getLookupTable.hpp:26-51) turns a probe's equal-range search into one
gather pair. It is built by one of two routes that give the same table:
the histogram of bucket keys or, for narrow tables, a binary search of the
bucket boundaries in the sorted lists (_use_bisect_table picks).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from real_tpu_torch.index.signatures import NUM_LISTS, SigConfig
from real_tpu_torch.text.packed import (MASK32, PackedText, extract_bases16,
                                        i32_bits, popcount32, u32)

POS_SENTINEL = 0x7FFFFFFF
SIG_SENTINEL = 0xFFFFFFFF


@dataclasses.dataclass
class SignatureIndex:
    """Six sorted pair-signature lists over one text block/shard, flat.
    sig holds the uint32 bit patterns as int32, like every 32-bit table
    of the port (text/packed.py)."""
    sig: torch.Tensor   # int32 [6*M] flat sorted lists
    pos: torch.Tensor   # int32 [6*M] window position (sentinel if invalid)
    bb: torch.Tensor    # int32 [6*(2^bucket_bits+1)] flat bucket begins
    seedl: int
    bucket_bits: int


def pick_bucket_bits(seedl: int, num_windows: int, reads: int = 0,
                     cap: int = 25) -> int:
    """Bucket-table width for a shard (real_tpu/index/build.py
    pick_bucket_bits, the same host math).

    With reads == 0: the occupancy-~1 rule, capped at `cap` and at the
    signature width. With reads > 0: the joint table-build + bisection
    cost model real_tpu fitted to its device (its constants are kept so
    that both packages build the same table)."""
    bits = max(num_windows - 1, 1).bit_length()
    occ1 = min(max(12, min(bits, cap)), seedl)
    if reads <= 0 or seedl > 32:
        return occ1
    M = max(num_windows, 2)
    logm = math.ceil(math.log2(M + 1))
    G = 10e-9
    SEG = 9e-9

    def table_cost(b: int) -> float:
        return min(6 * M * SEG, 6 * (1 << b) * logm * G)

    def match_cost(b: int) -> float:
        occ = M / float(1 << b)
        if occ <= 2.0:                      # lane path, no bisection
            return reads * 12 * 4 * G
        steps = math.ceil(math.log2(8.0 * occ + 1))
        steps = -(-steps // 4) * 4          # driver rounds to multiple of 4
        return reads * 12 * 2 * steps * G

    hi_b = min(max(12, min(bits, cap)), seedl)
    lo_b = min(12, hi_b)
    return min(range(lo_b, hi_b + 1),
               key=lambda b: (table_cost(b) + match_cost(b), -b))


def _use_bisect_table(bucket_bits: int, num_windows: int) -> bool:
    """Choice between the histogram and the bisected rank table (same
    result), as real_tpu makes it for narrow signatures."""
    logm = math.ceil(math.log2(max(num_windows, 2) + 1))
    return (1 << bucket_bits) * logm * 3 < num_windows * 9


def _rank_table_bisect(skey: torch.Tensor, real_n: torch.Tensor,
                       bucket_bits: int, shift_bits: int) -> torch.Tensor:
    """bb[j, b] = #{i < real_n : skey[j, i] < (b << shift)} by a binary
    search of every bucket boundary in the sorted lists [6, M] (unsigned
    values in int64). A real key with bucket value v is below b << shift
    iff v < b; sentinels (0xFFFFFFFF) sort after every real entry and the
    real_n bound excludes them — the boundary 2^32 counts everything."""
    nl = skey.shape[0]
    nb = 1 << bucket_bits
    bounds = torch.arange(1, nb + 1, dtype=torch.int64,
                          device=skey.device) << shift_bits
    cnt = torch.searchsorted(skey.contiguous(),
                             bounds.expand(nl, nb).contiguous())
    cnt = torch.minimum(cnt, real_n)
    zero = torch.zeros((nl, 1), dtype=torch.int64, device=skey.device)
    return torch.cat([zero, cnt], dim=1)


def _rank_table_histogram(skey: torch.Tensor, sp: torch.Tensor,
                          bucket_bits: int,
                          shift_bits: int) -> torch.Tensor:
    """Exclusive prefix sums of the per-bucket real-entry counts
    (getLookupTable.hpp:26-51)."""
    nl = skey.shape[0]
    nb = 1 << bucket_bits
    real = sp != POS_SENTINEL
    h = torch.where(real, skey >> shift_bits, nb - 1)
    h = h + (torch.arange(nl, device=skey.device) * nb)[:, None]
    counts = torch.zeros(nl * nb, dtype=torch.int64, device=skey.device)
    counts.scatter_add_(0, h.reshape(-1), real.reshape(-1).to(torch.int64))
    zero = torch.zeros((nl, 1), dtype=torch.int64, device=skey.device)
    return torch.cat([zero, counts.reshape(nl, nb).cumsum(dim=1)], dim=1)


def _npre16(nb16: torch.Tensor, ncum16: torch.Tensor,
            p: torch.Tensor) -> torch.Tensor:
    """Number of N bases before base position p >= 0, at 16-base
    granularity; past the tables' end (positions that are sentinels
    anyway) it reads no N-bits over the total count."""
    g = p >> 4
    part = popcount32(u32(nb16[g.clamp(max=nb16.shape[0] - 1)])
                      >> (16 - (p & 15)))
    return ncum16[g.clamp(max=ncum16.shape[0] - 1)].to(torch.int64) + part


def build_lists_impl(words: torch.Tensor, nb16: torch.Tensor,
                     ncum16: torch.Tensor, start: int, num_windows: int,
                     seedl: int, n: int, *, order_sentinels: bool = False,
                     bucket_bits: int = 0):
    """Sorted lists + bucket table covering windows
    [start, start + 16*ceil(num_windows/16)). `start` must be a multiple
    of 16. Positions past min(start + num_windows, n - seedl + 1) - 1
    become sentinels. Returns (sig, pos, bb) as FLAT int32 tensors with
    M = 16*ceil(num_windows/16) entries per list."""
    sc = SigConfig(seedl)
    if sc.wide:
        raise NotImplementedError("seeds over 32 bases are not ported")
    bucket_bits = bucket_bits or pick_bucket_bits(seedl, num_windows)
    dev = words.device
    m = 16 * (-(-num_windows // 16))
    pos = start + torch.arange(m, dtype=torch.int64, device=dev)
    segs = [extract_bases16(words, pos + off) >> (2 * (16 - w))
            for off, w in zip(sc.seg_offsets, sc.syms)]
    valid = (pos <= n - seedl) & (pos < start + num_windows) \
        & (_npre16(nb16, ncum16, pos + seedl)
           == _npre16(nb16, ncum16, pos))
    keys = torch.stack([torch.where(valid, s, SIG_SENTINEL)
                        for s in sc.compose_pairs(segs)])     # [6, M]
    poss = torch.where(valid, pos, POS_SENTINEL)

    if order_sentinels:
        # sentinel flag as the minor digit: real all-T entries first
        sortkey = (keys << 1) | (~valid).to(torch.int64)
        sortkey, perm = torch.sort(sortkey, dim=1)
        skey = sortkey >> 1
    else:
        skey, perm = torch.sort(keys, dim=1)
    sp = poss[perm]

    shift = sc.bucket_shift_bits(bucket_bits)
    if _use_bisect_table(bucket_bits, num_windows):
        bb = _rank_table_bisect(skey, valid.sum(), bucket_bits, shift)
    else:
        bb = _rank_table_histogram(skey, sp, bucket_bits, shift)
    return (i32_bits(skey & MASK32).reshape(-1),
            sp.to(torch.int32).reshape(-1),
            bb.to(torch.int32).reshape(-1))


def build_index(text: PackedText, seedl: int, start: int = 0,
                num_windows: Optional[int] = None,
                bucket_bits: int = 0) -> SignatureIndex:
    """Build the index over window positions [start, start+num_windows)
    on the text's device. `start` must be 16-aligned; bucket_bits
    overrides the table width (the driver passes the reads-aware
    pick_bucket_bits)."""
    total = max(text.n - seedl + 1, 0)
    if num_windows is None:
        num_windows = total - start
    if start % 16:
        raise ValueError("shard starts must be 16-aligned")
    bucket_bits = bucket_bits or pick_bucket_bits(seedl, int(num_windows))
    sig, pos, bb = build_lists_impl(
        text.words, text.nb16, text.ncum16, start, int(num_windows), seedl,
        text.n, order_sentinels=text.order_sentinels(seedl),
        bucket_bits=bucket_bits)
    return SignatureIndex(sig=sig, pos=pos, bb=bb, seedl=seedl,
                          bucket_bits=bucket_bits)
