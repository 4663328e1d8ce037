"""Device-side index construction, narrow (seedl <= 32) and wide (36..64).

Counterpart of real_tpu/index/build.py: one vectorized pass computes all
windows' four segments, composes the six pair signatures, and a sort
produces the six sorted lists, each row (signature, position) only
(MapTextFile.hpp:181-230, ListSet.hpp:41-63).

Windows enter the sort in real_tpu's PHASE-MAJOR order: position
start + 16k + p sits at entry p * C + k (C = windows / 16), the 16 phase
blocks side by side. Every sort here is stable, so within an equal
signature the entries keep that order, on the CPU and on the card alike.
The matcher imposes reference merge order on the lanes it keeps, so the
order inside an equal-signature run shows only where a run is longer than
the candidate cap: an overflowing read's first-pass lanes (rerun, never
printed) are then the first cand_cap entries of the run. real_tpu sorts
stably wherever it must (wide seeds, and narrow ones with real all-T
windows, PackedText.order_sentinels), and there `pos` equals its arrays
exactly; its other narrow builds use an unstable sort, whose order inside
a run XLA leaves undefined, so there `pos` equals it up to a permutation
inside each run of equal signatures.

The six lists are built ONE AFTER THE OTHER into preallocated outputs: a
list's sort key, permutation and the sort's own buffers are dead before
the next list starts, so the peak is the finished lists plus one list's
transients and not six (tools/planprobe.py measures it; parallel/plan.py
budgets with it).

Wide signatures are one int64 bit pattern each (index/signatures.py) and
sort by their sign-flipped key, the unsigned order — one sort where
real_tpu runs two stable LSD passes over its (lo, hi) planes.

Sentinels: invalid windows (containing N / past the range) get the
all-ones signature (0xFFFFFFFF narrow, 64 ones wide) and position
0x7FFFFFFF, and must sort AFTER every real entry (bucket counts and the
matcher's real-end clamp rely on it). That is automatic unless a real pair
signature can be all ones — an all-T segment pair at seedl 32 or 64
(PackedText.order_sentinels). real_tpu then adds a stable pre-sort pass on
the sentinel flag. Narrow: the flag is the minor digit of one composed
int64 sort key, `(key << 1) | flag`, the same LSD order in one pass. A
64-bit key has no spare bit, so wide (seedl 64) runs the flag pass as a
sort of its own FIRST (the minor digit; one permutation serves all six
lists, since the flag belongs to the window) and the stable key sort then
keeps real all-T entries ahead of the sentinels.

A per-list bucket table over the top `bucket_bits` signature bits
(getLookupTable.hpp:26-51) turns a probe's equal-range search into one
gather pair. It is built by one of two routes that give the same table:
the histogram of bucket keys or, for narrow tables of narrow signatures, a
binary search of the bucket boundaries in the sorted lists
(_use_bisect_table picks; wide keeps the histogram, as in real_tpu).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from real_tpu_torch.index.signatures import (NUM_LISTS, PAIR_SEGMENTS,
                                             SigConfig, unsigned_order)
from real_tpu_torch.text.packed import (MASK32, PackedText, extract_bases16,
                                        i32_bits, popcount32, u32)

POS_SENTINEL = 0x7FFFFFFF
SIG_SENTINEL = 0xFFFFFFFF
SIG_SENTINEL_WIDE = -1          # 64 ones, whatever the wide seed length
# pick_bucket_bits' cost constants: seconds per dependent bisection gather
# and per list entry of the histogram, measured by tools/planprobe.py on
# an NVIDIA H100 80GB HBM3 at 46.7M windows (PERF.md). real_tpu
# fitted 10e-9 and 9e-9 to its device; the tests pass those to hold the
# function against real_tpu's.
TABLE_GATHER_S = 0.39e-9
TABLE_ENTRY_S = 0.035e-9


@dataclasses.dataclass
class SignatureIndex:
    """Six sorted pair-signature lists over one text block/shard, flat.
    Narrow: sig holds the uint32 bit patterns as int32, like every 32-bit
    table of the port (text/packed.py). Wide (seedl > 32): sig is int64,
    one 64-bit pattern per entry — real_tpu's sig_hi and sig planes joined
    (convert.py goes both ways)."""
    sig: torch.Tensor   # int32 (int64 when wide) [6*M] flat sorted lists
    pos: torch.Tensor   # int32 [6*M] window position (sentinel if invalid)
    bb: torch.Tensor    # int32 [6*(2^bucket_bits+1)] flat bucket begins
    seedl: int
    bucket_bits: int


def pick_bucket_bits(seedl: int, num_windows: int, reads: int = 0,
                     cap: int = 25, gather_s: float = TABLE_GATHER_S,
                     entry_s: float = TABLE_ENTRY_S) -> int:
    """Bucket-table width for a shard (real_tpu/index/build.py
    pick_bucket_bits, the same host math).

    With reads == 0, or wide signatures: the occupancy-~1 rule, capped at
    `cap` and at the signature width. With reads > 0: the joint
    table-build + bisection cost model of real_tpu, over `gather_s`
    (seconds per dependent bisection gather) and `entry_s` (seconds per
    list entry of the histogram)."""
    bits = max(num_windows - 1, 1).bit_length()
    occ1 = min(max(12, min(bits, cap)), seedl)
    if reads <= 0 or seedl > 32:
        return occ1
    M = max(num_windows, 2)
    logm = math.ceil(math.log2(M + 1))
    G, SEG = gather_s, entry_s

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


def _use_bisect_table(bucket_bits: int, num_windows: int,
                      wide: bool = False) -> bool:
    """Choice between the histogram and the bisected rank table (same
    result), as real_tpu makes it: wide signatures keep the histogram."""
    if wide:
        return False
    logm = math.ceil(math.log2(max(num_windows, 2) + 1))
    return (1 << bucket_bits) * logm * 3 < num_windows * 9


def _rank_table_bisect(skey: torch.Tensor, real_n: torch.Tensor,
                       bucket_bits: int, shift_bits: int) -> torch.Tensor:
    """bb[b] = #{i < real_n : skey[i] < (b << shift)} for b = 1..2^bits
    (bb[0] is 0) by a binary search of every bucket boundary in one
    sorted list [M] (unsigned 32-bit values in int64). A real key with
    bucket value v is below b << shift iff v < b; sentinels (0xFFFFFFFF)
    sort after every real entry and the real_n bound excludes them — the
    boundary 2^32 counts everything."""
    nb = 1 << bucket_bits
    bounds = torch.arange(1, nb + 1, dtype=torch.int64,
                          device=skey.device) << shift_bits
    return torch.minimum(torch.searchsorted(skey, bounds), real_n)


def _rank_table_histogram(bucket: torch.Tensor, num_sentinels: torch.Tensor,
                          bucket_bits: int) -> torch.Tensor:
    """Prefix sums bb[1..2^bits] of the per-bucket real-entry counts of
    one list (bb[0] is 0; getLookupTable.hpp:26-51). `bucket` holds every
    entry's bucket key with the sentinels pinned to the top bucket, as
    real_tpu pins them before its histogram (a wide sentinel's key would
    wrap); their count comes off that bucket again."""
    nb = 1 << bucket_bits
    counts = torch.bincount(bucket, minlength=nb)
    counts[nb - 1] -= num_sentinels
    return counts.cumsum_(dim=0)


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
    become sentinels. Returns (sig, pos, bb) as FLAT tensors with
    M = 16*ceil(num_windows/16) entries per list: sig int32 bit patterns
    (int64 when seedl > 32), pos and bb int32."""
    sc = SigConfig(seedl)
    bucket_bits = bucket_bits or pick_bucket_bits(seedl, num_windows)
    dev = words.device
    C = -(-num_windows // 16)
    m = 16 * C
    # phase-major: row p holds positions start + 16k + p (k < C)
    pos = (start + 16 * torch.arange(C, dtype=torch.int64, device=dev)[None]
           + torch.arange(16, dtype=torch.int64, device=dev)[:, None]
           ).reshape(-1)
    valid = (pos <= n - seedl) & (pos < start + num_windows) \
        & (_npre16(nb16, ncum16, pos + seedl)
           == _npre16(nb16, ncum16, pos))
    segs = [extract_bases16(words, pos + off) >> (2 * (16 - w))
            for off, w in zip(sc.seg_offsets, sc.syms)]
    poss = torch.where(valid, pos, POS_SENTINEL).to(torch.int32)
    del pos
    if sc.wide and order_sentinels:
        # the sentinel flag as a stable pass of its own, the minor digit
        by_flag = torch.sort((~valid).to(torch.uint8), stable=True).indices
        valid, poss = valid[by_flag], poss[by_flag]
        segs = [sg[by_flag] for sg in segs]
        del by_flag
    real_n = valid.sum()
    num_sentinels = m - real_n

    nb = 1 << bucket_bits
    shift = sc.bucket_shift_bits(bucket_bits)
    bisect_table = _use_bisect_table(bucket_bits, num_windows, sc.wide)
    sig_out = torch.empty((NUM_LISTS, m), device=dev,
                          dtype=torch.int64 if sc.wide else torch.int32)
    pos_out = torch.empty((NUM_LISTS, m), dtype=torch.int32, device=dev)
    bb_out = torch.empty((NUM_LISTS, nb + 1), dtype=torch.int32, device=dev)
    bb_out[:, 0] = 0
    bits = sc.bits
    for j, (a, b) in enumerate(PAIR_SEGMENTS):
        key = torch.where(valid, (segs[a] << bits[b]) | segs[b],
                          SIG_SENTINEL_WIDE if sc.wide else SIG_SENTINEL)
        if sc.wide:
            skey, perm = torch.sort(unsigned_order(key), stable=True)
            skey = unsigned_order(skey)
        elif order_sentinels:
            # sentinel flag as the minor digit: real all-T entries first
            skey, perm = torch.sort((key << 1) | (~valid).to(torch.int64),
                                    stable=True)
            skey >>= 1
        else:
            skey, perm = torch.sort(key, stable=True)
        del key
        pos_out[j] = poss[perm]
        del perm
        if bisect_table:
            bb_out[j, 1:] = _rank_table_bisect(skey, real_n, bucket_bits,
                                               shift)
        else:
            bucket = torch.where(pos_out[j] != POS_SENTINEL,
                                 sc.bucket_key_bits(skey, bucket_bits),
                                 nb - 1)
            bb_out[j, 1:] = _rank_table_histogram(bucket, num_sentinels,
                                                  bucket_bits)
            del bucket
        sig_out[j] = skey if sc.wide else i32_bits(skey & MASK32)
        del skey
    return sig_out.reshape(-1), pos_out.reshape(-1), bb_out.reshape(-1)


def shard_windows(num_windows: int, num_shards: int) -> int:
    """Windows per shard, 16-aligned (so every shard's `start` is a
    multiple of 16 as build_lists_impl requires)."""
    per = -(-num_windows // num_shards)
    return -(-per // 16) * 16


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
