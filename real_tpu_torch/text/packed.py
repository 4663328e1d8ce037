"""Packed genome text on the device (counterpart of real_tpu/text/packed.py).

The genome is 2-bit packed (16 bases per 32-bit word, MSB-first), with a
packed N-wildcard bitmap plus a per-word cumulative popcount array replacing
the reference's two-level rank dictionary (AutoTextArray.hpp, ERank222B.hpp).

32-bit words in torch: torch has no usable uint32 shifts, adds or compares
on the CPU and no popcount. The port therefore STORES every 32-bit table
as int32 holding the same bit pattern as real_tpu's uint32 arrays (so a
table crosses between the packages as a plain view), and COMPUTES on int64
tensors holding the unsigned value (`u32`), where shifts, compares and the
SWAR popcount below behave as on uint32. Index math keeps real_tpu's
int32-overflow-safe form: `p >> 4` and `(p & 15) << 1`, never `p << 1`.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from real_tpu_torch import bitpack
from real_tpu_torch.index.signatures import PAIR_SEGMENTS, SigConfig

MASK32 = 0xFFFFFFFF


def u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern (or any int tensor) -> int64 unsigned value."""
    return x.to(torch.int64) & MASK32


def i32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 unsigned 32-bit value -> int32 tensor with the same bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of int64 tensors holding values in [0, 2^32) (SWAR)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def as_i32_tensor(a: np.ndarray, device) -> torch.Tensor:
    """uint32/int32 numpy array -> int32 tensor with the same bits."""
    if a.dtype not in (np.uint32, np.int32):
        raise TypeError(f"expected a 32-bit integer array, got {a.dtype}")
    return torch.from_numpy(
        np.ascontiguousarray(a).view(np.int32).copy()).to(device)


@dataclasses.dataclass
class PackedText:
    """Device-resident packed genome of ONE text file. 32-bit tables are
    int32 tensors holding real_tpu's uint32 bit patterns."""
    words: torch.Tensor         # [W+2], 16 bases/word, zero padded
    nbits: torch.Tensor         # [NW+2], wildcard bitmap, 32 bases/word
    ncum: torch.Tensor          # [NW+3], cumulative popcount of nbits
    frag_offsets: torch.Tensor  # [F+1], fragment starts + terminal n
    n: int                      # number of bases
    ranges: List[Tuple[str, int]]  # host copy incl. ("terminal", n)
    # 16-base-granularity wildcard structures used by the index build:
    # nb16[g] holds the 16 N-bits of bases [16g, 16g+16) in its low half,
    # ncum16[g] = #N in [0, 16g)
    nb16: torch.Tensor = None       # [G+4]
    ncum16: torch.Tensor = None     # [G+5]
    # True when some window's pair signature can equal the 0xFFFFFFFF
    # sentinel (an all-T segment pair at seedl 32 / 64) — the build then
    # orders real entries before sentinels (index/build.py)
    allt32: bool = False
    allt64: bool = False
    # True when the text contains any wildcard base: N-free texts skip the
    # per-candidate rank gathers
    has_n: bool = True

    @property
    def num_fragments(self) -> int:
        return len(self.ranges) - 1

    def order_sentinels(self, seedl: int) -> bool:
        return self.allt32 if seedl == 32 else (
            self.allt64 if seedl == 64 else False)


def build_packed_text(codes: np.ndarray, ranges: List[Tuple[str, int]],
                      device) -> PackedText:
    n = int(codes.shape[0])
    if n >= 2**31:
        raise ValueError(
            "text file larger than 2^31 bases: split into per-fragment "
            "shards (positions are int32, like the reference's u32 "
            "Mask::pos, Mask.hpp:47)")
    words = bitpack.pack_2bit(codes, pad_words=2)
    nbits = bitpack.pack_bitmap(codes > 3, pad_words=2)
    ncum = bitpack.bitmap_cum_popcount(nbits)
    # 16-bit N-groups: split each 32-bit word into (hi, lo) halves
    nw = len(nbits)
    nb16 = np.empty(2 * nw, dtype=np.uint32)
    nb16[0::2] = nbits >> np.uint32(16)
    nb16[1::2] = nbits & np.uint32(0xFFFF)
    ncum16 = np.zeros(2 * nw + 1, dtype=np.int64)
    ncum16[1:] = np.cumsum(np.bitwise_count(nb16))
    frag_offsets = np.array([off for _, off in ranges], dtype=np.int32)
    return PackedText(
        words=as_i32_tensor(words, device),
        nbits=as_i32_tensor(nbits, device),
        ncum=as_i32_tensor(ncum, device),
        frag_offsets=as_i32_tensor(frag_offsets, device),
        n=n,
        ranges=list(ranges),
        nb16=as_i32_tensor(nb16, device),
        ncum16=as_i32_tensor(ncum16.astype(np.int32), device),
        allt32=_has_all_t_pair(codes, 32),
        allt64=_has_all_t_pair(codes, 64),
        has_n=bool(ncum16[-1] > 0),
    )


def _run_all(x: np.ndarray, w: int) -> np.ndarray:
    """r[i] = x[i] & x[i+1] & ... & x[i+w-1] by dyadic folding (w a power
    of two); len(r) = len(x) - w + 1."""
    step = 1
    while step < w:
        x = x[:-step] & x[step:]
        step *= 2
    return x


def _has_all_t_pair(codes: np.ndarray, seedl: int) -> bool:
    """True when some window's pair signature equals the 0xFFFFFFFF
    sentinel — i.e. a genuine all-T segment pair exists. Only a
    full-width pair reaches the sentinel: seedl == 32 (narrow) or
    seedl == 64 (wide)."""
    w = seedl // 4
    x = codes == 3
    if len(x) < seedl:
        return False
    seg_t = _run_all(x, w)                 # seg_t[i]: codes[i:i+w] all T
    if not seg_t.any():
        return False
    offs = SigConfig(seedl).seg_offsets
    nwin = len(codes) - seedl + 1
    for a, b in PAIR_SEGMENTS:
        sa = seg_t[offs[a]:offs[a] + nwin]
        sb = seg_t[offs[b]:offs[b] + nwin]
        if bool(np.any(sa & sb)):
            return True
    return False


# ---------------------------------------------------------------------------
# device-side helpers
# ---------------------------------------------------------------------------

def _take_clip(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[clip(idx, 0, len-1)] — jnp.take(mode="clip")."""
    return table[idx.clamp(0, table.shape[0] - 1)]


def extract_bases16(words: torch.Tensor,
                    base_pos: torch.Tensor) -> torch.Tensor:
    """16 bases starting at an arbitrary base offset as one unsigned 32-bit
    value in int64 (MSB-first): two word gathers + a funnel shift
    (AutoTextArray::getTextWord, AutoTextArray.hpp:122-125)."""
    p = base_pos.to(torch.int64)
    idx = p >> 4
    sh = (p & 15) << 1
    w0 = u32(_take_clip(words, idx))
    w1 = u32(_take_clip(words, idx + 1))
    # w1 >> (32 - sh) is 0 for sh == 0: int64 shifts by 32 are defined
    return ((w0 << sh) & MASK32) | (w1 >> (32 - sh))


def pair_mismatch_count(x: torch.Tensor) -> torch.Tensor:
    """Number of differing 2-bit base pairs in an XOR'd packed word
    (PopCountTable.hpp:113-131)."""
    return popcount32(((x >> 1) | x) & 0x55555555)


def n_rank_excl(nbits: torch.Tensor, ncum: torch.Tensor,
                p: torch.Tensor) -> torch.Tensor:
    """Number of wildcard (N) bases in [0, p)."""
    p = p.to(torch.int64)
    wi = p >> 5
    bo = p & 31
    w = u32(_take_clip(nbits, wi))
    return _take_clip(ncum, wi).to(torch.int64) + popcount32(w >> (32 - bo))


def is_dontcare_free(nbits: torch.Tensor, ncum: torch.Tensor,
                     i: torch.Tensor, l) -> torch.Tensor:
    """AutoTextArray::isDontCareFree(i, l) (AutoTextArray.hpp:167-172)."""
    return (n_rank_excl(nbits, ncum, i + l)
            - n_rank_excl(nbits, ncum, i)) == 0
