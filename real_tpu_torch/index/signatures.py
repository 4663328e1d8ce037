"""Pigeonhole seed-signature algebra, narrow (seedl <= 32) and wide (36..64).

Reference: SignatureConstruction.hpp. The seed (first `seedl` bases of a
read / each genome window) is split into nu=4 segments m0..m3 with widths
l/4, l/4, l/4, l - 3*(l/4) (m3 absorbs the remainder,
SignatureConstruction.hpp:48). The C(4,2)=6 pairwise concatenations
s0=(m0,m1) .. s5=(m2,m3) (SignatureConstruction.hpp:62-67) are the index /
probe keys: with at most 2 seed mismatches, at least one pair is error-free.

Every pair signature has exactly `seedl` bits. Narrow signatures are
carried as int64 tensors holding the unsigned 32-bit value, so comparisons
and sorts follow the unsigned order real_tpu's uint32 lanes have.

Wide signatures (the reference's u_int64_t dispatch, real.cpp:217-221) are
ONE int64 per signature holding the 64-bit pattern, where real_tpu carries
two uint32 planes (hi, lo) because a TPU has no 64-bit lanes. One word is
the natural form here: torch sorts, searches and compares int64 on the CPU
and on the card, a CUDA thread loads 8 bytes in one instruction, and one
sort replaces real_tpu's two stable LSD passes. What it costs: at seedl 64
the top signature bit is the sign bit, and the sentinel (all ones) is -1 at
every wide seedl, so the unsigned order needs the sign flipped
(`unsigned_order`) before any sort, searchsorted or `<`, and a bucket key
needs a logical shift (`bucket_key_bits` masks after `>>`). planes_to_i64
and i64_to_planes cross between the two forms (convert.py, the tests).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

NUM_LISTS = 6
SIGN64 = -(1 << 63)          # the int64 with only the top bit set
# (first segment, second segment) of each pair signature s0..s5
PAIR_SEGMENTS: Tuple[Tuple[int, int], ...] = (
    (0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


@dataclasses.dataclass(frozen=True)
class SigConfig:
    seedl: int

    @property
    def syms(self) -> Tuple[int, int, int, int]:
        w = self.seedl // 4
        return (w, w, w, self.seedl - 3 * w)

    @property
    def bits(self) -> Tuple[int, int, int, int]:
        return tuple(2 * s for s in self.syms)

    @property
    def seg_offsets(self) -> Tuple[int, int, int, int]:
        s = self.syms
        return (0, s[0], s[0] + s[1], s[0] + s[1] + s[2])

    @property
    def wide(self) -> bool:
        """True when pair signatures exceed 32 bits (one int64 each)."""
        return self.seedl > 32

    def bucket_shift_bits(self, bits: int) -> int:
        return self.seedl - min(bits, self.seedl)

    def bucket_key_bits(self, sig: torch.Tensor, bits: int) -> torch.Tensor:
        """Top `bits` bits of a signature (narrow unsigned value or wide
        bit pattern): sig >> (seedl - bits) as a LOGICAL shift — the
        arithmetic shift of a negative int64 is masked back."""
        sh = self.bucket_shift_bits(bits)
        return logical_shift_right(sig, sh) if self.wide else sig >> sh

    def compose_pairs(self, m: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """s0..s5 from segments m0..m3 (int64 tensors).
        sj = (m_a << bits_b) | m_b (SignatureConstruction.hpp:62-67).
        Narrow: the unsigned value; wide: the 64-bit pattern, which at
        seedl 64 wraps into the sign bit (compose_pairs_wide of real_tpu
        with its planes joined)."""
        bits = self.bits
        return [(m[a] << bits[b]) | m[b] for a, b in PAIR_SEGMENTS]

    def validate(self) -> None:
        if self.seedl > 64:
            raise ValueError("seedl must be <= 64")
        if self.seedl % 4 or self.seedl < 4:
            raise ValueError("seedl must be a positive multiple of 4")


def unsigned_order(sig: torch.Tensor) -> torch.Tensor:
    """int64 keys whose SIGNED order is the unsigned order of the 64-bit
    patterns in `sig` (top bit flipped); its own inverse."""
    return sig ^ SIGN64


def logical_shift_right(x: torch.Tensor, sh: int) -> torch.Tensor:
    """x >> sh on the 64-bit pattern, zero-filled (0 <= sh <= 63)."""
    if sh == 0:
        return x
    return (x >> sh) & ((1 << (64 - sh)) - 1)


def planes_to_i64(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """real_tpu's (hi, lo) uint32 planes -> the int64 bit patterns."""
    u = (np.asarray(hi).astype(np.uint64) << np.uint64(32)) \
        | np.asarray(lo).astype(np.uint64)
    return u.view(np.int64)


def i64_to_planes(sig: np.ndarray):
    """int64 bit patterns -> (hi, lo) uint32 planes."""
    u = np.ascontiguousarray(sig, np.int64).view(np.uint64)
    return ((u >> np.uint64(32)).astype(np.uint32),
            (u & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def read_segments(codes: torch.Tensor, seedl: int) -> List[torch.Tensor]:
    """Extract m0..m3 (int64) from a [B, L>=seedl] batch of base codes.

    Vectorized equivalent of SignatureConstruction::signatureMapped
    (SignatureConstruction.hpp:219-280). Caller must mask out reads
    containing codes > 3 (the reference returns false for them)."""
    sc = SigConfig(seedl)
    sc.validate()
    c = codes.to(torch.int64) & 3
    segs = []
    for off, w in zip(sc.seg_offsets, sc.syms):
        shifts = 2 * (w - 1 - torch.arange(w, device=codes.device))
        segs.append((c[..., off:off + w] << shifts).sum(dim=-1))
    return segs


def read_segments_rc(codes: torch.Tensor, seedl: int) -> List[torch.Tensor]:
    """Segments of the reverse-complement of the read's SEED —
    RC(read[0:seedl]), which equals RC(read)[patl-seedl:patl]: for the
    inverted probe the indexed window sits at the END of the reverse
    placement, so pos = rpos - restlen (reverseMappedSignature,
    SignatureConstruction.hpp:348-410; RestMatch::getMatchOffset,
    RestMatch.hpp:84-89). `codes` is the straight read [B, L>=seedl]."""
    seed = codes[..., :seedl].to(torch.int64)
    rc = (3 - seed.flip(-1)) & 3
    return read_segments(rc, seedl)
