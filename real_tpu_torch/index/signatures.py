"""Pigeonhole seed-signature algebra (narrow path: seedl <= 32).

Reference: SignatureConstruction.hpp. The seed (first `seedl` bases of a
read / each genome window) is split into nu=4 segments m0..m3 with widths
l/4, l/4, l/4, l - 3*(l/4) (m3 absorbs the remainder,
SignatureConstruction.hpp:48). The C(4,2)=6 pairwise concatenations
s0=(m0,m1) .. s5=(m2,m3) (SignatureConstruction.hpp:62-67) are the index /
probe keys: with at most 2 seed mismatches, at least one pair is error-free.

Every pair signature has exactly `seedl` bits. Signatures are carried as
int64 tensors holding the unsigned 32-bit value, so comparisons and sorts
follow the unsigned order real_tpu's uint32 lanes have. Seeds wider than
32 bases (real_tpu's (hi, lo) plane path) are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch

NUM_LISTS = 6
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
        """True when pair signatures exceed 32 bits (not ported yet)."""
        return self.seedl > 32

    def bucket_shift_bits(self, bits: int) -> int:
        return self.seedl - min(bits, self.seedl)

    def compose_pairs(self, m: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """s0..s5 from segments m0..m3 (int64 tensors).
        sj = (m_a << bits_b) | m_b (SignatureConstruction.hpp:62-67)."""
        if self.wide:
            raise NotImplementedError("seeds over 32 bases are not ported")
        bits = self.bits
        return [(m[a] << bits[b]) | m[b] for a, b in PAIR_SEGMENTS]

    def validate(self) -> None:
        if self.seedl > 64:
            raise ValueError("seedl must be <= 64")
        if self.seedl % 4 or self.seedl < 4:
            raise ValueError("seedl must be a positive multiple of 4")


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
