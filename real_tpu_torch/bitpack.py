"""Host-side (NumPy) 2-bit packing utilities.

Layout convention used everywhere in this framework: base i of a sequence is
stored in uint32 word i//16 at bit offset 2*(15 - i%16), i.e. the first base
of a word occupies the two most significant bits. This mirrors the reference's
big-endian-within-word packing (AutoTextArray.hpp getTextArray /
Rank::FastWriteBitWriter8) so that a "text word" compares MSB-first, but uses
uint32 lanes (16 bases/word) to match the TPU VPU instead of uint64.
"""

from __future__ import annotations

import numpy as np

BASES_PER_WORD = 16


def pack_2bit(codes: np.ndarray, pad_words: int = 2) -> np.ndarray:
    """Pack base codes (0..3; values >3 are packed as code&3, like the
    reference which packs N's low bits and tracks them in a separate wildcard
    bitmap, AutoTextArray.hpp:27-43) into uint32 words, 16 bases per word,
    MSB-first. Returns shape [ceil(n/16) + pad_words] (zero padded).

    Dyadic uint8 folding + a big-endian u32 view: ~20x faster than the
    [nw, 16] broadcast-shift reduction (5.7 s -> ~0.3 s at 46.7 Mbp),
    which materialized a 16-wide uint32 temp per word."""
    codes = np.asarray(codes, dtype=np.uint8)
    n = codes.shape[0]
    nw = (n + BASES_PER_WORD - 1) // BASES_PER_WORD
    padded = np.zeros(nw * BASES_PER_WORD, dtype=np.uint8)
    np.bitwise_and(codes, 3, out=padded[:n])
    s1 = (padded[0::2] << np.uint8(2)) | padded[1::2]
    s2 = (s1[0::2] << np.uint8(4)) | s1[1::2]      # one byte = 4 bases
    words = np.ascontiguousarray(s2).view(">u4").astype(np.uint32)
    if pad_words:
        words = np.concatenate([words, np.zeros(pad_words, dtype=np.uint32)])
    return words


def pack_rows_2bit(codes: np.ndarray) -> np.ndarray:
    """Pack a batch of rows [B, L] of base codes into [B, ceil(L/16)] uint32
    words (MSB-first per word, rows zero padded).

    Dyadic uint8 folding per row + a big-endian u32 view, like pack_2bit:
    the earlier [B, nw, 16] uint32 broadcast-shift reduction materialized
    ~13 bytes of temporaries per base — at 50M x 100bp (config 4's
    resident upload) that was ~65 GB of allocation traffic and several
    hundred seconds; this form peaks at ~1.3 uint8 bytes per base."""
    codes = np.asarray(codes, dtype=np.uint8)
    b, l = codes.shape
    nw = (l + BASES_PER_WORD - 1) // BASES_PER_WORD
    padded = np.zeros((b, nw * BASES_PER_WORD), dtype=np.uint8)
    np.bitwise_and(codes, 3, out=padded[:, :l])
    s1 = (padded[:, 0::2] << np.uint8(2)) | padded[:, 1::2]
    s2 = (s1[:, 0::2] << np.uint8(4)) | s1[:, 1::2]   # one byte = 4 bases
    return np.ascontiguousarray(s2).view(">u4").astype(np.uint32)


def pack_bitmap(bits: np.ndarray, pad_words: int = 2) -> np.ndarray:
    """Pack a boolean array into uint32 words, 32 bits/word, MSB-first
    (bit i at position 31 - i%32 of word i//32).

    np.packbits (MSB-first bytes) + a big-endian u32 view: one bit per
    base of temporaries, where a [nw, 32] uint32 shift-and-sum took 8
    bytes per base twice (~33 GB for the 2.07 Gbp sub-text of a human
    genome)."""
    bits = np.asarray(bits, dtype=bool)
    nw = (bits.shape[0] + 31) // 32
    buf = np.zeros(4 * nw, dtype=np.uint8)
    packed = np.packbits(bits, bitorder="big")
    buf[:packed.size] = packed
    words = buf.view(">u4").astype(np.uint32)
    if pad_words:
        words = np.concatenate([words, np.zeros(pad_words, dtype=np.uint32)])
    return words


def bitmap_cum_popcount(words: np.ndarray) -> np.ndarray:
    """ncum[j] = number of set bits in words[:j]; int32, length len(words)+1.
    Replaces the reference's two-level rank dictionary (ERank222B.hpp) —
    rank(i) = ncum[i//32] + popcount(top bits of word i//32)."""
    pc = np.zeros(len(words) + 1, dtype=np.int64)
    pc[1:] = np.cumsum(np.bitwise_count(words))
    if pc[-1] >= 2**31:
        raise ValueError("bitmap popcount exceeds int32")
    return pc.astype(np.int32)


def unpack_2bit(words: np.ndarray, n: int) -> np.ndarray:
    """Inverse of pack_2bit → uint8 codes of length n."""
    words = np.asarray(words, dtype=np.uint32)
    shifts = (2 * (BASES_PER_WORD - 1 - np.arange(BASES_PER_WORD,
                                                  dtype=np.uint32)))
    codes = ((words[:, None] >> shifts) & 3).reshape(-1)
    return codes[:n].astype(np.uint8)
