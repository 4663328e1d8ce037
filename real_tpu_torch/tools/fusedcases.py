"""Hand-made inputs for the fused fetch entries of ops/gather.py
(probe_candidates, verify_windows): tables and positions no index build or
match step would produce, so that a kernel and its plain version are held
together on every edge rule. The CPU tests and chip_smoke.py share them.
All arrays are numpy, made from the caller's generator."""

from __future__ import annotations

import numpy as np
import torch


def tensors(arrays, device):
    """numpy arrays -> tensors on `device`; uint32 becomes the int32 bit
    pattern, and 2-D int32 tables are flattened list after list (a wide
    int64 list is flattened by the caller: probes are int64 and 2-D too)."""
    out = []
    for a in arrays:
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        if a.dtype == np.int32:
            a = a.reshape(-1)
        out.append(torch.from_numpy(np.ascontiguousarray(a)).to(device))
    return out


def edge_tables(rng, M=500, bits=6):
    """Hand-made lists and bucket tables whose entries no build would
    write: bucket bounds at M-1, at M, beyond it, negative and descending,
    signatures with the top bit set, sentinels at the lists' ends."""
    nbuck = (1 << bits) + 1
    sig = np.sort(rng.integers(0, 2**32, (6, M), dtype=np.uint64)
                  .astype(np.uint32), axis=1)
    sig[:, -7:] = 0xFFFFFFFF
    bb = np.zeros((6, nbuck), np.int64)
    for l in range(6):
        bounds = np.arange(nbuck, dtype=np.uint64) << np.uint64(32 - bits)
        bb[l] = np.minimum(np.searchsorted(sig[l], bounds), M - 7)
    bb[0, 3:6] = [M - 1, M, M + 5]
    bb[1, 10:13] = [-3, 40, 20]
    bb[2, -2] = M - 1
    bb[3, -1] = 3                      # a list with three real entries
    bb[5, 20] = 2**31 - 1
    return sig, bb.astype(np.int32), 32 - bits


def edge_probes(rng, sig, nb):
    """(probe int64 [nb, 12], read_valid bool [nb]) over edge_tables' lists:
    half the probes are stored signatures, one read is all T (the sentinel
    signature), one all A, a fifth of the reads invalid."""
    probe = rng.integers(0, 2**32, (nb, 12), dtype=np.uint64).astype(np.int64)
    take = rng.random((nb, 12)) < 0.5              # half are stored entries
    stored = sig[np.arange(12) % 6, rng.integers(0, sig.shape[1], (nb, 12))]
    probe[take] = stored[take]
    probe[0] = 0xFFFFFFFF
    probe[1] = 0
    valid = rng.random(nb) < 0.8
    return probe, valid


def edge_tables_wide(rng, seedl, M=500, bits=6):
    """edge_tables for wide signatures of `seedl` bits: int64 bit patterns
    [6, M] in unsigned order (at seedl 64 half of them have the top bit
    set, where signed and unsigned order differ), the all-ones sentinel at
    the lists' ends, and the same out-of-range bucket bounds."""
    nbuck = (1 << bits) + 1
    sig = np.sort(rng.integers(0, 2**64, (6, M), dtype=np.uint64)
                  >> np.uint64(64 - seedl), axis=1)
    sig[:, -7:] = np.uint64(2**64 - 1)
    bb = np.zeros((6, nbuck), np.int64)
    bounds = np.arange(nbuck - 1, dtype=np.uint64) << np.uint64(seedl - bits)
    for l in range(6):
        bb[l, :-1] = np.minimum(np.searchsorted(sig[l], bounds), M - 7)
        bb[l, -1] = M - 7
    bb[0, 3:6] = [M - 1, M, M + 5]
    bb[1, 10:13] = [-3, 40, 20]
    bb[2, -2] = M - 1
    bb[3, -1] = 3                      # a list with three real entries
    bb[5, 20] = 2**31 - 1
    return sig.view(np.int64), bb.astype(np.int32), seedl - bits


def edge_probes_wide(rng, sig, nb, seedl):
    """edge_probes over edge_tables_wide's lists (sig int64 [6, M]): half
    the probes are stored signatures (sentinels among them), the others
    random patterns of `seedl` bits; one read is all T (all ones over the
    width: the sentinel itself at seedl 64), one all A."""
    probe = (rng.integers(0, 2**64, (nb, 12), dtype=np.uint64)
             >> np.uint64(64 - seedl)).view(np.int64)
    take = rng.random((nb, 12)) < 0.5
    stored = sig[np.arange(12) % 6,
                 rng.integers(0, sig.shape[1] - 7, (nb, 12))]
    probe[take] = stored[take]
    probe[0] = np.uint64((1 << seedl) - 1).view(np.int64)
    probe[1] = 0
    valid = rng.random(nb) < 0.8
    return probe, valid


def verify_inputs(rng, mw, nb, s, patl):
    """(words uint32 [mw], pos int64 [nb, s], inv bool, words_s, words_r
    int64 [nb, kw]) with window starts at base 0, word-aligned, in the
    last text word and past the text end."""
    nw = (patl + 15) // 16
    words = rng.integers(0, 2**32, mw, dtype=np.uint64).astype(np.uint32)
    words[-2:] = 0
    pos = rng.integers(0, 16 * (mw - 2) - patl, (nb, s))
    pos[0, :4] = [0, 16, 16 * (mw - 1), 16 * (mw - 1) + 15]   # last word
    pos[1, :2] = [16 * mw + 40, 2**31 - 1]                    # past the end
    inv = rng.random((nb, s)) < 0.5
    ws = rng.integers(0, 2**32, (nb, nw), dtype=np.uint64).astype(np.int64)
    wr = rng.integers(0, 2**32, (nb, nw), dtype=np.uint64).astype(np.int64)
    return words, pos.astype(np.int64), inv, ws, wr
