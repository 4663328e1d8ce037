"""Odds-ratio quality scoring.

Reimplements the scoring math of the reference exactly (Scoring.cpp:61-133):
an odds-ratio 4x4 matrix from {similarity, GC content, transition rate,
error rate, GC-mutability bias}, flattened with the quality weighting
log2(oddsRatio[ref][read]) * (1 - Q_PRB[q]) (Scoring.cpp:170) into a
4*4*64 lookup table. A hit's score is 1.0 + sum over aligned bases of
LL[ref, read, q] accumulated in float64 in base order (ComputeScore.hpp),
then narrowed to float32 for the tie/epsilon comparisons
(UpdateUniqueInfo<true>, matchUniqueImplementation.cpp:179-248).

Q_PRB is the reference's hand-rounded table of pow(0.1, q/10) to 7 decimal
places (Scoring.cpp:28-36), generated by rounding.
"""

from __future__ import annotations

import math

import numpy as np
import torch

DFLT_SIMILARITY = 0.995
DFLT_ERR = 0.0
DFLT_TRANS = 0.71
DFLT_GC = 0.41
DFLT_GCMUT_BIAS = 2.0


def q_prb() -> np.ndarray:
    """pow(0.1, q/10) rounded to 7 decimals, 65 entries (Scoring.cpp:28)."""
    q = np.arange(65, dtype=np.float64)
    return np.round(np.power(0.1, q / 10.0), 7)


class Scoring:
    def __init__(self, similarity: float = DFLT_SIMILARITY,
                 gc: float = DFLT_GC, trans: float = DFLT_TRANS,
                 err: float = DFLT_ERR,
                 gcmut_bias: float = DFLT_GCMUT_BIAS) -> None:
        transit = trans * (1.0 - similarity)
        transver = (1.0 - trans) * (1.0 - similarity)

        bg = np.empty(4, dtype=np.float64)
        bg[0] = bg[3] = (1.0 - gc) / 2.0   # A, T
        bg[1] = bg[2] = gc / 2.0           # C, G

        gcmut = gcmut_bias * (1.0 - gc) / gc

        R = np.empty((4, 4), dtype=np.float64)
        # transitions (Scoring.cpp:76-79); base codes A=0 C=1 G=2 T=3
        R[0][2] = transit / (gcmut + 1.0) / (1.0 - gc)           # A->G
        R[3][1] = transit / (gcmut + 1.0) / (1.0 - gc)           # T->C
        R[2][0] = transit / (gcmut + 1.0) / gc * gcmut           # G->A
        R[1][3] = transit / (gcmut + 1.0) / gc * gcmut           # C->T
        # transversions (Scoring.cpp:81-88)
        tv_at = transver / 2.0 / (gcmut + 1.0) / (1.0 - gc)
        tv_gc = transver / 2.0 / (gcmut + 1.0) / gc * gcmut
        R[0][1] = R[3][2] = R[0][3] = R[3][0] = tv_at
        R[1][0] = R[2][3] = R[1][2] = R[2][1] = tv_gc
        # conservation (Scoring.cpp:90-93)
        R[0][0] = 1.0 - R[0][1] - R[0][2] - R[0][3]
        R[3][3] = 1.0 - R[3][0] - R[3][1] - R[3][2]
        R[2][2] = 1.0 - R[2][0] - R[2][1] - R[2][3]
        R[1][1] = 1.0 - R[1][0] - R[1][2] - R[1][3]
        # error adjustment + background normalisation (Scoring.cpp:96-111)
        for x in range(4):
            for y in range(4):
                R[x][y] *= 1.0 - err
                R[x][y] /= bg[y]

        self.odds_ratio = R

        # LL[(ref<<8) | (read<<6) | q] = log2(R[ref][read]) * (1-Q_PRB[q])
        qp = q_prb()
        ll = np.empty(4 * 4 * 64, dtype=np.float64)
        log2 = math.log(2.0)
        for c0 in range(4):
            for c1 in range(4):
                base = math.log(R[c0][c1]) / log2
                for q in range(64):
                    ll[(c0 << 8) | (c1 << 6) | q] = base * (1.0 - qp[q])
        self.ll = ll

    def raw_log_score(self, ref: int, read: int, q: int) -> float:
        """LL[ref, read, q]: one entry of the quality-weighted log-odds
        table (Scoring::rawLogScore)."""
        return float(self.ll[(ref << 8) | (read << 6) | q])

    def ll_f32_pair(self):
        """Two-float (hi, lo) split of the LUT."""
        hi = self.ll.astype(np.float32)
        lo = (self.ll - hi.astype(np.float64)).astype(np.float32)
        return hi, lo


class ScoreTables:
    """Constant scoring tables shipped into the match step.

    The port scores in float64 only (the card has native doubles), so it
    keeps the LUT's (hi, lo) f32 split that real_tpu's f64 mode sums back
    to float64 — the same 1024 values, bit for bit. real_tpu's Dekker and
    rank-1 factor tables serve its two-float mode, which the port does not
    need."""

    def __init__(self, scoring: "Scoring") -> None:
        self.ll_hi, self.ll_lo = scoring.ll_f32_pair()
        self._ll_on = {}

    def ll_f64(self) -> np.ndarray:
        """The LUT exactly as the match step sums it: f64(hi) + f64(lo)."""
        return (self.ll_hi.astype(np.float64)
                + self.ll_lo.astype(np.float64))

    def ll_on(self, device) -> torch.Tensor:
        """ll_f64 as a tensor on `device`, uploaded once per device: a copy
        from pageable host memory waits for the device's stream, so a copy
        per step would end every step in a synchronization."""
        dev = torch.device(device)
        if dev not in self._ll_on:
            self._ll_on[dev] = torch.from_numpy(self.ll_f64()).to(dev)
        return self._ll_on[dev]


_TABLE_CACHE = {}


def score_tables(scoring: Scoring) -> ScoreTables:
    key = scoring.odds_ratio.tobytes()
    if key not in _TABLE_CACHE:
        _TABLE_CACHE[key] = ScoreTables(scoring)
    return _TABLE_CACHE[key]
