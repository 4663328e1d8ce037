"""Cases for the score and fold (ops/scorefold.py, K4): crafted fold rows
at the automaton's edges and random lanes at the main path's shapes.

The CPU tests hold the plain loops (engine/matchstep.py score_survivors
and fold_unique) to real_tpu's on every case; the card's tests and
chip_smoke.py hold the kernel (csrc/score_fold.cu) to the plain loops,
bit for bit. A case is numpy; `torch_inputs` makes its tensors.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import numpy as np

from real_tpu_torch.scoring import scoring

NO_MATCH, STRAIGHT, REVERSE, GAPPED, NON_UNIQUE = 0, 1, 2, 3, 4
FLT_MAX = np.float32(np.finfo(np.float32).max)
LANE_FIELDS = ("valid", "inv", "pos", "frag", "k", "score")
STATE_FIELDS = ("st", "pos", "frag", "fileid", "errs", "score")


class ScoreFoldCase(NamedTuple):
    name: str
    lanes: Dict[str, np.ndarray]      # LANE_FIELDS, each [B, L]
    tw: Optional[np.ndarray]          # uint32 [kw, B, L]; None: no scoring
    codes: Optional[np.ndarray]       # uint8 [B, patl]
    quals: Optional[np.ndarray]       # int8 [B, patl]; None: FASTA's 30
    state: Optional[Dict[str, np.ndarray]]  # STATE_FIELDS, each [B]; None:
    #                                         no fold
    fileid: int
    epsilon: np.float32
    scores: bool                      # the fold compares scores, not k


def ll_table() -> np.ndarray:
    """The default scoring's 1,024 f64 LL entries, as the step sums them."""
    return scoring.score_tables(scoring.Scoring()).ll_f64()


def _up(x: np.float32) -> np.float32:
    return np.nextafter(x, np.float32(np.inf), dtype=np.float32)


def _crafted_rows(scores: bool, eps: np.float32, fileid: int):
    """(name, state, lanes) rows: state (st, pos, frag, fileid, errs,
    score), lanes [(valid, inv, pos, frag, k, score)]."""
    s0 = np.float32(-12.25)
    hi = np.float32(s0 + eps)                 # f32(score + eps) as folded
    lo = np.float32(s0 - eps)
    fresh = (NO_MATCH, 0, 0, 0, 0, -FLT_MAX)
    hit = (STRAIGHT, 10, 0, fileid, 2, s0)
    old = (STRAIGHT, 10, 0, fileid - 1, 2, s0)      # from an earlier file
    nu = (NON_UNIQUE, 10, 0, fileid, 2, s0)

    def lane(pos, score=s0, k=2, valid=True, inv=False, frag=0):
        return (valid, inv, pos, frag, k, score)

    if scores:
        return [
            ("all_invalid", fresh, [lane(5, valid=False), lane(6, 9.0, 0,
                                                            valid=False)]),
            ("first_valid_takes", fresh, [lane(5, valid=False), lane(100)]),
            ("inv_lane_reverse", fresh, [lane(7, inv=True)]),
            ("gapped_is_open", (GAPPED, 3, 1, 0, 4, s0), [lane(8, -90.0)]),
            ("within_eps_ties", hit, [lane(20, np.float32(s0 + eps / 2))]),
            ("at_plus_eps_ties", hit, [lane(20, hi)]),
            ("above_plus_eps_takes", hit, [lane(20, _up(hi), inv=True)]),
            ("at_minus_eps_keeps", hit, [lane(20, lo)]),
            ("above_minus_eps_ties", hit, [lane(20, _up(lo))]),
            ("same_locus_keeps", hit, [lane(10, s0), lane(10, _up(s0))]),
            ("other_frag_ties", hit, [lane(10, s0, frag=1)]),
            ("earlier_file_same_locus_ties", old, [lane(10, s0)]),
            ("non_unique_taken_back", nu, [lane(30, _up(hi), inv=True)]),
            ("non_unique_stays", nu, [lane(30, s0), lane(10, _up(lo))]),
            ("tie_then_better", hit, [lane(20, s0), lane(40, _up(hi))]),
            ("better_then_tie", hit, [lane(20, _up(hi)), lane(40, _up(hi))]),
            ("invalid_better_ignored", hit, [lane(20, 50.0, valid=False)]),
            ("reverse_hit_ties", (REVERSE, 10, 0, fileid, 2, s0),
             [lane(20, s0, inv=True)]),
            ("worse_keeps", hit, [lane(20, np.float32(s0 - 3 * eps))]),
        ]
    return [
        ("all_invalid", fresh, [lane(5, k=0, valid=False)]),
        ("first_valid_takes", fresh, [lane(5, k=4, valid=False),
                                      lane(100, k=3)]),
        ("inv_lane_reverse", fresh, [lane(7, k=1, inv=True)]),
        ("gapped_is_open", (GAPPED, 3, 1, 0, 0, s0), [lane(8, k=5)]),
        ("fewer_mismatches_takes", hit, [lane(20, k=1, inv=True)]),
        ("equal_mismatches_ties", hit, [lane(20, k=2)]),
        ("same_locus_keeps", hit, [lane(10, k=2)]),
        ("earlier_file_same_locus_ties", old, [lane(10, k=2)]),
        ("more_mismatches_keeps", hit, [lane(20, k=3)]),
        ("non_unique_taken_back", nu, [lane(30, k=1)]),
        ("non_unique_stays", nu, [lane(30, k=2), lane(40, k=3)]),
        ("tie_then_better", hit, [lane(20, k=2), lane(40, k=0)]),
        ("invalid_better_ignored", hit, [lane(20, k=0, valid=False)]),
        ("score_untouched", hit, [lane(20, 99.0, k=0)]),
    ]


def crafted_cases(fileid: int = 1) -> List[ScoreFoldCase]:
    """The crafted fold rows, one case each for scores and mismatch
    counts: every row a read, its lanes padded with invalid lanes to the
    longest row's count; fold alone (the lanes' scores given)."""
    out = []
    for scores in (True, False):
        eps = np.float32(3.5)
        rows = _crafted_rows(scores, eps, fileid)
        B, L = len(rows), max(len(r[2]) for r in rows) + 1
        lanes = {f: np.zeros((B, L), dtype) for f, dtype in zip(
            LANE_FIELDS, (bool, bool, np.int32, np.int32, np.int32,
                          np.float32))}
        state = {f: np.zeros(B, dtype) for f, dtype in zip(
            STATE_FIELDS, (np.int32,) * 5 + (np.float32,))}
        for b, (_, st, row) in enumerate(rows):
            for f, v in zip(STATE_FIELDS, st):
                state[f][b] = v
            for j, ln in enumerate(row):
                for f, v in zip(LANE_FIELDS, ln):
                    lanes[f][b, j] = v
        out.append(ScoreFoldCase(
            f"crafted_{'scores' if scores else 'mismatches'}", lanes, None,
            None, None, state, fileid, eps, scores))
    return out


def crafted_expectations(case: ScoreFoldCase) -> List[tuple]:
    """(row name, st) each crafted row must end in: the rows' intent,
    checked on real_tpu's fold by the CPU tests."""
    rows = _crafted_rows(case.scores, case.epsilon, case.fileid)
    want = {"all_invalid": NO_MATCH, "first_valid_takes": STRAIGHT,
            "inv_lane_reverse": REVERSE, "gapped_is_open": STRAIGHT,
            "within_eps_ties": NON_UNIQUE, "at_plus_eps_ties": NON_UNIQUE,
            "above_plus_eps_takes": REVERSE, "at_minus_eps_keeps": STRAIGHT,
            "above_minus_eps_ties": NON_UNIQUE,
            "same_locus_keeps": STRAIGHT, "other_frag_ties": NON_UNIQUE,
            "earlier_file_same_locus_ties": NON_UNIQUE,
            "non_unique_taken_back": REVERSE if case.scores else STRAIGHT,
            "non_unique_stays": NON_UNIQUE, "tie_then_better": STRAIGHT,
            "better_then_tie": NON_UNIQUE, "invalid_better_ignored": STRAIGHT,
            "reverse_hit_ties": NON_UNIQUE, "worse_keeps": STRAIGHT,
            "fewer_mismatches_takes": REVERSE,
            "equal_mismatches_ties": NON_UNIQUE,
            "more_mismatches_keeps": STRAIGHT, "score_untouched": STRAIGHT}
    return [(name, want[name]) for name, _, _ in rows]


def _pack_words(bases: np.ndarray, kw: int, rng) -> np.ndarray:
    """[..., patl] codes -> uint32 [kw, ...] MSB-first words, the tail of
    the last word random (verify_windows' words hold the next text bases
    there)."""
    shape, patl = bases.shape[:-1], bases.shape[-1]
    full = rng.integers(0, 4, shape + (kw * 16,)).astype(np.uint32)
    full[..., :patl] = bases
    full = full.reshape(shape + (kw, 16))
    shifts = (2 * (15 - np.arange(16))).astype(np.uint32)
    words = np.bitwise_or.reduce(full << shifts, axis=-1)
    return np.moveaxis(words, -1, 0).astype(np.uint32)


def plain_scores(tw, codes, quals, inv, ll) -> np.ndarray:
    """The lanes' scores summed base by base in f64 (numpy), as the step
    sums them; the random cases seed their states' scores with them."""
    kw, B, L = tw.shape
    patl = codes.shape[1]
    shifts = (2 * (15 - np.arange(16))).astype(np.uint32)
    ref = ((np.moveaxis(tw, 0, -1)[..., None] >> shifts) & 3) \
        .reshape(B, L, kw * 16)[..., :patl].astype(np.int64)
    c = codes.astype(np.int64) & 3
    q = np.full(codes.shape, 30, np.int64) if quals is None \
        else np.clip(quals.astype(np.int64), 0, 63)
    pat = np.where(inv[..., None], (3 - c[:, ::-1])[:, None, :],
                   c[:, None, :])
    qq = np.where(inv[..., None], q[:, ::-1][:, None, :], q[:, None, :])
    contrib = ll[(ref << 8) | (pat << 6) | qq]
    total = np.ones((B, L), np.float64)
    for i in range(patl):
        total = total + contrib[..., i]
    return total.astype(np.float32)


def random_case(seed: int, B: int, L: int, patl: int, *, score: bool,
                fold: bool, scores: bool = True, fasta: bool = False,
                with_n: bool = False, fileid: int = 1) -> ScoreFoldCase:
    """Lanes as a step makes them: each lane's window is its read (or the
    read's reverse complement on an inv lane) with 0-4 mismatches, so
    that lanes of a read often score alike; qualities run past both ends
    of 0..63. `with_n` puts N (4) in 4% of the codes: a read with N is
    never valid, and the port scores its N as code & 3 where real_tpu's
    straight lanes index past the base's entries, so only the port's two
    versions are compared on such reads. States: fresh, or a hit, a tie
    or a gapped read at a lane's locus or elsewhere, from this file or
    the last, scored at a lane's score, within eps of it or outside."""
    rng = np.random.default_rng(seed)
    kw = (patl + 15) // 16
    n_share = 0.04 if with_n else 0.0
    codes = rng.choice(5, (B, patl), p=[(1 - n_share) / 4] * 4 + [n_share]) \
        .astype(np.uint8)
    quals = None if fasta else rng.integers(-3, 72, (B, patl)) \
        .astype(np.int8)
    inv = rng.random((B, L)) < 0.5
    c = codes.astype(np.int64) & 3
    win = np.where(inv[..., None], (3 - c[:, ::-1])[:, None, :],
                   c[:, None, :]).astype(np.uint32)
    for m in range(1, 5):
        hit = rng.random((B, L)) < 0.2
        at = rng.integers(0, patl, (B, L))
        b, j = np.nonzero(hit)
        win[b, j, at[b, j]] = (win[b, j, at[b, j]]
                               + rng.integers(1, 4, len(b))) % 4
    tw = _pack_words(win, kw, rng)
    eps = np.float32(5 / 70.0 * patl)
    lanes = {"valid": rng.random((B, L)) < 0.7, "inv": inv,
             "pos": rng.integers(0, 6, (B, L)).astype(np.int32),
             "frag": rng.integers(0, 2, (B, L)).astype(np.int32),
             "k": rng.integers(0, 6, (B, L)).astype(np.int32)}
    lane_scores = plain_scores(tw, codes, quals, inv, ll_table())
    lanes["score"] = lane_scores if not score else \
        np.zeros((B, L), np.float32)
    state = None
    if fold:
        pick = lane_scores[np.arange(B), rng.integers(0, L, B)]
        nudge = rng.choice(np.array([0.0, 0.5, -0.5, 1.0, -1.0, 2.0],
                                    np.float32), B) * eps
        sc = np.where(rng.random(B) < 0.2, -FLT_MAX,
                      (pick + nudge).astype(np.float32))
        state = {"st": rng.choice(5, B, p=[0.3, 0.25, 0.2, 0.05, 0.2])
                 .astype(np.int32),
                 "pos": rng.integers(0, 6, B).astype(np.int32),
                 "frag": rng.integers(0, 2, B).astype(np.int32),
                 "fileid": rng.integers(fileid - 1, fileid + 1, B)
                 .astype(np.int32),
                 "errs": rng.integers(0, 6, B).astype(np.int32),
                 "score": sc.astype(np.float32)}
    return ScoreFoldCase(
        f"random_B{B}_L{L}_patl{patl}_{'score' if score else ''}"
        f"{'fold' if fold else ''}{'' if scores else '_k'}"
        f"{'_fasta' if fasta else ''}{'_n' if with_n else ''}",
        lanes, tw if score else None, codes if score else None,
        quals if score else None, state, fileid, eps, scores)


def torch_inputs(case: ScoreFoldCase, device):
    """(Survivors, MatchState or None, score_fold's keyword arguments) of a
    case as tensors on `device`."""
    import torch

    from real_tpu_torch.engine.matchstep import MatchState, Survivors

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    B = case.lanes["valid"].shape[0]
    surv = Survivors(*(t(case.lanes[f]) for f in LANE_FIELDS),
                     overflow=torch.zeros(B, dtype=torch.bool,
                                          device=device))
    state = None if case.state is None else \
        MatchState(*(t(case.state[f]) for f in STATE_FIELDS))
    kw = dict(fileid=case.fileid, epsilon=float(case.epsilon),
              scores=case.scores)
    if case.tw is not None:
        kw.update(tw=t(case.tw.view(np.int32)), codes=t(case.codes),
                  quals=None if case.quals is None else t(case.quals),
                  tables=scoring.score_tables(scoring.Scoring()))
    return surv, state, kw
