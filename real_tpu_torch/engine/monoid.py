"""Algebraic structure of the best-hit merge (UpdateUniqueInfo), the port's
copy of real_tpu/engine/monoid.py: what makes folding index shards that
run on several ranks legal (parallel/mesh.py), stated on one read.

The reference folds candidate hits one at a time into a per-read
UniqueMatchInfo (matchUniqueImplementation.cpp:97-160 no-scores,
:179-248 scores). Spreading that fold over index shards is legal only
where folding a concatenated hit sequence equals merging the states
folded from its parts. This module states what holds and what does not.

NO-SCORES MODE: associative, left-biased; commutative on disjoint loci.
  A state in {NoMatch} u {Hit(pos, k, strand)} u {NonUnique(k)}
  summarises a hit sequence by (k_min, witness locus and strand, more
  than one locus at k_min). Merging two summaries:
    * different k_min          -> the smaller-k summary wins outright;
    * equal k_min, same locus  -> the LEFT summary's strand wins (the same
                                  locus can be reported by several probe
                                  lists and, for palindromic reads, by
                                  both strands at equal k; the reference's
                                  `diff` test keeps the first strand it
                                  met, matchUniqueImplementation.cpp:
                                  131-139);
    * equal k_min, diff locus  -> NonUnique(k_min);
    * NonUnique at equal k     -> NonUnique absorbs.
  This is an associative monoid with identity NoMatch whose left bias
  reproduces the sequential fold's first-strand-wins rule, so an ordered
  (shard-major) tree reduction would be legal. It is not commutative in
  general (merge(Straight@p, Reverse@p) != merge(Reverse@p, Straight@p)),
  but each locus lives in exactly one index shard (shards are disjoint
  window ranges, and both strands of a locus are probed in the shard that
  owns it), so states merged across shards carry disjoint witness loci,
  on which merge is commutative. Once NonUnique, the witness is lost and
  "same locus" can no longer be tested, as in the reference (NonUnique
  stores no position); a strictly better (smaller-k) hit resurrects
  uniqueness in both (matchUniqueImplementation.cpp:146-157).

SCORES MODE: not associative (the order matters inside the epsilon window).
  `better = s_new > s_old + eps`, `tie = !better && s_new > s_old - eps`:
  a chain of hits each within eps of the previous can drift so that the
  outcome depends on the order met (s1=0, s2=eps*0.9, s3=eps*1.8: the
  order (s1,s2,s3) gives NonUnique at s2, then s3 resurrects it as
  better; (s1,s3,s2) gives Hit(s3), then a tie with s2 -> NonUnique). The
  reference is therefore order-DEFINED, not order-free: probes run list
  0..5 straight then reverse, candidates in ascending sorted-list order,
  text blocks in ascending position order (matchUniqueImplementation.cpp:
  416-488, :1253). A cross-shard merge in scores mode must replay that
  order: parallel/mesh.py all-gathers the survivors over a shard row and
  folds them shard-major (merge_shard_major), which is the reference's
  block-major order. Never replace it with a reduce.

Both modes are homomorphic under ordered concatenation: fold(xs ++ ys) ==
fold_from(fold(xs), ys). That weaker property is what the sequential shard
loop and the ordered gather-fold rely on; it holds by construction (the
fold never looks back at consumed hits).

EARLY-EXIT LEMMA. The reference skips straight lists 1..5 when list 0
left state == Straight with 0 errors (and likewise reverse lists 1..5
after list-0-reverse; matchUniqueImplementation.cpp:434-436, 470-472;
scores mode never skips). That is an optimisation, not a difference of
meaning, so a fold over all 12 probes' candidates is observably equal: a
skipped candidate could change a 0-error unique state only through `take`
(needs k < 0, impossible) or `tie` (needs k == 0, an exact whole-window
duplicate, which shares all six pair signatures and so already appeared
in list 0's equal range of the same strand, where it was processed).
List 0 of both strands always runs, so exact reverse (palindromic)
duplicates are seen too.

tests/test_torch_monoid.py holds these functions against real_tpu's and
against the device fold (engine/matchstep.py fold_unique), and carries the
non-associativity witness.
"""

from __future__ import annotations

import dataclasses

NO_MATCH, STRAIGHT, REVERSE, GAPPED, NON_UNIQUE = 0, 1, 2, 3, 4


@dataclasses.dataclass(frozen=True)
class State:
    """One read's MatchState row (engine/matchstep.py) on the host."""
    st: int = NO_MATCH
    pos: int = 0
    frag: int = 0
    fileid: int = 0
    errs: int = 0


@dataclasses.dataclass(frozen=True)
class Hit:
    pos: int
    frag: int
    fileid: int
    k: int
    inv: bool = False


def fold_hit(s: State, h: Hit) -> State:
    """The reference's no-scores automaton, one step
    (matchUniqueImplementation.cpp:97-160); matchstep.fold_unique with
    scores=False does it for a whole batch."""
    is_open = s.st in (NO_MATCH, GAPPED)
    is_hit = s.st in (STRAIGHT, REVERSE)
    is_nu = s.st == NON_UNIQUE
    diff = (h.pos != s.pos or h.frag != s.frag or h.fileid != s.fileid)
    better = h.k < s.errs
    take = is_open or ((is_hit or is_nu) and better)
    tie = is_hit and h.k == s.errs and diff
    if take:
        return State(REVERSE if h.inv else STRAIGHT,
                     h.pos, h.frag, h.fileid, h.k)
    if tie:
        return State(NON_UNIQUE, s.pos, s.frag, s.fileid, s.errs)
    return State(s.st, s.pos, s.frag, s.fileid, s.errs)


def fold_hits(s: State, hits) -> State:
    for h in hits:
        s = fold_hit(s, h)
    return s


@dataclasses.dataclass(frozen=True)
class ScoreState(State):
    # -FLT_MAX (UniqueMatchInfo.hpp:191)
    score: float = -3.4028234663852886e38


@dataclasses.dataclass(frozen=True)
class ScoreHit(Hit):
    score: float = 0.0


def fold_hit_scores(s: ScoreState, h: ScoreHit, eps: float) -> ScoreState:
    """The reference's scores automaton, one step
    (matchUniqueImplementation.cpp:179-248); matchstep.fold_unique with
    scores=True does it for a whole batch."""
    is_open = s.st in (NO_MATCH, GAPPED)
    is_hit = s.st in (STRAIGHT, REVERSE)
    is_nu = s.st == NON_UNIQUE
    diff = (h.pos != s.pos or h.frag != s.frag or h.fileid != s.fileid)
    better = h.score > s.score + eps
    within = h.score > s.score - eps
    take = is_open or ((is_hit or is_nu) and better)
    tie = is_hit and not better and within and diff
    if take:
        return ScoreState(REVERSE if h.inv else STRAIGHT,
                          h.pos, h.frag, h.fileid, h.k, h.score)
    if tie:
        return ScoreState(NON_UNIQUE, s.pos, s.frag, s.fileid, s.errs,
                          s.score)
    return s


def observable(s: State):
    """What the output pass can see: unique states print (pos, frag,
    fileid, errs[, score]); NonUnique and NoMatch print nothing."""
    if s.st in (STRAIGHT, REVERSE):
        return (s.st, s.pos, s.frag, s.fileid, s.errs,
                getattr(s, "score", None))
    return (s.st,)


def merge_states(a: State, b: State) -> State:
    """The associative merge of two independently folded no-scores states
    (left-biased; commutative on disjoint loci). Identity: NoMatch."""
    if b.st in (NO_MATCH, GAPPED):
        return a
    if a.st in (NO_MATCH, GAPPED):
        return b
    # both carry hits (unique or non-unique)
    if a.errs != b.errs:
        return a if a.errs < b.errs else b
    a_hit = a.st in (STRAIGHT, REVERSE)
    b_hit = b.st in (STRAIGHT, REVERSE)
    if a_hit and b_hit:
        if (a.pos, a.frag, a.fileid) == (b.pos, b.frag, b.fileid):
            return a
        return State(NON_UNIQUE, a.pos, a.frag, a.fileid, a.errs)
    # at least one NonUnique at the same (minimal) k absorbs
    nu = a if not a_hit else b
    return State(NON_UNIQUE, nu.pos, nu.frag, nu.fileid, nu.errs)
