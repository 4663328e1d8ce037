"""The best-hit merge algebra behind the port's fold
(real_tpu_torch/engine/monoid.py, the port's copy of
real_tpu/engine/monoid.py, whose docstrings carry the proofs): the
legality argument for folding index shards that run on several ranks
(parallel/mesh.py). Every function of the port's module equals
real_tpu's on random states and hits, and this file pins its three
results on the port's side, against the port's device fold:

* no-scores mode: merging independently folded shard states in shard
  order equals the sequential fold (an associative, left-biased monoid;
  shards hold disjoint loci);
* scores mode is order-DEFINED, not associative: a concrete witness, so
  that nobody turns a scored cross-shard merge into an unordered reduce;
* the early-exit lemma: the reference's skip of lists 1..5 after an exact
  list-0 hit is unobservable, which is why the port's fold over all
  survivors (engine/matchstep.py fold_unique) equals the host automaton
  row by row.

Exact."""

import random

import numpy as np
import pytest
import torch

from real_tpu.engine import monoid as j_monoid
from real_tpu_torch.engine.matchstep import (MatchState, Survivors,
                                             fold_unique, initial_state)
from real_tpu_torch.engine.monoid import (NON_UNIQUE, STRAIGHT, Hit,
                                          ScoreHit, ScoreState, State,
                                          fold_hit, fold_hit_scores,
                                          fold_hits, merge_states,
                                          observable)


def random_hits(rng, n, npos=4, kmax=4, pos_base=0, scored=False):
    """Random hits over a small locus universe; with `scored`, scores on a
    1/8 grid (exact in float32 and float64 alike)."""
    out = []
    for _ in range(n):
        kw = dict(pos=pos_base + rng.randrange(npos), frag=rng.randrange(2),
                  fileid=rng.randrange(2), k=rng.randrange(kmax),
                  inv=bool(rng.randrange(2)))
        out.append(ScoreHit(score=rng.randrange(-16, 17) / 8, **kw)
                   if scored else Hit(**kw))
    return out


def _as_real_tpus(x):
    """The same state or hit as real_tpu's dataclass."""
    return getattr(j_monoid, type(x).__name__)(**vars(x))


def random_state(rng, scored=False):
    kw = dict(st=rng.randrange(5), pos=rng.randrange(4),
              frag=rng.randrange(2), fileid=rng.randrange(2),
              errs=rng.randrange(4))
    return (ScoreState(score=rng.randrange(-16, 17) / 8, **kw) if scored
            else State(**kw))


def test_every_function_equals_real_tpus():
    """fold_hit, fold_hit_scores, fold_hits, merge_states and observable
    of the port's module give real_tpu's results on random inputs."""
    rng = random.Random(3)
    for _ in range(2000):
        s, t = random_state(rng), random_state(rng)
        h = random_hits(rng, 1)[0]
        assert _as_real_tpus(fold_hit(s, h)) \
            == j_monoid.fold_hit(_as_real_tpus(s), _as_real_tpus(h))
        assert _as_real_tpus(merge_states(s, t)) == j_monoid.merge_states(
            _as_real_tpus(s), _as_real_tpus(t))
        assert observable(s) == j_monoid.observable(_as_real_tpus(s))
        hs = random_hits(rng, rng.randrange(6))
        assert _as_real_tpus(fold_hits(s, hs)) == j_monoid.fold_hits(
            _as_real_tpus(s), [_as_real_tpus(h) for h in hs])
        ss, sh = random_state(rng, True), random_hits(rng, 1, scored=True)[0]
        eps = rng.choice((0.0, 0.25, 1.0))
        assert _as_real_tpus(fold_hit_scores(ss, sh, eps)) \
            == j_monoid.fold_hit_scores(_as_real_tpus(ss), _as_real_tpus(sh),
                                        eps)
    assert (j_monoid.NO_MATCH, j_monoid.STRAIGHT, j_monoid.NON_UNIQUE) \
        == (0, STRAIGHT, NON_UNIQUE)


def test_merge_equals_sequential_fold_over_random_splits():
    """Shards hold disjoint loci: merging the independently folded shard
    states in shard order equals folding all hits one after the other."""
    rng = random.Random(11)
    for _ in range(1500):
        nshard = rng.randrange(1, 5)
        shards = [random_hits(rng, rng.randrange(6), pos_base=100 * i)
                  for i in range(nshard)]
        seq = fold_hits(State(), [h for sh in shards for h in sh])
        merged = State()
        for sh in shards:
            merged = merge_states(merged, fold_hits(State(), sh))
        assert observable(merged) == observable(seq)


def test_scores_mode_is_not_associative():
    """The docstring's witness: inside the epsilon window the encounter
    order decides, so a scored cross-shard merge must replay the order."""
    eps = 1.0
    s1, s2, s3 = (ScoreHit(pos=p, frag=0, fileid=0, k=0, score=x)
                  for p, x in ((10, 0.0), (20, 0.9), (30, 1.8)))
    a = ScoreState()
    for h in (s1, s2, s3):
        a = fold_hit_scores(a, h, eps)
    b = ScoreState()
    for h in (s1, s3, s2):
        b = fold_hit_scores(b, h, eps)
    assert (a.st, a.pos) == (STRAIGHT, 30)
    assert b.st == NON_UNIQUE
    assert observable(a) != observable(b)


@pytest.mark.parametrize("scores", [False, True], ids=["noscores", "scores"])
def test_host_fold_equals_fold_unique_row_by_row(scores):
    """Two steps of fold_unique (file 0, then file 1) over random survivor
    lanes equal fold_hit / fold_hit_scores over each row's valid lanes."""
    rng = np.random.default_rng(5 + scores)
    B, S, eps = 400, 6, np.float32(0.25)
    state = initial_state(B, "cpu")
    lanes = []
    for fileid in (0, 1):
        valid = rng.random((B, S)) < 0.7
        surv = Survivors(
            valid=torch.from_numpy(valid),
            inv=torch.from_numpy(rng.random((B, S)) < 0.5),
            pos=torch.from_numpy(rng.integers(0, 4, (B, S), dtype=np.int32)),
            frag=torch.from_numpy(rng.integers(0, 2, (B, S),
                                               dtype=np.int32)),
            k=torch.from_numpy(rng.integers(0, 4, (B, S), dtype=np.int32)),
            score=torch.from_numpy(
                (rng.integers(-16, 17, (B, S)) / 8).astype(np.float32)),
            overflow=torch.zeros(B, dtype=torch.bool))
        state = fold_unique(state, surv, fileid, float(eps), scores=scores)
        lanes.append((fileid, surv))
    got = MatchState(*(t.numpy() for t in state))
    for r in range(B):
        s = ScoreState() if scores else State()
        for fileid, surv in lanes:
            for j in range(S):
                if not bool(surv.valid[r, j]):
                    continue
                kw = dict(pos=int(surv.pos[r, j]), frag=int(surv.frag[r, j]),
                          fileid=fileid, k=int(surv.k[r, j]),
                          inv=bool(surv.inv[r, j]))
                if scores:
                    s = fold_hit_scores(
                        s, ScoreHit(score=float(surv.score[r, j]), **kw),
                        float(eps))
                else:
                    s = fold_hit(s, Hit(**kw))
        row = (got.st[r], got.pos[r], got.frag[r], got.fileid[r],
               got.errs[r])
        assert row == (s.st, s.pos, s.frag, s.fileid, s.errs), r
        if scores:
            assert got.score[r] == np.float32(s.score)
