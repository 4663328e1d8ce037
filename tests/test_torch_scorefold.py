"""The score and fold's wrapper (real_tpu_torch/ops/scorefold.py) on the
CPU: its plain loops (engine/matchstep.py score_survivors and
fold_unique) against real_tpu's (score_mode "f64") on the cases of
tools/scorefoldcases.py, the crafted fold rows' intended states, and the
dispatch rule: CPU tensors take the plain loops and launch nothing.
Exact: scores as f32 bit patterns, every MatchState field."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_tpu.engine import matchstep as j_ms
from real_tpu.scoring import scoring as j_scoring
from real_tpu_torch.engine import matchstep as t_ms
from real_tpu_torch.ops import gather, scorefold
from real_tpu_torch.tools import scorefoldcases as cases

# (B, S): 2,048 lanes a case at each survivor cap of the main path and the
# rerun ladder
SHAPES = [(256, 8), (16, 128), (1, 2048)]
PATLS = [32, 50, 75, 100, 150]


def _real_tpu(case: cases.ScoreFoldCase):
    """real_tpu's score_survivors then fold_unique on the case's numpy
    inputs: (scores f32 [B, L], MatchState of numpy arrays or None)."""
    lanes = {f: jnp.asarray(case.lanes[f]) for f in cases.LANE_FIELDS}
    B = case.lanes["valid"].shape[0]
    surv = j_ms.Survivors(**lanes, overflow=jnp.zeros(B, bool))
    if case.tw is not None:
        quals = case.quals if case.quals is not None \
            else np.full(case.codes.shape, 30, np.int8)
        surv = j_ms.score_survivors(
            surv, [jnp.asarray(w) for w in case.tw],
            jnp.asarray(case.codes), jnp.asarray(quals),
            j_scoring.score_tables(j_scoring.Scoring()), score_mode="f64")
    state = None
    if case.state is not None:
        st = j_ms.MatchState(**{f: jnp.asarray(case.state[f])
                                for f in cases.STATE_FIELDS})
        state = j_ms.fold_unique(st, surv, case.fileid, case.epsilon,
                                 scores=case.scores)
        state = [np.asarray(a) for a in state]
    return np.asarray(surv.score), state


def _port(case: cases.ScoreFoldCase):
    """The port's wrapper on CPU tensors: the plain loops."""
    surv, state, kw = cases.torch_inputs(case, "cpu")
    before = gather.launch_counts()["score_fold"]
    surv, state = scorefold.score_fold(surv, state, **kw)
    assert gather.launch_counts()["score_fold"] == before == 0
    return surv.score.numpy(), \
        None if state is None else [t.numpy() for t in state]


def _assert_same(case: cases.ScoreFoldCase) -> None:
    want_score, want_state = _real_tpu(case)
    got_score, got_state = _port(case)
    np.testing.assert_array_equal(want_score.view(np.int32),
                                  got_score.view(np.int32))
    assert (want_state is None) == (got_state is None)
    if want_state is not None:
        for f, a, b in zip(cases.STATE_FIELDS, want_state, got_state):
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32),
                                          err_msg=f)


@pytest.mark.parametrize("case", cases.crafted_cases(),
                         ids=lambda c: c.name)
def test_crafted_fold_rows_equal_real_tpu(case):
    _assert_same(case)
    _, state = _real_tpu(case)
    for b, (row, st) in enumerate(cases.crafted_expectations(case)):
        assert state[0][b] == st, row
    if not case.scores:
        np.testing.assert_array_equal(state[5], case.state["score"])


@pytest.mark.parametrize("patl", PATLS)
@pytest.mark.parametrize("B,S", SHAPES)
def test_score_and_fold_equal_real_tpu(B, S, patl):
    """Both halves, FASTQ and FASTA alternating with the read length."""
    _assert_same(cases.random_case(B * S + patl, B, S, patl, score=True,
                                   fold=True, fasta=patl in (50, 100)))


@pytest.mark.parametrize("scores", [True, False], ids=["scores", "k"])
@pytest.mark.parametrize("n_shard", [1, 3])
def test_fold_alone_equals_real_tpu(n_shard, scores):
    """The mesh's shard-major merge folds n_shard * S lanes alone."""
    _assert_same(cases.random_case(n_shard * 10 + scores, 512, 8 * n_shard,
                                   75, score=False, fold=True,
                                   scores=scores))


def test_score_alone_equals_real_tpu_and_numpy():
    case = cases.random_case(3, 64, 128, 75, score=True, fold=False)
    _assert_same(case)
    got, _ = _port(case)
    want = cases.plain_scores(case.tw, case.codes, case.quals,
                              case.lanes["inv"], cases.ll_table())
    np.testing.assert_array_equal(want.view(np.int32), got.view(np.int32))


def test_wrapper_refuses_what_it_cannot_run():
    case = cases.random_case(4, 8, 8, 50, score=True, fold=True)
    surv, state, kw = cases.torch_inputs(case, "cpu")
    with pytest.raises(ValueError, match="neither"):
        scorefold.score_fold(surv)
    with pytest.raises(ValueError, match="scores=True"):
        scorefold.score_fold(surv, state, **{**kw, "scores": False})
    meta = state._replace(st=torch.empty(8, dtype=torch.int32,
                                         device="meta"))
    with pytest.raises(ValueError, match="one CUDA device"):
        scorefold.score_fold(surv, meta, **kw)
    assert gather.launch_counts()["score_fold"] == 0


def test_match_step_on_the_cpu_launches_nothing():
    """A CPU match step scores and folds through the plain loops: the
    wrapper's count stays 0 and equals the plain loops called directly."""
    case = cases.random_case(5, 64, 8, 75, score=True, fold=True)
    surv, state, kw = cases.torch_inputs(case, "cpu")
    gather.reset_launch_counts()
    got_surv, got_state = scorefold.score_fold(surv, state, **kw)
    want_surv = t_ms.score_survivors(surv, kw["tw"], kw["codes"],
                                     kw["quals"], kw["tables"])
    want_state = t_ms.fold_unique(state, want_surv, kw["fileid"],
                                  kw["epsilon"], scores=True)
    assert torch.equal(got_surv.score, want_surv.score)
    for a, b in zip(got_state, want_state):
        assert torch.equal(a, b)
    assert gather.launch_counts()["score_fold"] == 0
