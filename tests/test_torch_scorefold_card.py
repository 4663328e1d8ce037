"""The score and fold's CUDA kernel (real_tpu_torch/csrc/score_fold.cu
through ops/scorefold.py, K4) against its plain loops (engine/matchstep.py
score_survivors and fold_unique, run on the same inputs on the CPU), bit
for bit: every lane's score and every MatchState field, on the crafted
fold rows of tools/scorefoldcases.py and random lanes at every survivor
cap and read length of the main path, each half alone and both, with
FASTQ and FASTA reads, one launch a call. Skipped without a card; no JAX
here."""

import numpy as np
import pytest
import torch

from real_tpu_torch.ops import scorefold
from real_tpu_torch.tools import scorefoldcases as cases

SHAPES = [(4096, 8), (512, 128), (64, 2048)]
PATLS = [32, 50, 75, 100, 150]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _check(case: cases.ScoreFoldCase, dev, strided_codes=False) -> None:
    surv, state, kw = cases.torch_inputs(case, dev)
    if strided_codes and "codes" in kw:
        # the batch's codes are a [B, patl] slice of rows of kw * 16 bases
        B, patl = kw["codes"].shape
        wide = torch.zeros((B, -(-patl // 16) * 16), dtype=torch.uint8,
                           device=dev)
        wide[:, :patl] = kw["codes"]
        kw["codes"] = wide[:, :patl]
    before = scorefold.score_fold.launches
    got_surv, got_state = scorefold.score_fold(surv, state, **kw)
    torch.cuda.synchronize()
    assert scorefold.score_fold.launches == before + 1
    c_surv, c_state, c_kw = cases.torch_inputs(case, "cpu")
    want_surv, want_state = scorefold.score_fold(c_surv, c_state, **c_kw)
    assert got_surv.score.device.type == "cuda"
    np.testing.assert_array_equal(
        want_surv.score.numpy().view(np.int32),
        got_surv.score.cpu().numpy().view(np.int32), err_msg="score")
    assert (got_state is None) == (want_state is None)
    if want_state is not None:
        for f, a, b in zip(want_state._fields, want_state, got_state):
            assert a.dtype == b.dtype and b.device.type == "cuda", f
            np.testing.assert_array_equal(a.numpy().view(np.int32),
                                          b.cpu().numpy().view(np.int32),
                                          err_msg=f)


@pytest.mark.cuda
@pytest.mark.parametrize("case", cases.crafted_cases(),
                         ids=lambda c: c.name)
def test_kernel_equals_plain_loops_on_crafted_rows(cuda_device, case):
    _check(case, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("halves", ["scorefold", "score", "fold_k"])
@pytest.mark.parametrize("patl", PATLS)
@pytest.mark.parametrize("B,S", SHAPES)
def test_kernel_equals_plain_loops(cuda_device, B, S, patl, halves):
    """FASTA on two read lengths, N codes on two others; the codes as the
    batch holds them (strided rows) on every other case."""
    case = cases.random_case(
        B + S + patl, B, S, patl, score=halves != "fold_k",
        fold=halves != "score", scores=halves != "fold_k",
        fasta=patl in (50, 100), with_n=patl in (32, 75))
    _check(case, cuda_device, strided_codes=patl in (75, 150))


@pytest.mark.cuda
@pytest.mark.parametrize("scores", [True, False], ids=["scores", "k"])
@pytest.mark.parametrize("n_shard,S", [(2, 8), (3, 8), (4, 128)])
def test_kernel_folds_shard_major_lanes(cuda_device, n_shard, S, scores):
    """The mesh's merge: n_shard * S lanes folded alone."""
    _check(cases.random_case(n_shard * S + scores, 1024, n_shard * S, 75,
                             score=False, fold=True, scores=scores),
           cuda_device)
