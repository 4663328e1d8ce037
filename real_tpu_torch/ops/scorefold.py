"""Score a step's survivor lanes and fold them into each read's best hit
(K4, csrc/score_fold.cu), in one launch.

`score_fold(surv, state, tw=..., ...)` runs up to two halves, chosen by
what the call site passes:

  score  (tw given) each lane's score, f32(1.0 + sum_i LL[ref, pat, q])
         summed in f64 in base order: engine/matchstep.py score_survivors
  fold   (state given) the UpdateUniqueInfo automaton over each read's
         lanes in lane order, on scores (scores=True) or on mismatch
         counts: engine/matchstep.py fold_unique

The one-device matchUnique step scores and folds (or only folds, without
scores), matchAll and the mesh's per-shard steps only score, the mesh's
shard-major merge only folds. On CUDA tensors every call is one launch of
the kernel, counted in score_fold.launches (ops/gather.py launch_counts),
or raises; CPU tensors take the plain loops in engine/matchstep.py, which
stay the reference.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from real_tpu_torch.ops import cuda_build

KERNEL = "score_fold"

_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_ARGTYPES = ([_P] * 6 + [_I64, _INT]
             + [_P, _INT, _INT, _P, _I64, _P, _I64, _P, _P]
             + [_P] * 12 + [_INT, ctypes.c_float, _INT, _P])
_LANES = (("valid", torch.bool), ("inv", torch.bool), ("pos", torch.int32),
          ("frag", torch.int32), ("k", torch.int32), ("score", torch.float32))
_STATE = (("st", torch.int32), ("pos", torch.int32), ("frag", torch.int32),
          ("fileid", torch.int32), ("errs", torch.int32),
          ("score", torch.float32))


def _require(name: str, what: str, t: torch.Tensor, dtype, shape) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise TypeError(f"{name}: {what} must be {dtype} {tuple(shape)}, "
                        f"got {t.dtype} {tuple(t.shape)}")


def _rows(name: str, what: str, t: torch.Tensor, dtype, shape):
    """A [B, patl] read table as the kernel takes it: unit stride along
    a row, any row stride (the batch's codes are a slice of wider rows)."""
    _require(name, what, t, dtype, shape)
    if t.stride(1) != 1:
        t = t.contiguous()
    return t, t.stride(0)


def score_fold(surv, state=None, *, tw=None, codes=None, quals=None,
               tables=None, fileid: int = 0, epsilon: float = 0.0,
               scores: bool = True):
    """The lanes of `surv` (engine/matchstep.py Survivors, [B, L]) scored
    and/or folded into `state` (MatchState, [B]).

    tw int32 [kw, B, L] (verify_windows' window words), codes uint8 [B,
    patl], quals int8 [B, patl] or None (FASTA's constant 30) and tables
    (ScoreTables) turn the score half on; state turns the fold half on,
    over scores when `scores`, else over the lanes' mismatch counts k.
    Returns (surv with its lanes' scores when scored, else surv as given;
    the folded state, or None without state)."""
    name = "score_fold"
    if tw is None and state is None:
        raise ValueError(f"{name}: neither tw (score) nor state (fold)")
    if tw is not None and not scores:
        raise ValueError(f"{name}: scoring needs scores=True")
    tensors = [*surv[:-1]]
    if tw is not None:
        tensors += [tw, codes] + ([] if quals is None else [quals])
    if state is not None:
        tensors += [*state]
    if cuda_build.all_on_cpu(name, *tensors):
        from real_tpu_torch.engine import matchstep
        if tw is not None:
            surv = matchstep.score_survivors(surv, tw, codes, quals, tables)
        if state is not None:
            state = matchstep.fold_unique(state, surv, fileid, epsilon,
                                          scores=scores)
        return surv, state

    if surv.valid.dim() != 2:
        raise ValueError(f"{name}: lanes must be [B, L], got "
                         f"{tuple(surv.valid.shape)}")
    B, L = surv.valid.shape
    dev = surv.valid.device
    lanes = []
    for f, dtype in _LANES:
        t = getattr(surv, f)
        _require(name, f"surv.{f}", t, dtype, (B, L))
        lanes.append(t.contiguous())
    null = ctypes.c_void_p(None)
    score_args = [null, 0, 0, null, 0, null, 0, null, null]
    if tw is not None:
        patl = codes.shape[1] if codes.dim() == 2 else 0
        if patl < 1:
            raise ValueError(f"{name}: codes must be [B, patl >= 1], got "
                             f"{tuple(codes.shape)}")
        kw = (patl + 15) // 16
        _require(name, "tw", tw, torch.int32, (kw, B, L))
        codes, cstride = _rows(name, "codes", codes, torch.uint8, (B, patl))
        q_ptr, qstride = null, 0
        if quals is not None:
            quals, qstride = _rows(name, "quals", quals, torch.int8,
                                   (B, patl))
            q_ptr = quals.data_ptr()
        tw = tw.contiguous()
        ll = tables.ll_on(dev)
        score = torch.empty((B, L), dtype=torch.float32, device=dev)
        score_args = [tw.data_ptr(), kw, patl, codes.data_ptr(), cstride,
                      q_ptr, qstride, ll.data_ptr(), score.data_ptr()]
        surv = surv._replace(score=score)
    state_args = [null] * 12
    if state is not None:
        ins, outs = [], []
        for f, dtype in _STATE:
            t = getattr(state, f)
            _require(name, f"state.{f}", t, dtype, (B,))
            ins.append(t.contiguous())
            outs.append(torch.empty_like(ins[-1]))
        state_args = [t.data_ptr() for t in ins + outs]
        state = type(state)(*outs)
    if B:
        cuda_build.launch(
            KERNEL, "score_fold", _ARGTYPES, dev,
            *(t.data_ptr() for t in lanes), B, L, *score_args, *state_args,
            int(fileid), float(np.float32(epsilon)), int(scores))
        score_fold.launches += 1
    return surv, state


# launches since the last reset, read and reset with the match's other
# kernels by ops/gather.py launch_counts and reset_launch_counts
# (-metrics kernel_launches)
score_fold.launches = 0
