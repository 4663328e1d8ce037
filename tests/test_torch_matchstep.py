"""The port's match_step against real_tpu.engine.matchstep.match_step
(score_mode="f64") on identical inputs: the index built by real_tpu and
carried across with real_tpu_torch.convert, the same read batch.

MatchState must be equal exactly (scores too: both sides sum the same f64
LUT values in the same order and narrow to f32). Survivors are compared on
valid lanes (positions, strand, fragment, errors, scores exactly) and the
per-read overflow flags exactly."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_tpu.engine import matchstep as j_ms
from real_tpu.index import build as j_build
from real_tpu.scoring import scoring as j_scoring
from real_tpu.text import packed as j_packed
from real_tpu_torch import convert
from real_tpu_torch.engine import matchstep as t_ms
from real_tpu_torch.scoring import scoring as t_scoring
from real_tpu_torch.tools import simulate

B, PATL = 512, 100

CASES = {
    # genome n, n_prob, frags, bucket_bits, bsearch_steps, K, S, scores, quals
    "tiers_1_and_2": (20000, 0.0, 1, 12, 0, 8, 8, True, False),
    "lane_path_sparse_buckets": (20000, 0.0, 1, 0, 0, 8, 8, False, False),
    "bisection": (20000, 0.0, 1, 12, 8, 8, 8, True, True),
    "n_text_fragments": (24000, 0.003, 4, 0, 0, 8, 8, True, True),
    "n_text_bisection": (24000, 0.003, 4, 0, 12, 32, 32, False, False),
    "overflow_lanes": (20000, 0.0, 1, 12, 0, 2, 2, True, False),
    "overflow_bisect_unconverged": (20000, 0.0, 1, 12, 4, 2, 2, False,
                                    True),
}


def _inputs(n, n_prob, frags, seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, n).astype(np.uint8)
    if n_prob:
        codes[rng.random(n) < n_prob] = 4
    codes[5000:5300] = codes[9000:9300]          # a repeat: multi-hit reads
    per = n // frags
    ranges = [(f"f{i}", i * per) for i in range(frags)] + [("terminal", n)]
    rds = simulate.generate_reads(codes, B - 40, PATL, 0.03, False,
                                  seed=seed + 1)
    batch = np.zeros((B, PATL), np.uint8)
    for i, r in enumerate(rds):
        batch[i] = np.frombuffer(r.seq.encode(), np.uint8)
    lut = np.full(256, 4, np.uint8)
    for i, c in enumerate(b"ACGT"):
        lut[c] = i
    batch[:len(rds)] = lut[batch[:len(rds)]]
    valid = np.zeros(B, bool)
    valid[:len(rds)] = (batch[:len(rds)] <= 3).all(axis=1)
    quals = rng.integers(0, 45, (B, PATL)).astype(np.int8)
    return codes, ranges, batch, valid, quals


def _run_both(case, fileid_steps=(0, 1)):
    n, n_prob, frags, bits, steps, K, S, scores, use_q = CASES[case]
    codes, ranges, batch, valid, quals = _inputs(n, n_prob, frags, len(case))
    jt = j_packed.build_packed_text(codes, ranges)
    ji = j_build.build_index(jt, 32, bucket_bits=bits)
    fields = {f.name: getattr(jt, f.name) for f in dataclasses.fields(jt)}
    fields = {k: (np.asarray(v) if hasattr(v, "shape") else v)
              for k, v in fields.items()}
    tt = convert.packed_text_from_numpy(fields, "cpu")
    ti = convert.index_from_numpy(np.asarray(ji.sig), np.asarray(ji.pos),
                                  np.asarray(ji.bb), ji.bucket_bits, 32, "cpu")
    j_tables = j_scoring.score_tables(j_scoring.Scoring()) if scores else None
    t_tables = t_scoring.score_tables(t_scoring.Scoring()) if scores else None
    kw = dict(seedl=32, seedkmax=2, totalkmax=5, cand_cap=K, survivor_cap=S,
              scores=scores, bsearch_steps=steps, text_has_n=jt.has_n)
    eps = np.float32(0.02 * PATL * 5 / 70 * 1.0)
    q_j = jnp.asarray(quals) if use_q else None
    q_t = torch.from_numpy(quals) if use_q else None
    js, ts = j_ms.initial_state(B), t_ms.initial_state(B, "cpu")
    out = []
    for fid in fileid_steps:
        js, jsurv = j_ms.match_step(
            ji.sig, ji.pos, ji.bb, jt.words, jt.nbits, jt.ncum,
            jt.frag_offsets, jnp.asarray(batch), q_j, jnp.asarray(valid),
            js, jnp.int32(fid), eps, tables=j_tables, score_mode="f64",
            matchall=False, **kw)
        ts, tsurv = t_ms.match_step(
            ti.sig, ti.pos, ti.bb, tt.words, tt.nbits, tt.ncum,
            tt.frag_offsets, torch.from_numpy(batch), q_t,
            torch.from_numpy(valid), ts, fid, eps, tables=t_tables, **kw)
        out.append((js, jsurv, ts, tsurv))
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_match_step_equals_real_tpu(case):
    results = _run_both(case)
    for js, jsurv, ts, tsurv in results:
        for f in t_ms.MatchState._fields:
            a, b = np.asarray(getattr(js, f)), getattr(ts, f).numpy()
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        np.testing.assert_array_equal(np.asarray(jsurv.overflow),
                                      tsurv.overflow.numpy())
        jv = np.asarray(jsurv.valid)
        np.testing.assert_array_equal(jv, tsurv.valid.numpy())
        for f in ("inv", "pos", "frag", "k", "score"):
            np.testing.assert_array_equal(
                np.asarray(getattr(jsurv, f))[jv],
                getattr(tsurv, f).numpy()[jv], err_msg=f)
    # the case exercises what it is named for
    st0 = results[0][2].st.numpy()
    assert (st0 == t_ms.REVERSE).any() and (st0 == t_ms.STRAIGHT).any()
    # the second step (fileid 1, same index) ties every fileid-0 hit
    assert (results[-1][2].st.numpy() == t_ms.NON_UNIQUE).any()
    if case.startswith("overflow"):
        assert results[0][3].overflow.numpy().any()
