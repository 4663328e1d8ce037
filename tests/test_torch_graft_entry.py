"""The port's driver entry points (real_tpu_torch/tools/graft_entry.py)
against the JAX package's (__graft_entry__.py): entry()'s match step
equals real_tpu's match_step (score_mode "f64") on the same example
inputs and index, exactly; dryrun_multichip over n CPU cells prints the
one-device records of both modes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_tpu.engine import matchstep as j_ms
from real_tpu.scoring import scoring as j_scoring
from real_tpu.text import packed as j_packed
from real_tpu_torch import convert
from real_tpu_torch.engine import matchstep as t_ms
from real_tpu_torch.tools import graft_entry


def test_entry_equals_real_tpus_match_step():
    fn, args = graft_entry.entry("cpu")
    (sig, pos, bb, words, _, _, frag_offsets, mat, quals, valid, state,
     fileid, eps) = args
    assert mat.shape == (256, 80) and words.device.type == "cpu"
    assert frag_offsets.numel() == 3             # two fragments
    ts, tsurv = fn(*args)

    # real_tpu on the same text and the same index (carried across)
    from real_tpu_torch.io import fasta
    from real_tpu_torch.tools import simulate
    codes, ranges = fasta.parse_genome_bytes(np.frombuffer(
        simulate.random_genome(8192, seed=3, num_fragments=2).encode(),
        np.uint8))
    jt = j_packed.build_packed_text(codes, ranges)
    np.testing.assert_array_equal(np.asarray(jt.words).view(np.int32),
                                  words.numpy())
    ji = convert.index_to_numpy(_index(sig, pos, bb))
    js, jsurv = j_ms.match_step(
        jnp.asarray(ji["sig"]), jnp.asarray(ji["pos"]), jnp.asarray(ji["bb"]),
        jt.words, jt.nbits, jt.ncum, jt.frag_offsets,
        jnp.asarray(mat.numpy()), jnp.asarray(quals.numpy()),
        jnp.asarray(valid.numpy()), j_ms.initial_state(256),
        jnp.int32(fileid), eps, tables=j_scoring.score_tables(
            j_scoring.Scoring()), seedl=32, seedkmax=2, totalkmax=5,
        cand_cap=32, survivor_cap=32, scores=True, score_mode="f64",
        matchall=False, bsearch_steps=4, text_has_n=jt.has_n)
    for f in t_ms.MatchState._fields:
        a, b = np.asarray(getattr(js, f)), getattr(ts, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    jv = np.asarray(jsurv.valid)
    np.testing.assert_array_equal(jv, tsurv.valid.numpy())
    for f in ("inv", "pos", "frag", "k", "score"):
        np.testing.assert_array_equal(np.asarray(getattr(jsurv, f))[jv],
                                      getattr(tsurv, f).numpy()[jv],
                                      err_msg=f)
    st = ts.st.numpy()
    assert (st == t_ms.STRAIGHT).sum() > 64 and (st == t_ms.REVERSE).sum() > 64


def _index(sig, pos, bb):
    """The example's index as a SignatureIndex (its bucket width read
    back from the table)."""
    from real_tpu_torch.index.build import SignatureIndex
    nbuck = bb.shape[0] // 6
    return SignatureIndex(sig=sig, pos=pos, bb=bb, seedl=32,
                          bucket_bits=(nbuck - 1).bit_length() - 1)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_dryrun_multichip_prints_the_one_device_records(n, capsys):
    unique, every = graft_entry.dryrun_multichip(n, ["cpu"] * n)
    out = capsys.readouterr().out
    assert f"dryrun_multichip({n}): cells {' '.join(['cpu'] * n)}" in out
    want_u, want_a, matched, hits = graft_entry._dry_records(
        "cpu", None, 2 if n % 2 == 0 else 1)
    assert unique == want_u and every == want_a
    assert matched > 0 and hits >= matched
    assert unique.count("\n") == matched


def test_dryrun_multichip_names_its_cells():
    with pytest.raises(ValueError, match="2 cells named for 4"):
        graft_entry.dryrun_multichip(4, ["cpu", "cpu"])


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        graft_entry.dryrun_multichip(1)
