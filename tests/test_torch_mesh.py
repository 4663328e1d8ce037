"""Index shards across ranks (real_tpu_torch/parallel/mesh.py) held against
real_tpu's mesh (real_tpu/parallel/mesh.py sharded_match_step, on the CPU
mesh of 8 virtual devices that tests/conftest.py sets up), in one process:
every (dp, shard) cell runs the port's scored_survivors on its dp rows
(a batch's contiguous rows, as shard_map's P("dp") gives them) against its
own shard (build_sharded_index), and merge_shard_major folds each dp row's
cells as the row's gather would hand them over.

The setup is tests/test_multichip.py's (30 kbp in 3 fragments, 256 reads x
80 bp, seeds 21/22). The MatchState is exactly equal to real_tpu's and to
the port's one-device match_step, the overflow flags equal real_tpu's, the
fold equals engine/monoid.py's fold of the shard-major hit sequence, and
matchAll's compacted hits of each dp slice, decoded and sorted, equal
real_tpu's. The pass and shard bounds of the driver's mesh loop, the mesh
shape and the read slices equal real_tpu's on a table of cases. Exact."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_tpu.engine import driver as j_driver
from real_tpu.engine.matchstep import initial_state as j_initial_state
from real_tpu.io import fasta as j_fasta
from real_tpu.parallel import mesh as j_mesh
from real_tpu.parallel import multihost as j_multihost
from real_tpu.parallel import plan as j_plan
from real_tpu.scoring.scoring import Scoring as JScoring
from real_tpu.scoring.scoring import score_tables as j_score_tables
from real_tpu.text.packed import build_packed_text as j_build_packed_text
from real_tpu.tools import simulate as j_simulate
from real_tpu_torch.config import RealConfig
from real_tpu_torch.engine import driver, monoid
from real_tpu_torch.engine.matchstep import (initial_state, match_step,
                                             scored_survivors)
from real_tpu_torch.index.build import shard_windows
from real_tpu_torch.parallel import mesh, multihost, plan
from real_tpu_torch.scoring.scoring import Scoring, score_tables
from real_tpu_torch.text.packed import build_packed_text

B, PATL = 256, 80
EPS = np.float32(PATL * 5 / 70.0)
KW = dict(seedkmax=2, totalkmax=5, cand_cap=32, survivor_cap=32)
FIELDS = ("st", "pos", "frag", "fileid", "errs", "score")


def _inputs(t_run: bool, d):
    """(codes, ranges, reads [B, PATL], quals, valid): test_multichip's
    genome and reads; with t_run the genome ends in 150 T's, which lie in
    the last shard of every grid here, and four reads are all T."""
    g = os.path.join(d, "g.fa")
    with open(g, "w") as f:
        f.write(j_simulate.random_genome(30000, seed=21, num_fragments=3))
    codes, ranges = j_fasta.parse_genome(g)
    if t_run:
        codes = codes.copy()
        codes[-150:] = 3
    rds = j_simulate.generate_reads(codes, B, PATL, 0.03, False, seed=22)
    from real_tpu.io.reads import _MAP_TABLE
    batch = np.stack([_MAP_TABLE[np.frombuffer(r.seq.encode(), np.uint8)]
                      for r in rds])
    if t_run:
        batch[[5, 77, 130, 250]] = 3
    return (codes, ranges, batch, np.full_like(batch, 30, np.int8),
            np.ones(B, bool))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return {t_run: _inputs(t_run, tmp_path_factory.mktemp("mesh"))
            for t_run in (False, True)}


def _real_tpu(codes, ranges, batch, quals, valid, n_dp, n_shard, seedl,
              scores, matchall, bsearch_steps):
    text = j_build_packed_text(codes, ranges)
    m = j_mesh.make_mesh(n_dp, n_shard)
    sig_hi, sig, pos, bb = j_mesh.build_sharded_index(
        text.words, text.nb16, text.ncum16, jnp.int32(text.n),
        seedl=seedl, num_windows=text.n - seedl + 1, mesh=m,
        order_sentinels=text.order_sentinels(seedl))
    st, out = j_mesh.sharded_match_step(
        sig, pos, bb, text.words, text.nbits, text.ncum, text.frag_offsets,
        jnp.asarray(batch), jnp.asarray(quals), jnp.asarray(valid),
        j_initial_state(B), 0, EPS, sig_hi,
        tables=j_score_tables(JScoring()) if scores else None, seedl=seedl,
        scores=scores, score_mode="f64", mesh=m, matchall=matchall,
        bsearch_steps=bsearch_steps, **KW)
    return jax.tree.map(np.asarray, st), jax.tree.map(np.asarray, out)


def _port(codes, ranges, batch, quals, valid, n_dp, n_shard, seedl, scores,
          matchall, bsearch_steps):
    """[(state, out, parts)] per dp row: merge_shard_major's result over
    the row's cells, and the cells' survivors (shard order)."""
    text = build_packed_text(codes, ranges, "cpu")
    per = shard_windows(text.n - seedl + 1, n_shard)
    kw = dict(KW, seedl=seedl, scores=scores, bsearch_steps=bsearch_steps,
              tables=score_tables(Scoring()) if scores else None)
    rows = B // n_dp
    out = []
    for dp in range(n_dp):
        sl = slice(dp * rows, (dp + 1) * rows)
        parts = []
        for shard in range(n_shard):
            index = mesh.build_sharded_index(
                text, seedl, 0, per, mesh.Mesh(n_dp, n_shard, dp, shard),
                bucket_bits=0)
            parts.append(scored_survivors(
                index.sig, index.pos, index.bb, text.words, text.nbits,
                text.ncum, text.frag_offsets, torch.from_numpy(batch[sl]),
                torch.from_numpy(quals[sl]), torch.from_numpy(valid[sl]),
                **kw))
        st, o = mesh.merge_shard_major(
            parts, initial_state(rows, "cpu"), 0, EPS, scores=scores,
            matchall=matchall)
        out.append((st, o, parts))
    return out


def _one_device(codes, ranges, batch, quals, valid, seedl, scores):
    text = build_packed_text(codes, ranges, "cpu")
    index = mesh.build_sharded_index(
        text, seedl, 0, shard_windows(text.n - seedl + 1, 1),
        mesh.Mesh(1, 1, 0, 0), bucket_bits=0)
    st, _ = match_step(
        index.sig, index.pos, index.bb, text.words, text.nbits, text.ncum,
        text.frag_offsets, torch.from_numpy(batch), torch.from_numpy(quals),
        torch.from_numpy(valid), initial_state(B, "cpu"), 0, EPS,
        tables=score_tables(Scoring()) if scores else None, seedl=seedl,
        scores=scores, **KW)
    return st


def _host_fold(parts, r, scores):
    """engine/monoid.py's fold of row r's shard-major hit sequence."""
    s = monoid.ScoreState() if scores else monoid.State()
    for p in parts:
        for j in np.flatnonzero(p.valid[r].numpy()):
            kw = dict(pos=int(p.pos[r, j]), frag=int(p.frag[r, j]), fileid=0,
                      k=int(p.k[r, j]), inv=bool(p.inv[r, j]))
            if scores:
                s = monoid.fold_hit_scores(
                    s, monoid.ScoreHit(score=float(p.score[r, j]), **kw),
                    float(EPS))
            else:
                s = monoid.fold_hits(s, [monoid.Hit(**kw)])
    return s


GRIDS = [(1, 2), (2, 1), (2, 2), (1, 4), (2, 4)]


@pytest.mark.parametrize("seedl", [32, 48])
@pytest.mark.parametrize("scores", [False, True], ids=["noscores", "scores"])
@pytest.mark.parametrize("grid", GRIDS, ids=[f"{a}x{b}" for a, b in GRIDS])
def test_sharded_state_equals_real_tpu_and_one_device(data, grid, scores,
                                                      seedl):
    n_dp, n_shard = grid
    args = data[False]
    want, want_over = _real_tpu(*args, n_dp, n_shard, seedl, scores, False,
                                0)
    got = _port(*args, n_dp, n_shard, seedl, scores, False, 0)
    one = _one_device(*args, seedl, scores)
    for f in FIELDS:
        g = np.concatenate([getattr(st, f).numpy() for st, _, _ in got])
        np.testing.assert_array_equal(g, getattr(want, f), err_msg=f)
        np.testing.assert_array_equal(g, getattr(one, f).numpy(), err_msg=f)
    np.testing.assert_array_equal(
        np.concatenate([o.numpy() for _, o, _ in got]), want_over)
    st, _, parts = got[0]
    for r in range(0, B // n_dp, 7):
        s = _host_fold(parts, r, scores)
        assert (int(st.st[r]), int(st.pos[r]), int(st.frag[r]),
                int(st.errs[r])) == (s.st, s.pos, s.frag, s.errs), r
        if scores:
            assert float(st.score[r]) == np.float32(s.score), r
    assert (np.isin(want.st, (1, 2))).sum() > 200


def _decode(ch, row_base):
    """Sorted (row, k, pos, frag, inv, score bits) of one dp slice's
    CompactHits (numpy arrays; count a scalar)."""
    c = min(int(ch.count), len(ch.pos))
    m1, m2 = ch.m1[:c], ch.m2[:c]
    return sorted(zip((m1 >> 4) + row_base, m1 & 15, ch.pos[:c], m2 >> 1,
                      m2 & 1, np.asarray(ch.score[:c]).view(np.uint32)))


@pytest.mark.parametrize("scores", [False, True], ids=["noscores", "scores"])
@pytest.mark.parametrize("grid", GRIDS, ids=[f"{a}x{b}" for a, b in GRIDS])
def test_sharded_matchall_hits_equal_real_tpu(data, grid, scores):
    n_dp, n_shard = grid
    args = data[False]
    _, want = _real_tpu(*args, n_dp, n_shard, 32, scores, True, 0)
    got = _port(*args, n_dp, n_shard, 32, scores, True, 0)
    rows = B // n_dp
    H = len(want.pos) // n_dp
    for dp, (_, ch, _) in enumerate(got):
        ch = type(ch)(*(np.asarray(t) for t in ch))
        sl = slice(dp * H, (dp + 1) * H)
        w = type(ch)(pos=want.pos[sl], m1=want.m1[sl], m2=want.m2[sl],
                     score=want.score[sl], count=want.count[dp],
                     overflow=want.overflow[dp * rows:(dp + 1) * rows])
        assert int(ch.count) == int(w.count) > rows // 2
        assert _decode(ch, dp * rows) == _decode(w, dp * rows)
        np.testing.assert_array_equal(ch.overflow, w.overflow)


@pytest.mark.parametrize("steps", [4, 8, 16])
def test_bsearch_steps_on_2x4(data, steps):
    args = data[False]
    want, want_over = _real_tpu(*args, 2, 4, 32, True, False, steps)
    got = _port(*args, 2, 4, 32, True, False, steps)
    for f in FIELDS:
        np.testing.assert_array_equal(
            np.concatenate([getattr(st, f).numpy() for st, _, _ in got]),
            getattr(want, f), err_msg=f)
    np.testing.assert_array_equal(
        np.concatenate([o.numpy() for _, o, _ in got]), want_over)


@pytest.mark.parametrize("grid", [(1, 1), (1, 4), (2, 4)],
                         ids=["1x1", "1x4", "2x4"])
def test_last_shard_past_the_text_with_all_t_reads(data, grid):
    """The genome ends in 150 T's, in the last shard, which runs past the
    last window (its tail is sentinels, whose signature is the all-T
    probe's); four reads are all T and overflow their candidate caps.
    Every field equals real_tpu's and the one-device step's, the
    overflowing reads' too: their first-pass lanes are the first cand_cap
    entries of the all-T run, which both builds keep in the stable
    phase-major window order (position 29856, phase 0, ahead of 29850)."""
    n_dp, n_shard = grid
    codes, ranges, batch, quals, valid = data[True]
    nw = len(codes) - 32 + 1
    assert n_shard * shard_windows(nw, n_shard) > nw
    want, want_over = _real_tpu(codes, ranges, batch, quals, valid, n_dp,
                                n_shard, 32, True, False, 0)
    got = _port(codes, ranges, batch, quals, valid, n_dp, n_shard, 32, True,
                False, 0)
    one = _one_device(codes, ranges, batch, quals, valid, 32, True)
    over = np.concatenate([o.numpy() for _, o, _ in got])
    np.testing.assert_array_equal(over, want_over)
    assert over[[5, 77, 130, 250]].all() and over.sum() < 8
    for f in FIELDS:
        g = np.concatenate([getattr(st, f).numpy() for st, _, _ in got])
        np.testing.assert_array_equal(g, getattr(want, f), err_msg=f)
        np.testing.assert_array_equal(g, getattr(one, f).numpy(), err_msg=f)
    assert (want.pos[[5, 77, 130, 250]] == 29856).all()


# ---------------------------------------------------------------------------
# host arithmetic: pass and shard bounds, mesh shape, read slices
# ---------------------------------------------------------------------------

BOUND_CASES = {
    # text bases, planned shards, devices (ranks); comment
    "one_shard": (3000, 1, 2),
    "two_passes": (5000, 4, 2),
    "last_shard_past_text": (4159, 3, 4),
    "shard_wholly_past_text": (64, 4, 4),
    "pass_skipped": (64, 8, 1),
    "eight_ranks": (20011, 5, 8),
}


@pytest.mark.parametrize("case", list(BOUND_CASES))
def test_mesh_loop_bounds_equal_real_tpus(case, monkeypatch):
    """The windows each shard of each pass builds, and its bucket width,
    as real_tpu's _foreach_shard_mesh computes them (its build recorded
    in place of running it) against the port's unit loop over a MeshPlan
    route on every shard."""
    n, shards, n_dev = BOUND_CASES[case]
    rng = np.random.default_rng(n)
    codes = rng.integers(0, 4, n).astype(np.uint8)
    ranges = [("f0", 0), ("terminal", n)]
    reads = 777
    want = []

    class JText:
        packed = j_build_packed_text(codes, ranges)
        name = "t"

    def j_build(words, nb16, ncum16, n_, start, *, seedl, per_shard, mesh,
                order_sentinels, bucket_bits):
        want.append((int(start), per_shard, bucket_bits))
        return None

    monkeypatch.setattr(j_mesh, "build_sharded_index", j_build)
    monkeypatch.setattr(j_mesh, "make_mesh", lambda a, b: (a, b))
    monkeypatch.setattr(j_driver.jax, "local_devices",
                        lambda: list(range(n_dev)))
    monkeypatch.setattr(j_driver, "_plan_shards", lambda *a, **k:
                        dataclasses.make_dataclass("P", ["shards"])(shards))
    from real_tpu.config import RealConfig as JConfig
    j_driver._foreach_shard_mesh(JConfig(seedl=32), [JText], 8,
                                 lambda *a: None, reads=reads)
    n_dp, n_shard = j_plan.choose_mesh_shape(n_dev, shards)

    text = build_packed_text(codes, ranges, "cpu")
    tf = driver.TextFile("t", text)
    got = {s: [] for s in range(n_shard)}
    for s in range(n_shard):
        def t_build(text_, seedl, start, per_shard, m, bucket_bits, s=s):
            got[s].append((start + m.shard * per_shard, per_shard,
                           bucket_bits))
            return None
        monkeypatch.setattr(mesh, "build_sharded_index", t_build)
        mp = driver.MeshPlan(
            mesh.Mesh(n_dp, n_shard, 0, s), 0, 0, reads,
            {0: plan.StreamShardPlan(shards, False,
                                     driver.BUCKET_BITS_CAP)}, 0)
        driver._foreach_unit(RealConfig(seedl=32), mp, [tf], 8,
                             lambda *a: None, driver._Progress(False))
    for s in range(n_shard):
        assert got[s] == [(st + s * per, per, bb) for st, per, bb in want]
    nw = n - 32 + 1
    if case == "last_shard_past_text":
        start, per, _ = want[-1]
        assert start + n_shard * per > nw > start + (n_shard - 1) * per
    if case == "shard_wholly_past_text":
        assert want[-1][0] + (n_shard - 1) * want[-1][1] >= nw
    if case == "pass_skipped":
        assert len(want) < -(-shards // n_shard)


@pytest.mark.parametrize("n_dev,total", [(1, 1), (2, 1), (2, 5), (4, 3),
                                         (6, 4), (8, 8), (8, 3), (3, 2)])
def test_mesh_shape_and_axes_equal_real_tpus(n_dev, total):
    assert plan.choose_mesh_shape(n_dev, total) \
        == j_plan.choose_mesh_shape(n_dev, total)
    for hosts in (1, 2, 3):
        assert multihost.dp_shard_axes(n_dev, hosts, total) \
            == j_multihost.dp_shard_axes(n_dev, hosts, total)


@pytest.mark.parametrize("num_reads", [0, 1, 15, 16, 100, 257, 1000])
def test_host_read_slice_equals_real_tpus(num_reads):
    for count in (1, 2, 3, 4, 8):
        for i in range(count):
            assert multihost.host_read_slice(
                num_reads, multihost.HostTopology(i, count)) \
                == j_multihost.host_read_slice(
                    num_reads, j_multihost.HostTopology(i, count))


@pytest.mark.parametrize("fastq", [False, True], ids=["fasta", "fastq"])
def test_a_rows_reads_equal_its_parsed_slice(tmp_path, fastq):
    """A mesh rank parses the whole read file and takes its row's reads
    (ReadSet.records): the same read set as parsing that slice alone
    (multihost.parse_host_slice), with either parser."""
    from real_tpu_torch.io import reads as reads_io
    from tests import ab_util
    _, reads = ab_util.make_inputs(tmp_path, n=8000, numpat=101,
                                   patlen=50, seed=23, fastq=fastq)
    for native in (True, False):
        whole = reads_io.parse_reads(reads, use_native=native)
        for count in (1, 2, 3):
            for i in range(count):
                topo = multihost.HostTopology(i, count)
                got = whole.records(*multihost.host_read_slice(
                    whole.num_reads, topo))
                want = multihost.parse_host_slice(reads, topo,
                                                  use_native=native)
                assert list(got.ids) == list(want.ids)
                for f in ("lengths", "codes_flat", "offsets", "quals_flat"):
                    g, w = getattr(got, f), getattr(want, f)
                    assert (g is None) == (w is None)
                    if w is not None:
                        np.testing.assert_array_equal(g, w)
                assert (got.fastq, got.quality_offset) \
                    == (want.fastq, want.quality_offset)


def test_local_rank_count():
    topo = multihost.HostTopology(3, 8)
    assert multihost.local_rank_count(topo, {}) == 8
    assert multihost.local_rank_count(topo, {"LOCAL_WORLD_SIZE": "4"}) == 4
