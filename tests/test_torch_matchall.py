"""The port's matchAll against real_tpu's on the CPU.

compact_hits: equal count and overflow flags and the same multiset of
prefix hits as real_tpu.engine.matchstep.compact_hits, on both dedup
routes (S <= 16 pairwise mask, S > 16 per-row sort) and with whole-batch
hit overflow. _sort_dedup_hits: equal arrays. End to end: records
byte-identical to real_tpu's single-device run
(tests/ab_util.run_ours(unique=False, use_mesh=False)), through the driver
and the CLI. All comparisons are exact."""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_tpu.cli.output import write_all as j_write_all
from real_tpu.config import RealConfig as JConfig
from real_tpu.engine import driver as j_driver
from real_tpu.engine import matchstep as j_ms
from real_tpu.io import reads as j_reads
from real_tpu_torch.cli import main as t_main
from real_tpu_torch.cli.output import write_all, write_all_arrays, \
    write_unique
from real_tpu_torch.config import RealConfig
from real_tpu_torch.engine import driver
from real_tpu_torch.engine import matchstep as t_ms
from real_tpu_torch.io import reads as reads_io
from tests import ab_util


# ---------------------------------------------------------------------------
# compact_hits
# ---------------------------------------------------------------------------

def _survivors(B, S, seed):
    """Seeded Survivors with duplicate lanes: lanes of a row that share
    (pos, inv) share k, frag and score, as duplicates found through
    several lists do."""
    rng = np.random.default_rng(seed)
    pos = rng.integers(0, 6, (B, S)).astype(np.int32) * 1000 \
        + np.arange(B, dtype=np.int32)[:, None]
    inv = rng.random((B, S)) < 0.5
    valid = rng.random((B, S)) < 0.6
    k = ((pos * 7 + inv) % 19).astype(np.int32)          # > 15 clips
    frag = (pos // 1500).astype(np.int32)
    score = (pos.astype(np.float32) * np.float32(0.37)
             - inv.astype(np.float32))
    overflow = rng.random(B) < 0.1
    # invalid lanes carry noise in every field
    pos[~valid] = rng.integers(-5, 9000, int((~valid).sum()))
    return dict(valid=valid, inv=inv, pos=pos, frag=frag, k=k, score=score,
                overflow=overflow)


def _prefix(ch):
    h = len(ch["pos"])
    c = min(int(ch["count"]), h)
    return sorted(zip(*(ch[f][:c].tolist()
                        for f in ("pos", "m1", "m2", "score"))))


@pytest.mark.parametrize("B,S,cap", [(64, 8, 128), (64, 32, 1024),
                                     (64, 8, 40), (64, 32, 100)],
                         ids=["S8", "S32", "S8_count_over_H",
                              "S32_count_over_H"])
def test_compact_hits_equals_real_tpu(B, S, cap):
    a = _survivors(B, S, seed=B + S + cap)
    jch = j_ms.compact_hits(j_ms.Survivors(
        **{f: jnp.asarray(v) for f, v in a.items()}), cap)
    tch = t_ms.compact_hits(t_ms.Survivors(
        **{f: torch.from_numpy(v) for f, v in a.items()}), cap)
    j = {f: np.asarray(getattr(jch, f)) for f in t_ms.CompactHits._fields}
    t = {f: getattr(tch, f).numpy() for f in t_ms.CompactHits._fields}
    assert int(j["count"]) == int(t["count"])
    np.testing.assert_array_equal(j["overflow"], t["overflow"])
    for f in ("pos", "m1", "m2", "score"):
        assert j[f].dtype == t[f].dtype and j[f].shape == t[f].shape, f
    assert _prefix(j) == _prefix(t)
    # the case exercises what it is named for
    H = min(cap, B * S)
    over_h = int(t["count"]) > H
    assert over_h == (cap < 200)
    assert t["overflow"].all() == over_h
    dups = a["valid"].sum() - int(t["count"])
    assert dups > 0


# ---------------------------------------------------------------------------
# _sort_dedup_hits
# ---------------------------------------------------------------------------

def _hit_cols(rng, n, wide=False):
    pid = rng.integers(0, 40, n).astype(np.int64)
    k = rng.integers(0, 4, n).astype(np.int64)
    pos = rng.integers(0, 30, n).astype(np.int64) * 3
    if wide:
        pos[::7] += 1 << 31          # out of the composite keys' range
    fid = rng.integers(0, 2, n).astype(np.int64)
    frag = pos // 20 + fid
    score = rng.choice(np.array([-1.5, -0.0, 0.0, 0.25, 2.0, 7.5],
                                np.float32), n)
    inv = rng.random(n) < 0.5
    cols = [pid, k, pos, fid, frag, score, inv]
    dup = rng.integers(0, n, n // 3)           # exact duplicate records
    return tuple(np.concatenate([c, c[dup]]) for c in cols)


@pytest.mark.parametrize("wide", [False, True], ids=["composite", "lexsort"])
def test_sort_dedup_hits_equals_real_tpu(wide):
    cols = _hit_cols(np.random.default_rng(5 + wide), 3000, wide)
    want = j_driver._sort_dedup_hits(cols)
    got = driver._sort_dedup_hits(cols)
    assert len(got[0]) < len(cols[0])           # duplicates were dropped
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    # -0.0 and +0.0 tie: only one survives of an otherwise equal pair
    pair = tuple(np.array(v, dt) for v, dt in zip(
        ([3, 3], [1, 1], [10, 10], [0, 0], [0, 0], [-0.0, 0.0],
         [True, True]), driver.HIT_DTYPES))
    assert len(driver._sort_dedup_hits(pair)[0]) == 1


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------

def _repeat_genome(tmp_path):
    """A random genome with a 1,500 bp unit repeated 6 times and reads
    from the repeats: ~6 distinct hits per read, more than the H = 4 per
    read hit buffer of a 512 x 8 step (whole-batch hit overflow)."""
    rng = np.random.default_rng(31)
    g = rng.integers(0, 4, 24000)
    unit = rng.integers(0, 4, 1500)
    for c in range(6):
        g[2000 + c * 3000:2000 + c * 3000 + 1500] = unit
    seq = "".join("ACGT"[int(b)] for b in g)
    gp = tmp_path / "genome.fa"
    gp.write_text(">rep0\n" + "\n".join(seq[i:i + 60]
                                        for i in range(0, len(seq), 60))
                  + "\n")
    starts = 2000 + rng.integers(0, 1500 - 60, 500)
    rp = tmp_path / "reads.fa"
    rp.write_text("".join(f">r{i}\n{seq[p:p + 60]}\n"
                          for i, p in enumerate(starts)))
    return str(gp), str(rp)


CASES = {
    # make_inputs kwargs (None: the repeat genome), scores, caps, metric
    # that must be > 0
    "scores_fasta": (dict(seed=7), True, None, None),
    "noscores_fasta": (dict(seed=0), False, None, None),
    "scores_fastq": (dict(seed=3, fastq=True), True, None, None),
    "n_in_genome": (dict(seed=5, n_prob=0.002, patlen=80), True, None, None),
    "multifragment": (dict(seed=9, n=30000, patlen=75, num_fragments=5),
                      True, None, None),
    "overflow_rerun": (dict(seed=11), True, (2, 2), "overflow_rerun_reads"),
    "batch_hit_overflow": (None, False, None, "batch_hit_overflow_steps"),
}


def _real_tpu_records(genome, reads, scores, caps):
    if caps is None:
        return ab_util.run_ours(genome, reads, unique=False, scores=scores,
                                use_mesh=False)
    # ab_util.run_ours(unique=False) with forced candidate caps
    cfg = JConfig(textfilename=genome, patternfilename=reads,
                  outputfilename="-", match_unique=False, scores=scores,
                  index_shards=1, batch_size=512, use_mesh=False,
                  cand_cap=caps[0], survivor_cap=caps[1])
    rs = j_reads.parse_reads(reads)
    texts = j_driver.load_texts(cfg)
    buf = io.StringIO()
    j_write_all(buf, rs, j_driver.run_match_all(cfg, rs, texts), texts,
                scores)
    assert j_driver.last_metrics["overflow_rerun_reads"] > 0
    return buf.getvalue()


def _port(genome, reads, scores, caps=None, unique=False):
    cfg = RealConfig(textfilename=genome, patternfilename=reads,
                     outputfilename="-", match_unique=unique, scores=scores,
                     batch_size=512)
    if caps:
        cfg.cand_cap, cfg.survivor_cap = caps
    rs = reads_io.parse_reads(reads)
    texts = driver.load_texts(cfg, "cpu")
    buf = io.StringIO()
    if unique:
        write_unique(buf, rs, driver.run_match_unique(cfg, rs, texts, "cpu"),
                     texts, scores)
        return buf.getvalue(), None
    result = driver.run_match_all(cfg, rs, texts, "cpu", as_arrays=True)
    n = write_all_arrays(buf, rs, result.cols, texts, scores)
    assert buf.getvalue().count("\n") == n
    return buf.getvalue(), result


@pytest.mark.parametrize("case", sorted(CASES))
def test_records_equal_real_tpu(tmp_path, case):
    kw, scores, caps, metric = CASES[case]
    if kw is None:
        genome, reads = _repeat_genome(tmp_path)
    else:
        args = dict(n=20000, numpat=300, patlen=100, errprob=0.02)
        args.update(kw)
        genome, reads = ab_util.make_inputs(tmp_path, **args)
    ours, result = _port(genome, reads, scores, caps)
    assert len(result.pid) > 200
    assert ours == _real_tpu_records(genome, reads, scores, caps)
    m = result.metrics
    # the run's own metrics, and the unit loop's account of itself
    assert set(m) == {"phase_s", "overflow_rerun_reads",
                      "batch_hit_overflow_steps", "units", "units_skipped",
                      "units_dispatched", "reserved_bytes", "plans",
                      "source_resident", "resident_read_bytes",
                      "streamed_batches"}
    assert m["units"] == m["units_dispatched"] == 1 and m["source_resident"]
    if metric:
        assert m[metric] > 0 and m["overflow_rerun_reads"] > 0
    # the dict form holds the same records
    cfg = RealConfig(textfilename=genome, patternfilename=reads,
                     outputfilename="-", match_unique=False, scores=scores,
                     batch_size=512)
    if caps:
        cfg.cand_cap, cfg.survivor_cap = caps
    rs = reads_io.parse_reads(reads)
    texts = driver.load_texts(cfg, "cpu")
    buf = io.StringIO()
    write_all(buf, rs, driver.run_match_all(cfg, rs, texts, "cpu"), texts,
              scores)
    assert buf.getvalue() == ours


@pytest.mark.parametrize("scores", [True, False])
def test_match_unique_records_are_match_all_records(tmp_path, scores):
    genome, reads = ab_util.make_inputs(tmp_path, n=20000, numpat=300,
                                        patlen=60, seed=21)
    all_recs = set(ab_util.as_record_set(_port(genome, reads, scores)[0]))
    uniq = ab_util.as_record_set(_port(genome, reads, scores,
                                       unique=True)[0])
    assert len(uniq) > 200
    assert set(uniq) <= all_recs


def test_cli_u0_writes_the_same_file(tmp_path):
    genome, reads = ab_util.make_inputs(tmp_path, n=20000, numpat=200,
                                        patlen=60, seed=13)
    out = tmp_path / "out.txt"
    assert t_main.main(["-device", "cpu", "-u", "0", "-t", genome,
                        "-p", reads, "-o", str(out), "-B", "512"]) == 0
    assert out.read_text() == ab_util.run_ours(genome, reads, unique=False,
                                               use_mesh=False)


@pytest.mark.parametrize("fastq", [False, True], ids=["fasta", "fastq"])
def test_cli_u0_native_off_writes_the_same_file(tmp_path, fastq):
    """matchAll through the CLI: the C++ host library (default) and
    -native 0 (plain NumPy host phases, three stable argsorts, NumPy
    formatter) print the same bytes, equal to real_tpu's."""
    genome, reads = ab_util.make_inputs(tmp_path, n=20000, numpat=200,
                                        patlen=60, seed=19, fastq=fastq,
                                        num_fragments=3)
    outs = []
    for flags in ([], ["-native", "0"]):
        out = tmp_path / f"out{len(outs)}.txt"
        assert t_main.main(["-device", "cpu", "-u", "0", "-t", genome,
                            "-p", reads, "-o", str(out), "-B", "512",
                            "-R", "0", *flags]) == 0
        outs.append(out.read_bytes())
    assert outs[0].count(b"\n") > 150
    assert outs[0] == outs[1]
    assert outs[0].decode("latin-1") == ab_util.run_ours(
        genome, reads, unique=False, use_mesh=False)


@pytest.mark.parametrize("use_native", [True, False],
                         ids=["native", "plain"])
def test_driver_native_switch_gives_the_same_columns(tmp_path, use_native):
    genome, reads = _repeat_genome(tmp_path)
    cols = {}
    for native_host in (use_native, not use_native):
        cfg = RealConfig(textfilename=genome, patternfilename=reads,
                         outputfilename="-", match_unique=False,
                         scores=True, batch_size=512,
                         native_host=native_host)
        rs = reads_io.parse_reads(reads, use_native=native_host)
        texts = driver.load_texts(cfg, "cpu")
        cols[native_host] = driver.run_match_all(cfg, rs, texts, "cpu",
                                                 as_arrays=True).cols
    assert len(cols[True][0]) > 1000
    for a, b in zip(cols[True], cols[False]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
