"""The port's host parsing, packing and packed-text helpers against
real_tpu, on a genome with Ns and 3 fragments. Every comparison is exact:
32-bit tables compare as bit patterns, counts and flags as values."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_tpu import bitpack as j_bitpack
from real_tpu.io import fasta as j_fasta, reads as j_reads
from real_tpu.scoring import scoring as j_scoring
from real_tpu.text import packed as j_packed
from real_tpu_torch import bitpack as t_bitpack
from real_tpu_torch.io import fasta as t_fasta, reads as t_reads
from real_tpu_torch.scoring import scoring as t_scoring
from real_tpu_torch.text import packed as t_packed
from real_tpu_torch.tools import simulate

U32_FIELDS = ("words", "nbits", "ncum", "frag_offsets", "nb16", "ncum16")


def _as_u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    path = tmp_path_factory.mktemp("g") / "g.fa"
    path.write_text(simulate.random_genome(9000, seed=21, n_prob=0.01,
                                           num_fragments=3))
    return str(path)


def test_genome_parse_and_packed_text_fields(genome):
    jc, jr = j_fasta.parse_genome(genome)
    tc, tr = t_fasta.parse_genome(genome)
    np.testing.assert_array_equal(jc, tc)
    assert jr == tr and len(tr) == 4
    jt = j_packed.build_packed_text(jc, jr)
    tt = t_packed.build_packed_text(tc, tr, "cpu")
    for f in dataclasses.fields(jt):
        a, b = getattr(jt, f.name), getattr(tt, f.name)
        if f.name in U32_FIELDS:
            assert b.dtype == torch.int32
            np.testing.assert_array_equal(
                np.asarray(a).view(np.uint32), _as_u32(b), err_msg=f.name)
        else:
            assert a == b, f.name
    assert tt.has_n and tt.num_fragments == 3


@pytest.mark.parametrize("fastq", [False, True])
def test_read_parsers_and_row_packing(tmp_path, genome, fastq):
    codes, _ = t_fasta.parse_genome(genome)
    rds = simulate.generate_reads(codes, 120, 60, 0.05, fastq, seed=4)
    path = str(tmp_path / ("r.fq" if fastq else "r.fa"))
    simulate.write_reads(rds, path, fastq)
    a = j_reads.parse_reads(path, use_native=False)
    b = t_reads.parse_reads(path)
    assert list(a.ids) == list(b.ids) and a.fastq == b.fastq == fastq
    for f in ("lengths", "codes_flat", "offsets"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    if fastq:
        np.testing.assert_array_equal(a.quals_flat, b.quals_flat)
        assert a.quality_offset == b.quality_offset
    dense, _ = b.dense_batch(np.arange(b.num_reads))
    np.testing.assert_array_equal(j_bitpack.pack_rows_2bit(dense),
                                  t_bitpack.pack_rows_2bit(dense))


def test_scoring_tables_equal():
    a = j_scoring.score_tables(j_scoring.Scoring())
    b = t_scoring.score_tables(t_scoring.Scoring())
    np.testing.assert_array_equal(a.ll_hi, b.ll_hi)
    np.testing.assert_array_equal(a.ll_lo, b.ll_lo)
    np.testing.assert_array_equal(
        a.ll_hi.astype(np.float64) + a.ll_lo.astype(np.float64), b.ll_f64())


def test_device_helpers(genome):
    codes, ranges = t_fasta.parse_genome(genome)
    jt = j_packed.build_packed_text(codes, ranges)
    tt = t_packed.build_packed_text(codes, ranges, "cpu")
    rng = np.random.default_rng(5)
    pos = rng.integers(0, jt.n + 40, 4000).astype(np.int32)
    pos[:4] = [0, 1, jt.n - 1, jt.n]
    tpos = torch.from_numpy(pos)

    e_j = np.asarray(j_packed.extract_bases16(jt.words, jnp.asarray(pos)))
    e_t = t_packed.extract_bases16(tt.words, tpos)
    np.testing.assert_array_equal(e_j.astype(np.int64), e_t.numpy())

    x = rng.integers(0, 2**32, 4000, dtype=np.uint64).astype(np.uint32)
    x[:3] = [0, 0xFFFFFFFF, 0x80000000]
    pm_j = np.asarray(j_packed.pair_mismatch_count(jnp.asarray(x)))
    pm_t = t_packed.pair_mismatch_count(torch.from_numpy(x.astype(np.int64)))
    np.testing.assert_array_equal(pm_j, pm_t.numpy())
    np.testing.assert_array_equal(
        np.bitwise_count(x), t_packed.popcount32(
            torch.from_numpy(x.astype(np.int64))).numpy())

    r_j = np.asarray(j_packed.n_rank_excl(jt.nbits, jt.ncum,
                                          jnp.asarray(pos)))
    r_t = t_packed.n_rank_excl(tt.nbits, tt.ncum, tpos)
    np.testing.assert_array_equal(r_j, r_t.numpy())
    assert r_t.max() > 0

    f_j = np.asarray(j_packed.is_dontcare_free(jt.nbits, jt.ncum,
                                               jnp.asarray(pos), 50))
    f_t = t_packed.is_dontcare_free(tt.nbits, tt.ncum, tpos, 50)
    np.testing.assert_array_equal(f_j, f_t.numpy())
    assert (~f_t).any() and f_t.any()


def test_i32_bits_round_trip():
    v = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1], np.int64)
    t = t_packed.i32_bits(torch.from_numpy(v))
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(t.numpy().view(np.uint32), v)
    np.testing.assert_array_equal(t_packed.u32(t).numpy(), v)
