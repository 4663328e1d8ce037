"""The pieces of the genome-scale path (a 3.1 Gbp, 24-fragment FASTA,
benchmarks/scale.py "grch") on the CPU, without the genome's memory:

(a) tools/gendata.py writes benchmarks/gendata.py's bytes, and read_truth
    replays what write_reads_fast wrote;
(b) split_oversized splits grch's layout as real_tpu's does (a zero-byte
    stand-in for the 3.1 GB of codes);
(c) the planner at grch's two sub-texts on an 80 GB card, with the bytes
    the driver really reserves, and equal to real_tpu's plan given
    real_tpu's constants;
(d) the text's index arithmetic at base positions in [2^30, 2^31 - 64)
    (extract_bases16, the build's N-rank, the plain versions of the window
    gathers) against real_tpu's extract_bases16 / n_rank_excl, on a
    zero-filled word table sized to the highest position.
Exact throughout."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import gendata as b_gendata
from real_tpu.engine import driver as j_driver
from real_tpu.parallel import plan as j_plan
from real_tpu.text import packed as j_packed
from real_tpu_torch import bitpack
from real_tpu_torch.config import RealConfig
from real_tpu_torch.engine import driver
from real_tpu_torch.engine.matchstep import pack_read_words
from real_tpu_torch.index import build as t_build
from real_tpu_torch.io import fasta, pipeline, reads as reads_io
from real_tpu_torch.ops import gather
from real_tpu_torch.parallel import plan
from real_tpu_torch.text import packed as t_packed
from real_tpu_torch.tools import gendata

GRCH = gendata.GRCH
CARD_BYTES = 85_017_493_504          # torch.cuda.mem_get_info of an H100
J_MODEL = plan.MemoryModel(j_plan.BYTES_PER_WINDOW, j_plan.BUILD_FACTOR,
                           j_plan.SERIAL_BUILD_FACTOR)


# --- (a) the data generator ---------------------------------------------

@pytest.fixture(scope="module")
def small_genome(tmp_path_factory):
    """A 1,000,003 bp genome in 3 fragments from both generators, in
    chunks that split every fragment."""
    d = tmp_path_factory.mktemp("gendata")
    ours, theirs = str(d / "ours.fa"), str(d / "theirs.fa")
    gendata.write_random_genome(ours, 1_000_003, seed=55, num_fragments=3,
                                chunk=60 * 1_000 + 17)
    b_gendata.write_random_genome(theirs, 1_000_003, seed=55,
                                  num_fragments=3, chunk=60 * 1_000 + 17)
    return d, ours, theirs


def test_genome_is_byte_identical(small_genome):
    _, ours, theirs = small_genome
    blob = open(ours, "rb").read()
    assert blob == open(theirs, "rb").read()
    codes, ranges = fasta.parse_genome(ours)
    assert len(codes) == 1_000_003 and codes.max() <= 3
    assert [off for _, off in ranges] == [0, 333_334, 666_668, 1_000_003]
    assert ranges[2][0] == "random_2_333335"


@pytest.mark.parametrize("fastq", [False, True], ids=["fasta", "fastq"])
def test_reads_are_byte_identical_and_their_truth_replays(small_genome,
                                                          fastq):
    d, genome, _ = small_genome
    codes, _ = fasta.parse_genome(genome)
    ext = "fq" if fastq else "fa"
    ours, theirs = str(d / f"ours.{ext}"), str(d / f"theirs.{ext}")
    args = (codes, 3_000, 100, 0.02, fastq)
    gendata.write_reads_fast(ours, *args, seed=56, chunk=1_100)
    b_gendata.write_reads_fast(theirs, *args, seed=56, chunk=1_100)
    assert open(ours, "rb").read() == open(theirs, "rb").read()

    rs = reads_io.parse_reads(ours)
    assert rs.num_reads == 3_000 and bool((rs.lengths == 100).all())
    got = rs.codes_flat.reshape(3_000, 100)
    truth = list(gendata.read_truth(len(codes), 3_000, 100, 0.02, seed=56,
                                    chunk=1_100))
    assert [len(t[0]) for t in truth] == [1_100, 1_100, 800]
    start, inv, seedk, totalk = (np.concatenate(c) for c in zip(*truth))
    win = codes[start[:, None] + np.arange(100)]
    win = np.where(inv[:, None], 3 - win[:, ::-1], win)
    diff = win != got
    np.testing.assert_array_equal(diff.sum(axis=1), totalk)
    np.testing.assert_array_equal(diff[:, :32].sum(axis=1), seedk)
    assert inv.any() and (~inv).any() and totalk.max() >= 3


def test_named_configurations_are_benchmarks_scales():
    from benchmarks.scale import CONFIGS
    for cfg in (gendata.GRCH, gendata.FLY):
        want = CONFIGS[cfg.name]
        assert (cfg.genome_n, cfg.numpat, cfg.patl, cfg.errprob,
                cfg.totalkmax, cfg.seed, cfg.fastq) == (
            want["genome_n"], want["numpat"], want["patl"], want["errprob"],
            want["totalkmax"], want["seed"], want["fastq"])
        assert cfg.fragments == want.get("fragments", 1)


# --- (b) the split ------------------------------------------------------

def _grch_layout():
    per = GRCH.genome_n // GRCH.fragments
    last = GRCH.genome_n - per * (GRCH.fragments - 1)
    return [(f"random_{f}_{per if f < GRCH.fragments - 1 else last}",
             f * per) for f in range(GRCH.fragments)] \
        + [("terminal", GRCH.genome_n)]


def test_split_oversized_at_grch_equals_real_tpus():
    codes = np.broadcast_to(np.uint8(0), (GRCH.genome_n,))   # no memory
    ranges = _grch_layout()
    ours = driver.split_oversized("genome.fa", codes, ranges)
    theirs = j_driver.split_oversized("genome.fa", codes, ranges)
    assert len(ours) == len(theirs) == 2
    for (name, c, r), (jname, jc, jr) in zip(ours, theirs):
        assert name == jname and r == jr and c.shape == jc.shape
        assert np.shares_memory(c, codes)                    # a view
    (_, c0, r0), (_, c1, r1) = ours
    assert (len(c0), len(c1)) == (2_066_666_656, 1_033_333_344)
    assert (len(r0), len(r1)) == (16 + 1, 8 + 1)
    assert r1[0] == ("random_16_129166666", 0)
    assert r1[-1] == ("terminal", 1_033_333_344)
    assert len(c0) < driver.TEXT_SPLIT_LIMIT < len(c0) + 129_166_666


# --- (c) the planner ----------------------------------------------------

def _text_bytes(n: int) -> int:
    """Device bytes of a PackedText of n bases (driver._text_bytes)."""
    w16, w32 = -(-n // 16) + 2, -(-n // 32) + 2
    return 4 * (w16 + w32 + (w32 + 1) + 2 * w32 + (2 * w32 + 1))


def test_text_bytes_formula():
    codes = np.random.default_rng(5).integers(0, 4, 100_003).astype(np.uint8)
    text = t_packed.build_packed_text(codes, [("a", 0), ("terminal",
                                                          100_003)], "cpu")
    assert driver._text_bytes(text) == _text_bytes(100_003)


def _grch_reserved():
    """What the driver reserves beside the lists at grch: both
    sub-texts, the 2M resident reads (62 batches of 32,768 x 100 bp FASTA)
    and one step's workspace."""
    batches = -(-GRCH.numpat // 32_768)
    plans = [types.SimpleNamespace(rows=32_768, patl=100)] * batches
    reads = batches * pipeline.packed_batch_bytes(32_768, 100, False)
    assert reads < driver.RESIDENT_READS_SHARE * CARD_BYTES   # resident
    return (_text_bytes(2_066_666_656) + _text_bytes(1_033_333_344) + reads
            + driver._step_workspace_bytes(plans, 8))


def test_planner_at_grch(monkeypatch):
    monkeypatch.setattr(plan, "hbm_bytes_per_device",
                        lambda dev="cuda": CARD_BYTES)
    reserved = _grch_reserved()
    cfg = RealConfig()                                  # -f 0.75
    got = []
    for n in (2_066_666_656, 1_033_333_344):
        windows = n - 31
        sp = driver._plan_shards(cfg, types.SimpleNamespace(n=n),
                                 torch.device("cuda"),
                                 reserved_bytes=reserved,
                                 reads=GRCH.numpat)
        bounds = driver._shard_bounds(windows, sp.shards)
        per = max(e - s for s, e in bounds)
        bbits = t_build.pick_bucket_bits(32, per, GRCH.numpat,
                                         cap=sp.bucket_bits_cap)
        got.append((sp.shards, sp.serial_build, bbits,
                    driver._bsearch_steps_static(per, 8, bbits)))
        # every shard's lists, and its positions, index in int32
        assert 6 * per < 2**31 and n < t_build.POS_SENTINEL
        # real_tpu's arithmetic given its constants
        for f in (0.75, 0.3, 1.0):
            assert plan.plan_index_shards(windows, f, reserved, CARD_BYTES,
                                          J_MODEL) == \
                j_plan.plan_index_shards(windows, f, reserved_bytes=reserved,
                                         hbm_bytes=CARD_BYTES)
            a = plan.plan_index_shards_streaming(windows, f, reserved,
                                                 CARD_BYTES, J_MODEL)
            b = j_plan.plan_index_shards_streaming(
                windows, f, reserved_bytes=reserved, hbm_bytes=CARD_BYTES)
            assert (a.shards, a.serial_build, a.bucket_bits_cap) == \
                (b.shards, b.serial_build, b.bucket_bits_cap)
    # the default plan: 8 + 4 pipelined shards of ~258M windows, 7.7
    # windows per bucket at 2^25 buckets, so every step bisects
    assert got == [(8, False, 25, 8), (4, False, 25, 8)]
    # the fewest forced shards at which no unit bisects: 31 per sub-text
    def bisects(shards, n):
        per = max(e - s for s, e in driver._shard_bounds(n - 31, shards))
        b = t_build.pick_bucket_bits(32, per, GRCH.numpat, cap=25)
        return driver._bsearch_steps_static(per, 8, b) > 0
    assert bisects(30, 2_066_666_656) and not bisects(31, 2_066_666_656)
    assert not bisects(31, 1_033_333_344)


# --- (d) index arithmetic past 2^30 ---------------------------------------

N_TEXT = 2**31 - 64                  # the split's largest sub-text


@pytest.fixture(scope="module")
def high_positions():
    rng = np.random.default_rng(30)
    edge = [2**30, 2**30 + 1, 2**30 + 15, 2**30 + 16, 2**30 + 31,
            N_TEXT - 116, N_TEXT - 101, N_TEXT - 100]
    return np.concatenate([edge, rng.integers(2**30, N_TEXT - 100,
                                              503)]).astype(np.int64)


@pytest.fixture(scope="module")
def high_words(high_positions):
    """The text's word table (537 MB), zero but for the words every high
    position reads, which hold random bits."""
    rng = np.random.default_rng(31)
    words = np.zeros(-(-N_TEXT // 16) + 2, np.uint32)
    touched = np.unique((high_positions[:, None] >> 4)
                        + np.arange(9)[None, :])
    words[touched] = rng.integers(0, 2**32, len(touched), dtype=np.uint64)
    return words


def test_extract_bases16_past_2_30(high_positions, high_words):
    got = t_packed.extract_bases16(torch.from_numpy(high_words.view(np.int32)),
                                   torch.from_numpy(high_positions))
    want = j_packed.extract_bases16(jnp.asarray(high_words),
                                    jnp.asarray(high_positions))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).astype(np.int64))
    assert (got.numpy() != 0).mean() > 0.9


def test_gather_and_verify_plain_versions_past_2_30(high_positions,
                                                    high_words):
    """gather_word_windows_ref fetches the words the kernel's callers ask
    for at word indexes past 2^26, and verify_windows_ref finds a read cut
    from the text at a position past 2^30 with 0 mismatches on its strand
    and the mutations planted in it."""
    words = torch.from_numpy(high_words.view(np.int32))
    idx = torch.from_numpy((high_positions >> 4).astype(np.int32))
    got = torch.stack(gather.gather_word_windows_ref(words, idx, 8))
    want = np.stack([high_words[(high_positions >> 4) + k] for k in
                     range(8)]).view(np.int32)
    np.testing.assert_array_equal(got.numpy(), want)

    patl, B = 100, len(high_positions)
    win = np.stack([np.asarray(j_packed.extract_bases16(
        jnp.asarray(high_words), jnp.asarray(high_positions + 16 * k)))
        for k in range(7)], axis=1).astype(np.uint64)
    shifts = 2 * (15 - np.arange(16, dtype=np.uint64))
    codes = ((win[..., None] >> shifts) & 3).reshape(B, -1)[:, :patl]
    inv = np.arange(B) % 2 == 1
    reads = np.where(inv[:, None], 3 - codes[:, ::-1], codes).astype(np.uint8)
    reads[:, 5] = (reads[:, 5] + 1) & 3                  # one seed mismatch
    reads[:, 90] = (reads[:, 90] + 2) & 3                # one outside it
    words_s, words_r = pack_read_words(torch.from_numpy(reads))
    pos = torch.from_numpy(high_positions[:, None].copy())
    tw, totalk, seedk = gather.verify_windows_ref(
        words, pos, torch.from_numpy(inv[:, None].copy()), words_s, words_r,
        patl, 32)
    np.testing.assert_array_equal(totalk.numpy()[:, 0], 2)
    np.testing.assert_array_equal(seedk.numpy()[:, 0], 1)
    np.testing.assert_array_equal(tw.numpy()[:, :, 0].T,
                                  win[:, :7].astype(np.uint32).view(np.int32))


def test_build_n_rank_past_2_30(high_positions):
    """The build's 16-base N-rank (_npre16 over nb16/ncum16) equals
    real_tpu's n_rank_excl over nbits/ncum at positions past 2^30, with N
    runs planted around some of them."""
    rng = np.random.default_rng(32)
    nw = -(-N_TEXT // 32) + 2
    nbits = np.zeros(nw, np.uint32)
    planted = (high_positions[::3] >> 5) + rng.integers(-2, 3, len(
        high_positions[::3]))
    nbits[planted] = rng.integers(1, 2**32, len(planted), dtype=np.uint64)
    ncum = bitpack.bitmap_cum_popcount(nbits)
    want = np.asarray(j_packed.n_rank_excl(
        jnp.asarray(nbits), jnp.asarray(ncum), jnp.asarray(high_positions)))
    del ncum
    nb16 = np.empty(2 * nw, np.uint32)
    nb16[0::2] = nbits >> np.uint32(16)
    nb16[1::2] = nbits & np.uint32(0xFFFF)
    del nbits
    ncum16 = np.zeros(2 * nw + 1, np.int32)
    np.cumsum(np.bitwise_count(nb16), out=ncum16[1:])
    got = t_build._npre16(torch.from_numpy(nb16.view(np.int32)),
                          torch.from_numpy(ncum16),
                          torch.from_numpy(high_positions))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert len(np.unique(want)) > 50
