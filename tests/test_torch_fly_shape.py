"""The read-scale path (benchmarks/scale.py "fly": 140 Mbp, 50M x 100 bp
FASTA reads, k <= 5, matchUnique with scores) on the CPU, real_tpu as the
oracle:

(a) the planner at fly on an 80 GB card, with the bytes the driver really
    reserves: 1 pipelined shard of 25 bucket bits that bisects in 8 steps,
    no bisection at -shards 3, the packed reads resident; equal to
    real_tpu's plan given real_tpu's constants;
(b) fly's shape at a small size (a one-fragment genome and reads from
    tools/gendata.py): real_tpu's records against the port's resident,
    the port's in 3 streamed shards, and the same from the read store
    written and loaded again;
(c) (b)'s streamed run with a host cache that holds only part of the
    batches, so that later passes mix cached and repacked batches;
(d) gendata.read_truth against (b)'s records.
Records byte-identical throughout."""

import io
import types

import numpy as np
import pytest
import torch

from real_tpu.parallel import plan as j_plan
from real_tpu_torch.cli.output import write_unique
from real_tpu_torch.config import RealConfig
from real_tpu_torch.engine import driver
from real_tpu_torch.index import build as t_build
from real_tpu_torch.io import fasta, pipeline, readstore
from real_tpu_torch.io import reads as reads_io
from real_tpu_torch.parallel import plan
from real_tpu_torch.tools import gendata
from tests import ab_util

FLY = gendata.FLY
CARD_BYTES = 85_017_493_504          # torch.cuda.mem_get_info of an H100
J_MODEL = plan.MemoryModel(j_plan.BYTES_PER_WINDOW, j_plan.BUILD_FACTOR,
                           j_plan.SERIAL_BUILD_FACTOR)
# fly's shape, cut in size: one fragment, 100 bp FASTA reads, seeds as fly's
GENOME_BP, READS, BATCH = 200_000, 4_000, 512


# --- (a) the planner ----------------------------------------------------

def _text_bytes(n: int) -> int:
    """Device bytes of a PackedText of n bases (driver._text_bytes)."""
    w16, w32 = -(-n // 16) + 2, -(-n // 32) + 2
    return 4 * (w16 + w32 + (w32 + 1) + 2 * w32 + (2 * w32 + 1))


def _plan(cfg, reserved):
    sp = driver._plan_shards(cfg, types.SimpleNamespace(n=FLY.genome_n),
                             torch.device("cuda"), reserved_bytes=reserved,
                             reads=FLY.numpat)
    per = max(e - s for s, e in driver._shard_bounds(FLY.genome_n - 31,
                                                     sp.shards))
    bbits = t_build.pick_bucket_bits(32, per, FLY.numpat,
                                     cap=sp.bucket_bits_cap)
    return (sp.shards, sp.serial_build, bbits,
            driver._bsearch_steps_static(per, 8, bbits))


def test_planner_at_fly(monkeypatch):
    monkeypatch.setattr(plan, "hbm_bytes_per_device",
                        lambda dev="cuda": CARD_BYTES)
    batches = -(-FLY.numpat // 32_768)
    reads = batches * pipeline.packed_batch_bytes(32_768, FLY.patl, False)
    assert (batches, reads) == (1_526, 1_450_115_072)
    # the packed reads stay resident: under the 0.12 share of the card
    assert reads <= driver.RESIDENT_READS_SHARE * CARD_BYTES
    plans = [types.SimpleNamespace(rows=32_768, patl=FLY.patl)] * batches
    reserved = (_text_bytes(FLY.genome_n) + reads
                + driver._step_workspace_bytes(plans, 8))
    windows = FLY.genome_n - 31
    # the default plan: 1 pipelined shard, 4.2 windows per bucket at 2^25
    # buckets, so every step bisects
    assert _plan(RealConfig(), reserved) == (1, False, 25, 8)
    # -shards 3 and beyond: 46,666,672 windows, no bisection (the probe
    # route); -shards 2 still bisects
    assert driver._shard_bounds(windows, 3)[0] == (0, 46_666_672)
    for shards, steps in ((2, 8), (3, 0), (4, 0), (6, 0)):
        got = _plan(RealConfig(index_shards=shards), reserved)
        assert got == (shards, False, 25, steps)
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


# --- (b)-(d) fly's shape at a small size ----------------------------------

@pytest.fixture(scope="module")
def fly_small(tmp_path_factory):
    """(genome, reads, real_tpu's records) from tools/gendata.py with
    fly's seeds."""
    d = tmp_path_factory.mktemp("fly")
    genome, reads = str(d / "genome.fa"), str(d / "reads.fa")
    gendata.write_random_genome(genome, GENOME_BP, seed=FLY.seed)
    codes, _ = fasta.parse_genome(genome)
    gendata.write_reads_fast(reads, codes, READS, FLY.patl, FLY.errprob,
                             FLY.fastq, seed=FLY.seed + 1)
    want = ab_util.run_ours(genome, reads, totalkmax=FLY.totalkmax,
                            batch_size=BATCH, use_mesh=False)
    return genome, reads, want


def _port(genome, reads, rs=None, **kw):
    cfg = RealConfig(textfilename=genome, patternfilename=reads,
                     outputfilename="-", totalkmax=FLY.totalkmax,
                     batch_size=BATCH, **kw)
    rs = reads_io.parse_reads(reads) if rs is None else rs
    texts = driver.load_texts(cfg, "cpu")
    res = driver.run_match_unique(cfg, rs, texts, "cpu")
    buf = io.StringIO()
    write_unique(buf, rs, res, texts, cfg.scores)
    return buf.getvalue(), res


def test_fly_shape_records_equal_real_tpu(fly_small, tmp_path):
    genome, reads, want = fly_small
    nbatches = -(-READS // BATCH)
    assert want.count("\n") > 0.9 * READS
    got, res = _port(genome, reads)
    assert res.metrics["source_resident"] and got == want
    # real_tpu's shape of fly: 3 units, the reads streamed once per unit
    got, res = _port(genome, reads, index_shards=3, resident_reads_bytes=1)
    m = res.metrics
    assert m["units_dispatched"] == 3 and not m["source_resident"]
    assert m["streamed_batches"] == 3 * nbatches
    assert got == want
    # the same from the read store (-R 1), written and loaded again
    store_reads = tmp_path / "reads.fa"
    store_reads.write_bytes(open(reads, "rb").read())
    first = readstore.parse_reads_cached(str(store_reads))
    assert not isinstance(first.codes_flat, np.memmap)      # parsed, saved
    rs = readstore.parse_reads_cached(str(store_reads))
    assert isinstance(rs.codes_flat, np.memmap)             # loaded
    got, _ = _port(genome, str(store_reads), rs=rs, index_shards=3,
                   resident_reads_bytes=1)
    assert got == want


def test_fly_shape_with_a_partial_host_cache(fly_small, monkeypatch):
    """Only 3 of the 8 packed batches fit the host cache: pass 1 packs
    all 8, passes 2 and 3 take 3 from the cache and repack 5 each."""
    genome, reads, want = fly_small
    nbatches = -(-READS // BATCH)
    monkeypatch.setattr(pipeline, "_HOST_CACHE_MAX",
                        3 * pipeline.packed_batch_bytes(BATCH, FLY.patl,
                                                        False))
    packs, sources = [], []
    pack, make_source = pipeline._pack_host_tensors, driver._make_source
    monkeypatch.setattr(pipeline, "_pack_host_tensors",
                        lambda *a, **kw: packs.append(1) or pack(*a, **kw))

    def keep_source(*a, **kw):
        sources.append(make_source(*a, **kw))
        return sources[-1]
    monkeypatch.setattr(driver, "_make_source", keep_source)
    got, res = _port(genome, reads, index_shards=3, resident_reads_bytes=1)
    assert len(sources) == 1            # no overflow rerun at this size
    assert nbatches == 8 and len(sources[0]._host_cache) == 3
    assert len(packs) == nbatches + 2 * (nbatches - 3)
    assert res.metrics["streamed_batches"] == 3 * nbatches
    assert got == want


def test_fly_shape_truth(fly_small):
    """Reads with <= 2 seed and <= 5 mismatches are reported unique at
    their true position and strand (gendata.read_truth)."""
    _, _, want = fly_small
    start, inv, seedk, totalk = (np.concatenate(c) for c in zip(
        *gendata.read_truth(GENOME_BP, READS, FLY.patl, FLY.errprob,
                            FLY.seed + 1)))
    got_pos = np.full(READS, -1, np.int64)
    got_inv = np.zeros(READS, bool)
    for line in want.splitlines():
        f = line.split("\t")        # id seq score 1 a patl +/- frag pos
        i = int(f[0][1:])
        got_pos[i] = int(f[8]) - 1
        got_inv[i] = f[6] == "-"
    sel = (seedk <= 2) & (totalk <= FLY.totalkmax)
    ok = (got_pos == start) & (got_inv == inv)
    assert sel.sum() > 0.9 * READS
    assert ok[sel].mean() >= 0.999
