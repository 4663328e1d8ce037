"""The port's batch source (real_tpu_torch/io/pipeline.py BatchSource) in
both modes against real_tpu's, and parse_reads_sliced against real_tpu's.
Arrays equal exactly."""

import threading

import numpy as np
import pytest
import torch

from real_tpu.io import pipeline as j_pipeline
from real_tpu.io import reads as j_reads
from real_tpu_torch.config import RealConfig
from real_tpu_torch.engine import driver
from real_tpu_torch.io import pipeline, reads as reads_io
from tests import ab_util


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """700 FASTQ reads of 64 bases and 300 FASTA reads of two lengths."""
    d = tmp_path_factory.mktemp("pipe")
    g, fq = ab_util.make_inputs(d, n=30000, numpat=700, patlen=64,
                                fastq=True, seed=7, num_fragments=2)
    d2 = tmp_path_factory.mktemp("pipe_fa")
    _, fa = ab_util.make_inputs(d2, n=30000, numpat=200, patlen=50, seed=9)
    d3 = tmp_path_factory.mktemp("pipe_fa2")
    _, fa2 = ab_util.make_inputs(d3, n=30000, numpat=100, patlen=80, seed=10)
    mixed = str(d / "mixed.fa")
    with open(mixed, "w") as out:
        out.write(open(fa).read() + open(fa2).read())
    return g, fq, mixed


def _batches(src):
    return [(b.patids.copy(), b.patl, b.codes.numpy().copy(),
             None if b.quals is None else b.quals.numpy().copy(),
             b.valid.numpy().copy()) for b in src]


def _assert_same_batches(a, b):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x[0], y[0])
        assert x[1] == y[1]
        np.testing.assert_array_equal(x[2], y[2])
        assert (x[3] is None) == (y[3] is None)
        if x[3] is not None:
            np.testing.assert_array_equal(x[3], y[3])
        np.testing.assert_array_equal(x[4], y[4])


@pytest.mark.parametrize("which", ["fastq", "mixed_fasta"])
@pytest.mark.parametrize("native", [True, False], ids=["native", "plain"])
def test_streaming_equals_resident_batch_for_batch(data, which, native):
    _, fq, mixed = data
    path = fq if which == "fastq" else mixed
    rs = reads_io.parse_reads(path)
    resident = pipeline.make_source(rs, 128, 32, "cpu", use_native=native)
    stream = pipeline.make_source(rs, 128, 32, "cpu", use_native=native,
                                  resident_budget_bytes=1)
    assert resident.resident and not stream.resident
    assert stream.resident_device_bytes == 0
    has_q = rs.quals_flat is not None
    assert resident.resident_device_bytes == sum(
        pipeline.packed_batch_bytes(p.rows, p.patl, has_q)
        for p in resident.plans)
    a, b = _batches(resident), _batches(stream)
    _assert_same_batches(a, b)
    assert [len(x[0]) for x in a] == [len(p.patids) for p in resident.plans]
    # and equal to real_tpu's batches
    jrs = j_reads.parse_reads(path)
    jsrc = j_pipeline.make_source(jrs, 128, 32, resident_budget_bytes=1)
    assert resident.resident_device_bytes == sum(
        j_pipeline.packed_batch_bytes(p.rows, p.patl, has_q)
        for p in jsrc.plans)
    jb = [(x.patids, x.patl, np.asarray(x.codes),
           None if x.quals is None else np.asarray(x.quals),
           np.asarray(x.valid)) for x in jsrc]
    _assert_same_batches(a, jb)


def test_streaming_source_reiterates_from_its_host_cache(data, monkeypatch):
    _, fq, _ = data
    rs = reads_io.parse_reads(fq)
    src = pipeline.make_source(rs, 128, 32, "cpu", resident_budget_bytes=1)
    packs = []
    real = pipeline._pack_host_tensors
    monkeypatch.setattr(pipeline, "_pack_host_tensors",
                        lambda *a, **kw: packs.append(1) or real(*a, **kw))
    first, second = _batches(src), _batches(src)
    _assert_same_batches(first, second)
    assert len(first) == len(src.plans) == 6
    assert src.streamed_batches == 12
    assert len(packs) == 6                  # the second pass packs nothing
    # with no room in the host cache every pass packs again
    monkeypatch.setattr(pipeline, "_HOST_CACHE_MAX", 0)
    src2 = pipeline.make_source(rs, 128, 32, "cpu", resident_budget_bytes=1)
    _assert_same_batches(_batches(src2), _batches(src2))
    assert len(packs) == 6 + 12


def test_producer_error_reaches_the_consumer(data, monkeypatch):
    _, fq, _ = data
    rs = reads_io.parse_reads(fq)
    src = pipeline.make_source(rs, 128, 32, "cpu", resident_budget_bytes=1)
    real = pipeline._pack_host_tensors
    calls = []

    def failing(rs_, plan, *a, **kw):
        calls.append(1)
        if len(calls) == 3:
            raise OSError("read store vanished")
        return real(rs_, plan, *a, **kw)
    monkeypatch.setattr(pipeline, "_pack_host_tensors", failing)
    got = []
    with pytest.raises(OSError, match="read store vanished"):
        for b in src:
            got.append(b)
    assert len(got) == 2


def test_abandoned_stream_stops_its_producer(data):
    _, fq, _ = data
    rs = reads_io.parse_reads(fq)
    src = pipeline.make_source(rs, 128, 32, "cpu", resident_budget_bytes=1)
    before = threading.active_count()
    it = iter(src)
    next(it)
    it.close()                      # the consumer goes away mid-pass
    assert threading.active_count() == before


@pytest.mark.parametrize("unique", [True, False], ids=["unique", "all"])
def test_driver_streaming_equals_resident(data, unique):
    g, fq, _ = data
    rs = reads_io.parse_reads(fq)
    out = []
    for budget in (0, 1):
        cfg = RealConfig(textfilename=g, patternfilename=fq,
                         outputfilename="-", batch_size=128,
                         match_unique=unique, resident_reads_bytes=budget)
        texts = driver.load_texts(cfg, "cpu")
        if unique:
            res = driver.run_match_unique(cfg, rs, texts, "cpu")
            out.append([getattr(res, f) for f in
                        ("st", "pos", "frag", "fileid", "errs", "score")])
        else:
            res = driver.run_match_all(cfg, rs, texts, "cpu", as_arrays=True)
            out.append(list(res.cols))
        assert res.metrics["source_resident"] == (budget == 0)
        assert res.metrics["streamed_batches"] == (6 if budget else 0)
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)
    assert len(out[0][0]) > 500


@pytest.mark.parametrize("which", ["fastq", "mixed_fasta"])
@pytest.mark.parametrize("nranks", [1, 2, 3])
def test_parse_reads_sliced_equals_real_tpu(data, which, nranks):
    _, fq, mixed = data
    path = fq if which == "fastq" else mixed
    whole = reads_io.parse_reads(path)
    seen = 0
    for rank in range(nranks):
        for native in (True, False):
            rs, lo, nrec = reads_io.parse_reads_sliced(path, rank, nranks,
                                                       use_native=native)
            jrs, jlo, jnrec = j_reads.parse_reads_sliced(path, rank, nranks)
            assert (lo, nrec) == (jlo, jnrec)
            assert nrec == whole.num_reads
            assert reads_io.split_records(nrec, rank, nranks) \
                == j_reads.split_records(nrec, rank, nranks)
            assert rs.fastq == jrs.fastq
            assert rs.quality_offset == jrs.quality_offset
            np.testing.assert_array_equal(rs.lengths, jrs.lengths)
            np.testing.assert_array_equal(rs.codes_flat, jrs.codes_flat)
            np.testing.assert_array_equal(rs.offsets, jrs.offsets)
            if rs.fastq:
                np.testing.assert_array_equal(rs.quals_flat, jrs.quals_flat)
            assert list(rs.ids) == list(jrs.ids)
            # the slice is the whole file's records [lo, lo + n)
            np.testing.assert_array_equal(
                rs.lengths, whole.lengths[lo:lo + rs.num_reads])
            assert rs.ids[0] == whole.ids[lo]
        seen += rs.num_reads
    assert seen == whole.num_reads


def test_pinned_request_without_a_card_raises(data):
    """Pinned host memory belongs to the card's upload path; asking for it
    on a machine without CUDA raises instead of packing unpinned."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without CUDA")
    _, fq, _ = data
    rs = reads_io.parse_reads(fq)
    plan = pipeline.make_plans(rs, 128, 32)[0]
    with pytest.raises(RuntimeError):
        pipeline._pack_host_tensors(rs, plan, pinned=True)
