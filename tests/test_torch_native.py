"""The port's native host pipeline (real_tpu_torch/native/readpack.cpp and
its ctypes front-ends) against real_tpu's native entries and against the
port's own plain NumPy versions.

For every entry the same bytes go through real_tpu's native function, the
port's native function and the port's plain version, and all arrays (or
record bytes) must be equal: exact, no tolerance. The port's own number
writers (the formatter's "%lld" and "%.6g" without printf) are held against
Python's formatting and snprintf. A library that does not build must raise
and never step down to the NumPy versions."""

import ctypes
import io
import json
import threading
import types

import numpy as np
import pytest

from real_tpu import native as j_native
from real_tpu.cli import output as j_output
from real_tpu.engine import driver as j_driver
from real_tpu.io import fasta as j_fasta
from real_tpu.io import native_io as j_native_io
from real_tpu.io import pipeline as j_pipeline
from real_tpu.io import reads as j_reads
from real_tpu_torch import bitpack, native
from real_tpu_torch.cli import main as t_main
from real_tpu_torch.cli import output as t_output
from real_tpu_torch.engine import driver as t_driver
from real_tpu_torch.io import fasta as t_fasta
from real_tpu_torch.io import native_io as t_native_io
from real_tpu_torch.io import pipeline as t_pipeline
from real_tpu_torch.io import reads as t_reads
from real_tpu_torch.tools import scorecheck, simulate
from real_tpu_torch.utils import spans


def _buf(text) -> np.ndarray:
    raw = text if isinstance(text, bytes) else text.encode("latin-1")
    return np.frombuffer(raw, dtype=np.uint8)


def _assert_readsets_equal(a, b):
    """Two ReadSets (of either package) hold the same arrays."""
    assert a.fastq == b.fastq and a.quality_offset == b.quality_offset
    assert a.num_reads == b.num_reads
    for f in ("lengths", "codes_flat", "offsets"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert (a.quals_flat is None) == (b.quals_flat is None)
    if a.quals_flat is not None:
        assert a.quals_flat.dtype == b.quals_flat.dtype == np.int8
        np.testing.assert_array_equal(a.quals_flat, b.quals_flat)
    assert list(a.ids) == list(b.ids)
    if hasattr(a.ids, "blob") and hasattr(b.ids, "blob"):
        np.testing.assert_array_equal(a.ids.blob, b.ids.blob)
        np.testing.assert_array_equal(a.ids.off, b.ids.off)


def _simulated(n_reads, patl, fastq, seed, n_prob=0.0):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, 6000).astype(np.uint8)
    rows = simulate.generate_reads(codes, n_reads, patl, 0.05, fastq,
                                   seed=seed + 1)
    return rows


def test_real_tpu_native_library_is_present():
    """The comparisons below are against real_tpu's native entries, not
    against its NumPy fallbacks."""
    assert j_native.get_lib() is not None


# ---------------------------------------------------------------------------
# FASTA reads
# ---------------------------------------------------------------------------

FASTA_CASES = {
    "plain": ">r0\nACGTACGT\n>r1\nTTTTGGGG\n",
    "multi_line": ">r0 first\nACGT\nACGT\nAC\n>r1\nGG\nTT\n",
    "crlf": ">r0\r\nACGTAC\r\n>r1\r\nGGTTAA\r\nCC\r\n",
    "empty_ids": ">\nACGT\n>\nGGCC\n>x\nTT\n",
    "n_and_lower_case": ">r0\nACGTNNacgtnRYK\n>r1\nnnnnACGT\n",
    "no_final_newline": ">r0\nACGT\n>r1\nGGTT",
    "header_at_the_end": ">r0\nACGT\n>r1",
    "blank_lines_and_spaces": ">r0\n\nAC GT\n\t\n>r1\n  \nGG\n\n",
    "junk_before_first_record": "ACGT\nGG\n>r0\nTTAA\n",
    "empty_records": ">r0\n>r1\n>r2\nACGT\n",
    "latin1_ids": b">r\xe9\xff0\nACGT\n>\x80\nGG\n",
}


@pytest.mark.parametrize("case", sorted(FASTA_CASES))
def test_fasta_reads_three_ways(case):
    buf = _buf(FASTA_CASES[case])
    want = j_native_io.parse_fasta_reads_native(buf)
    assert want is not None
    got = t_native_io.parse_fasta_reads_native(buf)
    _assert_readsets_equal(got, want)
    _assert_readsets_equal(got, t_reads.parse_fasta_reads_bytes(buf))
    assert got.num_reads >= 1 and not got.fastq


def test_fasta_reads_simulated_file(tmp_path):
    rows = _simulated(400, 75, False, seed=3)
    path = str(tmp_path / "r.fa")
    simulate.write_reads(rows, path, False)
    want = j_reads.parse_reads(path)
    got = t_reads.parse_reads(path)
    plain = t_reads.parse_reads(path, use_native=False)
    _assert_readsets_equal(got, want)
    _assert_readsets_equal(got, plain)
    assert isinstance(got.ids, t_reads.IdView) and got.num_reads == 400


# ---------------------------------------------------------------------------
# FASTQ
# ---------------------------------------------------------------------------

def _fastq_text(offset, crlf=False):
    rng = np.random.default_rng(offset)
    nl = "\r\n" if crlf else "\n"
    out = []
    for i in range(40):
        L = 20 + i % 7
        seq = "".join("ACGTN"[c] for c in rng.choice(5, L, p=[.24] * 4 + [.04]))
        q = "".join(chr(offset + int(v)) for v in rng.integers(2, 41, L))
        out.append(f"@q{i} len={L}{nl}{seq}{nl}+{nl}{q}{nl}")
    return "".join(out)


FASTQ_CASES = {
    # text, quality_offset argument, detected or given offset
    "offset_33": (_fastq_text(33), 33, 33),
    "offset_64": (_fastq_text(64), 64, 64),
    "autodetect_33": (_fastq_text(33), 0, 33),
    "autodetect_64": (_fastq_text(64), 0, 64),
    "crlf_autodetect": (_fastq_text(33, crlf=True), 0, 33),
    "plus_line_repeats_id": ("@a\nACGT\n+a\n!!!!\n@b\nGGCC\n+b\n#$%&\n", 0,
                             33),
    "no_final_newline": ("@a\nACGT\n+\n!!!!\n@b\nGGCC\n+\n####", 33, 33),
}


@pytest.mark.parametrize("case", sorted(FASTQ_CASES))
def test_fastq_three_ways(case):
    text, arg, offset = FASTQ_CASES[case]
    buf = _buf(text)
    want = j_native_io.parse_fastq_native(buf, arg)
    assert want is not None
    got = t_native_io.parse_fastq_native(buf, arg)
    _assert_readsets_equal(got, want)
    _assert_readsets_equal(got, t_reads.parse_fastq_bytes(buf, arg))
    assert got.fastq and got.quality_offset == offset
    assert got.quals_flat.min() >= 0 and got.quals_flat.max() <= 41


def test_fastq_undetectable_offset_raises_everywhere():
    # every quality character lies between '7' (55) and ']' (93)
    buf = _buf("@a\nACGT\n+\nAAAA\n@b\nGGCC\n+\nBBBB\n")
    for parse in (j_native_io.parse_fastq_native,
                  t_native_io.parse_fastq_native,
                  t_reads.parse_fastq_bytes):
        with pytest.raises(RuntimeError, match="quality format"):
            parse(buf, 0)


IRREGULAR_FASTQ = {
    "two_line_sequence": "@a\nACGT\nACGT\n+\n!!!!!!!!\n",
    "missing_plus": "@a\nACGT\n!!!!\n@b\nGGCC\n+\n!!!!\n",
    "quality_length_differs": "@a\nACGT\n+\n!!!\n@b\nGGCC\n+\n!!!!\n",
    "truncated": "@a\nACGT\n+\n!!!!\n@b\nGG\n",
}


@pytest.mark.parametrize("case", sorted(IRREGULAR_FASTQ))
def test_irregular_fastq_takes_the_general_parser(tmp_path, case):
    """fastq_reads_count returns -1 for a buffer that is not 4-line
    regular: both packages then take the NumPy parser, and both end the
    same way (the same exception, or the same read set)."""
    buf = _buf(IRREGULAR_FASTQ[case])
    assert j_native_io.parse_fastq_native(buf, 33) is None
    assert t_native_io.parse_fastq_native(buf, 33) is None
    path = tmp_path / "r.fq"
    path.write_bytes(buf.tobytes())
    outcomes = []
    for parse in (j_reads.parse_reads, t_reads.parse_reads):
        try:
            outcomes.append(parse(str(path), 33))
        except (ValueError, IndexError) as e:
            outcomes.append(type(e))
    if isinstance(outcomes[0], type):
        assert outcomes[1] is outcomes[0]
    else:
        _assert_readsets_equal(outcomes[1], outcomes[0])


# ---------------------------------------------------------------------------
# genome
# ---------------------------------------------------------------------------

GENOME_CASES = {
    "one_fragment": ">chr1\nACGTACGTAC\nGGTTAACC\n",
    "several_fragments": ">chr1 a b\nACGT\nAC\n>chr2\nGGGG\n>chr3\nTT\nTT\n",
    "lower_case_and_n": ">c\nACGTnnnnNNNNacgtRYACGT\n>d\nNNNN\nacgt\nAC\n",
    "crlf": ">chr1\r\nACGT\r\nGG\r\n>chr2\r\nTT\r\n",
    "no_header": "ACGTACGT\nGGCC\n",
    "header_without_final_newline": ">chr1\nACGT\n>chr2",
    "no_final_newline": ">chr1\nACGT\n>chr2\nGGTT",
    "empty_fragments": ">a\n>b\n>c\nACGT\n>d\n",
    "latin1_names": b">chr\xe9\xff\nACGT\n>\x80\nGG\n",
}


@pytest.mark.parametrize("case", sorted(GENOME_CASES))
def test_genome_three_ways(case):
    buf = _buf(GENOME_CASES[case])
    want = j_native_io.parse_genome_native(buf)
    assert want is not None
    got = t_native_io.parse_genome_native(buf)
    plain = t_fasta.parse_genome_bytes(buf)
    for codes, ranges in (got, plain):
        assert codes.dtype == np.uint8
        np.testing.assert_array_equal(codes, want[0])
        assert ranges == want[1]
    assert got[1][-1] == ("terminal", len(got[0]))


def test_genome_file_with_fragments(tmp_path):
    path = str(tmp_path / "g.fa")
    with open(path, "w") as f:
        f.write(simulate.random_genome(30000, seed=4, n_prob=0.003,
                                       num_fragments=7))
    want = j_fasta.parse_genome(path)
    got = t_fasta.parse_genome(path)
    plain = t_fasta.parse_genome(path, use_native=False)
    for codes, ranges in (got, plain):
        np.testing.assert_array_equal(codes, want[0])
        assert ranges == want[1]
    assert len(got[1]) == 8 and (got[0] == 4).any()


def test_empty_files_parse_to_nothing(tmp_path):
    path = tmp_path / "empty.fa"
    path.write_bytes(b"")
    assert t_reads.parse_reads(str(path)).num_reads == 0
    codes, ranges = t_fasta.parse_genome(str(path))
    assert len(codes) == 0 and ranges == [("terminal", 0)]


# ---------------------------------------------------------------------------
# row packer
# ---------------------------------------------------------------------------

def _read_file(tmp_path, patl, fastq, seed):
    rows = _simulated(300, patl, fastq, seed)
    path = str(tmp_path / ("r.fq" if fastq else "r.fa"))
    simulate.write_reads(rows, path, fastq)
    return path


@pytest.mark.parametrize("patl", [50, 100, 101])
@pytest.mark.parametrize("fastq", [False, True], ids=["fasta", "fastq"])
@pytest.mark.parametrize("contiguous", [True, False],
                         ids=["contiguous", "every_third_read"])
def test_pack_host_three_ways(tmp_path, patl, fastq, contiguous):
    path = _read_file(tmp_path, patl, fastq, seed=patl)
    j_rs, t_rs = j_reads.parse_reads(path), t_reads.parse_reads(path)
    # a few reads with N: they pack as their low bits and are not valid
    for rs in (j_rs, t_rs):
        rs.codes_flat[patl * 5 + 3] = 4
        rs.codes_flat[patl * 9] = 4
    patids = np.arange(0, 300, 1 if contiguous else 3, dtype=np.int64)
    rows = 512
    want = j_pipeline._pack_host(
        j_rs, j_pipeline.BatchPlan(patids=patids, patl=patl, rows=rows))
    plan = t_pipeline.BatchPlan(patids=patids, patl=patl, rows=rows)
    got = t_pipeline._pack_host(t_rs, plan)
    plain = t_pipeline._pack_host(t_rs, plan, use_native=False)
    chunked = t_pipeline._pack_host(t_rs, plan, chunk=37)
    for words, quals, valid in (got, plain, chunked):
        assert words.dtype == np.uint32
        assert words.shape == (rows, (patl + 15) // 16)
        np.testing.assert_array_equal(words, want[0])
        np.testing.assert_array_equal(valid, want[2])
        assert (quals is None) == (not fastq)
        if fastq:
            np.testing.assert_array_equal(quals, want[1])
    n = len(patids)
    assert got[2][:n].sum() == n - (2 if contiguous else 1)
    assert not got[2][n:].any() and not got[0][n:].any()


@pytest.mark.parametrize("patl", [1, 15, 16, 17, 50, 100, 101])
def test_native_row_packer_equals_bitpack(patl):
    import ctypes
    rng = np.random.default_rng(patl)
    codes = rng.integers(0, 5, (64, patl)).astype(np.uint8)
    kw = (patl + 15) // 16
    out = np.full((64, kw), 0xFFFFFFFF, np.uint32)
    native.get_lib().pack_rows_2bit(
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), 64, patl,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), kw)
    np.testing.assert_array_equal(out, bitpack.pack_rows_2bit(codes))


# ---------------------------------------------------------------------------
# radix argsort and the hit sort
# ---------------------------------------------------------------------------

def _three_keys(rng, n, bits):
    """Three uint64 keys with ties in every key and values up to `bits`
    bits."""
    ks = []
    for b in bits:
        pool = rng.integers(0, 1 << b, max(n // 6, 1),
                            dtype=np.uint64) if b < 64 else \
            rng.integers(0, 2**63, max(n // 6, 1), dtype=np.uint64) * 2 + 1
        ks.append(pool[rng.integers(0, len(pool), n)])
    return ks


@pytest.mark.parametrize("n,bits", [(0, (8, 8, 8)), (1, (8, 8, 8)),
                                    (2, (1, 1, 1)), (5000, (3, 3, 3)),
                                    (5000, (11, 12, 23)),
                                    (5000, (33, 47, 64)),
                                    (3000, (64, 1, 40))],
                         ids=["empty", "one", "two", "many_ties", "digits",
                              "wide", "constant_middle"])
def test_radix_argsort3_is_three_stable_passes(n, bits):
    p1, p2, p3 = _three_keys(np.random.default_rng(n + sum(bits)), n, bits)
    if bits[1] == 1:
        p2[:] = 7                       # a key whose digits are all constant
    got = t_driver._radix_argsort3(p1, p2, p3)
    assert got.dtype == np.int64 and got.shape == (n,)
    want = np.argsort(p1, kind="stable")
    want = want[np.argsort(p2[want], kind="stable")]
    want = want[np.argsort(p3[want], kind="stable")]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.lexsort((p1, p2, p3)))
    np.testing.assert_array_equal(got, j_driver._radix_argsort3(p1, p2, p3))


def _hit_cols(rng, n):
    pid = rng.integers(0, 50, n).astype(np.int64)
    k = rng.integers(0, 4, n).astype(np.int64)
    pos = rng.integers(0, 40, n).astype(np.int64) * 5
    fid = rng.integers(0, 3, n).astype(np.int64)
    frag = pos // 50 + fid
    score = rng.choice(np.array([-2.5, -0.0, 0.0, 1e-7, 0.25, 7.5, -3e38],
                                np.float32), n)
    inv = rng.random(n) < 0.5
    cols = [pid, k, pos, fid, frag, score, inv]
    dup = rng.integers(0, n, n // 3)
    return tuple(np.concatenate([c, c[dup]]) for c in cols)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sort_dedup_hits_native_plain_and_real_tpu(seed):
    cols = _hit_cols(np.random.default_rng(seed), 4000)
    want = j_driver._sort_dedup_hits(cols)
    got = t_driver._sort_dedup_hits(cols)
    plain = t_driver._sort_dedup_hits(cols, use_native=False)
    assert len(got[0]) < len(cols[0])
    for g, p, w in zip(got, plain, want):
        assert g.dtype == w.dtype == p.dtype
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(p, w)
    # the order is the seven-key order (with -0.0 == +0.0)
    pid, k, pos, fid, frag, score, inv = got
    order = np.lexsort((inv, score + np.float32(0.0), frag, fid, pos, k, pid))
    np.testing.assert_array_equal(order, np.arange(len(pid)))
    # -0.0 and +0.0 tie: one record survives of an otherwise equal pair
    pair = tuple(np.array(v, dt) for v, dt in zip(
        ([3, 3], [1, 1], [10, 10], [0, 0], [0, 0], [0.0, -0.0],
         [True, True]), t_driver.HIT_DTYPES))
    for use_native in (True, False):
        assert len(t_driver._sort_dedup_hits(pair, use_native)[0]) == 1


# ---------------------------------------------------------------------------
# record formatter
# ---------------------------------------------------------------------------

def _texts():
    """Two text files with three and two fragments (only .packed.ranges is
    read by the formatters)."""
    def tf(ranges):
        return types.SimpleNamespace(
            packed=types.SimpleNamespace(ranges=ranges))
    return [tf([("chr1 first", 0), ("chr2", 700), ("", 1500),
                ("terminal", 2600)]),
            tf([("b\xe9ta", 0), ("gamma\r", 90), ("terminal", 400)])]


def _format_case(tmp_path, seed, repeat):
    path = str(tmp_path / "r.fa")
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(120):
        L = int(rng.choice([36, 50, 75, 101]))
        seq = "".join("ACGTN"[c] for c in rng.choice(5, L,
                                                     p=[.245] * 4 + [.02]))
        rows.append(f">read{i} /{L}\n{seq}\n")
    rows[7] = ">\nACGTACGTACGTACGT\n"           # an empty id
    with open(path, "w") as f:
        f.write("".join(rows))
    n = 300 if repeat else 90
    pids = np.sort(rng.integers(0, 120, n)) if repeat \
        else np.sort(rng.choice(120, n, replace=False))
    fileid = rng.integers(0, 2, n)
    frag = np.where(fileid == 0, rng.integers(0, 3, n), rng.integers(0, 2, n))
    starts = np.array([[0, 700, 1500], [0, 90, 0]])
    pos = starts[fileid, frag] + rng.integers(0, 60, n)
    score = rng.choice(np.array(
        [0.0, -0.0, 1.0, -12.5, 123456.7, 1234567.0, 1e-7, 3.14159274,
         -3.0e38, 0.1, 99999.95, 1e-5], np.float64), n) \
        * rng.choice([1.0, 1.0000001], n)
    return (path, pids.astype(np.int64), rng.random(n) < 0.5,
            fileid.astype(np.int64), frag.astype(np.int64),
            pos.astype(np.int32), rng.integers(0, 6, n).astype(np.int32),
            score)


@pytest.mark.parametrize("scores", [True, False],
                         ids=["scores", "no_scores"])
@pytest.mark.parametrize("repeat", [False, True],
                         ids=["unique_pids", "repeated_pids"])
def test_format_records_three_ways(tmp_path, scores, repeat):
    path, *cols = _format_case(tmp_path, seed=11 + repeat, repeat=repeat)
    texts = _texts()
    j_rs, t_rs = j_reads.parse_reads(path), t_reads.parse_reads(path)
    want = j_output._format_records_native(j_rs, *cols, texts, scores)
    assert want is not None
    got = t_output._format_records_native(t_rs, *cols, texts, scores)
    plain = t_output._format_records_plain(t_rs, *cols, texts, scores)
    assert got == want
    assert got == plain
    assert got.count(b"\n") == len(cols[0])
    first = got.split(b"\n")[0].split(b"\t")
    assert len(first) == 11 and (first[2] != b"") == scores
    # float32 scores (matchAll's column type) print the same bytes
    cols32 = cols[:-1] + [cols[-1].astype(np.float32)]
    assert t_output._format_records_native(t_rs, *cols32, texts,
                                           scores) == got


def test_format_records_takes_the_plain_version_for_string_ids(tmp_path):
    path, *cols = _format_case(tmp_path, seed=5, repeat=True)
    rs = t_reads.parse_reads(path)
    as_list = t_reads.ReadSet(list(rs.ids), rs.lengths, rs.codes_flat,
                              rs.offsets, None, False)
    assert t_output._format_records(as_list, *cols, _texts(), True) \
        == t_output._format_records(rs, *cols, _texts(), True)


def test_emit_chunks_keeps_order_and_reraises():
    blobs = [bytes([65 + i % 26]) * (i % 5 + 1) for i in range(200)]

    def make_blob(s, e):
        return b"".join(blobs[s:e])

    for chunk in (1, 7, 64, 200, 500):
        out = io.BytesIO()
        t_output._emit_chunks(out, make_blob, len(blobs), chunk=chunk)
        assert out.getvalue() == b"".join(blobs)

    def bad_blob(s, e):
        if s >= 40:
            raise KeyError("formatter failed")
        return make_blob(s, e)

    with pytest.raises(KeyError):
        t_output._emit_chunks(io.BytesIO(), bad_blob, len(blobs), chunk=8)

    class Full:
        def write(self, b):
            raise OSError("disk full")

    done = []

    def run():
        try:
            t_output._emit_chunks(Full(), make_blob, len(blobs), chunk=8)
        except OSError as e:
            done.append(e)

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive() and len(done) == 1


@pytest.mark.parametrize("unique", [True, False], ids=["unique", "all"])
def test_writers_native_equals_plain_across_chunks(tmp_path, monkeypatch,
                                                   unique):
    """write_unique / write_all_arrays over several chunks and threads:
    native and plain print the same bytes."""
    path, pids, inv, fileid, frag, pos, errs, score = _format_case(
        tmp_path, seed=23, repeat=not unique)
    rs = t_reads.parse_reads(path)
    texts = _texts()
    monkeypatch.setattr(t_output, "_CHUNK_RECORDS", 16)
    # _emit_chunks' default was bound at definition: pass through a wrapper
    real_emit = t_output._emit_chunks
    monkeypatch.setattr(t_output, "_emit_chunks",
                        lambda out, mk, n: real_emit(out, mk, n, chunk=16))
    outs = []
    for use_native in (True, False):
        buf = io.BytesIO()
        if unique:
            st = np.zeros(120, np.int32)
            res = t_driver.MatchResult(
                st=st, pos=np.zeros(120, np.int32),
                frag=np.zeros(120, np.int32), fileid=np.zeros(120, np.int32),
                errs=np.zeros(120, np.int32),
                score=np.zeros(120, np.float32))
            res.st[pids] = np.where(inv, 2, 1)
            res.pos[pids], res.frag[pids] = pos, frag
            res.fileid[pids], res.errs[pids] = fileid, errs
            res.score[pids] = score
            n = t_output.write_unique(buf, rs, res, texts, True, use_native)
            assert n == len(pids)
        else:
            cols = (pids, errs.astype(np.int64), pos.astype(np.int64),
                    fileid, frag, score.astype(np.float32), inv)
            n = t_output.write_all_arrays(buf, rs, cols, texts, True,
                                          use_native)
        assert buf.getvalue().count(b"\n") == n > 16 * 3
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# the formatter's number writers: "%lld" and the score's "%.6g"
# ---------------------------------------------------------------------------

def _u8p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _format_int(v):
    out = np.zeros(32, np.uint8)
    n = native.get_lib().format_int(v, _u8p(out))
    return out[:n].tobytes()


def _snprintf_lld(v):
    out = ctypes.create_string_buffer(32)
    n = ctypes.CDLL(None).snprintf(out, 32, b"%lld", ctypes.c_longlong(v))
    return out.raw[:n]


INT_CASES = {f"1e{j}": [10**j - 1, 10**j, 10**j + 1] for j in range(19)}
INT_CASES.update({
    "2^31": [2**31 - 1, 2**31, 2**31 + 1],
    "int64_ends": [2**63 - 1, 2**63 - 2, -2**63, -2**63 + 1],
    "small_and_negative": [0, 1, 5, -1, -10, -99, -100, -2**31],
})


@pytest.mark.parametrize("case", list(INT_CASES))
def test_integer_writer_is_printf_lld(case):
    for v in INT_CASES[case]:
        assert _format_int(v) == b"%d" % v == _snprintf_lld(v), v


def _format_scores(values):
    """The native writer's bytes of each float32 score, and its slow
    count."""
    f = np.ascontiguousarray(values, np.float32)
    out = np.zeros(32 * len(f) + 1, np.uint8)
    slow = ctypes.c_int64(-1)
    n = native.get_lib().format_scores(
        len(f), f.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), _u8p(out),
        ctypes.byref(slow))
    return out[:n].tobytes().split(b"\n")[:-1], slow.value


def _pct6g(values):
    return [("%.6g" % float(v)).encode()
            for v in np.asarray(values, np.float32)]


def _fast(values):
    """Whether each float32 takes the integer path: 0 and 1e-3 <= |f| <
    1e9."""
    a = np.abs(np.asarray(values, np.float32).astype(np.float64))
    return (a == 0) | ((a >= 1e-3) & (a < 1e9))


# the fast range's float32 bit patterns, positive: 1e-3 rounds up in
# float32, 1e9 is exact and out of range
FAST_LO, FAST_HI = 0x3A83126F, 0x4E6E6B28


def _seeded_scores(kind, seed, n=100_000):
    rng = np.random.default_rng(seed)
    sign = np.where(rng.random(n) < 0.5, -1.0, 1.0)
    if kind == "bits":          # every binade of the range alike
        bits = rng.integers(FAST_LO, FAST_HI, n).astype(np.uint32)
        return bits.view(np.float32) * sign.astype(np.float32)
    if kind == "scores":        # a 50-150 bp read's score range
        return rng.uniform(-1479.0, 343.0, n)
    if kind == "decimals":      # short decimals, near 6-digit ties
        return (rng.integers(1, 10**7, n) / 10.0 ** rng.integers(0, 9, n)
                * sign)
    raise ValueError(kind)


@pytest.mark.parametrize("kind,seed", [("bits", 1), ("bits", 2),
                                       ("scores", 3), ("decimals", 4)])
def test_score_writer_is_python_pct6g_on_seeded_values(kind, seed):
    v = _seeded_scores(kind, seed)
    v = v[_fast(v)]
    assert len(v) > 80_000
    got, slow = _format_scores(v)
    assert slow == 0
    assert got == _pct6g(v)


def _ulps(x):
    x = np.float32(x)
    return [np.nextafter(x, np.float32(-np.inf)), x,
            np.nextafter(x, np.float32(np.inf))]


# values whose digits past the sixth are an exact half (float32-exact)
EXACT_HALVES = [100000.5, 100001.5, 123456.5, 123457.5, 999998.5,
                1234565.0, 1234575.0, 9999985.0, 9999995.0, 12345650.0,
                12345750.0]

SCORE_EDGES = {
    **{f"1e{j}": _ulps(10.0 ** j) for j in range(-3, 10)},
    "exact_halves": EXACT_HALVES + [-h for h in EXACT_HALVES],
    "carry_to_1e6": [999999.5, 999999.0, 999999.4375, 999999.5625,
                     *_ulps(999999.5), 99999.95, 99999.949, 9999.995,
                     9.999995, 0.999999, 0.9999995, 0.00999999,
                     0.009999995, 99999950.0, 999999500.0, -999999.5],
    "zeros": [0.0, -0.0],
}


@pytest.mark.parametrize("case", list(SCORE_EDGES))
def test_score_writer_is_python_pct6g_at_the_edges(case):
    v = np.array(SCORE_EDGES[case], np.float32)
    if case == "exact_halves":
        assert (v.astype(np.float64) == np.array(SCORE_EDGES[case])).all()
    got, slow = _format_scores(v)
    assert got == _pct6g(v)
    assert slow == int((~_fast(v)).sum())
    if case == "zeros":
        assert got == [b"0", b"-0"]


SLOW_SCORES = {"9.99e-4": 9.99e-4, "1e9": 1e9, "3.4e38": 3.4e38,
               "smallest_subnormal": float(np.uint32(1).view(np.float32)),
               "inf": np.inf, "-inf": -np.inf, "nan": np.nan}


@pytest.mark.parametrize("case", list(SLOW_SCORES))
def test_slow_path_scores_are_right_and_counted_once(tmp_path, case):
    v = np.float32(SLOW_SCORES[case])
    assert not _fast([v])[0]
    got, slow = _format_scores([v])
    assert got == _pct6g([v]) and slow == 1
    # through a record: the job's counter output.score_slow counts it once
    path = str(tmp_path / "r.fa")
    with open(path, "w") as f:
        f.write(">r0\nACGTACGTACGTACGTAC\n")
    rs = t_reads.parse_reads(path)
    one = [np.zeros(1, np.int64), np.zeros(1, bool), np.zeros(1, np.int64),
           np.zeros(1, np.int64), np.full(1, 5, np.int32),
           np.ones(1, np.int32), np.full(1, v, np.float32)]
    rec = spans.Recorder()
    with rec.job():
        line = t_output._format_records_native(rs, *one, _texts(), True)
    assert rec.counters["output.score_slow"] == 1
    assert line.split(b"\t")[2] == got[0]
    assert line == t_output._format_records_plain(rs, *one, _texts(), True)


@pytest.mark.parametrize("case", ["strided", "low_edge", "high_edge",
                                  "negative_edges"])
def test_score_check_agrees_with_snprintf(case):
    """tools/scorecheck.py's native check: the integer path against
    snprintf on a strided slice of every float32 pattern (the tool runs
    them all), and pattern by pattern across the range's ends, where it
    compares exactly the patterns inside."""
    if case == "strided":
        bad, seen = scorecheck.check(stride=1021, threads=4)
        mag = np.arange(0, 1 << 32, 1021, dtype=np.uint64) & 0x7FFFFFFF
        want = ((mag == 0) | ((mag >= FAST_LO) & (mag < FAST_HI))).sum()
        assert bad == 0 and seen == want > 600_000
        return
    sign = 0x80000000 if case == "negative_edges" else 0
    edges = {"low_edge": [FAST_LO], "high_edge": [FAST_HI],
             "negative_edges": [FAST_LO, FAST_HI]}[case]
    for edge in edges:
        lo = sign | (edge - 500)
        bad, seen = scorecheck.check(stride=1, threads=2, lo=lo,
                                     hi=lo + 1000)
        assert bad == 0 and seen == 500


@pytest.mark.parametrize("flags", [[], ["-u", "0"]], ids=["unique", "all"])
def test_cli_counts_the_records_and_no_slow_score(tmp_path, flags):
    """A CLI job's -metrics counters: output.records is the lines printed
    and output.score_slow 0 (scores on); -native 0 prints the same bytes
    and counts the same records."""
    genome, reads = str(tmp_path / "g.fa"), str(tmp_path / "r.fq")
    with open(genome, "w") as f:
        f.write(simulate.random_genome(20000, seed=61))
    codes, _ = t_fasta.parse_genome(genome)
    simulate.write_reads(simulate.generate_reads(codes, 300, 75, 0.02, True,
                                                 seed=62), reads, True)
    runs = []
    for native_flag in ("1", "0"):
        out, m = tmp_path / f"o{native_flag}.txt", tmp_path / "m.json"
        assert t_main.main(["-device", "cpu", "-t", genome, "-p", reads,
                            "-o", str(out), "-q", "1", "-e", "3", "-R", "0",
                            "-native", native_flag, "-metrics", str(m),
                            *flags]) == 0
        runs.append((out.read_bytes(), json.loads(m.read_text())))
    (got, m), (plain, m0) = runs
    lines = got.count(b"\n")
    assert lines > 250 and got == plain
    assert m["counters"]["output.records"] == lines
    assert m["counters"]["output.score_slow"] == 0
    assert m0["counters"]["output.records"] == lines
    scores = [ln.split(b"\t")[2] for ln in got.splitlines()]
    assert all(s and s != b"0" for s in scores)


# ---------------------------------------------------------------------------
# a build or load failure raises
# ---------------------------------------------------------------------------

def _definitions(path):
    """A C++ source's top-level definitions and declarations, comments
    and the namespace and extern "C" wrappers aside: {first line: code
    lines}."""
    import re
    text = re.sub(r"//[^\n]*", "", open(path).read())
    defs, cur, depth = {}, [], 0
    for ln in (ln.strip() for ln in text.splitlines()):
        if not ln or (depth == 0 and ln in ("namespace {", 'extern "C" {',
                                            "}")):
            continue
        cur.append(ln)
        depth += ln.count("{") - ln.count("}")
        if depth == 0 and (ln.startswith("#") or ln.endswith(("}", ";"))):
            defs[cur[0]] = cur
            cur = []
    assert depth == 0 and not cur
    return defs


def test_source_is_the_ports_own_copy():
    """real_tpu's readpack.cpp, kept in the port's package, with the
    record formatter's numbers written without printf: every other
    definition is real_tpu's code (comments aside); no built library is
    committed beside it."""
    import os

    assert native.SRC.name == "readpack.cpp"
    assert "real_tpu_torch" in str(native.SRC)
    theirs = _definitions(os.path.join(os.path.dirname(j_native.__file__),
                                       "readpack.cpp"))
    ours = _definitions(str(native.SRC))
    changed = {"int64_t format_records("}
    assert changed <= set(theirs) and set(theirs) <= set(ours)
    for head, code in theirs.items():
        if head not in changed:
            assert ours[head] == code, head
    assert len(theirs) > 20 and {"int64_t format_int(int64_t v, uint8_t* "
                                 "out) {"} <= set(ours)
    tracked = [f for f in os.listdir(native.SRC.parent) if f.endswith(".so")]
    assert tracked == []


def test_failed_build_raises_and_nothing_steps_down(tmp_path, monkeypatch):
    bad = tmp_path / "readpack.cpp"
    bad.write_text(native.SRC.read_text() + "\nthis is not C++ ;\n")
    with pytest.raises(RuntimeError, match="failed for"):
        native.library_path(bad, tmp_path / "build")
    assert not list((tmp_path / "build").glob("*.so"))
    # with the loader pointed at that source every host entry point raises
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    reads = tmp_path / "r.fa"
    reads.write_text(">r0\nACGTACGTACGTACGTACGTACGTACGTACGTACGT\n")
    genome = tmp_path / "g.fa"
    genome.write_text(">g\nACGTACGT\n")
    with pytest.raises(RuntimeError, match="failed for"):
        t_reads.parse_reads(str(reads))
    with pytest.raises(RuntimeError, match="failed for"):
        t_fasta.parse_genome(str(genome))
    rs = t_reads.parse_reads(str(reads), use_native=False)
    plan = t_pipeline.BatchPlan(patids=np.arange(1), patl=36, rows=512)
    with pytest.raises(RuntimeError, match="failed for"):
        t_pipeline._pack_host(rs, plan)
    cols = _hit_cols(np.random.default_rng(0), 30)
    with pytest.raises(RuntimeError, match="failed for"):
        t_driver._sort_dedup_hits(cols)
    with pytest.raises(RuntimeError, match="failed for"):
        t_output._format_records(
            rs, np.zeros(1, np.int64), np.zeros(1, bool),
            np.zeros(1, np.int64), np.zeros(1, np.int64),
            np.zeros(1, np.int32), np.zeros(1, np.int32), np.zeros(1),
            _texts(), True)
    # the plain versions still answer when asked for by name
    assert rs.num_reads == 1
    assert len(t_driver._sort_dedup_hits(cols, use_native=False)[0]) > 0


def test_missing_compiler_raises(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("CXX", "no-such-compiler-xyz")
    with pytest.raises(RuntimeError, match="not found"):
        native.get_lib()
    with pytest.raises(RuntimeError, match="not found"):
        t_native_io.parse_fasta_reads_native(_buf(">r\nACGT\n"))


def test_unloadable_library_raises(tmp_path):
    junk = tmp_path / "libreadpack-junk.so"
    junk.write_bytes(b"not an ELF file")
    with pytest.raises(OSError):
        native.load_library(junk)
