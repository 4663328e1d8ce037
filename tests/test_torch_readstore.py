"""The port's packed read store (real_tpu_torch/io/readstore.py, -R 1)
against real_tpu's: the same path rule, version and file layout, so a
store written by either package loads in the other; and through the CLI a
second run loads the store and prints the same bytes. All comparisons are
exact."""

import os

import numpy as np
import pytest

from real_tpu.io import reads as j_reads
from real_tpu.io import readstore as j_store
from real_tpu_torch.cli import main as t_main
from real_tpu_torch.io import reads as t_reads
from real_tpu_torch.io import readstore as t_store
from tests import ab_util


def _assert_same_reads(a, b):
    assert a.fastq == b.fastq and a.quality_offset == b.quality_offset
    for f in ("lengths", "codes_flat", "offsets"):
        assert getattr(a, f).dtype == getattr(b, f).dtype
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert (a.quals_flat is None) == (b.quals_flat is None)
    if a.quals_flat is not None:
        np.testing.assert_array_equal(a.quals_flat, b.quals_flat)
    np.testing.assert_array_equal(a.ids.blob, b.ids.blob)
    np.testing.assert_array_equal(a.ids.off, b.ids.off)


@pytest.fixture(params=[False, True], ids=["fasta", "fastq"])
def reads_file(tmp_path, request):
    _, reads = ab_util.make_inputs(tmp_path, n=8000, numpat=150, patlen=60,
                                   fastq=request.param, seed=17)
    return reads


def test_store_constants_are_real_tpus(reads_file):
    assert t_store.STORE_VERSION == j_store.STORE_VERSION
    assert t_store._ARRAYS == j_store._ARRAYS
    assert t_store._store_path(reads_file) == j_store._store_path(reads_file)


def test_store_written_by_real_tpu_loads_in_the_port(reads_file):
    want = j_reads.parse_reads(reads_file)
    store = j_store.save(want, reads_file)
    got = t_store.load(reads_file)
    assert got is not None and isinstance(got.ids, t_reads.IdView)
    _assert_same_reads(got, want)
    _assert_same_reads(got, t_reads.parse_reads(reads_file))
    assert sorted(os.listdir(store)) == sorted(
        [a + ".npy" for a in t_store._ARRAYS] + ["meta.npz"])


def test_store_written_by_the_port_loads_in_real_tpu(reads_file):
    rs = t_reads.parse_reads(reads_file)
    store = t_store.save(rs, reads_file)
    assert store == j_store._store_path(reads_file)
    got = j_store.load(reads_file)
    assert got is not None
    _assert_same_reads(got, rs)
    # file for file the same bytes as real_tpu's own store
    theirs = {}
    for name in os.listdir(store):
        theirs[name] = open(os.path.join(store, name), "rb").read()
        os.remove(os.path.join(store, name))
    j_store.save(j_reads.parse_reads(reads_file), reads_file)
    for name in t_store._ARRAYS:
        with open(os.path.join(store, name + ".npy"), "rb") as f:
            assert f.read() == theirs[name + ".npy"], name


def test_string_ids_are_stored_as_a_blob(tmp_path):
    path = tmp_path / "r.fa"
    path.write_text(">a b\nACGT\n>\nGG\n>c\xe9\nTTT\n", encoding="latin-1")
    rs = t_reads.parse_reads(str(path), use_native=False)
    as_list = t_reads.ReadSet(list(rs.ids), rs.lengths, rs.codes_flat,
                              rs.offsets, None, False)
    t_store.save(as_list, str(path))
    got = t_store.load(str(path))
    assert list(got.ids) == ["a b", "", "c\xe9"]
    _assert_same_reads(got, rs)


def test_parse_reads_cached_writes_then_loads(reads_file, monkeypatch):
    store = t_store._store_path(reads_file)
    first = t_store.parse_reads_cached(reads_file)
    assert os.path.exists(os.path.join(store, "meta.npz"))

    def no_parse(*a, **k):
        raise AssertionError("the second run must load the store")

    monkeypatch.setattr(t_store, "parse_reads", no_parse)
    second = t_store.parse_reads_cached(reads_file)
    assert isinstance(second.codes_flat, np.memmap)
    _assert_same_reads(second, first)
    # the explicit offset the store was written with also loads it
    if first.fastq:
        _assert_same_reads(
            t_store.parse_reads_cached(reads_file, first.quality_offset),
            first)


def test_rewrite_off_never_touches_the_store(reads_file):
    rs = t_store.parse_reads_cached(reads_file, rewrite=False)
    assert not os.path.exists(t_store._store_path(reads_file))
    _assert_same_reads(rs, t_reads.parse_reads(reads_file))


def test_other_quality_offset_parses_anew(tmp_path):
    _, reads = ab_util.make_inputs(tmp_path, n=8000, numpat=50, patlen=40,
                                   fastq=True, seed=3)
    first = t_store.parse_reads_cached(reads)          # autodetected: 33
    assert first.quality_offset == 33
    other = t_store.parse_reads_cached(reads, 31)
    assert other.quality_offset == 31
    np.testing.assert_array_equal(other.quals_flat,
                                  first.quals_flat.astype(np.int16) + 2)


def test_changed_file_gets_a_new_store(reads_file):
    t_store.parse_reads_cached(reads_file)
    old = t_store._store_path(reads_file)
    with open(reads_file, "ab") as f:
        f.write(b"\n")
    assert t_store._store_path(reads_file) != old
    assert t_store.load(reads_file) is None


@pytest.mark.parametrize("damage", ["truncated_array", "missing_array",
                                    "no_meta", "junk_meta"])
def test_damaged_store_is_parsed_anew(reads_file, damage):
    want = t_reads.parse_reads(reads_file)
    store = t_store.save(want, reads_file)
    codes = os.path.join(store, "codes_flat.npy")
    meta = os.path.join(store, "meta.npz")
    if damage == "truncated_array":
        with open(codes, "r+b") as f:
            f.truncate(100)
    elif damage == "missing_array":
        os.remove(codes)
    elif damage == "no_meta":
        os.remove(meta)
    else:
        with open(meta, "wb") as f:
            f.write(b"not a zip file")
    assert t_store.load(reads_file) is None
    _assert_same_reads(t_store.parse_reads_cached(reads_file), want)
    # ... and the store is whole again
    _assert_same_reads(t_store.load(reads_file), want)


@pytest.mark.parametrize("mode", ["1", "0"], ids=["unique", "all"])
def test_cli_second_run_loads_the_store_and_prints_the_same(tmp_path,
                                                            monkeypatch,
                                                            mode):
    genome, reads = ab_util.make_inputs(tmp_path, n=20000, numpat=200,
                                        patlen=60, seed=13)
    args = ["-device", "cpu", "-u", mode, "-t", genome, "-p", reads,
            "-B", "512"]
    assert t_main.main(args + ["-o", str(tmp_path / "no_store.txt"),
                               "-R", "0"]) == 0
    assert not os.path.exists(t_store._store_path(reads))
    assert t_main.main(args + ["-o", str(tmp_path / "first.txt")]) == 0
    assert os.path.exists(os.path.join(t_store._store_path(reads),
                                       "meta.npz"))

    def no_parse(*a, **k):
        raise AssertionError("the second run must load the store")

    monkeypatch.setattr(t_store, "parse_reads", no_parse)
    assert t_main.main(args + ["-o", str(tmp_path / "second.txt"),
                               "-R", "1"]) == 0
    first = (tmp_path / "first.txt").read_bytes()
    assert first.count(b"\n") > 150
    assert (tmp_path / "second.txt").read_bytes() == first
    assert (tmp_path / "no_store.txt").read_bytes() == first
    assert first.decode("latin-1") == ab_util.run_ours(
        genome, reads, unique=mode == "1", use_mesh=False)


def test_cli_loads_a_store_written_by_real_tpu(tmp_path, monkeypatch):
    genome, reads = ab_util.make_inputs(tmp_path, n=20000, numpat=120,
                                        fastq=True, seed=29)
    j_store.save(j_reads.parse_reads(reads), reads)
    monkeypatch.setattr(
        t_store, "parse_reads",
        lambda *a, **k: (_ for _ in ()).throw(AssertionError("parsed")))
    out = tmp_path / "out.txt"
    assert t_main.main(["-device", "cpu", "-t", genome, "-p", reads,
                        "-o", str(out), "-B", "512"]) == 0
    assert out.read_text() == ab_util.run_ours(genome, reads, use_mesh=False)
