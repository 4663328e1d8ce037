"""The spans and counters of the port's matchAll hit path through its CLI
on the CPU (-device cpu -u 0 -q 1 -metrics): a FASTQ read set over a
genome of four fragments with a planted repeat family of 20 copies, so
that reads have more hits than the survivor cap and are rerun. The hit
path's spans lie under `driver`, its counters count the records printed
and the rows decoded, -metrics leaves the records as they are, and a
matchUnique job records none of them."""

import json

import numpy as np
import pytest

from real_tpu_torch.cli import main as t_main
from real_tpu_torch.tools import simulate

SEED = 2**34 + 29
HIT_SPANS = {"allhits.wait", "allhits.decode", "allhits.sort"}
HIT_COUNTERS = {"allhits.decoded", "allhits.records"}
_ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


def _genome(path, n=40000, fragments=4, copies=20, length=200):
    """A random genome in `fragments` FASTA fragments with one segment
    pasted `copies` times, every other copy reverse-complemented, each
    with one base changed; returns its codes."""
    rng = np.random.default_rng(SEED)
    codes = rng.integers(0, 4, n).astype(np.uint8)
    seg = codes[500:500 + length].copy()
    for i, at in enumerate(2000 + 1700 * np.arange(copies)):
        copy = seg if i % 2 == 0 else 3 - seg[::-1]
        copy = copy.copy()
        j = int(rng.integers(length))
        copy[j] = (copy[j] + 1) & 3
        codes[at:at + length] = copy
    per = n // fragments
    with open(path, "w") as f:
        for fr in range(fragments):
            seq = _ACGT[codes[fr * per:(fr + 1) * per]].tobytes().decode()
            f.write(f">chr{fr}\n")
            f.writelines(seq[i:i + 60] + "\n" for i in range(0, per, 60))
    return codes


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("allhits")
    genome, reads = str(d / "g.fa"), str(d / "r.fq")
    codes = _genome(genome)
    simulate.write_reads(simulate.generate_reads(codes, 800, 50, 0.02, True,
                                                 seed=SEED), reads, True)
    return genome, reads


def _run(tmp_path, inputs, tag, flags, metrics=True):
    genome, reads = inputs
    out = tmp_path / f"{tag}.txt"
    argv = ["-device", "cpu", "-t", genome, "-p", reads, "-o", str(out),
            "-q", "1", "-e", "3", "-R", "0", *flags]
    if metrics:
        argv += ["-metrics", str(tmp_path / f"{tag}.json")]
    assert t_main.main(argv) == 0
    got = (json.loads((tmp_path / f"{tag}.json").read_text()) if metrics
           else None)
    return out.read_bytes(), got


def _under_driver(s, by_id):
    while s is not None:
        if s["name"] == "driver":
            return True
        s = by_id.get(s["parent"])
    return False


@pytest.fixture(scope="module")
def match_all(tmp_path_factory, inputs):
    return _run(tmp_path_factory.mktemp("all"), inputs, "all", ["-u", "0"])


def test_hit_path_spans_lie_under_the_driver(match_all):
    _, m = match_all
    rows = m["spans"]
    by_id = {s["id"]: s for s in rows}
    mine = [s for s in rows if s["name"] in HIT_SPANS]
    assert {s["name"] for s in mine} == HIT_SPANS
    for s in mine:
        assert by_id[s["parent"]]["name"] != "job"
        assert _under_driver(by_id[s["parent"]], by_id)
        assert s["end_ns"] >= s["start_ns"]
    # a sort at the finalize of each depth and one at the rerun's merge
    assert m["overflow_rerun_reads"] > 0
    assert sum(s["name"] == "allhits.sort" for s in mine) == 3


def test_records_counter_counts_the_lines_printed(match_all):
    out, m = match_all
    lines = out.count(b"\n")
    assert lines > 800
    assert m["counters"]["allhits.records"] == lines
    # reads with more hits than the survivor cap (8)
    per_read = {}
    for line in out.splitlines():
        rid = line.split(b"\t", 1)[0]
        per_read[rid] = per_read.get(rid, 0) + 1
    assert max(per_read.values()) > 8


def test_decoded_rows_exceed_the_records_when_reads_are_rerun(match_all):
    _, m = match_all
    c = m["counters"]
    assert set(c) == HIT_COUNTERS | {"output.records", "output.score_slow",
                                     "index.units_built",
                                     "index.windows_built",
                                     "index.build_device_s"}
    assert m["overflow_rerun_reads"] > 0
    # the first-pass hits of the rerun reads are decoded and dropped
    assert c["allhits.decoded"] > c["allhits.records"]


def test_records_are_the_same_without_metrics(tmp_path, inputs, match_all):
    out, _ = match_all
    plain, _ = _run(tmp_path, inputs, "plain", ["-u", "0"], metrics=False)
    assert plain == out


def test_match_unique_records_no_hit_path_span_or_counter(tmp_path, inputs):
    out, m = _run(tmp_path, inputs, "unique", ["-u", "1"])
    assert out.count(b"\n") > 0
    names = {s["name"] for s in m["spans"]}
    assert not {n for n in names if n.startswith("allhits.")}
    assert not {n for n in m["counters"] if n.startswith("allhits.")}
    assert "driver" in names
