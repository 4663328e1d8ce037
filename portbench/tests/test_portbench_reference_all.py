"""The matchAll yardstick held to the program, and the comparison shown to
fail.

On a small seeded genome of several fragments with repeat families
planted as the yeast configuration plants them (3% of the genome in
families of 8-24 copies, diverged 0-1%; the segment shortened to the
genome's size), the plain reference's records equal the records of
real_tpu_torch's CPU run (-device cpu -u 0 -q 1 -e 3) for every read,
compared as multisets of lines, with FASTQ and with FASTA reads. The
control (the reference with its scores summed in float32) and the program
broken where its records are written (a record dropped, one doubled, a
score's last printed digit changed, a hit on the wrong strand) come out
not correct. The readers of the layer "matchAll hits" read a made-up run,
and read nothing where the program writes none of their spans and
counters. The test marked `cuda` runs the program on the card and decides
inside the test whether there is one.
"""

import math
import os
import sys

import numpy as np
import pytest
import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, ROOT)

from portbench import allhits, check, gen, reference_all, run  # noqa: E402

SEED = 2**41 + 77
YEAST = run.load_json(os.path.join(BENCH, "configs", "yeast.json"))
NUM = 3000


def _config(fmt, genome_bp=200000, fragments=5):
    """The yeast configuration at a small size: its repeat spec with a
    250-base segment, so that 3% of the genome is still about two
    families."""
    return dict(YEAST, genome_bp=genome_bp, fragments=fragments,
                read_format=fmt,
                repeats=dict(YEAST["repeats"], length=250))


@pytest.fixture(scope="module", params=["fastq", "fasta"])
def data(request, tmp_path_factory):
    cfg = _config(request.param)
    d = str(tmp_path_factory.mktemp(request.param))
    traffic = {"reads_per_job": NUM, "files": [{"draw": 0}]}
    g, gpath, paths, draws = gen.make_files(SEED, d, cfg, traffic)
    return cfg, g, gpath, paths[0], draws[0]


def _expected(cfg, g, draw, device="cpu", dtype=np.float64):
    rows = np.arange(len(draw.codes))
    quals = None
    if draw.quals is not None:
        quals = draw.quals.astype(np.int64) \
            - reference_all.quality_offset(draw.quals)
    ids = [bytes(x) for x in gen.read_ids(rows)]
    return rows, reference_all.records(g, ids, draw.codes, quals, cfg,
                                       device, dtype)


def _program(cfg, gpath, path, tmp_path, device):
    argv = run.job_argv(cfg, gpath, path, str(tmp_path / "m.json"), device)
    assert argv[argv.index("-u"):argv.index("-u") + 6] == \
        ["-u", "0", "-q", "1", "-e", "3"]
    out = b"".join(run.run_job(argv, NUM, 0,
                               device.startswith("cuda")).output)
    return out, run.load_json(str(tmp_path / "m.json"))


def test_reference_equals_the_program_on_the_cpu(data, tmp_path):
    cfg, g, gpath, path, draw = data
    rows, want = _expected(cfg, g, draw)
    out, m = _program(cfg, gpath, path, tmp_path, "cpu")
    assert check.differing(out, NUM, rows, want) == 0
    # the repeats give reads past the survivor cap (8), which are rerun
    counts = [w.count(b"\n") if w else 0 for w in want]
    assert max(counts) > 8 and m["overflow_rerun_reads"] > 0
    assert sum(c > 1 for c in counts) >= 50
    assert sum(counts) == out.count(b"\n")
    # hits on several fragments, on both strands
    fields = [line.split(b"\t") for line in out.splitlines()]
    assert len({f[7] for f in fields}) == cfg["fragments"]
    assert {f[6] for f in fields} == {b"+", b"-"}


@pytest.mark.cuda
def test_reference_equals_the_program_on_the_card(data, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    cfg, g, gpath, path, draw = data
    rows, want = _expected(cfg, g, draw, "cuda")
    out, _ = _program(cfg, gpath, path, tmp_path, "cuda")
    assert check.differing(out, NUM, rows, want) == 0


def test_control_float32_scores_are_not_correct(data):
    cfg, g, _, _, draw = data
    rows, want = _expected(cfg, g, draw)
    _, low = _expected(cfg, g, draw, dtype=np.float32)
    assert check.differing(b"".join(w for w in low if w), NUM, rows,
                           want) > 0


@pytest.mark.parametrize("cfg", [dict(YEAST, mode="unique"),
                                 dict(YEAST, scores=False)],
                         ids=["unique", "no_scores"])
def test_reference_refuses_another_mode(cfg):
    g = gen.make_genome(SEED, 1000)
    with pytest.raises(ValueError, match="matchAll with scores"):
        reference_all.records(g, [b"r000000000"],
                              np.zeros((1, 50), np.uint8), None, cfg, "cpu")


def _last_digit_up(s: float) -> np.float32:
    """s with the last of the six significant digits %.6g prints moved
    up by one."""
    return np.float32(s + 10.0 ** (math.floor(math.log10(abs(s))) - 5))


def _broken(monkeypatch, fault):
    """The program with one record broken where its records are written:
    a row of a read with several records dropped, doubled, its score's
    last printed digit changed, or its strand flipped."""
    from real_tpu_torch.cli import output
    write = output.write_all_arrays

    def broken(out, rs, cols, *args, **kw):
        cols = [np.array(c) for c in cols]
        pid = cols[0]
        i = int(np.flatnonzero(pid[1:] == pid[:-1])[0])
        if fault == "dropped":
            cols = [np.delete(c, i) for c in cols]
        elif fault == "doubled":
            cols = [np.insert(c, i, c[i]) for c in cols]
        elif fault == "score":
            cols[5][i] = _last_digit_up(float(cols[5][i]))
        elif fault == "strand":
            cols[6][i] = ~cols[6][i]
        return write(out, rs, tuple(cols), *args, **kw)

    monkeypatch.setattr(output, "write_all_arrays", broken)


@pytest.mark.parametrize("fault", [None, "dropped", "doubled", "score",
                                   "strand"])
def test_a_run_with_a_broken_record_is_not_correct(tmp_path, monkeypatch,
                                                   fault):
    """A whole run but for the look for a card (-device cpu, a window of
    one job) of the small yeast configuration: sound, it is correct; with
    one record broken, each job reads one read differing."""
    cfg = _config("fastq", genome_bp=100000, fragments=3)
    if fault:
        _broken(monkeypatch, fault)
    traffic = {"reads_per_job": 1500, "files": [{"draw": 0}]}
    r, checked, bad, _ = run.measure(cfg, traffic, SEED, 0, False,
                                     device="cpu", tmp=str(tmp_path))
    assert checked == len(r.jobs) == 1
    assert bad == [0 if fault is None else 1]


def test_last_digit_up_changes_the_printed_score():
    for s in (1.0, -3.25, 61.2345, 71.70001):
        assert b"%.6g" % float(_last_digit_up(s)) != b"%.6g" % s


# ---------------------------------------------------------------------------
# the readers of the layer "matchAll hits"
# ---------------------------------------------------------------------------

HIT_METRICS = ["allhits.wait_s", "allhits.decode_s", "allhits.sort_s",
               "allhits.kept_share"]
MS = 10**6


def _span(i, name, parent, a, b):
    return {"id": i, "name": name, "parent": parent, "thread": 1,
            "start_ns": a * MS, "end_ns": b * MS}


SPANS = [
    _span(0, "job", None, 0, 1000),
    _span(1, "driver", 0, 10, 900),
    _span(2, "match", 1, 20, 400),
    _span(3, "allhits.wait", 2, 30, 40),
    _span(4, "allhits.decode", 2, 40, 60),
    _span(5, "allhits.wait", 2, 70, 75),
    _span(6, "allhits.decode", 2, 75, 80),
    _span(7, "finalize", 1, 400, 500),
    _span(8, "allhits.sort", 7, 410, 490),
    _span(9, "driver", 1, 500, 800),          # the overflow rerun
    _span(10, "allhits.wait", 9, 510, 512),
    _span(11, "allhits.decode", 9, 512, 520),
    _span(12, "allhits.sort", 9, 700, 720),
    _span(13, "allhits.sort", 1, 810, 850),   # the merge after the rerun
    _span(14, "output", 0, 900, 990),
]


def _job(spans, counters, reads=1000):
    metrics = {"phase_s": {}, "wall_s": 0.0, "overflow_rerun_reads": 0}
    if spans is not None:
        metrics["spans"] = spans
    if counters is not None:
        metrics["counters"] = counters
    return run.Job(0.0, 1.0, reads, metrics, 0, [], 0)


def test_hit_metrics_are_declared():
    bench = run.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    declared = {m["name"]: m for m in bench["per_layer"]}
    cell = {w["name"]: w for w in bench["workloads"]}["yeast.a.1m"]
    assert (cell["config"], cell["traffic"], cell["chips"]) == \
        ("yeast", "a.1m", 1)
    for name in HIT_METRICS:
        m = declared[name]
        assert m["layer"] == "matchAll hits" and m["moves"] == "reads_per_s"
        assert m["workloads"] == ["yeast.a.1m"]
    assert {declared[n]["source"] for n in HIT_METRICS[:3]} == \
        {"program_span"}
    assert declared["allhits.kept_share"]["source"] == "program_counter"
    # the cell runs every layer, so every per-layer metric reads it
    assert all("yeast.a.1m" in m["workloads"] for m in bench["per_layer"])


def test_hit_readers_on_a_made_up_run():
    counters = {"allhits.decoded": 1500.0, "allhits.records": 1400.0,
                "stream_wait_s": 0.0}
    r = run.Run(1.0, [_job(SPANS, counters),
                      _job(SPANS[:9], dict(counters,
                                           **{"allhits.decoded": 1100.0}))],
                None)
    got = {n: run.read_metric(n, r) for n in HIT_METRICS}
    want = {"allhits.wait_s": (0.017 + 0.015) / 2,
            "allhits.decode_s": (0.033 + 0.025) / 2,
            "allhits.sort_s": (0.14 + 0.08) / 2,
            "allhits.kept_share": 100 * 2800 / 2600}
    assert got == pytest.approx(want)


@pytest.mark.parametrize("jobs", [
    [(None, None)],                                 # no spans, no counters
    [(SPANS[:3] + SPANS[14:], {})],                 # a matchUnique job
    [(SPANS, {"allhits.decoded": 10.0, "allhits.records": 9.0}),
     (SPANS[:3], {"stream_wait_s": 0.0})],          # one job without
], ids=["parent", "unique", "one-job-without"])
def test_no_hit_spans_nothing_to_read(jobs):
    r = run.Run(1.0, [_job(s, c) for s, c in jobs], None)
    for name in HIT_METRICS:
        assert run.read_metric(name, r) is None


def test_nothing_decoded_no_kept_share():
    r = run.Run(1.0, [_job(SPANS, {"allhits.decoded": 0.0,
                                   "allhits.records": 0.0})], None)
    assert run.read_metric("allhits.kept_share", r) is None


def test_hit_readers_read_a_cpu_run(tmp_path):
    """A traced run of the harness on the CPU (the small yeast
    configuration): every reader of the layer reads."""
    cfg = _config("fastq", genome_bp=100000, fragments=3)
    traffic = {"reads_per_job": 1500, "files": [{"draw": 0}]}
    r, checked, bad, _ = run.measure(cfg, traffic, SEED + 1, 0, True,
                                     device="cpu", tmp=str(tmp_path))
    assert sum(bad) == 0 and checked == len(r.jobs) + 2
    got = {n: run.read_metric(n, r) for n in HIT_METRICS}
    assert all(v is not None and v >= 0 for v in got.values()), got
    records = allhits.counter_sum(r, "allhits.records")
    assert records / sum(j.reads for j in r.jobs) > 1.0
    assert 0 < got["allhits.kept_share"] <= 100
