"""The readers of the program's spans: sums and self times on a made-up
job, nothing to read from a program that writes no spans, and on a CPU
run of the harness the split of parse.s and output.s that the spans
give."""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, ROOT)

from portbench import run, span_sums  # noqa: E402

BENCHMARK = run.load_json(os.path.join(ROOT, "BENCHMARK.json"))
SPAN_METRICS = ["parse.reads_s", "parse.genome_s", "plan.s",
                "driver.host_s", "output.emit_s", "output.format_s",
                "output.write_s"]
MS = 10**6


def _span(i, name, parent, a, b, thread=1):
    return {"id": i, "name": name, "parent": parent, "thread": thread,
            "start_ns": a * MS, "end_ns": b * MS}


SPANS = [
    _span(0, "job", None, 0, 1000),
    _span(1, "parse.reads", 0, 1, 200),
    _span(2, "genome.load", 0, 200, 500),
    _span(3, "genome.parse", 2, 201, 300),
    _span(4, "driver", 0, 510, 800),
    _span(5, "setup", 4, 515, 530),
    _span(6, "plan", 4, 530, 540),
    _span(7, "match", 4, 550, 700),
    _span(8, "driver", 4, 710, 790),      # the overflow rerun
    _span(9, "plan", 8, 712, 715),
    _span(10, "match", 8, 720, 780),
    _span(11, "output", 0, 810, 990),
    _span(12, "output.format", 11, 811, 900, thread=2),
    _span(13, "output.format", 11, 812, 905, thread=3),
    _span(14, "output.write", 11, 905, 950, thread=4),
]


def _job(spans):
    metrics = {"phase_s": {}, "wall_s": 0.0, "overflow_rerun_reads": 0}
    if spans is not None:
        metrics["spans"] = spans
    return run.Job(0.0, 1.0, 100, metrics, 0, [], 0)


def test_the_span_metrics_are_declared():
    cells = [w["name"] for w in BENCHMARK["workloads"]]
    declared = {m["name"]: m for m in BENCHMARK["per_layer"]}
    for name in SPAN_METRICS:
        m = declared[name]
        assert m["source"] == "program_span" and m["unit"] == "s"
        assert m["moves"] == "reads_per_s" and m["workloads"] == cells


def test_span_readers_on_a_made_up_run():
    r = run.Run(1.0, [_job(SPANS), _job(SPANS)], None)
    got = {n: run.read_metric(n, r) for n in SPAN_METRICS}
    # driver self: 290 - (15 + 10 + 150 + 80) and 80 - (3 + 60)
    want = {"parse.reads_s": 0.199, "parse.genome_s": 0.3, "plan.s": 0.013,
            "driver.host_s": 0.035 + 0.017, "output.emit_s": 0.18,
            "output.format_s": 0.089 + 0.093, "output.write_s": 0.045}
    assert got == pytest.approx(want)
    # the children on other threads do not count against the parent
    assert span_sums.self_ns(SPANS[11], SPANS) == 180 * MS
    assert span_sums.job_seconds(SPANS, "genome.load", own=True) \
        == pytest.approx(0.201)


@pytest.mark.parametrize("jobs", [[None], [SPANS, None], [[]]],
                         ids=["parent", "one-job-without", "empty"])
def test_no_spans_nothing_to_read(jobs):
    r = run.Run(1.0, [_job(s) for s in jobs], None)
    for name in SPAN_METRICS:
        assert run.read_metric(name, r) is None


def test_spans_split_parse_and_output_on_a_cpu_run(tmp_path):
    """A run of the harness on the CPU: every span reader reads, and the
    spans account for the outside measures parse.s and output.s, less the
    few statements between spans."""
    cfg = {"genome_bp": 30000, "fragments": 1, "read_length": 75,
           "read_format": "fastq", "errprob": 0.02, "max_mismatches": 4,
           "mode": "unique", "scores": True,
           "reference": "reference_unique"}
    traffic = {"reads_per_job": 1500, "files": [{"draw": 0}]}
    r, checked, bad, _ = run.measure(cfg, traffic, 2**35 + 3, 0, True,
                                     device="cpu", tmp=str(tmp_path))
    assert sum(bad) == 0 and checked == len(r.jobs) + 2
    got = {n: run.read_metric(n, r) for n in SPAN_METRICS}
    assert all(v is not None and v >= 0 for v in got.values()), got
    parse = run.read_metric("parse.s", r)
    out = run.read_metric("output.s", r)
    split = got["parse.reads_s"] + got["parse.genome_s"]
    assert split <= parse + 0.002
    rest = got["output.emit_s"] + got["driver.host_s"] + got["plan.s"]
    # wall_s and each phase_s entry are rounded to 3 decimals
    assert rest <= out + 0.002 + 5e-4 * len(r.jobs[0].metrics["phase_s"])
    # the idle gaps of the CPU trace carry the spans' names
    assert r.trace.idle_gaps
    assert not r.trace.idle_gaps[0][0].startswith("host, between")
