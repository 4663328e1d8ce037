"""The reader of output.record_ns on made-up runs: the `output.format`
spans' nanoseconds over the `output.records` counter, a job at a time, and
nothing to read from a program or a job without the counter."""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, ROOT)

from portbench import run  # noqa: E402

MS = 10**6


def _span(i, name, parent, a, b, thread=1):
    return {"id": i, "name": name, "parent": parent, "thread": thread,
            "start_ns": a * MS, "end_ns": b * MS}


SPANS = [
    _span(0, "job", None, 0, 1000),
    _span(1, "driver", 0, 10, 500),
    _span(2, "output", 0, 510, 990),
    _span(3, "output.format", 2, 511, 700, thread=2),
    _span(4, "output.format", 2, 512, 721, thread=3),
    _span(5, "output.write", 2, 700, 800, thread=4),
]


def _job(spans, counters):
    metrics = {"phase_s": {}, "wall_s": 0.0, "overflow_rerun_reads": 0}
    if spans is not None:
        metrics["spans"] = spans
    if counters is not None:
        metrics["counters"] = counters
    return run.Job(0.0, 1.0, 1000, metrics, 0, [], 0)


def test_record_ns_is_declared_for_every_cell():
    bench = run.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    m = {m["name"]: m for m in bench["per_layer"]}["output.record_ns"]
    assert (m["layer"], m["unit"], m["better"], m["source"], m["moves"]) \
        == ("output", "ns", "lower", "program_span", "reads_per_s")
    assert m["workloads"] == [w["name"] for w in bench["workloads"]]


def test_record_ns_on_a_made_up_run():
    counters = {"output.records": 2_000_000.0, "output.score_slow": 0.0}
    r = run.Run(1.0, [_job(SPANS, counters),
                      _job(SPANS[:4], dict(counters,
                                           **{"output.records": 500_000.0}))],
                None)
    # (189 + 209) ms over 2M records, then 189 ms over 500k
    want = ((189 + 209) * MS / 2e6 + 189 * MS / 5e5) / 2
    assert run.read_metric("output.record_ns", r) == pytest.approx(want)


@pytest.mark.parametrize("jobs", [
    [(None, None)],                                      # no spans, counters
    [(SPANS, {"stream_wait_s": 0.0})],                   # the parent
    [(SPANS, {"output.records": 10.0}), (SPANS, {})],    # one job without
    [(SPANS, {"output.records": 0.0})],                  # nothing formatted
    [(None, {"output.records": 10.0})],                  # no spans
], ids=["nothing", "parent", "one-job-without", "no-records", "no-spans"])
def test_no_counter_nothing_to_read(jobs):
    r = run.Run(1.0, [_job(s, c) for s, c in jobs], None)
    assert run.read_metric("output.record_ns", r) is None
