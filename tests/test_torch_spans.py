"""The job's spans (real_tpu_torch/utils/spans.py) through the port's CLI
on the CPU: the `spans` tree of -metrics and its phase sums, the spans of
a -trace run's Chrome trace, the streaming source's wait counter, the
output threads' spans, and what a span costs with no profiler."""

import glob
import io
import json
import os
import threading
import time

import pytest
import torch

from real_tpu_torch.cli import main as t_main
from real_tpu_torch.cli import output
from real_tpu_torch.engine import driver
from real_tpu_torch.io import fasta, readstore
from real_tpu_torch.tools import simulate
from real_tpu_torch.utils import spans

PHASES = {"setup", "index_build", "index_load", "match", "drain",
          "collect", "finalize", "mesh_gather"}
# the spans every one-device CLI job runs (index_load and mesh_gather run
# only with -exchange or on a mesh)
JOB_SPANS = {"job", "parse.reads", "genome.load", "genome.parse",
             "genome.pack", "genome.upload", "driver", "plan", "setup",
             "index_build", "match", "drain", "output", "output.format",
             "output.write"}
CASES = {"unique": ([], {"collect"}),
         "all": (["-u", "0"], {"finalize", "allhits.wait", "allhits.decode",
                               "allhits.sort"})}


def _inputs(tmp_path, numpat=300, seed=41):
    genome, reads = str(tmp_path / "g.fa"), str(tmp_path / "r.fa")
    with open(genome, "w") as f:
        f.write(simulate.random_genome(20000, seed=seed))
    codes, _ = fasta.parse_genome(genome, use_native=False)
    simulate.write_reads(simulate.generate_reads(codes, numpat, 100, 0.02,
                                                 False, seed=seed + 1),
                         reads, False)
    return genome, reads


def _self_ns(s, rows):
    """The span's length less the union of its children on its thread."""
    kids = sorted((c["start_ns"], c["end_ns"]) for c in rows
                  if c["parent"] == s["id"] and c["thread"] == s["thread"])
    covered, end = 0, s["start_ns"]
    for a, b in kids:
        if b > end:
            covered += b - max(a, end)
            end = b
    return s["end_ns"] - s["start_ns"] - covered


def _driver_depth(s, by_id):
    """How many `driver` spans the span is or runs in, less one."""
    depth = -1
    while s is not None:
        depth += s["name"] == "driver"
        s = by_id.get(s["parent"])
    return depth


@pytest.mark.parametrize("case", sorted(CASES))
def test_metrics_spans_form_the_jobs_tree(tmp_path, case):
    flags, more = CASES[case]
    genome, reads = _inputs(tmp_path)
    m = tmp_path / "m.json"
    assert t_main.main(["-device", "cpu", "-t", genome, "-p", reads,
                        "-o", str(tmp_path / "o.txt"), "-B", "512",
                        "-K", "2", "-S", "2", "-metrics", str(m),
                        *flags]) == 0
    got = json.loads(m.read_text())
    rows = got["spans"]
    by_id = {s["id"]: s for s in rows}
    assert [s["id"] for s in rows] == list(range(len(rows)))
    assert {s["name"] for s in rows} == JOB_SPANS | more
    job = rows[0]
    assert job["name"] == "job" and job["parent"] is None
    assert job["start_ns"] == 0
    assert [s for s in rows if s["parent"] is None] == [job]
    assert [by_id[s["parent"]]["name"] for s in rows[1:]
            if s["name"] == "parse.reads"] == ["job"]
    for s in rows[1:]:
        p = by_id[s["parent"]]
        assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] <= p["end_ns"]
        assert _self_ns(s, rows) >= 0
    expect_parent = {"genome.parse": "genome.load", "genome.pack":
                     "genome.load", "genome.upload": "genome.load",
                     "plan": "driver", "output.format": "output",
                     "output.write": "output", "parse.reads": "job",
                     "genome.load": "job", "output": "job"}
    for s in rows[1:]:
        if s["name"] in expect_parent:
            assert by_id[s["parent"]]["name"] == expect_parent[s["name"]]
        if s["name"] in PHASES:
            assert by_id[s["parent"]]["name"] == "driver"
    # the overflow rerun's driver runs inside its caller's
    assert got["overflow_rerun_reads"] > 0
    assert {_driver_depth(s, by_id) for s in rows
            if s["name"] == "driver"} == {0, 1}
    sums = {}
    for s in rows:
        if s["name"] in PHASES:
            k = "rerun." * _driver_depth(s, by_id) + s["name"]
            sums[k] = sums.get(k, 0) + (s["end_ns"] - s["start_ns"]) / 1e9
    assert set(sums) == set(got["phase_s"])
    for k, v in got["phase_s"].items():
        assert v == round(sums[k], 3)
    assert got["stream_wait_s"] == 0.0 and got["source_resident"]
    # wall_s runs from after genome.load to after output
    load, out = (next(s for s in rows if s["name"] == n)
                 for n in ("genome.load", "output"))
    assert got["wall_s"] >= (out["end_ns"] - load["end_ns"]) / 1e9 - 5e-4


def test_trace_holds_the_jobs_spans_from_the_read_parse_on(tmp_path):
    genome, reads = _inputs(tmp_path, numpat=120, seed=43)
    trace_dir = tmp_path / "trace"
    assert t_main.main(["-device", "cpu", "-t", genome, "-p", reads,
                        "-o", str(tmp_path / "o.txt"), "-B", "512",
                        "-trace", str(trace_dir)]) == 0
    files = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    ann = [e for e in events if e.get("cat") == "user_annotation"]
    names = [e["name"] for e in ann]
    for n in ("job", "parse.reads", "genome.load", "driver", "output"):
        assert n in names
    assert names.count("job") == 1
    job = ann[names.index("job")]
    lo, hi = job["ts"], job["ts"] + job["dur"]
    inner = sorted((e for e in ann if e is not job), key=lambda e: e["ts"])
    assert all(lo <= e["ts"] and e["ts"] + e["dur"] <= hi for e in inner)
    assert inner[0]["name"] == "parse.reads"
    # the read parse lies inside the traced window, among the CPU ops
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    assert ops and min(e["ts"] for e in events) <= inner[0]["ts"]


def test_streaming_run_counts_its_wait(tmp_path):
    genome, reads = _inputs(tmp_path, numpat=200, seed=45)
    m = tmp_path / "m.json"
    cfg = t_main.parse_args(["-t", genome, "-p", reads,
                             "-o", str(tmp_path / "o.txt"), "-B", "64",
                             "-metrics", str(m)])
    cfg.resident_reads_bytes = 1        # force the streaming source
    rs = readstore.parse_reads_cached(reads, rewrite=False)
    assert t_main.run(cfg, rs, driver.resolve_device("cpu")) == 0
    got = json.loads(m.read_text())
    assert not got["source_resident"] and got["streamed_batches"] > 0
    assert got["stream_wait_s"] >= 0
    # a rank enters at run: its job span opens there, with no read parse
    names = [s["name"] for s in got["spans"]]
    assert names[0] == "job" and "parse.reads" not in names
    assert names[1] == "genome.load"


def test_output_threads_record_their_spans_under_the_caller():
    rec = spans.Recorder()
    buf = io.BytesIO()
    with rec.job():
        with spans.span("output"):
            parent = spans.here()[1]
            output._emit_chunks(buf, lambda s, e: b"".join(
                b"%d\n" % i for i in range(s, e)), 10, chunk=3)
    assert buf.getvalue() == b"".join(b"%d\n" % i for i in range(10))
    rows = rec.export()
    main = threading.get_native_id()
    for name in ("output.format", "output.write"):
        mine = [s for s in rows if s["name"] == name]
        assert len(mine) == 4
        assert all(s["parent"] == parent for s in mine)
        assert all(s["thread"] != main for s in mine)
        assert all(s["end_ns"] >= s["start_ns"] >= rows[parent]["start_ns"]
                   for s in mine)


def test_a_span_costs_little_with_no_profiler():
    assert not spans.profiling()
    n, best = 2000, float("inf")
    for _ in range(5):
        rec = spans.Recorder()
        with rec.job():
            t = time.perf_counter()
            for _ in range(n):
                with spans.span("x"):
                    pass
            best = min(best, (time.perf_counter() - t) / n)
        assert len(rec.names) == n + 1
    assert best < 20e-6
    # outside a job a span only times itself
    with spans.span("alone") as s:
        torch.zeros(1)
    assert s.ns > 0 and spans.here() == (None, None)


def test_run_under_an_active_profiler_opens_none_of_its_own(tmp_path):
    """A rank enters at run: with a profiler already recording (a harness
    around it), -trace opens no second one, and the job's spans land in
    the outer trace."""
    from torch.profiler import ProfilerActivity, profile
    genome, reads = _inputs(tmp_path, numpat=80, seed=47)
    trace_dir = tmp_path / "trace"
    cfg = t_main.parse_args(["-t", genome, "-p", reads,
                             "-o", str(tmp_path / "o.txt"),
                             "-trace", str(trace_dir)])
    rs = readstore.parse_reads_cached(reads, rewrite=False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert t_main.run(cfg, rs, driver.resolve_device("cpu")) == 0
    assert not trace_dir.exists()
    names = {e.name for e in prof.events()}
    assert {"job", "genome.load", "driver", "output"} <= names


def test_threads_share_one_recorder_without_losing_a_span():
    """More threads than cores open spans into one job's recorder at a
    shortened switch interval: every span gets its own id, its own row
    and its thread's parent."""
    import sys
    threads_n, per = 4 * (os.cpu_count() or 1), 200
    rec = spans.Recorder()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with rec.job():
            at = spans.here()
            # every thread lives until all have run: no native id reused
            meet = threading.Barrier(threads_n, timeout=60)

            def work():
                meet.wait()
                with spans.span("outer", at):
                    for _ in range(per):
                        with spans.span("inner"):
                            spans.add("n", 1.0)
                meet.wait()

            ts = [threading.Thread(target=work) for _ in range(threads_n)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    rows = rec.export()
    assert len(rows) == 1 + threads_n * (per + 1)
    assert rec.counters["n"] == threads_n * per
    by_id = {s["id"]: s for s in rows}
    outer = {s["thread"]: s["id"] for s in rows if s["name"] == "outer"}
    assert len(outer) == threads_n
    for s in rows:
        assert s["end_ns"] is not None and s["end_ns"] >= s["start_ns"]
        if s["name"] == "inner":
            assert by_id[s["parent"]]["name"] == "outer"
            assert s["parent"] == outer[s["thread"]]
