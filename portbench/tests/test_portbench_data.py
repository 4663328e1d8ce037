"""The benchmark's data and files: seeded bytes, genpat's FASTQ
qualities, every file BENCHMARK.json names, and the metric readers on a
made-up run."""

import glob
import json
import os
import sys

import numpy as np
import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, ROOT)

from portbench import gen, run, trace  # noqa: E402

CFG = {"genome_bp": 20000, "fragments": 2, "read_length": 60,
       "read_format": "fastq", "errprob": 0.05}
TRAFFIC = {"reads_per_job": 500, "files": [{"draw": 0}, {"reorder_of": 0},
                                           {"draw": 1}]}


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _bytes(d):
    return {os.path.basename(p): _read(p)
            for p in sorted(glob.glob(os.path.join(d, "*")))}


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 2**40 + 3, -12])
def test_same_seed_same_bytes(tmp_path, seed):
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir()
    b.mkdir()
    gen.make_files(seed, str(a), CFG, TRAFFIC)
    gen.make_files(seed, str(b), CFG, TRAFFIC)
    assert _bytes(a) == _bytes(b)
    c = tmp_path / "c"
    c.mkdir()
    gen.make_files(seed + 1, str(c), CFG, TRAFFIC)
    assert _bytes(c)["genome.fa"] != _bytes(a)["genome.fa"]


def test_planted_repeats():
    spec = {"share": 0.1, "length": 200, "copies": [2, 6],
            "divergence": [0.0, 0.03]}
    plain = gen.make_genome(9, 200000, 1)
    g = gen.make_genome(9, 200000, 1, spec)
    assert (g.codes == gen.make_genome(9, 200000, 1, spec).codes).all()
    dst = gen.plant_repeats(9, plain.codes.copy(), spec)
    changed = (g.codes != plain.codes).mean()
    # the pasted copies cover about share * (1 - 1/4) less overlaps, and a
    # pasted base equals the one it covers 1 time in 4
    assert 0.04 < changed < 0.08
    # each pasted copy lies within its divergence (or its reverse
    # complement does) of some segment elsewhere in the genome
    k = 32
    first = {}
    for i in range(0, len(g.codes) - k + 1):
        first.setdefault(g.codes[i:i + k].tobytes(), i)
    found = 0
    for at in dst[:50]:
        probe = g.codes[at + 84:at + 84 + k]
        hits = [first.get(probe.tobytes()),
                first.get((3 - probe[::-1]).tobytes())]
        found += any(h is not None and h != at + 84 for h in hits)
    assert found >= 25


def _fastq(path):
    lines = _read(path).split(b"\n")[:-1]
    return lines[0::4], lines[1::4], lines[3::4]


def test_reads_and_genpat_qualities(tmp_path):
    g, gpath, paths, draws = gen.make_files(11, str(tmp_path), CFG,
                                            TRAFFIC)
    assert _read(gpath).count(b">") == 2
    ids, seqs, quals = _fastq(paths[0])
    d = draws[0]
    acgt = np.frombuffer(b"ACGT", np.uint8)
    L = CFG["read_length"]
    mutated = 0
    for i in range(TRAFFIC["reads_per_job"]):
        assert ids[i] == b"@r%09d" % i
        src = g.codes[d.start[i]:d.start[i] + L]
        if d.reverse[i]:
            src = 3 - src[::-1]
        seq = np.frombuffer(seqs[i], np.uint8)
        assert (seq == acgt[d.codes[i]]).all()
        kept = seq == acgt[src]
        q = np.frombuffer(quals[i], np.uint8)
        assert (q == np.where(kept, ord("D"), ord("*"))).all()
        mutated += int((~kept).sum())
    assert 0.03 < mutated / (L * TRAFFIC["reads_per_job"]) < 0.07
    # a reordering holds the same records in another order
    ids2, seqs2, quals2 = _fastq(paths[1])
    assert ids2 != ids and sorted(zip(ids2, seqs2, quals2)) == sorted(
        zip(ids, seqs, quals))
    assert _fastq(paths[2])[1] != seqs


def test_fasta_reads(tmp_path):
    cfg = dict(CFG, read_format="fasta")
    _, _, paths, draws = gen.make_files(3, str(tmp_path), cfg, TRAFFIC)
    lines = _read(paths[0]).split(b"\n")[:-1]
    assert lines[0] == b">r000000000" and len(lines[1]) == 60
    assert draws[0].quals is None


def test_sample_is_seeded_and_distinct():
    a = gen.sample(5, 0, 10**6, 1000)
    assert (a == gen.sample(5, 0, 10**6, 1000)).all()
    assert len(np.unique(a)) == 1000 and (np.diff(a) > 0).all()
    assert not (a == gen.sample(5, 1, 10**6, 1000)).all()
    assert (gen.sample(5, 0, 100, 1000) == np.arange(100)).all()


# ---------------------------------------------------------------------------
# BENCHMARK.json and the files it names
# ---------------------------------------------------------------------------

BENCHMARK = run.load_json(os.path.join(ROOT, "BENCHMARK.json"))
METRICS = BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]


def test_every_named_file_exists_and_loads():
    configs = {c["name"]: c for c in BENCHMARK["configs"]}
    for c in configs.values():
        cfg = run.load_json(os.path.join(ROOT, c["file"]))
        for key in ("genome_bp", "fragments", "read_length", "read_format",
                    "errprob", "max_mismatches", "mode", "scores",
                    "reference"):
            assert key in cfg, (c["name"], key)
        assert set(c["reduced"]) <= set(cfg["reduced"])
        __import__("portbench." + cfg["reference"])
    used = set()
    for w in BENCHMARK["workloads"]:
        assert w["config"] in configs
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        cell, cfg, traffic = run.cell_files(BENCHMARK, w["name"])
        assert traffic["reads_per_job"] > 0 and traffic["files"]
        gen.file_draws(traffic["files"])
        used.add(w["traffic"])
    files = {os.path.basename(p)[:-5]
             for p in glob.glob(os.path.join(BENCH, "traffic", "*.json"))}
    assert files == used


def test_every_metric_has_a_reader_and_every_reader_a_metric():
    readers = {os.path.basename(p)[:-3]
               for p in glob.glob(os.path.join(BENCH, "metrics", "*.py"))}
    assert readers == {m["name"] for m in METRICS}
    cells = {w["name"] for w in BENCHMARK["workloads"]}
    for m in METRICS:
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCHMARK["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCHMARK["end_to_end"]}


def _job(start, end, reads, phase_s, wall_s, rerun, peak):
    return run.Job(start, end, reads, {"phase_s": phase_s, "wall_s": wall_s,
                                       "overflow_rerun_reads": rerun},
                   peak, [], 0)


def _trace_file(path):
    ev = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 100,
         "dur": 50},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 160, "dur": 5},
        {"ph": "X", "cat": "kernel", "name": "void probe_candidates_kernel"
         "<Narrow>(int)", "ts": 120, "dur": 30},
        {"ph": "X", "cat": "kernel", "name": "verify_windows_kernel",
         "ts": 140, "dur": 20},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 300,
         "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "other_kernel", "ts": 900,
         "dur": 100},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 10},
    ]
    with open(path, "w") as f:
        json.dump({"traceEvents": ev}, f)


def test_metric_readers_on_a_made_up_run(tmp_path):
    p = str(tmp_path / "t.json")
    _trace_file(p)
    tr = trace.read(p)
    # busy: [120, 160) + [300, 400) + [900, 1000); window [100, 1000)
    assert tr.busy_s == pytest.approx(240e-6)
    assert tr.window_s == pytest.approx(900e-6)
    assert tr.idle_gaps[0] == ("host, between cudaLaunchKernel and the "
                               "trace's end", pytest.approx(500e-6))
    assert tr.idle_gaps[1] == ("host, between aten::copy_ and the trace's "
                               "end", pytest.approx(140e-6))
    assert tr.idle_gaps[-1] == ("aten::copy_", pytest.approx(20e-6))
    assert tr.device_ops()[0] == ("Memcpy HtoD", pytest.approx(100e-6))
    # a window given by the host's clock replaces the events' span
    assert trace.read(p, 2e-3).window_s == 2e-3
    assert trace.read(p, 2e-3).busy_s == pytest.approx(240e-6)
    jobs = [
        _job(10.0, 12.0, 1000, {"setup": 0.1, "index_build": 0.2,
                                "match": 0.3, "drain": 0.05,
                                "collect": 0.05, "rerun.match": 0.1},
             1.0, 10, 5 * 10**9),
        _job(12.5, 14.0, 1000, {"setup": 0.1, "index_build": 0.2,
                                "match": 0.1, "drain": 0.0,
                                "collect": 0.0}, 0.6, 0, 6 * 10**9),
    ]
    r = run.Run(20.0, jobs, tr)
    want = {"reads_per_s": 2000 / 3.5, "setup_s": 20.0, "job_s.max": 2.0,
            "parse.s": 0.95, "driver.loop_s": 0.35, "index_build.s": 0.2,
            "rerun.s": 0.05, "rerun.read_share": 0.5, "output.s": 0.2,
            "device_peak_gb": 6.0,
            "device.idle": 100 * (1 - 240e-6 / 1.75), "k1.ms": 0.05}
    # the span metrics read None on these span-less jobs; their readings
    # are test_portbench_spans.py's
    got = {name: run.read_metric(name, r) for name in want}
    assert got == pytest.approx(want)
    quiet = run.Run(20.0, [jobs[1]], None)
    for name in ("rerun.s", "rerun.read_share", "device.idle", "k1.ms"):
        assert run.read_metric(name, quiet) is None


@pytest.mark.parametrize("cut", [1, 7, 1000])
def test_sampled_lines_keep_what_the_check_reads(cut):
    """A job's output cut down between jobs compares as the whole output
    does, however the program split it into writes."""
    from portbench import check
    recs = [b"r%09d\tA\t%d\n" % (i, i) for i in (3, 0, 5, 1, 3)]
    blob = b"".join(recs) + b"junk\n" + b"r000000002\tcut"
    rows = np.array([0, 1, 3, 4])
    want = [recs[1], recs[3], recs[0], None]
    whole = check.differing(blob, 6, rows, want)
    keep = np.zeros(6, bool)
    keep[rows] = True
    chunks = [blob[i:i + cut] for i in range(0, len(blob), cut)]
    kept, bad = check.sampled_lines(chunks, 6, keep)
    assert kept == recs[0] + recs[1] + recs[3] + recs[4]
    assert bad == 2
    # read 3 twice, the junk line, the cut line
    assert check.differing(kept, 6, rows, want) + bad == whole == 3


def test_cell_metrics_follow_workloads():
    for w in BENCHMARK["workloads"]:
        e2e = {m["name"] for m in run.cell_metrics(BENCHMARK, w["name"],
                                                   False)}
        assert {"reads_per_s", "setup_s"} <= e2e
        assert run.cell_metrics(BENCHMARK, w["name"], True)


def _argv_today(cfg, device):
    """job_argv for a configuration without `flags`, written out."""
    argv = ["-t", "g.fa", "-p", "r.fq", "-u",
            "1" if cfg["mode"] == "unique" else "0",
            "-q", "1" if cfg["scores"] else "0",
            "-e", str(cfg["max_mismatches"]), "-R", "0", "-o", "-",
            "-metrics", "m.json"]
    return argv + (["-device", device] if device else [])


@pytest.mark.parametrize("device", [None, "cpu"])
def test_job_argv_appends_a_configurations_own_flags(device):
    configs = [run.load_json(os.path.join(ROOT, c["file"]))
               for c in BENCHMARK["configs"]]
    for cfg in configs + [{"mode": "all", "scores": False,
                           "max_mismatches": 3}]:
        assert run.job_argv(cfg, "g.fa", "r.fq", "m.json", device) == \
            _argv_today(cfg, device)
        flagged = dict(cfg, flags=["-shards", "3", "-l", "64"])
        assert run.job_argv(flagged, "g.fa", "r.fq", "m.json", device) == \
            _argv_today(cfg, device) + ["-shards", "3", "-l", "64"]


@pytest.mark.parametrize("flag", run.HARNESS_FLAGS)
def test_job_argv_refuses_a_flag_the_harness_sets(flag):
    cfg = {"mode": "unique", "scores": True, "max_mismatches": 4,
           "flags": ["-shards", "3", flag, "1"]}
    with pytest.raises(ValueError, match="harness"):
        run.job_argv(cfg, "g.fa", "r.fq", "m.json", "cpu")
