"""The blocked yardstick of the grch configuration held to the plain one
and to the program, the comparison shown to fail, and the readers of the
unit loop's spans and counters.

reference_unique_blocked.py searches the genome in blocks of key starts.
On small chr21-like and fly-like genomes with repeat families planted, at
block sizes that cut hits, its hits and records equal reference_unique's
read for read. Where a configuration names index units, it folds a read's
hits unit after unit as the program does: on a genome dense with repeats
the program's CPU run with -shards 4 has the unit order's records, which
differ from one unit's on a few reads. The program's CPU run on a small
24-fragment genome with grch's repeat spec, in 4 units, equals the
blocked reference; the float32 control and a record broken on purpose
come out not correct. The three readers of the unit loop's counters read
a made-up run and a CPU run of the harness, and read nothing where the
program writes none of their counters; they are declared for every cell.
"""

import os
import sys

import numpy as np
import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, ROOT)

from portbench import (check, gen, reference_unique,  # noqa: E402
                       reference_unique_blocked as blocked, run)

SEED = 2**37 + 91
NUM = 3000
GRCH = run.load_json(os.path.join(BENCH, "configs", "grch.json"))
CHR21 = run.load_json(os.path.join(BENCH, "configs", "chr21.json"))
FLY = run.load_json(os.path.join(BENCH, "configs", "fly.json"))
# dense repeat families, so that reads have several hits and ties
DENSE = {"share": 0.2, "length": 300, "copies": [2, 6],
         "divergence": [0.0, 0.03]}
UNIT_METRICS = ("index.windows_built_share", "index.build_device_s",
                "rerun.index_build_device_s")
COLS = ("read", "strand", "list", "pos", "mismatches")


def _unit_starts(n, units, seedl=32):
    """The program's units of a text of n bases (< 2^31 - 64): the first
    seed window of each of `units` 16-aligned shards
    (real_tpu_torch/index/build.py shard_windows)."""
    windows = n - seedl + 1
    per = -(-windows // units)
    per = -(-per // 16) * 16
    return list(range(0, windows, per))


def _inputs(cfg, seed=SEED, num=NUM):
    g = gen.cell_genome(seed, cfg)
    draw = gen.draw_reads(seed, 0, g, num, cfg["read_length"],
                          cfg["errprob"], cfg["read_format"] == "fastq")
    quals = None
    if draw.quals is not None:
        quals = draw.quals.astype(np.int64) \
            - reference_unique.quality_offset(draw.quals)
    return g, draw, quals


@pytest.fixture(scope="module", params=["chr21", "fly"])
def small(request):
    """A small genome of the configuration, with dense repeats, its reads
    and reference_unique's hits and records of them."""
    base = {"chr21": CHR21, "fly": FLY}[request.param]
    cfg = dict(base, genome_bp=60000, fragments=3, repeats=DENSE)
    g, draw, quals = _inputs(cfg)
    ids = [bytes(x) for x in gen.read_ids(np.arange(NUM))]
    hits = reference_unique.find_hits(g.codes, g.offsets, draw.codes,
                                      cfg["max_mismatches"], "cpu")
    want = reference_unique.records(g, ids, draw.codes, quals, cfg, "cpu")
    return cfg, g, draw, quals, ids, hits, want


def _rows(h):
    return sorted(zip(*(h[c].tolist() for c in COLS)))


@pytest.mark.parametrize("block", [1000, 4096, 7777])
def test_blocked_hits_equal_the_plain_search(small, block):
    cfg, g, draw, _, _, hits, _ = small
    got = blocked.find_hits(g.codes, g.offsets, draw.codes,
                            cfg["max_mismatches"], "cpu", block)
    assert len(hits["read"]) > NUM
    assert _rows(got) == _rows(hits)


@pytest.mark.parametrize("block", [1000, 7777])
def test_blocked_records_equal_the_plain_reference(small, block):
    cfg, g, draw, quals, ids, _, want = small
    got = blocked.records(g, ids, draw.codes, quals, cfg, "cpu", np.float64,
                          block)
    assert sum(w is not None for w in want) > NUM // 2
    assert got == want


def test_control_and_a_broken_record_are_not_correct(small):
    cfg, g, draw, quals, ids, _, want = small
    rows = np.arange(NUM)
    good = b"".join(w for w in want if w)
    assert check.differing(good, NUM, rows, want) == 0
    low = blocked.records(g, ids, draw.codes, quals, cfg, "cpu", np.float32,
                          4096)
    assert check.differing(b"".join(w for w in low if w), NUM, rows,
                           want) > 0
    i = next(i for i, w in enumerate(want) if w)
    fields = want[i].split(b"\t")
    fields[8] = b"%d" % (int(fields[8]) + 1)          # the position
    broken = list(want)
    broken[i] = b"\t".join(fields)
    assert check.differing(b"".join(w for w in broken if w), NUM, rows,
                           want) == 1


# the reads of this dense genome's draw whose records depend on the units
UNIT_ORDER_READS = [20060, 36997, 40187]


def test_units_fold_in_the_programs_order(tmp_path):
    """Reads with hits in several of 4 units whose records differ from one
    unit's: the program (-shards 4 on the CPU) prints the unit order's."""
    cfg = dict(FLY, genome_bp=300000, fragments=3,
               repeats={"share": 0.6, "length": 300, "copies": [4, 10],
                        "divergence": [0.01, 0.04]},
               flags=["-shards", "4"])
    num = 60000
    g = gen.cell_genome(5151, cfg)
    draw = gen.draw_reads(5151, 0, g, num, 100, 0.02, False)
    rows = np.array(sorted(set(range(1500)) | set(UNIT_ORDER_READS)))
    gpath, rpath = str(tmp_path / "g.fa"), str(tmp_path / "r.fa")
    gen.write_genome(gpath, g)
    gen.write_reads(rpath, draw, rows)
    ids = [bytes(x) for x in gen.read_ids(rows)]
    one = blocked.records(g, ids, draw.codes[rows], None, cfg, "cpu")
    units = blocked.records(
        g, ids, draw.codes[rows], None,
        dict(cfg, index_unit_starts=_unit_starts(cfg["genome_bp"], 4)),
        "cpu", np.float64, 5000)
    assert [int(r) for r, a, b in zip(rows, one, units) if a != b] \
        == UNIT_ORDER_READS
    argv = run.job_argv(cfg, gpath, rpath, str(tmp_path / "m.json"), "cpu")
    out = b"".join(run.run_job(argv, len(rows), 0, False).output)
    assert check.differing(out, num, rows, units) == 0
    assert check.differing(out, num, rows, one) == len(UNIT_ORDER_READS)


def _small_grch(units=4, **flags):
    """grch with its repeat spec on 24 fragments of 20 kbp, in `units`
    units of one text."""
    cfg = dict(GRCH, genome_bp=480000,
               flags=["-shards", str(units)] + [
                   x for kv in flags.items() for x in kv])
    return dict(cfg, index_unit_starts=_unit_starts(cfg["genome_bp"],
                                                    units))


def test_the_program_equals_the_blocked_reference_on_a_small_grch(
        tmp_path, monkeypatch):
    cfg = _small_grch()
    assert cfg["fragments"] == 24 and cfg["read_length"] == 100
    monkeypatch.setattr(blocked, "BLOCK_CPU", 5000)
    traffic = {"reads_per_job": 2000, "files": [{"draw": 0}, {"draw": 1}]}
    r, checked, bad, _ = run.measure(cfg, traffic, SEED, 0, False,
                                     device="cpu", tmp=str(tmp_path))
    assert checked == len(r.jobs) == 1 and bad == [0]
    m = r.jobs[0].metrics
    windows = m["plans"][0]["windows"]
    assert [sum(windows[:i]) for i in range(len(windows))] \
        == cfg["index_unit_starts"]


@pytest.mark.parametrize("units", [1, 3])
def test_unit_readers_read_a_cpu_run(tmp_path, units):
    """A traced run of the harness on the CPU with caps that make reads
    overflow: in 3 units each unit is built twice a job; one unit is
    built once, its rerun taking the cached index."""
    cfg = _small_grch(units, **{"-K": "2", "-S": "2"})
    traffic = {"reads_per_job": 1500, "files": [{"draw": 0}]}
    r, checked, bad, _ = run.measure(cfg, traffic, SEED + 1, 0, True,
                                     device="cpu", tmp=str(tmp_path))
    assert sum(bad) == 0
    assert all(j.metrics["overflow_rerun_reads"] > 0 for j in r.jobs)
    got = {n: run.read_metric(n, r) for n in UNIT_METRICS}
    assert got["index.windows_built_share"] == \
        pytest.approx(100.0 if units == 1 else 200.0)
    assert got["index.build_device_s"] > 0
    if units == 1:
        assert got["rerun.index_build_device_s"] == 0
    else:
        assert got["rerun.index_build_device_s"] > 0


def _job(counters=None, plans=None):
    metrics = {"phase_s": {}, "wall_s": 0.0, "overflow_rerun_reads": 1}
    for key, v in (("counters", counters), ("plans", plans)):
        if v is not None:
            metrics[key] = v
    return run.Job(0.0, 1.0, 1000, metrics, 0, [], 0)


PLANS = [{"windows": [600, 400]}, {"windows": [250, 250]}]


def test_unit_readers_on_a_made_up_run():
    r = run.Run(1.0, [
        _job({"index.windows_built": 3000.0, "index.build_device_s": 2.0,
              "rerun.index.build_device_s": 1.5}, PLANS),
        _job({"index.windows_built": 1500.0, "index.build_device_s": 1.0},
             PLANS)], None)
    got = {n: run.read_metric(n, r) for n in UNIT_METRICS}
    assert got == pytest.approx({"index.windows_built_share": 150.0,
                                 "index.build_device_s": 1.5,
                                 "rerun.index_build_device_s": 0.75})


@pytest.mark.parametrize("job", [
    _job(),                                              # nothing at all
    _job({"output.records": 5.0}, PLANS),                # the parent
    _job({"index.windows_built": 5.0,
          "rerun.index.build_device_s": 1.0}, None),     # no plans
], ids=["nothing", "parent", "no-plans"])
def test_no_unit_counters_nothing_to_read(job):
    r = run.Run(1.0, [job], None)
    for name in UNIT_METRICS:
        assert run.read_metric(name, r) is None


def test_grch_is_declared():
    bench = run.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    conf = {c["name"]: c for c in bench["configs"]}["grch"]
    assert conf["file"] == "portbench/configs/grch.json"
    assert conf["reduced"] == ["reads_per_job"] == list(GRCH["reduced"])
    cell = {w["name"]: w for w in bench["workloads"]}["grch.u.262k"]
    assert (cell["config"], cell["traffic"], cell["chips"]) == \
        ("grch", "u.262k", 1)
    declared = {m["name"]: m for m in bench["per_layer"]}
    cells = [w["name"] for w in bench["workloads"]]
    layers = {"index.windows_built_share": ("index build", "%"),
              "index.build_device_s": ("index build", "s"),
              "rerun.index_build_device_s": ("overflow rerun", "s")}
    for name, (layer, unit) in layers.items():
        m = declared[name]
        assert (m["layer"], m["unit"], m["source"], m["better"],
                m["moves"], m["workloads"]) == \
            (layer, unit, "program_counter", "lower", "reads_per_s", cells)
    for m in bench["per_layer"]:
        assert ("grch.u.262k" in m["workloads"]) \
            == (not m["name"].startswith("allhits."))


def test_grch_units_are_the_split_genomes():
    """The configuration's units: the genome split below 2^31 - 64 bases
    between fragments (16 + 8), each part in 8 and 4 shards."""
    n, f = GRCH["genome_bp"], GRCH["fragments"]
    per = n // f
    first = 16 * per
    assert first < 2**31 - 64 < first + per
    starts = _unit_starts(first, 8) + [first + s for s in
                                       _unit_starts(n - first, 4)]
    assert GRCH["index_unit_starts"] == starts
