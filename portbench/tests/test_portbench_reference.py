"""The yardstick held to the program, and the comparison shown to fail.

On a small genome with repeat families planted as the cells' genomes
have them (so that reads have several hits, ties and non-unique states), the plain reference's records equal the
records of real_tpu_torch's CPU run (-device cpu) byte for byte, for every
read. The control (the reference with its scores summed in float32, one
precision below real's float64) and the program with its timed path
broken (a step that leaves the state unchanged, half of each batch left
out, an answer altered where it is produced) come out not correct. The
tests marked `cuda` run the program on the card and decide inside the
test whether there is one.

The comparison takes a read's several records in any order: on the
program's own matchAll output, reordered, it finds nothing, and it finds
each fault of one read once; on one-record outputs it gives the verdicts
of its frozen one-record version below.
"""

import os
import random
import sys

import numpy as np
import pytest
import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(BENCH))

from portbench import check, gen, reference_unique, run  # noqa: E402
from portbench.check import _lines  # noqa: E402
from portbench.gen import ID_WIDTH  # noqa: E402

SEED = 2**33 + 17
TRAFFIC = {"reads_per_job": 3000, "files": [{"draw": 0}, {"reorder_of": 0}]}


def _config(fmt, k):
    return {"genome_bp": 60000, "fragments": 3, "read_length": 75,
            "read_format": fmt, "errprob": 0.02, "max_mismatches": k,
            "mode": "unique", "scores": True,
            "reference": "reference_unique"}


REPEATS = {"share": 0.2, "length": 300, "copies": [2, 6],
           "divergence": [0.0, 0.03]}


@pytest.fixture(scope="module", params=[("fastq", 4), ("fasta", 5)],
                ids=["fastq.k4", "fasta.k5"])
def data(request, tmp_path_factory):
    fmt, k = request.param
    cfg = _config(fmt, k)
    d = str(tmp_path_factory.mktemp(fmt))
    g = gen.make_genome(SEED, cfg["genome_bp"], cfg["fragments"], REPEATS)
    gpath = os.path.join(d, "genome.fa")
    gen.write_genome(gpath, g)
    num = TRAFFIC["reads_per_job"]
    draw = gen.draw_reads(SEED, 0, g, num, 75, 0.02, fmt == "fastq")
    paths = []
    for i, spec in enumerate(TRAFFIC["files"]):
        paths.append(os.path.join(d, f"reads{i}"))
        gen.write_reads(paths[-1], draw, gen.file_order(SEED, i, num, spec))
    return cfg, g, gpath, paths, draw


def _expected(cfg, g, draw, device="cpu", dtype=np.float64):
    rows = np.arange(len(draw.codes))
    quals = None
    if draw.quals is not None:
        quals = draw.quals.astype(np.int64) \
            - reference_unique.quality_offset(draw.quals)
    ids = [bytes(x) for x in gen.read_ids(rows)]
    return rows, reference_unique.records(g, ids, draw.codes, quals, cfg,
                                          device, dtype)


def _program(cfg, gpath, path, tmp_path, device):
    argv = run.job_argv(cfg, gpath, path, str(tmp_path / "m.json"), device)
    return b"".join(run.run_job(argv, TRAFFIC["reads_per_job"], 0,
                                device.startswith("cuda")).output)


def test_planted_repeats_give_several_hits(data):
    cfg, g, _, _, draw = data
    h = reference_unique.find_hits(g.codes, g.offsets, draw.codes,
                                   cfg["max_mismatches"], "cpu")
    hits = {}
    for r, s, p in zip(h["read"], h["strand"], h["pos"]):
        hits.setdefault(r, set()).add((s, p))
    multi = sum(len(v) > 1 for v in hits.values())
    assert multi >= 20
    _, want = _expected(cfg, g, draw)
    assert sum(w is None for w in want) > multi // 2


@pytest.mark.parametrize("which", [0, 1], ids=["draw", "reordered"])
def test_reference_equals_the_program_on_the_cpu(data, tmp_path, which):
    cfg, g, gpath, paths, draw = data
    rows, want = _expected(cfg, g, draw)
    out = _program(cfg, gpath, paths[which], tmp_path, "cpu")
    assert check.differing(out, len(rows), rows, want) == 0
    if which == 0:
        assert out == b"".join(w for w in want if w)


@pytest.mark.cuda
def test_reference_equals_the_program_on_the_card(data, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    cfg, g, gpath, paths, draw = data
    rows, want = _expected(cfg, g, draw, "cuda")
    out = _program(cfg, gpath, paths[0], tmp_path, "cuda")
    assert out == b"".join(w for w in want if w)


def test_control_float32_scores_are_not_correct(data):
    """The control: the reference in the program's place with its scores
    summed in float32 differs from the float64 reference."""
    cfg, g, _, _, draw = data
    rows, want = _expected(cfg, g, draw)
    _, low = _expected(cfg, g, draw, dtype=np.float32)
    out = b"".join(w for w in low if w)
    assert check.differing(out, len(rows), rows, want) > 0


def test_comparison_catches_malformed_and_doubled_lines(data):
    cfg, g, _, _, draw = data
    rows, want = _expected(cfg, g, draw)
    good = b"".join(w for w in want if w)
    assert check.differing(good, len(rows), rows, want) == 0
    first = next(w for w in want if w)
    assert check.differing(good + first, len(rows), rows, want) == 1
    assert check.differing(good + b"junk\n", len(rows), rows, want) == 1
    assert check.differing(good[:-1], len(rows), rows, want) >= 1
    assert check.differing(b"", len(rows), rows, want) == \
        sum(w is not None for w in want)


def _faulty(monkeypatch, fault):
    from real_tpu_torch.engine import driver
    step = driver.match_step

    def broken(*args, **kw):
        state = args[10]
        if fault == "half_batch":
            valid = args[9].clone()
            valid[valid.shape[0] // 2:] = False
            args = args[:9] + (valid,) + args[10:]
        new, surv = step(*args, **kw)
        if fault == "unchanged":
            return state, surv
        if fault == "altered":
            return new._replace(pos=new.pos + 1), surv
        return new, surv

    monkeypatch.setattr(driver, "match_step", broken)


@pytest.mark.parametrize("fault", [None, "unchanged", "half_batch",
                                   "altered"])
def test_a_run_with_the_timed_path_broken_is_not_correct(
        data, tmp_path, monkeypatch, fault):
    """A whole run but for the look for a card (-device cpu, a window of
    one job): sound, it is correct; with each fault a one-card cell can
    have, it is not. (The exchange between cards has no place here: every
    cell takes one card.)"""
    cfg, *_ = data
    cfg = dict(cfg, genome_bp=30000, fragments=1)
    if fault:
        _faulty(monkeypatch, fault)
    traffic = dict(TRAFFIC, reads_per_job=1500)
    r, checked, bad, _ = run.measure(cfg, traffic, SEED, 0, False,
                                     device="cpu", tmp=str(tmp_path))
    assert checked == len(r.jobs) == 1
    assert (sum(bad) == 0) == (fault is None)


def test_a_traced_run_on_the_cpu(data, tmp_path):
    """--trace 1 adds two traced jobs, whose records are checked too, and
    every job carries its host readings."""
    cfg, *_ = data
    cfg = dict(cfg, genome_bp=30000, fragments=1)
    traffic = dict(TRAFFIC, reads_per_job=1500)
    r, checked, bad, _ = run.measure(cfg, traffic, SEED, 0, True,
                                     device="cpu", tmp=str(tmp_path))
    assert checked == len(r.jobs) + 2 and sum(bad) == 0
    assert r.trace is not None and r.trace.idle_gaps
    assert r.trace.window_s > 0
    for key in ("cpu_s", "probe_ms"):
        assert r.jobs[0].host[key] > 0


# ---------------------------------------------------------------------------
# several records a read: the program's matchAll
# ---------------------------------------------------------------------------

MATCH_ALL = {"mode": "all", "scores": True, "max_mismatches": 3}
ALL_SAMPLE = 1000


@pytest.fixture(scope="module")
def match_all(tmp_path_factory):
    """The port's matchAll on the CPU (-u 0 -q 1 -e 3 -device cpu) over
    50 bp FASTQ reads of a genome with planted repeats: its record lines,
    the reads drawn, the sampled reads, and the job's own records of each
    sampled read in place of a reference's."""
    d = tmp_path_factory.mktemp("all")
    g = gen.make_genome(SEED, 60000, 2, REPEATS)
    gpath = str(d / "genome.fa")
    gen.write_genome(gpath, g)
    num = TRAFFIC["reads_per_job"]
    draw = gen.draw_reads(SEED, 0, g, num, 50, 0.02, True)
    path = str(d / "reads")
    gen.write_reads(path, draw, gen.file_order(SEED, 0, num, {"draw": 0}))
    argv = run.job_argv(MATCH_ALL, gpath, path, str(d / "m.json"), "cpu")
    assert argv[argv.index("-u"):argv.index("-u") + 6] == \
        ["-u", "0", "-q", "1", "-e", "3"]
    out = b"".join(run.run_job(argv, num, 0, False).output)
    lines = out.splitlines(keepends=True)
    by_read = {}
    for line in lines:
        by_read.setdefault(int(line[1:ID_WIDTH]), []).append(line)
    rows = gen.sample(SEED, 0, num, ALL_SAMPLE)
    want = [b"".join(by_read[r]) if r in by_read else None
            for r in rows.tolist()]
    return lines, num, rows, want, by_read


def _fault(case, lines, rows, want, by_read):
    """(lines, want) with `case` done to them."""
    lines, want = list(lines), list(want)
    sampled = rows.tolist()
    multi = [r for r in sampled if len(by_read.get(r, ())) > 1]
    m, other = multi[0], multi[1]
    rec = by_read[m][1]
    if case == "shuffled":
        random.Random(SEED).shuffle(lines)
        # the records of a read are reordered among themselves too
        assert any([x for x in lines if x in by_read[r]] != by_read[r]
                   for r in multi)
    elif case == "dropped":
        lines.remove(rec)
    elif case == "doubled":
        lines.insert(lines.index(rec), rec)
    elif case == "byte":
        i = lines.index(rec)
        at = ID_WIDTH + 1            # the read's first base
        base = b"C" if rec[at:at + 1] == b"A" else b"A"
        lines[i] = rec[:at] + base + rec[at + 1:]
    elif case == "foreign":
        lines.append(by_read[other][0].replace(b"r%09d" % other,
                                               b"r%09d" % m))
    elif case == "records_where_none":
        want[sampled.index(m)] = None
    elif case == "none_where_records":
        lines = [x for x in lines if x not in by_read[m]]
    return lines, want


@pytest.mark.parametrize("case, differs", [
    ("as_written", 0), ("shuffled", 0), ("dropped", 1), ("doubled", 1),
    ("byte", 1), ("foreign", 1), ("records_where_none", 1),
    ("none_where_records", 1)])
def test_several_records_a_read_compare_in_any_order(match_all, case,
                                                     differs):
    lines, num, rows, want, by_read = match_all
    multi = sum(len(by_read.get(r, ())) > 1 for r in rows.tolist())
    assert multi >= 50
    lines, want = _fault(case, lines, rows, want, by_read)
    assert check.differing(b"".join(lines), num, rows, want) == differs


# ---------------------------------------------------------------------------
# one record a read: the verdicts of the one-record comparison
# ---------------------------------------------------------------------------

def _differing_one_record(blob, num_reads, rows, expected):
    """check.differing as it was while a read had one record at most:
    a sampled read differed when its one line was not the reference's,
    or when the output held the read twice. Frozen here to show that the
    multiset comparison gives matchUnique's output the same counts."""
    a = np.frombuffer(blob, np.uint8)
    bad = int(len(a) > 0 and a[-1] != ord("\n"))   # a cut last line
    starts, ends, num, b = _lines(a, num_reads)
    bad += b
    count = np.bincount(num, minlength=num_reads)
    line_of = np.full(num_reads, -1, np.int64)
    line_of[num] = np.arange(len(num))
    for r, want in zip(rows.tolist(), expected):
        i = line_of[r]
        got = None if i < 0 else blob[starts[i]:ends[i]]
        bad += int(got != want or count[r] > 1)
    return bad


def _both(blob, num, rows, want):
    new = check.differing(blob, num, rows, want)
    assert new == _differing_one_record(blob, num, rows, want)
    return new


def test_unique_verdicts_on_the_comparisons_own_cases(data):
    """The cases of test_comparison_catches_malformed_and_doubled_lines
    and of test_portbench_data.py's
    test_sampled_lines_keep_what_the_check_reads."""
    cfg, g, _, _, draw = data
    rows, want = _expected(cfg, g, draw)
    good = b"".join(w for w in want if w)
    first = next(w for w in want if w)
    for blob in (good, good + first, good + b"junk\n", good[:-1], b""):
        _both(blob, len(rows), rows, want)
    recs = [b"r%09d\tA\t%d\n" % (i, i) for i in (3, 0, 5, 1, 3)]
    blob = b"".join(recs) + b"junk\n" + b"r000000002\tcut"
    rows = np.array([0, 1, 3, 4])
    want = [recs[1], recs[3], recs[0], None]
    assert _both(blob, 6, rows, want) == 3
    keep = np.zeros(6, bool)
    keep[rows] = True
    kept, _ = check.sampled_lines([blob], 6, keep)
    _both(kept, 6, rows, want)


@pytest.mark.parametrize("seed", [0, 1, 2**31 + 7, 2**40 + 5])
def test_unique_verdicts_on_made_up_outputs(seed):
    """Seeded one-record outputs, read in any order, with reads missing,
    reads doubled, records changed, records of reads the reference has
    none for, junk lines and a cut last line."""
    rng = np.random.default_rng(seed)
    num = 5000
    rows = gen.sample(seed, 0, num, 1500)
    recs = {r: b"r%09d\t%s\t%d\n" % (r, b"ACGT"[r % 4:r % 4 + 1] * 20,
                                        r * 7)
            for r in range(num)}
    has = rng.random(num) < 0.8
    want = [recs[r] if has[r] else None for r in rows.tolist()]
    out = []
    for r in range(num):
        u = rng.random()
        if has[r] and u < 0.05:
            continue                               # missing
        n = 2 if u < 0.08 else 1                   # doubled
        if not has[r] and u > 0.03:
            n = 0                                  # or printed anyway
        rec = recs[r]
        if 0.08 <= u < 0.1:
            rec = rec[:-2] + b"9\n"                # changed
        out += [rec] * n
    for _ in range(30):
        out.insert(int(rng.integers(len(out) + 1)),
                   [b"junk\n", b"\n", b"r12\tshort\n",
                    b"r%09d\tpast\n" % (num + 3)][int(rng.integers(4))])
    rng.shuffle(out)
    blob = b"".join(out)
    counts = [_both(b, num, rows, want)
              for b in (blob, blob + b"r000000001\tcut", blob[:-1])]
    assert counts[0] > 30 and counts[1] == counts[0] + 1
