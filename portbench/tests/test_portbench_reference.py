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
"""

import os
import sys

import numpy as np
import pytest
import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(BENCH))

from portbench import check, gen, reference_unique, run  # noqa: E402

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
