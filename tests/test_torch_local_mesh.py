"""The in-process dp x shard mesh of the port (parallel/mesh.py LocalMesh,
engine/driver.py local_mesh_cells / LocalLayout / _foreach_unit,
io/pipeline.py BatchSource.rows) held against real_tpu's mesh on the 8
virtual CPU devices that tests/conftest.py sets up, the port's cells being
RealConfig.mesh_devices = ["cpu"] * n.

* make_plans(row_align=n) and choose_mesh_shape equal real_tpu's.
* One local mesh step (every row's local_row_step) equals real_tpu's
  sharded_match_step field for field, matchUnique states and overflow
  flags and matchAll compact hits, on every grid listed.
* Records of the port's in-process mesh are byte-identical to real_tpu's
  default run, which meshes its 8 devices: both modes, -shards 1/2/3,
  -l 48, the streaming source, a run stopped after one pass and resumed,
  overflow reruns, two texts of different grids, and through cli.run.
* The default: a mesh of every card only when the process sees more than
  one, names no card and is no rank of a job; nothing falls back to one
  device. Exact (integers, bit patterns, bytes)."""

import dataclasses
import io
import os

import jax
import numpy as np
import pytest
import torch

from real_tpu.cli.output import write_all as j_write_all
from real_tpu.cli.output import write_unique as j_write_unique
from real_tpu.config import RealConfig as JConfig
from real_tpu.engine import driver as j_driver
from real_tpu.io import pipeline as j_pipeline
from real_tpu.io import reads as j_reads
from real_tpu.parallel import plan as j_plan
from real_tpu.tools import simulate as j_simulate
from real_tpu_torch.cli import main as t_main
from real_tpu_torch.cli.output import write_all_arrays, write_unique
from real_tpu_torch.config import RealConfig
from real_tpu_torch.engine import driver
from real_tpu_torch.engine.matchstep import initial_state
from real_tpu_torch.index.build import shard_windows
from real_tpu_torch.io import pipeline
from real_tpu_torch.io import reads as reads_io
from real_tpu_torch.parallel import mesh, plan
from real_tpu_torch.scoring.scoring import Scoring, score_tables
from real_tpu_torch.text.packed import build_packed_text
from tests import ab_util
from tests.test_torch_mesh import (B, EPS, FIELDS, KW, _decode, _inputs,
                                   _real_tpu)

CPU8 = ["cpu"] * 8


# ---------------------------------------------------------------------------
# host arithmetic: row-aligned plans, mesh shapes, per-card budgets
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mixed_reads(tmp_path_factory):
    """A read file of four lengths (40 shorter than the seed), 1,900
    reads, FASTA."""
    d = tmp_path_factory.mktemp("mixed")
    g, _ = ab_util.make_inputs(d, n=20000, numpat=1, seed=3)
    from real_tpu.io import fasta as j_fasta
    codes, _ = j_fasta.parse_genome(g)
    rds = []
    for k, (num, patl) in enumerate(((700, 100), (40, 20), (1100, 75),
                                     (60, 50))):
        rds += j_simulate.generate_reads(codes, num, patl, 0.02, False,
                                         seed=30 + k)
    path = str(d / "mixed.fa")
    j_simulate.write_reads(rds, path, False)
    return path


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_row_align_plans_equal_real_tpus(mixed_reads, n):
    jrs = j_reads.parse_reads(mixed_reads)
    trs = reads_io.parse_reads(mixed_reads)
    rng = np.random.default_rng(n)
    subset = np.sort(rng.choice(jrs.num_reads, 333, replace=False))
    for batch, filt, max_rows in ((256, None, 0), (1000, None, 0),
                                  (32768, subset, 512), (100, subset, 0)):
        want = j_pipeline.make_plans(jrs, batch, 32, filt, row_align=n,
                                     max_rows=max_rows)
        got = pipeline.make_plans(trs, batch, 32, filt, max_rows=max_rows,
                                  row_align=n)
        assert [(p.patl, p.rows) for p in got] \
            == [(p.patl, p.rows) for p in want]
        for g, w in zip(got, want):
            assert g.rows % n == 0
            np.testing.assert_array_equal(g.patids, w.patids)
        # dp row slices cover each batch's reads once, in order
        for p in got:
            rows = [pipeline.row_plan(p, n, d) for d in range(n)]
            assert all(r.rows * n == p.rows for r in rows)
            np.testing.assert_array_equal(
                np.concatenate([r.patids for r in rows]), p.patids)


@pytest.mark.parametrize("n_devices", list(range(1, 9)))
def test_choose_mesh_shape_equals_real_tpus(n_devices):
    for total in range(1, 13):
        assert plan.choose_mesh_shape(n_devices, total) \
            == j_plan.choose_mesh_shape(n_devices, total)


def test_cells_that_share_a_card_share_its_budget(monkeypatch):
    """k cells on one device each plan against 1/k of its memory and of
    the bytes reserved there; distinct devices against their own memory,
    the tightest deciding."""
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 4, 300_000).astype(np.uint8)
    text = build_packed_text(codes, [("f", 0), ("terminal", len(codes))],
                             "cpu")
    tf = driver.TextFile("t", text)
    hbm = {"cuda:0": 400 << 20, "cuda:1": 100 << 20, "cpu": 400 << 20}
    monkeypatch.setattr(plan, "hbm_bytes_per_device",
                        lambda d="cuda": hbm[str(torch.device(d))])
    monkeypatch.setattr(plan, "BUCKET_TABLE_BYTES", 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cfg = RealConfig(fracmem=0.5)
    source = type("Src", (), dict(resident_device_bytes=8 << 20, plans=[],
                                  resident=True))()
    nw = len(codes) - 31
    one = driver._plan_shards(cfg, text, torch.device("cpu"),
                              reserved_bytes=len(codes))
    for cells, dev, k in ((["cpu"] * 4, "cpu", 4),
                          (["cuda:0"] * 2 + ["cuda:1"], "cuda:1", 1),
                          (["cuda:0"] * 8 + ["cuda:1"], "cuda:0", 8)):
        lay = driver._local_layout(cfg, [tf], [torch.device(c) for c in cells],
                                   source, 0, 8)
        (fi, splan, m), = lay.texts
        # the route's units: passes over every window, each bounded by
        # the mesh's devices and folding on its rows' homes
        units = lay.units(cfg, [tf])
        assert all(u.devices == m.devices and u.homes
                   == [m.home(d) for d in range(m.n_dp)] for u in units)
        assert len(units) * m.n_shard * units[0].windows >= nw
        want = plan.plan_index_shards(
            nw, 0.5, reserved_bytes=lay.reserved_bytes // k,
            hbm_bytes=hbm[dev] // k, model=plan.NARROW)
        assert splan.shards == want > one.shards
        assert plan.device_cells(cells)[torch.device(dev)] == k
        assert (m.n_dp, m.n_shard) == plan.choose_mesh_shape(len(cells),
                                                              want)
        # the shards planned for one card fit -f of it together
        cost = nw / want * plan.NARROW.bytes_per_window \
            * plan.NARROW.build_factor
        for d, n in plan.device_cells(cells).items():
            assert n * cost + lay.reserved_bytes <= 0.5 * hbm[str(d)]


# ---------------------------------------------------------------------------
# one step: local_row_step against real_tpu's sharded_match_step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def step_data(tmp_path_factory):
    return _inputs(False, tmp_path_factory.mktemp("local"))


def _local(codes, ranges, batch, quals, valid, n_dp, n_shard, seedl,
           scores, matchall):
    """[(state, out)] per dp row of one local mesh step on n_dp x n_shard
    CPU cells, and the mesh."""
    m = mesh.make_local_mesh(n_dp, n_shard, CPU8)
    text = build_packed_text(codes, ranges, "cpu")
    reps = mesh.replicate_text(text, m.devices)
    indexes = mesh.build_local_shards(
        reps, seedl, 0, shard_windows(text.n - seedl + 1, n_shard), m, 0)
    kw = dict(KW, seedl=seedl, scores=scores,
              tables=score_tables(Scoring()) if scores else None)
    rows = B // n_dp
    out = []
    for d in range(n_dp):
        sl = slice(d * rows, (d + 1) * rows)
        b = pipeline.Batch(
            patids=np.arange(d * rows, (d + 1) * rows), patl=batch.shape[1],
            codes=torch.from_numpy(batch[sl]),
            quals=torch.from_numpy(quals[sl]),
            valid=torch.from_numpy(valid[sl]))
        out.append(mesh.local_row_step(
            m, d, indexes, reps, {torch.device("cpu"): b},
            None if matchall else initial_state(rows, "cpu"), 0, EPS,
            matchall=matchall, **kw))
    return out, m


GRIDS = [(1, 2), (2, 1), (2, 2), (1, 4), (2, 4), (4, 2), (8, 1)]


@pytest.mark.parametrize("seedl", [32, 48])
@pytest.mark.parametrize("scores", [False, True], ids=["noscores", "scores"])
@pytest.mark.parametrize("grid", GRIDS, ids=[f"{a}x{b}" for a, b in GRIDS])
def test_local_step_state_equals_real_tpu(step_data, grid, scores, seedl):
    n_dp, n_shard = grid
    want, want_over = _real_tpu(*step_data, n_dp, n_shard, seedl, scores,
                                False, 0)
    got, m = _local(*step_data, n_dp, n_shard, seedl, scores, False)
    for f in FIELDS:
        np.testing.assert_array_equal(
            np.concatenate([getattr(st, f).numpy() for st, _ in got]),
            getattr(want, f), err_msg=f)
    np.testing.assert_array_equal(
        np.concatenate([o.numpy() for _, o in got]), want_over)
    assert (np.isin(want.st, (1, 2))).sum() > 200
    # every cell ran its step; a row of several shards gathered once
    assert sorted(m.launches) == list(range(n_dp * n_shard))
    assert m.gathers == (n_dp if n_shard > 1 else 0)


@pytest.mark.parametrize("scores", [False, True], ids=["noscores", "scores"])
@pytest.mark.parametrize("grid", GRIDS, ids=[f"{a}x{b}" for a, b in GRIDS])
def test_local_step_matchall_hits_equal_real_tpu(step_data, grid, scores):
    n_dp, n_shard = grid
    _, want = _real_tpu(*step_data, n_dp, n_shard, 32, scores, True, 0)
    got, _ = _local(*step_data, n_dp, n_shard, 32, scores, True)
    rows = B // n_dp
    H = len(want.pos) // n_dp
    for d, (_, ch) in enumerate(got):
        ch = type(ch)(*(np.asarray(t) for t in ch))
        sl = slice(d * H, (d + 1) * H)
        w = type(ch)(pos=want.pos[sl], m1=want.m1[sl], m2=want.m2[sl],
                     score=want.score[sl], count=want.count[d],
                     overflow=want.overflow[d * rows:(d + 1) * rows])
        assert int(ch.count) == int(w.count) > rows // 2
        assert _decode(ch, d * rows) == _decode(w, d * rows)
        np.testing.assert_array_equal(ch.overflow, w.overflow)


# ---------------------------------------------------------------------------
# records: the port's in-process mesh against real_tpu's default run
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("localrec")
    g, r = ab_util.make_inputs(d, n=24000, numpat=400, patlen=90,
                               errprob=0.02, seed=71)
    return g, r


_J_CACHE = {}


def _real_tpu_records(g, r, unique, shards, seedl=32, caps=None):
    """real_tpu's default run (it meshes its 8 devices) through its
    driver, cached per arguments."""
    key = (g, r, unique, shards, seedl, caps)
    if key not in _J_CACHE:
        cfg = JConfig(textfilename=g, patternfilename=r, outputfilename="-",
                      match_unique=unique, index_shards=shards, seedl=seedl,
                      batch_size=128)
        if caps:
            cfg.cand_cap, cfg.survivor_cap = caps
        rs = j_reads.parse_reads(r)
        cfg.fastq = rs.fastq
        texts = j_driver.load_texts(cfg)
        assert len(jax.local_devices()) == 8
        buf = io.StringIO()
        if unique:
            j_write_unique(buf, rs, j_driver.run_match_unique(cfg, rs, texts),
                           texts, True)
        else:
            j_write_all(buf, rs, j_driver.run_match_all(cfg, rs, texts),
                        texts, True)
        _J_CACHE[key] = buf.getvalue()
    return _J_CACHE[key]


def _port(g, r, unique, cells=CPU8, **kw):
    """(records, metrics) of the port's driver with `cells` as the
    in-process mesh's cells (None: one device)."""
    cfg = RealConfig(textfilename=g, patternfilename=r, outputfilename="-",
                     match_unique=unique, batch_size=128,
                     mesh_devices=cells, **kw)
    rs = reads_io.parse_reads(r)
    cfg.fastq = rs.fastq
    texts = driver.load_texts(cfg, "cpu")
    buf = io.StringIO()
    if unique:
        res = driver.run_match_unique(cfg, rs, texts, "cpu")
        write_unique(buf, rs, res, texts, True)
    else:
        res = driver.run_match_all(cfg, rs, texts, "cpu", as_arrays=True)
        write_all_arrays(buf, rs, res.cols, texts, True)
    return buf.getvalue(), res.metrics


RECORD_CASES = {
    # mode, -shards, seedl, extra config, real_tpu caps; the grid on 8 cells
    "unique_shards1": (True, 1, 32, {}, None, (8, 1)),
    "unique_shards2": (True, 2, 32, {}, None, (4, 2)),
    "unique_shards3": (True, 3, 32, {}, None, (4, 2)),
    "all_shards1": (False, 1, 32, {}, None, (8, 1)),
    "all_shards2": (False, 2, 32, {}, None, (4, 2)),
    "all_shards3": (False, 3, 32, {}, None, (4, 2)),
    "unique_l48": (True, 2, 48, {}, None, (4, 2)),
    "all_l48": (False, 2, 48, {}, None, (4, 2)),
    "unique_streamed": (True, 3, 32, dict(resident_reads_bytes=1), None,
                        (4, 2)),
    "all_streamed": (False, 3, 32, dict(resident_reads_bytes=1), None,
                     (4, 2)),
    "unique_overflow_rerun": (True, 2, 32, dict(cand_cap=2, survivor_cap=2),
                              (2, 2), (4, 2)),
    "all_overflow_rerun": (False, 2, 32, dict(cand_cap=2, survivor_cap=2),
                           (2, 2), (4, 2)),
}


@pytest.mark.parametrize("case", list(RECORD_CASES))
def test_records_equal_real_tpus_default_run(inputs, case):
    unique, shards, seedl, extra, caps, grid = RECORD_CASES[case]
    g, r = inputs
    got, m = _port(g, r, unique, index_shards=shards, seedl=seedl, **extra)
    want = _real_tpu_records(g, r, unique, shards, seedl, caps)
    assert got == want and got.count("\n") > 300
    assert m["mesh"]["grids"] == [[0, *grid]]
    assert m["mesh"]["devices"] == CPU8
    assert len(m["mesh"]["cell_launches"]) == 8
    assert m["units_dispatched"] == -(-shards // grid[1])
    assert m["mesh_gathers"] == (0 if grid[1] == 1 else
                                 m["units_dispatched"] * grid[0]
                                 * -(-400 // 128))
    assert m["source_resident"] == ("resident_reads_bytes" not in extra)
    if caps:
        assert m["overflow_rerun_reads"] > 0
    else:
        assert got == _port(g, r, unique, cells=None, index_shards=shards,
                            seedl=seedl, **extra)[0]


class _Stop(Exception):
    """The injected failure."""


@pytest.mark.parametrize("unique", [True, False], ids=["unique", "all"])
def test_stopped_after_one_pass_and_resumed(inputs, tmp_path, monkeypatch,
                                            unique):
    """-shards 3 on 8 cells: a 4 x 2 grid in two passes. The run stops at
    the first step of pass 2, after pass 1's checkpoint; the next run
    skips pass 1 and prints real_tpu's records."""
    g, r = inputs
    ckpt = str(tmp_path / "local.npz")
    real = mesh.local_row_step
    calls = {"n": 0, "stop": 4 * -(-400 // 128)}     # one pass of 4 rows

    def step(*a, **kw):
        calls["n"] += 1
        if calls["stop"] and calls["n"] > calls["stop"]:
            raise _Stop("simulated kill")
        return real(*a, **kw)
    monkeypatch.setattr(mesh, "local_row_step", step)
    with pytest.raises(_Stop):
        _port(g, r, unique, index_shards=3, checkpoint=ckpt)
    assert os.path.exists(ckpt)
    calls.update(n=0, stop=0)
    got, m = _port(g, r, unique, index_shards=3, checkpoint=ckpt)
    assert got == _real_tpu_records(g, r, unique, 3)
    assert m["units_skipped"] == 1 and m["units_dispatched"] == 1
    assert calls["n"] == 4 * -(-400 // 128)
    assert not os.path.exists(ckpt)
    # another grid never resumes from it
    with pytest.raises(_Stop):
        calls.update(n=0, stop=4 * -(-400 // 128))
        _port(g, r, unique, index_shards=3, checkpoint=ckpt)
    calls.update(n=0, stop=0)
    got, m = _port(g, r, unique, cells=["cpu"] * 4, index_shards=3,
                   checkpoint=ckpt)
    assert got == _real_tpu_records(g, r, unique, 3)
    assert m["units_skipped"] == 0 and m["mesh"]["grids"] == [[0, 2, 2]]


@pytest.mark.parametrize("unique", [True, False], ids=["unique", "all"])
def test_two_texts_of_different_grids(inputs, tmp_path, monkeypatch,
                                      unique):
    """A -t directory of two .fa files, the larger planned in 3 shards
    (a 4 x 2 grid in two passes) and the smaller in 1 (8 x 1): each text
    gets its own mesh and the matchUnique states move between the grids'
    rows. real_tpu's default run of the same directory is the oracle."""
    g, r = inputs
    tdir = tmp_path / "texts"
    tdir.mkdir()
    with open(g) as f:
        lines = f.read().splitlines()
    body = "".join(lines[1:])
    (tdir / "a.fa").write_text(f">a\n{body[:16000]}\n")
    (tdir / "b.fa").write_text(f">b\n{body[16000:]}\n")
    real_plan = driver._plan_shards

    def plan_by_size(cfg, text, *a, **kw):
        sp = real_plan(cfg, text, *a, **kw)
        return dataclasses.replace(sp, shards=3 if text.n > 10000 else 1)
    monkeypatch.setattr(driver, "_plan_shards", plan_by_size)
    got, m = _port(str(tdir), r, unique)
    assert m["mesh"]["grids"] == [[0, 4, 2], [1, 8, 1]]
    assert m["units_dispatched"] == 3
    want = _real_tpu_records(str(tdir), r, unique, 0)
    assert got == want and got.count("\n") > 300


def test_cli_run_writes_real_tpus_records_and_the_mesh_account(
        inputs, tmp_path):
    import json
    g, r = inputs
    out, mj = tmp_path / "o.txt", tmp_path / "m.json"
    cfg = t_main.parse_args(["-t", g, "-p", r, "-o", str(out), "-B", "128",
                             "-shards", "2", "-metrics", str(mj)])
    cfg.mesh_devices = CPU8
    rs = reads_io.parse_reads(r)
    assert t_main.run(cfg, rs, driver.resolve_device("cpu")) == 0
    assert out.read_text() == _real_tpu_records(g, r, True, 2)
    m = json.loads(mj.read_text())
    assert m["mesh"]["n_dp"] == 4 and m["mesh"]["n_shard"] == 2
    assert m["mesh_gathers"] > 0 and "mesh_gather" in m["phase_s"]


# ---------------------------------------------------------------------------
# the batch source's row slices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("budget", [1 << 30, 1], ids=["resident", "streamed"])
def test_row_slices_equal_the_batches_rows(inputs, budget):
    _, r = inputs
    rs = reads_io.parse_reads(r)
    whole = pipeline.make_source(rs, 128, 32, "cpu", row_align=4,
                                 resident_budget_bytes=budget)
    src = pipeline.make_source(rs, 128, 32, None, row_align=4,
                               resident_budget_bytes=budget)
    assert src.resident == (budget > 1)
    cpu = torch.device("cpu")
    for layout in ([[cpu]] * 4, [[cpu]] * 2, [[cpu]]):
        n = len(layout)
        got = list(src.rows(layout))
        assert len(got) == len(whole.plans)
        for b, parts in zip(whole, got):
            assert len(parts) == n
            for d, part in enumerate(parts):
                rb = part[cpu]
                rows = b.codes.shape[0] // n
                sl = slice(d * rows, (d + 1) * rows)
                np.testing.assert_array_equal(rb.codes, b.codes[sl])
                np.testing.assert_array_equal(rb.valid, b.valid[sl])
                np.testing.assert_array_equal(rb.patids, b.patids[sl])


# ---------------------------------------------------------------------------
# the default, and no fallback
# ---------------------------------------------------------------------------

def test_default_selects_a_mesh_of_every_card_only_when_it_should(
        monkeypatch, tmp_path):
    cfg = RealConfig()
    assert driver.local_mesh_cells(cfg, "cpu") is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert driver.local_mesh_cells(cfg, "cuda") is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert driver.local_mesh_cells(cfg, "cuda") \
        == [torch.device("cuda", i) for i in range(4)]
    assert driver.local_mesh_cells(cfg, torch.device("cuda")) \
        == [torch.device("cuda", i) for i in range(4)]
    # -device cuda:1 pins one card, -device cpu runs one cell
    assert driver.local_mesh_cells(cfg, "cuda:1") is None
    assert driver.local_mesh_cells(cfg, "cpu") is None
    # use_mesh True is the rank mesh, False one device
    assert driver.local_mesh_cells(RealConfig(use_mesh=True), "cuda") is None
    assert driver.local_mesh_cells(RealConfig(use_mesh=False),
                                   "cuda") is None
    assert driver.local_mesh_cells(RealConfig(mesh_devices=["cpu"] * 3),
                                   "cpu") == [torch.device("cpu")] * 3
    with pytest.raises(ValueError, match="mesh_devices"):
        RealConfig(mesh_devices=["cpu"], use_mesh=False)
    # a job of one rank meshes as a single process does (a rank of a job
    # of several drives its own cells: tests/test_torch_rank_local_mesh.py)
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            world_size=1, rank=0)
    try:
        assert driver.local_mesh_cells(cfg, "cuda") \
            == [torch.device("cuda", i) for i in range(4)]
        assert driver.local_mesh_cells(RealConfig(mesh_devices=CPU8),
                                       "cpu") == [torch.device("cpu")] * 8
        assert driver.local_mesh_cells(RealConfig(use_mesh=True),
                                       "cuda") is None
    finally:
        dist.destroy_process_group()


def test_a_mesh_on_cuda_without_cards_raises(inputs, monkeypatch):
    """No fallback: cells on cards this process cannot reach raise, and
    so does an unqualified cell; nothing drops to one device."""
    g, r = inputs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _port(g, r, True, cells=["cuda:0", "cuda:1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh.make_local_mesh(2, 1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        driver.run_match_unique(RealConfig(), reads_io.parse_reads(r), [],
                                "cuda")


def test_an_unreachable_cell_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert mesh.check_cells(["cuda:1", "cuda:1"]) == [torch.device(
        "cuda", 1)] * 2
    with pytest.raises(RuntimeError, match="cannot be reached"):
        mesh.make_local_mesh(1, 2, ["cuda:0", "cuda:2"])
    with pytest.raises(ValueError, match="names its card"):
        mesh.check_cells(["cuda"])
    with pytest.raises(ValueError, match="needs 4 cells"):
        mesh.make_local_mesh(2, 2, ["cuda:0"] * 3)
