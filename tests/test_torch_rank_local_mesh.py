"""Ranks of a multi-process job that each drive an in-process dp x shard
mesh of their own cells: real_tpu's multi-host design (every process
meshes its local devices over its read slice, tests/test_multihost.py with
tests/multihost_worker.py), held against real_tpu's one-process records and
the port's.

* multihost.rank_cells over 1/2/4 ranks x 1/2/4/8 cards, under torchrun's
  LOCAL_RANK / LOCAL_WORLD_SIZE, for an explicit card, the CPU and cards
  left idle; its first card is always rank_device's.
* driver.local_mesh_cells in a job of several ranks: the cells
  RealConfig.mesh_devices names, else the rank's own cards; use_mesh True
  stays the rank mesh and False one device; a rank's mesh with -exchange
  raises.
* Two gloo ranks of this file as a script, each driving
  RealConfig.mesh_devices = ["cpu"] * k through multihost.run_rank on its
  read slice: grids 2 x 1, 1 x 2 and 2 x 2, matchUnique with scores and
  matchAll, seedl 32 and 48, on real_tpu's own two-process inputs and on a
  FASTQ read file whose last slice is not a multiple of 16 reads. The
  rank-order concatenation is byte-identical to real_tpu's one-process
  records and to the port's.
* A rank stopped after one unit and resumed from its -ckpt prints the same
  bytes; a rank's mesh with -exchange raises; -mesh still selects the rank
  mesh. Exact.

Run as a script, this file is one rank of those runs:
  -cells K        the rank's cells: RealConfig.mesh_devices = ["cpu"] * K
  -stop_rank R    rank R raises right after it saved its first checkpoint
  -mesh           the runner's own main (the rank mesh)"""

import json
import os
import subprocess
import sys

import pytest
import torch

from real_tpu_torch.config import RealConfig
from real_tpu_torch.engine import driver
from real_tpu_torch.parallel import multihost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT_S = 240
BATCH = 64


# ---------------------------------------------------------------------------
# a rank's cards
# ---------------------------------------------------------------------------

# (ranks, cards): each rank's cards
CARD_TABLE = {
    (1, 1): [["cuda"]],
    (1, 2): [["cuda"]],
    (1, 4): [["cuda"]],
    (1, 8): [["cuda"]],
    (2, 1): [["cuda:0"], ["cuda:0"]],
    (2, 2): [["cuda:0"], ["cuda:1"]],
    (2, 4): [["cuda:0", "cuda:2"], ["cuda:1", "cuda:3"]],
    (2, 8): [["cuda:0", "cuda:2", "cuda:4", "cuda:6"],
             ["cuda:1", "cuda:3", "cuda:5", "cuda:7"]],
    (4, 1): [["cuda:0"]] * 4,
    (4, 2): [["cuda:0"], ["cuda:1"], ["cuda:0"], ["cuda:1"]],
    (4, 4): [["cuda:0"], ["cuda:1"], ["cuda:2"], ["cuda:3"]],
    (4, 8): [["cuda:0", "cuda:4"], ["cuda:1", "cuda:5"],
             ["cuda:2", "cuda:6"], ["cuda:3", "cuda:7"]],
}


@pytest.mark.parametrize("world,cards", list(CARD_TABLE),
                         ids=[f"{w}ranks_{c}cards" for w, c in CARD_TABLE])
def test_rank_cells_table(world, cards, capsys):
    """Plain "cuda": a rank takes cards // ranks cards, interleaved by
    rank, or rank_device's one card when its share is one or less; no card
    stays idle in these cases, so nothing is said."""
    for rank, want in enumerate(CARD_TABLE[world, cards]):
        topo = multihost.HostTopology(rank, world)
        got = multihost.rank_cells("cuda", topo, cards, {})
        assert got == want
        assert got[0] == multihost.rank_device("cuda", topo, cards, {})
    assert capsys.readouterr().err == ""


ENV_CASES = {
    # device, rank, world, cards, env, cells
    "torchrun_2_nodes_of_2_ranks_4_cards": (
        "cuda", 3, 4, 4, {"LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "2"},
        ["cuda:1", "cuda:3"]),
    "torchrun_one_rank_per_node_8_cards": (
        "cuda", 1, 2, 8, {"LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1"},
        [f"cuda:{i}" for i in range(8)]),
    "torchrun_2_nodes_of_4_ranks_4_cards": (
        "cuda", 5, 8, 4, {"LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "4"},
        ["cuda:1"]),
    "local_rank_without_local_world": (
        "cuda", 5, 8, 4, {"LOCAL_RANK": "1"}, ["cuda:1"]),
    "explicit_card": ("cuda:2", 1, 2, 4, {}, ["cuda:2"]),
    "cpu": ("cpu", 1, 2, 0, {}, ["cpu"]),
    "single_process_8_cards": ("cuda", 0, 1, 8, {}, ["cuda"]),
}


@pytest.mark.parametrize("case", list(ENV_CASES))
def test_rank_cells_under_torchrun_and_as_asked(case, capsys):
    device, rank, world, cards, env, want = ENV_CASES[case]
    topo = multihost.HostTopology(rank, world)
    assert multihost.rank_cells(device, topo, cards, env) == want
    assert want[0] == multihost.rank_device(device, topo, cards, env)
    assert capsys.readouterr().err == ""


def test_cards_left_idle_are_said_once_per_node(capsys):
    """3 ranks on 8 cards take 2 each; cuda:6 and cuda:7 stay idle and
    local rank 0 alone says so."""
    got = [multihost.rank_cells("cuda", multihost.HostTopology(r, 3), 8, {})
           for r in range(3)]
    assert got == [["cuda:0", "cuda:3"], ["cuda:1", "cuda:4"],
                   ["cuda:2", "cuda:5"]]
    err = capsys.readouterr().err
    assert err == "2 of 8 cards stay idle: 3 ranks take 2 each\n"


def test_a_local_rank_outside_its_node_raises():
    with pytest.raises(ValueError, match="local rank 2 outside"):
        multihost.rank_cells("cuda", multihost.HostTopology(2, 4), 4,
                             {"LOCAL_RANK": "2", "LOCAL_WORLD_SIZE": "2"})


# ---------------------------------------------------------------------------
# the driver's choice in a job of several ranks
# ---------------------------------------------------------------------------

@pytest.fixture
def rank1_of_2(monkeypatch):
    """This process as rank 1 of a two-rank job on a machine of 4 cards
    (the topology and the card count stubbed; no torchrun variables)."""
    for var in ("LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(multihost, "current_topology",
                        lambda: multihost.HostTopology(1, 2))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)


def test_a_rank_meshes_its_own_cards(rank1_of_2, monkeypatch):
    assert driver.local_mesh_cells(RealConfig(), "cuda") \
        == [torch.device("cuda", 1), torch.device("cuda", 3)]
    # cfg.mesh_devices names this rank's cells
    assert driver.local_mesh_cells(RealConfig(mesh_devices=["cpu"] * 2),
                                   "cpu") == [torch.device("cpu")] * 2
    assert driver.local_mesh_cells(
        RealConfig(mesh_devices=["cuda:2", "cuda:2"]), "cuda") \
        == [torch.device("cuda", 2)] * 2
    # an explicit card or the CPU runs one device
    assert driver.local_mesh_cells(RealConfig(), "cuda:1") is None
    assert driver.local_mesh_cells(RealConfig(), "cpu") is None
    # use_mesh True is the rank mesh, False one device
    assert driver.local_mesh_cells(RealConfig(use_mesh=True), "cuda") is None
    assert driver.local_mesh_cells(RealConfig(use_mesh=False),
                                   "cuda") is None
    # a share of one card is one device
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert driver.local_mesh_cells(RealConfig(), "cuda") is None


def test_a_ranks_mesh_with_exchange_raises(rank1_of_2, tmp_path):
    with pytest.raises(ValueError, match="-exchange and a rank's in-process"):
        driver.local_mesh_cells(
            RealConfig(build_exchange_dir=str(tmp_path)), "cuda")
    with pytest.raises(ValueError, match="-exchange and a rank's in-process"):
        driver.local_mesh_cells(RealConfig(
            build_exchange_dir=str(tmp_path), mesh_devices=["cpu"] * 2),
            "cpu")
    # one card per rank exchanges shards as before
    assert driver.local_mesh_cells(
        RealConfig(build_exchange_dir=str(tmp_path)), "cuda:1") is None


# ---------------------------------------------------------------------------
# two gloo ranks, each driving its cells
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Two read sets: real_tpu's two-process test inputs
    (tests/test_multihost.py: 12 kbp in two fragments, 192 reads x 70 bp
    FASTA, seeds 21 and 22), and 203 FASTQ reads x 90 bp, whose rank 1
    slice holds 91 reads."""
    from real_tpu.io import fasta as j_fasta
    from real_tpu.tools import simulate
    from tests import ab_util
    d = tmp_path_factory.mktemp("rank_local")
    g, r = str(d / "g.fa"), str(d / "r.fa")
    with open(g, "w") as f:
        f.write(simulate.random_genome(12000, seed=21, num_fragments=2))
    codes, _ = j_fasta.parse_genome(g)
    simulate.write_reads(
        simulate.generate_reads(codes, 192, 70, 0.02, False, seed=22), r,
        False)
    fq = d / "fq"
    fq.mkdir()
    gq, rq = ab_util.make_inputs(fq, n=16000, numpat=203, patlen=90,
                                 seed=61, fastq=True)
    return {"multihost": (g, r, 192), "fastq": (gq, rq, 203)}


_ONE = {}


def _one_process(inputs, data, unique, seedl, tmp_path_factory):
    """(real_tpu's one-process records, the port's one-process CLI file),
    which must agree, cached per arguments."""
    key = (data, unique, seedl)
    if key not in _ONE:
        from real_tpu_torch.cli import main as t_main
        from tests import ab_util
        g, r, _ = inputs[data]
        out = tmp_path_factory.mktemp("one") / "one.txt"
        assert t_main.main(["-device", "cpu", "-t", g, "-p", r, "-o",
                            str(out), "-B", str(BATCH), "-R", "0", "-u",
                            str(int(unique)), "-l", str(seedl)]) == 0
        real_tpu = ab_util.run_ours(g, r, unique=unique, seedl=seedl,
                                    batch_size=BATCH, use_mesh=False)
        _ONE[key] = (real_tpu.encode(), out.read_bytes())
    return _ONE[key]


def _run_ranks(tmp_path, tag, flags, world=2):
    """`world` ranks of this file as a script, each with a timeout;
    returns (exit codes, logs)."""
    store = tmp_path / f"{tag}.store"
    env = dict(os.environ, PYTHONPATH=REPO)
    for var in ("WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        env.pop(var, None)
    logs = [tmp_path / f"{tag}.{r}.log" for r in range(world)]
    procs = []
    try:
        for r, log in enumerate(logs):
            with open(log, "wb") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__),
                     "-init_method", f"file://{store}", "-world", str(world),
                     "-rank", str(r), *flags],
                    env=env, stdout=f, stderr=subprocess.STDOUT))
        for p in procs:
            p.wait(timeout=RANK_TIMEOUT_S)
    finally:
        for p in procs:
            p.kill()
            p.wait()
    return [p.returncode for p in procs], [log.read_text() for log in logs]


def _rank_run(tmp_path, inputs, data, unique, seedl, shards, cells,
              tag="run", extra=()):
    """Two ranks of `cells` CPU cells each; returns (exit codes, logs,
    outputs, metrics), the last two None for a rank that failed."""
    g, r, _ = inputs[data]
    out, met = tmp_path / f"{tag}.txt", tmp_path / f"{tag}.json"
    rcs, logs = _run_ranks(tmp_path, tag, [
        "-cells", str(cells), "-device", "cpu", "-t", g, "-p", r,
        "-B", str(BATCH), "-R", "0", "-u", str(int(unique)),
        "-l", str(seedl), "-shards", str(shards), "-o", str(out),
        "-metrics", str(met), *extra])
    outs = [(tmp_path / f"{tag}.txt.{k}").read_bytes() if rc == 0 else None
            for k, rc in enumerate(rcs)]
    metrics = [json.loads((tmp_path / f"{tag}.json.{k}").read_text())
               if rc == 0 else None for k, rc in enumerate(rcs)]
    return rcs, logs, outs, metrics


RUN_CASES = {
    # inputs, unique, seedl, -shards, cells per rank -> grid of each rank
    "multihost_unique_2x2": ("multihost", True, 32, 2, 4, (2, 2)),
    "multihost_all_2x1": ("multihost", False, 32, 1, 2, (2, 1)),
    "fastq_unique_2x1": ("fastq", True, 32, 1, 2, (2, 1)),
    "fastq_unique_1x2": ("fastq", True, 32, 2, 2, (1, 2)),
    "fastq_all_1x2": ("fastq", False, 32, 2, 2, (1, 2)),
    "fastq_all_2x2": ("fastq", False, 32, 2, 4, (2, 2)),
    "fastq_unique_l48_2x2": ("fastq", True, 48, 2, 4, (2, 2)),
    "fastq_all_l48_1x2": ("fastq", False, 48, 2, 2, (1, 2)),
}


@pytest.mark.parametrize("case", list(RUN_CASES))
def test_ranks_of_local_meshes_concatenate_to_one_process(
        tmp_path, tmp_path_factory, inputs, case):
    data, unique, seedl, shards, cells, grid = RUN_CASES[case]
    real_tpu, one = _one_process(inputs, data, unique, seedl,
                                 tmp_path_factory)
    assert one == real_tpu and one.count(b"\n") > 150
    rcs, logs, outs, metrics = _rank_run(tmp_path, inputs, data, unique,
                                         seedl, shards, cells)
    assert rcs == [0, 0], logs[0][-3000:] + logs[1][-3000:]
    assert b"".join(outs) == real_tpu
    total = inputs[data][2]
    for rank, (log, m) in enumerate(zip(logs, metrics)):
        assert f"rank {rank} of 2: device cpu, cells " \
            + " ".join(["cpu"] * cells) in log
        lo, hi = multihost.host_read_slice(total,
                                           multihost.HostTopology(rank, 2))
        assert m["num_reads"] == hi - lo
        assert m["mesh"]["grids"] == [[0, *grid]]
        assert m["mesh"]["devices"] == ["cpu"] * cells
        assert (m["mesh"]["rank"], m["mesh"]["ranks"]) == (rank, 2)
        assert len(m["mesh"]["cell_launches"]) == cells
        assert m["units_dispatched"] == -(-shards // grid[1])
        assert m["mesh_gathers"] == (grid[1] > 1) * grid[0] * -(-(hi - lo)
                                                                // BATCH)
        assert "mesh_gather" in m["phase_s"]
        # the plain versions run on the CPU: no kernel launches
        assert set(m["kernel_launches"].values()) == {0}


class _StopAfterSave(Exception):
    """Raised by the hook that stops a rank after its first checkpoint."""


@pytest.mark.parametrize("unique", [True, False], ids=["unique", "all"])
def test_a_stopped_rank_resumes_from_its_checkpoint(
        tmp_path, tmp_path_factory, inputs, unique):
    """-shards 3 on 2 cells: a 1 x 2 grid in two passes per rank. Rank 0
    stops after unit 1's checkpoint while rank 1 runs to its end; the
    second run resumes rank 0 after unit 1, runs rank 1 anew, and the
    concatenation is the one-process file."""
    real_tpu, _ = _one_process(inputs, "fastq", unique, 32, tmp_path_factory)
    ckpt = str(tmp_path / "c.ckpt")
    rcs, logs, _, _ = _rank_run(tmp_path, inputs, "fastq", unique, 32, 3, 2,
                                tag="stopped",
                                extra=["-ckpt", ckpt, "-stop_rank", "0"])
    assert rcs[0] != 0 and "_StopAfterSave" in logs[0]
    assert rcs[1] == 0, logs[1][-3000:]
    assert os.path.exists(f"{ckpt}.0") and not os.path.exists(f"{ckpt}.1")
    rcs, logs, outs, metrics = _rank_run(tmp_path, inputs, "fastq", unique,
                                         32, 3, 2, tag="resumed",
                                         extra=["-ckpt", ckpt])
    assert rcs == [0, 0], logs[0][-3000:] + logs[1][-3000:]
    assert b"".join(outs) == real_tpu
    assert [(m["units_skipped"], m["units_dispatched"]) for m in metrics] \
        == [(1, 1), (0, 2)]
    assert not os.path.exists(f"{ckpt}.0")


def test_a_ranks_local_mesh_with_exchange_raises(tmp_path, inputs):
    xdir = tmp_path / "exchange"
    rcs, logs, _, _ = _rank_run(tmp_path, inputs, "multihost", True, 32, 2,
                                2, tag="exchange",
                                extra=["-exchange", str(xdir)])
    assert rcs[0] != 0 and rcs[1] != 0
    for log in logs:
        assert "-exchange and a rank's in-process mesh exclude" in log
    assert not xdir.exists()


def test_mesh_flag_still_selects_the_rank_mesh(tmp_path, tmp_path_factory,
                                               inputs):
    """-mesh through the runner's main: a 1 x 2 grid of ranks, each rank
    one shard of the row, no in-process cells."""
    g, r, _ = inputs["multihost"]
    real_tpu, _ = _one_process(inputs, "multihost", True, 32,
                               tmp_path_factory)
    out, met = tmp_path / "m.txt", tmp_path / "m.json"
    rcs, logs = _run_ranks(tmp_path, "mesh", [
        "-mesh", "-device", "cpu", "-t", g, "-p", r, "-B", str(BATCH),
        "-R", "0", "-shards", "2", "-o", str(out), "-metrics", str(met)])
    assert rcs == [0, 0], logs[0][-3000:] + logs[1][-3000:]
    assert b"".join((tmp_path / f"m.txt.{k}").read_bytes()
                    for k in range(2)) == real_tpu
    for rank in range(2):
        m = json.loads((tmp_path / f"m.json.{rank}").read_text())
        assert m["mesh"] == {"n_dp": 1, "n_shard": 2, "dp": 0,
                             "shard": rank}
        assert "cells" not in logs[rank]


def _pop_flag(args, flag):
    """The value of `flag` in args (removed with it), or None."""
    if flag not in args:
        return None
    i = args.index(flag)
    value = args.pop(i + 1)
    args.pop(i)
    return value


def _stop_after_first_save() -> None:
    from real_tpu_torch.engine import checkpoint

    for cls in (checkpoint.Checkpoint, checkpoint.AllCheckpoint):
        def stopping(self, *a, _save=cls.save, **kw):
            _save(self, *a, **kw)
            raise _StopAfterSave()
        cls.save = stopping


def _rank_main(argv) -> int:
    from real_tpu_torch.cli import main as t_main
    if "-mesh" in argv:
        return multihost.main(argv)
    job, args = multihost.parse_job(argv)
    cells = int(_pop_flag(args, "-cells"))
    stop = _pop_flag(args, "-stop_rank")
    if stop is not None and int(stop) == job.rank:
        _stop_after_first_save()
    cfg = t_main.parse_args(args)
    cfg.mesh_devices = ["cpu"] * cells
    return multihost.run_rank(cfg, job)


if __name__ == "__main__":
    sys.exit(_rank_main(sys.argv[1:]))
