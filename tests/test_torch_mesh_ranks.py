"""Mesh runs (python -m real_tpu_torch.parallel.multihost -mesh) as real
gloo processes on the CPU: for the grids (1,2), (2,1) and (2,2), in both
modes, the ranks' outputs concatenated in rank order are byte-identical to
the one-process CLI file and to real_tpu's records, also after a resume
from the ranks' checkpoints and with an overflow rerun in one dp row only;
a pure-dp two-rank matchAll run without -mesh concatenates the same way.
The runner's conflicts raise, and a rank that dies makes its row's other
rank raise instead of hang. Exact.

Run as a script, this file is one rank of those runs:
  -stop_after_unit N   every rank raises before it builds unit N + 1
  -small_cap_ranks L   the ranks in the comma list L run with cand_cap 1
  -die_rank R          rank R raises before its first gather"""

import json
import os
import subprocess
import sys

import pytest
import torch

from real_tpu_torch.parallel import multihost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT_S = 240


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The genome, the reads and, per mode, the one-process CLI file
    (-shards 1), which must equal real_tpu's records."""
    from real_tpu_torch.cli import main as t_main
    from tests import ab_util
    d = tmp_path_factory.mktemp("mesh_ranks")
    genome, reads = ab_util.make_inputs(d, n=12000, numpat=160, patlen=70,
                                        seed=41, num_fragments=2)
    one = {}
    for unique in (True, False):
        out = d / f"one_{int(unique)}.txt"
        assert t_main.main(["-device", "cpu", "-t", genome, "-p", reads,
                            "-o", str(out), "-B", "64", "-R", "0",
                            "-u", str(int(unique))]) == 0
        one[unique] = out.read_bytes()
        assert one[unique].decode() == ab_util.run_ours(
            genome, reads, unique=unique, index_shards=1, use_mesh=False)
        assert one[unique].count(b"\n") > 100
    return genome, reads, one


def _run_ranks(tmp_path, tag, flags, world, expect_ok=True):
    """`world` ranks of this file as a script, each with a timeout;
    returns their logs."""
    store = tmp_path / f"{tag}.store"
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("WORLD_SIZE", None)
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
    texts = [log.read_text() for log in logs]
    for p, text in zip(procs, texts):
        assert (p.returncode == 0) == expect_ok, text[-3000:]
    return texts


def _mesh_run(tmp_path, inputs, unique, world, shards, extra=(), tag="mesh",
              expect_ok=True):
    genome, reads, _ = inputs
    out, met = tmp_path / f"{tag}.txt", tmp_path / f"{tag}.json"
    logs = _run_ranks(tmp_path, tag, [
        "-mesh", "-device", "cpu", "-t", genome, "-p", reads, "-B", "64",
        "-R", "0", "-u", str(int(unique)), "-shards", str(shards),
        "-o", str(out), "-metrics", str(met), *extra], world, expect_ok)
    if not expect_ok:
        return logs, None, None
    outs = [(tmp_path / f"{tag}.txt.{r}").read_bytes() for r in range(world)]
    metrics = [json.loads((tmp_path / f"{tag}.json.{r}").read_text())
               for r in range(world)]
    return logs, outs, metrics


GRIDS = {
    # (n_dp, n_shard): world, -shards, passes
    (1, 2): (2, 4, 2),
    (2, 1): (2, 1, 1),
    (2, 2): (4, 3, 2),
    (4, 2): (8, 3, 2),
    (2, 4): (8, 5, 2),
}
SLOW_GRIDS = {(4, 2), (2, 4)}      # eight processes each


@pytest.mark.parametrize("unique", [True, False], ids=["unique", "all"])
@pytest.mark.parametrize("grid", [
    pytest.param(g, id=f"{g[0]}x{g[1]}",
                 marks=[pytest.mark.slow] if g in SLOW_GRIDS else [])
    for g in GRIDS])
def test_mesh_ranks_concatenate_to_the_one_process_file(tmp_path, inputs,
                                                        grid, unique):
    n_dp, n_shard = grid
    world, shards, passes = GRIDS[grid]
    _, outs, metrics = _mesh_run(tmp_path, inputs, unique, world, shards)
    assert b"".join(outs) == inputs[2][unique]
    for r, (out, m) in enumerate(zip(outs, metrics)):
        assert m["mesh"] == {"n_dp": n_dp, "n_shard": n_shard,
                             "dp": r // n_shard, "shard": r % n_shard}
        assert (out == b"") == (r % n_shard != 0)
        assert m["units"] == m["units_dispatched"] == passes
        lo, hi = multihost.host_read_slice(
            160, multihost.HostTopology(r // n_shard, n_dp))
        assert m["num_reads"] == hi - lo
        assert "mesh_gather" in m["phase_s"]
        # one gather per step of a pass (64-row batches); none in a row of
        # one shard
        assert m["mesh_gathers"] == (n_shard > 1) * passes * -(-(hi - lo)
                                                                // 64)
        # the plain versions run on the CPU: no kernel launches
        assert set(m["kernel_launches"].values()) == {0}


class _StopAfterUnit(Exception):
    """Raised by the hook that stops every rank after a unit."""


def test_mesh_ranks_resume_from_their_checkpoints(tmp_path, inputs):
    """Every rank stops after unit 1 of 2 (scores on); the second run
    skips it on every rank and prints the one-process records."""
    ckpt = str(tmp_path / "c.ckpt")
    logs, _, _ = _mesh_run(tmp_path, inputs, True, 2, 4,
                           ["-ckpt", ckpt, "-stop_after_unit", "1"],
                           tag="stopped", expect_ok=False)
    assert all("_StopAfterUnit" in log for log in logs)
    assert all(os.path.exists(f"{ckpt}.{r}") for r in range(2))
    _, outs, metrics = _mesh_run(tmp_path, inputs, True, 2, 4,
                                 ["-ckpt", ckpt], tag="resumed")
    assert b"".join(outs) == inputs[2][True]
    for r, m in enumerate(metrics):
        assert (m["units_skipped"], m["units_dispatched"]) == (1, 1)
        assert not os.path.exists(f"{ckpt}.{r}")


def test_overflow_rerun_in_one_dp_row_only(tmp_path, inputs):
    """Row 0 of a (2,2) mesh runs with cand_cap 1 and reruns its
    overflowing reads in lockstep; row 1 has none and never waits."""
    for unique in (True, False):
        _, outs, metrics = _mesh_run(
            tmp_path, inputs, unique, 4, 3, ["-small_cap_ranks", "0,1"],
            tag=f"cap{int(unique)}")
        assert b"".join(outs) == inputs[2][unique]
        reruns = [m["overflow_rerun_reads"] for m in metrics]
        assert reruns[0] == reruns[1] > 0 and reruns[2] == reruns[3] == 0
        assert "rerun.mesh_gather" in metrics[0]["phase_s"]
        assert not any(k.startswith("rerun.") for k in metrics[2]["phase_s"])


def test_pure_dp_matchall_ranks_concatenate(tmp_path, inputs):
    """Two ranks of matchAll through the runner without -mesh: each
    parses and matches its own slice."""
    genome, reads, one = inputs
    out = tmp_path / "dp.txt"
    _run_ranks(tmp_path, "dp", ["-device", "cpu", "-t", genome, "-p", reads,
                                "-B", "64", "-R", "0", "-u", "0", "-shards",
                                "2", "-o", str(out)], 2)
    assert b"".join((tmp_path / f"dp.txt.{r}").read_bytes()
                    for r in range(2)) == one[False]


def test_a_dead_rank_makes_its_row_raise(tmp_path, inputs):
    logs, _, _ = _mesh_run(tmp_path, inputs, True, 2, 2, ["-die_rank", "1"],
                           tag="dead", expect_ok=False)
    assert "rank 1 dies before its first gather" in logs[1]
    assert "Traceback" in logs[0]


def test_mesh_with_exchange_raises_before_joining(tmp_path, inputs):
    genome, reads, _ = inputs
    with pytest.raises(ValueError, match="-mesh and -exchange"):
        multihost.main(["-mesh", "-exchange", str(tmp_path / "x"),
                        "-device", "cpu", "-t", genome, "-p", reads,
                        "-o", str(tmp_path / "o.txt")])
    assert not torch.distributed.is_initialized()


def test_use_mesh_without_a_group_raises(tmp_path, inputs):
    from real_tpu_torch.cli import main as t_main
    from real_tpu_torch.config import RealConfig
    from real_tpu_torch.engine import driver
    from real_tpu_torch.io import reads as reads_io
    genome, reads, _ = inputs
    cfg = RealConfig(textfilename=genome, patternfilename=reads,
                     outputfilename=str(tmp_path / "o.txt"), use_mesh=True)
    rs = reads_io.parse_reads(reads)
    with pytest.raises(RuntimeError, match="initialized process group"):
        t_main.run(cfg, rs, torch.device("cpu"))
    texts = driver.load_texts(cfg, "cpu")
    for run in (driver.run_match_unique, driver.run_match_all):
        with pytest.raises(RuntimeError, match="driver.plan_mesh"):
            run(cfg, rs, texts, "cpu")


def test_a_world_that_is_not_the_grid_raises(tmp_path):
    from real_tpu_torch.parallel import mesh
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{tmp_path / 'store'}", world_size=1,
        rank=0)
    try:
        with pytest.raises(ValueError, match="needs 2 ranks, the job has 1"):
            mesh.make_mesh(1, 2)
        m = mesh.make_mesh(1, 1)
        assert (m.n_dp, m.n_shard, m.dp, m.shard) == (1, 1, 0, 0)
    finally:
        torch.distributed.destroy_process_group()


def _install_hooks(args):
    """The script options of the module docstring; returns the CLI args."""
    from real_tpu_torch.parallel import mesh
    rank = int(args[args.index("-rank") + 1])
    if "-stop_after_unit" in args:
        i = args.index("-stop_after_unit")
        units = int(args.pop(i + 1))
        args.pop(i)
        build, calls = mesh.build_sharded_index, [0]

        def stopping_build(*a, **kw):
            calls[0] += 1
            if calls[0] > units:
                raise _StopAfterUnit()
            return build(*a, **kw)
        mesh.build_sharded_index = stopping_build
    if "-small_cap_ranks" in args:
        i = args.index("-small_cap_ranks")
        ranks = [int(x) for x in args.pop(i + 1).split(",")]
        args.pop(i)
        if rank in ranks:
            args += ["-K", "1"]
    if "-die_rank" in args:
        i = args.index("-die_rank")
        if rank == int(args.pop(i + 1)):
            def die(*a, **kw):
                raise SystemExit(f"rank {rank} dies before its first gather")
            mesh.gather_survivors = die
        args.pop(i)
    return args


if __name__ == "__main__":
    sys.exit(multihost.main(_install_hooks(sys.argv[1:])))
