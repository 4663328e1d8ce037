"""Several processes (real_tpu_torch/parallel/multihost.py) against
real_tpu's multihost helpers and the one-process run: the read slices
equal real_tpu's; each rank's card; two gloo processes spawned on the
CPU, with and without -exchange, print the one-process records once their
outputs are concatenated in rank order, also when the ranks' own shard
plans differ and the exchange directory holds an earlier run's shards; a
shard saved by either package's BuildExchange loads in the other's with
the same arrays, narrow and wide. Exact.

Run as a script, this file is one rank of the two-process runs; with
-skew_plan every rank but 0 plans one shard more than the planner says."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from real_tpu_torch.parallel import multihost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT_S = 240


@pytest.mark.parametrize("fastq", [False, True], ids=["fasta", "fastq"])
def test_parse_host_slice_equals_real_tpus(tmp_path, fastq):
    from real_tpu.parallel import multihost as j_multihost
    from tests import ab_util
    _, reads = ab_util.make_inputs(tmp_path, n=8000, numpat=101,
                                   patlen=50, seed=23, fastq=fastq)
    for procs in (1, 2, 3):
        for p in range(procs):
            got = multihost.parse_host_slice(
                reads, multihost.HostTopology(p, procs))
            want = j_multihost.parse_host_slice(
                reads, j_multihost.HostTopology(p, procs))
            assert list(got.ids) == list(want.ids)
            for f in ("lengths", "codes_flat", "offsets", "quals_flat"):
                g, w = getattr(got, f), getattr(want, f)
                assert (g is None) == (w is None)
                if w is not None:
                    np.testing.assert_array_equal(g, w)
            assert got.quality_offset == want.quality_offset


def test_initialize_in_a_plain_process_is_a_no_op(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert multihost.initialize() == multihost.HostTopology(0, 1)
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("device,rank,world,cards,env,want", [
    ("cuda", 0, 1, 4, {}, "cuda"),
    ("cuda", 1, 2, 4, {}, "cuda:1"),
    ("cuda", 3, 4, 2, {}, "cuda:1"),
    ("cuda", 1, 2, 1, {}, "cuda:0"),
    ("cuda", 5, 8, 4, {"LOCAL_RANK": "1"}, "cuda:1"),
    ("cuda:2", 1, 2, 4, {}, "cuda:2"),
    ("cpu", 1, 2, 0, {}, "cpu"),
], ids=["single", "own_card", "wraps", "one_card", "local_rank",
        "explicit_card", "cpu"])
def test_rank_device(device, rank, world, cards, env, want):
    """Plain "cuda" gives each rank of a job its own card (LOCAL_RANK
    under torchrun, else the rank, modulo the cards); anything else and a
    single process keep the device asked for."""
    assert multihost.rank_device(device, multihost.HostTopology(rank, world),
                                 cards, env) == want


def _run_ranks(tmp_path, tag, flags, world=2):
    """`world` ranks of this file as a script, each with a timeout."""
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
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log.read_text()[-3000:]


RANK_CASES = {
    # -shards, -exchange, skewed plans and a stale exchange directory
    "replicated_build": ("3", False, False),
    "exchange": ("3", True, False),
    "exchange_planner_skewed_stale_dir": ("0", True, True),
}


@pytest.mark.parametrize("case", list(RANK_CASES))
def test_two_processes_concatenate_to_the_one_process_file(tmp_path, case):
    """In the skewed case the planner decides (-shards 0), every rank but
    0 would plan one shard more, and the exchange directory holds the
    shards of an earlier run over other bounds: rank 0's plan wins, the
    stale shards go, and the records stay the one process's."""
    from real_tpu_torch.cli import main as t_main
    from tests import ab_util
    shards, exchange, skewed = RANK_CASES[case]
    genome, reads = ab_util.make_inputs(tmp_path, n=12000, numpat=160,
                                        patlen=70, seed=41,
                                        num_fragments=2)
    base = ["-device", "cpu", "-t", genome, "-p", reads, "-B", "64",
            "-shards", shards, "-R", "0"]
    single = tmp_path / "single.txt"
    assert t_main.main([*base, "-o", str(single)]) == 0
    assert single.read_text() == ab_util.run_ours(
        genome, reads, index_shards=int(shards), use_mesh=False)
    units = int(shards) or 1
    xdir = tmp_path / "exchange"
    if skewed:
        # an earlier run's shards over 5 units of the same text
        from real_tpu_torch.config import RealConfig
        from real_tpu_torch.engine import driver
        from real_tpu_torch.index.build import build_index
        text = driver.load_texts(RealConfig(textfilename=genome),
                                 "cpu")[0].packed
        old = multihost.BuildExchange(str(xdir),
                                      multihost.HostTopology(0, 1), "cpu")
        for u in range(5):
            old.save(u, build_index(text, 32, start=16 * u,
                                    num_windows=160))
    out, met = tmp_path / "out.txt", tmp_path / "m.json"
    _run_ranks(tmp_path, "ranks", [*base, "-o", str(out),
                                   "-metrics", str(met)]
               + (["-exchange", str(xdir)] if exchange else [])
               + (["-skew_plan"] if skewed else []))
    merged = b"".join((tmp_path / f"out.txt.{r}").read_bytes()
                      for r in range(2))
    assert merged == single.read_bytes() and merged.count(b"\n") > 100
    metrics = [json.loads((tmp_path / f"m.json.{r}").read_text())
               for r in range(2)]
    assert [m["num_reads"] for m in metrics] == [80, 80]
    assert metrics[0]["plans"] == metrics[1]["plans"]
    for m in metrics:
        assert m["units_dispatched"] == units
        assert ("index_load" in m["phase_s"]) == exchange
    if exchange:
        # every unit published once, by its owner (unit % 2)
        assert sorted(os.listdir(xdir)) == sorted(
            f"shard_{u:05d}.{ext}" for u in range(units)
            for ext in ("npz", "done"))
    else:
        assert not xdir.exists()


def _texts(seedl):
    from real_tpu.text.packed import build_packed_text as j_build
    from real_tpu_torch.text.packed import build_packed_text
    rng = np.random.default_rng(seedl)
    codes = rng.integers(0, 4, 5000).astype(np.uint8)
    codes[700:790] = 3
    codes[3000:3002] = 4
    ranges = [("f0", 0), ("terminal", len(codes))]
    return build_packed_text(codes, ranges, "cpu"), j_build(codes, ranges)


@pytest.mark.parametrize("seedl", [32, 48, 64])
def test_shards_cross_between_the_packages(tmp_path, seedl):
    """The port's BuildExchange writes what real_tpu's reads, and the
    reverse: a shard of the port's build loads in real_tpu with real_tpu's
    arrays of it (convert.index_to_numpy), and real_tpu's shard of its own
    host build loads in the port as that build's arrays."""
    from real_tpu.index.hostbuild import build_index_host as j_build_host
    from real_tpu.parallel import multihost as j_multihost
    from real_tpu_torch.convert import index_to_numpy
    from real_tpu_torch.index.build import build_index
    text, jtext = _texts(seedl)
    topo, jtopo = (multihost.HostTopology(0, 1),
                   j_multihost.HostTopology(0, 1))
    ours = build_index(text, seedl, start=16, num_windows=4000)
    theirs = j_build_host(jtext, seedl, start=16, num_windows=4000)

    multihost.BuildExchange(str(tmp_path / "a"), topo, "cpu").save(0, ours)
    got = j_multihost.BuildExchange(str(tmp_path / "a"), jtopo).load(0)
    want = index_to_numpy(ours)
    for f in ("sig", "pos", "bb", "sig_hi"):
        w = want[f]
        assert (getattr(got, f) is None) == (w is None) == (
            f == "sig_hi" and seedl <= 32)
        if w is not None:
            g = np.asarray(getattr(got, f))
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    assert (got.seedl, got.bucket_bits) == (seedl, ours.bucket_bits)

    j_multihost.BuildExchange(str(tmp_path / "b"), jtopo).save(3, theirs)
    back = index_to_numpy(
        multihost.BuildExchange(str(tmp_path / "b"), topo, "cpu").load(3))
    for f in ("sig", "pos", "bb", "sig_hi"):
        w = getattr(theirs, f)
        assert (back[f] is None) == (w is None)
        if w is not None:
            np.testing.assert_array_equal(back[f], np.asarray(w))
    assert (back["seedl"], back["bucket_bits"]) == (seedl,
                                                    theirs.bucket_bits)


def test_a_shard_that_never_arrives_raises(tmp_path):
    ex = multihost.BuildExchange(str(tmp_path), multihost.HostTopology(1, 2),
                                 "cpu", timeout_s=0.1)
    assert ex.owns(1) and not ex.owns(0)
    with pytest.raises(TimeoutError, match="shard 0 not published"):
        ex.load(0)


def _skew_plan(rank: int) -> None:
    """Every rank but 0 plans one shard more than the planner says."""
    if rank == 0:
        return
    import dataclasses
    from real_tpu_torch.engine import driver
    planned = driver._plan_shards

    def skewed(*a, **kw):
        p = planned(*a, **kw)
        return dataclasses.replace(p, shards=p.shards + 1)
    driver._plan_shards = skewed


if __name__ == "__main__":
    args = sys.argv[1:]
    if "-skew_plan" in args:
        args.remove("-skew_plan")
        _skew_plan(int(args[args.index("-rank") + 1]))
    sys.exit(multihost.main(args))
