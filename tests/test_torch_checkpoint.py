"""Checkpoint/resume, -debug 1 and the watchdog of the port
(engine/checkpoint.py, engine/driver.py, utils/watchdog.py), after
real_tpu's tests/test_checkpoint.py and tests/test_watchdog.py. A run
stopped mid-way must resume from the saved state and unit cursor, really
skip the finished units, and give the uninterrupted run's bytes."""

import io
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

from real_tpu_torch.cli import main as t_main
from real_tpu_torch.cli.output import write_all_arrays, write_unique
from real_tpu_torch.config import RealConfig
from real_tpu_torch.engine import checkpoint as ckpt_mod
from real_tpu_torch.engine import driver
from real_tpu_torch.io import reads as reads_io
from real_tpu_torch.parallel import mesh, multihost, plan
from real_tpu_torch.utils.watchdog import watchdog
from tests import ab_util

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_BATCHES = 3   # 300 reads / 128 -> 3 batches
_REAL_STEP = driver.match_step


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    g, r = ab_util.make_inputs(d, n=30000, numpat=300, patlen=70,
                               errprob=0.03, seed=61)
    return g, r, reads_io.parse_reads(r)


def _cfg(g, r, ckpt="", unique=True, **kw):
    kw.setdefault("index_shards", 3)
    return RealConfig(textfilename=g, patternfilename=r, outputfilename="-",
                      batch_size=128, checkpoint=ckpt, match_unique=unique,
                      **kw)


def _run(cfg, rs, texts):
    """(record bytes, metrics) of one run through the driver."""
    buf = io.StringIO()
    if cfg.match_unique:
        res = driver.run_match_unique(cfg, rs, texts, "cpu")
        write_unique(buf, rs, res, texts, cfg.scores)
    else:
        res = driver.run_match_all(cfg, rs, texts, "cpu", as_arrays=True)
        write_all_arrays(buf, rs, res.cols, texts, cfg.scores)
    return buf.getvalue(), res.metrics


class _Stop(Exception):
    """The injected failure."""


def _stopping_step(monkeypatch, after_calls):
    """driver.match_step raises _Stop on call number after_calls + 1;
    returns the call counter."""
    calls = {"n": 0}
    real = _REAL_STEP

    def step(*a, **kw):
        calls["n"] += 1
        if after_calls is not None and calls["n"] > after_calls:
            raise _Stop("simulated kill")
        return real(*a, **kw)
    monkeypatch.setattr(driver, "match_step", step)
    return calls


@pytest.mark.parametrize("unique", [True, False], ids=["unique", "all"])
@pytest.mark.parametrize("stream", [False, True],
                         ids=["resident", "streaming"])
def test_resume_after_injected_failure(inputs, tmp_path, monkeypatch, unique,
                                       stream):
    g, r, rs = inputs
    ckpt = str(tmp_path / "state.npz")
    extra = dict(resident_reads_bytes=1) if stream else {}
    texts = driver.load_texts(_cfg(g, r), "cpu")
    full, _ = _run(_cfg(g, r, unique=unique, **extra), rs, texts)
    assert full.count("\n") > 200

    # stop at the start of unit 2, after unit 1's checkpoint
    _stopping_step(monkeypatch, N_BATCHES)
    with pytest.raises(_Stop):
        _run(_cfg(g, r, ckpt, unique, **extra), rs, texts)
    assert os.path.exists(ckpt) and not os.path.exists(ckpt + ".tmp")

    calls = _stopping_step(monkeypatch, None)
    resumed, metrics = _run(_cfg(g, r, ckpt, unique, **extra), rs, texts)
    assert resumed == full
    assert metrics["units_skipped"] == 1 and metrics["units_dispatched"] == 2
    # unit 1 really was skipped: its steps never ran (a rerun of
    # overflowing reads would add 512-row steps of its own)
    assert calls["n"] >= 2 * N_BATCHES
    assert calls["n"] < 3 * N_BATCHES or metrics["overflow_rerun_reads"] > 0
    assert not os.path.exists(ckpt)         # deleted on success


# (resident, streamed): the patched device size and the -f values at
# which the planner makes 3 and then 2 shards of the fixture's genome
PLAN_CHANGES = {False: (64 * 2**30, 0.023531, 0.023545),
                True: (8 * 2**20, 0.5, 0.95)}


def _plans(metrics):
    return [(p["shards"], p["serial_build"]) for p in metrics["plans"]]


@pytest.mark.parametrize("unique", [True, False], ids=["unique", "all"])
@pytest.mark.parametrize("stream", [False, True],
                         ids=["resident", "streaming"])
def test_resume_under_another_shard_plan(inputs, tmp_path, monkeypatch,
                                         capsys, unique, stream):
    """A checkpoint written under the planner's 3-shard plan and resumed
    under a -f that plans 2 shards is ignored with a message: its unit
    cursor counts units of another plan, so resuming it would skip other
    windows and print fewer records. The resumed run prints the
    uninterrupted run's bytes."""
    from real_tpu_torch.parallel import plan
    g, r, rs = inputs
    hbm, f3, f2 = PLAN_CHANGES[stream]
    monkeypatch.setattr(plan, "hbm_bytes_per_device", lambda dev="cuda": hbm)
    ckpt = str(tmp_path / "plan.npz")
    extra = dict(resident_reads_bytes=1) if stream else {}
    texts = driver.load_texts(_cfg(g, r), "cpu")

    def cfg(f, path=""):
        return _cfg(g, r, path, unique, index_shards=0, fracmem=f, **extra)
    full3, m3 = _run(cfg(f3), rs, texts)
    full2, m2 = _run(cfg(f2), rs, texts)
    assert full3 == full2 and full2.count("\n") > 200
    assert [s for s, _ in _plans(m3)] == [3] and \
        [s for s, _ in _plans(m2)] == [2]

    _stopping_step(monkeypatch, N_BATCHES)      # after unit 1 of 3
    with pytest.raises(_Stop):
        _run(cfg(f3, ckpt), rs, texts)
    assert os.path.exists(ckpt)
    capsys.readouterr()
    _stopping_step(monkeypatch, None)
    resumed, metrics = _run(cfg(f2, ckpt), rs, texts)
    assert "fingerprint mismatch" in capsys.readouterr().err
    assert resumed == full2
    assert metrics["units_skipped"] == 0 and metrics["units_dispatched"] == 2
    assert _plans(metrics) == _plans(m2)


@pytest.mark.parametrize("exchange", [False, True],
                         ids=["replicated_build", "exchange"])
def test_two_ranks_resume_under_another_shard_plan(inputs, tmp_path,
                                                   exchange):
    """Two ranks over read slices (parallel/multihost.py, gloo on the
    CPU), stopped after their first unit under a 3-shard plan and run again
    under a -f that plans 2: each rank ignores its checkpoint with a
    message, and the concatenation is the one-process file."""
    g, r, _ = inputs
    hbm, f3, f2 = 64 * 2**30, 0.023535, 0.02356
    base = ["-device", "cpu", "-t", g, "-p", r, "-B", "128", "-R", "0",
            "-ckpt", str(tmp_path / "ranks.ckpt"), "-hbm", str(hbm)]
    if exchange:
        base += ["-exchange", str(tmp_path / "exchange")]
    single = tmp_path / "single.txt"
    assert t_main.main(["-device", "cpu", "-t", g, "-p", r, "-B", "128",
                        "-R", "0", "-o", str(single)]) == 0
    out = tmp_path / "out.txt"
    logs = _run_ranks(tmp_path, "stop", [*base, "-f", str(f3), "-o",
                                         str(out), "-stop_after", "2"])
    assert all("simulated kill" in log for log in logs)
    assert all(os.path.exists(tmp_path / f"ranks.ckpt.{k}")
               for k in range(2))
    logs = _run_ranks(tmp_path, "resume", [*base, "-f", str(f2), "-o",
                                           str(out)], check=True)
    assert all("fingerprint mismatch" in log for log in logs)
    merged = b"".join((tmp_path / f"out.txt.{k}").read_bytes()
                      for k in range(2))
    assert merged == single.read_bytes() and merged.count(b"\n") > 200


def _run_ranks(tmp_path, tag, flags, check=False):
    """Two ranks of this file as a script, each with a timeout; their
    logs. With check, both must exit 0."""
    store = tmp_path / f"{tag}.store"
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("WORLD_SIZE", None)
    logs = [tmp_path / f"{tag}.{k}.log" for k in range(2)]
    procs = []
    try:
        for k, log in enumerate(logs):
            with open(log, "wb") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__),
                     "-init_method", f"file://{store}", "-world", "2",
                     "-rank", str(k), *flags],
                    env=env, stdout=f, stderr=subprocess.STDOUT))
        for p in procs:
            p.wait(timeout=240)
    finally:
        for p in procs:
            p.kill()
            p.wait()
    texts = [log.read_text() for log in logs]
    if check:
        for p, text in zip(procs, texts):
            assert p.returncode == 0, text[-3000:]
    return texts


# Each route's checkpoint key before the fingerprint: a changed key makes
# the resume of a checkpoint written before the change start over
# ("checkpoint fingerprint mismatch; ignoring it").
ROUTE_TAGS = {
    "one_device_two_shards": "seq:[(0, 2, False)]-",
    "one_device_exchange": "seq:[(0, 3, False)]-",
    "rank_mesh": "mesh2x2.1.0:[(0, 4)]-",
    "in_process_cells": "local4:[(0, 2, 2, 2)]-",
    "rank_in_process_cells": "rank1of2.local4:[(0, 2, 2, 2)]-",
}


class _Opened(Exception):
    """Raised where a run opens its checkpoint, with the checkpoint's key."""


@pytest.mark.parametrize("unique", [True, False], ids=["unique", "all"])
@pytest.mark.parametrize("route", list(ROUTE_TAGS))
def test_checkpoint_key_of_each_route(inputs, tmp_path, monkeypatch, route,
                                      unique):
    """The key each route and mode give the checkpoint: one device with two
    shards, one device under -exchange (rank 1 of 2, rank 0's plan), a
    rank of a 2 x 2 rank mesh, and an in-process mesh of four CPU cells,
    alone and as rank 1 of 2."""
    g, r, rs = inputs

    def opened(self):
        raise _Opened(self.fp)
    monkeypatch.setattr(ckpt_mod, "fingerprint", lambda *a, **kw: "")
    monkeypatch.setattr(ckpt_mod.Checkpoint, "load", opened)
    monkeypatch.setattr(ckpt_mod.AllCheckpoint, "load", opened)
    cfg = _cfg(g, r, str(tmp_path / "c.npz"), unique, index_shards=2)
    texts = driver.load_texts(cfg, "cpu")

    def rank1of2():
        return multihost.HostTopology(1, 2)
    mesh_plan = None
    if route == "one_device_exchange":
        cfg.index_shards = 3
        cfg.build_exchange_dir = str(tmp_path / "x")
        monkeypatch.setattr(multihost, "current_topology", rank1of2)
        monkeypatch.setattr(multihost.BuildExchange, "agree",
                            lambda self, p: p)
    elif route == "rank_mesh":
        cfg.use_mesh = True
        mesh_plan = driver.MeshPlan(
            mesh.Mesh(2, 2, 1, 0), 0, rs.num_reads, rs.num_reads,
            {0: plan.StreamShardPlan(4, False, driver.BUCKET_BITS_CAP)}, 0)
    elif route.endswith("cells"):
        cfg.mesh_devices = ["cpu"] * 4
        if route.startswith("rank"):
            monkeypatch.setattr(multihost, "current_topology", rank1of2)
    with pytest.raises(_Opened) as opened_with:
        if unique:
            driver.run_match_unique(cfg, rs, texts, "cpu",
                                    mesh_plan=mesh_plan)
        else:
            driver.run_match_all(cfg, rs, texts, "cpu", as_arrays=True,
                                 mesh_plan=mesh_plan)
    assert str(opened_with.value) == ("" if unique else "all-") \
        + ROUTE_TAGS[route]


def test_checkpoint_every_two_units(inputs, tmp_path, monkeypatch):
    g, r, rs = inputs
    ckpt = str(tmp_path / "every.npz")
    texts = driver.load_texts(_cfg(g, r), "cpu")
    full, _ = _run(_cfg(g, r), rs, texts)
    # stopped in unit 2: with -ckpt_every 2 nothing has been saved yet
    _stopping_step(monkeypatch, N_BATCHES + 1)
    with pytest.raises(_Stop):
        _run(_cfg(g, r, ckpt, checkpoint_every=2), rs, texts)
    assert not os.path.exists(ckpt)
    # stopped in unit 3: units 1 and 2 are on disk
    _stopping_step(monkeypatch, 2 * N_BATCHES + 1)
    with pytest.raises(_Stop):
        _run(_cfg(g, r, ckpt, checkpoint_every=2), rs, texts)
    assert os.path.exists(ckpt)
    _stopping_step(monkeypatch, None)
    resumed, metrics = _run(_cfg(g, r, ckpt, checkpoint_every=2), rs, texts)
    assert resumed == full and metrics["units_skipped"] == 2


def test_stale_checkpoint_ignored(inputs, tmp_path, capsys):
    g, r, rs = inputs
    ckpt = str(tmp_path / "stale.npz")
    texts = driver.load_texts(_cfg(g, r), "cpu")
    full, _ = _run(_cfg(g, r), rs, texts)
    # written under ANOTHER config (seedkmax): ignored, not reused
    other = _cfg(g, r, ckpt, seedkmax=1)
    fp = ckpt_mod.fingerprint(other, texts, rs.num_reads, 3, 8, 8)
    bogus = [{f: np.full(128, 9, np.float32 if f == "score" else np.int32)
              for f in ("st", "pos", "frag", "fileid", "errs", "score")}
             for _ in range(3)]
    ckpt_mod.Checkpoint(ckpt, fp).save(3, bogus, [np.zeros(128, bool)] * 3)
    got, metrics = _run(_cfg(g, r, ckpt), rs, texts)
    assert got == full and metrics["units_skipped"] == 0
    assert "fingerprint mismatch" in capsys.readouterr().err
    # a matchUnique checkpoint never resumes a matchAll run
    fp = ckpt_mod.fingerprint(_cfg(g, r, ckpt), texts, rs.num_reads, 3, 8, 8)
    ckpt_mod.Checkpoint(ckpt, fp).save(3, bogus, [np.zeros(128, bool)] * 3)
    full_all, _ = _run(_cfg(g, r, unique=False), rs, texts)
    got_all, metrics = _run(_cfg(g, r, ckpt, unique=False), rs, texts)
    assert got_all == full_all and metrics["units_skipped"] == 0


@pytest.mark.parametrize("content", [b"", b"not a zip file",
                                     b"PK\x03\x04 cut off mid-write"])
def test_unreadable_checkpoint_ignored(inputs, tmp_path, capsys, content):
    g, r, rs = inputs
    ckpt = tmp_path / "torn.npz"
    ckpt.write_bytes(content)
    texts = driver.load_texts(_cfg(g, r), "cpu")
    full, _ = _run(_cfg(g, r), rs, texts)
    got, metrics = _run(_cfg(g, r, str(ckpt)), rs, texts)
    assert got == full and metrics["units_skipped"] == 0
    assert "checkpoint unreadable" in capsys.readouterr().err


def test_edited_readfile_invalidates_checkpoint(inputs, tmp_path):
    """Editing the read file IN PLACE (same name, read count and size)
    must invalidate the checkpoint: the fingerprint holds the input
    files' (size, mtime) stamps."""
    g, r0, _ = inputs
    r = str(tmp_path / "r_edit.fa")
    shutil.copy(r0, r)
    rs = reads_io.parse_reads(r)
    texts = driver.load_texts(_cfg(g, r), "cpu")
    fp1 = ckpt_mod.fingerprint(_cfg(g, r), texts, rs.num_reads, 3, 8, 8)
    assert fp1 == ckpt_mod.fingerprint(_cfg(g, r), texts, rs.num_reads, 3,
                                       8, 8)
    with open(r, "r+b") as f:
        f.seek(200)
        c = f.read(1)
        f.seek(200)
        f.write(b"A" if c != b"A" else b"C")
    time.sleep(0.01)   # mtime_ns moves even on coarse clocks
    os.utime(r)
    rs2 = reads_io.parse_reads(r)
    assert rs2.num_reads == rs.num_reads
    fp2 = ckpt_mod.fingerprint(_cfg(g, r), texts, rs2.num_reads, 3, 8, 8)
    assert fp1 != fp2
    # and every field that shapes the work moves it
    for kw in (dict(seedl=48), dict(index_shards=2), dict(scores=False),
               dict(batch_size=64)):
        cfg = _cfg(g, r)
        for k, v in kw.items():
            setattr(cfg, k, v)
        assert ckpt_mod.fingerprint(cfg, texts, rs2.num_reads, 3, 8, 8) != fp2


def test_checkpoint_arrays_are_numpy_and_round_trip(tmp_path):
    """The file is plain numpy (no pickles): what a CPU run wrote loads
    anywhere numpy does, as the same arrays."""
    path = str(tmp_path / "rt.npz")
    rng = np.random.default_rng(3)
    states = [{f: (rng.random(16).astype(np.float32) if f == "score"
                   else rng.integers(0, 99, 16).astype(np.int32))
               for f in ("st", "pos", "frag", "fileid", "errs", "score")}
              for _ in range(2)]
    over = [rng.random(16) < 0.5 for _ in range(2)]
    ck = ckpt_mod.Checkpoint(path, "fp")
    ck.save(2, states, over)
    with np.load(path, allow_pickle=False) as z:
        assert str(z["fingerprint"]) == "fp"
    data = ck.load()
    assert data["units_done"] == 2
    for a, b in zip(states, data["states"]):
        for f in a:
            assert a[f].dtype == b[f].dtype
            np.testing.assert_array_equal(a[f], b[f])
    for a, b in zip(over, data["overflow"]):
        np.testing.assert_array_equal(a, b)
    cols = tuple(rng.integers(0, 9, 5).astype(dt) for dt in driver.HIT_DTYPES)
    ack = ckpt_mod.AllCheckpoint(path, "all-fp")
    assert ack.load() is None                  # another fingerprint
    ack.save(1, over[0], cols)
    got = ack.load()
    assert got["units_done"] == 1
    for a, b in zip(cols, got["cols"]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    ack.delete()
    assert ack.load() is None and not os.path.exists(path)


@pytest.mark.parametrize("unique", [True, False], ids=["unique", "all"])
def test_debug_checks_flag(inputs, unique):
    """-debug 1 runs the per-step NaN scan and the invariant checks
    without changing results; the validators reject corrupted outputs."""
    g, r, rs = inputs
    texts = driver.load_texts(_cfg(g, r), "cpu")
    ref, _ = _run(_cfg(g, r, unique=unique), rs, texts)
    got, _ = _run(_cfg(g, r, unique=unique, debug_checks=True), rs, texts)
    assert got == ref
    cfg = _cfg(g, r, unique=unique)
    if unique:
        res = driver.run_match_unique(cfg, rs, texts, "cpu")
        driver.validate_result(cfg, res, texts)
        matched = np.flatnonzero((res.st == 1) | (res.st == 2))
        for field, value in (("errs", 99), ("pos", -4), ("pos", 2**30),
                             ("st", 7), ("score", np.nan)):
            bad = driver.MatchResult(**{f: np.copy(getattr(res, f)) for f in
                                        ("st", "pos", "frag", "fileid",
                                         "errs", "score")})
            getattr(bad, field)[matched[0]] = value
            with pytest.raises(AssertionError):
                driver.validate_result(cfg, bad, texts)
    else:
        res = driver.run_match_all(cfg, rs, texts, "cpu", as_arrays=True)
        driver.validate_hits(cfg, res.cols)
        for col, value in ((1, 99), (2, -1), (5, np.inf)):
            cols = [np.copy(c) for c in res.cols]
            cols[col][0] = value
            with pytest.raises(AssertionError):
                driver.validate_hits(cfg, cols)


def test_debug_step_scan_raises_on_nan(inputs, monkeypatch):
    g, r, rs = inputs
    texts = driver.load_texts(_cfg(g, r), "cpu")
    real = driver.match_step

    def poisoned(*a, **kw):
        state, surv = real(*a, **kw)
        score = surv.score.clone()
        score[surv.valid] = float("nan")
        return state, surv._replace(score=score)
    monkeypatch.setattr(driver, "match_step", poisoned)
    with pytest.raises(FloatingPointError):
        driver.run_match_unique(_cfg(g, r, debug_checks=True), rs, texts,
                                "cpu")
    driver.run_match_unique(_cfg(g, r), rs, texts, "cpu")   # unchecked


@pytest.mark.parametrize("flags", [["-u", "1"], ["-u", "0"],
                                   ["-u", "1", "-native", "0"],
                                   ["-u", "0", "-native", "0"]],
                         ids=["unique", "all", "unique_plain_host",
                              "all_plain_host"])
def test_cli_interrupted_then_resumed(inputs, tmp_path, monkeypatch, flags):
    """Through the CLI: -shards 3 -ckpt with a forced streaming source,
    stopped after unit 1 and run again; the file equals real_tpu's."""
    g, r, _ = inputs
    ckpt, out = str(tmp_path / "cli.ckpt"), tmp_path / "out.txt"
    args = ["-device", "cpu", "-t", g, "-p", r, "-o", str(out), "-B", "128",
            "-R", "0", "-shards", "3", "-ckpt", ckpt, "-debug", "1",
            "-watchdog", "60", *flags]
    real_parse = t_main.parse_args

    def parse_streaming(argv):
        cfg = real_parse(argv)
        cfg.resident_reads_bytes = 1
        return cfg
    monkeypatch.setattr(t_main, "parse_args", parse_streaming)
    _stopping_step(monkeypatch, N_BATCHES)
    with pytest.raises(_Stop):
        t_main.main(args)
    assert os.path.exists(ckpt)
    _stopping_step(monkeypatch, None)
    assert t_main.main(args) == 0
    assert not os.path.exists(ckpt)
    want = ab_util.run_ours(g, r, unique=flags[1] == "1", index_shards=3,
                            batch_size=128, use_mesh=False)
    assert out.read_text() == want and want.count("\n") > 200


def test_watchdog_noop_when_fast():
    with watchdog(30, "fast path"):
        x = 1 + 1
    assert x == 2


def test_watchdog_disabled_by_zero():
    for seconds in (0, -1, None):
        with watchdog(seconds, "disabled"):
            pass


def test_watchdog_aborts_wedged_process():
    code = ("import time\n"
            "from real_tpu_torch.utils.watchdog import watchdog\n"
            "with watchdog(0.3, 'wedged fetch'):\n"
            "    time.sleep(30)\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       timeout=60, cwd=REPO,
                       env=dict(os.environ, PYTHONPATH=REPO))
    assert p.returncode == 3
    assert b"WATCHDOG" in p.stderr and b"wedged fetch" in p.stderr


if __name__ == "__main__":
    # one rank of test_two_ranks_resume_under_another_shard_plan: -hbm
    # patches the planner's device size, -stop_after N stops the rank at
    # its match step N + 1
    from real_tpu_torch.parallel import multihost, plan
    args = sys.argv[1:]
    i = args.index("-hbm")
    hbm = int(args[i + 1])
    del args[i:i + 2]
    plan.hbm_bytes_per_device = lambda dev="cuda": hbm
    if "-stop_after" in args:
        i = args.index("-stop_after")
        after = int(args[i + 1])
        del args[i:i + 2]
        calls = [0]

        def step(*a, **kw):
            calls[0] += 1
            if calls[0] > after:
                raise _Stop("simulated kill")
            return _REAL_STEP(*a, **kw)
        driver.match_step = step
    sys.exit(multihost.main(args))
