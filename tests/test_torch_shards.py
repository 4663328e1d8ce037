"""Index shards and the memory planner of the port against real_tpu's.

The planning functions are held against real_tpu.parallel.plan over a grid
when they are given real_tpu's constants (the port's own defaults describe
its own build on an H100 and are not real_tpu's). Sharded runs, forced and
planner-chosen, must print records byte-identical to real_tpu's at the same
setting and to the port's own one-shard run. Exact throughout."""

import gc
import io
import weakref

import numpy as np
import pytest

from real_tpu.engine import driver as j_driver
from real_tpu.index import build as j_build
from real_tpu.parallel import plan as j_plan
from real_tpu_torch.cli.output import write_all_arrays, write_unique
from real_tpu_torch.config import RealConfig
from real_tpu_torch.engine import driver
from real_tpu_torch.index import build as t_build
from real_tpu_torch.io import reads as reads_io
from real_tpu_torch.parallel import plan
from tests import ab_util

HBM = 16 * 1024**3
# real_tpu's memory model (lax.sort on uint32 planes on its device)
J_MODEL = plan.MemoryModel(j_plan.BYTES_PER_WINDOW, j_plan.BUILD_FACTOR,
                           j_plan.SERIAL_BUILD_FACTOR)


def _same_plan(a, b):
    return (a.shards, a.serial_build, a.bucket_bits_cap) \
        == (b.shards, b.serial_build, b.bucket_bits_cap)


@pytest.mark.parametrize("windows", [1000, 1_000_000, 46_700_000,
                                     140_000_000, 500_000_000,
                                     2_070_000_000])
@pytest.mark.parametrize("fracmem", [0.05, 0.3, 0.75, 1.0])
def test_planners_equal_real_tpu_given_its_constants(windows, fracmem):
    for reserved in (0, 35_000_000, 800_000_000, 3 * 2**30):
        for hbm in (256 * 2**20, 2**30, HBM, 80 * 2**30):
            assert plan.plan_index_shards(
                windows, fracmem, reserved, hbm, J_MODEL) \
                == j_plan.plan_index_shards(
                    windows, fracmem, reserved_bytes=reserved, hbm_bytes=hbm)
            assert _same_plan(
                plan.plan_index_shards_streaming(windows, fracmem, reserved,
                                                 hbm, J_MODEL),
                j_plan.plan_index_shards_streaming(
                    windows, fracmem, reserved_bytes=reserved,
                    hbm_bytes=hbm))


PINNED = {
    # real_tpu's tests/test_plan_streaming.py cases: windows, reserved, hbm
    "config4_two_serial_shards": (140_000_000, 35_000_000, HBM),
    "small_genome_keeps_pipelined_plan": (46_700_000, 12_000_000, HBM),
    "tiny_device_falls_back": (1_000_000, 0, 256 * 1024**2),
    "serial_shard_memory_model": (2_070_000_000, 800_000_000, HBM),
}


@pytest.mark.parametrize("case", sorted(PINNED))
def test_streaming_plan_pinned_cases(case):
    windows, reserved, hbm = PINNED[case]
    p = plan.plan_index_shards_streaming(windows, 0.75, reserved, hbm,
                                         J_MODEL)
    assert _same_plan(p, j_plan.plan_index_shards_streaming(
        windows, 0.75, reserved_bytes=reserved, hbm_bytes=hbm))
    if case == "config4_two_serial_shards":
        assert (p.shards, p.serial_build, p.bucket_bits_cap) == (2, True, 26)
        assert plan.plan_index_shards(windows, 0.75, reserved, hbm,
                                      J_MODEL) == 3
    elif case == "small_genome_keeps_pipelined_plan":
        assert p.shards == 1 and not p.serial_build
    elif case == "tiny_device_falls_back":
        assert p.shards >= 1
    else:
        per = -(-windows // p.shards)
        table = 6 * ((1 << p.bucket_bits_cap) + 1) * 4
        assert p.serial_build
        assert per * J_MODEL.bytes_per_window * J_MODEL.serial_build_factor \
            + table <= 0.75 * hbm - reserved
        assert per / float(1 << p.bucket_bits_cap) <= 2.0


def test_own_memory_models_are_the_ports():
    """The defaults describe the port's build: wide lists are 72 B per
    window, a build peaks above its lists, and pipelining costs one more
    set of lists than a serial build."""
    for m, b in ((plan.NARROW, 48), (plan.WIDE, 72)):
        assert m.bytes_per_window == b
        assert m.serial_build_factor > 1.0
        assert m.build_factor > m.serial_build_factor + 1.0
    assert plan.model_for(32) is plan.NARROW
    assert plan.model_for(36) is plan.WIDE
    # a bigger build peak can only plan more shards
    lean = plan.memory_model(48, 100.0)
    fat = plan.memory_model(48, 400.0)
    assert plan.plan_index_shards(500_000_000, 0.75, 0, 80 * 2**30, fat) \
        > plan.plan_index_shards(500_000_000, 0.75, 0, 80 * 2**30, lean)
    assert plan.hbm_bytes_per_device("cpu") > 2**30
    assert plan.choose_mesh_shape(8, 3) == j_plan.choose_mesh_shape(8, 3)
    assert plan.choose_mesh_shape(4, 9) == j_plan.choose_mesh_shape(4, 9)


@pytest.mark.parametrize("windows", [1, 17, 1000, 23969, 46_699_926])
def test_shard_bounds_equal_real_tpu(windows):
    for shards in (1, 2, 3, 4, 7, 64):
        assert t_build.shard_windows(windows, shards) \
            == j_build.shard_windows(windows, shards)
        bounds = driver._shard_bounds(windows, shards)
        assert bounds == j_driver._shard_bounds(windows, shards)
        assert bounds[0][0] == 0 and bounds[-1][1] == windows
        assert all(s % 16 == 0 for s, _ in bounds)
        assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))


def _port_run(genome, reads, *, unique=True, scores=True, shards=1,
              stream=False, split_limit=None, fracmem=0.75, seedl=32):
    cfg = RealConfig(textfilename=genome, patternfilename=reads,
                     outputfilename="-", match_unique=unique, scores=scores,
                     index_shards=shards, batch_size=512, fracmem=fracmem,
                     seedl=seedl, resident_reads_bytes=1 if stream else 0)
    rs = reads_io.parse_reads(reads)
    if split_limit is None:
        texts = driver.load_texts(cfg, "cpu")
    else:
        texts = driver.load_texts(cfg, "cpu", split_limit=split_limit)
    buf = io.StringIO()
    if unique:
        res = driver.run_match_unique(cfg, rs, texts, "cpu")
        write_unique(buf, rs, res, texts, scores)
    else:
        res = driver.run_match_all(cfg, rs, texts, "cpu", as_arrays=True)
        write_all_arrays(buf, rs, res.cols, texts, scores)
    return buf.getvalue(), res.metrics


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("shards")
    genome, reads = ab_util.make_inputs(d, n=24000, numpat=250, patlen=90,
                                        errprob=0.02, seed=23)
    one = {(u, q): _port_run(genome, reads, unique=u, scores=q)[0]
           for u in (True, False) for q in (True, False)}
    return genome, reads, one


@pytest.mark.parametrize("unique,scores,shards,stream", [
    (True, True, 2, False), (True, True, 3, True), (True, True, 4, False),
    (True, False, 3, False), (True, False, 4, True),
    (False, True, 3, False), (False, True, 2, True), (False, False, 4, False),
], ids=lambda v: str(v))
def test_forced_shards_records_equal_real_tpu(inputs, unique, scores, shards,
                                              stream):
    genome, reads, one = inputs
    got, metrics = _port_run(genome, reads, unique=unique, scores=scores,
                             shards=shards, stream=stream)
    assert metrics["units"] == metrics["units_dispatched"] == shards
    assert metrics["source_resident"] == (not stream)
    if stream:
        assert metrics["streamed_batches"] == shards * 1   # 250 reads: 1 batch
    assert got.count("\n") > 150
    assert got == one[(unique, scores)]
    assert got == ab_util.run_ours(genome, reads, unique=unique,
                                   scores=scores, index_shards=shards,
                                   use_mesh=False)


@pytest.mark.parametrize("unique", [True, False], ids=["unique", "all"])
def test_planner_chosen_split_records_equal_real_tpu(inputs, monkeypatch,
                                                     unique):
    """A device of 8 MB: both planners split the 24,000-window text, each
    by its own memory model, and the records do not notice."""
    genome, reads, one = inputs
    tiny = 8 * 1024**2
    monkeypatch.setattr(plan, "hbm_bytes_per_device", lambda device="cuda":
                        tiny)
    monkeypatch.setattr(j_plan, "hbm_bytes_per_device", lambda: tiny)
    got, metrics = _port_run(genome, reads, unique=unique, shards=0)
    assert metrics["units"] > 1 and metrics["plans"][0]["shards"] > 1
    assert metrics["units_dispatched"] == metrics["units"]
    assert got == one[(unique, True)]
    assert got == ab_util.run_ours(genome, reads, unique=unique,
                                   index_shards=0, use_mesh=False)


def test_planner_reserves_texts_reads_and_workspace(inputs, monkeypatch):
    genome, reads, _ = inputs
    seen = []
    real = driver._plan_shards

    def spy(cfg, text, dev, **kw):
        seen.append(kw)
        return real(cfg, text, dev, **kw)
    monkeypatch.setattr(driver, "_plan_shards", spy)
    _, metrics = _port_run(genome, reads, shards=0)
    assert metrics["units"] == 1            # the host's RAM holds 24 kbp
    text_bytes = 24000 // 4 + 2 * 24000 // 8
    assert seen[0]["reserved_bytes"] == metrics["reserved_bytes"]
    assert metrics["reserved_bytes"] > text_bytes \
        + metrics["resident_read_bytes"] + 512 * 90 * 8
    assert seen[0]["reads"] == 250 and seen[0]["streaming"] is False


@pytest.mark.parametrize("serial", [True, False],
                         ids=["serial_build", "pipelined"])
def test_serial_build_frees_the_previous_index(inputs, monkeypatch, serial):
    """Under a serial_build plan no earlier unit's index is alive when the
    next build starts; a pipelined plan still holds exactly the previous
    one. Records equal the one-shard run either way."""
    genome, reads, one = inputs
    monkeypatch.setattr(
        driver, "_plan_shards", lambda *a, **kw: plan.StreamShardPlan(
            shards=3, serial_build=serial, bucket_bits_cap=25))
    built, alive_at_build = [], []
    real = driver.build_index

    def counting_build(*a, **kw):
        gc.collect()
        alive_at_build.append(sum(r() is not None for r in built))
        index = real(*a, **kw)
        built.append(weakref.ref(index))
        return index
    monkeypatch.setattr(driver, "build_index", counting_build)
    got, metrics = _port_run(genome, reads, shards=0, stream=True)
    assert metrics["units_dispatched"] == 3 and len(built) == 3
    assert alive_at_build == ([0, 0, 0] if serial else [0, 1, 1])
    assert got == one[(True, True)]
    gc.collect()
    assert not any(r() is not None for r in built)   # multi-unit: no cache


def test_single_unit_run_caches_its_index_for_the_rerun(inputs, monkeypatch):
    genome, reads, _ = inputs
    calls = []
    real = driver.build_index
    monkeypatch.setattr(driver, "build_index",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    cfg = RealConfig(textfilename=genome, patternfilename=reads,
                     outputfilename="-", batch_size=512, cand_cap=2,
                     survivor_cap=2)
    rs = reads_io.parse_reads(reads)
    texts = driver.load_texts(cfg, "cpu")
    res = driver.run_match_unique(cfg, rs, texts, "cpu")
    assert res.metrics["overflow_rerun_reads"] > 0 and len(calls) == 1
    calls.clear()
    cfg.index_shards = 2
    res = driver.run_match_unique(cfg, rs, texts, "cpu")
    assert res.metrics["overflow_rerun_reads"] > 0 and len(calls) >= 4


def test_skewed_bucket_adversarial_sharded(tmp_path):
    """One bucket holds thousands of entries while each equal range is
    tiny (tests/test_e2e_ab.py's adversarial genome): unconverged
    bisections must escalate, not drop hits, with the index in 3 shards."""
    rng = np.random.default_rng(77)
    nblk = 3000
    prefix = "ACGTACGTACG"          # 11 bases = 22 bucket bits of list s0
    blocks = ["".join("ACGT"[b] for b in rng.integers(0, 4, 21))
              for _ in range(nblk)]
    genome = "".join(prefix + b for b in blocks)
    gpath = tmp_path / "g.fa"
    gpath.write_text(">frag0\n" + "\n".join(
        genome[i:i + 60] for i in range(0, len(genome), 60)) + "\n")
    rpath = tmp_path / "r.fa"
    rpath.write_text("".join(f">r{i}\n{genome[i * 32:i * 32 + 64]}\n"
                             for i in range(0, nblk - 2, 7)))
    want = ab_util.run_ours(str(gpath), str(rpath), scores=False,
                            use_mesh=False, index_shards=3)
    assert want.count("\n") > 300
    got, metrics = _port_run(str(gpath), str(rpath), scores=False, shards=3)
    assert got == want
    assert got == _port_run(str(gpath), str(rpath), scores=False)[0]


def test_split_oversized_with_shards(tmp_path):
    """A tiny split limit breaks one 7-fragment file into several
    sub-texts, each in 2 shards; records equal real_tpu's."""
    genome, reads = ab_util.make_inputs(tmp_path, n=30000, numpat=250,
                                        patlen=75, errprob=0.02, seed=61,
                                        num_fragments=7)
    want = ab_util.run_ours(genome, reads, split_limit=10000,
                            use_mesh=False, index_shards=2)
    got, metrics = _port_run(genome, reads, shards=2, split_limit=10000)
    assert metrics["units"] >= 6 and len(metrics["plans"]) >= 3
    assert got == want
    assert got == _port_run(genome, reads)[0]


@pytest.mark.parametrize("seedl", [48, 64])
def test_wide_sharded_streaming_records_equal_real_tpu(tmp_path, seedl):
    genome, reads = ab_util.make_inputs(tmp_path, n=24000, numpat=250,
                                        patlen=100, errprob=0.02,
                                        seed=40 + seedl)
    got, metrics = _port_run(genome, reads, shards=3, stream=True,
                             seedl=seedl)
    assert metrics["units_dispatched"] == 3
    assert got == ab_util.run_ours(genome, reads, seedl=seedl,
                                   index_shards=3, use_mesh=False)
