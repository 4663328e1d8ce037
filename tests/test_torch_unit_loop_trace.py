"""The unit loop's spans and counters through the port's CLI on the CPU
(-device cpu -metrics): a job whose index is split into several units
(-shards 3), with caps small enough that reads overflow and are rerun,
builds every unit again in the rerun and counts each build
(`index.units_built`, `index.windows_built`) and the builds' seconds of
the first pass and of the rerun (`index.build_device_s`,
`rerun.index.build_device_s`); a single-unit job's rerun takes the cached
index and counts one build; the waits for a unit in flight are
`index.unit_wait` spans under `driver`; and the records of both jobs are
real_tpu's CLI's at the same setting."""

import json

import pytest

from real_tpu.cli import main as j_main
from real_tpu_torch.cli import main as t_main
from real_tpu_torch.io import fasta
from real_tpu_torch.tools import simulate

GENOME_BP = 20000
SEEDL = 32
FLAGS = ["-B", "512", "-K", "2", "-S", "2"]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("unitloop")
    genome, reads = str(d / "g.fa"), str(d / "r.fa")
    with open(genome, "w") as f:
        f.write(simulate.random_genome(GENOME_BP, seed=61))
    codes, _ = fasta.parse_genome(genome, use_native=False)
    simulate.write_reads(simulate.generate_reads(codes, 300, 100, 0.02,
                                                 False, seed=62),
                         reads, False)
    return genome, reads


def _job(tmp_path, inputs, shards):
    genome, reads = inputs
    out, m = tmp_path / f"o{shards}.txt", tmp_path / f"m{shards}.json"
    assert t_main.main(["-device", "cpu", "-t", genome, "-p", reads,
                        "-o", str(out), *FLAGS, "-shards", str(shards),
                        "-metrics", str(m)]) == 0
    return out.read_bytes(), json.loads(m.read_text())


@pytest.fixture(scope="module")
def real_tpu_records(tmp_path_factory, inputs):
    """real_tpu's CLI on the same inputs and flags in 3 shards (its
    persistent compilation cache kept off)."""
    from real_tpu.utils import cache
    genome, reads = inputs
    out = tmp_path_factory.mktemp("real_tpu") / "o.txt"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cache, "enable_compilation_cache", lambda: None)
        assert j_main.main(["-t", genome, "-p", reads, "-o", str(out),
                            *FLAGS, "-shards", "3"]) == 0
    return out.read_bytes()


@pytest.fixture(scope="module")
def jobs(tmp_path_factory, inputs):
    d = tmp_path_factory.mktemp("jobs")
    return {shards: _job(d, inputs, shards) for shards in (1, 3)}


def _names(m, name):
    return [s for s in m["spans"] if s["name"] == name]


@pytest.mark.parametrize("shards", [1, 3])
def test_each_build_counts_once_at_every_depth(jobs, shards):
    """Every depth of a multi-unit job builds all of its units; a
    single-unit job's rerun takes the index its first pass built."""
    _, m = jobs[shards]
    assert m["overflow_rerun_reads"] > 0
    depths = len(_names(m, "driver"))
    assert depths == 2
    assert m["units"] == shards
    text_windows = sum(sum(p["windows"]) for p in m["plans"])
    assert text_windows == GENOME_BP - SEEDL + 1
    passes = depths if shards > 1 else 1
    c = m["counters"]
    assert c["index.units_built"] == shards * passes
    assert c["index.windows_built"] == text_windows * passes
    assert len(_names(m, "index_build")) == shards * passes
    # the builds' seconds, on the CPU their host time, by depth
    assert c["index.build_device_s"] > 0
    assert ("rerun.index.build_device_s" in c) == (shards > 1)
    if shards > 1:
        assert c["rerun.index.build_device_s"] > 0


@pytest.mark.parametrize("shards", [1, 3])
def test_unit_waits_lie_under_driver(jobs, shards):
    """At most two units are in flight: a depth of three units waits
    once, a depth of one never."""
    _, m = jobs[shards]
    by_id = {s["id"]: s for s in m["spans"]}
    waits = _names(m, "index.unit_wait")
    assert len(waits) == len(_names(m, "driver")) * max(shards - 2, 0)
    for s in waits:
        parent = by_id[s["parent"]]
        assert parent["name"] == "driver"
        assert parent["start_ns"] <= s["start_ns"] <= s["end_ns"] \
            <= parent["end_ns"]


@pytest.mark.parametrize("shards", [1, 3])
def test_records_are_the_unit_loops_own(jobs, real_tpu_records, shards):
    out, _ = jobs[shards]
    assert out.count(b"\n") > 200
    assert out == real_tpu_records
