"""-metrics and -trace of the port's CLI against real_tpu's CLI on the same
input: the metrics file has real_tpu's keys and phases and equal overflow
counts; a -trace run under -device cpu writes a Chrome trace and the same
records as the untraced run. Exact (bytes, key sets, counts)."""

import glob
import json
import os

import pytest

from real_tpu.cli import main as j_main
from real_tpu_torch.cli import main as t_main
from tests import ab_util

# keys the port's metrics add to real_tpu's: the unit loop's account of
# itself (engine/driver.py _loop_metrics), the hand kernels' launches, and
# the job's spans, counters and streaming wait (cli/main.py)
PORT_EXTRA_KEYS = {"units", "units_skipped", "units_dispatched",
                   "reserved_bytes", "plans", "source_resident",
                   "resident_read_bytes", "streamed_batches",
                   "kernel_launches", "spans", "counters", "stream_wait_s"}
# phase keys only the port has: real_tpu fills its metrics before the
# overflow rerun, the port adds the rerun's phases as rerun.<phase>
RERUN_PREFIX = "rerun."
# the port's matchAll times its batch source's setup as matchUnique does;
# real_tpu's matchAll leaves it untimed
PORT_EXTRA_PHASES = {"unique": set(), "all": {"setup"}}
RUN_KEYS = {"wall_s", "num_reads", "reads_per_sec", "mode",
            "native_paths_active"}

CASES = {
    # flags beside -t/-p/-o, mode key
    "unique": (["-K", "2", "-S", "2"], "unique"),
    "all": (["-u", "0", "-K", "2", "-S", "2"], "all"),
}


@pytest.fixture
def no_xla_cache(monkeypatch):
    """real_tpu's CLI turns on JAX's persistent compilation cache under
    the home directory; the tests keep it off."""
    from real_tpu.utils import cache
    monkeypatch.setattr(cache, "enable_compilation_cache", lambda: None)


@pytest.mark.parametrize("case", sorted(CASES))
def test_metrics_file_has_real_tpus_keys_and_counts(tmp_path, case,
                                                    no_xla_cache):
    flags, mode = CASES[case]
    genome, reads = ab_util.make_inputs(tmp_path, n=20000, numpat=300,
                                        seed=31)
    runs = {}
    for tag, main, extra in (("port", t_main.main, ["-device", "cpu"]),
                             ("real_tpu", j_main.main, [])):
        out = tmp_path / f"{tag}.txt"
        m = tmp_path / f"{tag}.json"
        assert main([*extra, "-t", genome, "-p", reads, "-o", str(out),
                     "-B", "512", "-R", "0", "-metrics", str(m),
                     *flags]) == 0
        runs[tag] = (out.read_bytes(), json.loads(m.read_text()))
    (port_out, port), (j_out, j) = runs["port"], runs["real_tpu"]
    assert port_out == j_out and port_out.count(b"\n") > 200
    assert set(port) - set(j) == PORT_EXTRA_KEYS
    # the match's hand kernels and the genome pack's, none on the CPU
    assert set(port["kernel_launches"]) == {
        "probe_candidates", "probe_candidates_wide", "verify_windows",
        "gather_word_windows", "pack_text"}
    assert set(port["kernel_launches"].values()) == {0}
    assert set(j) <= set(port) and RUN_KEYS <= set(j)
    assert port["overflow_rerun_reads"] == j["overflow_rerun_reads"] > 0
    if mode == "all":
        assert port["batch_hit_overflow_steps"] \
            == j["batch_hit_overflow_steps"]
    first = {k for k in port["phase_s"] if not k.startswith(RERUN_PREFIX)}
    assert first == set(j["phase_s"]) | PORT_EXTRA_PHASES[mode]
    # the rerun reuses the one unit's cached index: no rerun.index_build
    assert {k[len(RERUN_PREFIX):] for k in port["phase_s"]
            if k.startswith(RERUN_PREFIX)} == first - {"index_build"}
    for k in ("num_reads", "mode", "native_paths_active"):
        assert port[k] == j[k]
    assert port["mode"] == mode and port["num_reads"] == 300
    assert all(v == round(v, 3) for v in port["phase_s"].values())
    # reads_per_sec comes from the unrounded wall time
    wall = port["wall_s"]
    assert 300 / (wall + 5e-4) - 0.05 <= port["reads_per_sec"] \
        <= 300 / (wall - 5e-4) + 0.05


def test_metrics_record_the_plain_host_versions(tmp_path):
    genome, reads = ab_util.make_inputs(tmp_path, n=8000, numpat=40, seed=33)
    m = tmp_path / "m.json"
    assert t_main.main(["-device", "cpu", "-t", genome, "-p", reads,
                        "-o", str(tmp_path / "o.txt"), "-native", "0",
                        "-metrics", str(m)]) == 0
    got = json.loads(m.read_text())
    assert got["native_paths_active"] is False
    assert got["units"] == got["units_dispatched"] == 1


@pytest.mark.parametrize("flags", [[], ["-u", "0"]], ids=["unique", "all"])
def test_trace_on_cpu_writes_a_chrome_trace_and_the_same_records(tmp_path,
                                                                 flags):
    genome, reads = ab_util.make_inputs(tmp_path, n=12000, numpat=120,
                                        seed=35)
    outs = []
    trace_dir = tmp_path / "new" / "trace"     # created by the run
    for extra in ([], ["-trace", str(trace_dir)]):
        out = tmp_path / f"o{len(outs)}.txt"
        assert t_main.main(["-device", "cpu", "-t", genome, "-p", reads,
                            "-o", str(out), "-B", "512", *flags,
                            *extra]) == 0
        outs.append(out.read_bytes())
    assert outs[0] == outs[1] and outs[0].count(b"\n") > 50
    files = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    assert ops and all(e["dur"] >= 0 for e in ops)
    # the CPU alone: no kernel, memcpy or memset of a card
    assert not [e for e in events
                if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
